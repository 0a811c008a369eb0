"""Device time of the host-to-device copies in the traced window, per
call, in ms."""


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    return run.trace.seconds(("gpu_memcpy",), "HtoD") / run.n_calls * 1e3
