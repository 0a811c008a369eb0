"""Share of the traced window in which the device runs no kernel, copy or
set (their intervals merged), in %."""


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
