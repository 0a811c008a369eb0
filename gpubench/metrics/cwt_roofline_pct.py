"""The least time of a call's transform work (``gpubench.costs``, against
the published peaks of ``gpubench.peaks``) over the device time of all the
kernels of a call in the traced window, in %."""
from ..peaks import least_seconds


def read(run):
    if run.trace is None:
        return None
    kernel_s = run.trace.seconds(("kernel",)) / run.n_calls
    if kernel_s <= 0:
        return None
    return 100.0 * least_seconds(run.cost["flops"], run.cost["bytes"]) \
        / kernel_s
