"""The 95th percentile of the wall times of all calls in the window, in
ms (host clock, each call ended by a device synchronization)."""
from ..stats import percentile


def read(run):
    return percentile(run.call_s, 95.0) * 1e3
