"""Plane-sized CWTs a call computes on the plain epoch route: the
program's ``ninw.epoch.cwt`` spans (one around each epoch's transform) of
the window's thread that start inside the traced window, over the
window's calls.  A diagnostic of the plain route alone: None where the
window holds no such span (a kernel route, or a program that records
none), without a trace, or where the trace holds no device activity."""

SPAN = "ninw.epoch.cwt"


def read(run):
    tr = run.trace
    if tr is None or not tr.device:
        return None
    n = sum(1 for s, _, name in tr.host
            if name == SPAN and tr.lo <= s < tr.hi)
    return n / run.n_calls if n else None
