"""The program's own host spans in a traced window.

The program opens ``torch.profiler`` spans named ``ninw.*`` at its layer
boundaries (``ninwavelets_tpu_torch.utils.observability.span``), on the
profiler's clock.  ``Trace.host`` keeps those of the window's thread; the
readers here sum the durations of one name, clipped to the window.
"""
from __future__ import annotations

#: The prefix of every span the program records.
PREFIX = "ninw."


def seconds(trace, name: str):
    """Summed seconds, inside the window, of the window thread's host spans
    named ``name``: 0.0 where the window holds spans of the program but
    none of that name (the work was not done), None where it holds none of
    the program's (a program that records no spans)."""
    if not any(n.startswith(PREFIX) for _, _, n in trace.host):
        return None
    return sum(max(0.0, min(e, trace.hi) - max(s, trace.lo))
               for s, e, n in trace.host if n == name)


def ms_per_call(run, name: str):
    """``seconds`` of ``name`` over the window's calls, in ms; None without
    a trace, or where the trace holds no device activity (as the other
    readers of the device trace)."""
    if run.trace is None or not run.trace.device:
        return None
    s = seconds(run.trace, name)
    return None if s is None else s / run.n_calls * 1e3
