"""The device timeline of a measured window, from ``torch.profiler``.

The harness profiles the window with CPU and CUDA activity and marks it
with a ``gpubench.window`` span.  ``Trace`` keeps what the metric readers
need from the profiler's Chrome trace: the device's kernels, copies and
sets inside the window, and the host spans of the thread that ran it.
Times are in seconds.
"""
from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict

from . import stats

WINDOW = "gpubench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


class Trace:
    def __init__(self, events: list) -> None:
        window = [e for e in events if e.get("name") == WINDOW
                  and e.get("cat") == "user_annotation"]
        if len(window) != 1:
            raise ValueError(f"expected one {WINDOW!r} span, found "
                             f"{len(window)}")
        w = window[0]
        self.lo = w["ts"] * 1e-6
        self.hi = (w["ts"] + w["dur"]) * 1e-6
        #: (category, name, start, end) of every device activity.
        self.device = [(e["cat"], e["name"], e["ts"] * 1e-6,
                        (e["ts"] + e["dur"]) * 1e-6)
                       for e in events
                       if e.get("cat") in DEVICE_CATS and "dur" in e]
        #: (start, end, name) of the host spans of the window's thread.
        self.host = [(e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6,
                      e["name"])
                     for e in events
                     if e.get("cat") in HOST_CATS and "dur" in e
                     and e.get("pid") == w.get("pid")
                     and e.get("tid") == w.get("tid")]

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        fd, path = tempfile.mkstemp(prefix="gpubench-", suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as fh:
                doc = json.load(fh)
        finally:
            os.remove(path)
        return cls(doc["traceEvents"] if isinstance(doc, dict) else doc)

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    def intervals(self, cats=DEVICE_CATS, name_part: str = "") -> list:
        return [(s, e) for c, n, s, e in self.device
                if c in cats and name_part in n]

    def busy_s(self) -> float:
        """Seconds of the window in which the device ran anything."""
        return stats.covered(self.intervals(), self.lo, self.hi)

    def seconds(self, cats, name_part: str = "") -> float:
        """Summed durations (inside the window) of the device activities
        of ``cats`` whose name holds ``name_part``."""
        return sum(max(0.0, min(e, self.hi) - max(s, self.lo))
                   for s, e in self.intervals(cats, name_part))

    def device_ops(self, top: int = 10) -> list:
        """``[name, seconds]`` of the device activities that took most
        time in the window, summed by name."""
        total = defaultdict(float)
        for c, n, s, e in self.device:
            total[n] += max(0.0, min(e, self.hi) - max(s, self.lo))
        return sorted(([n, t] for n, t in total.items() if t > 0),
                      key=lambda x: -x[1])[:top]

    def idle_gaps(self, top: int = 10) -> list:
        """``[host span, seconds]``: the device's idle time in the window,
        summed by the innermost host span running at the middle of each
        gap."""
        gaps = stats.gaps(self.intervals(), self.lo, self.hi)
        total = defaultdict(float)
        for (s, e), name in zip(gaps, _innermost(self.host,
                                                 [(s + e) / 2 for s, e in
                                                  gaps])):
            total[name] += e - s
        return sorted(([n, t] for n, t in total.items()),
                      key=lambda x: -x[1])[:top]


def _innermost(spans: list, points: list) -> list:
    """For each of the sorted ``points``, the name of the innermost of the
    properly nested ``(start, end, name)`` spans that holds it."""
    spans = sorted(spans, key=lambda x: (x[0], -x[1]))
    out, stack, j = [], [], 0
    for p in points:
        while j < len(spans) and spans[j][0] <= p:
            while stack and stack[-1][1] <= spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        out.append(stack[-1][2] if stack else "(no host span)")
    return out
