"""The arithmetic of the metrics: percentiles, spreads and time intervals."""
from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float:
    """The ``q``-th percentile, linear between closest ranks (numpy's
    default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    h = (len(xs) - 1) * q / 100.0
    lo = math.floor(h)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (h - lo) * (xs[hi] - xs[lo])


def spread(values) -> float:
    """Distance between the first and third quartiles over the median
    (``statistics.quantiles(values, n=4)``)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def merge(intervals, lo: float, hi: float) -> list:
    """The union of ``(start, end)`` intervals clipped to ``[lo, hi]``, as
    sorted disjoint intervals."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def covered(intervals, lo: float, hi: float) -> float:
    """Length of ``[lo, hi]`` that the intervals cover."""
    return sum(e - s for s, e in merge(intervals, lo, hi))


def gaps(intervals, lo: float, hi: float) -> list:
    """The parts of ``[lo, hi]`` that no interval covers."""
    out, at = [], lo
    for s, e in merge(intervals, lo, hi):
        if s > at:
            out.append((at, s))
        at = e
    if hi > at:
        out.append((at, hi))
    return out
