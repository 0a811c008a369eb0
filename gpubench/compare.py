"""The comparison that decides ``correct``.

Outputs are (C, F, T) planes compared in blocks against the float64
reference.  ``RowErrors`` keeps, per (channel, frequency) row, the largest
``|program - reference|`` and the largest ``|reference|`` seen; its two
numbers are the widest gap over the whole plane (``absolute``) and the
widest gap of a row over that row's own peak (``relative``), so that a
quiet row is held as tightly as a loud one.  A NaN or an infinity in
either plane makes the number infinite.
"""
from __future__ import annotations

import math

import torch


class RowErrors:
    def __init__(self, rows: tuple, device) -> None:
        self.diff = torch.zeros(rows, dtype=torch.float64, device=device)
        self.peak = torch.zeros(rows, dtype=torch.float64, device=device)

    def add(self, sel, got: torch.Tensor, ref: torch.Tensor) -> None:
        """Fold in one block: ``got`` and ``ref`` are (c, F, t) for the
        rows ``sel`` (a slice of the channels)."""
        ref = ref.to(torch.float64)
        diff = torch.abs(got.to(torch.float64) - ref)
        diff = torch.where(torch.isfinite(diff), diff,
                           torch.full_like(diff, math.inf))
        self.diff[sel] = torch.maximum(self.diff[sel], diff.amax(-1))
        self.peak[sel] = torch.maximum(self.peak[sel],
                                       torch.abs(ref).amax(-1))

    def absolute(self) -> float:
        return float(self.diff.max())

    def relative(self) -> float:
        zero = self.peak == 0
        rel = self.diff / torch.where(zero, torch.ones_like(self.peak),
                                      self.peak)
        rel = torch.where(zero & (self.diff > 0),
                          torch.full_like(rel, math.inf), rel)
        return float(rel.max())


def judge(numbers: dict, limits: dict) -> dict:
    """``{name: {"value", "limit", "ok"}}`` for every number that has a
    limit; a number without a limit, or a limit without a number, is
    not ok."""
    out = {}
    for name in sorted(set(numbers) | set(limits)):
        value, limit = numbers.get(name), limits.get(name)
        ok = (value is not None and limit is not None
              and math.isfinite(value) and value <= limit)
        out[name] = {"value": value if value is None or math.isfinite(value)
                     else None, "limit": limit, "ok": ok}
    return out
