"""Baseline correction, the reference's six methods (port of
``ninwavelets_tpu.ops.baseline``).

Semantics as in the reference, quirks included:

* ``Baseline`` and ``baseline_correct`` slice the FIRST axis
  (``wave[int(start*sfreq) : int(stop*sfreq)]``) and use scalar statistics
  over the whole window;
* ``zlog`` is ``log10(ratio) / std(baseline)``: log-then-divide;
* ``std`` is the population std of the raw baseline window.

``baseline_tf`` corrects a (..., F, N) time-frequency plane along its TIME
axis with per-row statistics.
"""
from __future__ import annotations

import torch

METHODS = ("mean", "ratio", "percent", "log", "zscore", "zlog")


def _std(x: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    """Two-pass population std, ``sqrt(mean((x - mean)^2))``."""
    if dim is None:
        return torch.sqrt(torch.square(x - x.mean()).mean())
    mean = x.mean(dim=dim, keepdim=True)
    return torch.sqrt(torch.square(x - mean).mean(dim=dim, keepdim=keepdim))


def _correct(wave, basemean, basestd, method: str):
    if method == "mean":
        return wave - basemean
    if method == "ratio":
        return wave / basemean
    if method == "percent":
        return (wave - basemean) / basemean
    if method == "log":
        return torch.log10(wave / basemean)
    if method == "zscore":
        return (wave - basemean) / basestd
    if method == "zlog":
        # Reference quirk: log10(ratio) / std, not zscore-then-log.
        return torch.log10(wave / basemean) / basestd
    raise ValueError(f"unknown baseline method {method!r}; one of {METHODS}")


class Baseline:
    """The reference ``Baseline``: the window ``[start, stop)`` in seconds
    slices the first axis; statistics are scalars over the whole window."""

    def __init__(self, wave, sfreq: float, start: float, stop: float) -> None:
        self.wave = torch.as_tensor(wave)
        self.baseline = self.wave[int(start * sfreq): int(stop * sfreq)]
        self.basemean = self.baseline.mean()
        self._basestd = _std(self.baseline)

    def mean(self):
        return _correct(self.wave, self.basemean, self._basestd, "mean")

    def ratio(self):
        return _correct(self.wave, self.basemean, self._basestd, "ratio")

    def percent(self):
        return _correct(self.wave, self.basemean, self._basestd, "percent")

    def log(self):
        return _correct(self.wave, self.basemean, self._basestd, "log")

    def zscore(self):
        return _correct(self.wave, self.basemean, self._basestd, "zscore")

    def zlog(self):
        return _correct(self.wave, self.basemean, self._basestd, "zlog")


def baseline_of(wave, sfreq: float, start: float, stop: float
                ) -> torch.Tensor:
    """The reference free function: slice the window off the first axis."""
    return torch.as_tensor(wave)[int(start * sfreq): int(stop * sfreq)]


def baseline_correct(wave, sfreq: float, start: float, stop: float,
                     method: str = "zscore") -> torch.Tensor:
    """One-shot form of ``Baseline`` (first-axis window, scalar
    statistics)."""
    wave = torch.as_tensor(wave)
    base = wave[int(start * sfreq): int(stop * sfreq)]
    return _correct(wave, base.mean(), _std(base), method)


def baseline_tf(tf: torch.Tensor, sfreq: float, start: float, stop: float,
                method: str = "zscore", degenerate: str = "unit"
                ) -> torch.Tensor:
    """Per-frequency-row baseline correction of a (..., F, N) plane along the
    time axis; statistics per row over ``[start, stop)`` seconds.

    ``degenerate`` handles rows whose baseline std is zero: ``"unit"``
    (default) substitutes std=1, so zscore/zlog degrade to mean-correction;
    ``"strict"`` keeps the reference's division (inf/NaN).
    """
    if degenerate not in ("unit", "strict"):
        raise ValueError("degenerate must be 'unit' or 'strict'")
    tf = torch.as_tensor(tf)
    window = tf[..., int(start * sfreq):int(stop * sfreq)]
    mean = window.mean(dim=-1, keepdim=True)
    std = _std(window, dim=-1, keepdim=True)
    if degenerate == "unit":
        std = torch.where(std > 0, std, torch.ones_like(std))
    return _correct(tf, mean, std, method)
