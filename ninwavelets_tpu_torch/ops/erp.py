"""Evoked-response (ERP) measurement, port of ``ninwavelets_tpu.ops.erp``:
peaks, mean amplitudes, fractional-area latencies and jackknife onset
latencies (Luck, "An Introduction to the ERP Technique").

Every measure is a reduction (argmax, mean, a cumsum crossing) over a
window of plain Python sample indices; the jackknife builds all
leave-one-out waveforms from one epoch sum, and the Miller-Ulrich
standard error is a closed form.  ``torch.argmax`` returns the first
maximum, as ``jnp.argmax`` does.

A numpy input goes to ``device`` (the card when None); a tensor stays on
its device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import as_float32
from .signal_utils import row_cumsum

__all__ = ["evoked", "peak_measures", "mean_amplitude",
           "fractional_area_latency", "fractional_peak_onset",
           "jackknife_onsets", "PeakResult"]


class PeakResult(NamedTuple):
    """Windowed peak measurement: ``latency`` (samples, absolute index
    into the epoch, int32), ``amplitude`` (signal units), both shaped like
    the input minus the time axis."""
    latency: torch.Tensor
    amplitude: torch.Tensor


def evoked(x, device=None) -> torch.Tensor:
    """(E, ..., N) -> (..., N) trial-average waveform."""
    return torch.mean(as_float32(x, device), dim=0)


def _window(window, n):
    if window is None:
        return 0, n
    lo, hi = int(window[0]), int(window[1])
    if not 0 <= lo < hi <= n:
        raise ValueError(f"window {window} outside 0..{n}")
    return lo, hi


def _first_true(mask):
    """Index of the first True along the last axis (0 when none)."""
    return torch.argmax(mask.to(torch.uint8), dim=-1)


def peak_measures(x, window=None, polarity: int = 1,
                  device=None) -> PeakResult:
    """Largest positive (``polarity=+1``) or negative (``-1``) peak of
    (..., N) waveforms inside ``window`` (a (lo, hi) SAMPLE pair; default
    all): absolute-sample latency and signed amplitude."""
    x = as_float32(x, device)
    lo, hi = _window(window, x.shape[-1])
    seg = x[..., lo:hi]
    idx = torch.argmax(seg if polarity >= 0 else -seg, dim=-1)
    amp = torch.gather(seg, -1, idx[..., None])[..., 0]
    return PeakResult(latency=(idx + lo).to(torch.int32), amplitude=amp)


def mean_amplitude(x, window, device=None) -> torch.Tensor:
    """Mean amplitude of (..., N) waveforms over the (lo, hi) sample
    window (linear in the data, so trial averaging and measurement
    commute)."""
    x = as_float32(x, device)
    lo, hi = _window(window, x.shape[-1])
    return torch.mean(x[..., lo:hi], dim=-1)


def fractional_area_latency(x, window, fraction: float = 0.5,
                            polarity: int = 1, device=None) -> torch.Tensor:
    """Latency (absolute samples, int32) at which ``fraction`` of the
    component's area inside ``window`` has accumulated (0.5: the midpoint
    latency).  Only same-polarity area counts (opposite excursions clip
    to 0)."""
    x = as_float32(x, device)
    lo, hi = _window(window, x.shape[-1])
    if not 0.0 < float(fraction) < 1.0:
        raise ValueError("fraction must be in (0, 1)")
    seg = x[..., lo:hi]
    seg = torch.clamp(seg if polarity >= 0 else -seg, min=0.0)
    c = row_cumsum(seg)
    hit = c >= float(fraction) * c[..., -1:]
    return (_first_true(hit) + lo).to(torch.int32)


def _frac_peak_onset(x, lo, hi, criterion, polarity):
    seg = x[..., lo:hi]
    seg = seg if polarity >= 0 else -seg
    pk = torch.argmax(seg, dim=-1)
    pamp = torch.gather(seg, -1, pk[..., None])
    # last sample at or before the peak still below criterion x peak
    t = torch.arange(seg.shape[-1], device=seg.device)
    below = (seg < criterion * pamp) & (t <= pk[..., None])
    last = seg.shape[-1] - 1 - _first_true(torch.flip(below, dims=(-1,)))
    onset = torch.where(below.any(dim=-1), last, torch.zeros_like(last))
    return (onset + lo).to(torch.int32)


def fractional_peak_onset(x, window, criterion: float = 0.5,
                          polarity: int = 1, device=None) -> torch.Tensor:
    """Onset latency as the last pre-peak sample below ``criterion`` x
    peak amplitude (Miller, Patterson & Ulrich 1998).  Absolute samples
    (int32); the window start when the waveform never dips below the
    criterion."""
    x = as_float32(x, device)
    lo, hi = _window(window, x.shape[-1])
    if not 0.0 < float(criterion) < 1.0:
        raise ValueError("criterion must be in (0, 1)")
    return _frac_peak_onset(x, lo, hi, float(criterion), int(polarity))


def jackknife_onsets(x, window, criterion: float = 0.5,
                     polarity: int = 1, device=None):
    """Leave-one-trial-out onset latencies of the evoked waveform
    (Miller-Ulrich jackknife).  Returns ``(onsets, mean, se)``: the
    (E, ...) float32 leave-one-out onsets (samples), their mean, and the
    corrected standard error ``sqrt((E-1)/E * sum (o_i - mean)^2)``."""
    x = as_float32(x, device)
    if x.ndim < 2 or x.shape[0] < 2:
        raise ValueError("need (E >= 2, ..., N) epochs")
    lo, hi = _window(window, x.shape[-1])
    e = x.shape[0]
    loo = (torch.sum(x, dim=0, keepdim=True) - x) / (e - 1.0)
    ons = _frac_peak_onset(loo, lo, hi, float(criterion),
                           int(polarity)).to(torch.float32)
    mean = torch.mean(ons, dim=0)
    se = torch.sqrt((e - 1.0) / e * torch.sum((ons - mean) ** 2, dim=0))
    return ons, mean, se
