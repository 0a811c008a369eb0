"""Oscillatory burst detection and statistics on single-trial TFRs (port of
``ninwavelets_tpu.ops.bursts``; the beta-burst methodology of Shin, Law,
Tsutsui, Moore & Jones, eLife 2017: transient suprathreshold events, not
sustained rhythms, carry most task effects).

A burst is a 4-connected suprathreshold component of one trial's (F, N)
power plane above ``factor`` x the median power of its frequency row
(medians taken across trials and time).  Every per-burst statistic is a
scatter reduction over the labels of ``ops.cluster.label_components``:
area (a count), duration (the min and max of the time index), frequency
span, peak power (a max).  Counts, minima and maxima do not depend on the
order of the adds, so they are the same on every run and device.
``burst_table`` reads each burst's statistics at its root pixel on the
device, and only the table's rows cross to the host.

A numpy input goes to the card; a tensor stays on its device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import as_float32
from .cluster import label_components
from .denoise import _median

__all__ = ["burst_threshold", "burst_summary", "burst_table",
           "BurstSummary"]


def burst_threshold(trials, factor: float = 6.0) -> torch.Tensor:
    """(F,) burst threshold: ``factor`` x the median power of each
    frequency row across trials and time (Shin et al. use 6x median); the
    median of an even count is the mean of its two middle values, as
    ``jnp.median``'s."""
    trials = as_float32(trials)
    rows = trials.movedim(0, -2)                    # (..., F, E, N)
    return factor * _median(rows.reshape(*rows.shape[:-2], -1))


class BurstSummary(NamedTuple):
    """Per-epoch burst statistics (all (E,) float tensors): ``count``,
    ``rate`` (bursts/s), ``mean_duration`` (s), ``mean_span`` (Hz),
    ``mean_peak`` (power units)."""
    count: torch.Tensor
    rate: torch.Tensor
    mean_duration: torch.Tensor
    mean_span: torch.Tensor
    mean_peak: torch.Tensor


def _scatter(labels_flat, vals_flat, init, op):
    """Per-root scatter reduction ("sum", "amin", "amax") into (E, FN + 1)
    bins that start at ``init``."""
    e, fn = labels_flat.shape
    bins = torch.full((e, fn + 1), init, dtype=vals_flat.dtype,
                      device=vals_flat.device)
    return bins.scatter_reduce_(1, labels_flat, vals_flat, op)


def _labels(trials, threshold):
    mask = trials > threshold[None, :, None]
    return mask, label_components(mask)


def _summary(trials, threshold, sfreq: float, freq_step: float,
             min_area: int):
    e, f, n = trials.shape
    fn = f * n
    mask, labels = _labels(trials, threshold)
    flat_l = labels.reshape(e, fn)
    ar = torch.arange(fn, device=trials.device)
    is_root = (flat_l == ar) & mask.reshape(e, fn)
    # discard spurious specks: component pixel area >= min_area
    areas = _scatter(flat_l, torch.ones((e, fn), device=trials.device), 0.0,
                     "sum")[:, :fn]
    is_root = is_root & (areas >= min_area)
    count = is_root.sum(-1).float()
    big = float(fn + 1)

    def spread(idx):
        v = idx.float().expand(e, fn)
        lo = _scatter(flat_l, v, big, "amin")
        hi = _scatter(flat_l, v, -1.0, "amax")
        return hi[:, :fn] - lo[:, :fn] + 1.0      # extent per root bin

    dur = spread(ar % n) / sfreq
    span = spread(ar // n) * freq_step
    peak = _scatter(flat_l, trials.reshape(e, fn), 0.0, "amax")[:, :fn]
    safe = torch.clamp(count, min=1.0)

    def mean_of(stat):
        return torch.where(count > 0,
                           torch.where(is_root, stat, 0.0).sum(-1) / safe,
                           0.0)

    seconds = n / sfreq
    return (count, count / seconds, mean_of(dur), mean_of(span),
            mean_of(peak))


def burst_summary(trials, threshold=None, sfreq: float = 1000.0,
                  freq_step: float = 1.0, factor: float = 6.0,
                  min_area: int = 1) -> BurstSummary:
    """Per-epoch burst statistics of (E, F, N) single-trial power planes.

    ``threshold`` is an (F,) row threshold (default: ``burst_threshold``
    with ``factor``); ``freq_step`` converts frequency-bin spans to Hz (the
    analysis grid's step); components smaller than ``min_area`` pixels are
    discarded (single-pixel noise crossings are ubiquitous at the
    conventional 6x-median threshold).
    """
    trials = as_float32(trials)
    if trials.ndim != 3:
        raise ValueError("expected (epochs, F, N), got %s"
                         % (tuple(trials.shape),))
    if threshold is None:
        threshold = burst_threshold(trials, factor)
    return BurstSummary(*_summary(
        trials, as_float32(threshold, trials.device), float(sfreq),
        float(freq_step), int(min_area)))


def burst_table(trials, threshold=None, sfreq: float = 1000.0,
                freqs=None, factor: float = 6.0, min_area: int = 1) -> list:
    """Host-side burst listing: one dict per detected burst with
    ``epoch``, ``t_start``/``t_stop`` (s), ``f_lo``/``f_hi`` (Hz when
    ``freqs`` is given, else row indices), ``peak`` power, ``area`` (pixel
    count), in epoch order and, within an epoch, by root pixel.  The device
    labels the planes and reduces each burst to its row; the host only
    formats the rows.
    """
    trials = as_float32(trials)
    if threshold is None:
        threshold = burst_threshold(trials, factor)
    _, labels = _labels(trials, as_float32(threshold, trials.device))
    e, f, n = trials.shape
    fn = f * n
    flat_l = labels.reshape(e, fn)
    ar = torch.arange(fn, device=trials.device).expand(e, fn)
    area = _scatter(flat_l, torch.ones_like(ar), 0, "sum")
    t_lo = _scatter(flat_l, ar % n, fn, "amin")
    t_hi = _scatter(flat_l, ar % n, -1, "amax")
    f_lo = _scatter(flat_l, ar // n, fn, "amin")
    f_hi = _scatter(flat_l, ar // n, -1, "amax")
    peak = _scatter(flat_l, trials.reshape(e, fn), -np.inf, "amax")
    ep, root = torch.nonzero((flat_l == ar) & (area[:, :fn] >= min_area),
                             as_tuple=True)     # epoch order, then root
    rows = [t[ep, root].cpu().numpy()
            for t in (area, t_lo, t_hi, f_lo, f_hi, peak)]
    freqs = np.arange(f, dtype=np.float64) if freqs is None \
        else np.asarray(freqs, np.float64)
    return [{"epoch": int(k),
             "t_start": float(t0 / sfreq),
             "t_stop": float((t1 + 1) / sfreq),
             "f_lo": float(freqs[f0]),
             "f_hi": float(freqs[f1]),
             "peak": float(pk),
             "area": int(a)}
            for k, a, t0, t1, f0, f1, pk in zip(ep.tolist(), *rows)]
