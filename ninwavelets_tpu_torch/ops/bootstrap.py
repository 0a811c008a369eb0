"""Bootstrap confidence intervals for trial-averaged planes (port of
``ninwavelets_tpu.ops.bootstrap``; percentile bootstrap over epochs): how
stable is this TFR / ITC / spectrum given the trials at hand?

A bootstrap replicate's mean is a weighted trial average, so all replicates
are one (B, E) @ (E, plane) contraction of the resampling counts, in full
float32 (``fp32_matmul("exact")``).  The per-pixel quantiles are JAX's
"linear" ones, taken from a sort along the replicate axis, a chunk of
pixels at a time (``torch.quantile`` refuses inputs above 2^24 elements,
and the chunks bound the memory to ``_PIXELS`` replicate means).

The resampling counts come from a ``torch.Generator`` seeded with ``seed``
on the data's device: one seed gives other replicates than the JAX
package's.  ``_boot_from_counts`` takes the counts in the JAX package's
padded (n_chunks, chunk, E) layout.  A numpy input goes to the card; a
tensor stays on its device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import as_float32
from .scattering import fp32_matmul

__all__ = ["bootstrap_ci"]

_CHUNK = 64
_PIXELS = 1 << 24   # replicate means held at once (n_boot x pixels)


def _boot_counts(seed: int, n_boot: int, e: int, chunk: int,
                 device) -> torch.Tensor:
    """(n_chunks, chunk, E) resampling counts: how often each trial is
    drawn (uniformly, with replacement) into each replicate."""
    n_chunks = -(-n_boot // chunk)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    draws = torch.randint(0, e, (n_chunks * chunk, e), generator=gen,
                          device=device)
    counts = torch.zeros((n_chunks * chunk, e), dtype=torch.int64,
                         device=device)
    counts.scatter_add_(1, draws, torch.ones_like(draws))
    return counts.reshape(n_chunks, chunk, e)


def _linear_weights(q: float, n: int):
    """JAX's "linear" quantile in float32: the two order statistics and
    their weights."""
    pos = np.float32(q) * np.float32(n - 1)
    low = float(np.floor(pos))
    hi_w = np.float32(pos - np.float32(low))
    lo_w = np.float32(1.0) - hi_w
    lo = int(min(max(low, 0), n - 1))
    hi = int(min(max(np.ceil(pos), 0), n - 1))
    return lo, hi, float(lo_w), float(hi_w)


def _boot_from_counts(x, counts, *, n_boot: int, lower: float,
                      upper: float):
    """``(lo, hi)`` bounds of the replicate means given the resampling
    ``counts`` (n_chunks, chunk, E) of ``_boot_counts``."""
    x = as_float32(x)
    e = x.shape[0]
    xf = x.reshape(e, -1)
    w = as_float32(counts, x.device).reshape(-1, e)[:n_boot] / e
    picks = [_linear_weights(q, n_boot) for q in (lower, upper)]
    step = max(1, _PIXELS // n_boot)
    out = [torch.empty(xf.shape[1], device=x.device) for _ in picks]
    for start in range(0, xf.shape[1], step):
        with fp32_matmul("exact"):
            means = w @ xf[:, start:start + step]     # (n_boot, pixels)
        srt = torch.sort(means, dim=0).values
        for o, (lo, hi, lo_w, hi_w) in zip(out, picks):
            o[start:start + step] = srt[lo] * lo_w + srt[hi] * hi_w
    return tuple(o.reshape(x.shape[1:]) for o in out)


def bootstrap_ci(trials, alpha: float = 0.05, n_boot: int = 1000,
                 seed: int = 0):
    """``(lower, upper)`` percentile-bootstrap confidence bounds for the
    trial mean of (E, ...) per-trial planes (e.g. single-trial power):
    resample trials with replacement ``n_boot`` times (each replicate's
    mean is one row of a counts-matrix contraction), take the ``alpha/2``
    and ``1 - alpha/2`` per-pixel quantiles.
    """
    trials = as_float32(trials)
    if trials.ndim < 2 or trials.shape[0] < 2:
        raise ValueError("expected (epochs >= 2, ...), got %s"
                         % (tuple(trials.shape),))
    counts = _boot_counts(seed, int(n_boot), trials.shape[0], _CHUNK,
                          trials.device)
    return _boot_from_counts(trials, counts, n_boot=int(n_boot),
                             lower=float(alpha / 2.0),
                             upper=float(1.0 - alpha / 2.0))
