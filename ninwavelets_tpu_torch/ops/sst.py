"""Synchrosqueezed CWT: frequency-reassigned scalograms (port of
``ninwavelets_tpu.ops.sst``).

Synchrosqueezing (Daubechies, Lu & Wu 2011) moves each (f, t) cell's energy
to the analysis row nearest its instantaneous frequency

    omega(f, t) = Im[ dW/dt / W ] / (2 pi),

collapsing the wavelet's frequency smear onto the ridge.  The time
derivative costs one extra bank multiply (the spectrum times ``i 2 pi nu``),
so the transform is two CWTs, an elementwise phase transform and a
reassignment.

This module is the plain path: it serves the CPU, and it is what the fused
CUDA kernels (``ops.fused.fused_ssq_mean_power`` and
``fused_ssq_power_from_bank``) are held against on the card.  The row map
is the JAX package's: a closed form for regular grids (``uniform_grid_hint``)
or a left-bisect count of the row edges (``torch.searchsorted``) for
irregular ones.  The reassignment is ``scatter_add_`` along the row axis (the
TPU's select-reduce scan computes the same sums in another order).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .cwt import analytic_spectrum

__all__ = ["ssq_power_from_bank", "ssq_power", "ssq_mean_power_from_bank",
           "ssq_mean_power", "uniform_grid_hint"]

#: Bytes of the two complex coefficient planes (W and dW) of one epoch chunk
#: of ``ssq_mean_power_from_bank``.  The plain path holds about three times
#: that at once (power, frequency, row and output planes beside them): about
#: 6 GB of the card's 80 GB, 10 epochs a chunk at 64 x 2048 x 100 rows.
EPOCH_CHUNK_BYTES = 2 << 30


def _bin_nu(n: int, sfreq: float, device=None) -> torch.Tensor:
    """Signed physical frequency of each FFT bin (Hz): k*sfreq/n for the
    lower half, negative mirror for the upper half."""
    k = torch.arange(n, device=device)
    k = torch.where(k < (n + 1) // 2, k, k - n).to(torch.float32)
    return k * (sfreq / n)


def uniform_grid_hint(freqs):
    """Closed-form row-mapping hint for (piecewise-)regular grids, else None.

    * arithmetic (uniform) grids -> ``("lin", edges0, df)``:
      ``idx = ceil((omega - edges0) / df)``
    * geometric (log-spaced) grids -> ``("log", log(edges0), log(ratio))``:
      the midpoint edges ``e_k = f0 r^k (1+r)/2`` are uniform in log, so
      ``idx = ceil((log omega - log e0) / log r)`` (omega <= 0 maps to row
      0: it is below every edge).
    * piecewise-regular grids -> ``("pw", ((kind, p0, step, m), ...))``:
      the row edges split greedily into maximal arithmetic/geometric runs,
      whose closed-form counts (each clipped to its run length ``m``) sum to
      the global left-bisect count.  Only returned when ``8*S < n_edges``;
      irregular grids return None (the edge count).

    Detected on host frequencies; ascending grids only.  A float32
    ``linspace`` often fails the ``rtol=1e-6`` arithmetic test and comes
    back ``"pw"`` (``np.linspace(2, 100, 100).astype(np.float32)`` gives 9
    segments).  The fused kernel takes only a single "lin" or "log" map.
    """
    f = np.asarray(freqs, np.float64)
    if f.size < 2 or f[0] <= 0 or np.any(np.diff(f) <= 0):
        return None
    d = np.diff(f)
    if np.allclose(d, d[0], rtol=1e-6, atol=0.0):
        return ("lin", float((f[0] + f[1]) / 2.0), float(d[0]))
    r = f[1:] / f[:-1]
    if r[0] > 1 and np.allclose(r, r[0], rtol=1e-6, atol=0.0):
        e0 = f[0] * (1.0 + r[0]) / 2.0
        return ("log", float(np.log(e0)), float(np.log(r[0])))
    edges = 0.5 * (f[1:] + f[:-1])
    segs = _edge_segments(edges)
    if segs is not None and 8 * len(segs) < edges.size:
        return ("pw", segs)
    return None


def _edge_segments(edges: np.ndarray, rtol: float = 1e-6):
    """Greedy maximal arithmetic/geometric runs over the (ascending) row
    edges, as ``((kind, p0, step, m), ...)`` with ``p0``/``step`` in log
    space for geometric runs.  At each position the longer of the two run
    types wins (ties -> arithmetic)."""
    m = edges.size
    segs = []
    i = 0
    while i < m:
        if i == m - 1:
            segs.append(("lin", float(edges[i]), 1.0, 1))
            break
        d = edges[i + 1] - edges[i]
        j_lin = i + 1
        while (j_lin + 1 < m
               and abs(edges[j_lin + 1] - edges[j_lin] - d) <= rtol * d):
            j_lin += 1
        j_log = i
        ratio = edges[i + 1] / edges[i]
        if edges[i] > 0 and ratio > 1:
            j_log = i + 1
            while (j_log + 1 < m
                   and abs(edges[j_log + 1] / edges[j_log] - ratio)
                   <= rtol * ratio):
                j_log += 1
        if j_log > j_lin:
            segs.append(("log", float(np.log(edges[i])),
                         float(np.log(ratio)), j_log - i + 1))
            i = j_log + 1
        else:
            segs.append(("lin", float(edges[i]), float(d), j_lin - i + 1))
            i = j_lin + 1
    if sum(s[3] for s in segs) != m:
        raise RuntimeError("edge segments do not cover the edges")
    return tuple(segs)


def _closed_form_count(omega: torch.Tensor, kind: str, p0: float,
                       step: float) -> torch.Tensor:
    """The left-bisect count of one regular run of edges, unclipped."""
    if kind == "log":
        safe = torch.log(torch.clamp(omega, min=1e-30))
        return torch.where(omega > 0.0, torch.ceil((safe - p0) / step),
                           torch.zeros_like(omega))
    return torch.ceil((omega - p0) / step)


def _row_index(omega: torch.Tensor, n_edges: int, f_grid,
               uniform_grid) -> torch.Tensor:
    """Target row of every cell: the number of row edges (midpoints of the
    analysis grid) strictly below omega, clipped to [0, n_edges]."""
    if uniform_grid is None:
        f_grid = torch.as_tensor(np.asarray(f_grid, np.float32),
                                 device=omega.device)
        edges = 0.5 * (f_grid[1:] + f_grid[:-1])
        return torch.searchsorted(edges, omega.contiguous(), right=False)
    if uniform_grid[0] == "pw":
        cnt = torch.zeros_like(omega)
        for kind, p0, step, m in uniform_grid[1]:
            cnt += torch.clamp(_closed_form_count(omega, kind, p0, step),
                               0.0, float(m))
    else:
        cnt = _closed_form_count(omega, *uniform_grid)
    return torch.clamp(cnt, 0, n_edges).to(torch.int64)


def _reassigned_power(signal: torch.Tensor, bank: torch.Tensor, f_grid,
                      sfreq: float, interpolate: bool, rel_threshold: float,
                      uniform_grid=None) -> torch.Tensor:
    """Core reassignment: (..., N) x (F, N) -> (..., F, N).

    ``f_grid`` (the F analysis frequencies) is read only by the edge count
    of an irregular grid (``uniform_grid`` None); a closed-form map needs
    only F.  The noise-gate floor is per leading element: ``rel_threshold``
    times the max of that element's (F, N) power plane.
    """
    n = signal.shape[-1]
    n_f = bank.shape[0]
    spec = analytic_spectrum(signal, interpolate)[..., None, :]
    w = torch.fft.ifft(spec * bank)
    dw = torch.fft.ifft(spec * (bank * (2j * math.pi
                                        * _bin_nu(n, sfreq, bank.device))))
    power = torch.square(w.real) + torch.square(w.imag)
    # omega = Im(dW / W) / 2pi, as Im(dW conj W) / (2pi |W|^2), guarded.
    num = dw.imag * w.real - dw.real * w.imag
    del w, dw
    omega = num / (2.0 * math.pi * torch.clamp(power, min=1e-30))
    idx = _row_index(omega, n_f - 1, f_grid, uniform_grid)
    del omega, num
    # Noise gate: weak cells keep their energy in place (their phase is
    # noise).
    floor = rel_threshold * torch.amax(power, dim=(-2, -1), keepdim=True)
    src = torch.arange(n_f, device=idx.device)[:, None].expand(n_f, n)
    idx = torch.where(power >= floor, idx, src)
    return torch.zeros_like(power).scatter_add_(-2, idx, power)


def ssq_power_from_bank(signal: torch.Tensor, bank: torch.Tensor, freqs,
                        sfreq: float, interpolate: bool = True,
                        rel_threshold: float = 1e-6,
                        uniform_grid=None) -> torch.Tensor:
    """Synchrosqueezed power: (..., N) -> (..., F, N), the energy of each
    scalogram cell reassigned to the analysis row nearest its
    instantaneous frequency.

    Args:
      signal: (..., N) real.
      bank: (F, N) frequency-domain bank (real: analytic families).
      freqs: the F analysis frequencies (Hz), monotone increasing; both the
        source rows and the reassignment target grid.
      rel_threshold: cells with power below ``rel_threshold * max power``
        (per leading element) keep their energy in place.
      uniform_grid: the ``uniform_grid_hint`` of ``freqs``, or None for the
        edge count.

    Returns (..., F, N) float32; the total energy equals the plain
    scalogram's (reassignment only moves energy between rows).
    """
    return _reassigned_power(signal, bank, freqs, sfreq, interpolate,
                             rel_threshold, uniform_grid)


def _epoch_block(signals_shape, n_rows,
                 budget_bytes: int = EPOCH_CHUNK_BYTES) -> int:
    """Epochs per chunk such that the two complex coefficient planes of a
    chunk stay under ``budget_bytes``."""
    inner = math.prod(int(s) for s in signals_shape[1:-1])
    per_epoch = 2 * 8 * inner * int(n_rows) * int(signals_shape[-1])
    return max(1, budget_bytes // max(per_epoch, 1))


def ssq_mean_power_from_bank(signals: torch.Tensor, bank: torch.Tensor,
                             freqs, sfreq: float, interpolate: bool = True,
                             rel_threshold: float = 1e-6,
                             uniform_grid=None) -> torch.Tensor:
    """Epoch-mean synchrosqueezed power: (E, ..., N) -> (..., F, N).

    Epochs go through in chunks sized by ``EPOCH_CHUNK_BYTES``, so memory
    is bounded whatever E.  The noise gate is per (epoch, channel), so the
    chunking is exact: the result is the mean of ``ssq_power_from_bank``
    over epochs.
    """
    e = signals.shape[0]
    block = min(int(e), _epoch_block(signals.shape, bank.shape[0]))
    total = None
    for lo in range(0, e, block):
        part = _reassigned_power(signals[lo:lo + block], bank, freqs, sfreq,
                                 interpolate, rel_threshold,
                                 uniform_grid).sum(0)
        total = part if total is None else total.add_(part)
    return total / e


def ssq_power(signal: torch.Tensor, bank: torch.Tensor, freqs, sfreq: float,
              interpolate: bool = True,
              rel_threshold: float = 1e-6) -> torch.Tensor:
    """Per-signal synchrosqueezed power (..., N) -> (..., F, N), the row map
    detected on the host frequencies.  A real CUDA workload the kernel takes
    (``ops.fused.supports_ssq`` on one signal, a single "lin" / "log" map)
    runs ``fused_ssq_power_from_bank``; everything else the plain path."""
    from .fused import (fused_ssq_power_from_bank, signal_batch,
                        ssq_kernel_takes)
    freqs = np.asarray(freqs, np.float32)
    hint = uniform_grid_hint(freqs)
    if ssq_kernel_takes(signal_batch(signal), bank, hint, interpolate):
        return fused_ssq_power_from_bank(
            signal, bank, uniform_grid=hint, sfreq=sfreq,
            rel_threshold=rel_threshold, interpolate=interpolate)
    return ssq_power_from_bank(signal, bank, freqs, sfreq, interpolate,
                               rel_threshold, hint)


def ssq_mean_power(signals: torch.Tensor, bank: torch.Tensor, freqs,
                   sfreq: float, interpolate: bool = True,
                   rel_threshold: float = 1e-6) -> torch.Tensor:
    """Epoch-mean synchrosqueezed power (E, C, N) -> (C, F, N), the row map
    detected on the host frequencies.  A real CUDA workload that
    ``ops.fused.supports_ssq`` accepts runs the two kernels
    (``fused_ssq_mean_power``); everything else the plain path."""
    from .fused import fused_ssq_mean_power, ssq_kernel_takes
    freqs = np.asarray(freqs, np.float32)
    hint = uniform_grid_hint(freqs)
    if ssq_kernel_takes(signals, bank, hint, interpolate):
        return fused_ssq_mean_power(
            signals, bank, uniform_grid=hint, sfreq=sfreq,
            rel_threshold=rel_threshold, interpolate=interpolate)
    return ssq_mean_power_from_bank(signals, bank, freqs, sfreq, interpolate,
                                    rel_threshold, hint)
