"""Empirical Wavelet Transform (Gilles, IEEE TSP 2013), port of
``ninwavelets_tpu.ops.ewt``: detect the signal's own spectral supports,
build Meyer-style tight-frame filters on those boundaries, and extract one
mode per band.

The boundary detection and the filterbank are the JAX package's host numpy
code, copied; the transform is ``irfft(filters**2 * rfft(x))``, M modes
from one forward FFT.  The frame is tight, so ``modes.sum(-2)`` gives the
input back to float precision.

A numpy input goes to ``device`` (the card when None); a tensor stays on
its device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import as_float32, resolve_device

__all__ = ["ewt", "ewt_boundaries", "ewt_filterbank", "ewt_reconstruct"]


def ewt_boundaries(signal, sfreq: float, n_modes: int,
                   smooth: int = 0) -> np.ndarray:
    """(n_modes - 1,) spectral boundaries (Hz) by Gilles' "localmax"
    rule: the ``n_modes`` largest local maxima of the (optionally
    boxcar-smoothed) one-sided magnitude spectrum define the bands; the
    boundaries sit at the midpoints between consecutive peaks."""
    if isinstance(signal, torch.Tensor):
        signal = signal.detach().cpu().numpy()
    x = np.asarray(signal, np.float64).ravel()
    mag = np.abs(np.fft.rfft(x))
    if smooth > 1:
        kern = np.ones(smooth) / smooth
        mag = np.convolve(mag, kern, mode="same")
    n_modes = int(n_modes)
    if n_modes < 2:
        raise ValueError("need at least 2 modes")
    interior = mag[1:-1]
    is_max = (interior > mag[:-2]) & (interior >= mag[2:])
    idx = np.nonzero(is_max)[0] + 1
    if idx.size < n_modes:
        raise ValueError(
            f"spectrum has only {idx.size} local maxima; "
            f"cannot split into {n_modes} modes")
    top = np.sort(idx[np.argsort(mag[idx])[::-1][: n_modes]])
    bounds = 0.5 * (top[:-1] + top[1:])
    freqs = bounds * sfreq / x.size
    return np.asarray(freqs, np.float64)


def ewt_filterbank(boundaries_hz, n: int, sfreq: float,
                   gamma: float | None = None, device=None) -> torch.Tensor:
    """(M, n//2 + 1) float32 Meyer-style tight-frame filters on the rfft
    grid for ``M = len(boundaries) + 1`` bands: a lowpass up to the first
    boundary, bandpasses between consecutive boundaries, a highpass up to
    Nyquist.  ``gamma`` is the relative transition half-width (default
    half the largest that keeps the frame tight); squared filters sum to
    exactly 1, so summation reconstructs the signal."""
    b = np.sort(np.asarray(boundaries_hz, np.float64))
    if b.size == 0 or b[0] <= 0 or b[-1] >= sfreq / 2:
        raise ValueError("boundaries must lie strictly inside "
                         "(0, sfreq/2)")
    w = np.pi * b / (sfreq / 2.0)             # normalized to (0, pi)
    edges = np.concatenate([w, [np.pi]])
    ratios = (edges[1:] - edges[:-1]) / (edges[1:] + edges[:-1])
    gmax = float(min(ratios.min(), w[0] / np.pi))
    if gamma is None:
        gamma = 0.5 * gmax
    if not 0 < gamma < gmax:
        raise ValueError(f"gamma must be in (0, {gmax:.4f}) for a tight "
                         f"frame, got {gamma}")
    k = n // 2 + 1
    omega = np.pi * np.arange(k) / (n / 2.0)  # rfft bins on [0, pi]

    def beta(x):
        x = np.clip(x, 0.0, 1.0)
        return x ** 4 * (35 - 84 * x + 70 * x ** 2 - 20 * x ** 3)

    def lo_edge(wm):                          # rising sin transition
        return np.sin(0.5 * np.pi * beta(
            (omega - (1 - gamma) * wm) / (2 * gamma * wm)))

    def hi_edge(wm):                          # falling cos transition
        return np.cos(0.5 * np.pi * beta(
            (omega - (1 - gamma) * wm) / (2 * gamma * wm)))

    filters = []
    phi = np.where(omega <= (1 - gamma) * w[0], 1.0, hi_edge(w[0]))
    phi = np.where(omega >= (1 + gamma) * w[0], 0.0, phi)
    filters.append(phi)
    for m in range(len(w)):
        lo = w[m]
        hi = edges[m + 1]
        f = np.ones(k)
        f = np.where(omega < (1 - gamma) * lo, 0.0,
                     np.where(omega <= (1 + gamma) * lo, lo_edge(lo), f))
        if hi < np.pi:                        # last band keeps Nyquist
            f = np.where(omega > (1 + gamma) * hi, 0.0,
                         np.where(omega >= (1 - gamma) * hi, hi_edge(hi),
                                  f))
        filters.append(f)
    return torch.from_numpy(np.stack(filters).astype(np.float32)).to(
        resolve_device(device))


def _ewt_apply(signal: torch.Tensor, filters: torch.Tensor) -> torch.Tensor:
    """Modes through the SQUARED filters: one analysis + synthesis round
    trip per band, (..., N) -> (..., M, N)."""
    n = signal.shape[-1]
    spec = torch.fft.rfft(signal)
    return torch.fft.irfft(spec[..., None, :] * filters.square(), n=n,
                           dim=-1)


def ewt(signal_r, sfreq: float, n_modes: int = 3, boundaries=None,
        gamma: float | None = None, smooth: int = 0, device=None):
    """Empirical wavelet decomposition of a real (..., N) signal into
    ``(modes, boundaries_hz)``: modes (..., M, N) on the signal's device,
    boundaries host numpy.  The boundaries come from the FIRST signal of
    the batch unless given."""
    x = as_float32(signal_r, device)
    if boundaries is None:
        host = x.reshape(-1, x.shape[-1])[0].cpu().numpy()
        boundaries = ewt_boundaries(host, sfreq, n_modes, smooth)
    filters = ewt_filterbank(boundaries, x.shape[-1], sfreq, gamma,
                             device=x.device)
    return _ewt_apply(x, filters), np.asarray(boundaries)


def ewt_reconstruct(modes) -> torch.Tensor:
    """Inverse EWT: the tight frame makes synthesis a plain sum over the
    mode axis."""
    return as_float32(modes).sum(-2)
