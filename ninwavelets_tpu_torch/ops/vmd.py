"""Variational Mode Decomposition (Dragomiretskiy & Zosso, IEEE TSP 2014)
and its multivariate form (Rehman & Aftab, IEEE TSP 2019), port of
``ninwavelets_tpu.ops.vmd``, with the instantaneous attributes and the
Hilbert spectrum of adaptive modes.

Every ADMM update is closed-form on the rfft grid: the mode update is a
Wiener filter ``(x - sum_others + lam/2) / (1 + alpha (f - f_k)^2)``, the
center-frequency update a power-weighted mean.  The fixed iteration count
runs as a Python loop of these elementwise updates, the modes updated
Gauss-Seidel style in the reference algorithm's order.

The Hilbert spectrum writes each mode's instantaneous energy into the
frequency bin of its instantaneous frequency.  Each (mode, signal, time)
cell takes exactly one value, so the plane is a scatter into distinct
cells followed by a sum over the modes: no two values meet in one cell and
the result does not depend on the order of the writes.

A numpy input goes to ``device`` (the card when None); a tensor stays on
its device.
"""
from __future__ import annotations

import math

import torch

from ..device import as_float32

__all__ = ["vmd", "mvmd", "instantaneous", "hilbert_spectrum"]


def _admm(xhat, freqs, w, *, alpha, tau, n_iter, mode_axis, reduce_dims):
    """The fixed-count ADMM loop shared by ``vmd`` and ``mvmd``: ``xhat``
    (..., [C,] K_bins) complex spectra; ``w`` (..., M) initial centers;
    modes stacked at ``mode_axis`` of ``u``; each center is the
    power-weighted mean over ``reduce_dims``.  The Wiener filter divides
    the real and imaginary parts by its real denominator, the quotient
    the JAX package's complex division gives for a zero imaginary part.
    Returns (u, w)."""
    n_modes = w.shape[-1]
    tail = xhat.shape[w.ndim - 1:]            # (K_bins,) or (C, K_bins)
    u = torch.zeros(w.shape + tail, dtype=torch.complex64,
                    device=xhat.device)
    lam = torch.zeros_like(xhat)
    for _ in range(int(n_iter)):
        for k in range(n_modes):
            others = u.sum(mode_axis) - u.select(mode_axis, k)
            num = xhat - others + 0.5 * lam
            wk = w[..., k].reshape(w.shape[:-1] + (1,) * len(tail))
            den = 1.0 + alpha * torch.square(freqs - wk)
            uk = torch.complex(num.real / den, num.imag / den)
            u.select(mode_axis, k).copy_(uk)
            p = torch.square(torch.abs(uk))
            w[..., k] = (freqs * p).sum(reduce_dims) / p.sum(
                reduce_dims).clamp(min=1e-20)
        lam = lam + tau * (xhat - u.sum(mode_axis))
    return u, w


def _vmd(signal, *, n_modes, alpha, tau, n_iter, sfreq, multi):
    n = signal.shape[-1]
    k_bins = n // 2 + 1
    freqs = torch.arange(k_bins, dtype=torch.float32,
                         device=signal.device) * (sfreq / n)
    xhat = torch.fft.rfft(signal)
    batch = signal.shape[:-2] if multi else signal.shape[:-1]
    w0 = (torch.arange(1, n_modes + 1, dtype=torch.float32,
                       device=signal.device) / (n_modes + 1.0)) \
        * (sfreq / 2.0)
    w = w0.expand(batch + (n_modes,)).clone()
    mode_axis, dims = (-3, (-2, -1)) if multi else (-2, -1)
    u, w = _admm(xhat, freqs, w, alpha=alpha, tau=tau, n_iter=n_iter,
                 mode_axis=mode_axis, reduce_dims=dims)
    modes = torch.fft.irfft(u, n=n, dim=-1)
    order = torch.argsort(w, dim=-1, stable=True)
    idx = order[(...,) + (None,) * (-mode_axis - 1)].expand(modes.shape)
    return torch.gather(modes, mode_axis, idx), torch.gather(w, -1, order)


def vmd(signal_r, sfreq: float, n_modes: int = 3, alpha: float = 2000.0,
        tau: float = 0.0, n_iter: int = 200, device=None):
    """``(modes, center_freqs)`` of a real (..., N) signal: modes
    (..., K, N) sorted by ascending center frequency (Hz, (..., K)).

    ``alpha`` is the bandwidth penalty in the vmdpy / MATLAB convention
    (it enters as ``alpha ((f - f_k)/sfreq)^2``); ``tau`` the dual ascent
    rate (0 disables the exact-reconstruction constraint); ``n_iter`` the
    fixed ADMM iteration count."""
    x = as_float32(signal_r, device)
    return _vmd(x, n_modes=int(n_modes), alpha=float(alpha) / float(
        sfreq) ** 2, tau=float(tau), n_iter=int(n_iter),
                sfreq=float(sfreq), multi=False)


def mvmd(signals_r, sfreq: float, n_modes: int = 3,
         alpha: float = 2000.0, tau: float = 0.0, n_iter: int = 200,
         device=None):
    """Multivariate VMD of a real (..., C, N) block: ``(modes,
    center_freqs)`` with modes (..., K, C, N) and ONE center frequency per
    mode shared by the channels.  Same knobs as ``vmd``."""
    x = as_float32(signals_r, device)
    if x.ndim < 2:
        raise ValueError("expected (..., channels, N), got %s"
                         % (tuple(x.shape),))
    return _vmd(x, n_modes=int(n_modes), alpha=float(alpha) / float(
        sfreq) ** 2, tau=float(tau), n_iter=int(n_iter),
                sfreq=float(sfreq), multi=True)


def instantaneous(modes, sfreq: float, smooth: int = 0, device=None):
    """``(if_hz, amplitude)`` of (..., M, N) band-limited modes: the
    analytic signal per mode, the instantaneous frequency from the wrapped
    phase difference (optionally boxcar-smoothed over ``smooth`` samples,
    edge-padded), the amplitude as the analytic envelope."""
    modes = as_float32(modes, device)
    sfreq = float(sfreq)
    n = modes.shape[-1]
    spec = torch.fft.fft(modes)
    gain = torch.zeros(n, device=modes.device)
    gain[0] = 1.0
    gain[1:(n + 1) // 2] = 2.0
    if n % 2 == 0:
        gain[n // 2] = 1.0
    z = torch.fft.ifft(spec * gain)
    amp = z.abs()
    dphi = torch.diff(z.angle(), dim=-1)
    dphi = torch.remainder(dphi + math.pi, 2.0 * math.pi) - math.pi
    inst = dphi * (sfreq / (2.0 * math.pi))
    inst = torch.cat([inst[..., :1], inst], -1)
    if smooth > 1:
        pad = smooth // 2
        padded = torch.cat([inst[..., :1].expand(*inst.shape[:-1], pad),
                            inst, inst[..., -1:].expand(
                                *inst.shape[:-1], smooth - 1 - pad)], -1)
        kern = torch.full((smooth,), 1.0 / smooth, device=modes.device)
        inst = (padded.unfold(-1, smooth, 1) * kern).sum(-1)
    return inst, amp


def hilbert_spectrum(modes, sfreq: float, n_bins: int = 64,
                     fmax: float | None = None, smooth: int = 5,
                     device=None) -> torch.Tensor:
    """(..., n_bins, N) Hilbert spectrum of (..., M, N) adaptive modes:
    each mode's instantaneous energy ``a(t)^2`` in the frequency bin of its
    instantaneous frequency, summed over the modes (bin k spans
    ``[k, k+1) * fmax / n_bins`` Hz; ``fmax`` defaults to Nyquist)."""
    if_hz, amp = instantaneous(modes, sfreq, smooth, device)
    fmax = float(sfreq / 2.0 if fmax is None else fmax)
    n = if_hz.shape[-1]
    step = fmax / n_bins
    rows = (if_hz / step).to(torch.int32).clamp(0, n_bins - 1).to(
        torch.int64).reshape(-1, 1, n)
    energy = (amp * amp).reshape(-1, 1, n)
    out = torch.zeros(rows.shape[0], n_bins, n, device=if_hz.device)
    out.scatter_(1, rows, energy)       # one value a (signal, time) cell
    return out.reshape(*if_hz.shape[:-1], n_bins, n).sum(-3)
