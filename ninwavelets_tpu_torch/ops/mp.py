"""Matching pursuit: greedy sparse Gabor decomposition of a signal (port of
``ninwavelets_tpu.ops.mp``; Mallat & Zhang 1993, Durka's EEG MP maps).

Each iteration correlates the residual with every (scale, frequency) row of
a spectral Gabor dictionary at every translation, ``ifft(fft(r) * h_hat)``,
takes the global argmax (the first maximum, in the flat ``(row, u)``
order, as ``jnp.argmax``), and removes the atom by the exact rank-2
(cos / sin) projection, so the residual energy never grows.  The signals
ride a leading batch axis and the loop runs over the atoms.  Correlations
are circular.  The dictionary is the JAX package's host numpy code,
copied.

A numpy input goes to ``device`` (the card when None); a tensor stays on
its device.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..device import as_float32
from .scattering import fp32_matmul

__all__ = ["MPResult", "gabor_dictionary", "matching_pursuit", "mp_tfr"]


class MPResult(NamedTuple):
    """Greedy decomposition: the input's leading dims, then one entry per
    atom.  ``amplitude`` / ``phase`` parametrize the real atom ``A
    exp(-pi (t-u)^2/s^2) cos(2 pi xi (t-u) + phi)``; ``scale_s`` is ``s``
    in seconds, ``time_s`` the center ``u``, ``freq_hz`` the carrier
    ``xi``; ``energy`` the residual energy the atom removed; ``residual``
    the signal left after all atoms."""
    amplitude: torch.Tensor     # (..., K)
    phase: torch.Tensor         # (..., K)
    scale_s: torch.Tensor       # (..., K)
    time_s: torch.Tensor        # (..., K)
    freq_hz: torch.Tensor       # (..., K)
    energy: torch.Tensor        # (..., K)
    residual: torch.Tensor      # (..., N)


def gabor_dictionary(n: int, sfreq: float,
                     scales_s: Optional[Sequence[float]] = None,
                     freqs: Optional[Sequence[float]] = None):
    """Spectral Gabor dictionary ``(rows, meta)``: ``rows`` the (S*F, N)
    float32 analytic-atom spectra (L2-normalized per row), ``meta`` the
    (S*F, 2) float64 (scale_s, freq_hz) of each row; host numpy.

    Defaults: dyadic scales from 4 cycles of the highest frequency up to
    N/2 samples; a linear frequency grid up to 0.4*sfreq."""
    if freqs is None:
        freqs = np.linspace(sfreq / n, 0.4 * sfreq, 64)
    freqs = np.asarray(freqs, np.float64)
    if scales_s is None:
        smin = max(4.0 / freqs.max(), 8.0 / sfreq)
        smax = (n / 2.0) / sfreq
        n_s = max(int(np.ceil(np.log2(smax / smin))) + 1, 2)
        scales_s = smin * 2.0 ** np.arange(n_s)
        scales_s = scales_s[scales_s * sfreq <= n / 2]
    scales_s = np.asarray(scales_s, np.float64)

    # FT[exp(-pi t^2/s^2) e^{i 2 pi xi t}](nu) = s exp(-pi s^2 (nu-xi)^2)
    k = np.arange(n)
    nu = np.where(k < (n + 1) // 2, k, k - n) * (sfreq / n)
    rows = []
    meta = []
    for s in scales_s:
        for xi in freqs:
            spec = s * np.exp(-np.pi * s ** 2 * (nu - xi) ** 2)
            norm = np.sqrt((spec ** 2).sum() / n)   # Parseval, circular
            if norm < 1e-20:
                continue
            rows.append(spec / norm)
            meta.append((s, xi))
    return np.asarray(rows, np.float32), np.asarray(meta, np.float64)


def _atom_pair(n: int, sfreq: float, s, xi, u):
    """Unnormalized quadrature atoms at (scale s [s], freq xi [Hz], center
    u [samples]), each (B,), on the circular grid: (gc, gs) (B, N) =
    envelope times (cos, sin)."""
    t = torch.arange(n, dtype=torch.float32, device=s.device)
    d = torch.remainder(t - u[:, None] + n / 2.0, float(n)) - n / 2.0
    d = d / sfreq                                   # seconds
    env = torch.exp(-math.pi * d ** 2 / s.clamp(min=1e-12)[:, None] ** 2)
    ang = 2.0 * math.pi * xi[:, None] * d
    return env * torch.cos(ang), env * torch.sin(ang)


def _mp_flat(flat, bank, meta, *, n_atoms: int, sfreq: float):
    """(B, N) signals, (R, N) real bank, (R, 2) float32 meta -> (residual
    (B, N), (amp, phi, s, u_s, xi, energy) each (B, K))."""
    n = flat.shape[-1]
    r = flat
    outs = []
    for _ in range(int(n_atoms)):
        rf = torch.fft.fft(r)
        # bank rows are real Gaussians in frequency, so the product is the
        # spectrum of the circular cross-correlation over every u
        corr = torch.fft.ifft(rf[:, None, :] * bank)          # (B, R, N)
        mag = corr.real.square() + corr.imag.square()
        idx = mag.reshape(mag.shape[0], -1).argmax(-1)
        del corr, mag
        row = torch.div(idx, n, rounding_mode="floor")
        u = (idx % n).to(torch.float32)
        s, xi = meta[row, 0], meta[row, 1]
        gc, gs = _atom_pair(n, sfreq, s, xi, u)
        # exact rank-2 projection onto span{gc, gs}
        a = (gc * gc).sum(-1)
        b = (gs * gs).sum(-1)
        c = (gc * gs).sum(-1)
        p = (r * gc).sum(-1)
        q = (r * gs).sum(-1)
        det = (a * b - c * c).clamp(min=1e-20)
        alpha = (b * p - c * q) / det
        beta = (a * q - c * p) / det
        r = r - alpha[:, None] * gc - beta[:, None] * gs
        outs.append((torch.sqrt(alpha ** 2 + beta ** 2),
                     torch.atan2(-beta, alpha), s, u / sfreq, xi,
                     alpha * p + beta * q))
    return r, tuple(torch.stack(o, -1) for o in zip(*outs))


def matching_pursuit(signals_r, n_atoms: int, sfreq: float,
                     scales_s: Optional[Sequence[float]] = None,
                     freqs: Optional[Sequence[float]] = None,
                     device=None) -> MPResult:
    """Greedy Gabor decomposition of ``(..., N)`` signals into ``n_atoms``
    atoms each (see :class:`MPResult`).  One iteration costs one (B, R, N)
    complex correlation, R = scales x frequencies."""
    x = as_float32(signals_r, device)
    lead = x.shape[:-1]
    n = x.shape[-1]
    rows, meta = gabor_dictionary(n, sfreq, scales_s, freqs)
    residual, outs = _mp_flat(
        x.reshape(-1, n), torch.from_numpy(rows).to(x.device),
        torch.from_numpy(meta.astype(np.float32)).to(x.device),
        n_atoms=int(n_atoms), sfreq=float(sfreq))
    shape = lead + (int(n_atoms),)
    return MPResult(*(o.reshape(shape) for o in outs),
                    residual.reshape(lead + (n,)))


def mp_tfr(result: MPResult, n: int, sfreq: float, f_grid,
           t_decim: int = 16) -> torch.Tensor:
    """(..., F, ceil(N/t_decim)) MP energy map (Durka-style): each atom
    paints its closed-form Wigner blob, a 2-D Gaussian at (freq_hz,
    time_s) with time width ``s/2`` and frequency width ``1/(2 pi s)``,
    scaled to its energy.  The product runs in full float32."""
    amp = result.amplitude
    f_grid = as_float32(f_grid, amp.device)
    n_t = -(-n // t_decim)
    t_grid = (torch.arange(n_t, dtype=torch.float32, device=amp.device)
              + 0.5) * t_decim / sfreq
    s, u, xi, en = (result.scale_s, result.time_s, result.freq_hz,
                    result.energy)
    sc = s.clamp(min=1e-12)
    sig_f = 1.0 / (2.0 * math.pi * sc)
    fprof = torch.exp(-0.5 * ((f_grid - xi[..., None]) / sig_f[..., None])
                      ** 2)
    fprof = fprof / fprof.sum(-1, keepdim=True).clamp(min=1e-20)
    sig_t = sc / 2.0
    tprof = torch.exp(-0.5 * ((t_grid - u[..., None]) / sig_t[..., None])
                      ** 2)
    tprof = tprof / tprof.sum(-1, keepdim=True).clamp(min=1e-20)
    scaled = fprof * en.clamp(min=0.0)[..., None]
    with fp32_matmul("exact"):
        return torch.einsum("...kf,...kt->...ft", scaled, tprof)
