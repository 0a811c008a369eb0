"""IRASA: irregular-resampling separation of fractal and oscillatory
spectral components (port of ``ninwavelets_tpu.ops.irasa``; Wen & Liu
2016).

For each resampling factor ``h`` the geometric mean
``sqrt(PSD(h f) * PSD(f / h))`` leaves a power law untouched while an
oscillation's peak lands at two mismatched frequencies and is suppressed;
the median across an ``h`` set is the fractal estimate and ``PSD -
fractal`` the oscillatory residual.  The resampled spectra are evaluated
by the time-scaling theorem, ``PSD_{up h}(f) = PSD(h f)``, as linear
interpolation on the uniform Welch grid, with the positions in float32 as
the JAX package computes them.  The Welch PSD is frames x Hamming x rFFT.

A numpy input goes to ``device`` (the card when None); a tensor stays on
its device.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..device import as_float32
from .denoise import _median

__all__ = ["IrasaResult", "irasa", "welch_psd", "aperiodic_fit"]


class IrasaResult(NamedTuple):
    """``psd = fractal + oscillatory`` exactly, on ``freqs`` (Hz)."""
    freqs: torch.Tensor         # (Fb,)
    psd: torch.Tensor           # (..., Fb)
    fractal: torch.Tensor       # (..., Fb)
    oscillatory: torch.Tensor   # (..., Fb)


def welch_psd(signals, *, sfreq: float, nperseg: int = 1024,
              device=None) -> torch.Tensor:
    """(..., F) one-sided Welch PSD on the uniform grid
    ``arange(nperseg//2 + 1) * sfreq/nperseg``: Hamming window, 50%
    overlap, density scaling (``scipy.signal.welch``'s)."""
    x = as_float32(signals, device)
    n = x.shape[-1]
    hop = nperseg // 2
    if n >= nperseg:
        frames = x.unfold(-1, nperseg, hop)           # (..., S, nperseg)
    else:
        # one segment whose samples past the end repeat the last one, as
        # the JAX package's clamped gather reads them
        idx = torch.arange(nperseg, device=x.device).clamp(max=n - 1)
        frames = x[..., None, :].index_select(-1, idx)
    frames = frames - frames.mean(-1, keepdim=True)
    win = np.hamming(nperseg)
    spec = torch.fft.rfft(frames * torch.from_numpy(
        win.astype(np.float32)).to(x.device))
    p = spec.real.square() + spec.imag.square()
    p = p * (1.0 / (float(sfreq) * float((win ** 2).sum())))
    # one-sided: double everything but DC (and Nyquist for even nperseg)
    stop = -1 if nperseg % 2 == 0 else None
    p[..., 1:stop] *= 2.0
    return p.mean(-2)


def _eval_scaled(psd: torch.Tensor, scale: np.float32) -> torch.Tensor:
    """PSD evaluated at ``f * scale`` by linear interpolation on the
    uniform bin grid (index = bin * scale, in float32; clipped at the
    edges)."""
    nf = psd.shape[-1]
    pos = torch.arange(nf, dtype=torch.float32, device=psd.device) * \
        torch.tensor(scale, dtype=torch.float32, device=psd.device)
    lo = pos.floor().to(torch.int64).clamp(0, nf - 1)
    hi = (lo + 1).clamp(0, nf - 1)
    w = (pos - lo).clamp(0.0, 1.0)
    return psd[..., lo] * (1.0 - w) + psd[..., hi] * w


def irasa(signals, sfreq: float, band=(1.0, 40.0),
          hset: Optional[Sequence[float]] = None,
          nperseg: int = 1024, device=None) -> IrasaResult:
    """Fractal / oscillatory split of ``(..., N)`` signals over ``band``.

    ``hset`` defaults to Wen & Liu's 1.1..1.9 (step 0.05).  The median over
    ``hset`` averages the two middle values for an even count, as
    ``jnp.median`` does (``torch.median`` would take the lower)."""
    if hset is None:
        hset = np.arange(1.1, 1.95, 0.05)
    hset = np.asarray(hset, np.float64)
    if np.any(hset <= 1.0):
        raise ValueError("resampling factors must be > 1")
    psd = welch_psd(signals, sfreq=float(sfreq), nperseg=int(nperseg),
                    device=device)
    geo = []
    for h in hset:
        up = _eval_scaled(psd, np.float32(h))
        dn = _eval_scaled(psd, np.float32(1.0 / h))
        geo.append((up * dn).clamp(min=0.0).sqrt())
    fractal = _median(torch.stack(geo, -1))
    freqs = np.arange(nperseg // 2 + 1) * (sfreq / nperseg)
    keep = (freqs >= band[0]) & (freqs <= band[1])
    if not keep.any():
        raise ValueError(f"band {band} outside the Welch grid "
                         f"(df={sfreq / nperseg:.3f}, "
                         f"fmax={freqs[-1]:.1f})")
    kidx = torch.from_numpy(np.where(keep)[0]).to(psd.device)
    psd_b = psd.index_select(-1, kidx)
    frac_b = fractal.index_select(-1, kidx)
    return IrasaResult(
        torch.from_numpy(freqs[keep].astype(np.float32)).to(psd.device),
        psd_b, frac_b, psd_b - frac_b)


def aperiodic_fit(freqs, fractal):
    """(offset, exponent) of the log-log line ``log10 P = offset -
    exponent * log10 f`` fitted by least squares to the fractal component:
    the model-free counterpart of ``specparam``'s aperiodic parameters.
    Batched over the leading dims of ``fractal``."""
    fractal = as_float32(fractal)
    lf = torch.log10(as_float32(freqs, fractal.device))
    lp = torch.log10(fractal.clamp(min=1e-30))
    lfc = lf - lf.mean()
    slope = (lfc * (lp - lp.mean(-1, keepdim=True))).sum(-1) \
        / (lfc * lfc).sum()
    offset = lp.mean(-1) - slope * lf.mean()
    return offset, -slope
