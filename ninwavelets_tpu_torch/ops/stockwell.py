"""Stockwell transform (S-transform; Stockwell, Mansinha & Lowe, IEEE TSP
1996), port of ``ninwavelets_tpu.ops.stockwell``: a frequency-scaled
Gaussian window like a Morlet wavelet's, but with ABSOLUTELY referenced
phase (measured against e^{-i 2 pi f t} at t = 0), so S-transform phase
maps read like Fourier phase and the rows integrate back to the Fourier
spectrum.

S(f_k, t) = ifft_nu[ X(nu + f_k) * exp(-2 pi^2 nu^2 / f_k^2) ]: the rolled
signal spectrum (one gather of the spectrum at ``(j + bin_k) mod N``) times
a closed-form float32 Gaussian row, and one batched inverse FFT for all
rows.  ``mean_t S(f, t) = X(f) / N`` (the window has unit area), which
``istockwell`` inverts.

A numpy input goes to ``device`` (the card when None); a tensor stays on
its device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..device import as_float32, resolve_device

__all__ = ["stockwell", "istockwell"]


def _bins(freqs, n, sfreq) -> np.ndarray:
    b = np.rint(np.asarray(freqs, np.float64) * n / sfreq).astype(np.int64)
    if np.any(b <= 0) or np.any(b >= n // 2 + 1):
        raise ValueError("analysis frequencies must round to FFT bins in "
                         "(0, Nyquist]")
    return b


def _fftfreq(n: int, sfreq: float, device) -> torch.Tensor:
    """``jnp.fft.fftfreq(n, 1 / sfreq)`` in its own float32 arithmetic:
    the signed bin index over ``float32(n / sfreq)``."""
    i = torch.arange(n, dtype=torch.float32, device=device)
    k = torch.remainder(i + n // 2, n) - n // 2
    return k / torch.tensor((1.0 / sfreq) * n, dtype=torch.float32,
                            device=device)


def stockwell(signal, freqs, sfreq: float, device=None) -> torch.Tensor:
    """Complex64 (..., F, N) S-transform of a real (..., N) signal at the
    analysis frequencies ``freqs`` (Hz, rounded to FFT bins in (0,
    Nyquist]).  ``abs(...)**2`` is the S-spectrogram; the phase is
    absolutely referenced."""
    signal = as_float32(signal, device)
    bins = torch.from_numpy(_bins(freqs, signal.shape[-1], sfreq))
    return _stockwell_bins(signal, bins.to(signal.device), sfreq)


def _stockwell_bins(signal: torch.Tensor, bins: torch.Tensor,
                    sfreq: float) -> torch.Tensor:
    """``stockwell`` at the validated FFT ``bins`` of the analysis rows
    (``parallel.sharded_stockwell`` hands each rank its own rows)."""
    n = signal.shape[-1]
    spec = torch.fft.fft(signal)                       # (..., N)
    nu = _fftfreq(n, float(sfreq), signal.device)      # (N,) Hz, fft order
    # rolled spectra: row k holds X(nu + f_k) -> gather at (j + bin_k) % N
    idx = torch.remainder(torch.arange(n, device=signal.device)[None, :]
                          + bins[:, None], n)          # (F, N)
    shifted = spec[..., idx]                           # (..., F, N)
    f_k = bins.to(torch.float32) * (float(sfreq) / n)  # (F,) Hz
    gauss = torch.exp(-2.0 * (math.pi * nu[None, :]) ** 2
                      / torch.clamp(f_k[:, None], min=1e-20) ** 2)
    return torch.fft.ifft(shifted * gauss, dim=-1)


def istockwell(st, freqs, sfreq: float, n: int, device=None) -> torch.Tensor:
    """Inverse over the covered rows: (..., F, N) complex -> (..., n)
    float32.  Each row's time mean times ``n`` is its Fourier coefficient
    (``mean_t S(f, t) = X(f) / N``); the covered part of the spectrum is
    rebuilt with Hermitian completion and inverse-transformed.  Exact for
    signals whose energy lies on the analyzed bins; a band-limited
    projection otherwise.  Two freqs that round to one bin write it in
    an unspecified order (as in the JAX package); at the Nyquist bin the
    conjugate's write comes second and wins."""
    n = int(n)
    if not isinstance(st, torch.Tensor):
        st = torch.as_tensor(np.asarray(st), dtype=torch.complex64,
                             device=resolve_device(device))
    bins = torch.from_numpy(_bins(freqs, n, sfreq)).to(st.device)
    coef_r = torch.mean(st.real, dim=-1) * n           # (..., F)
    coef_i = torch.mean(st.imag, dim=-1) * n
    spec_r = torch.zeros((*st.shape[:-2], n), dtype=torch.float32,
                         device=st.device)
    spec_i = torch.zeros_like(spec_r)
    spec_r[..., bins] = coef_r
    spec_i[..., bins] = coef_i
    # Hermitian completion (real signals): X(-f) = conj X(f)
    neg = torch.remainder(n - bins, n)
    spec_r[..., neg] = coef_r
    spec_i[..., neg] = -coef_i
    return torch.fft.ifft(torch.complex(spec_r, spec_i)).real.contiguous()
