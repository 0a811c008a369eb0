"""The reference computations, in blocks so that each fits on one card.

Formulas, with ``w = (k * sfreq / n) / f`` the frequency of FFT bin ``k``
of an ``n``-sample signal over the analysis frequency ``f``:

* generalized Morse wavelet (Lilly & Olhede 2012, peak-normalized as the
  upstream ``Morse`` class has it): ``2 H(w) w**b exp((b/r)(1 - w**r))``,
  ``H(0) = 0``;
* analytic path (``interpolate=True``): bins ``k >= n // 2`` of the signal
  spectrum and of the bank are zeroed;
* coefficients ``ifft(bank * fft(x))``; power ``|c|**2``; epoch-mean power
  ``mean_e |c|**2``; inter-trial coherence ``|mean_e c / |c||``;
* z-score baseline: per (channel, frequency) row, ``(p - mean) / std`` over
  samples ``[int(start * sfreq), int(stop * sfreq))``, population std, a
  zero std taken as 1;
* long recordings: windows of ``window`` samples, each extended by ``halo``
  samples of the recording on both sides (zeros outside it), transformed
  at the extended length, and the halos discarded.  The halo is the
  one-sided distance at which the envelope of the slowest wavelet falls
  below ``tol`` of its peak, rounded up so that ``window + 2 * halo`` is a
  power of two.
"""
from __future__ import annotations

import math

import numpy as np
import torch


class Precision:
    """How the reference computes.

    ``float64``: every stage in float64 / complex128.  ``bfloat16``: every
    stage computed in float32 / complex64 and its result stored in bfloat16
    (both parts of a complex number rounded): the control, one precision
    below the float32 that the configurations state.
    """

    NAMES = ("float64", "bfloat16")

    def __init__(self, name: str = "float64") -> None:
        if name not in self.NAMES:
            raise ValueError(f"precision must be one of {self.NAMES}")
        self.name = name
        wide = name == "float64"
        self.real = torch.float64 if wide else torch.float32
        self.complex = torch.complex128 if wide else torch.complex64

    def round(self, t: torch.Tensor) -> torch.Tensor:
        if self.name == "float64":
            return t
        if t.is_complex():
            return torch.complex(_bf16(t.real), _bf16(t.imag))
        return _bf16(t)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def _morse(w: torch.Tensor, b: float, r: float) -> torch.Tensor:
    pos = w > 0
    safe = torch.where(pos, w, torch.ones_like(w))
    val = 2.0 * torch.exp(b * torch.log(safe) + (b / r) * (1.0 - safe ** r))
    return torch.where(pos, val, torch.zeros_like(val))


def morse_bank(freqs, n: int, sfreq: float, b: float, r: float,
               analytic: bool, prec: Precision, device) -> torch.Tensor:
    """The (F, n) real bank, evaluated in float64 and stored in ``prec``."""
    k = torch.arange(n, dtype=torch.float64, device=device)
    f = torch.as_tensor(np.asarray(freqs, np.float64), device=device)
    bank = _morse(k[None, :] * (sfreq / n) / f[:, None], b, r)
    if analytic:
        bank[:, n // 2:] = 0
    return prec.round(bank.to(prec.real))


def _spectrum(x: torch.Tensor, analytic: bool, prec: Precision
              ) -> torch.Tensor:
    n = x.shape[-1]
    spec = torch.fft.fft(prec.round(x.to(prec.real)))
    if analytic:
        spec[..., n // 2:] = 0
    return prec.round(spec)


def _coefficients(x, bank, analytic, prec):
    """(..., n) signals -> (..., F, n) coefficients."""
    spec = _spectrum(x, analytic, prec)
    return prec.round(torch.fft.ifft(prec.round(spec[..., None, :] * bank)))


def epochs_planes(data: np.ndarray, freqs, sfreq: float, b: float, r: float,
                  analytic: bool, baseline, prec: Precision, device,
                  channels_per_block: int = 4):
    """Yield ``(channels, z-scored power, itc)`` for blocks of channels of
    the (E, C, N) epochs ``data``: two (c, F, N) planes a block, in
    ``prec.real``."""
    n_epochs, n_channels, n = data.shape
    bank = morse_bank(freqs, n, sfreq, b, r, analytic, prec, device)
    lo, hi = int(baseline[0] * sfreq), int(baseline[1] * sfreq)
    for c0 in range(0, n_channels, channels_per_block):
        sel = slice(c0, min(c0 + channels_per_block, n_channels))
        x = torch.from_numpy(np.ascontiguousarray(data[:, sel])).to(device)
        coef = _coefficients(x, bank, analytic, prec)
        power = prec.round(prec.round(coef.real ** 2 + coef.imag ** 2)
                           .sum(0) / n_epochs)
        itc = prec.round(torch.abs(prec.round(coef / torch.abs(coef))
                                   .sum(0) / n_epochs))
        del coef
        window = power[..., lo:hi]
        mean = window.mean(-1, keepdim=True)
        std = torch.sqrt(((window - mean) ** 2).mean(-1, keepdim=True))
        std = torch.where(std > 0, std, torch.ones_like(std))
        yield sel, prec.round((power - mean) / std), itc


def halo_samples(b: float, r: float, min_freq: float, sfreq: float,
                 tol: float) -> int:
    """One-sided support, in samples, of the Morse wavelet at ``min_freq``:
    one more than the farthest circular distance from sample 0 at which its
    envelope exceeds ``tol`` of the peak, probed over at least 16 periods
    and 2 s, in float64."""
    n = 2 ** math.ceil(math.log2(sfreq * max(16.0 / min_freq, 2.0)))
    w = torch.arange(n, dtype=torch.float64) * (sfreq / n) / min_freq
    env = np.abs(np.fft.ifft(_morse(w, b, r).numpy()))
    above = np.nonzero(env > tol * env.max())[0]
    return int(np.minimum(above, n - above).max()) + 1


def window_geometry(n_samples: int, window: int, min_halo: int):
    """``(halo, extended length, window starts)``: the halo rounded up so
    that the extended window is a power of two."""
    ext = 1 << math.ceil(math.log2(window + 2 * min_halo))
    return (ext - window) // 2, ext, list(range(0, n_samples, window))


def recording_power_blocks(data: np.ndarray, freqs, sfreq: float, b: float,
                           r: float, analytic: bool, window: int, tol: float,
                           prec: Precision, device,
                           channels_per_block: int = 16):
    """Yield ``(channels, t0, t1, power)`` blocks of the (C, F, N) power of
    the (C, N) recording ``data``, window by window: ``power`` is the
    (c, F, t1 - t0) interior of one window, in ``prec.real``."""
    n_channels, n = data.shape
    halo, ext, starts = window_geometry(
        n, window, halo_samples(b, r, float(np.min(freqs)), sfreq, tol))
    bank = morse_bank(freqs, ext, sfreq, b, r, analytic, prec, device)
    signal = torch.from_numpy(np.ascontiguousarray(data)).to(device)
    for t0 in starts:
        t1 = min(t0 + window, n)
        lo, hi = max(t0 - halo, 0), min(t0 + window + halo, n)
        seg = torch.zeros(n_channels, ext, dtype=signal.dtype,
                          device=device)
        seg[:, lo - (t0 - halo):hi - (t0 - halo)] = signal[:, lo:hi]
        for c0 in range(0, n_channels, channels_per_block):
            sel = slice(c0, min(c0 + channels_per_block, n_channels))
            coef = _coefficients(seg[sel], bank, analytic, prec)
            power = prec.round(coef.real ** 2 + coef.imag ** 2)
            del coef
            yield sel, t0, t1, power[..., halo:halo + t1 - t0]
