"""Superlets: superresolution power by geometric bank fusion (port of
``ninwavelets_tpu.ops.superlets``; Moca, Barzan, Nagy & Muresan, Nat.
Commun. 2021).

A superlet of order ``o`` at frequency ``f`` is the geometric mean of the
powers of ``o`` Morlets whose cycle counts grow ``k = 1..o``; in this
engine's Morlet convention ``sigma`` plays the cycle-count role, so order
``k`` uses ``sigma = k * base_sigma``.  The fractional adaptive order
schedule is an (O, F) weight matrix computed on the host.

Each order's power goes through ``ops.fused.power_auto``, so on the card
every order is one "power_each" launch over all the signals.  The epoch mean
batches the epochs in chunks whose (chunk, ..., F, N) planes stay within
about 2 GB, instead of the JAX package's one-epoch scan; the result is the
same per-epoch weighted geometric mean, then the epoch mean.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..device import as_float32, resolve_device
from .bank import WaveletDef, WaveletMode, make_fft_bank
from .fused import power_auto
from .spectra import morlet_peak_freq, morlet_spectrum, morlet_time

__all__ = ["superlet_banks", "superlet_weights",
           "superlet_power_from_banks", "superlet_power",
           "superlet_mean_power"]

#: Bytes of one epoch chunk's float32 power plane in ``superlet_mean_power``.
CHUNK_BYTES = 2 * 1024 ** 3


@lru_cache(maxsize=None)
def _morlet_def(sigma: float) -> WaveletDef:
    """Morlet WaveletDef with ``sigma`` baked in (one object per sigma)."""
    def tf(grid, freq=1.0):
        return morlet_spectrum(grid, freq, sigma)

    def tmf(timeline, freq=1.0):
        return morlet_time(timeline, sigma)

    def pf(freq):
        return morlet_peak_freq(freq, sigma)

    return WaveletDef(mode=WaveletMode.Both, trans_formula=tf,
                      time_formula=tmf, peak_freq=pf)


def superlet_banks(freqs, n: int, sfreq: float, base_sigma: float = 3.0,
                   order_max: int = 8, interpolate: bool = False,
                   device=None) -> torch.Tensor:
    """(O, F, n) stacked real Morlet banks, order k -> sigma = k*base_sigma,
    on ``device`` (the card when None)."""
    freqs = torch.as_tensor(np.asarray(freqs, np.float32))
    device = resolve_device(device)
    return torch.stack([
        make_fft_bank(_morlet_def(k * float(base_sigma)), freqs, int(n),
                      float(sfreq), bool(interpolate), device=device)
        for k in range(1, int(order_max) + 1)])


def superlet_weights(freqs, order_min: int = 1, order_max: int = 8,
                     adaptive: bool = True) -> np.ndarray:
    """(O, F) float32 weight matrix of the fractional adaptive schedule (host
    numpy).  The fractional order ``a(f)`` runs linearly from ``order_min``
    at the lowest frequency to ``order_max`` at the highest; member k gets
    ``clip(a - (k - 1), 0, 1)``.  ``adaptive=False`` uses ``order_max``
    everywhere."""
    f = np.asarray(freqs, np.float64)
    order_min, order_max = int(order_min), int(order_max)
    if not 1 <= order_min <= order_max:
        raise ValueError("need 1 <= order_min <= order_max")
    if adaptive and f.size > 1 and f.max() > f.min():
        a = order_min + (order_max - order_min) * (f - f.min()) \
            / (f.max() - f.min())
    else:
        a = np.full(f.shape, float(order_max))
    ks = np.arange(1, order_max + 1, dtype=np.float64)[:, None]
    return np.clip(a[None, :] - (ks - 1.0), 0.0, 1.0).astype(np.float32)


def superlet_power_from_banks(signal: torch.Tensor, banks: torch.Tensor,
                              weights, interpolate: bool = False,
                              eps: float = 1e-30) -> torch.Tensor:
    """Weighted geometric mean of the member powers,
    ``exp(sum_k w_k log max(P_k, eps) / sum_k w_k)``: (..., N) real signals,
    (O, F, N) banks, (O, F) weights -> (..., F, N) float32."""
    weights = torch.as_tensor(weights, dtype=torch.float32,
                              device=signal.device)
    total = None
    for bank_k, w_k in zip(banks, weights):
        p = power_auto(signal, bank_k, interpolate=interpolate)
        term = w_k[:, None] * torch.log(torch.clamp(p, min=eps))
        total = term if total is None else total.add_(term)
    return torch.exp(total / weights.sum(0)[:, None])


def _setup(signals, freqs, sfreq, base_sigma, order_min, order_max,
           adaptive, interpolate, device):
    signals = as_float32(signals, device)
    banks = superlet_banks(freqs, signals.shape[-1], sfreq, base_sigma,
                           order_max, interpolate, device=signals.device)
    return signals, banks, superlet_weights(freqs, order_min, order_max,
                                            adaptive)


def superlet_power(signal_r, freqs, sfreq: float, base_sigma: float = 3.0,
                   order_min: int = 1, order_max: int = 8,
                   adaptive: bool = True, interpolate: bool = False,
                   eps: float = 1e-30, device=None) -> torch.Tensor:
    """(..., F, N) fractional adaptive superlet power of real ``signal_r``
    (a tensor stays on its device; other input goes to ``device``, the card
    when None)."""
    signal, banks, w = _setup(signal_r, freqs, sfreq, base_sigma, order_min,
                              order_max, adaptive, interpolate, device)
    return superlet_power_from_banks(signal, banks, w, interpolate, eps)


def superlet_mean_power(signals_r, freqs, sfreq: float,
                        base_sigma: float = 3.0, order_min: int = 1,
                        order_max: int = 8, adaptive: bool = True,
                        interpolate: bool = False, eps: float = 1e-30,
                        device=None) -> torch.Tensor:
    """(..., F, N) epoch-mean superlet power of (E, ..., N) epochs: each
    epoch's superlet plane, then the mean over epochs, taken in chunks of
    epochs whose power planes stay within ``CHUNK_BYTES``."""
    signals, banks, w = _setup(signals_r, freqs, sfreq, base_sigma,
                               order_min, order_max, adaptive, interpolate,
                               device)
    e = signals.shape[0]
    per_epoch = 4 * signals[0].numel() * banks.shape[1]
    chunk = max(1, CHUNK_BYTES // per_epoch)
    total = None
    for lo in range(0, e, chunk):
        part = superlet_power_from_banks(signals[lo:lo + chunk], banks, w,
                                         interpolate, eps).sum(0)
        total = part if total is None else total.add_(part)
    return total / e
