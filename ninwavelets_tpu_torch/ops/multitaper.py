"""Multitaper Morse spectrograms: the mean of the scalograms of the first K
orthogonal generalized Morse wavelets (Olhede & Walden 2002), and the
multitaper all-pairs coherence and partial coherence (port of
``ninwavelets_tpu.ops.multitaper``).

Taper k is F more rows of the ordinary frequency-domain bank, so the K-taper
transform is one (F*K, N) bank, stacked F-major, through the same paths as
every other family: ``multitaper_mean_power`` is one ``mean_power_auto``
call (the fused "power" epilogue on the card), ``multitaper_power`` one
``power_auto`` call (the per-signal "power_each" epilogue).

The banks are synthesised on the CPU and cached as numpy arrays per
geometry (the Laguerre recurrences are many small ops), then moved to the
signals' device at each call.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..device import as_float32
from .bank import WaveletDef, WaveletMode, make_fft_bank
from .connectivity import _pair_sums, partial_coherence_per_row
from .cwt import analytic_spectrum
from .fused import mean_power_auto, power_auto
from .spectra import morse_taper_spectrum

__all__ = ["morse_taper_def", "multitaper_banks",
           "multitaper_power_from_banks", "multitaper_power",
           "multitaper_mean_power", "multitaper_coherence_matrix",
           "multitaper_partial_coherence"]


@lru_cache(maxsize=None)
def morse_taper_def(b: float, r: float, order: int) -> WaveletDef:
    """WaveletDef of the order-``order`` Morse taper (cached: one object per
    parameter set)."""
    def tf(grid, freq=1.0):
        return morse_taper_spectrum(grid, freq, b, r, order)

    return WaveletDef(mode=WaveletMode.Reverse, trans_formula=tf)


@lru_cache(maxsize=64)
def _banks_np(freqs_key: tuple, n: int, sfreq: float, b: float, r: float,
              n_tapers: int, interpolate: bool,
              real_wave_length: float) -> np.ndarray:
    """The (F, K, n) float32 taper banks, synthesised on the CPU."""
    freqs = torch.tensor(freqs_key, dtype=torch.float32)
    rows = [make_fft_bank(morse_taper_def(b, r, k), freqs, n, sfreq,
                          interpolate, real_wave_length, device="cpu").numpy()
            for k in range(n_tapers)]
    return np.stack(rows, axis=1)


def multitaper_banks(freqs, n: int, sfreq: float, b: float = 17.5,
                     r: float = 3.0, n_tapers: int = 3,
                     interpolate: bool = False,
                     real_wave_length: float = 1.0,
                     device=None) -> torch.Tensor:
    """(F, K, n) stacked real Morse-taper banks (taper k = order k), F-major
    so a flatten to (F*K, n) keeps each frequency's tapers together; on
    ``device`` (the card when None)."""
    key = tuple(np.asarray(freqs, np.float32).tolist())
    arr = _banks_np(key, int(n), float(sfreq), float(b), float(r),
                    int(n_tapers), bool(interpolate), float(real_wave_length))
    return as_float32(arr, device)


def multitaper_power_from_banks(signal: torch.Tensor, banks: torch.Tensor,
                                interpolate: bool = False,
                                weights=None) -> torch.Tensor:
    """(..., F, N) multitaper power: the (weighted) mean over the taper
    scalograms of the (F, K, n) ``banks``; uniform 1/K weights by default.
    The K*F rows go through ``power_auto`` in one call."""
    f, k, n = banks.shape
    flat = banks.reshape(f * k, n)
    p = power_auto(signal, flat, interpolate=interpolate)
    p = p.reshape(*p.shape[:-2], f, k, p.shape[-1])
    if weights is None:
        return p.mean(-2)
    w = torch.as_tensor(weights, dtype=p.dtype, device=p.device)
    return torch.tensordot(p, w / w.sum(), dims=([p.ndim - 2], [0]))


def _flat_banks(freqs, n, sfreq, b, r, n_tapers, interpolate, device):
    return multitaper_banks(freqs, n, sfreq, b, r, n_tapers, interpolate,
                            device=device).reshape(-1, n)


def multitaper_power(signal_r, freqs, sfreq: float, b: float = 17.5,
                     r: float = 3.0, n_tapers: int = 3,
                     interpolate: bool = False,
                     device=None) -> torch.Tensor:
    """(..., F, N) multitaper Morse power of real ``signal_r`` (a tensor
    stays on its device; other input goes to ``device``, the card when
    None)."""
    signal = as_float32(signal_r, device)
    n = int(signal.shape[-1])
    flat = _flat_banks(freqs, n, sfreq, b, r, n_tapers, interpolate,
                       signal.device)
    return multitaper_power_from_banks(
        signal, flat.reshape(-1, int(n_tapers), n), interpolate)


def multitaper_mean_power(signals_r, freqs, sfreq: float, b: float = 17.5,
                          r: float = 3.0, n_tapers: int = 3,
                          interpolate: bool = False,
                          device=None) -> torch.Tensor:
    """(..., F, N) epoch-mean multitaper power of (E, ..., N) signals.  The
    epoch mean and the taper mean commute, so this is ONE (F*K, N)-bank
    epoch-mean power (``mean_power_auto``: one "power" launch on the card)
    followed by the K-group mean."""
    signals = as_float32(signals_r, device)
    n = int(signals.shape[-1])
    flat = _flat_banks(freqs, n, sfreq, b, r, n_tapers, interpolate,
                       signals.device)
    p = mean_power_auto(signals, flat, interpolate=interpolate)
    p = p.reshape(*p.shape[:-2], -1, int(n_tapers), p.shape[-1])
    return p.mean(-2)


def _mt_pair_scan(sigs: torch.Tensor, banks: torch.Tensor, per_row,
                  interpolate: bool, time_range=None) -> torch.Tensor:
    """Stream an all-pairs statistic over the (F, K, n) taper banks: per
    frequency, one inverse FFT of the (K, E, C, N) slab, the K tapers
    folded into the epoch axis (K more trials of the same local spectrum),
    the full-float32 pairwise sums over the ``time_range`` window
    (``connectivity._pair_sums``) and ``per_row(sr, si) -> (C, C)``.
    Returns the (F, C, C) stack."""
    spec = analytic_spectrum(sigs, interpolate)              # (E, C, N)
    n0, n1 = time_range if time_range is not None else (0, sigs.shape[-1])
    rows = []
    for bank_f in banks:                                      # (K, N)
        w = torch.fft.ifft(spec[None] * bank_f[:, None, None, :])
        rows.append(per_row(*_pair_sums(
            w.reshape(-1, *w.shape[2:])[..., n0:n1])))
    return torch.stack(rows)


def _mt_input(sigs_r, freqs, sfreq, b, r, n_tapers, interpolate, device):
    sigs = as_float32(sigs_r, device)
    banks = multitaper_banks(freqs, int(sigs.shape[-1]), sfreq, b, r,
                             n_tapers, interpolate, device=sigs.device)
    return sigs, banks


def multitaper_coherence_matrix(sigs_r, freqs, sfreq: float,
                                b: float = 17.5, r: float = 3.0,
                                n_tapers: int = 3,
                                interpolate: bool = False,
                                eps: float = 1e-12, time_range=None,
                                device=None) -> torch.Tensor:
    """(F, C, C) all-pairs multitaper coherence of (E, C, N) epochs:
    ``|S_ab|^2 / (S_aa S_bb)`` with the cross-spectra summed over epochs,
    time (the ``time_range`` (start, stop) sample window) and the K tapers
    (``_mt_pair_scan``).  The denominator is floored at ``eps`` times its
    maximum."""
    sigs, banks = _mt_input(sigs_r, freqs, sfreq, b, r, n_tapers,
                            interpolate, device)

    def per_row(sr, si):
        s_r, s_i = sr.sum(-1), si.sum(-1)                    # (C, C)
        p = torch.diagonal(s_r)
        den = p[:, None] * p[None, :]
        den = torch.maximum(den, eps * den.max())
        return (s_r * s_r + s_i * s_i) / den

    return _mt_pair_scan(sigs, banks, per_row, interpolate, time_range)


def multitaper_partial_coherence(sigs_r, freqs, sfreq: float,
                                 b: float = 17.5, r: float = 3.0,
                                 n_tapers: int = 3,
                                 interpolate: bool = False,
                                 lam: float = 1e-5, time_range=None,
                                 device=None) -> torch.Tensor:
    """(F, C, C) multitaper partial coherence: the conditioning inverse of
    ``connectivity.partial_coherence_per_row`` on the taper-augmented
    cross-spectra, whose effective epoch count is E * K, so the (C, C)
    inverse stays well posed at trial counts where the single-taper
    estimate is rank-starved (E * K * n_time >= C)."""
    sigs, banks = _mt_input(sigs_r, freqs, sfreq, b, r, n_tapers,
                            interpolate, device)
    e_eff = sigs.shape[0] * int(n_tapers)

    def per_row(sr, si):
        return partial_coherence_per_row(sr, si, e_eff, lam)

    return _mt_pair_scan(sigs, banks, per_row, interpolate, time_range)
