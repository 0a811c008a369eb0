"""Synthesis of the (F, N) frequency-domain wavelet bank (port of
``ninwavelets_tpu.ops.bank``).

The whole bank is one broadcast evaluation: the formulas see a (1, N) grid and
an (F, 1) column of analysis frequencies.

Mode semantics, as in the reference:

* ``Reverse`` / ``Both``: evaluate the frequency-domain formula on the FFT bin
  grid.  With ``interpolate=True`` the upper half is zeroed.
* ``Normal`` / ``Twice``: build the time-domain wavelet, center-pad it to
  ``sfreq * real_wave_length`` samples, FFT, then take ``abs`` of the real and
  imaginary parts separately (a reference quirk that defines coefficient
  parity for MexicanHat and Haar), then length-match every row to the signal
  (center-pad / head-truncate).

Real formulas give a float32 bank; Normal/Twice families give complex64.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from .grids import (analytic_mask, fft_bin_freqs, reverse_timeline,
                    wavelet_timeline)
from .signal_utils import pad_last_axis_to


class WaveletMode(enum.Enum):
    """Synthesis-path selector, mirroring the reference enum."""
    Normal = 0            # time-domain formula only
    Both = 1              # both formulas (freq-domain used for the bank)
    Reverse = 2           # frequency-domain formula only
    Indifferentiable = 3  # declared by the reference, never used by any class
    Twice = 4             # iFFT'd wavelet re-FFT'd


@dataclass(frozen=True)
class WaveletDef:
    """A wavelet family: a mode plus up to two formulas.

    trans_formula(freq_grid, freq) -> spectrum values on the grid
    time_formula(timeline, freq)   -> wavelet samples on the phase timeline
    peak_freq(freq)                -> peak frequency scaling the time grid
    """
    mode: WaveletMode
    trans_formula: Optional[Callable] = None
    time_formula: Optional[Callable] = None
    peak_freq: Callable = field(default=lambda freq: 1.0)


def _as_freq(freq, device) -> torch.Tensor:
    return torch.as_tensor(freq, dtype=torch.float32, device=device)


def _time_domain_wavelet(wdef: WaveletDef, freq: torch.Tensor, sfreq: float,
                         real_wave_length: float) -> torch.Tensor:
    """The reference ``make_wavelet``; ``freq`` is a scalar or an (F, 1)
    column, giving one wavelet per row."""
    if wdef.mode in (WaveletMode.Reverse, WaveletMode.Twice):
        # iFFT the frequency formula on the i/freq grid (called with its
        # default freq=1: the grid values already carry freq), then build
        # the two-sided analytic wavelet and slice the central half.
        t = reverse_timeline(sfreq, freq, real_wave_length,
                             device=freq.device)
        w = torch.fft.ifft(wdef.trans_formula(t, 1.0).to(torch.complex64))
        length = w.shape[-1]
        total = torch.cat([torch.conj(torch.flip(w, (-1,))), w], -1)
        return total[..., length // 2:(length // 2) * 3]
    timeline = wavelet_timeline(sfreq, freq, wdef.peak_freq(freq),
                                real_length=1.0, zero_mean=True,
                                device=freq.device)
    return wdef.time_formula(timeline, freq)


def _twice_spectrum(wdef: WaveletDef, freq: torch.Tensor, sfreq: float,
                    real_wave_length_cfg: float) -> torch.Tensor:
    """Normal/Twice spectrum: time wavelet -> center pad to ``sfreq *
    real_wave_length_cfg`` -> FFT -> abs of real and imag parts."""
    w = _time_domain_wavelet(wdef, freq, sfreq, real_wave_length_cfg)
    n0 = int(round(sfreq * real_wave_length_cfg))
    half = int((n0 - w.shape[-1]) / 2)
    if half > 0:
        w = torch.nn.functional.pad(w, (half, half))
    elif half < 0:
        w = w[..., -half:w.shape[-1] + half]
    spec = torch.fft.fft(w.to(torch.complex64))
    return torch.complex(torch.abs(spec.real), torch.abs(spec.imag))


def _freq_domain_rows(wdef: WaveletDef, freq: torch.Tensor, sfreq: float,
                      n: int, interpolate: bool) -> torch.Tensor:
    grid = fft_bin_freqs(n, sfreq, device=freq.device)
    rows = wdef.trans_formula(grid, freq)
    if interpolate:
        rows = rows * analytic_mask(n, rows.real.dtype, rows.device)
    return rows


def make_fft_wavelet(wdef: WaveletDef, freq, sfreq: float,
                     real_length: float = 1.0, interpolate: bool = False,
                     real_wave_length_cfg: float = 1.0,
                     device=None) -> torch.Tensor:
    """One FFT-domain wavelet as the reference's singular
    ``make_fft_wavelet`` returns it, WITHOUT the alias mask and signal-length
    pad that ``make_fft_wavelets`` / ``cwt`` add later.  Reverse/Both: length
    ``sfreq * real_length``; Normal/Twice: ``sfreq * real_wave_length_cfg``.
    """
    freq = _as_freq(freq, device)
    if wdef.mode in (WaveletMode.Reverse, WaveletMode.Both):
        n = int(round(sfreq * real_length))
        return _freq_domain_rows(wdef, freq, sfreq, n, interpolate)
    return _twice_spectrum(wdef, freq, sfreq, real_wave_length_cfg)


def make_time_wavelet(wdef: WaveletDef, freq, sfreq: float,
                      real_wave_length: float = 1.0,
                      device=None) -> torch.Tensor:
    """Time-domain wavelet (the reference ``make_wavelet``)."""
    return _time_domain_wavelet(wdef, _as_freq(freq, device), sfreq,
                                real_wave_length)


def make_fft_bank(wdef: WaveletDef, freqs, n: int, sfreq: float,
                  interpolate: bool = False, real_wave_length_cfg: float = 1.0,
                  device=None) -> torch.Tensor:
    """The full (F, n) FFT-domain bank for a signal of ``n`` samples.

    ``real_wave_length_cfg`` is the CONSTRUCTOR ``real_wave_length``: the
    Normal/Twice path sizes its FFT by it, not by the signal length (a
    reference quirk), then center-pads or truncates each row to ``n``.

    Returns float32 for Reverse/Both families with real formulas
    (Morse/Morlet/Shannon) and complex64 for Normal/Twice families.
    """
    freqs = _as_freq(freqs, device).reshape(-1, 1)
    if wdef.mode in (WaveletMode.Reverse, WaveletMode.Both):
        bank = _freq_domain_rows(wdef, freqs, sfreq, n, interpolate)
    else:
        bank = _twice_spectrum(wdef, freqs, sfreq, real_wave_length_cfg)
        if interpolate:
            bank = bank * analytic_mask(bank.shape[-1], torch.float32,
                                        bank.device)
        bank = pad_last_axis_to(bank, n)
    return bank.expand(freqs.shape[0], n).contiguous()
