"""The reference wavelet families: Morse, Morlet/Gabor, MexicanHat, Shannon,
Haar (port of ``ninwavelets_tpu.models.zoo``), with the same constructors and
defaults plus ``device``.  Every formula delegates to ``ops.spectra``.
"""
from __future__ import annotations

import torch

from ..ops import spectra
from ..ops.bank import WaveletMode
from .base import WaveletBase


class Morse(WaveletBase):
    """Generalized Morse wavelets, peak-normalized and defined in the
    frequency domain (mode=Reverse): ``2 * H(w) * w**b * exp((b/r) *
    (1 - w**r))``.

    sfreq: sampling frequency (Hz).  b: beta (default 17.5).  r: gamma
    (default 3, the Airy family).
    """

    def __init__(self, sfreq: float = 1000, b: float = 17.5, r: float = 3,
                 real_wave_length: float = 1.,
                 interpolate: bool = False, cuda: bool = False,
                 device=None) -> None:
        super().__init__(sfreq, real_wave_length, interpolate, cuda, device)
        self.r = float(r)
        self.b = float(b)
        self.mode = WaveletMode.Reverse
        self.help = ('Generalized Morse wavelets are defined in the '
                     'frequency domain; the time-domain form shown here is '
                     'their inverse FFT.')

    def trans_formula(self, freqs: torch.Tensor, freq=1.0) -> torch.Tensor:
        return spectra.morse_spectrum(freqs, freq, self.b, self.r)


class Morlet(WaveletBase):
    """Morlet (or Gabor, with ``gabor=True``) wavelets, mode=Both: the
    frequency-domain formula drives the bank; the time-domain formula is for
    plotting and MNE interop."""

    def __init__(self, sfreq: float = 1000, sigma: float = 7.,
                 real_wave_length: float = 1.,
                 gabor: bool = False, interpolate: bool = False,
                 cuda: bool = False, device=None) -> None:
        super().__init__(sfreq, real_wave_length, interpolate, cuda, device)
        self.mode = WaveletMode.Both
        self.sigma = float(sigma)
        self.gabor = bool(gabor)
        self.c, self.k = spectra.morlet_norm_constants(self.sigma, self.gabor)

    def trans_formula(self, freqs: torch.Tensor, freq=1.0) -> torch.Tensor:
        return spectra.morlet_spectrum(freqs, freq, self.sigma, self.gabor)

    def formula(self, timeline: torch.Tensor, freq=1.0) -> torch.Tensor:
        return spectra.morlet_time(timeline, self.sigma, self.gabor)

    def peak_freq(self, freq):
        return spectra.morlet_peak_freq(freq, self.sigma)


class MexicanHat(WaveletBase):
    """Mexican-hat (Ricker) wavelets, mode=Normal: time domain only; the bank
    is its FFT with the reference's abs-of-parts quirk."""

    def __init__(self, sfreq: float = 1000, sigma: float = 7,
                 real_wave_length: float = 1.,
                 interpolate: bool = False, cuda: bool = False,
                 device=None) -> None:
        super().__init__(sfreq, real_wave_length, interpolate, cuda, device)
        self.sigma = float(sigma)
        self.mode = WaveletMode.Normal
        self.help = ''

    def formula(self, tc: torch.Tensor, freq=1.0) -> torch.Tensor:
        return spectra.mexican_hat_time(tc, self.sigma)

    def peak_freq(self, freq):
        return spectra.MEXICAN_HAT_PEAK_FREQ


class Shannon(WaveletBase):
    """Shannon wavelets, mode=Reverse.  The brick wall passes grid VALUES
    <= 1 and ignores the analysis frequency, as the reference does."""

    def __init__(self, sfreq: float = 1000, sigma: float = 7,
                 real_wave_length: float = 1.,
                 interpolate: bool = False, cuda: bool = False,
                 device=None) -> None:
        super().__init__(sfreq, real_wave_length, interpolate, cuda, device)
        self.sigma = float(sigma)
        self.mode = WaveletMode.Reverse
        self.help = ''

    def trans_formula(self, tc: torch.Tensor, freq=1.0) -> torch.Tensor:
        return spectra.shannon_spectrum(tc, freq)


class Haar(WaveletBase):
    """Haar wavelets, mode=Normal.  Like the reference class it takes no
    ``cuda`` flag; ``device`` places it."""

    def __init__(self, sfreq: float = 1000, real_wave_length: float = 1.,
                 interpolate: bool = False, device=None) -> None:
        super().__init__(sfreq, real_wave_length, interpolate, device=device)
        self.mode = WaveletMode.Normal

    def formula(self, timeline: torch.Tensor, freq=1.0) -> torch.Tensor:
        return spectra.haar_time(timeline)
