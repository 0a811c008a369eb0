"""The wavelet zoo: the reference families Morse, MorseMNE, Morlet/Gabor,
MexicanHat, Shannon, Haar, the extension families Paul, DOG, Bump, and the
composite estimators Superlet and MorseMultitaper (port of
``ninwavelets_tpu.models.zoo``), with the same constructors and defaults plus
``device``.  Every formula delegates to ``ops.spectra`` or
``ops.extensions``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import as_float32, resolve_device
from ..ops import extensions, spectra
from ..ops.bank import WaveletMode
from .base import Numbers, WaveletBase


class Morse(WaveletBase):
    """Generalized Morse wavelets, peak-normalized and defined in the
    frequency domain (mode=Reverse): ``2 * H(w) * w**b * exp((b/r) *
    (1 - w**r))``.

    sfreq: sampling frequency (Hz).  b: beta (default 17.5).  r: gamma
    (default 3, the Airy family).
    """

    def __init__(self, sfreq: float = 1000, b: float = 17.5, r: float = 3,
                 real_wave_length: float = 1.,
                 interpolate: bool = False, cuda: Optional[bool] = None,
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
                 cuda: Optional[bool] = None, device=None) -> None:
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


class MorseMNE(Morse):
    """Morse CWT delegated to mne-python's ``tfr.cwt`` with time-domain
    wavelets, kept for API parity with the reference; needs ``mne``.  Like
    the JAX package it honours ``freqs`` (the reference hardcodes
    ``range(1, 100)``).  A tensor input, on the card or not, goes to the host
    for mne; the epoch-mean coefficients come back as a tensor on the
    wavelet's device."""

    def cwt(self, wave, freqs: Numbers, use_fft: bool = True,
            mode: str = 'same', decim: float = 1):  # type: ignore[override]
        try:
            from mne.time_frequency import tfr
        except ImportError as e:
            raise ImportError(
                "MorseMNE.cwt requires mne-python; install mne or use "
                "Morse.cwt for the port's own path") from e
        wavelets = [w.cpu().numpy() for w in self.make_wavelets(freqs)]
        if isinstance(wave, torch.Tensor):
            wave = wave.detach().cpu().numpy()
        wave = np.atleast_2d(np.asarray(wave))
        out = tfr.cwt(wave, wavelets, use_fft=use_fft, mode=mode,
                      decim=decim).mean(axis=0)
        return torch.as_tensor(out, device=self.device)


class MexicanHat(WaveletBase):
    """Mexican-hat (Ricker) wavelets, mode=Normal: time domain only; the bank
    is its FFT with the reference's abs-of-parts quirk."""

    def __init__(self, sfreq: float = 1000, sigma: float = 7,
                 real_wave_length: float = 1.,
                 interpolate: bool = False, cuda: Optional[bool] = None,
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
                 interpolate: bool = False, cuda: Optional[bool] = None,
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


class Paul(WaveletBase):
    """Paul wavelet of order m (extension), mode=Reverse: strong time
    resolution, broad in frequency (``ops.extensions.paul_spectrum``)."""

    def __init__(self, sfreq: float = 1000, m: float = 4.0,
                 real_wave_length: float = 1.,
                 interpolate: bool = False, cuda: Optional[bool] = None,
                 device=None) -> None:
        super().__init__(sfreq, real_wave_length, interpolate, cuda, device)
        self.m = float(m)
        self.mode = WaveletMode.Reverse

    def trans_formula(self, freqs: torch.Tensor, freq=1.0) -> torch.Tensor:
        return extensions.paul_spectrum(freqs, freq, self.m)


class DOG(WaveletBase):
    """Analytic derivative-of-Gaussian wavelet of order m (extension),
    mode=Reverse; ``m = 2`` is the analytic counterpart of MexicanHat."""

    def __init__(self, sfreq: float = 1000, m: float = 2.0,
                 real_wave_length: float = 1.,
                 interpolate: bool = False, cuda: Optional[bool] = None,
                 device=None) -> None:
        super().__init__(sfreq, real_wave_length, interpolate, cuda, device)
        self.m = float(m)
        self.mode = WaveletMode.Reverse

    def trans_formula(self, freqs: torch.Tensor, freq=1.0) -> torch.Tensor:
        return extensions.dog_spectrum(freqs, freq, self.m)


class Bump(WaveletBase):
    """Bump wavelet (extension), mode=Reverse: compact frequency support, the
    sharpest frequency resolution of the zoo."""

    def __init__(self, sfreq: float = 1000, sigma: float = 0.6,
                 real_wave_length: float = 1.,
                 interpolate: bool = False, cuda: Optional[bool] = None,
                 device=None) -> None:
        super().__init__(sfreq, real_wave_length, interpolate, cuda, device)
        self.sigma = float(sigma)
        self.mode = WaveletMode.Reverse

    def trans_formula(self, freqs: torch.Tensor, freq=1.0) -> torch.Tensor:
        return extensions.bump_spectrum(freqs, freq, self.sigma)


class Superlet:
    """Fractional adaptive superlet transform (extension, ``ops.superlets``):
    the weighted geometric mean of Morlets with growing cycle counts.  Not a
    ``WaveletBase``: a superlet is a family of banks fused multiplicatively.

    sfreq: sampling frequency (Hz).  sigma: base Morlet sigma; order k uses
    ``k * sigma``.  order_min / order_max: the adaptive order range (the
    lowest frequency uses ``order_min`` members, the highest ``order_max``);
    ``adaptive=False`` uses ``order_max`` everywhere.  device: where the
    data go (the card when None).
    """

    def __init__(self, sfreq: float = 1000, sigma: float = 3.0,
                 order_min: int = 1, order_max: int = 8,
                 adaptive: bool = True, interpolate: bool = False,
                 device=None) -> None:
        self.sfreq = float(sfreq)
        self.sigma = float(sigma)
        self.order_min = int(order_min)
        self.order_max = int(order_max)
        self.adaptive = bool(adaptive)
        self.interpolate = bool(interpolate)
        self.device = resolve_device(device)

    def _kw(self):
        return dict(base_sigma=self.sigma, order_min=self.order_min,
                    order_max=self.order_max, adaptive=self.adaptive,
                    interpolate=self.interpolate)

    def power(self, wave, freqs: Numbers) -> torch.Tensor:
        """(..., F, N) superlet power of ``wave`` at ``freqs``."""
        from ..ops.superlets import superlet_power
        freqs = WaveletBase._check_freqs(freqs).numpy()
        return superlet_power(as_float32(wave, self.device), freqs,
                              self.sfreq, **self._kw())

    def mean_power(self, waves, freqs: Numbers) -> torch.Tensor:
        """(..., F, N) epoch-mean superlet power of (E, ..., N) epochs."""
        from ..ops.superlets import superlet_mean_power
        freqs = WaveletBase._check_freqs(freqs).numpy()
        return superlet_mean_power(as_float32(waves, self.device), freqs,
                                   self.sfreq, **self._kw())


class MorseMultitaper:
    """Multitaper Morse spectrogram (extension, ``ops.multitaper``): the
    mean of the scalograms of the first ``n_tapers`` orthogonal generalized
    Morse wavelets, one (K*F, N) bank through the same paths as any bank.
    ``n_tapers=1`` is ``Morse(...).power``.  device: where the data go (the
    card when None)."""

    def __init__(self, sfreq: float = 1000, b: float = 17.5, r: float = 3,
                 n_tapers: int = 3, interpolate: bool = False,
                 device=None) -> None:
        self.sfreq = float(sfreq)
        self.b = float(b)
        self.r = float(r)
        self.n_tapers = int(n_tapers)
        self.interpolate = bool(interpolate)
        self.device = resolve_device(device)

    def _kw(self):
        return dict(b=self.b, r=self.r, n_tapers=self.n_tapers,
                    interpolate=self.interpolate)

    def power(self, wave, freqs: Numbers) -> torch.Tensor:
        """(..., F, N) multitaper power of ``wave`` at ``freqs``."""
        from ..ops.multitaper import multitaper_power
        freqs = WaveletBase._check_freqs(freqs).numpy()
        return multitaper_power(as_float32(wave, self.device), freqs,
                                self.sfreq, **self._kw())

    def mean_power(self, waves, freqs: Numbers) -> torch.Tensor:
        """(..., F, N) epoch-mean multitaper power of (E, ..., N) epochs (one
        (K*F, N)-bank epoch-mean pass)."""
        from ..ops.multitaper import multitaper_mean_power
        freqs = WaveletBase._check_freqs(freqs).numpy()
        return multitaper_mean_power(as_float32(waves, self.device), freqs,
                                     self.sfreq, **self._kw())
