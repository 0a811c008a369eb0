"""``WaveletBase``, the template-method extension contract (port of
``ninwavelets_tpu.models.base``).

A subclass supplies only formulas (``formula``, ``trans_formula``,
``peak_freq``) plus a ``WaveletMode``; the base class owns the grids, the bank
and the CWT.  The formulas take tensors and broadcast: the bank is built by
one call on a (1, N) grid against an (F, 1) column of frequencies.

The placement follows ``device.resolve_device``: ``device=`` wins; an
explicit ``cuda=False`` (the reference's flag) means the CPU; otherwise the
data go to ``"cuda"``, and the constructor raises when CUDA is absent, so
``device="cpu"`` is how a caller asks for the CPU.  Every bank is built from the current parameters, so
mutating ``morse.b`` takes effect at the next build.  With ``reuse=True``
(the default) a cached bank is NOT rebuilt, even for a new signal length or
new parameters: it is center-padded / truncated to the signal, the
reference's stale-bank contract.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ..device import resolve_device
from ..ops import bank as _bank
from ..ops.bank import WaveletDef, WaveletMode
from ..ops.cwt import abs_from_bank, cwt_from_bank, power_from_bank
from ..ops.denoise import denoise as _denoise
from ..ops.ridge import extract_modes as _extract_modes
from ..ops.scattering import scattering as _scattering
from ..ops.signal_utils import pad_to
from ..ops.sst import ssq_power as _ssq_power

Numbers = Union[Sequence[float], np.ndarray, range, torch.Tensor]


class WaveletBase:
    """Base class of wavelets.  Subclasses override ``formula`` (time
    domain), ``trans_formula`` (frequency domain) and ``peak_freq``, and set
    ``self.mode``.  The constructor matches the reference, plus ``device``.
    """

    def __init__(self, sfreq: float = 1000, real_wave_length: float = 1.,
                 interpolate: bool = True, cuda: Optional[bool] = None,
                 device=None) -> None:
        self.mode: WaveletMode = WaveletMode.Normal
        self.sfreq: float = sfreq
        self.help: str = ''
        self.real_wave_length: float = real_wave_length
        self.freq_dist: float = 0.0  # distance between analysis freqs (cwt)
        self.interpolate = interpolate
        self.cuda = cuda
        self.device = resolve_device(device, cuda)

    # -- subclass hooks ------------------------------------------------------

    def peak_freq(self, freq):
        """Peak frequency used to scale the time-domain grid."""
        return 1.0

    def formula(self, timeline: torch.Tensor, freq) -> torch.Tensor:
        """Time-domain wavelet formula."""
        return timeline

    def trans_formula(self, freqs: torch.Tensor, freq=1.0) -> torch.Tensor:
        """Frequency-domain wavelet formula."""
        return freqs

    # -- engine --------------------------------------------------------------

    def _wdef(self) -> WaveletDef:
        """The functional wavelet definition, read at each call so runtime
        mode and parameter switches take effect."""
        return WaveletDef(mode=self.mode, trans_formula=self.trans_formula,
                          time_formula=self.formula,
                          peak_freq=self.peak_freq)

    @staticmethod
    def _check_freqs(freqs: Numbers) -> torch.Tensor:
        if isinstance(freqs, torch.Tensor):
            arr = freqs.detach().to("cpu", torch.float32)
        else:
            arr = torch.from_numpy(np.array(freqs, dtype=np.float32))
        if arr.ndim != 1 or arr.shape[0] == 0:
            raise ValueError("freqs must be a non-empty 1-D sequence")
        if bool((arr == 0.0).any()):
            raise ZeroDivisionError("analysis frequency 0 is not allowed")
        return arr

    def make_fft_wavelet(self, freq: float,
                         real_length: float = 1.) -> torch.Tensor:
        """Single FFT-domain wavelet (real for Reverse/Both families with
        real formulas, complex for the Normal/Twice path)."""
        if freq == 0:
            raise ZeroDivisionError
        return _bank.make_fft_wavelet(
            self._wdef(), float(freq), self.sfreq, real_length,
            self.interpolate, self.real_wave_length, device=self.device)

    def _build_bank(self, freqs: Numbers, real_wave_length: float) -> None:
        """Build and cache the (F, N) bank on ``self.device``."""
        freqs = self._check_freqs(freqs)
        if freqs.shape[0] > 1:
            # The reference indexes freqs[1] unconditionally; a one-element
            # grid keeps the previous freq_dist instead of raising.
            self.freq_dist = float(freqs[1] - freqs[0])
        n = int(round(self.sfreq * real_wave_length))
        self._bank_freqs = freqs.numpy()
        self._bank = _bank.make_fft_bank(
            self._wdef(), freqs, n, self.sfreq, self.interpolate,
            self.real_wave_length, device=self.device)

    @property
    def fft_wavelets(self) -> torch.Tensor:
        """The cached (F, N) bank."""
        if not hasattr(self, '_bank'):
            raise AttributeError("no bank cached yet — call "
                                 "make_fft_wavelets or cwt first")
        return self._bank

    def make_fft_wavelets(self, freqs: Numbers,
                          real_wave_length: float = 1.) -> torch.Tensor:
        """Build, cache and return the bank."""
        self._build_bank(freqs, real_wave_length)
        return self._bank

    def make_wavelet(self, freq: float) -> torch.Tensor:
        """Single time-domain wavelet."""
        if freq == 0:
            raise ZeroDivisionError
        return _bank.make_time_wavelet(self._wdef(), float(freq), self.sfreq,
                                       self.real_wave_length,
                                       device=self.device)

    def make_wavelets(self, freqs: Numbers) -> List[torch.Tensor]:
        """Time-domain wavelets, one per frequency (list form for mne-python
        interop)."""
        self.wavelets = [self.make_wavelet(float(f))
                         for f in np.asarray(freqs)]
        return self.wavelets

    def _as_wave(self, wave) -> torch.Tensor:
        wave = torch.as_tensor(wave, device=self.device)
        return wave.to(torch.complex64 if wave.is_complex()
                       else torch.float32)

    def _prepare(self, wave, freqs, reuse):
        wave = self._as_wave(wave)
        if (not reuse) or (not hasattr(self, '_bank')):
            if freqs is None:
                raise ValueError("freqs is required when no bank is cached")
            self._build_bank(freqs, wave.shape[-1] / self.sfreq)
        return wave, pad_to(self._bank, wave)

    def cwt(self, wave, freqs: Optional[Numbers] = None,
            reuse: bool = True) -> torch.Tensor:
        """Continuous wavelet transform of an (N,) or (..., N) signal:
        (..., F, N) complex64 on ``self.device``.  ``reuse=True`` keeps the
        cached bank even if freqs or the signal length changed (see the
        module docstring)."""
        wave, bank = self._prepare(wave, freqs, reuse)
        return cwt_from_bank(wave, bank, self.interpolate)

    def power(self, wave, freqs: Optional[Numbers] = None,
              reuse: bool = True) -> torch.Tensor:
        """``|cwt|**2``, float32."""
        wave, bank = self._prepare(wave, freqs, reuse)
        return power_from_bank(wave, bank, self.interpolate)

    def abs(self, wave, freqs: Optional[Numbers] = None,
            reuse: bool = True) -> torch.Tensor:
        """``|cwt|``, float32."""
        wave, bank = self._prepare(wave, freqs, reuse)
        return abs_from_bank(wave, bank, self.interpolate)

    def phase(self, wave, freqs: Optional[Numbers] = None,
              reuse: bool = True) -> torch.Tensor:
        """Instantaneous phase ``angle(cwt)`` in radians."""
        return torch.angle(self.cwt(wave, freqs, reuse))

    def denoise(self, wave, freqs: Optional[Numbers] = None,
                reuse: bool = True, method: str = "soft",
                threshold_scale: float = 1.0) -> torch.Tensor:
        """Wavelet-domain denoising (see ``ops.denoise``): CWT -> soft/hard
        shrinkage -> band-limited least-squares inverse.  The bank should
        cover the signal band (``ops.coverage``); same bank-reuse contract
        as ``cwt``.  Returns the real (..., N) float32 estimate."""
        wave, bank = self._prepare(wave, freqs, reuse)
        if wave.is_complex():
            raise ValueError("denoise expects a real signal")
        return _denoise(wave, bank, interpolate=self.interpolate,
                        method=method, threshold_scale=threshold_scale)

    def ssq_power(self, wave, freqs: Optional[Numbers] = None,
                  reuse: bool = True,
                  rel_threshold: float = 1e-6) -> torch.Tensor:
        """Synchrosqueezed power (see ``ops.sst``): scalogram energy
        reassigned to the analysis row nearest each cell's instantaneous
        frequency, float32 (..., F, N).  Same bank-reuse contract as
        ``cwt``; needs a real (analytic-family) bank, a real signal and a
        monotone freqs grid.  On the card a single "lin" or "log" grid at a
        kernel length runs the synchrosqueezing kernels."""
        wave, bank = self._prepare(wave, freqs, reuse)
        if bank.is_complex():
            raise ValueError(
                "synchrosqueezing needs an analytic (real-bank) family; "
                "Normal/Twice-mode banks carry no usable phase")
        if wave.is_complex():
            raise ValueError("synchrosqueezing expects a real signal")
        return _ssq_power(wave, bank, self._bank_freqs, self.sfreq,
                          interpolate=self.interpolate,
                          rel_threshold=rel_threshold)

    def extract_modes(self, wave, freqs: Optional[Numbers] = None,
                      reuse: bool = True, n_modes: int = 2,
                      penalty: float = 0.5, bw_rows: float = 2.0):
        """Iterative multi-component retrieval (see
        ``ops.ridge.extract_modes``): ridge-track the dominant component,
        reconstruct it around the track, subtract, ``n_modes`` times.  Same
        bank-reuse contract as ``cwt``; one real (N,) signal.  Returns
        ``(modes (K, N), tracks (K, N) row positions, residual (N,))``."""
        wave, bank = self._prepare(wave, freqs, reuse)
        if wave.is_complex():
            raise ValueError("extract_modes expects a real signal")
        if wave.ndim != 1:
            raise ValueError("extract_modes takes one (N,) signal; loop for "
                             "batches")
        return _extract_modes(wave, bank, n_modes=n_modes, penalty=penalty,
                              bw_rows=bw_rows, interpolate=self.interpolate)

    def scattering(self, wave, freqs1: Numbers, freqs2: Numbers,
                   stride: int = 32, lowpass: str = "auto"):
        """Order-2 time scattering (see ``ops.scattering``): CWT -> modulus
        -> CWT -> lowpass, returning (S1, S2) translation-stable features.
        ``freqs1`` are analysis frequencies, ``freqs2`` MODULATION rates
        (typically 1-64 Hz).  Both banks are built at the signal length
        (the cwt/power cache is not touched); a real-bank (analytic)
        family is required."""
        wave = torch.as_tensor(wave, dtype=torch.float32, device=self.device)
        n = wave.shape[-1]

        def build(freqs, analytic):
            bank = _bank.make_fft_bank(
                self._wdef(), self._check_freqs(freqs), n, self.sfreq,
                analytic, self.real_wave_length, device=self.device)
            if bank.is_complex():
                raise ValueError(
                    "scattering needs an analytic (real-bank) family; "
                    "Normal/Twice-mode banks are not meaningful here")
            return bank

        # Layer 2 sees the (real, nonnegative) modulus: its spectrum is
        # two-sided, so no analytic trick there.
        return _scattering(wave, build(freqs1, self.interpolate),
                           build(freqs2, False), self.sfreq, stride=stride,
                           interpolate=self.interpolate, lowpass=lowpass)
