"""Zero-phase spectral filtering and FFT resampling (port of
``ninwavelets_tpu.ops.filtering``).

* The filters are zero-phase gains on the rfft grid with raised-cosine
  transitions: the signal is reflect-padded to a power of two
  (``ops.dwt.pow2_pad``), multiplied by the gain, inverse-transformed and
  cropped.  The padding is part of the result (it sets the grid the gain
  is sampled on and what the circular filter sees past the end), so the
  port keeps it though cuFFT takes any length.
* ``resample`` has two routes.  When the target grid is a power-of-two
  fraction or multiple of the padded grid (1000 -> 250, 512 -> 128) it is
  one spectrum truncation (the new Nyquist bin set to its real part) or
  zero-padding, and an irfft.  Any other ratio truncates the spectrum at
  the new Nyquist, oversamples to a power-of-two grid at least 8x the
  target rate and interpolates by periodic Catmull-Rom cubics at the
  output times.  Those times are computed in float32, as the JAX package
  computes them: past about 2^21 oversampled samples their spacing is a
  quarter sample, and the interpolation is evaluated at the wrong
  fraction (1.3e-2 error on a 100 Hz tone over 600,000 samples, 1000 ->
  300 Hz).  The port gives the JAX package's numbers, fault included.
* Before every irfft the DC and Nyquist bins are set to their real parts:
  the CPU's pocketfft ignores their imaginary parts, and cuFFT's C2R does
  not promise to.

A numpy input goes to ``device`` (the card when None); a tensor stays on
its device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..device import as_float32
from .dwt import pow2_pad

__all__ = ["bandpass", "lowpass", "highpass", "notch", "resample"]


def _irfft(spec: torch.Tensor, n: int) -> torch.Tensor:
    """``irfft(spec, n)`` with the DC and (even ``n``) Nyquist bins taken
    as their real parts, the C2R convention of pocketfft and the JAX
    package's CPU FFT.  Sets those bins of ``spec`` in place."""
    spec[..., 0].imag.zero_()
    if n % 2 == 0 and spec.shape[-1] == n // 2 + 1:
        spec[..., -1].imag.zero_()
    return torch.fft.irfft(spec, n=n, dim=-1)


def _edge(d: torch.Tensor, w: float) -> torch.Tensor:
    """0 below the transition, 1 above, raised-cosine ramp inside.
    ``d`` is the (signed) distance past the cut, ``w`` the full
    transition width.  The clip comes BEFORE the sin, or the flat regions
    ripple."""
    return 0.5 * (1.0 + torch.sin(math.pi * torch.clamp(d / w, -0.5, 0.5)))


def _band(x: torch.Tensor, sfreq: float, f_lo, f_hi, trans_frac: float,
          stop: bool, trans_hz=None) -> torch.Tensor:
    n = x.shape[-1]
    xp, _ = pow2_pad(x)
    n2 = xp.shape[-1]
    f = torch.arange(n2 // 2 + 1, dtype=torch.float32,
                     device=x.device) * (sfreq / n2)
    gain = torch.ones_like(f)
    # transition width: proportional to the edge frequency for pass
    # filters, ABSOLUTE for the notch (a width-proportional ramp at the
    # notch's center frequency would dwarf the stop band itself)
    if f_lo is not None:
        w = trans_hz if trans_hz is not None else 2.0 * trans_frac * f_lo
        gain = gain * _edge(f - f_lo, w)
    if f_hi is not None:
        w = trans_hz if trans_hz is not None else 2.0 * trans_frac * f_hi
        gain = gain * _edge(f_hi - f, w)
    if stop:
        gain = 1.0 - gain
    y = _irfft(torch.fft.rfft(xp) * gain, n2)
    return y[..., :n].contiguous()


def _as32(x, device) -> torch.Tensor:
    x = as_float32(x, device)
    if x.shape[-1] < 4:
        raise ValueError("signal too short")
    return x


def bandpass(x, sfreq: float, f_lo: float, f_hi: float,
             trans_frac: float = 0.25, device=None) -> torch.Tensor:
    """Zero-phase raised-cosine bandpass of (..., N) signals: unity in
    [f_lo, f_hi], cosine transitions of width ``2 trans_frac * edge``
    centered on each edge."""
    if not (0.0 < f_lo < f_hi):
        raise ValueError("need 0 < f_lo < f_hi")
    if f_hi >= sfreq / 2.0:
        raise ValueError("f_hi must be below Nyquist")
    return _band(_as32(x, device), float(sfreq), float(f_lo), float(f_hi),
                 float(trans_frac), False)


def lowpass(x, sfreq: float, f_hi: float, trans_frac: float = 0.25,
            device=None) -> torch.Tensor:
    """Zero-phase lowpass (see ``bandpass``)."""
    if not (0.0 < f_hi < sfreq / 2.0):
        raise ValueError("need 0 < f_hi < Nyquist")
    return _band(_as32(x, device), float(sfreq), None, float(f_hi),
                 float(trans_frac), False)


def highpass(x, sfreq: float, f_lo: float, trans_frac: float = 0.25,
             device=None) -> torch.Tensor:
    """Zero-phase highpass (see ``bandpass``)."""
    if not (0.0 < f_lo < sfreq / 2.0):
        raise ValueError("need 0 < f_lo < Nyquist")
    return _band(_as32(x, device), float(sfreq), float(f_lo), None,
                 float(trans_frac), False)


def notch(x, sfreq: float, f0: float, width: float = 2.0,
          trans_frac: float = 0.25, device=None) -> torch.Tensor:
    """Zero-phase band-stop around ``f0`` (line-noise removal): the
    complement of a ``width``-Hz-wide bandpass centered on ``f0``, with
    transitions ``width`` Hz wide."""
    f_lo, f_hi = f0 - width / 2.0, f0 + width / 2.0
    if not (0.0 < f_lo < f_hi < sfreq / 2.0):
        raise ValueError("notch band must sit inside (0, Nyquist)")
    return _band(_as32(x, device), float(sfreq), float(f_lo), float(f_hi),
                 float(trans_frac), True, trans_hz=float(width))


def _resample_pow2(xp: torch.Tensor, n2: int, m2: int) -> torch.Tensor:
    """Exact FFT resampling n2 -> m2 samples, both powers of two."""
    spec = torch.fft.rfft(xp)
    k_in, k_out = n2 // 2 + 1, m2 // 2 + 1
    if m2 < n2:                                     # decimate: truncate
        spec = spec[..., :k_out]                    # _irfft: new Nyquist
    else:                                           # interpolate: pad
        spec = torch.nn.functional.pad(spec, (0, k_out - k_in))
    return _irfft(spec, m2) * (m2 / n2)


def _resample_any(xp: torch.Tensor, n2: int, l2: int, m: int, ratio: float,
                  k_cut: int) -> torch.Tensor:
    """Arbitrary-ratio resampling: anti-alias truncation at the NEW
    Nyquist (bin ``k_cut``), oversampling to l2, then Catmull-Rom cubic
    interpolation at the m output times.  Without the truncation the
    content above the new Nyquist survives the oversampling and ALIASES
    when the interpolant is point-sampled."""
    spec = torch.fft.rfft(xp)                       # (., n2//2+1)
    k_in = n2 // 2 + 1
    if k_cut < k_in:
        spec[..., k_cut:] = 0
    spec = torch.nn.functional.pad(spec, (0, l2 // 2 + 1 - k_in))
    up = _irfft(spec, l2) * (l2 / n2)
    # output sample j sits at padded-grid time j / ratio, i.e. oversampled
    # index j * l2 / (n2 * ratio), in float32 (see the module docstring)
    pos = torch.arange(m, dtype=torch.float32, device=xp.device) * (
        l2 / (n2 * ratio))
    i0 = torch.clamp(torch.floor(pos).to(torch.int32), 0, l2 - 1)
    t = pos - i0
    i0 = i0.long()

    # periodic wrap, not clip: the Fourier model is circular, and a
    # clipped edge stencil diverges from it by O(1) at sample 0
    def g(k):
        return up.index_select(-1, torch.remainder(i0 + k, l2))

    pm1, p0, p1, p2 = g(-1), g(0), g(1), g(2)
    # Catmull-Rom basis
    return 0.5 * ((2.0 * p0) + (-pm1 + p1) * t
                  + (2.0 * pm1 - 5.0 * p0 + 4.0 * p1 - p2) * t * t
                  + (-pm1 + 3.0 * p0 - 3.0 * p1 + p2) * t * t * t)


def resample(x, sfreq: float, new_sfreq: float, device=None):
    """``(y, new_sfreq)``: a (..., M) resampled copy of (..., N) signals
    with ``M = round(N * new_sfreq / sfreq)``.

    Power-of-two rate ratios are one exact spectrum truncation or padding;
    any other ratio runs through an >= 8x power-of-two oversampling and
    cubic interpolation (see the module docstring for its float32
    positions).  Downsampling applies the implied brick-wall anti-alias
    (spectrum truncation); lowpass first for a softer transition.
    """
    if new_sfreq <= 0:
        raise ValueError("new_sfreq must be positive")
    x = _as32(x, device)
    n = x.shape[-1]
    ratio = float(new_sfreq) / float(sfreq)
    m = max(1, int(round(n * ratio)))
    xp, _ = pow2_pad(x)
    n2 = xp.shape[-1]
    m2f = n2 * ratio
    m2 = int(round(m2f))
    if abs(m2f - m2) < 1e-9 and m2 >= 2 and (m2 & (m2 - 1)) == 0:
        y = _resample_pow2(xp, n2, m2)[..., :m].contiguous()
    else:
        l2 = 1 << int(np.ceil(np.log2(max(8.0 * m2f, 16.0))))
        l2 = max(l2, n2)          # never throw away input bandwidth
        k_cut = max(1, int(np.floor(m2f / 2.0)))    # new Nyquist bin
        y = _resample_any(xp, n2, l2, m, ratio, k_cut)
    return y, float(new_sfreq)
