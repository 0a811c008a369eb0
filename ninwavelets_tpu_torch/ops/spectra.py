"""Closed-form wavelet spectra and time-domain formulas (port of
``ninwavelets_tpu.ops.spectra``).

Every function broadcasts over its arguments: a (1, N) grid against an (F, 1)
column of analysis frequencies gives the whole (F, N) bank in one call.  The
Generalized Morse spectrum is evaluated in log space because ``w ** b``
overflows float32 at ``w > ~148`` for ``b = 17.5``.
"""
from __future__ import annotations

import math

import torch

_PI_M14 = math.pi ** (-0.25)


def _like(x, ref: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=ref.dtype, device=ref.device)


# ----------------------------------------------------------------------------
# Generalized Morse (mode=Reverse)
# ----------------------------------------------------------------------------

def morse_spectrum(freq_grid: torch.Tensor, freq, b: float = 17.5,
                   r: float = 3.0) -> torch.Tensor:
    """``2 * H(w) * w**b * exp((b/r) * (1 - w**r))`` with ``w = grid / freq``,
    evaluated as ``2 * exp(b*log(w) + (b/r)*(1 - w**r))``; ``w <= 0`` maps to
    0 (Heaviside with H(0) = 0)."""
    w = freq_grid / _like(freq, freq_grid)
    b = float(b)
    r = float(r)
    safe_w = torch.where(w > 0, w, torch.ones_like(w))
    log_mag = b * torch.log(safe_w) + (b / r) * (1.0 - safe_w ** r)
    return torch.where(w > 0, 2.0 * torch.exp(log_mag), torch.zeros_like(w))


def morse_taper_spectrum(freq_grid: torch.Tensor, freq, b: float = 17.5,
                         r: float = 3.0, order: int = 0) -> torch.Tensor:
    """Order-``k`` generalized Morse wavelet (Olhede & Walden 2002) in the
    engine's Morse convention,

        M_k(w) = 2 rho_k * w**b * exp((b/r)(1 - w**r)) * L_k^c(2(b/r)w**r)

    with ``c = (2b+1)/r - 1`` and ``rho_k = sqrt(k! Gamma(c+1) /
    Gamma(k+c+1))``.  ``order=0`` is ``morse_spectrum``.  The Laguerre
    recurrence argument is zeroed where the log-magnitude has underflowed
    (< -60 nats), so the polynomial never overflows float32 where the output
    is 0 anyway.
    """
    k = int(order)
    if k == 0:
        return morse_spectrum(freq_grid, freq, b, r)
    b = float(b)
    r = float(r)
    c = (2.0 * b + 1.0) / r - 1.0
    log_rho = 0.5 * (math.lgamma(k + 1.0) + math.lgamma(c + 1.0)
                     - math.lgamma(k + c + 1.0))
    w = freq_grid / _like(freq, freq_grid)
    safe_w = torch.where(w > 0, w, torch.ones_like(w))
    log_mag = b * torch.log(safe_w) + (b / r) * (1.0 - safe_w ** r) + log_rho
    live = (w > 0) & (log_mag > -60.0)
    x = torch.where(live, 2.0 * (b / r) * safe_w ** r, torch.zeros_like(w))
    prev, cur = torch.ones_like(x), 1.0 + c - x
    for m in range(2, k + 1):
        prev, cur = cur, ((2 * m - 1 + c - x) * cur - (m - 1 + c) * prev) / m
    return torch.where(live, 2.0 * torch.exp(log_mag) * cur,
                       torch.zeros_like(w))


# ----------------------------------------------------------------------------
# Morlet / Gabor (mode=Both)
# ----------------------------------------------------------------------------

def morlet_norm_constants(sigma: float, gabor: bool = False):
    """The reference's ``c`` and ``k``.  Quirk kept for parity: ``c`` uses
    ``exp(-sigma**2)``, not the textbook ``exp(-sigma**2 / 2)``."""
    sigma = float(sigma)
    c = (1.0 + math.exp(-sigma * sigma)
         - 2.0 * math.exp(-0.75 * sigma * sigma)) ** (-0.5)
    k = 0.0 if gabor else math.exp(-(sigma ** 2) / 2.0)
    return c, k


def morlet_peak_freq(freq, sigma: float) -> torch.Tensor:
    """``sigma / (1 - exp(-sigma * freq))`` in float32."""
    sigma = float(sigma)
    freq = torch.as_tensor(freq, dtype=torch.float32)
    return sigma / (1.0 - torch.exp(-sigma * freq))


def morlet_spectrum(freq_grid: torch.Tensor, freq, sigma: float = 7.0,
                    gabor: bool = False) -> torch.Tensor:
    """``c * pi**(-1/4) * (exp(-(sigma - s)**2 / 2) - k * exp(-s**2 / 2))``
    with ``s = grid / freq * peak_freq(freq)``."""
    c, k = morlet_norm_constants(sigma, gabor)
    freq = _like(freq, freq_grid)
    s = freq_grid / freq * morlet_peak_freq(freq, sigma)
    sigma = float(sigma)
    out = torch.exp(-0.5 * torch.square(sigma - s))
    if k != 0.0:
        out = out - k * torch.exp(-0.5 * torch.square(s))
    return (c * _PI_M14) * out


def morlet_time(timeline: torch.Tensor, sigma: float = 7.0,
                gabor: bool = False) -> torch.Tensor:
    """``c * pi**(-1/4) * exp(-t**2/2) * (exp(i*sigma*t) - k)``, complex64."""
    c, k = morlet_norm_constants(sigma, gabor)
    sigma = float(sigma)
    envelope = torch.exp(-0.5 * torch.square(timeline))
    carrier = torch.exp(1j * sigma * timeline.to(torch.complex64))
    return (c * _PI_M14) * envelope * (carrier - k)


# ----------------------------------------------------------------------------
# Mexican hat (mode=Normal)
# ----------------------------------------------------------------------------

MEXICAN_HAT_PEAK_FREQ = math.sqrt(6.0) / (math.pi * math.pi)


def mexican_hat_time(timeline: torch.Tensor, sigma: float = 7.0
                     ) -> torch.Tensor:
    """``(1 - (t/sigma)**2) * exp(-t**2 / sigma**2 / 2)``, real."""
    tc = timeline / float(sigma)
    return (1.0 - torch.square(tc)) * torch.exp(-0.5 * torch.square(tc))


# ----------------------------------------------------------------------------
# Shannon (mode=Reverse)
# ----------------------------------------------------------------------------

def shannon_spectrum(freq_grid: torch.Tensor, freq=1.0) -> torch.Tensor:
    """Brick wall on the grid VALUES, not physical Hz: the reference ignores
    ``freq`` and passes only bins at <= 1 "grid unit".  Kept for coefficient
    parity."""
    del freq
    return (freq_grid <= 1.0).to(freq_grid.dtype)


# ----------------------------------------------------------------------------
# Haar (mode=Normal)
# ----------------------------------------------------------------------------

def haar_time(timeline: torch.Tensor) -> torch.Tensor:
    """Step function: +1 on (0, 1], -1 on (-1, 0], 0 elsewhere."""
    t = timeline
    pos = (t > 0.0) & (t <= 1.0)
    neg = (t > -1.0) & (t <= 0.0)
    return pos.to(t.dtype) - neg.to(t.dtype)
