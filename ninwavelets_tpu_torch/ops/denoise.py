"""Wavelet-domain signal denoising by soft / hard coefficient shrinkage
(port of ``ninwavelets_tpu.ops.denoise``): CWT -> shrink -> the exact
least-squares inverse (``ops.icwt``).

One global input-noise variance, estimated robustly as the minimum over
rows of (MAD of the coefficient real part / 0.6745)^2 normalized by that
row's white-noise gain ``mean|B_f|^2 / 2`` (a per-row MAD alone would read a
sustained tone as noise and kill its row).  Each row then gets the
Donoho-Johnstone universal threshold at its own gain, ``lambda_f = k *
sqrt(var_in * mean|B_f|^2 / 2) * sqrt(2 ln N)``, applied to the complex
magnitude: soft shrinkage ``c * max(1 - lambda/|c|, 0)`` or hard keep/kill.
Plain torch on every device.
"""
from __future__ import annotations

import math

import torch

from .cwt import cwt_from_bank
from .icwt import icwt_from_bank

__all__ = ["denoise_from_bank", "denoise"]


def _median(x: torch.Tensor) -> torch.Tensor:
    """Median over the last axis, the mean of the two middle values for an
    even count (``jnp.median``'s; ``torch.median`` takes the lower)."""
    s = torch.sort(x, dim=-1).values
    m = x.shape[-1]
    return 0.5 * (s[..., (m - 1) // 2] + s[..., m // 2])


def denoise_from_bank(signal: torch.Tensor, bank: torch.Tensor,
                      interpolate: bool = False, method: str = "soft",
                      threshold_scale: float = 1.0,
                      eps: float = 1e-6) -> torch.Tensor:
    """Denoised reconstruction of ``signal``: (..., N) -> (..., N) real.

    Args:
      signal: (..., N) real signal(s).
      bank: (F, N) analysis bank; reconstruction quality needs the bank to
        cover the signal band (``ops.icwt.coverage``).
      method: "soft" (shrink toward zero) or "hard" (keep/kill).
      threshold_scale: multiplier on the universal threshold.
    """
    if method not in ("soft", "hard"):
        raise ValueError("method must be 'soft' or 'hard'")
    c = cwt_from_bank(signal, bank, interpolate)            # (..., F, N)
    n = signal.shape[-1]
    # Per-row white-noise gain (per real/imag component).
    gain = torch.clamp(torch.mean(torch.abs(bank) ** 2, dim=-1) / 2.0,
                       min=1e-30)                           # (F,)
    mad = _median(torch.abs(c.real)) / 0.6745               # (..., F)
    var_in = torch.amin(torch.square(mad) / gain, dim=-1,
                        keepdim=True)                       # (..., 1)
    sigma = torch.sqrt(var_in[..., None] * gain[:, None])   # (..., F, 1)
    lam = float(threshold_scale) * sigma * math.sqrt(2.0 * math.log(n))
    mag = torch.abs(c)
    if method == "soft":
        shrink = torch.clamp(1.0 - lam / torch.clamp(mag, min=1e-30),
                             min=0.0)
    else:
        shrink = (mag > lam).to(mag.dtype)
    # Band-limited inverse: the shrinkage leaks energy outside the covered
    # band, where 1/coverage would amplify it.
    return icwt_from_bank(c * shrink, bank, eps=eps, real_signal=True,
                          support_floor=1e-3).real


def denoise(signal: torch.Tensor, bank: torch.Tensor, *,
            interpolate: bool = False, method: str = "soft",
            threshold_scale: float = 1.0, eps: float = 1e-6):
    """``denoise_from_bank`` (the JAX package's jitted entry point)."""
    return denoise_from_bank(signal, bank, interpolate, method,
                             float(threshold_scale), float(eps))
