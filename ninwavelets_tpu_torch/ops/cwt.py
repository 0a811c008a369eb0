"""The CWT in plain PyTorch: FFT x bank x iFFT, and its epoch reductions
(port of ``ninwavelets_tpu.ops.cwt``).

This is the plain path.  It serves the CPU, and it is the yardstick the fused
CUDA kernel (``ops.fused``) is held against on the card.  The epoch
reductions loop over epochs, so memory stays O(C*F*N) whatever the epoch
count.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .grids import analytic_mask


def analytic_spectrum(signal: torch.Tensor, interpolate: bool
                      ) -> torch.Tensor:
    """FFT of the signal; with ``interpolate`` the negative-frequency half
    (bins ``>= n//2``, the Nyquist bin included) is zeroed.  For a real
    signal that is the rFFT's lower bins, zero-padded."""
    n = signal.shape[-1]
    if interpolate and not signal.is_complex():
        half = torch.fft.rfft(signal)[..., :n // 2]
        return F.pad(half, (0, n - n // 2))
    spec = torch.fft.fft(signal.to(torch.complex64))
    if interpolate:
        spec = spec * analytic_mask(n, torch.float32, spec.device)
    return spec


def cwt_from_bank(signal: torch.Tensor, bank: torch.Tensor,
                  interpolate: bool = False) -> torch.Tensor:
    """(..., N) signal x (F, N) bank -> (..., F, N) complex64 coefficients,
    ``ifft(bank * fft(signal))``."""
    spec = analytic_spectrum(signal, interpolate)
    return torch.fft.ifft(spec[..., None, :] * bank)


def power_from_bank(signal: torch.Tensor, bank: torch.Tensor,
                    interpolate: bool = False) -> torch.Tensor:
    """``|cwt|**2``, float32."""
    c = cwt_from_bank(signal, bank, interpolate)
    return torch.square(c.real) + torch.square(c.imag)


def abs_from_bank(signal: torch.Tensor, bank: torch.Tensor,
                  interpolate: bool = False) -> torch.Tensor:
    """``|cwt|``, float32."""
    return torch.abs(cwt_from_bank(signal, bank, interpolate))


def _epoch_mean(signals, bank, interpolate, per_epoch):
    """Mean of ``per_epoch(cwt)`` over the leading (epoch) axis, one epoch
    at a time."""
    total = None
    for sig in signals:
        term = per_epoch(cwt_from_bank(sig, bank, interpolate))
        total = term if total is None else total.add_(term)
    return total / signals.shape[0]


def mean_power_from_bank(signals: torch.Tensor, bank: torch.Tensor,
                         interpolate: bool = False) -> torch.Tensor:
    """Epoch-mean power: (E, ..., N) -> (..., F, N) float32,
    ``mean_E |cwt|**2``."""
    return _epoch_mean(signals, bank, interpolate,
                       lambda c: torch.square(c.real) + torch.square(c.imag))


def itc_from_bank(signals: torch.Tensor, bank: torch.Tensor,
                  interpolate: bool = False, eps: float = 0.0
                  ) -> torch.Tensor:
    """Inter-trial coherence ``| mean_E (cwt / |cwt|) |``: (E, ..., N) ->
    (..., F, N) float32.  ``eps`` floors |cwt| in the division; at the
    default 0.0 an exactly-zero coefficient gives 0/0 = NaN, as in the
    reference."""
    def unit_phase(c):
        mag = torch.abs(c)
        if eps:
            mag = torch.clamp(mag, min=eps)
        return c / mag

    return torch.abs(_epoch_mean(signals, bank, interpolate, unit_phase))
