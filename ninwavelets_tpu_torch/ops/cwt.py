"""The CWT in plain PyTorch: FFT x bank x iFFT, and its epoch reductions
(port of ``ninwavelets_tpu.ops.cwt``).

This is the plain path.  It serves the CPU, and it is the yardstick the fused
CUDA kernel (``ops.fused``) is held against on the card.  The epoch
reductions loop over epochs, so memory stays O(C*F*N) whatever the epoch
count.  Each epoch's transform runs inside a ``ninw.epoch.cwt`` span.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.observability import span
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
    return power_term(cwt_from_bank(signal, bank, interpolate))


def abs_from_bank(signal: torch.Tensor, bank: torch.Tensor,
                  interpolate: bool = False) -> torch.Tensor:
    """``|cwt|``, float32."""
    return torch.abs(cwt_from_bank(signal, bank, interpolate))


def power_term(c: torch.Tensor) -> torch.Tensor:
    """``|c|**2`` of complex coefficients, float32: Re**2 + Im**2.  The
    power of every plain route (``power_from_bank``, the epoch sums)."""
    return torch.square(c.real) + torch.square(c.imag)


def unit_phase(c: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """``c / |c|``, the term of every plain coherence sum.  ``eps`` floors
    |c| in the division; at 0.0 an exactly-zero coefficient gives
    0/0 = NaN, as in the reference."""
    mag = torch.abs(c)
    if eps:
        mag = torch.clamp(mag, min=eps)
    return c / mag


def _epoch_sum(signals, bank, interpolate, *per_epoch,
               transform=cwt_from_bank):
    """Sums of each ``per_epoch(cwt)`` over the leading (epoch) axis, one
    epoch at a time: one plane for each function given.  Each epoch's CWT
    (``transform``) is computed once; each term is added into its total as
    soon as it exists, and the coefficients are dropped before the next
    epoch's, so the totals, one epoch's coefficients and one term's
    temporaries are all that is held.  The first epoch's terms start the
    totals."""
    totals = None
    for sig in signals:
        with span("ninw.epoch.cwt"):
            c = transform(sig, bank, interpolate)
        if totals is None:
            totals = [f(c) for f in per_epoch]
        else:
            for total, f in zip(totals, per_epoch):
                total.add_(f(c))
        del c
    return totals


def _epoch_mean(signals, bank, interpolate, per_epoch):
    """Mean of ``per_epoch(cwt)`` over the leading (epoch) axis, one epoch
    at a time."""
    return _epoch_sum(signals, bank, interpolate, per_epoch)[0] \
        / signals.shape[0]


def mean_power_from_bank(signals: torch.Tensor, bank: torch.Tensor,
                         interpolate: bool = False) -> torch.Tensor:
    """Epoch-mean power: (E, ..., N) -> (..., F, N) float32,
    ``mean_E |cwt|**2``."""
    return _epoch_mean(signals, bank, interpolate, power_term)


def itc_from_bank(signals: torch.Tensor, bank: torch.Tensor,
                  interpolate: bool = False, eps: float = 0.0
                  ) -> torch.Tensor:
    """Inter-trial coherence ``| mean_E (cwt / |cwt|) |``: (E, ..., N) ->
    (..., F, N) float32.  ``eps`` floors |cwt| in the division; at the
    default 0.0 an exactly-zero coefficient gives 0/0 = NaN, as in the
    reference."""
    return torch.abs(_epoch_mean(signals, bank, interpolate,
                                 lambda c: unit_phase(c, eps)))


def power_itc_from_bank(signals: torch.Tensor, bank: torch.Tensor,
                        interpolate: bool = False):
    """``(mean_power_from_bank, itc_from_bank)`` off one pass: each epoch's
    CWT is computed once and feeds both sums, which add in the same order
    as the two reductions', so both planes equal theirs bit for bit.  The
    totals are divided in place: the magnitude, which allocates a complex
    temporary on the card, then runs beside no other copy of them."""
    power, phase = _epoch_sum(signals, bank, interpolate, power_term,
                              unit_phase)
    n_epochs = signals.shape[0]
    return power.div_(n_epochs), torch.abs(phase.div_(n_epochs))
