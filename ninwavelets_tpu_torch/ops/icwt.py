"""Inverse CWT: reconstruct the signal from its coefficients (port of
``ninwavelets_tpu.ops.icwt``).

The CWT here is a bank of linear frequency-domain filters
(``W_f = ifft(B_f . fft(x))``), so the least-squares inverse has a closed
form per FFT bin:

    x_hat(w) = sum_f conj(B_f(w)) . FFT(W_f)(w) / sum_f |B_f(w)|^2

exact wherever the bank covers the spectrum (sum |B|^2 > 0); outside the
covered band the Tikhonov term ``eps`` keeps the division finite and the
estimate lacks the uncovered components.  Plain torch on every device.
"""
from __future__ import annotations

import torch

__all__ = ["icwt_from_bank", "coverage"]


def icwt_from_bank(coeffs: torch.Tensor, bank: torch.Tensor,
                   eps: float = 1e-6, real_signal: bool = True,
                   support_floor: float = 0.0) -> torch.Tensor:
    """Least-squares signal estimate from (..., F, N) complex coefficients.

    Args:
      coeffs: (..., F, N) complex CWT coefficients (as from
        ``cwt_from_bank`` with the same bank).
      bank: (F, N) frequency-domain bank used for the analysis.
      eps: Tikhonov floor for the energy normalization, relative to the
        peak of ``sum_f |B_f|^2``.
      real_signal: the banks live on the positive-frequency half, so the
        estimate populates positive bins only; for a real input the
        negative half is their conjugate mirror, which this restores.  Set
        False for a genuinely complex signal.
      support_floor: zero the estimate at bins whose coverage is below this
        fraction of the peak (band-limited inverse); use ~1e-3 for
        nonlinearly modified coefficients (``ops.denoise``).

    Returns:
      (..., N) complex reconstruction (take ``.real`` for real signals).
    """
    n = coeffs.shape[-1]
    spec_w = torch.fft.fft(coeffs)                          # (..., F, N)
    bconj = bank.conj() if bank.is_complex() else bank
    num = torch.sum(bconj * spec_w, dim=-2)                 # (..., N)
    energy = coverage(bank)                                 # (N,)
    floor = float(eps) * torch.amax(energy)
    x_spec = num / torch.maximum(energy, floor)
    if support_floor:
        x_spec = torch.where(
            energy >= float(support_floor) * torch.amax(energy), x_spec,
            torch.zeros_like(x_spec))
    if real_signal:
        # Hermitian completion: bin k > N/2 := conj(bin N-k).
        rev = torch.conj(torch.roll(torch.flip(x_spec, (-1,)), 1, -1))
        mask_hi = torch.arange(n, device=x_spec.device) > n // 2
        x_spec = torch.where(mask_hi, rev, x_spec)
    return torch.fft.ifft(x_spec)


def coverage(bank: torch.Tensor) -> torch.Tensor:
    """(N,) spectral energy ``sum_f |B_f|^2``: reconstruction is reliable
    where this is well above zero."""
    return torch.sum(torch.abs(bank) ** 2, dim=0)
