"""The Paul / DOG / Bump wavelet spectra and the cross-signal products of
two channels (port of the spectra and the coherence part of
``ninwavelets_tpu.ops.extensions``): the cross-wavelet product, epoch-wise
wavelet coherence, imaginary coherency and the phase slope index.

The spectra follow the engine convention of ``ops.spectra``: a
frequency-domain ``trans_formula(grid, freq)`` peaking at ``grid == freq``
with amplitude 2, zero at zero and negative frequency, evaluated in log space
where powers would overflow float32.

All three statistics come from the same four epoch sums
(``coherence_sums``), which loop over epochs so memory stays O(C*F*N).  The
``*_auto`` entry points take the cross-pair kernel's "coherence" epilogue
(``ops.fused``) for a real bank and an (E, C, N) pair batch that
``ops.fused.supports()`` takes, as the JAX package does on a TPU; the
single-pair (E, N) shape runs the plain sums.  The other families of the
JAX module (bicoherence, single-trial wavelet coherence, cross-frequency
directionality) are not ported yet.
"""
from __future__ import annotations

import torch

from .cwt import cwt_from_bank
from .spectra import _like


# -- Paul, DOG and Bump spectra (mode=Reverse) --------------------------------

def paul_spectrum(freq_grid: torch.Tensor, freq, m: float = 4.0
                  ) -> torch.Tensor:
    """Paul wavelet of order m, peak-normalized:
    ``2 * H(w) * w**m * exp(m * (1 - w))`` with ``w = grid / freq`` (the
    textbook ``w**m e^{-w}`` rescaled so the peak sits at the analysis
    frequency), evaluated in log space."""
    w = freq_grid / _like(freq, freq_grid)
    m = float(m)
    safe_w = torch.where(w > 0, w, torch.ones_like(w))
    log_mag = m * torch.log(safe_w) + m * (1.0 - safe_w)
    return torch.where(w > 0, 2.0 * torch.exp(log_mag), torch.zeros_like(w))


def dog_spectrum(freq_grid: torch.Tensor, freq, m: float = 2.0
                 ) -> torch.Tensor:
    """Analytic derivative-of-Gaussian wavelet of order m, peak-normalized:
    ``2 * H(w) * w**m * exp(m/2 * (1 - w**2))``.  ``m = 2`` is the analytic
    counterpart of the MexicanHat family."""
    w = freq_grid / _like(freq, freq_grid)
    m = float(m)
    safe_w = torch.where(w > 0, w, torch.ones_like(w))
    log_mag = m * torch.log(safe_w) + 0.5 * m * (1.0 - safe_w * safe_w)
    return torch.where(w > 0, 2.0 * torch.exp(log_mag), torch.zeros_like(w))


def bump_spectrum(freq_grid: torch.Tensor, freq, sigma: float = 0.6
                  ) -> torch.Tensor:
    """Bump wavelet, peak-normalized: ``2 * exp(1 - 1/(1 - u**2))`` on
    ``|u| < 1`` with ``u = (w - 1) / sigma``, ``w = grid / freq``; zero
    elsewhere (compact support in frequency)."""
    w = freq_grid / _like(freq, freq_grid)
    u = (w - 1.0) / float(sigma)
    inside = (torch.abs(u) < 1.0) & (w > 0)
    safe_u2 = torch.where(inside, u * u, torch.zeros_like(u))
    val = 2.0 * torch.exp(1.0 - 1.0 / (1.0 - safe_u2))
    return torch.where(inside, val, torch.zeros_like(w))


def cross_power_from_bank(sig_a: torch.Tensor, sig_b: torch.Tensor,
                          bank: torch.Tensor, interpolate: bool = False):
    """Cross-wavelet product ``Wa * conj(Wb)`` of (..., N) signals as a
    (real, imag) pair of (..., F, N) planes: its magnitude is the
    cross-power, its angle the relative phase of the two signals."""
    x = (cwt_from_bank(sig_a, bank, interpolate)
         * torch.conj(cwt_from_bank(sig_b, bank, interpolate)))
    return x.real, x.imag


def epoch_sums(sigs_a: torch.Tensor, sigs_b: torch.Tensor,
               bank: torch.Tensor, interpolate: bool, per_epoch):
    """Sums over the leading (epoch) axis of the planes ``per_epoch(wa,
    wb)`` returns for each epoch's two coefficient sets, one epoch at a
    time (memory O(C*F*N) whatever the epoch count)."""
    totals = None
    for sa, sb in zip(sigs_a, sigs_b):
        terms = per_epoch(cwt_from_bank(sa, bank, interpolate),
                          cwt_from_bank(sb, bank, interpolate))
        totals = (list(terms) if totals is None
                  else [t + u for t, u in zip(totals, terms)])
    return tuple(totals)


def coherence_sums(sigs_a, sigs_b, bank, interpolate: bool = False):
    """Epoch-SUMMED coherence accumulators ``(sum cross_r, sum cross_i,
    sum |Wa|^2, sum |Wb|^2)`` of (E, ..., N) pair batches: the plain version
    of the cross-pair kernel's "coherence" epilogue."""
    def per_epoch(ca, cb):
        x = ca * torch.conj(cb)
        return (x.real, x.imag,
                torch.square(ca.real) + torch.square(ca.imag),
                torch.square(cb.real) + torch.square(cb.imag))

    return epoch_sums(sigs_a, sigs_b, bank, interpolate, per_epoch)


def coherence_from_sums(xr, xi, pa, pb, n_epochs: int,
                        eps: float = 1e-12) -> torch.Tensor:
    """``|mean cross|^2 / (mean power_a * mean power_b)`` from the epoch
    sums.  A positive ``eps`` floors the denominator at ``eps`` times its
    maximum, so rows with no spectral support read 0 rather than 0/0."""
    num = (torch.square(xr) + torch.square(xi)) / (n_epochs * n_epochs)
    den = (pa / n_epochs) * (pb / n_epochs)
    if eps:
        den = torch.maximum(den, eps * den.max())
    return num / den


def epoch_coherence_from_bank(sigs_a: torch.Tensor, sigs_b: torch.Tensor,
                              bank: torch.Tensor, interpolate: bool = False,
                              eps: float = 1e-12) -> torch.Tensor:
    """Epoch-wise magnitude-squared wavelet coherence,
    ``|mean_E Wa conj(Wb)|**2 / (mean_E |Wa|**2 * mean_E |Wb|**2)``:
    (E, ..., N) x2 -> (..., F, N) float32 in [0, 1] (up to float error).
    The ensemble mean over epochs plays the role of the time/scale
    smoothing of single-trial coherence."""
    xr, xi, pa, pb = coherence_sums(sigs_a, sigs_b, bank, interpolate)
    return coherence_from_sums(xr, xi, pa, pb, sigs_a.shape[0], eps)


def epoch_coherence(sigs_a, sigs_b, bank, interpolate: bool = False,
                    eps: float = 1e-12) -> torch.Tensor:
    """``epoch_coherence_from_bank`` (real or complex banks): always the
    plain path; ``epoch_coherence_auto`` takes the kernel."""
    return epoch_coherence_from_bank(sigs_a, sigs_b, bank, interpolate, eps)


def epoch_coherence_auto(sigs_a, sigs_b, bank, interpolate: bool = False,
                         eps: float = 1e-12, precision: str = "fast3"):
    """Epoch coherence with automatic kernel dispatch: the cross-pair
    kernel's "coherence" epilogue for a real bank and a workload
    ``ops.fused.supports()`` takes, the plain path otherwise."""
    from .fused import fused_coherence, _kernel_takes
    if not bank.is_complex() and _kernel_takes(sigs_a, bank):
        return fused_coherence(sigs_a, sigs_b, bank, interpolate=interpolate,
                               eps=eps, precision=precision)
    return epoch_coherence(sigs_a, sigs_b, bank, interpolate, eps)


# -- imaginary coherency ------------------------------------------------------

def imcoh_from_sums(xr, xi, pa, pb, eps: float = 1e-12) -> torch.Tensor:
    """``Im(mean cross) / sqrt(mean |Wa|^2 mean |Wb|^2)`` from the
    ``coherence_sums`` planes (the epoch count cancels), with the relative
    denominator floor of ``coherence_from_sums``."""
    den = torch.sqrt(pa * pb)
    if eps:
        den = torch.maximum(den, eps * den.max())
    return xi / den


def imcoh_from_bank(sigs_a: torch.Tensor, sigs_b: torch.Tensor,
                    bank: torch.Tensor, interpolate: bool = False,
                    eps: float = 1e-12) -> torch.Tensor:
    """Imaginary part of coherency (Nolte 2004): (E, ..., N) x2 ->
    (..., F, N) in [-1, 1].  A common instantaneous source gives a purely
    real cross-spectrum, so only lagged interaction survives the Im."""
    xr, xi, pa, pb = coherence_sums(sigs_a, sigs_b, bank, interpolate)
    return imcoh_from_sums(xr, xi, pa, pb, eps)


def imcoh(sigs_a, sigs_b, bank, interpolate: bool = False,
          eps: float = 1e-12) -> torch.Tensor:
    """``imcoh_from_bank``: always the plain path; ``imcoh_auto`` takes the
    kernel."""
    return imcoh_from_bank(sigs_a, sigs_b, bank, interpolate, eps)


def imcoh_auto(sigs_a, sigs_b, bank, interpolate: bool = False,
               eps: float = 1e-12, precision: str = "fast3"):
    """Imaginary coherency with automatic kernel dispatch: the "coherence"
    epilogue's sums under ``epoch_coherence_auto``'s rule, the plain path
    otherwise."""
    from .fused import fused_imcoh, _kernel_takes
    if not bank.is_complex() and _kernel_takes(sigs_a, bank):
        return fused_imcoh(sigs_a, sigs_b, bank, interpolate=interpolate,
                           eps=eps, precision=precision)
    return imcoh(sigs_a, sigs_b, bank, interpolate, eps)


# -- phase slope index --------------------------------------------------------

def psi_from_sums(xr, xi, pa, pb, band=None, eps: float = 1e-12,
                  normalize: bool = True) -> torch.Tensor:
    """Phase slope index from the ``coherence_sums`` planes:
    ``PSI = sum_f Im(conj(C_f) C_{f+1})`` with ``C = S_ab / sqrt(S_aa S_bb)``
    over consecutive bank rows in ``band`` (a (lo, hi) row-index slice;
    default all rows).  Positive where channel a leads b.  With
    ``normalize`` the sum is scaled by ``sum_f |C_f| |C_{f+1}|`` into
    [-1, 1].  Returns the (..., N) time-resolved index."""
    den = torch.sqrt(pa * pb)
    if eps:
        den = torch.maximum(den, eps * den.max())
    cr, ci = xr / den, xi / den
    lo, hi = (0, cr.shape[-2]) if band is None else band
    cr, ci = cr[..., lo:hi, :], ci[..., lo:hi, :]
    a_r, a_i = cr[..., :-1, :], ci[..., :-1, :]
    b_r, b_i = cr[..., 1:, :], ci[..., 1:, :]
    psi_ = torch.sum(a_r * b_i - a_i * b_r, dim=-2)
    if not normalize:
        return psi_
    mag = torch.sum(torch.sqrt((a_r * a_r + a_i * a_i)
                               * (b_r * b_r + b_i * b_i)), dim=-2)
    if eps:
        mag = torch.clamp(mag, min=eps)
    return psi_ / mag


def psi_from_bank(sigs_a: torch.Tensor, sigs_b: torch.Tensor,
                  bank: torch.Tensor, band=None, interpolate: bool = False,
                  eps: float = 1e-12, normalize: bool = True) -> torch.Tensor:
    """Phase slope index (Nolte 2008): (E, ..., N) x2 -> (..., N), the
    slope of the cross-spectral phase across the ``band`` rows of a bank
    built on an ascending frequency grid."""
    xr, xi, pa, pb = coherence_sums(sigs_a, sigs_b, bank, interpolate)
    return psi_from_sums(xr, xi, pa, pb, band, eps, normalize)


def psi(sigs_a, sigs_b, bank, band=None, interpolate: bool = False,
        eps: float = 1e-12, normalize: bool = True) -> torch.Tensor:
    """``psi_from_bank`` with ``band`` taken as an integer (lo, hi) pair;
    the plain sums, as in the JAX package."""
    b = None if band is None else (int(band[0]), int(band[1]))
    return psi_from_bank(sigs_a, sigs_b, bank, b, interpolate, eps, normalize)
