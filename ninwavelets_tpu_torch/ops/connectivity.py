"""Cross-channel phase connectivity (port of the pair statistics and the
all-pairs matrices of ``ninwavelets_tpu.ops.connectivity``): PLV, PPC, the
phase-lag family (PLI, wPLI, debiased wPLI^2), and the (F, C, C) matrices
of PLV, PPC, coherence and phase lag that montage users consume.

The pair statistics are epoch reductions of elementwise images of the
cross-spectrum ``Wa conj(Wb)``; their plain sums loop over epochs, so
memory stays O(C*F*N).  The ``*_auto`` entry points take the cross-pair
kernel (``ops.fused``: "plv" at eps = 0, "phaselag" at any eps) for an
(E, C, N) pair batch that ``ops.fused.supports()`` takes, as the JAX
package does on a TPU; the single-pair (E, N) shape runs the plain sums.

The all-pairs matrices stream over the bank rows: one signal FFT up front,
one inverse FFT per row, and the pairwise epoch sums as one batched real
matrix product per row (``_pair_sums``), in true float32 (no TF32).  PAC,
n:m PLV, partial coherence, Kuramoto, ``psi_matrix`` and the surrogate
significance functions are not ported yet.
"""
from __future__ import annotations

import torch

from .cwt import analytic_spectrum
from .extensions import epoch_sums


# -- phase-locking value ------------------------------------------------------

def plv_sums(sigs_a, sigs_b, bank, interpolate: bool = False,
             eps: float = 0.0):
    """Epoch-SUMMED unit cross-phase planes ``(sum_r, sum_i)`` of
    ``X / |X|``, ``X = Wa conj(Wb)``: the plain version of the cross-pair
    kernel's "plv" epilogue.  A zero cross-spectrum gives 0/0 = NaN unless
    ``eps`` floors the magnitude."""
    def per_epoch(wa, wb):
        x = wa * torch.conj(wb)
        mag = torch.abs(x)
        if eps:
            mag = torch.clamp(mag, min=eps)
        return x.real / mag, x.imag / mag

    return epoch_sums(sigs_a, sigs_b, bank, interpolate, per_epoch)


def plv_from_bank(sigs_a: torch.Tensor, sigs_b: torch.Tensor,
                  bank: torch.Tensor, interpolate: bool = False,
                  eps: float = 0.0) -> torch.Tensor:
    """Phase-locking value ``| mean_E exp(i (phi_a - phi_b)) |`` between
    two channels over epochs: (E, ..., N) x2 -> (..., F, N) in [0, 1], the
    cross-channel analog of inter-trial coherence."""
    sr, si = plv_sums(sigs_a, sigs_b, bank, interpolate, eps)
    return torch.sqrt(sr * sr + si * si) / sigs_a.shape[0]


def plv(sigs_a, sigs_b, bank, interpolate: bool = False, eps: float = 0.0):
    """``plv_from_bank``: always the plain path; ``plv_auto`` takes the
    kernel."""
    return plv_from_bank(sigs_a, sigs_b, bank, interpolate, eps)


def plv_auto(sigs_a, sigs_b, bank, interpolate: bool = False,
             eps: float = 0.0, precision: str = "fast3"):
    """PLV with automatic kernel dispatch: the "plv" epilogue at eps = 0
    (the kernel has no floor) for a workload ``ops.fused.supports()``
    takes, the plain path otherwise."""
    if eps == 0.0:
        from .fused import fused_plv, _kernel_takes
        if _kernel_takes(sigs_a, bank):
            return fused_plv(sigs_a, sigs_b, bank, interpolate=interpolate,
                             precision=precision)
    return plv(sigs_a, sigs_b, bank, interpolate, eps)


# -- phase-lag family: PLI / wPLI / debiased wPLI^2, and PPC ------------------

PHASE_LAG_METHODS = ("pli", "wpli", "dwpli")


def _pinned_im(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``p - q`` with the cells whose two rounded products agree pinned to
    exact 0: there the true Im is below float32 resolution, and a self-pair
    or zero-lag cell then takes the documented 0/0 -> NaN path."""
    return torch.where(p == q, torch.zeros_like(p), p - q)


def _lag_terms(im: torch.Tensor):
    return im, torch.abs(im), torch.sign(im), im * im


def phase_lag_sums(sigs_a, sigs_b, bank, interpolate: bool = False):
    """Epoch-SUMMED phase-lag accumulators ``(sum Im, sum |Im|,
    sum sign(Im), sum Im^2)`` of the per-epoch ``Im(Wa conj(Wb))``, with
    ``p = Im Wa Re Wb`` and ``q = Re Wa Im Wb`` evaluated as separate
    tensors and pinned where they agree: the plain version of the
    cross-pair kernel's "phaselag" epilogue."""
    def per_epoch(wa, wb):
        return _lag_terms(_pinned_im(wa.imag * wb.real, wa.real * wb.imag))

    return epoch_sums(sigs_a, sigs_b, bank, interpolate, per_epoch)


def phase_lag_from_sums(sums, n_epochs: int, method: str = "wpli",
                        eps: float = 0.0):
    """Finish a phase-lag statistic from the ``phase_lag_sums`` planes:
    "pli" ``|mean sign(Im)|`` (Stam 2007); "wpli" ``|sum Im| / sum |Im|``
    (Vinck 2011); "dwpli" ``((sum Im)^2 - sum Im^2) / ((sum |Im|)^2 -
    sum Im^2)``, debiased wPLI^2, which may go slightly negative under the
    null and needs 2 epochs.  At ``eps = 0`` a cell whose cross-spectrum is
    real in every epoch (a channel against itself) gives NaN for wpli and
    dwpli; a positive ``eps`` floors the denominator."""
    s_im, s_abs, s_sgn, s_sq = sums
    if method == "pli":
        return torch.abs(s_sgn) / n_epochs
    if method == "wpli":
        den = torch.clamp(s_abs, min=eps) if eps else s_abs
        return torch.abs(s_im) / den
    if method == "dwpli":
        den = s_abs * s_abs - s_sq
        if eps:
            den = torch.clamp(den, min=eps)
        return (s_im * s_im - s_sq) / den
    raise ValueError(f"method must be one of {PHASE_LAG_METHODS}, "
                     f"got {method!r}")


def phase_lag_from_bank(sigs_a: torch.Tensor, sigs_b: torch.Tensor,
                        bank: torch.Tensor, method: str = "wpli",
                        interpolate: bool = False,
                        eps: float = 0.0) -> torch.Tensor:
    """Phase-lag connectivity between two channels over epochs:
    (E, ..., N) x2 -> (..., F, N); see ``phase_lag_from_sums``."""
    sums = phase_lag_sums(sigs_a, sigs_b, bank, interpolate)
    return phase_lag_from_sums(sums, sigs_a.shape[0], method, eps)


def phase_lag(sigs_a, sigs_b, bank, method: str = "wpli",
              interpolate: bool = False, eps: float = 0.0):
    """``phase_lag_from_bank``: always the plain path; ``phase_lag_auto``
    takes the kernel."""
    return phase_lag_from_bank(sigs_a, sigs_b, bank, method, interpolate, eps)


def phase_lag_auto(sigs_a, sigs_b, bank, method: str = "wpli",
                   interpolate: bool = False, eps: float = 0.0,
                   precision: str = "fast3"):
    """Phase-lag statistic with automatic kernel dispatch: the "phaselag"
    epilogue (at any eps: eps acts in the finisher) for a workload
    ``ops.fused.supports()`` takes, the plain path otherwise."""
    from .fused import fused_phase_lag, _kernel_takes
    if _kernel_takes(sigs_a, bank):
        return fused_phase_lag(sigs_a, sigs_b, bank, method=method,
                               interpolate=interpolate, eps=eps,
                               precision=precision)
    return phase_lag(sigs_a, sigs_b, bank, method, interpolate, eps)


def ppc_from_bank(sigs_a: torch.Tensor, sigs_b: torch.Tensor,
                  bank: torch.Tensor, interpolate: bool = False,
                  eps: float = 0.0) -> torch.Tensor:
    """Pairwise phase consistency (Vinck 2010),
    ``(|sum_E u|^2 - E) / (E (E - 1))`` with ``u`` the unit cross-phase:
    the bias-free counterpart of PLV^2, off the same sums.  Needs 2
    epochs."""
    sr, si = plv_sums(sigs_a, sigs_b, bank, interpolate, eps)
    e = sigs_a.shape[0]
    return (sr * sr + si * si - e) / (e * (e - 1.0))


def ppc(sigs_a, sigs_b, bank, interpolate: bool = False, eps: float = 0.0):
    """``ppc_from_bank``: always the plain path; ``ppc_auto`` takes the
    kernel."""
    return ppc_from_bank(sigs_a, sigs_b, bank, interpolate, eps)


def ppc_auto(sigs_a, sigs_b, bank, interpolate: bool = False,
             eps: float = 0.0, precision: str = "fast3"):
    """PPC with automatic kernel dispatch: the "plv" epilogue's sums under
    ``plv_auto``'s rule, the plain path otherwise."""
    if eps == 0.0:
        from .fused import fused_ppc, _kernel_takes
        if _kernel_takes(sigs_a, bank):
            return fused_ppc(sigs_a, sigs_b, bank, interpolate=interpolate,
                             precision=precision)
    return ppc(sigs_a, sigs_b, bank, interpolate, eps)


# -- all-pairs connectivity matrices ------------------------------------------

def _pair_sums(w: torch.Tensor):
    """Pairwise epoch sums ``S[a, b, n] = sum_e w[e, a, n] conj(w[e, b, n])``
    as a (real, imag) pair of (C, C, n) planes: two real batched matrix
    products over the stacked epoch axis, ``S_r = u . u`` and
    ``S_i = [wi; -wr] . u`` with ``u = [wr; wi]``, the time axis the batch.
    Float32 products run in full float32 (no TF32 on the card, whatever the
    process's matmul precision; it is restored on exit)."""
    from .scattering import fp32_matmul    # scattering imports ops.fused
    u = torch.cat([w.real, w.imag], dim=0)                  # (2E, C, n)
    v = torch.cat([w.imag, -w.real], dim=0)
    ut = u.permute(2, 0, 1)                                  # (n, 2E, C)
    with fp32_matmul("exact"):
        sr = torch.bmm(ut.transpose(1, 2), ut).permute(1, 2, 0)
        si = torch.bmm(v.permute(2, 1, 0), ut).permute(1, 2, 0)
    return sr, si


def pair_matrix_scan(sigs: torch.Tensor, bank: torch.Tensor, per_row,
                     interpolate: bool = False, unit: bool = False,
                     eps: float = 0.0, time_range=None) -> torch.Tensor:
    """Stream an all-pairs statistic over the bank rows: per row, the
    inverse FFT of the (E, C, N) coefficient slab (the signal spectrum is
    computed once), optionally unit-normalised (``eps`` floors the
    magnitude; 0 keeps 0/0 -> NaN), the ``time_range`` (start, stop) sample
    window, the pairwise epoch sums, and ``per_row(sr, si) -> (C, C)``.
    Memory is O(E*C*N + C*C*n); returns the (F, C, C) stack."""
    spec = analytic_spectrum(sigs, interpolate)
    n0, n1 = time_range if time_range is not None else (0, sigs.shape[-1])
    rows = []
    for bank_row in bank:
        w = torch.fft.ifft(spec * bank_row)
        if unit:
            mag = torch.abs(w)
            if eps:
                mag = torch.clamp(mag, min=eps)
            w = w / mag
        rows.append(per_row(*_pair_sums(w[..., n0:n1])))
    return torch.stack(rows)


def plv_matrix_from_bank(sigs: torch.Tensor, bank: torch.Tensor,
                         interpolate: bool = False, eps: float = 0.0,
                         time_range=None) -> torch.Tensor:
    """All-pairs phase-locking matrix: (E, C, N) -> (F, C, C),
    ``mean_t | mean_E exp(i (phi_a - phi_b)) |`` over ``time_range``.
    Symmetric with unit diagonal."""
    e = sigs.shape[0]

    def per_row(sr, si):
        return torch.mean(torch.sqrt(sr * sr + si * si), dim=-1) / e

    return pair_matrix_scan(sigs, bank, per_row, interpolate, unit=True,
                            eps=eps, time_range=time_range)


def coherence_matrix_from_bank(sigs: torch.Tensor, bank: torch.Tensor,
                               interpolate: bool = False,
                               eps: float = 1e-12,
                               time_range=None) -> torch.Tensor:
    """All-pairs epoch-wise wavelet coherence: (E, C, N) -> (F, C, C),
    time-averaged; the per-channel power sums are the diagonal of the
    pairwise sums.  ``eps`` is the relative floor of
    ``extensions.coherence_from_sums``."""
    e = sigs.shape[0]

    def per_row(sr, si):
        num = (sr * sr + si * si) / (e * e)
        p = torch.diagonal(sr, dim1=0, dim2=1).T / e         # (C, n)
        den = p[:, None, :] * p[None, :, :]
        if eps:
            den = torch.maximum(den, eps * den.max())
        return torch.mean(num / den, dim=-1)

    return pair_matrix_scan(sigs, bank, per_row, interpolate,
                            time_range=time_range)


def ppc_matrix_from_bank(sigs: torch.Tensor, bank: torch.Tensor,
                         interpolate: bool = False, eps: float = 0.0,
                         time_range=None) -> torch.Tensor:
    """All-pairs pairwise phase consistency: (E, C, N) -> (F, C, C), off
    the unit-phase pairwise sums of ``plv_matrix_from_bank``.  Diagonal 1;
    needs 2 epochs."""
    e = sigs.shape[0]

    def per_row(sr, si):
        return torch.mean((sr * sr + si * si - e) / (e * (e - 1.0)), dim=-1)

    return pair_matrix_scan(sigs, bank, per_row, interpolate, unit=True,
                            eps=eps, time_range=time_range)


def wpli_matrix_from_bank(sigs: torch.Tensor, bank: torch.Tensor,
                          method: str = "wpli",
                          interpolate: bool = False, eps: float = 0.0,
                          time_range=None) -> torch.Tensor:
    """All-pairs phase-lag connectivity: (E, C, N) -> (F, C, C), any
    ``PHASE_LAG_METHODS`` estimator, finished per (channel, channel, time)
    cell and then time-averaged.  The epoch axis cannot be a matrix
    product (|Im S_e| is needed per epoch), so each row accumulates the
    four ``phase_lag_sums`` planes over epochs as (C, C, n) outer products,
    pinned like ``phase_lag_sums``: the diagonal is 0/0 -> NaN at
    ``eps = 0``.  A ``time_range`` (start, stop) outside 0 <= start <= stop
    <= N raises ``ValueError``."""
    if method not in PHASE_LAG_METHODS:
        raise ValueError(f"method must be one of {PHASE_LAG_METHODS}, "
                         f"got {method!r}")
    e, n = sigs.shape[0], sigs.shape[-1]
    n0, n1 = time_range if time_range is not None else (0, n)
    if not 0 <= n0 <= n1 <= n:
        # The reference's (C, C, n1 - n0) epoch sums cannot take a window
        # that leaves the signal either.
        raise ValueError(f"time_range {(n0, n1)} is not a window of the "
                         f"{n} samples")
    spec = analytic_spectrum(sigs, interpolate)
    rows = []
    for bank_row in bank:
        w = torch.fft.ifft(spec * bank_row)[..., n0:n1]      # (E, C, n)
        sums = None
        for r, i in zip(w.real, w.imag):
            p = i[:, None, :] * r[None, :, :]
            terms = _lag_terms(_pinned_im(p, p.transpose(0, 1)))
            sums = (list(terms) if sums is None
                    else [s + t for s, t in zip(sums, terms)])
        rows.append(torch.mean(phase_lag_from_sums(sums, e, method, eps),
                               dim=-1))
    return torch.stack(rows)


def _samples(time_range):
    return None if time_range is None else (int(time_range[0]),
                                            int(time_range[1]))


def wpli_matrix(sigs, bank, method: str = "wpli", interpolate: bool = False,
                eps: float = 0.0, time_range=None):
    """``wpli_matrix_from_bank`` with ``time_range`` taken as an integer
    (start, stop) sample pair (real analytic banks: the lag sign needs the
    analytic signal)."""
    return wpli_matrix_from_bank(sigs, bank, method, interpolate, eps,
                                 _samples(time_range))


def ppc_matrix(sigs, bank, interpolate: bool = False, eps: float = 0.0,
               time_range=None):
    """``ppc_matrix_from_bank`` with an integer ``time_range``."""
    return ppc_matrix_from_bank(sigs, bank, interpolate, eps,
                                _samples(time_range))


def plv_matrix(sigs, bank, interpolate: bool = False, eps: float = 0.0,
               time_range=None):
    """``plv_matrix_from_bank`` with an integer ``time_range`` (real
    analytic banks: phase needs the analytic signal)."""
    return plv_matrix_from_bank(sigs, bank, interpolate, eps,
                                _samples(time_range))


def coherence_matrix(sigs, bank, interpolate: bool = False,
                     eps: float = 1e-12, time_range=None):
    """``coherence_matrix_from_bank`` (real or complex banks) with an
    integer ``time_range``."""
    return coherence_matrix_from_bank(sigs, bank, interpolate, eps,
                                      _samples(time_range))
