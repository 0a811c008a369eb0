"""Cross-channel phase connectivity (port of the pair statistics and the
all-pairs matrices of ``ninwavelets_tpu.ops.connectivity``): PLV, PPC, the
phase-lag family (PLI, wPLI, debiased wPLI^2), and the (F, C, C) matrices
of PLV, PPC, coherence and phase lag that montage users consume.

The pair statistics are epoch reductions of elementwise images of the
cross-spectrum ``Wa conj(Wb)``; their plain sums run over chunks of
epochs (``extensions.epoch_sums``), so memory stays bounded.  The
``*_auto`` entry points take the cross-pair kernel (``ops.fused``: "plv"
at eps = 0, "phaselag" at any eps) for an (E, C, N) pair batch that
``ops.fused.route()`` takes, as the JAX package does on a TPU; the
single-pair (E, N) shape runs the plain sums.

The all-pairs matrices stream over the bank rows: one signal FFT up front,
one inverse FFT per row, and the pairwise epoch sums as one batched real
matrix product per row (``_pair_sums``), in true float32 (no TF32).

The rest is plain torch, every product in full float32: n:m PLV, the
circular-shift surrogate p-values (a ``torch.Generator`` draws the (S, E)
shift table; ``surrogate_pvalues_from_shifts`` counts), PAC and ERPAC, the
Kuramoto order, partial coherence (a real block solve per bank row), the
jackknifed phase-slope-index matrix and lagged coherence.
"""
from __future__ import annotations

import logging
import math
from functools import lru_cache

import numpy as np
import torch

from ..device import as_float32
from ..utils.observability import span
from .bank import WaveletDef, WaveletMode, make_fft_bank
from .cwt import analytic_spectrum, cwt_from_bank
from .extensions import chunk_size, epoch_sums
from .spectra import morse_spectrum

log = logging.getLogger(__name__)


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
    (the kernel has no floor) for a workload ``ops.fused.route()`` takes,
    the plain path otherwise, inside the span it names."""
    from .fused import fused_plv, route
    r = route("plv", sigs_a, bank, eps=eps)
    with span(r.span):
        if r.takes:
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
    ``ops.fused.route()`` takes, the plain path otherwise, inside the span
    it names."""
    from .fused import fused_phase_lag, route
    r = route("phaselag", sigs_a, bank)
    with span(r.span):
        if r.takes:
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
    from .fused import fused_ppc, route
    r = route("plv", sigs_a, bank, eps=eps)
    with span(r.span):
        if r.takes:
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


# -- n:m cross-frequency phase locking ----------------------------------------

def nm_plv_sums(sigs_a, sigs_b, bank_a, bank_b, n: int = 1, m: int = 1,
                interpolate: bool = False, eps: float = 0.0):
    """Epoch-SUMMED ``exp(i (n phi_a - m phi_b))`` planes ``(sum_r, sum_i)``
    over chunks of epochs (``extensions.epoch_sums``); ``exp(i n phi)`` is
    the unit coefficient raised to the n-th power by repeated
    multiplication."""
    if n < 1 or m < 1:
        raise ValueError("n and m must be positive integers")

    def unit_pow(w, k):
        mag = torch.abs(w)
        if eps:
            mag = torch.clamp(mag, min=eps)
        u = w / mag
        out = u
        for _ in range(int(k) - 1):
            out = out * u
        return out

    def per_epoch(wa, wb):
        z = unit_pow(wa, n) * torch.conj(unit_pow(wb, m))
        return z.real, z.imag

    return epoch_sums(sigs_a, sigs_b, bank_a, interpolate, per_epoch,
                      bank_b)


def nm_plv_from_bank(sigs_a: torch.Tensor, sigs_b: torch.Tensor,
                     bank_a: torch.Tensor, bank_b: torch.Tensor,
                     n: int = 1, m: int = 1, interpolate: bool = False,
                     eps: float = 0.0) -> torch.Tensor:
    """n:m cross-frequency phase-locking value (Tass 1998),
    ``| mean_E exp(i (n phi_a - m phi_b)) |``: (E, ..., N) x2 -> (..., F, N)
    in [0, 1].  Row k of ``bank_a`` pairs with row k of ``bank_b``; build
    ``bank_b`` at ``n / m`` times the ``bank_a`` frequencies.  At
    ``n = m = 1`` this is ``plv_from_bank``."""
    sr, si = nm_plv_sums(sigs_a, sigs_b, bank_a, bank_b, n, m, interpolate,
                         eps)
    return torch.sqrt(sr * sr + si * si) / sigs_a.shape[0]


def nm_plv(sigs_a, sigs_b, bank_a, bank_b, n: int = 1, m: int = 1,
           interpolate: bool = False, eps: float = 0.0) -> torch.Tensor:
    """``nm_plv_from_bank`` (real analytic banks: phase needs the analytic
    signal)."""
    return nm_plv_from_bank(sigs_a, sigs_b, bank_a, bank_b, int(n), int(m),
                            interpolate, float(eps))


# -- surrogate significance ---------------------------------------------------

def _min_shift(nt: int, min_shift) -> int:
    lo = nt // 8 if min_shift is None else int(min_shift)
    if not 0 < lo < nt - lo:
        raise ValueError(f"min_shift {lo} leaves no admissible offsets")
    return lo


def surrogate_shifts(n_samples: int, n_epochs: int, generator,
                     n_surrogates: int = 199, min_shift=None
                     ) -> torch.Tensor:
    """The (S, E) table of circular offsets, one per surrogate and epoch,
    uniform on ``[min_shift, N - min_shift)`` (default ``min_shift = N //
    8``), drawn with ``torch.randint`` from ``generator`` on its device."""
    lo = _min_shift(int(n_samples), min_shift)
    return torch.randint(lo, int(n_samples) - lo,
                         (int(n_surrogates), int(n_epochs)),
                         generator=generator, device=generator.device)


def roll_epochs(sigs: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """Each epoch of (E, ..., N) ``sigs`` rolled by its own ``shifts[e]``
    (``jnp.roll`` semantics: ``out[n] = x[(n - shift) % N]``), as one
    gather."""
    n = sigs.shape[-1]
    idx = (torch.arange(n, device=sigs.device)
           - shifts.to(sigs.device)[:, None]) % n               # (E, N)
    idx = idx.reshape(idx.shape[0], *([1] * (sigs.ndim - 2)), n)
    return torch.gather(sigs, -1, idx.expand(sigs.shape))


def surrogate_pvalues_from_shifts(stat_fn, observed: torch.Tensor,
                                  sigs_b: torch.Tensor,
                                  shifts: torch.Tensor) -> torch.Tensor:
    """Right-tail p-values ``(1 + #{stat_fn(rolled b) >= observed}) /
    (S + 1)`` over the S rows of the (S, E) ``shifts`` table: each
    surrogate rolls every epoch of ``sigs_b`` by its own offset, which
    keeps each signal's spectrum and waveform and destroys the alignment
    with channel a.  The smallest p is ``1 / (S + 1)``."""
    cnt = torch.zeros_like(observed)
    for row in shifts:
        cnt += (stat_fn(roll_epochs(sigs_b, row)) >= observed).to(cnt.dtype)
    return (cnt + 1.0) / (float(shifts.shape[0]) + 1.0)


def surrogate_pvalues(stat_fn, observed: torch.Tensor, sigs_b: torch.Tensor,
                      generator, n_surrogates: int = 199,
                      min_shift=None) -> torch.Tensor:
    """Circular-shift surrogate p-values of ``observed``: the shift table
    of ``surrogate_shifts`` drawn from the ``torch.Generator``
    ``generator`` (in place of the JAX package's PRNG key), counted by
    ``surrogate_pvalues_from_shifts``.  ``min_shift`` (default N // 8)
    keeps surrogates away from zero lag."""
    shifts = surrogate_shifts(sigs_b.shape[-1], sigs_b.shape[0], generator,
                              n_surrogates, min_shift)
    return surrogate_pvalues_from_shifts(stat_fn, observed, sigs_b, shifts)


def _with_pvalues(stat, sigs_b, n_surrogates, min_shift, seed):
    """``(stat(sigs_b), p)``: the observed plane and its surrogate p-values,
    the shifts drawn by a ``torch.Generator`` seeded with ``seed`` on the
    data's device (other draws than the JAX package's for the same
    seed)."""
    obs = stat(sigs_b)
    g = torch.Generator(device=sigs_b.device).manual_seed(int(seed))
    return obs, surrogate_pvalues(stat, obs, sigs_b, g, n_surrogates,
                                  min_shift)


def plv_significance(sigs_a, sigs_b, bank, interpolate: bool = False,
                     eps: float = 0.0, n_surrogates: int = 199,
                     min_shift=None, seed: int = 0):
    """PLV and its circular-shift surrogate p-values: ``((..., F, N) plv,
    same-shape p)``.  Cost is ``n_surrogates + 1`` PLV passes; the
    surrogates as in ``_with_pvalues``."""
    def stat(b):
        return plv_from_bank(sigs_a, b, bank, interpolate, eps)

    return _with_pvalues(stat, sigs_b, n_surrogates, min_shift, seed)


def phase_lag_significance(sigs_a, sigs_b, bank, method: str = "wpli",
                           interpolate: bool = False, eps: float = 0.0,
                           n_surrogates: int = 199, min_shift=None,
                           seed: int = 0):
    """A ``PHASE_LAG_METHODS`` statistic and its circular-shift surrogate
    p-values, under ``plv_significance``'s conventions."""
    if method not in PHASE_LAG_METHODS:
        raise ValueError(f"method must be one of {PHASE_LAG_METHODS}, "
                         f"got {method!r}")

    def stat(b):
        return phase_lag_from_bank(sigs_a, b, bank, method, interpolate, eps)

    return _with_pvalues(stat, sigs_b, n_surrogates, min_shift, seed)


# -- phase-amplitude coupling -------------------------------------------------

PAC_METHODS = ("mvl", "tort")


def _phase_amp(sig, bank_phase, bank_amp, interpolate, eps):
    """Unit phase vectors (complex, (..., Fp, N)) of the low band and
    amplitudes ((..., Fa, N)) of the high band."""
    wp = cwt_from_bank(sig, bank_phase, interpolate)
    wa = cwt_from_bank(sig, bank_amp, interpolate)
    return wp / torch.clamp(torch.abs(wp), min=eps), torch.abs(wa)


def _pac_score(u, a, n, method, n_bins, eps):
    """(..., Fp, Fa) comodulogram from unit phases and amplitudes: "mvl"
    ``|sum_t A u| / sqrt(N sum_t A^2)``; "tort" the KL divergence of the
    mean amplitude per phase bin from uniform over ``log(n_bins)``.  Both
    collapse time with a full-float32 matrix product."""
    from .scattering import fp32_matmul    # scattering imports ops.fused
    at = a.transpose(-1, -2)
    if method == "mvl":
        with fp32_matmul("exact"):
            mr = torch.matmul(u.real, at)
            mi = torch.matmul(u.imag, at)
        denom = torch.sqrt(n * torch.sum(a * a, dim=-1))
        return torch.sqrt(mr * mr + mi * mi) / torch.clamp(
            denom[..., None, :], min=eps)
    if method != "tort":
        raise ValueError("method must be 'mvl' or 'tort'")
    phase = torch.atan2(u.imag, u.real)
    idx = torch.clamp(((phase + math.pi) * (n_bins / (2.0 * math.pi)))
                      .to(torch.int32), 0, n_bins - 1)
    bins = torch.arange(n_bins, dtype=torch.int32, device=u.device)
    onehot = (idx[..., None, :] == bins[:, None]).to(torch.float32)
    counts = onehot.sum(-1)                                  # (..., Fp, B)
    with fp32_matmul("exact"):
        sums = torch.matmul(onehot, at[..., None, :, :])     # (..., Fp, B, Fa)
    mean_amp = sums / torch.clamp(counts, min=1.0)[..., None]
    p = mean_amp / torch.clamp(mean_amp.sum(-2, keepdim=True), min=eps)
    plogp = torch.where(p > 0, p * torch.log(p), torch.zeros_like(p))
    kl = math.log(float(n_bins)) + plogp.sum(-2)
    return kl / math.log(float(n_bins))


def pac_pair_from_banks(sig_phase: torch.Tensor, sig_amp: torch.Tensor,
                        bank_phase: torch.Tensor, bank_amp: torch.Tensor,
                        interpolate: bool = False, method: str = "mvl",
                        n_bins: int = 18, eps: float = 1e-20):
    """``pac_from_banks`` with the phase and the amplitude from two signals:
    the cross-channel comodulogram and the surrogate null's building
    block."""
    wp = cwt_from_bank(sig_phase, bank_phase, interpolate)
    u = wp / torch.clamp(torch.abs(wp), min=eps)
    a = torch.abs(cwt_from_bank(sig_amp, bank_amp, interpolate))
    return _pac_score(u, a, sig_phase.shape[-1], method, n_bins, eps)


def pac_from_banks(signal: torch.Tensor, bank_phase: torch.Tensor,
                   bank_amp: torch.Tensor, interpolate: bool = False,
                   method: str = "mvl", n_bins: int = 18,
                   eps: float = 1e-20):
    """Phase-amplitude coupling comodulogram: (..., N) -> (..., F_phase,
    F_amp), "mvl" (Canolty 2006 / Ozkurt 2010, in [0, 1]) or "tort" (Tort
    2010 modulation index over ``n_bins`` phase bins, in [0, 1]); leading
    axes are a batch."""
    return pac_pair_from_banks(signal, signal, bank_phase, bank_amp,
                               interpolate, method, n_bins, eps)


def pac_mean_from_banks(sig, bank_phase, bank_amp, interpolate, method,
                        n_bins):
    """Epoch-mean comodulogram of (E, ..., N) ``sig``: ``pac_pair_mean``
    with both signals ``sig``."""
    return pac_pair_mean(sig, sig, bank_phase, bank_amp, interpolate,
                         method, n_bins)


def pac_pair_mean(sig_p, sig_a, bank_phase, bank_amp, interpolate, method,
                  n_bins):
    """Epoch-mean cross-signal comodulogram, over chunks of epochs (up to
    ``extensions.CHUNK_ELEMS`` of the largest per-epoch intermediate: the
    one-hot bins for "tort")."""
    step = chunk_size(math.prod(sig_p.shape[1:-1]) * sig_p.shape[-1] * (
        bank_phase.shape[0] * (n_bins if method == "tort" else 1)
        + bank_amp.shape[0]))
    total = sum(pac_pair_from_banks(sp, sa, bank_phase, bank_amp,
                                    interpolate, method, n_bins).sum(0)
                for sp, sa in zip(torch.split(sig_p, step),
                                  torch.split(sig_a, step)))
    return total / sig_p.shape[0]


def pac_pair(sig_phase, sig_amp, bank_phase, bank_amp, *,
             interpolate: bool = False, method: str = "mvl",
             n_bins: int = 18):
    """Epoch-mean CROSS-SIGNAL comodulogram: phase from the first (E, N)
    batch, amplitude from the second."""
    return pac_pair_mean(sig_phase, sig_amp, bank_phase, bank_amp,
                         bool(interpolate), str(method), int(n_bins))


def pac(signal, bank_phase, bank_amp, interpolate: bool = False,
        method: str = "mvl", n_bins: int = 18, mean_epochs: bool = False):
    """``pac_from_banks``; with ``mean_epochs`` the leading axis is an epoch
    axis and the per-epoch comodulograms are averaged."""
    if not mean_epochs:
        return pac_from_banks(signal, bank_phase, bank_amp, interpolate,
                              method, n_bins)
    return pac_mean_from_banks(signal, bank_phase, bank_amp, interpolate,
                               method, n_bins)


def _min_phase_cycles(bank_phase: torch.Tensor) -> int:
    """Minimum peak FFT bin (the cycles in the window) over the phase
    bank's rows, reduced on the bank's device; one host read."""
    return int(torch.abs(bank_phase).argmax(-1).min().item())


def pac_significance(signal, bank_phase, bank_amp,
                     interpolate: bool = False, method: str = "mvl",
                     n_bins: int = 18, n_surrogates: int = 199,
                     min_shift=None, seed: int = 0):
    """Epoch-mean comodulogram of (E, N) ``signal`` and its circular-shift
    surrogate p-values ``((Fp, Fa) pac, same-shape p)``: each surrogate
    rolls every epoch's amplitude copy while the phase copy stays (Tort
    2010).  The shift null is anticonservative with few phase cycles per
    window: below 8 cycles of the slowest phase row a warning is logged.
    Surrogates as in ``plv_significance``."""
    sig = signal if signal.ndim > 1 else signal[None]
    min_cycles = _min_phase_cycles(bank_phase)
    if min_cycles < 8:
        log.warning(
            "pac_significance: slowest phase band has only %d cycles "
            "in the window; the circular-shift null is "
            "anticonservative below ~8 cycles; lengthen the analysis "
            "window", min_cycles)

    def stat(shifted):
        return pac_pair_mean(sig, shifted, bank_phase, bank_amp,
                             interpolate, method, n_bins)

    return _with_pvalues(stat, sig, n_surrogates, min_shift, seed)


def erpac_from_banks(sigs: torch.Tensor, bank_phase: torch.Tensor,
                     bank_amp: torch.Tensor, interpolate: bool = False,
                     eps: float = 1e-20) -> torch.Tensor:
    """Event-related PAC (Voytek et al. 2013): (E, N) -> (Fp, Fa, N), the
    circular-linear correlation across trials between the low-band phase
    and the high-band amplitude at every time point,
    ``sqrt((r_ca^2 + r_sa^2 - 2 r_ca r_sa r_cs) / (1 - r_cs^2))``; the two
    trial contractions are full-float32 products batched over time."""
    from .scattering import fp32_matmul    # scattering imports ops.fused
    u, a = _phase_amp(sigs, bank_phase, bank_amp, interpolate, eps)

    def center(x):
        return x - x.mean(0, keepdim=True)

    def norm(x):
        return torch.sqrt(torch.clamp((x * x).sum(0), min=eps))

    cc, ss, aa = center(u.real), center(u.imag), center(a)
    nc, ns, na = norm(cc), norm(ss), norm(aa)
    with fp32_matmul("exact"):
        r_ca = torch.einsum("eft,egt->fgt", cc, aa) / (nc[:, None] * na[None])
        r_sa = torch.einsum("eft,egt->fgt", ss, aa) / (ns[:, None] * na[None])
    r_cs = ((cc * ss).sum(0) / (nc * ns))[:, None, :]
    num = r_ca ** 2 + r_sa ** 2 - 2.0 * r_ca * r_sa * r_cs
    den = torch.clamp(1.0 - r_cs ** 2, min=eps)
    return torch.sqrt(torch.clamp(num / den, 0.0, 1.0))


def erpac(sigs_r, bank_phase, bank_amp, interpolate: bool = False,
          eps: float = 1e-20, device=None) -> torch.Tensor:
    """``erpac_from_banks`` of an (epochs, N) trial stack (a tensor stays on
    its device; other input goes to ``device``, the card when None)."""
    sigs = as_float32(sigs_r, device)
    if sigs.ndim != 2:
        raise ValueError("erpac needs an (epochs, N) trial stack (the "
                         "correlation runs ACROSS trials), got %s"
                         % (tuple(sigs.shape),))
    return erpac_from_banks(sigs, as_float32(bank_phase, sigs.device),
                            as_float32(bank_amp, sigs.device),
                            bool(interpolate), float(eps))


# -- Kuramoto order parameter -------------------------------------------------

def kuramoto_order_from_bank(sigs: torch.Tensor, bank: torch.Tensor,
                             interpolate: bool = False, eps: float = 1e-12,
                             mean_epochs: bool = True) -> torch.Tensor:
    """Global phase synchrony across channels, ``R(f, t) = |mean_c exp(i
    phi_c)|``: (E, C, N) -> (F, N), or (E, F, N) with ``mean_epochs=False``.
    1 when every channel shares the phase, ~1/sqrt(C) under
    independence.  One inverse FFT per bank row."""
    spec = analytic_spectrum(sigs, interpolate)
    rows = []
    for bank_row in bank:
        w = torch.fft.ifft(spec * bank_row)
        u = w / torch.clamp(torch.abs(w), min=eps)
        r = torch.abs(u.mean(-2))                            # (E, N)
        rows.append(r.mean(0) if mean_epochs else r)
    out = torch.stack(rows)
    return out if mean_epochs else out.transpose(0, 1)


def kuramoto_order(sigs, bank, interpolate: bool = False,
                   eps: float = 1e-12, mean_epochs: bool = True):
    """``kuramoto_order_from_bank`` (real analytic banks)."""
    return kuramoto_order_from_bank(sigs, bank, interpolate, float(eps),
                                    bool(mean_epochs))


# -- partial coherence --------------------------------------------------------

def _solve_ex(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a^{-1} b`` for (..., C, C) and (..., C, k), batch dims broadcast,
    through ``torch.linalg.solve_ex`` without error checks: a singular
    system gives non-finite values (``jnp.linalg.solve``'s result) instead
    of an exception, and the card is not synced to check."""
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    return torch.linalg.solve_ex(a.expand(*batch, *a.shape[-2:]),
                                 b.expand(*batch, *b.shape[-2:]),
                                 check_errors=False)[0]


def _solve_complex(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a^{-1} b`` for complex (..., C, C) through the real (2C, 2C) block
    embedding ``[[Re, -Im], [Im, Re]]``, in full float32 (the JAX
    package's form, shared with ``ops.granger``); ``_solve_ex``'s rules."""
    from .scattering import fp32_matmul    # scattering imports ops.fused
    ar, ai = a.real, a.imag
    big_a = torch.cat([torch.cat([ar, -ai], -1), torch.cat([ai, ar], -1)],
                      -2)
    big_b = torch.cat([b.real, b.imag], -2)
    with fp32_matmul("exact"):
        x = _solve_ex(big_a, big_b)
    c = a.shape[-1]
    return torch.complex(x[..., :c, :], x[..., c:, :])


def partial_coherence_per_row(sr, si, e: int, lam: float):
    """(C, C) magnitude-squared partial coherence from one bank row's
    pairwise epoch sums: ``|S^-1_ij|^2 / (S^-1_ii S^-1_jj)`` of the epoch-
    and time-mean cross-spectral matrix, its diagonal raised by ``lam``
    times its mean (a relative Tikhonov floor)."""
    c = sr.shape[0]
    s = torch.complex(sr.mean(-1), si.mean(-1)) / e
    tr = torch.diagonal(s).real.sum() / c
    eye = torch.eye(c, dtype=s.dtype, device=s.device)
    s = s + lam * torch.clamp(tr, min=1e-30) * eye
    sinv = _solve_complex(s, eye)
    d = torch.clamp(torch.diagonal(sinv).real, min=1e-30)
    num = sinv.real ** 2 + sinv.imag ** 2
    return num / (d[:, None] * d[None, :])


def partial_coherence_from_bank(sigs: torch.Tensor, bank: torch.Tensor,
                                interpolate: bool = False,
                                lam: float = 1e-5,
                                time_range=None) -> torch.Tensor:
    """All-pairs partial coherence: (E, C, N) -> (F, C, C), each pair
    conditioned on every other channel through the inverse of the
    cross-spectral matrix per bank row; purely mediated coupling drops to
    ~0.  Symmetric, diagonal 1.  Needs E * n_time >= C for a
    well-conditioned inverse (``lam`` floors the rest)."""
    if sigs.shape[1] < 2:
        raise ValueError("partial coherence needs at least 2 channels")
    e = sigs.shape[0]

    def per_row(sr, si):
        return partial_coherence_per_row(sr, si, e, lam)

    return pair_matrix_scan(sigs, bank, per_row, interpolate,
                            time_range=time_range)


def partial_coherence(sigs, bank, interpolate: bool = False,
                      lam: float = 1e-5, time_range=None):
    """``partial_coherence_from_bank`` with an integer ``time_range``."""
    return partial_coherence_from_bank(sigs, bank, interpolate, float(lam),
                                       _samples(time_range))


# -- phase slope index matrix -------------------------------------------------

def _psi_row_creps(spec, bank_row, n0, n1, e, eps, complete=None):
    """Coherency replicates of one bank row: the leave-one-epoch-out
    estimates of the locally held epochs and the full-sample estimate
    last, as a (real, imag) pair of (E_local + 1, C, C) stacks.  ``e`` is
    the global epoch count; ``complete`` finishes the total sums across
    devices (identity when None).  The per-epoch time sums are four
    full-float32 batched products: the replicates differ from the total by
    O(1/E), which TF32 round-off would swamp."""
    from .scattering import fp32_matmul    # scattering imports ops.fused
    w = torch.fft.ifft(spec * bank_row)[..., n0:n1]          # (E, C, n)
    wr, wi = w.real, w.imag
    with fp32_matmul("exact"):
        sr = (torch.einsum("ean,ebn->eab", wr, wr)
              + torch.einsum("ean,ebn->eab", wi, wi))
        si = (torch.einsum("ean,ebn->eab", wi, wr)
              - torch.einsum("ean,ebn->eab", wr, wi))
    tot_r, tot_i = sr.sum(0), si.sum(0)
    if complete is not None:
        tot_r, tot_i = complete(tot_r), complete(tot_i)
    rep_r = torch.cat([(tot_r[None] - sr) / (e - 1.0), tot_r[None] / e])
    rep_i = torch.cat([(tot_i[None] - si) / (e - 1.0), tot_i[None] / e])
    p = torch.diagonal(rep_r, dim1=1, dim2=2)                # (E+1, C)
    den = torch.sqrt(torch.clamp(p[:, :, None] * p[:, None, :], min=0.0))
    den = torch.maximum(den, eps * den.max())
    return rep_r / den, rep_i / den


def psi_reps_scan(sigs, bank, n0, n1, e, eps, interpolate,
                  complete=None) -> torch.Tensor:
    """(E_local + 1, C, C) PSI replicates, ``sum_f Im(conj(C_f) C_{f+1})``
    over adjacent bank rows, the diagonal pinned to exact 0: the two ``si``
    products contract to FMAs on the card and need not cancel there."""
    spec = analytic_spectrum(sigs, interpolate)
    pr, pi = _psi_row_creps(spec, bank[0], n0, n1, e, eps, complete)
    incs = []
    for bank_row in bank[1:]:
        cr, ci = _psi_row_creps(spec, bank_row, n0, n1, e, eps, complete)
        incs.append(pr * ci - pi * cr)
        pr, pi = cr, ci
    reps = torch.stack(incs).sum(0)
    c = reps.shape[-1]
    return reps * (1.0 - torch.eye(c, dtype=reps.dtype, device=reps.device))


def psi_matrix_from_bank(sigs: torch.Tensor, bank: torch.Tensor,
                         interpolate: bool = False, eps: float = 1e-12,
                         time_range=None,
                         normalize: bool = True) -> torch.Tensor:
    """Phase slope index over every channel pair (Nolte 2008): (E, C, N)
    -> (C, C), antisymmetric with zero diagonal; positive ``[a, b]`` where
    channel a leads b.  Adjacent bank rows form the slope, so the rows
    must ascend.  ``normalize`` divides by the leave-one-epoch-out
    jackknife standard error (a z-like statistic; needs E >= 3 to mean
    anything)."""
    e = sigs.shape[0]
    if e < 2:
        raise ValueError("psi needs at least 2 epochs (>= 3 for a "
                         "meaningful jackknife)")
    if bank.shape[0] < 2:
        raise ValueError("psi needs at least 2 bank rows (adjacent "
                         "frequency pairs form the slope)")
    n0, n1 = time_range if time_range is not None else (0, sigs.shape[-1])
    reps = psi_reps_scan(sigs, bank, n0, n1, e, eps, interpolate)
    psi_ = reps[e]
    if not normalize:
        return psi_
    jk = reps[:e]
    var = (e - 1.0) * torch.mean((jk - jk.mean(0)) ** 2, dim=0)
    std = torch.sqrt(torch.clamp(var, min=0.0))
    return torch.where(std > 0,
                       psi_ / torch.where(std > 0, std, torch.ones_like(std)),
                       torch.zeros_like(psi_))


def psi_matrix(sigs, bank, interpolate: bool = False, eps: float = 1e-12,
               time_range=None, normalize: bool = True):
    """``psi_matrix_from_bank`` with an integer ``time_range`` (real
    analytic banks)."""
    return psi_matrix_from_bank(sigs, bank, interpolate, float(eps),
                                _samples(time_range), bool(normalize))


# -- lagged coherence ---------------------------------------------------------

def _lagged_indices(freqs, sfreq: float, n: int, lag: int):
    """Host per-frequency sample grids: ``idx[f, k]`` is the k-th sample,
    ``lag`` periods apart; ``valid[f, k]`` masks samples past the end (K
    is the largest count, shorter rows masked)."""
    freqs = np.asarray(freqs, np.float64)
    stride = lag * sfreq / freqs
    k_max = int(np.floor((n - 1) / stride.min())) + 1
    k = np.arange(k_max)[None, :]
    pos = k * stride[:, None]
    valid = pos <= n - 1
    idx = np.minimum(np.round(pos), n - 1).astype(np.int64)
    return idx, valid


def lagged_coherence(sig_r, bank_r, freqs, sfreq: float, lag: int = 1,
                     interpolate: bool = False, pooled: bool = False,
                     device=None) -> torch.Tensor:
    """Wavelet lagged coherence (after Fransen et al. 2015): coefficients
    sampled ``lag`` periods apart,
    ``|sum_k w_k conj(w_{k+1})| / sqrt(sum |w_k|^2 sum |w_{k+1}|^2)``, 1 for
    a sustained rhythm and low for noise.  (..., N) -> (..., F), or (F,)
    with ``pooled`` (the pair sums pooled over every leading axis).
    ``freqs`` are the bank rows' Hz."""
    sig = as_float32(sig_r, device)
    bank = as_float32(bank_r, sig.device)
    n = sig.shape[-1]
    if tuple(bank.shape) != (len(np.atleast_1d(freqs)), n):
        raise ValueError("bank must be (F, N) matching freqs and signal")
    if lag < 1:
        raise ValueError("lag must be >= 1 period")
    if np.asarray(freqs, np.float64).min() * n < lag * sfreq:
        raise ValueError("signal too short for even one lag at the "
                         "lowest frequency")
    idx, valid = _lagged_indices(freqs, sfreq, n, int(lag))
    w = cwt_from_bank(sig, bank, interpolate)               # (..., F, N)
    idx_t = torch.from_numpy(idx).to(sig.device)
    wk = torch.gather(w, -1, idx_t.expand(*w.shape[:-1], idx.shape[-1]))
    a, b = wk[..., :-1], wk[..., 1:]
    m = torch.from_numpy(valid[..., :-1] & valid[..., 1:]).to(
        sig.device, torch.float32)
    num = torch.sum(a * torch.conj(b) * m, dim=-1)
    p_a = torch.sum(torch.abs(a) ** 2 * m, dim=-1)
    p_b = torch.sum(torch.abs(b) ** 2 * m, dim=-1)
    if pooled:
        red = tuple(range(num.ndim - 1))
        if red:
            num, p_a, p_b = (v.sum(red) for v in (num, p_a, p_b))
    return torch.abs(num) / torch.clamp(torch.sqrt(p_a * p_b), min=1e-20)


@lru_cache(maxsize=None)
def _short_morse_def(beta: float, gamma: float) -> WaveletDef:
    """Reverse-mode Morse ``WaveletDef`` with (beta, gamma) baked in
    (cached: one object per parameter pair)."""
    def tf(grid, freq=1.0):
        return morse_spectrum(grid, freq, beta, gamma)

    return WaveletDef(mode=WaveletMode.Reverse, trans_formula=tf)


def lagged_coherence_morse(sig_r, freqs, sfreq: float,
                           n_cycles: float = 3.0, lag=None,
                           gamma: float = 3.0, pooled: bool = False,
                           device=None) -> torch.Tensor:
    """``lagged_coherence`` on a short Morse bank of ~``n_cycles`` periods
    (``beta = n_cycles^2 / gamma``) with ``lag`` defaulting to
    ``ceil(n_cycles)``: samples one window apart are near-independent
    under noise (a long wavelet at lag 1 pushes white noise toward 1)."""
    sig = as_float32(sig_r, device)
    if lag is None:
        lag = int(np.ceil(n_cycles))
    beta = float(n_cycles) ** 2 / float(gamma)
    bank = make_fft_bank(_short_morse_def(beta, float(gamma)),
                         np.asarray(freqs, np.float32), int(sig.shape[-1]),
                         float(sfreq), True, device=sig.device)
    return lagged_coherence(sig, bank, freqs, sfreq, lag=int(lag),
                            interpolate=True, pooled=bool(pooled))
