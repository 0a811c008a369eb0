"""The Paul / DOG / Bump wavelet spectra and the cross-signal products of
two channels (port of the spectra and the coherence part of
``ninwavelets_tpu.ops.extensions``): the cross-wavelet product, epoch-wise
wavelet coherence, imaginary coherency and the phase slope index.

The spectra follow the engine convention of ``ops.spectra``: a
frequency-domain ``trans_formula(grid, freq)`` peaking at ``grid == freq``
with amplitude 2, zero at zero and negative frequency, evaluated in log space
where powers would overflow float32.

All three statistics come from the same four epoch sums
(``coherence_sums``), taken over chunks of epochs (``epoch_sums``), so
memory stays bounded whatever the epoch count.  The
``*_auto`` entry points take the cross-pair kernel's "coherence" epilogue
(``ops.fused``) for a real bank and an (E, C, N) pair batch that
``ops.fused.route()`` takes, as the JAX package does on a TPU; the
single-pair (E, N) shape runs the plain sums.

The rest of the module is plain torch: bicoherence, the single-trial
smoothed wavelet coherence with its AR(1) Monte-Carlo significance levels,
cross-frequency directionality and the wavelet entropy.  Every matrix
product runs in full float32 (``scattering.fp32_matmul("exact")``).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..device import as_float32, resolve_device
from ..utils.observability import span
from .cwt import cwt_from_bank
from .spectra import _like

#: Elements of a vectorized step's largest per-item intermediate that one
#: chunk of epochs (or surrogates) may hold: 2^24, 128 MiB of complex64.
CHUNK_ELEMS = 1 << 24


def chunk_size(per_item: int) -> int:
    """Items (epochs, surrogates) one vectorized step takes at once."""
    return max(1, CHUNK_ELEMS // max(1, int(per_item)))


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
               bank: torch.Tensor, interpolate: bool, per_epoch,
               bank_b=None):
    """Sums over the leading (epoch) axis of the planes ``per_epoch(wa,
    wb)`` returns for the two coefficient sets (``sigs_b`` through
    ``bank_b`` when given, a bank of as many rows), taken over chunks of
    epochs (``chunk_size``: one epoch at a time once an epoch's
    coefficients reach ``CHUNK_ELEMS``); ``per_epoch`` is elementwise, so
    it maps a chunk at once.  Memory O(CHUNK_ELEMS + C*F*N) whatever the
    epoch count.  A one-epoch chunk's planes are taken as they are (a sum
    over its axis of one would copy each plane)."""
    bank_b = bank if bank_b is None else bank_b
    step = chunk_size(math.prod(sigs_a.shape[1:-1]) * bank.shape[0]
                      * sigs_a.shape[-1])
    totals = None
    for sa, sb in zip(torch.split(sigs_a, step), torch.split(sigs_b, step)):
        terms = [t[0] if len(t) == 1 else t.sum(0) for t in per_epoch(
            cwt_from_bank(sa, bank, interpolate),
            cwt_from_bank(sb, bank_b, interpolate))]
        totals = terms if totals is None else [
            t + u for t, u in zip(totals, terms)]
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


def _global_max(den: torch.Tensor, freq_group) -> torch.Tensor:
    """``den.max()``, completed over the ranks of ``freq_group`` (the bank
    rows of a frequency-sharded plane) when one is given."""
    m = den.max()
    if freq_group is not None:
        from ..parallel.collectives import pmax
        m = pmax(m, freq_group)
    return m


def coherence_from_sums(xr, xi, pa, pb, n_epochs: int,
                        eps: float = 1e-12, freq_group=None) -> torch.Tensor:
    """``|mean cross|^2 / (mean power_a * mean power_b)`` from the epoch
    sums.  A positive ``eps`` floors the denominator at ``eps`` times its
    maximum, so rows with no spectral support read 0 rather than 0/0.
    ``freq_group``: the ranks a frequency-sharded plane is split over, so
    that the floor's maximum is the whole plane's."""
    num = (torch.square(xr) + torch.square(xi)) / (n_epochs * n_epochs)
    den = (pa / n_epochs) * (pb / n_epochs)
    if eps:
        den = torch.maximum(den, eps * _global_max(den, freq_group))
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
    kernel's "coherence" epilogue for a workload ``ops.fused.route()``
    takes (a real bank among it), the plain path otherwise, inside the span
    it names."""
    from .fused import fused_coherence, route
    r = route("coherence", sigs_a, bank)
    with span(r.span):
        if r.takes:
            return fused_coherence(sigs_a, sigs_b, bank,
                                   interpolate=interpolate, eps=eps,
                                   precision=precision)
        return epoch_coherence(sigs_a, sigs_b, bank, interpolate, eps)


# -- imaginary coherency ------------------------------------------------------

def imcoh_from_sums(xr, xi, pa, pb, eps: float = 1e-12,
                    freq_group=None) -> torch.Tensor:
    """``Im(mean cross) / sqrt(mean |Wa|^2 mean |Wb|^2)`` from the
    ``coherence_sums`` planes (the epoch count cancels), with the relative
    denominator floor (and ``freq_group``) of ``coherence_from_sums``."""
    den = torch.sqrt(pa * pb)
    if eps:
        den = torch.maximum(den, eps * _global_max(den, freq_group))
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
    from .fused import fused_imcoh, route
    r = route("coherence", sigs_a, bank)
    with span(r.span):
        if r.takes:
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


# -- bicoherence --------------------------------------------------------------

def bicoherence_from_banks(sigs: torch.Tensor, bank1: torch.Tensor,
                           bank2: torch.Tensor, bank12: torch.Tensor,
                           interpolate: bool = False,
                           eps: float = 1e-12) -> torch.Tensor:
    """Magnitude-squared wavelet bicoherence (Kim & Powers 1979),
    ``|sum W(f1) W(f2) conj(W(f1+f2))|^2 / (sum |W(f1) W(f2)|^2
    sum |W(f1+f2)|^2)`` with the sums over time and epochs: (E, ..., N)
    -> (..., F1, F2).  ``bank12`` holds the F1 * F2 sum-frequency rows,
    row-major pairs ``f1[i] + f2[j]``, all below Nyquist.  Over chunks of
    epochs (``chunk_size`` of the (..., F1, F2, N) triple product, which is
    transient)."""
    f1, f2 = bank1.shape[0], bank2.shape[0]
    n = sigs.shape[-1]
    step = chunk_size(math.prod(sigs.shape[1:-1]) * f1 * f2 * n)
    sums = None
    for s in torch.split(sigs, step):
        w1 = cwt_from_bank(s, bank1, interpolate)
        w2 = cwt_from_bank(s, bank2, interpolate)
        w12 = cwt_from_bank(s, bank12, interpolate).reshape(
            *s.shape[:-1], f1, f2, n)
        pair = w1[..., :, None, :] * w2[..., None, :, :]
        t = pair * torch.conj(w12)
        terms = [u.sum(-1).sum(0) for u in (
            t.real, t.imag,
            torch.square(pair.real) + torch.square(pair.imag),
            torch.square(w12.real) + torch.square(w12.imag))]
        sums = terms if sums is None else [
            a + b for a, b in zip(sums, terms)]
    nr, ni, d1, d2 = sums
    num = torch.square(nr) + torch.square(ni)
    den = d1 * d2
    if eps:
        den = torch.maximum(den, eps * den.max())
    return num / den


def bicoherence(sigs, bank1, bank2, bank12, interpolate: bool = False,
                eps: float = 1e-12) -> torch.Tensor:
    """``bicoherence_from_banks`` (real analytic banks: the statistic needs
    the analytic phases)."""
    return bicoherence_from_banks(sigs, bank1, bank2, bank12, interpolate,
                                  eps)


# -- single-trial smoothed wavelet coherence ----------------------------------

def _coherence_smooth(planes: torch.Tensor, f_grid: torch.Tensor,
                      sfreq: float, cycles: float,
                      scale_width: float) -> torch.Tensor:
    """Torrence-Webster smoothing of real (..., F, N) planes: per row a
    Gaussian in time of width ``cycles / f`` (one rFFT, a closed-form
    transfer ``exp(-(2 pi nu s_f)^2 / 2)``, one irFFT; circular), then a
    boxcar in scale of ``scale_width`` octaves as one normalized (F, F)
    matrix product over the frequency axis, in full float32."""
    from .scattering import fp32_matmul    # scattering imports ops.fused
    n = planes.shape[-1]
    nu = torch.fft.rfftfreq(n, 1.0 / sfreq, dtype=torch.float32,
                            device=planes.device)
    s_f = cycles / f_grid
    arg = (2.0 * math.pi) * nu[None, :] * s_f[:, None]
    transfer = torch.exp(-0.5 * arg * arg)                   # (F, N//2+1)
    sm = torch.fft.irfft(torch.fft.rfft(planes) * transfer, n=n)
    oct_dist = torch.abs(torch.log2(f_grid[:, None] / f_grid[None, :]))
    w = (oct_dist <= 0.5 * scale_width).to(torch.float32)
    w = w / w.sum(1, keepdim=True)
    with fp32_matmul("exact"):
        return torch.matmul(w, sm)


def wavelet_coherence_from_bank(sig_a: torch.Tensor, sig_b: torch.Tensor,
                                bank: torch.Tensor, f_grid: torch.Tensor,
                                sfreq: float, interpolate: bool = False,
                                cycles: float = 1.0,
                                scale_width: float = 0.6,
                                eps: float = 1e-12,
                                return_phase: bool = False):
    """Single-trial magnitude-squared wavelet coherence with time and scale
    smoothing (Torrence & Webster 1999, Grinsted 2004),
    ``|S(W_ab / s)|^2 / (S(|Wa|^2 / s) S(|Wb|^2 / s))`` with ``1/s ∝ f``:
    (..., N) x2 -> (..., F, N) in [0, 1], and with ``return_phase`` also
    the smoothed relative phase ``atan2(S(x_i), S(x_r))`` (positive: a
    leads b).  The denominator is floored at ``eps`` times its maximum
    over the whole batch."""
    ca = cwt_from_bank(sig_a, bank, interpolate)
    cb = cwt_from_bank(sig_b, bank, interpolate)
    x = ca * torch.conj(cb)
    inv_s = f_grid[:, None]
    planes = torch.stack([
        x.real * inv_s, x.imag * inv_s,
        (torch.square(ca.real) + torch.square(ca.imag)) * inv_s,
        (torch.square(cb.real) + torch.square(cb.imag)) * inv_s])
    sm = _coherence_smooth(planes, f_grid, sfreq, cycles, scale_width)
    num = torch.square(sm[0]) + torch.square(sm[1])
    den = sm[2] * sm[3]
    if eps:
        den = torch.maximum(den, eps * den.max())
    coh = num / den
    if return_phase:
        return coh, torch.atan2(sm[1], sm[0])
    return coh


def wavelet_coherence(sig_a, sig_b, bank, freqs, sfreq: float,
                      interpolate: bool = False, cycles: float = 1.0,
                      scale_width: float = 0.6, eps: float = 1e-12,
                      return_phase: bool = False):
    """``wavelet_coherence_from_bank`` with ``freqs`` (the bank's Hz rows)
    taken as any sequence (real or complex banks)."""
    f_grid = torch.as_tensor(freqs, dtype=torch.float32, device=sig_a.device)
    return wavelet_coherence_from_bank(sig_a, sig_b, bank, f_grid,
                                       float(sfreq), interpolate, cycles,
                                       scale_width, eps, return_phase)


# -- cross-frequency directionality -------------------------------------------

def cfd_from_banks(sigs: torch.Tensor, bank_slow: torch.Tensor,
                   bank_fast: torch.Tensor, band=None,
                   interpolate: bool = False, eps: float = 1e-12,
                   normalize: bool = True) -> torch.Tensor:
    """Cross-frequency directionality (Jiang et al. 2015): (E, ..., N) ->
    (..., N), the phase slope index across the ``bank_slow`` rows between
    the signal and its fast-band amplitude envelope (the mean |W| over the
    ``bank_fast`` rows).  Positive where the slow phase leads the fast
    amplitude.  A pure sinusoid in the slow band has a flat cross-phase
    across the rows, so its CFD is ~0 however strong the coupling."""
    env = torch.abs(cwt_from_bank(sigs, bank_fast, interpolate)).mean(-2)
    return psi_from_bank(sigs, env, bank_slow, band, interpolate, eps,
                         normalize)


def cfd(sigs, bank_slow, bank_fast, band=None, interpolate: bool = False,
        eps: float = 1e-12, normalize: bool = True) -> torch.Tensor:
    """``cfd_from_banks`` with ``band`` taken as an integer (lo, hi) pair of
    slow rows (real analytic banks)."""
    b = None if band is None else (int(band[0]), int(band[1]))
    return cfd_from_banks(sigs, bank_slow, bank_fast, b, interpolate, eps,
                          normalize)


# -- wavelet entropy ----------------------------------------------------------

def wavelet_entropy(power, normalized: bool = True, eps: float = 1e-30,
                    device=None) -> torch.Tensor:
    """Time-resolved wavelet entropy of a (..., F, N) power plane (Rosso
    et al. 2001): ``-sum_f p_f ln p_f`` with ``p_f = P(f, t) / sum_f P``,
    divided by ``ln F`` when ``normalized`` (1: energy spread over every
    band, 0: one band).  A single band gives zeros.  A tensor stays on its
    device; other input goes to ``device`` (the card when None)."""
    power = as_float32(power, device)
    tot = torch.clamp(power.sum(-2, keepdim=True), min=eps)
    p = power / tot
    h = -torch.where(p > 0, p * torch.log(torch.clamp(p, min=eps)),
                     torch.zeros_like(p)).sum(-2)
    if normalized:
        f = power.shape[-2]
        h = h / math.log(f) if f > 1 else torch.zeros_like(h)
    return h


# -- Monte-Carlo significance of the smoothed wavelet coherence ---------------

AR1_BLOCK = 128


def ar1_filter(alpha: float, noise: torch.Tensor) -> torch.Tensor:
    """``x_t = alpha x_{t-1} + e_t`` along the last axis from ``x_{-1} = 0``,
    blocked: each block of L = ``AR1_BLOCK`` samples is one product with
    the L x L lower-triangular matrix of powers of ``alpha`` (full
    float32), and the values at the block ends, themselves an AR(1) with
    coefficient ``alpha^L``, come from the same routine one level down and
    are carried into the next block by ``alpha^(i+1)``.  Depth log_L(N),
    no loop over samples."""
    from .scattering import fp32_matmul    # scattering imports ops.fused
    n = noise.shape[-1]
    length = min(AR1_BLOCK, n)
    nb = -(-n // length)
    e = torch.nn.functional.pad(noise, (0, nb * length - n))
    i = np.arange(length)
    powers = np.where(i[:, None] >= i[None, :],
                      float(alpha) ** np.maximum(i[:, None] - i[None, :], 0),
                      0.0)
    tri = torch.as_tensor(powers, dtype=noise.dtype, device=noise.device)
    with fp32_matmul("exact"):
        y = torch.matmul(e.reshape(*e.shape[:-1], nb, length), tri.T)
    if nb > 1:
        ends = ar1_filter(float(alpha) ** length, y[..., -1])
        carry = torch.nn.functional.pad(ends[..., :-1], (1, 0))
        decay = torch.as_tensor(float(alpha) ** (i + 1.0), dtype=noise.dtype,
                                device=noise.device)
        y = y + carry[..., None] * decay
    return y.reshape(*e.shape)[..., :n]


def row_quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(x, q, axis=-1)`` with ``method="linear"`` for rows of
    any length (``torch.quantile`` refuses more than 2^24 elements): one
    sort per row, then ``v[lo] (1 - t) + v[hi] t`` at ``q (M - 1) =
    lo + t``."""
    m = x.shape[-1]
    pos = float(q) * (m - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, m - 1)
    t = pos - lo
    v = torch.sort(x, dim=-1).values
    return v[..., lo] * (1.0 - t) + v[..., hi] * t


def _wtc_null(bank: torch.Tensor, f_grid: torch.Tensor, noise: torch.Tensor,
              alpha_a: float, alpha_b: float, sfreq: float,
              interpolate: bool = False, cycles: float = 1.0,
              scale_width: float = 0.6, eps: float = 1e-12,
              q: float = 0.95) -> torch.Tensor:
    """(F,) significance levels from the (2, S, N) standard-normal
    ``noise``: the S AR(1) surrogate pairs (``ar1_filter``), the smoothed
    coherence of each pair (one surrogate at a time: its denominator floor
    is its own), and the pooled (surrogate, time) quantile ``q`` per row."""
    xa = ar1_filter(alpha_a, noise[0])
    xb = ar1_filter(alpha_b, noise[1])
    wtcs = torch.stack([
        wavelet_coherence_from_bank(a, b, bank, f_grid, sfreq, interpolate,
                                    cycles, scale_width, eps)
        for a, b in zip(xa, xb)])                            # (S, F, N)
    return row_quantile(wtcs.transpose(0, 1).reshape(bank.shape[0], -1), q)


def wtc_significance(sig_a_r, sig_b_r, bank_r, freqs, sfreq: float,
                     n_surrogates: int = 100, q: float = 0.95,
                     seed: int = 0, interpolate: bool = False,
                     cycles: float = 1.0, scale_width: float = 0.6,
                     eps: float = 1e-12, device=None) -> torch.Tensor:
    """(F,) Monte-Carlo significance levels for the smoothed wavelet
    coherence (Grinsted, Moore & Jevrejeva 2004): the coherence of
    ``n_surrogates`` independent AR(1) pairs, their lag-1 coefficients
    fitted to the two inputs (``tc_stats.ar1_coefficient`` on the first
    (..., N) row of each), pooled over (surrogate, time) per row at
    quantile ``q``.  The noise is drawn on the bank's device (``device``
    when given) from a ``torch.Generator`` seeded with ``seed``: the same
    seed gives other surrogates than the JAX package's.  Memory holds the
    (S, F, N) coherence stack; size ``n_surrogates`` for it."""
    from .tc_stats import ar1_coefficient
    a = np.asarray(torch.as_tensor(sig_a_r).detach().cpu(), np.float32)
    b = np.asarray(torch.as_tensor(sig_b_r).detach().cpu(), np.float32)
    n = a.shape[-1]
    alpha_a = ar1_coefficient(a.reshape(-1, n)[0])
    alpha_b = ar1_coefficient(b.reshape(-1, n)[0])
    if isinstance(bank_r, torch.Tensor):
        bank = bank_r if device is None else bank_r.to(device)
    else:
        bank = torch.as_tensor(np.asarray(bank_r),
                               device=resolve_device(device))
    g = torch.Generator(device=bank.device).manual_seed(int(seed))
    noise = torch.randn((2, int(n_surrogates), n), generator=g,
                        dtype=torch.float32, device=bank.device)
    f_grid = torch.as_tensor(freqs, dtype=torch.float32, device=bank.device)
    return _wtc_null(bank, f_grid, noise, alpha_a, alpha_b, float(sfreq),
                     interpolate, cycles, scale_width, eps, q)
