"""Spectral (wavelet-domain) Granger causality via Wilson spectral
factorization (port of ``ninwavelets_tpu.ops.granger``; Wilson 1972;
Dhamala, Rangarajan & Ding, NeuroImage 2008).

Factorize the (cross-)spectral density matrix S(f) = H(f) Sigma H(f)^dagger
into a causal transfer function H and a noise covariance Sigma, then read
Geweke's Granger causality (and DTF / PDC) off the factors.  Applied per
time slice of the wavelet cross-spectrogram it gives time-varying directed
influence.

Design, as in the JAX package:

* the factorization grid is UNIFORM over [0, Nyquist] (Wilson's "plus
  operator" is an FFT across frequency), so ``wavelet_granger`` builds its
  own energy-normalized uniform-grid Morse bank (a per-frequency gain would
  distort the GC ratio);
* the Wilson loop runs a FIXED count of steps (60), batched over every
  (time, pair) system, each a frequency-axis FFT pair plus small-matrix
  algebra; the complex solves go through the real (2C, 2C) block embedding
  of ``ops.connectivity._solve_complex`` (``torch.linalg.solve_ex`` without
  error checks: a singular block gives non-finite values, as in the JAX
  package, and no host sync);
* every matrix product (``psi @ gamma``, the cross-spectra einsums) runs in
  full float32 (``fp32_matmul("exact")``), whatever the caller's TF32
  setting; the Wilson products of matrices up to 4 x 4 are formed
  elementwise (``_mm``), not by a batched GEMM;
* the pairwise path factorizes the (time, pair) systems in balanced chunks
  of at most ``_PAIR_CHUNK`` systems, which bounds the peak memory of the
  full-width call; the systems are independent, so the result does not
  depend on the chunks.

Complex input is a complex tensor (or a numpy array): there is no
float-pair boundary to cross.  A numpy input goes to ``device``, the card
when None; a tensor stays where it is.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import as_float32, resolve_device
from .bank import make_fft_bank
from .connectivity import _solve_complex, _solve_ex
from .cwt import cwt_from_bank
from .scattering import fp32_matmul

__all__ = ["wilson_factorize", "spectral_granger_pairwise",
           "conditional_granger", "wavelet_conditional_granger",
           "dtf_pdc", "wavelet_dtf_pdc",
           "granger_from_factors", "wavelet_granger",
           "wavelet_granger_significance", "uniform_freqs"]

#: (time, pair) systems factorized at once by the pairwise path: at 2(K-1) =
#: 128 frequency points that is 2^21 complex 2x2 matrices (64 MiB as
#: complex64, 128 MiB in the real block embedding of the solves).
_PAIR_CHUNK = 1 << 14
#: Complex CWT coefficients formed at once by the decimated CWT (epochs are
#: taken in chunks of at most this many coefficients, and at least one).
_CWT_CHUNK = 1 << 25


def uniform_freqs(n_bins: int, sfreq: float) -> np.ndarray:
    """The one-sided uniform factorization grid: ``n_bins`` frequencies
    ``k * (sfreq/2) / (n_bins - 1)``, k = 0..n_bins-1 (DC..Nyquist)."""
    return np.linspace(0.0, sfreq / 2.0, int(n_bins))


def _as_complex(s, device=None) -> torch.Tensor:
    """``s`` as a complex64 tensor: a tensor stays on its device, other
    input goes to ``device`` (the card when None)."""
    if isinstance(s, torch.Tensor):
        return s.to(torch.complex64)
    arr = np.asarray(s).astype(np.complex64)
    return torch.from_numpy(arr).to(resolve_device(device))


def _two_sided(s: torch.Tensor) -> torch.Tensor:
    """Hermitian completion of a one-sided (..., K, C, C) spectral matrix
    onto the full 2(K-1) circle: ``S(-f) = conj(S(f))`` entrywise (real
    processes have real lag covariances)."""
    body = s[..., 1:-1, :, :].flip(-3).conj()
    return torch.cat([s, body], dim=-3)


def _plus_operator(g: torch.Tensor, half: int) -> torch.Tensor:
    """Wilson's causal-part operator on a full-circle (..., 2h, C, C)
    function: to the lag domain, keep lags 1..h-1, halve lag 0 and keep only
    its upper triangle (diagonal included), zero the rest, back to
    frequency."""
    gam = torch.fft.ifft(g, dim=-3)
    out = torch.zeros_like(gam)
    out[..., 1:half, :, :] = gam[..., 1:half, :, :]
    out[..., 0, :, :] = torch.triu(0.5 * gam[..., 0, :, :])
    return torch.fft.fft(out, dim=-3)


def _dagger(m: torch.Tensor) -> torch.Tensor:
    return m.transpose(-1, -2).conj()


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for batches of small matrices: up to 4 x 4 as elementwise
    products summed over k (a batched GEMM pads each 2 x 2 product into a
    32 x 32 tile: on an H100 it took half of the full-width Wilson loop);
    larger ones through ``matmul``, in full float32 under the caller's
    ``fp32_matmul("exact")``."""
    if max(a.shape[-2:] + b.shape[-1:]) > 4:
        return a @ b
    return (a.unsqueeze(-1) * b.unsqueeze(-3)).sum(-2)


def _wilson_full(s_full: torch.Tensor, n_iter: int = 60):
    """Wilson's iteration on the full-circle spectral matrix (..., 2h, C, C),
    complex64.  Returns (psi_full, h_one_sided, sigma).  Call it inside
    ``fp32_matmul("exact")``."""
    n2 = s_full.shape[-3]
    h = n2 // 2
    c = s_full.shape[-1]
    eye = torch.eye(c, dtype=s_full.dtype, device=s_full.device)

    # Diagonal init psi0 = diag(sqrt(mean S_ii)): Wilson converges from any
    # invertible causal init, and this one needs no Cholesky.
    diag0 = torch.sqrt(torch.clamp(torch.diagonal(
        s_full.mean(-3), dim1=-2, dim2=-1).real, min=1e-20))
    psi = torch.diag_embed(diag0).unsqueeze(-3).expand(
        s_full.shape).to(s_full.dtype)

    for _ in range(int(n_iter)):
        x = _solve_complex(psi, s_full)
        g = _dagger(_solve_complex(psi, _dagger(x))) + eye
        psi = _mm(psi, _plus_operator(g, h))
    # Zero-lag coefficient = the frequency mean; Sigma = A0 A0^dagger,
    # H = psi A0^{-1} (the one-sided half is returned).
    a0 = psi.mean(-3)
    sigma = _mm(a0, _dagger(a0)).real
    a0inv = _solve_complex(a0, eye.expand(a0.shape))
    h_fn = _mm(psi[..., :h + 1, :, :], a0inv.unsqueeze(-3))
    return psi, h_fn, sigma


def wilson_factorize(s, n_iter: int = 60, device=None):
    """Factorize a one-sided (..., K, C, C) Hermitian spectral density into
    ``S(f) = H(f) Sigma H(f)^dagger`` (H causal, H(lag 0) = I).

    Returns ``(H, Sigma)``: H (..., K, C, C) complex64, Sigma (..., C, C)
    float32.  K - 1 must be the half grid (K uniform bins from DC to
    Nyquist).  The discrete factorization is exact for the circular process
    whose covariance is the inverse DFT of the sampled spectrum: the true
    lag covariance must have decayed within 2(K-1) lags, so sharp
    resonances need fine grids.
    """
    s = _as_complex(s, device)
    if s.shape[-1] != s.shape[-2]:
        raise ValueError("spectral matrix must be square, got %s"
                         % (tuple(s.shape),))
    if s.shape[-3] < 3:
        raise ValueError("need at least 3 frequency bins (DC..Nyquist)")
    with fp32_matmul("exact"):
        _, h_fn, sigma = _wilson_full(_two_sided(s), n_iter)
    return h_fn, sigma


def granger_from_factors(h_fn: torch.Tensor, sigma: torch.Tensor,
                         s: torch.Tensor) -> torch.Tensor:
    """Geweke's pairwise spectral GC from 2x2 factors: for the (x, y)
    system, influence y -> x at f is

        ln( S_xx / (S_xx - (Sig_yy - Sig_xy^2 / Sig_xx) |H_xy|^2) ).

    ``h_fn`` / ``s`` are (..., K, 2, 2), ``sigma`` (..., 2, 2); returns
    (..., K, 2) = [y->x, x->y].
    """
    sxx = s[..., 0, 0].real
    syy = s[..., 1, 1].real
    sig = sigma.unsqueeze(-3)
    cond_y = sig[..., 1, 1] - sig[..., 0, 1] ** 2 / sig[..., 0, 0]
    cond_x = sig[..., 0, 0] - sig[..., 0, 1] ** 2 / sig[..., 1, 1]
    hxy2 = h_fn[..., 0, 1].abs() ** 2
    hyx2 = h_fn[..., 1, 0].abs() ** 2
    eps = 1e-12
    gc_yx = torch.log(torch.clamp(sxx, min=eps)
                      / torch.clamp(sxx - cond_y * hxy2, min=eps))
    gc_xy = torch.log(torch.clamp(syy, min=eps)
                      / torch.clamp(syy - cond_x * hyx2, min=eps))
    return torch.stack([gc_yx, gc_xy], dim=-1)


def _pair_list(c: int) -> np.ndarray:
    return np.array([(a, b) for a in range(c) for b in range(a + 1, c)],
                    np.int64).reshape(-1, 2)


def _pairwise_gc(s: torch.Tensor, pairs: torch.Tensor,
                 n_iter: int) -> torch.Tensor:
    """(..., K, C, C) spectra -> (..., P, K, 2) GC of every pair's 2x2
    submatrix, the (batch, pair) systems factorized in balanced chunks of
    at most ``_PAIR_CHUNK``."""
    i, j = pairs[:, 0], pairs[:, 1]
    ii = torch.stack([i, i, j, j], -1)
    jj = torch.stack([i, j, i, j], -1)
    # (..., K, P, 4) -> (..., P, K, 2, 2)
    g = s[..., ii, jj].movedim(-2, -3)
    g = g.reshape(*g.shape[:-1], 2, 2)
    lead = g.shape[:-3]
    flat = g.reshape(-1, *g.shape[-3:])
    if flat.shape[0] == 0:
        return torch.zeros(*lead, g.shape[-3], 2, device=g.device)
    out = []
    # Balanced, so that no chunk is a lone system split off a larger batch:
    # one system's frequency-axis FFTs take the CPU's unvectorized path,
    # which rounds differently.
    n_chunks = -(-flat.shape[0] // _PAIR_CHUNK)
    with fp32_matmul("exact"):
        for part in torch.tensor_split(flat, n_chunks):
            _, h_fn, sigma = _wilson_full(_two_sided(part), n_iter)
            out.append(granger_from_factors(h_fn, sigma, part))
    return torch.cat(out).reshape(*lead, *out[0].shape[1:])


def _pairwise_assemble(s: torch.Tensor, n_iter: int) -> torch.Tensor:
    """All-pairs GC of (..., K, C, C) spectra scattered into the
    (..., K, C, C) plane: ``out[..., i, j]`` = influence j -> i."""
    c = s.shape[-1]
    pairs = torch.from_numpy(_pair_list(c)).to(s.device)
    gc = _pairwise_gc(s, pairs, n_iter)
    out = torch.zeros(*s.shape[:-3], s.shape[-3], c, c, dtype=torch.float32,
                      device=s.device)
    i, j = pairs[:, 0], pairs[:, 1]
    # gc[..., p, :, 0] = j->i goes to out[i, j]; [..., 1] = i->j to [j, i]
    out[..., i, j] = gc[..., 0].movedim(-2, -1)
    out[..., j, i] = gc[..., 1].movedim(-2, -1)
    return out


def spectral_granger_pairwise(s, n_iter: int = 60,
                              device=None) -> torch.Tensor:
    """All-pairs spectral Granger causality of a one-sided (..., K, C, C)
    spectral matrix: each unordered channel pair's 2x2 submatrix is
    factorized independently (batched), giving the (..., K, C, C) GC plane
    with ``out[..., i, j]`` = influence j -> i (diagonal 0).  Pairwise (not
    conditional) GC: the standard Dhamala nonparametric estimator."""
    return _pairwise_assemble(_as_complex(s, device), n_iter)


# -- DTF / PDC off the same factors -------------------------------------------

def _dtf_pdc(s: torch.Tensor, n_iter: int):
    c = s.shape[-1]
    with fp32_matmul("exact"):
        _, h_fn, _ = _wilson_full(_two_sided(s), n_iter)
        eye = torch.eye(c, dtype=h_fn.dtype, device=h_fn.device)
        a_fn = _solve_complex(h_fn, eye.expand(h_fn.shape))
    h2 = h_fn.abs() ** 2
    a2 = a_fn.abs() ** 2
    dtf = torch.sqrt(h2 / torch.clamp(h2.sum(-1, keepdim=True), min=1e-20))
    pdc = torch.sqrt(a2 / torch.clamp(a2.sum(-2, keepdim=True), min=1e-20))
    return dtf, pdc


def dtf_pdc(s, n_iter: int = 60, device=None):
    """(DTF, PDC) of a one-sided (..., K, C, C) spectral matrix, both
    (..., K, C, C) with ``[..., i, j]`` = flow j -> i in [0, 1].

    From the Wilson factors: the directed transfer function is the
    row-normalized transfer magnitude ``|H_ij| / sqrt(sum_m |H_im|^2)``
    (Kaminski-Blinowska: sensitive to CASCADES, an x<-z<-y chain lights
    y->x up), and partial directed coherence the column-normalized
    inverse-transfer magnitude ``|A_ij| / sqrt(sum_k |A_kj|^2)`` with
    ``A = H^{-1}`` (Baccala-Sameshima: DIRECT links only).
    """
    s = _as_complex(s, device)
    if s.shape[-1] != s.shape[-2]:
        raise ValueError("spectral matrix must be square, got %s"
                         % (tuple(s.shape),))
    return _dtf_pdc(s, n_iter)


def wavelet_dtf_pdc(sigs_r, sfreq: float, n_bins: int = 65,
                    time_decim: int = 16, n_iter: int = 60,
                    interpolate: bool = True, device=None):
    """Time-resolved (DTF, PDC) of an (E, C, N) epoch stack: the
    ``wavelet_granger`` cross-spectra pipeline with the normalized transfer
    measures per time slice, each (T', K, C, C)."""
    sigs, bank = _granger_inputs(sigs_r, sfreq, n_bins, interpolate,
                                 device=device)
    return _dtf_pdc(_cross_spectra(sigs, bank, time_decim, interpolate),
                    n_iter)


# -- conditional (multivariate) Granger causality -----------------------------

def _solve_real(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a^{-1} b`` for real (..., C, C) and (..., C, k), without error
    checks: a singular system gives non-finite values, as
    ``jnp.linalg.solve`` does."""
    return _solve_ex(a, b)


def _conditional(s: torch.Tensor, n_iter: int) -> torch.Tensor:
    """(..., K, C, C) conditional GC of complex spectra.

    Factorize the FULL system S = H Sigma H^dagger and, for each excluded
    source j, the REDUCED system without j, S_red = G Sigma_G G^dagger.
    The reduced innovations are eta = Q eps with Q = G^{-1} H_rows, and
    the part of target i's innovation power owed to source j's partialized
    innovation is sigma_{jj|rest} |Q_{i,j}(f)|^2, so

        F_{j->i|rest}(f) = ln( Sigma_G[i,i]
                               / (Sigma_G[i,i]
                                  - sigma_{jj|rest} |Q_{i,j}(f)|^2) ).

    It reduces exactly to the bivariate Geweke formula at C = 2.
    """
    c = s.shape[-1]
    k = s.shape[-3]
    dev = s.device
    keep_np = np.stack([np.delete(np.arange(c), j) for j in range(c)])
    keep = torch.from_numpy(keep_np).to(dev)                 # (Cx, C-1)
    ar = torch.arange(c, device=dev)
    with fp32_matmul("exact"):
        _, h_full, sigma = _wilson_full(_two_sided(s), n_iter)
        # every reduced system batched on a new axis:
        # (..., K, Cx, C-1, C-1) -> (..., Cx, K, C-1, C-1)
        s_red = s[..., keep[:, :, None], keep[:, None, :]].movedim(-4, -3)
        _, g_red, sigma_g = _wilson_full(_two_sided(s_red), n_iter)
        # Q = G^{-1} H_rows: (..., Cx, K, C-1, C)
        h_rows = h_full[..., keep[:, :, None], ar[None, None, :]].movedim(
            -4, -3)
        q = _solve_complex(g_red, h_rows)
        # sigma_{jj|rest} from the full innovation covariance: (..., Cx)
        sig_rr = sigma[..., keep[:, :, None], keep[:, None, :]]
        col_j = sigma[..., keep, ar[:, None]]                # (..., Cx, C-1)
        solved = _solve_real(sig_rr, col_j.unsqueeze(-1))[..., 0]
    sig_jj = torch.diagonal(sigma, dim1=-2, dim2=-1)         # (..., C)
    sigma_cond = sig_jj - (col_j * solved).sum(-1)
    # |Q[pos(i), j]|^2 per excluded j: column j of the j-th reduced system
    q_j = torch.diagonal(q, dim1=-4, dim2=-1).movedim(-1, -3)
    diag_g = torch.diagonal(sigma_g, dim1=-2, dim2=-1)       # (..., Cx, C-1)
    num = diag_g.unsqueeze(-2)
    den = num - sigma_cond[..., None, None] * q_j.abs() ** 2
    eps = 1e-12
    f_red = torch.log(torch.clamp(num, min=eps)
                      / torch.clamp(den, min=eps))         # (..., Cx, K, C-1)
    # scatter back: out[..., k, i, j] = f_red[..., j, k, pos(i in keep[j])]
    out = torch.zeros(*s.shape[:-3], k, c, c, dtype=torch.float32,
                      device=dev)
    for j in range(c):
        out[..., keep[j], j] = f_red[..., j, :, :]
    return out


def conditional_granger(s, n_iter: int = 60, device=None) -> torch.Tensor:
    """Conditional multivariate Granger causality of a one-sided
    (..., K, C, C) spectral matrix: ``out[..., i, j]`` is the influence
    j -> i CONDITIONED on all remaining channels (diagonal 0), so indirect
    routes that pairwise GC misreads as direct are suppressed.  One full
    factorization plus C reduced ones, all batched."""
    s = _as_complex(s, device)
    if s.shape[-1] != s.shape[-2] or s.shape[-1] < 3:
        raise ValueError(
            "conditional GC needs (..., K, C>=3, C) spectra; use the "
            "pairwise estimator for C = 2, got %s" % (tuple(s.shape),))
    return _conditional(s, n_iter)


def wavelet_conditional_granger(sigs_r, sfreq: float, n_bins: int = 65,
                                time_decim: int = 16, n_iter: int = 60,
                                interpolate: bool = True,
                                device=None) -> torch.Tensor:
    """Time-resolved CONDITIONAL Granger causality of an (E, C, N) epoch
    stack: ``wavelet_granger``'s cross-spectra pipeline with the
    multivariate conditional estimator per time slice."""
    sigs, bank = _granger_inputs(sigs_r, sfreq, n_bins, interpolate,
                                 device=device)
    if sigs.shape[1] < 3:
        raise ValueError("conditional GC needs >= 3 channels")
    return _conditional(_cross_spectra(sigs, bank, time_decim, interpolate),
                        n_iter)


# -- the wavelet cross spectra ------------------------------------------------

def _decimated_cwt(sigs: torch.Tensor, bank: torch.Tensor, time_decim: int,
                   interpolate: bool) -> torch.Tensor:
    """(E, C, K, T') complex CWT coefficients of (E, C, N) signals at every
    ``time_decim``-th sample: the per-trial tableau the surrogate nulls
    re-pair.  Epochs are transformed in chunks of at most ``_CWT_CHUNK``
    coefficients."""
    e, c, n = sigs.shape
    step = max(1, _CWT_CHUNK // (c * bank.shape[0] * n))
    # each chunk's kept samples are copied out, so that its full plane is
    # freed before the next chunk is transformed
    return torch.cat([
        cwt_from_bank(sigs[i:i + step], bank,
                      interpolate)[..., ::time_decim].clone()
        for i in range(0, e, step)])


def _cross_from_tableau(w: torch.Tensor, perms=None) -> torch.Tensor:
    """Epoch-mean cross spectra (..., T', K, C, C) of an (E, C, K, T')
    tableau, each channel's trial axis re-paired by its own row of
    ``perms`` ((C, E); None keeps the observed pairing)."""
    e = w.shape[0]
    if perms is not None:
        # out[e, c] = w[perms[c, e], c]
        w = w[perms.T, torch.arange(w.shape[1], device=w.device)[None, :]]
    with fp32_matmul("exact"):
        cross = torch.einsum("eakt,ebkt->tkab", w, w.conj())
    return cross / e


def _cross_spectra(sigs, bank, time_decim, interpolate) -> torch.Tensor:
    """(T', K, C, C) epoch-mean wavelet cross spectra at every
    ``time_decim``-th sample."""
    return _cross_from_tableau(
        _decimated_cwt(sigs, bank, int(time_decim), bool(interpolate)))


def _granger_inputs(sigs_r, sfreq, n_bins, interpolate,
                    b: float = 17.5, r: float = 3.0, device=None):
    """Validated (E, C, N) float32 signals and the energy-normalized
    uniform-grid Morse bank on their device (a per-frequency gain would
    distort the GC ratio; the DC row is synthesized as the first analyzed
    bin, since wavelets have no DC atom)."""
    from ..models.zoo import Morse

    sigs = as_float32(sigs_r, device)
    if sigs.ndim != 3:
        raise ValueError("expected (epochs, channels, N), got %s"
                         % (tuple(sigs.shape),))
    freqs = uniform_freqs(n_bins, sfreq)
    freqs[0] = freqs[1]  # no DC wavelet: reuse the first analyzed bin
    morse = Morse(sfreq, b=b, r=r, device=sigs.device)
    bank = make_fft_bank(morse._wdef(), freqs.astype(np.float32),
                         sigs.shape[-1], sfreq, bool(interpolate),
                         device=sigs.device)
    norms = torch.sqrt((bank.abs() ** 2).sum(-1, keepdim=True)
                       / sigs.shape[-1])
    return sigs, bank / torch.clamp(norms, min=1e-20)


def wavelet_granger(sigs_r, sfreq: float, n_bins: int = 65,
                    b: float = 17.5, r: float = 3.0,
                    time_decim: int = 16, n_iter: int = 60,
                    interpolate: bool = True, device=None) -> torch.Tensor:
    """Time-resolved pairwise spectral Granger causality of an (E, C, N)
    multi-channel epoch stack (Dhamala et al. 2008, wavelet variant).

    Builds an ENERGY-normalized Morse bank on the uniform ``n_bins``
    factorization grid, epoch-averages the wavelet cross-spectral matrix at
    every ``time_decim``-th sample, Wilson-factorizes each (time, pair) 2x2
    spectral matrix, and returns the (T', K, C, C) GC array with
    ``[..., i, j]`` = influence j -> i (T' = ceil(N / time_decim),
    K = n_bins).  ``n_bins - 1`` should be a power of two (the
    factorization FFTs run over 2(K-1) points).
    """
    sigs, bank = _granger_inputs(sigs_r, sfreq, n_bins, interpolate, b, r,
                                 device)
    return _pairwise_assemble(
        _cross_spectra(sigs, bank, time_decim, interpolate), n_iter)


def _trial_perms(n_surrogates: int, c: int, e: int, seed: int,
                 device) -> torch.Tensor:
    """(S, C, E) independent trial permutations from a ``torch.Generator``
    seeded with ``seed`` on ``device`` (other draws than the JAX
    package's for the same seed)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return torch.rand((n_surrogates, c, e), generator=gen,
                      device=device).argsort(-1)


def _significance_from_perms(sigs: torch.Tensor, bank: torch.Tensor,
                             perms: torch.Tensor, time_decim: int,
                             n_iter: int, interpolate: bool):
    """``(gc, p)`` of ``wavelet_granger_significance`` with the (S, C, E)
    trial permutations given."""
    w = _decimated_cwt(sigs, bank, int(time_decim), bool(interpolate))
    gc = _pairwise_assemble(_cross_from_tableau(w), n_iter)
    surr = torch.stack([_cross_from_tableau(w, p) for p in perms])
    gc_surr = _pairwise_assemble(surr, n_iter)
    count = (gc_surr >= gc[None]).sum(0)
    p = (count + 1.0) / (perms.shape[0] + 1.0)
    eye = torch.eye(gc.shape[-1], dtype=torch.bool, device=gc.device)
    return gc, torch.where(eye, torch.ones_like(p), p)


def wavelet_granger_significance(sigs_r, sfreq: float,
                                 n_surrogates: int = 19, seed: int = 0,
                                 n_bins: int = 65, time_decim: int = 16,
                                 n_iter: int = 60,
                                 interpolate: bool = True, device=None):
    """``(gc, p)``: time-resolved pairwise GC plus trial-shuffle surrogate
    p-values.

    Each surrogate independently permutes every channel's trial axis before
    the cross spectra: per-channel spectra and trial counts are kept while
    the cross-trial alignment (and so any true directed coupling) is
    destroyed, the standard nonparametric GC null.  All surrogates
    factorize in one batched Wilson pass.  ``p`` is the (1 + count) /
    (n + 1) exceedance of the observed GC per (time, frequency, direction)
    cell (diagonal 1).  The permutations come from a ``torch.Generator``
    seeded with ``seed``: one seed gives other surrogates than the JAX
    package's.
    """
    sigs, bank = _granger_inputs(sigs_r, sfreq, n_bins, interpolate,
                                 device=device)
    e, c, _ = sigs.shape
    perms = _trial_perms(int(n_surrogates), c, e, seed, sigs.device)
    return _significance_from_perms(sigs, bank, perms, time_decim, n_iter,
                                    interpolate)
