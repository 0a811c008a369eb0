"""Time-frequency decoding (MVPA), CSP decoding and SSVEP recognition
(port of ``ninwavelets_tpu.ops.decoding``): cross-validated two-class
decoding from the multichannel pattern at every time-frequency pixel
(diagonal LDA, ``w = (mu_a - mu_b) / (pooled_var + lam)``, ROC AUC on the
held-out trials), the temporal generalization matrix, CSP + LDA and
CCA-SSVEP.

The folds are the JAX package's static round-robin assignment.  The AUC
counts correctly ranked held-out pairs, ties 0.5: every partial sum is a
multiple of 0.5 below 2^23, so the count is exact in any order, and only
the held-out trials of each class enter it.  A pair whose score difference
is within round-off may still rank the other way than in the JAX package
and move an AUC by 1 / (na nb).  The pairwise comparison takes the
class-a trials in chunks whose (chunk, Eb, plane) comparison tensor stays
under ``_AUC_BYTES``; the plane statistics take the trials in chunks
under ``_PLANE_BYTES``, so no temporary of the size of an input plane
stack is made.  Products run inside ``fp32_matmul("exact")``.

``_tf_decode_jit`` keeps the JAX package's name.  A numpy input goes to
``device`` (the card when None); a tensor stays on its device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import as_float32
from .scattering import fp32_matmul, sym_eigh

__all__ = ["csp_decode", "tf_decode", "decode_auc",
           "temporal_generalization", "cca_reference", "ssvep_cca"]

# the most bytes of one (chunk, Eb, plane) pairwise comparison tensor
_AUC_BYTES = 1 << 30
# the most bytes of a per-trial-chunk temporary over an (E, ...) stack
_PLANE_BYTES = 1 << 29


def _chunk(per_item_bytes: int, budget: int) -> int:
    return max(1, budget // max(per_item_bytes, 1))


def _masked_stats(x, keep):
    """Mean and variance over the trial axis of ``x`` (E, ...) using only
    the ``keep`` (E,) trials (0/1 weights): ((...,), (...,), count)."""
    cnt = keep.sum()
    plane = x[0].numel()
    step = _chunk(plane * 4, _PLANE_BYTES)
    with fp32_matmul("exact"):
        mean = torch.tensordot(keep, x, dims=([0], [0])) / cnt.clamp(min=1.0)
        var = torch.zeros_like(mean)
        for i in range(0, x.shape[0], step):
            d = x[i:i + step] - mean
            var += torch.tensordot(keep[i:i + step], d * d, dims=([0], [0]))
    return mean, var / (cnt - 1.0).clamp(min=1.0), cnt


def decode_auc(scores_a, scores_b, valid_a, valid_b):
    """Held-out ROC AUC per pixel from decision scores: the fraction of
    (class-a, class-b) pairs of valid trials ranked correctly (ties count
    half).  scores_* (E, ...); valid_* (E,) 0/1 masks."""
    ia = torch.nonzero(valid_a > 0)[:, 0]
    ib = torch.nonzero(valid_b > 0)[:, 0]
    sa = scores_a.index_select(0, ia)
    sb = scores_b.index_select(0, ib)
    wa = valid_a.index_select(0, ia)
    wb = valid_b.index_select(0, ib)
    wb = wb.reshape(wb.shape + (1,) * (sb.ndim - 1))
    total = torch.zeros_like(scores_b[0])
    step = _chunk(sb.numel() * 4, _AUC_BYTES)
    for i in range(0, sa.shape[0], step):
        diff = sa[i:i + step, None] - sb[None]        # (chunk, Eb, ...)
        wins = torch.where(diff > 0, 1.0, torch.where(diff == 0, 0.5, 0.0))
        part = (wins * wb).sum(1)                     # (chunk, ...)
        with fp32_matmul("exact"):
            total += torch.tensordot(wa[i:i + step], part, dims=([0], [0]))
    n_pairs = (valid_a.sum() * valid_b.sum()).clamp(min=1.0)
    return total / n_pairs


def _fold_masks(e, n_folds, device):
    """(n_folds, E) 0/1 train masks of the round-robin folds."""
    ids = torch.arange(e, device=device) % n_folds
    return (ids[None, :] != torch.arange(n_folds, device=device)[:, None]
            ).to(torch.float32)


def _scores(x, w):
    """``einsum('ec...,c...->e...', x, w)`` in trial chunks."""
    step = _chunk(x[0].numel() * 4, _PLANE_BYTES)
    return torch.cat([(x[i:i + step] * w).sum(1)
                      for i in range(0, x.shape[0], step)])


def _lda_weights(xa, xb, keep_a, keep_b, lam):
    """Diagonal-LDA weights ``(mu_a - mu_b) / (pooled_var + lam)`` of the
    kept trials, per feature (no bias term: the AUC depends only on score
    differences)."""
    m0, v0, n0 = _masked_stats(xa, keep_a)
    m1, v1, n1 = _masked_stats(xb, keep_b)
    pooled = ((n0 - 1.0) * v0 + (n1 - 1.0) * v1) \
        / (n0 + n1 - 2.0).clamp(min=1.0)
    return (m0 - m1) / (pooled + lam)


def _tf_decode_jit(xa, xb, *, n_folds, lam, vma_axes=()):
    """Mean held-out AUC map over the folds (``vma_axes`` is accepted for
    the JAX package's signature)."""
    tr_a = _fold_masks(xa.shape[0], n_folds, xa.device)
    tr_b = _fold_masks(xb.shape[0], n_folds, xb.device)
    auc = torch.zeros(xa.shape[2:], dtype=torch.float32, device=xa.device)
    for f in range(n_folds):
        w = _lda_weights(xa, xb, tr_a[f], tr_b[f], lam)   # (C, F, N)
        auc += decode_auc(_scores(xa, w), _scores(xb, w), 1.0 - tr_a[f],
                          1.0 - tr_b[f])
    return auc / n_folds


def tf_decode(xa, xb, n_folds: int = 5, lam: float = 1e-3,
              device=None) -> torch.Tensor:
    """(F, N) cross-validated decoding AUC between two trial groups of
    single-trial feature planes (Ea, C, F, N) vs (Eb, C, F, N): diagonal
    LDA per pixel, ``n_folds``-fold round-robin CV, ROC AUC on held-out
    trials (0.5 = chance); ``lam`` floors the pooled variance."""
    xa = as_float32(xa, device)
    xb = as_float32(xb, xa.device)
    if xa.ndim != 4 or xb.ndim != 4 or xa.shape[1:] != xb.shape[1:]:
        raise ValueError("expected (Ea, C, F, N) and (Eb, C, F, N) with "
                         "matching planes, got %s and %s"
                         % (tuple(xa.shape), tuple(xb.shape)))
    if min(xa.shape[0], xb.shape[0]) < n_folds:
        raise ValueError("need at least n_folds trials per class")
    return _tf_decode_jit(xa, xb, n_folds=int(n_folds), lam=float(lam))


def _temporal_gen_jit(xa, xb, *, n_folds, lam):
    tr_a = _fold_masks(xa.shape[0], n_folds, xa.device)
    tr_b = _fold_masks(xb.shape[0], n_folds, xb.device)
    t = xa.shape[-1]
    auc = torch.zeros((t, t), dtype=torch.float32, device=xa.device)
    for f in range(n_folds):
        w = _lda_weights(xa, xb, tr_a[f], tr_b[f], lam)   # (C, T_train)
        with fp32_matmul("exact"):
            sa = w.T @ xa                             # (E, T_train, T_test)
            sb = w.T @ xb
        auc += decode_auc(sa, sb, 1.0 - tr_a[f], 1.0 - tr_b[f])
    return auc / n_folds


def temporal_generalization(xa, xb, n_folds: int = 5, lam: float = 1e-3,
                            device=None) -> torch.Tensor:
    """(T, T) temporal generalization matrix (King & Dehaene 2014):
    ``out[t_train, t_test]`` is the cross-validated AUC of a diagonal-LDA
    decoder fit on the channel pattern at ``t_train`` and tested at
    ``t_test``, from (Ea, C, T) vs (Eb, C, T) feature courses."""
    xa = as_float32(xa, device)
    xb = as_float32(xb, xa.device)
    if xa.ndim != 3 or xb.ndim != 3 or xa.shape[1:] != xb.shape[1:]:
        raise ValueError("expected (Ea, C, T) and (Eb, C, T) with "
                         "matching planes, got %s and %s"
                         % (tuple(xa.shape), tuple(xb.shape)))
    if min(xa.shape[0], xb.shape[0]) < n_folds:
        raise ValueError("need at least n_folds trials per class")
    return _temporal_gen_jit(xa, xb, n_folds=int(n_folds), lam=float(lam))


def _fold_covs_jit(x, *, n_folds):
    """(n_folds, C, C) train covariances: the per-epoch covariance stack
    contracted against the round-robin train masks."""
    xc = x - x.mean(2, keepdim=True)
    tr = _fold_masks(x.shape[0], n_folds, x.device)
    with fp32_matmul("exact"):
        cov = (xc @ xc.transpose(1, 2)) / float(x.shape[-1] - 1)
        out = torch.tensordot(tr, cov, dims=([1], [0]))
    return out / tr.sum(1)[:, None, None]


def _fold_ged_jit(covs_a, covs_b, *, n_components, shrink):
    """(n_folds, C, K) per-fold CSP filters: one batched generalized
    eigensolve over the fold axis."""
    from .spatial import _csp_select, _ged_core
    c = covs_a.shape[-1]
    _, filt, _ = _ged_core(covs_a, covs_a + covs_b, shrink)
    return filt[:, :, _csp_select(c, n_components).to(filt.device)]


def _csp_fold_scores(xa, xb, filters, *, n_folds, lam):
    """Per-fold CSP + LDA decision scores given per-fold filters (n_folds,
    C, K): log-relative-variance features and a full (K, K) LDA per fold
    (pooled feature covariance, ridge ``lam``).  Returns the (n_folds, Ea)
    and (n_folds, Eb) scores and the train masks."""
    tr_a = _fold_masks(xa.shape[0], n_folds, xa.device)
    tr_b = _fold_masks(xb.shape[0], n_folds, xb.device)

    def feats(x):
        # (n_folds, E, K) log relative variance of the filtered epochs
        with fp32_matmul("exact"):
            src = filters.transpose(1, 2)[:, None] @ x[None]
        v = src.var(3, correction=0)
        return torch.log((v / v.sum(2, keepdim=True)).clamp(min=1e-30))

    fa, fb = feats(xa), feats(xb)

    def moments(feat, keep):
        cnt = keep.sum(1)                              # (n_folds,)
        mean = (feat * keep[..., None]).sum(1) / cnt.clamp(min=1.0)[:, None]
        d = (feat - mean[:, None]) * keep[..., None]
        with fp32_matmul("exact"):
            cov = d.transpose(1, 2) @ d
        return mean, cov, cnt

    m0, s0, n0 = moments(fa, tr_a)
    m1, s1, n1 = moments(fb, tr_b)
    pooled = (s0 + s1) / (n0 + n1 - 2.0).clamp(min=1.0)[:, None, None]
    eye = torch.eye(pooled.shape[-1], dtype=pooled.dtype,
                    device=pooled.device)
    with fp32_matmul("exact"):
        w = torch.linalg.solve_ex(pooled + lam * eye,
                                  (m0 - m1)[..., None])[0][..., 0]
    return ((fa * w[:, None]).sum(-1), (fb * w[:, None]).sum(-1), tr_a,
            tr_b)


def _csp_fold_auc_jit(xa, xb, filters, *, n_folds, lam):
    """Mean held-out AUC given per-fold CSP filters (n_folds, C, K)."""
    sa, sb, tr_a, tr_b = _csp_fold_scores(xa, xb, filters, n_folds=n_folds,
                                          lam=lam)
    auc = sum(decode_auc(sa[f], sb[f], 1.0 - tr_a[f], 1.0 - tr_b[f])
              for f in range(n_folds))
    return auc / n_folds


def csp_decode(xa, xb, n_folds: int = 5, n_components: int = 4,
               shrink: float = 0.01, lam: float = 1e-3,
               f_lo=None, f_hi=None, sfreq=None,
               device=None) -> torch.Tensor:
    """Cross-validated CSP + LDA decoding AUC between two-class epochs
    (Ea, C, N) vs (Eb, C, N): per-fold train covariances, one batched
    generalized eigensolve for every fold's CSP filters, then
    log-relative-variance features, a (K, K) ridge LDA and the held-out
    ROC AUC.  ``f_lo`` / ``f_hi`` / ``sfreq`` bandpass both classes first.
    Returns a scalar AUC (0.5 = chance)."""
    from .spatial import _band_pair
    xa = as_float32(xa, device)
    xb = as_float32(xb, xa.device)
    if xa.ndim != 3 or xb.ndim != 3 or xa.shape[1:] != xb.shape[1:]:
        raise ValueError("expected (Ea, C, N) and (Eb, C, N) with "
                         "matching (C, N)")
    if min(xa.shape[0], xb.shape[0]) < n_folds:
        raise ValueError("need at least n_folds trials per class")
    xa, xb = _band_pair(xa, xb, f_lo, f_hi, sfreq)
    k = int(n_components)
    if not (1 <= k <= xa.shape[1]):
        raise ValueError("n_components must be in [1, C]")
    nf = int(n_folds)
    filters = _fold_ged_jit(_fold_covs_jit(xa, n_folds=nf),
                            _fold_covs_jit(xb, n_folds=nf), n_components=k,
                            shrink=float(shrink))
    return _csp_fold_auc_jit(xa, xb, filters, n_folds=nf, lam=float(lam))


# -- SSVEP: canonical correlation against sinusoidal references --------------

def cca_reference(freqs, n: int, sfreq: float, n_harmonics: int = 3,
                  device=None) -> torch.Tensor:
    """(F, 2H, N) sinusoidal reference set per stimulus frequency: sin /
    cos pairs at the fundamental and ``n_harmonics - 1`` harmonics (Lin
    et al. 2006), built in float64 on the host."""
    freqs = np.asarray(list(freqs), np.float64)
    t = np.arange(n) / float(sfreq)
    rows = []
    for f0 in freqs:
        comps = []
        for h in range(1, int(n_harmonics) + 1):
            comps.append(np.sin(2 * np.pi * h * f0 * t))
            comps.append(np.cos(2 * np.pi * h * f0 * t))
        rows.append(np.stack(comps))
    return as_float32(np.stack(rows).astype(np.float32), device)


def _cca_rho_jit(x, refs, *, lam):
    """Largest canonical correlation of every (trial, frequency) pair,
    x (E, C, N), refs (F, R, N) -> (E, F): the square root of the top
    eigenvalue of M M^T, M = Cxx^{-1/2} Cxy Cyy^{-1/2}."""
    xm = x - x.mean(-1, keepdim=True)
    rm = refs - refs.mean(-1, keepdim=True)
    n = x.shape[-1]

    def isqrt(m):
        d, v = sym_eigh(m)
        d = torch.maximum(d, lam * d[..., -1:])
        return (v / torch.sqrt(d)[..., None, :]) @ v.transpose(-1, -2)

    with fp32_matmul("exact"):
        cxx = (xm @ xm.transpose(1, 2)) / n
        cyy = (rm @ rm.transpose(1, 2)) / n
        cxy = (xm[:, None] @ rm.transpose(1, 2)[None]) / n  # (E, F, C, R)
        ix = isqrt(cxx)                                    # (E, C, C)
        iy = isqrt(cyy)                                    # (F, R, R)
        m = (ix[:, None] @ cxy) @ iy[None]                 # (E, F, C, R)
        mmt = m @ m.transpose(-1, -2)
    vals = sym_eigh(mmt)[0]
    return torch.sqrt(vals[..., -1].clamp(0.0, 1.0))


def ssvep_cca(x, freqs, sfreq: float, n_harmonics: int = 3,
              lam: float = 1e-6, device=None):
    """CCA-based SSVEP frequency recognition (Lin 2006): per trial the
    canonical correlation of the (C, N) EEG with each stimulus frequency's
    sin / cos references; the label is the argmax.  Returns ``(labels (E,)
    int32 indices into freqs, rho (E, F))``."""
    x = as_float32(x, device)
    if x.ndim == 2:
        x = x[None]
    if x.ndim != 3:
        raise ValueError("x must be (E, C, N)")
    freqs = list(freqs)
    if not freqs:
        raise ValueError("need at least one stimulus frequency")
    refs = cca_reference(freqs, x.shape[-1], sfreq, n_harmonics,
                         device=x.device)
    rho = _cca_rho_jit(x, refs, lam=float(lam))
    return rho.argmax(-1).to(torch.int32), rho
