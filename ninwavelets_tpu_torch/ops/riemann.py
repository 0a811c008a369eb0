"""Riemannian geometry of covariance matrices (port of
``ninwavelets_tpu.ops.riemann``): affine-invariant distances, the Karcher
mean, tangent-space features and the MDM and tangent-space LDA
classifiers (the pyRiemann workflow, Barachant 2012).

Every manifold primitive is a batched ``eigh`` of small (C, C) stacks:
``logm`` / ``expm`` / ``sqrtm`` transform the eigenvalues and sandwich
back.  The Karcher mean is the fixed point ``G <- G^{1/2} exp(mean_k
log(G^{-1/2} C_k G^{-1/2})) G^{1/2}``, a fixed number of steps.  The
cross-validation folds are batched, as the JAX package vmaps them: each
Karcher step is one (n_folds, C, C) ``eigh`` and one (n_folds, E, C, C)
``eigh``, not a loop over folds.  A zero weight excludes a trial exactly.
Every product runs inside ``fp32_matmul("exact")``.

A numpy input goes to ``device`` (the card when None); a tensor stays on
its device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import as_float32
from .decoding import _fold_masks, decode_auc
from .scattering import fp32_matmul, sym_eigh

__all__ = ["epoch_covariances", "spd_logm", "spd_expm", "spd_sqrtm",
           "riemannian_distance", "riemannian_mean", "tangent_space",
           "mdm_decode", "tangent_decode"]


def _sandwich(v, d):
    """``v diag(d) v^T`` over a batch."""
    with fp32_matmul("exact"):
        return (v * d[..., None, :]) @ v.transpose(-1, -2)


def epoch_covariances(x, shrink=0.05, device=None) -> torch.Tensor:
    """(E, C, N) -> (E, C, C) per-trial covariance shrunk toward the
    scaled identity: a fixed relative weight, or ``"lw"`` for each trial's
    Ledoit-Wolf intensity (``ops.spatial.ledoit_wolf``)."""
    x = as_float32(x, device)
    if x.ndim != 3:
        raise ValueError("x must be (E, C, N)")
    if isinstance(shrink, str):
        if shrink != "lw":
            raise ValueError("shrink must be a float or 'lw'")
        from .spatial import _lw_jit
        return _lw_jit(x)[0]
    xm = x - x.mean(-1, keepdim=True)
    with fp32_matmul("exact"):
        c = (xm @ xm.transpose(1, 2)) / x.shape[-1]
    tr = torch.diagonal(c, dim1=-2, dim2=-1).sum(-1) / x.shape[1]
    eye = torch.eye(x.shape[1], dtype=c.dtype, device=c.device)
    return (1.0 - shrink) * c + shrink * tr[:, None, None] * eye


def _eig_fn(p, fn):
    d, v = sym_eigh(p)
    d = torch.maximum(d, 1e-12 * d[..., -1:])
    return _sandwich(v, fn(d))


def spd_logm(p) -> torch.Tensor:
    """Batched matrix logarithm of SPD stacks (eigh-based)."""
    return _eig_fn(as_float32(p), torch.log)


def spd_expm(p) -> torch.Tensor:
    """Batched matrix exponential of symmetric stacks."""
    d, v = sym_eigh(as_float32(p))
    return _sandwich(v, torch.exp(d))


def spd_sqrtm(p) -> torch.Tensor:
    """Batched matrix square root of SPD stacks."""
    return _eig_fn(as_float32(p), torch.sqrt)


def _isqrtm(p):
    return _eig_fn(p, lambda d: 1.0 / torch.sqrt(d))


def riemannian_distance(a, b) -> torch.Tensor:
    """Affine-invariant distance ``|| logm(A^{-1/2} B A^{-1/2}) ||_F``
    between SPD stacks (batch dims broadcast)."""
    a = as_float32(a)
    b = as_float32(b, a.device)
    ia = _isqrtm(a)
    with fp32_matmul("exact"):
        m = (ia @ b) @ ia
    lg = spd_logm(m)
    return torch.sqrt((lg * lg).sum((-2, -1)))


def _karcher_jit(covs, weights, *, n_iter):
    """Weighted Karcher mean of (E, C, C) with weights (..., E) summing to
    1: (..., C, C), the leading weight dims a batch (the CV folds)."""
    with fp32_matmul("exact"):
        g = torch.tensordot(weights, covs, dims=([-1], [0]))
    g = 0.5 * (g + g.transpose(-1, -2))
    for _ in range(int(n_iter)):
        # one eigh serves both the sqrt and inverse-sqrt factors
        d, v = sym_eigh(g)
        d = torch.maximum(d, 1e-12 * d[..., -1:])
        gs = _sandwich(v, torch.sqrt(d))
        gis = _sandwich(v, 1.0 / torch.sqrt(d))
        with fp32_matmul("exact"):
            m = (gis[..., None, :, :] @ covs) @ gis[..., None, :, :]
            t = (weights[..., None, None] * spd_logm(m)).sum(-3)
            g_new = (gs @ spd_expm(t)) @ gs
        g = 0.5 * (g_new + g_new.transpose(-1, -2))   # re-symmetrize
    return g


def riemannian_mean(covs, weights=None, n_iter: int = 15) -> torch.Tensor:
    """Karcher (geometric) mean of an (E, C, C) SPD stack under the
    affine-invariant metric; ``weights`` default uniform."""
    covs = as_float32(covs)
    if covs.ndim != 3 or covs.shape[-1] != covs.shape[-2]:
        raise ValueError("covs must be (E, C, C)")
    e = covs.shape[0]
    if weights is None:
        weights = torch.full((e,), 1.0 / e, dtype=torch.float32,
                             device=covs.device)
    else:
        weights = as_float32(weights, covs.device)
        weights = weights / weights.sum()
    return _karcher_jit(covs, weights, n_iter=int(n_iter))


def _triu_weights(c, device):
    iu, ju = np.triu_indices(c)
    w = np.where(iu == ju, 1.0, np.sqrt(2.0)).astype(np.float32)
    return (torch.from_numpy(iu).to(device), torch.from_numpy(ju).to(device),
            torch.from_numpy(w).to(device))


def tangent_space(covs, ref) -> torch.Tensor:
    """Project an (E, C, C) SPD stack to the tangent space at ``ref``
    ((C, C), or (..., C, C) for one reference per batch): the upper
    triangle of ``logm(ref^{-1/2} C_e ref^{-1/2})`` with sqrt(2)-weighted
    off-diagonals, (..., E, C(C+1)/2)."""
    covs = as_float32(covs)
    ref = as_float32(ref, covs.device)
    ir = _isqrtm(ref)[..., None, :, :]
    with fp32_matmul("exact"):
        m = (ir @ covs) @ ir
    s = spd_logm(m)
    iu, ju, w = _triu_weights(s.shape[-1], s.device)
    return s[..., iu, ju] * w


def _karcher_masked(covs, w, n_iter):
    """Weighted Karcher mean with unnormalized (..., E) weights."""
    return _karcher_jit(covs, w / w.sum(-1, keepdim=True), n_iter=n_iter)


def _mdm_cv_jit(ca, cb, *, n_folds, n_iter):
    tr_a = _fold_masks(ca.shape[0], n_folds, ca.device)
    tr_b = _fold_masks(cb.shape[0], n_folds, cb.device)
    te_a, te_b = 1.0 - tr_a, 1.0 - tr_b
    ma = _karcher_masked(ca, tr_a, n_iter)[:, None]    # (F, 1, C, C)
    mb = _karcher_masked(cb, tr_b, n_iter)[:, None]
    daa = riemannian_distance(ca, ma)                  # (F, Ea)
    dab = riemannian_distance(ca, mb)
    dba = riemannian_distance(cb, ma)
    dbb = riemannian_distance(cb, mb)
    correct = ((te_a * (daa < dab)).sum(1) + (te_b * (dbb < dba)).sum(1))
    total = te_a.sum(1) + te_b.sum(1)
    return correct.sum() / total.sum()


def mdm_decode(xa, xb, n_folds: int = 5, shrink: float = 0.05,
               n_iter: int = 15, device=None):
    """Cross-validated MDM (minimum distance to Riemannian mean) accuracy
    between two-class epochs (Ea, C, N) vs (Eb, C, N): per fold each
    class's Karcher mean from the training trials, held-out trials labeled
    by the smaller distance.  Returns the accuracy (0.5 = chance)."""
    ca, cb, nf = _decode_setup(xa, xb, n_folds, shrink, device)
    return float(_mdm_cv_jit(ca, cb, n_folds=nf, n_iter=int(n_iter)))


def _tangent_fold_scores(ca, cb, *, n_folds, n_iter, lam):
    """Per fold, the pooled training trials' Karcher mean as the tangent
    reference and a ridge LDA on the tangent vectors: the (n_folds, Ea)
    and (n_folds, Eb) decision scores and the train masks."""
    tr_a = _fold_masks(ca.shape[0], n_folds, ca.device)
    tr_b = _fold_masks(cb.shape[0], n_folds, cb.device)
    covs = torch.cat([ca, cb], 0)
    ref = _karcher_masked(covs, torch.cat([tr_a, tr_b], 1), n_iter)
    fa, fb = tangent_space(ca, ref), tangent_space(cb, ref)  # (F, E, D)
    na, nb = tr_a.sum(1), tr_b.sum(1)
    with fp32_matmul("exact"):
        mu_a = (tr_a[:, None, :] @ fa)[:, 0] / na[:, None]
        mu_b = (tr_b[:, None, :] @ fb)[:, 0] / nb[:, None]
        da, db = fa - mu_a[:, None], fb - mu_b[:, None]
        cov = ((da * tr_a[..., None]).transpose(1, 2) @ da
               + (db * tr_b[..., None]).transpose(1, 2) @ db) \
            / (na + nb - 2.0).clamp(min=1.0)[:, None, None]
        d = cov.shape[-1]
        tr = torch.diagonal(cov, dim1=-2, dim2=-1).sum(-1)
        cov = cov + (lam * tr / d)[:, None, None] * torch.eye(
            d, dtype=cov.dtype, device=cov.device)
        wvec = torch.linalg.solve_ex(cov, (mu_a - mu_b)[..., None])[0]
        return (fa @ wvec)[..., 0], (fb @ wvec)[..., 0], tr_a, tr_b


def _tangent_cv_jit(ca, cb, *, n_folds, n_iter, lam):
    sa, sb, tr_a, tr_b = _tangent_fold_scores(ca, cb, n_folds=n_folds,
                                              n_iter=n_iter, lam=lam)
    aucs = [decode_auc(sa[f], sb[f], 1.0 - tr_a[f], 1.0 - tr_b[f])
            for f in range(n_folds)]
    return torch.stack(aucs).mean()


def tangent_decode(xa, xb, n_folds: int = 5, shrink: float = 0.05,
                   n_iter: int = 15, lam: float = 1e-3, device=None):
    """Cross-validated tangent-space LDA AUC between two-class epochs: per
    fold the pooled training trials' Karcher mean is the tangent
    reference, and a ridge LDA scores the held-out trials (ROC AUC, 0.5 =
    chance)."""
    ca, cb, nf = _decode_setup(xa, xb, n_folds, shrink, device)
    return float(_tangent_cv_jit(ca, cb, n_folds=nf, n_iter=int(n_iter),
                                 lam=float(lam)))


def _decode_setup(xa, xb, n_folds, shrink, device=None):
    xa = as_float32(xa, device)
    xb = as_float32(xb, xa.device)
    if xa.ndim != 3 or xb.ndim != 3 or xa.shape[1:] != xb.shape[1:]:
        raise ValueError("expected (Ea, C, N) and (Eb, C, N) with "
                         "matching (C, N)")
    nf = int(n_folds)
    if min(xa.shape[0], xb.shape[0]) < nf:
        raise ValueError("need at least n_folds trials per class")
    return epoch_covariances(xa, shrink), epoch_covariances(xb, shrink), nf
