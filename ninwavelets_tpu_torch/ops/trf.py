"""Temporal response functions (mTRF; Crosse et al. 2016), port of
``ninwavelets_tpu.ops.trf``: ridge-regression encoding models from
continuous stimuli to continuous responses, ``r(t) = sum_k sum_l w[k, l]
s_k(t - lag_l) + noise``.

The Gram matrix of the lagged design is one (K*L, N) @ (N, K*L) product
over the stacked shifted copies and the solve one (K*L, K*L) system for
all response channels (``torch.linalg.solve_ex``: no error check, so the
card is not synced), both in full float32 (``fp32_matmul("exact")``).
Cross-validation folds are contiguous time blocks.  A numpy input goes to
``device`` (the card when None); a tensor stays on its device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import as_float32
from .scattering import fp32_matmul

__all__ = ["TRFResult", "lagged_design", "trf_fit", "trf_predict",
           "trf_cv"]


class TRFResult(NamedTuple):
    """Fitted encoding model: ``weights`` (C, K, L) response channel x
    stimulus feature x lag, ``lags`` (L,) sample offsets (positive: the
    response follows the stimulus), ``lam`` the ridge used."""
    weights: torch.Tensor
    lags: np.ndarray
    lam: float


def _as2d(x, device=None):
    x = as_float32(x, device)
    return x[None] if x.ndim == 1 else x


def lagged_design(stim, lags, device=None) -> torch.Tensor:
    """(K, N) stimulus -> (K, L, N) stack of lagged copies:
    ``out[k, l, t] = s_k(t - lags[l])`` (zero-padded edges)."""
    stim = _as2d(stim, device)
    n = stim.shape[-1]
    out = stim.new_zeros((stim.shape[0], len(lags), n))
    for i, lag in enumerate(int(v) for v in lags):
        if lag >= 0:
            if lag < n:
                out[:, i, lag:] = stim[:, :n - lag]
        elif -lag < n:
            out[:, i, :n + lag] = stim[:, -lag:]
    return out


def _gram_jit(stim, resp, *, lags):
    x = lagged_design(stim, lags)
    k, l, n = x.shape
    xf = x.reshape(k * l, n)
    with fp32_matmul("exact"):
        return xf @ xf.T, xf @ resp.T                 # (KL, KL), (KL, C)


def _solve_jit(xtx, xty, lam):
    kl = xtx.shape[0]
    a = xtx + lam * torch.trace(xtx) / kl * torch.eye(
        kl, dtype=xtx.dtype, device=xtx.device)
    with fp32_matmul("exact"):
        return torch.linalg.solve_ex(a, xty)[0]       # (KL, C)


def _weights(w, c, k, n_lags):
    return w.T.reshape(c, k, n_lags)


def trf_fit(stim, resp, lags, lam: float = 1e-2, device=None) -> TRFResult:
    """Fit a multivariate TRF: stimulus (K, N) (or (N,)) -> response
    (C, N), ridge ``lam`` relative to the mean design variance.  ``lags``
    are SAMPLE offsets (e.g. ``range(0, 64)``)."""
    stim = _as2d(stim, device)
    resp = _as2d(resp, stim.device)
    if stim.shape[-1] != resp.shape[-1]:
        raise ValueError("stimulus and response must share the time axis")
    lags_t = tuple(int(v) for v in lags)
    if not lags_t:
        raise ValueError("need at least one lag")
    xtx, xty = _gram_jit(stim, resp, lags=lags_t)
    w = _solve_jit(xtx, xty, float(np.float32(lam)))
    return TRFResult(weights=_weights(w, resp.shape[0], stim.shape[0],
                                      len(lags_t)),
                     lags=np.asarray(lags_t), lam=float(lam))


def _predict_jit(weights, stim, *, lags):
    x = lagged_design(stim, lags)                     # (K, L, N)
    c, k, l = weights.shape
    with fp32_matmul("exact"):
        return weights.reshape(c, k * l) @ x.reshape(k * l, -1)


def trf_predict(result: TRFResult, stim) -> torch.Tensor:
    """Predicted response (C, N) from a fitted TRF and a (K, N)
    stimulus."""
    stim = _as2d(stim, result.weights.device)
    return _predict_jit(result.weights, stim,
                        lags=tuple(int(v) for v in result.lags))


def trf_cv(stim, resp, lags, lams=(1e-4, 1e-3, 1e-2, 1e-1, 1.0),
           n_folds: int = 5, device=None):
    """Cross-validated TRF over contiguous-block folds, every ridge of
    ``lams`` scored per fold from one pair of Gram matrices.  Returns
    ``(result, r, best_lam)``: the model refitted on all data at the
    winning lam, the (C,) mean held-out Pearson r per response channel at
    that lam (host numpy), and the lam."""
    stim = _as2d(stim, device)
    resp = _as2d(resp, stim.device)
    if stim.shape[-1] != resp.shape[-1]:
        raise ValueError("stimulus and response must share the time axis")
    n = stim.shape[-1]
    nf = int(n_folds)
    if n < 4 * nf:
        raise ValueError("recording too short for the fold count")
    lags_t = tuple(int(v) for v in lags)
    edges = np.linspace(0, n, nf + 1).astype(int)
    lams = tuple(float(v) for v in lams)
    rs = []
    for f in range(nf):
        lo, hi = int(edges[f]), int(edges[f + 1])
        tr_stim = torch.cat([stim[:, :lo], stim[:, hi:]], -1)
        tr_resp = torch.cat([resp[:, :lo], resp[:, hi:]], -1)
        xtx, xty = _gram_jit(tr_stim, tr_resp, lags=lags_t)
        te_stim, te_resp = stim[:, lo:hi], resp[:, lo:hi]
        rc = te_resp - te_resp.mean(-1, keepdim=True)
        per_lam = []
        for lam in lams:
            w = _solve_jit(xtx, xty, float(np.float32(lam)))
            pred = _predict_jit(_weights(w, resp.shape[0], stim.shape[0],
                                         len(lags_t)), te_stim, lags=lags_t)
            pc = pred - pred.mean(-1, keepdim=True)
            denom = torch.sqrt((pc * pc).sum(-1) * (rc * rc).sum(-1))
            per_lam.append((pc * rc).sum(-1) / denom.clamp(min=1e-30))
        rs.append(torch.stack(per_lam))                # (lams, C)
    mean_r = torch.stack(rs, -1).double().mean(-1).cpu().numpy()
    best = int(np.argmax(mean_r.mean(-1)))
    final = trf_fit(stim, resp, lags_t, lam=lams[best])
    return final, mean_r[best], lams[best]
