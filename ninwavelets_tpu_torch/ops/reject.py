"""Automated epoch rejection and channel QC (port of
``ninwavelets_tpu.ops.reject``): peak-to-peak thresholds, the
cross-validated global threshold search (Jas et al. 2017, "global
autoreject"), least-squares regression of reference channels (Gratton &
Coles) and PREP-style bad-channel detection (Bigdely-Shamlo 2015).

Rejection is masking: keep masks are (T, E) 0/1 weights, so the kept-trial
evoked means of every candidate threshold are one (T, E) @ (E, C*N)
product a fold.  The folds are the JAX package's round-robin assignment of
a seeded ``np.random.default_rng`` permutation (host numpy), so both
packages score the same folds.  The validation target is each fold's
pointwise median evoked, the mean of the two middle trials for an even
count (``jnp.nanmedian``'s; ``torch.median`` takes the lower).  The
candidate grid is the JAX package's linear quantiles, computed the same
way (``low * (1 - w) + high * w`` at float32 ranks).

Every product the JAX package runs at ``Precision.HIGHEST`` runs inside
``fp32_matmul("exact")``.  A numpy input goes to ``device`` (the card when
None); a tensor stays on its device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import as_float32
from .denoise import _median
from .irasa import welch_psd
from .scattering import fp32_matmul

__all__ = ["ptp", "ptp_reject", "autoreject_global", "RejectResult",
           "regress_out", "find_bad_channels"]


class RejectResult(NamedTuple):
    """Outcome of the global threshold search.

    ``threshold`` float: the winning peak-to-peak threshold.
    ``drop_mask`` (E,) bool: True where the trial exceeds it (drop).
    ``thresholds`` (T,): the candidate grid.  ``cv_error`` (T,): mean
    validation RMSE per candidate (lower is better).
    """
    threshold: float
    drop_mask: torch.Tensor
    thresholds: torch.Tensor
    cv_error: torch.Tensor


def ptp(x, device=None) -> torch.Tensor:
    """(..., N) -> (...,) peak-to-peak amplitude (max - min)."""
    x = as_float32(x, device)
    return x.amax(-1) - x.amin(-1)


def ptp_reject(x, threshold: float, device=None) -> torch.Tensor:
    """(E, C, N) -> (E,) bool drop mask: True where ANY channel's
    peak-to-peak exceeds ``threshold`` (the mne ``reject`` rule)."""
    x = as_float32(x, device)
    if x.ndim != 3:
        raise ValueError("x must be (E, C, N)")
    return ptp(x).amax(-1) > threshold


def _quantiles(v: torch.Tensor, n: int) -> torch.Tensor:
    """``jnp.quantile(v, jnp.linspace(0, 1, n))``: linear interpolation at
    the float32 ranks ``q (len - 1)``, weighted as the JAX package
    weighs."""
    q = torch.cat([torch.arange(n - 1, dtype=torch.float32,
                                device=v.device) / float(n - 1),
                   torch.ones(1, dtype=torch.float32, device=v.device)]) \
        if n > 1 else torch.zeros(1, dtype=torch.float32, device=v.device)
    s = torch.sort(v).values
    rank = q * float(v.shape[0] - 1)
    low = rank.floor()
    hw = rank - low
    lw = 1.0 - hw
    lo = low.to(torch.int64).clamp(0, v.shape[0] - 1)
    hi = rank.ceil().to(torch.int64).clamp(0, v.shape[0] - 1)
    return s[lo] * lw + s[hi] * hw


def _cv_errors(x, thresholds, fold_ids, *, n_folds):
    """(T,) mean validation RMSE of the kept-trial evoked vs the
    fold-validation MEDIAN evoked, for every candidate threshold.
    ``fold_ids`` is host numpy (E,)."""
    e = x.shape[0]
    trial_ptp = ptp(x).amax(-1)                            # (E,)
    keep = (trial_ptp[None, :] <= thresholds[:, None]).to(torch.float32)
    flat = x.reshape(e, -1)                                # (E, C*N)
    errs = []
    for k in range(int(n_folds)):
        train = torch.from_numpy((fold_ids != k).astype(np.float32)).to(
            x.device)
        w = keep * train[None, :]                          # (T, E)
        cnt = w.sum(1, keepdim=True)
        with fp32_matmul("exact"):
            mean_kept = (w @ flat) / cnt.clamp(min=1.0)    # (T, C*N)
        val = torch.from_numpy(np.flatnonzero(fold_ids == k)).to(x.device)
        target = _median(flat.index_select(0, val).T)      # (C*N,)
        err = (mean_kept - target[None, :]).square().mean(1).sqrt()
        errs.append(torch.where(cnt[:, 0] > 0, err,
                                torch.full_like(err, float("inf"))))
    return torch.stack(errs).mean(0)


def autoreject_global(x, thresholds=None, n_candidates: int = 30,
                      n_folds: int = 5, seed: int = 0,
                      device=None) -> RejectResult:
    """Cross-validated global peak-to-peak threshold (Jas et al. 2017, the
    "global autoreject" variant) for an (E, C, N) epochs batch.

    For each candidate threshold, trials whose worst-channel peak-to-peak
    exceeds it are dropped from the training folds; the retained-trial
    evoked mean is scored against the validation folds' pointwise MEDIAN
    evoked, and the threshold with the lowest mean RMSE wins.
    ``thresholds`` defaults to ``n_candidates`` quantiles of the observed
    per-trial max peak-to-peak.  Returns a :class:`RejectResult`."""
    x = as_float32(x, device)
    if x.ndim != 3:
        raise ValueError("x must be (E, C, N)")
    e = x.shape[0]
    if e < max(int(n_folds), 2):
        raise ValueError(f"need at least n_folds={n_folds} epochs")
    if thresholds is None:
        thresholds = _quantiles(ptp(x).amax(-1), int(n_candidates))
    else:
        thresholds = as_float32(thresholds, x.device)
        if thresholds.ndim != 1 or thresholds.shape[0] < 1:
            raise ValueError("thresholds must be a 1-D grid")
    # round-robin fold assignment of a seeded permutation (host numpy, the
    # JAX package's folds)
    perm = np.random.default_rng(int(seed)).permutation(e)
    fold_ids = np.mod(np.argsort(perm), int(n_folds))
    errs = _cv_errors(x, thresholds, fold_ids, n_folds=int(n_folds))
    best = int(torch.argmin(errs))
    thr = float(thresholds[best])
    return RejectResult(threshold=thr, drop_mask=ptp_reject(x, thr),
                        thresholds=thresholds, cv_error=errs)


def _regress_out_jit(x, refs):
    xm = x - x.mean(-1, keepdim=True)
    rm = refs - refs.mean(-1, keepdim=True)
    with fp32_matmul("exact"):
        # beta = (R R^T)^{-1} R X^T per batch row: a tiny (K, K) solve
        g = rm @ rm.transpose(-1, -2)
        tr = torch.diagonal(g, dim1=-2, dim2=-1).sum(-1)
        g = g + 1e-9 * tr[..., None, None] * torch.eye(
            g.shape[-1], dtype=g.dtype, device=g.device)
        cross = rm @ xm.transpose(-1, -2)
        beta = torch.linalg.solve_ex(g, cross)[0]          # (..., K, C)
        return xm - beta.transpose(-1, -2) @ rm


def regress_out(x, refs, device=None) -> torch.Tensor:
    """Least-squares regression of reference channels out of (..., C, N)
    data (the classical EOG/ECG correction, Gratton & Coles): each data
    channel loses its best linear fit on the (..., K, N) references.  Both
    are mean-centered first; the (K, K) normal equations get a relative
    ridge so collinear references stay solvable.  Leading batch dims
    (epochs) broadcast."""
    x = as_float32(x, device)
    refs = as_float32(refs, x.device)
    if refs.ndim == 1:
        refs = refs[None, :]
    if x.shape[-1] != refs.shape[-1]:
        raise ValueError("x and refs must share the time axis")
    if x.ndim != refs.ndim:
        raise ValueError("x and refs need matching batch dims "
                         "(add a channel axis to 1-D refs)")
    return _regress_out_jit(x, refs)


def _chan_stats_jit(x, *, sfreq, hf_hz):
    """Per-channel QC statistics of a (C, N) recording: robust amplitude
    (1.4826 MAD of the centered signal), the log high / low frequency power
    ratio off one Welch pass, and the channel correlation matrix (zero
    diagonal) in full float32."""
    c, n = x.shape
    med = _median(x)[:, None]
    mad = _median((x - med).abs()) * 1.4826
    seg = 1 << min(10, int(np.log2(max(n, 4))))
    psd = welch_psd(x, sfreq=float(sfreq), nperseg=seg)
    freqs = torch.arange(seg // 2 + 1, device=x.device) * (sfreq / seg)
    hi = freqs[None, :] >= hf_hz
    hf = torch.where(hi, psd, 0.0).sum(1)
    lf = torch.where(~hi, psd, 0.0).sum(1)
    hf_ratio = torch.log(hf.clamp(min=1e-30) / lf.clamp(min=1e-30))
    xm = x - x.mean(1, keepdim=True)
    u = xm / torch.linalg.vector_norm(xm, dim=1, keepdim=True).clamp(
        min=1e-30)
    with fp32_matmul("exact"):
        corr = u @ u.T
    # zero the diagonal: self-pairs must not win best-|corr|
    corr = corr * (1.0 - torch.eye(c, dtype=corr.dtype, device=x.device))
    return mad, hf_ratio, corr


def _robust_z(v, mask, floor):
    """Robust z of ``v`` against the median/MAD of ``v[mask]``, the scale
    floored at ``floor`` (both criteria work in log units)."""
    ref = v[mask] if mask.any() else v
    med = np.median(ref)
    mad = np.median(np.abs(ref - med)) * 1.4826
    return (v - med) / max(mad, floor)


def find_bad_channels(x, sfreq: float, *, flat_tol: float = 1e-10,
                      z_thresh: float = 5.0, hf_hz: float = 40.0,
                      corr_thresh: float = 0.3,
                      bridge_thresh: float = 0.995, device=None) -> dict:
    """Channel-level QC of a (C, N) recording (PREP-style criteria).
    Returns a dict of index lists: ``flat`` (robust amplitude below
    ``flat_tol`` or 1000x below the channel median), ``noisy`` (robust z of
    the log amplitude above ``z_thresh``), ``hf`` (robust z of the log
    high / low power ratio split at ``hf_hz``; off when ``hf_hz >=
    sfreq/2``), ``uncorrelated`` (best |correlation| with the other good
    channels below ``corr_thresh``), ``bridged`` (pairs above
    ``bridge_thresh``) and ``bads`` (the union of the single-channel
    criteria, sorted).  The statistics run on the device; the thresholds
    on the host, as in the JAX package."""
    x = as_float32(x, device)
    if x.ndim != 2:
        raise ValueError("x must be (C, N)")
    c, n = x.shape
    if n < 8:
        raise ValueError("recording too short for channel QC")
    mad, hf, corr = (v.cpu().numpy() for v in
                     _chan_stats_jit(x, sfreq=float(sfreq),
                                     hf_hz=float(hf_hz)))
    med_amp = np.median(mad)
    flat = (mad < flat_tol) | (mad < 1e-3 * med_amp)
    good = ~flat
    la = np.log(np.maximum(mad, 1e-30))
    noisy = (_robust_z(la, good, 0.05) > z_thresh) & good
    if hf_hz >= sfreq / 2:          # empty high band: criterion off
        hf_bad = np.zeros(c, bool)
    else:
        hf_bad = (_robust_z(hf, good, 0.1) > z_thresh) & good
    corr = corr.copy()
    corr[flat, :] = 0.0
    corr[:, flat] = 0.0
    best = np.abs(corr).max(axis=1)
    uncorr = (best < corr_thresh) & good
    iu, ju = np.nonzero(np.triu(np.abs(corr) > bridge_thresh, 1))
    bads = sorted(set(np.flatnonzero(flat | noisy | hf_bad | uncorr)
                      .tolist()))
    return {"flat": np.flatnonzero(flat).tolist(),
            "noisy": np.flatnonzero(noisy).tolist(),
            "hf": np.flatnonzero(hf_bad).tolist(),
            "uncorrelated": np.flatnonzero(uncorr).tolist(),
            "bridged": list(zip(iu.tolist(), ju.tolist())),
            "bads": [int(b) for b in bads]}
