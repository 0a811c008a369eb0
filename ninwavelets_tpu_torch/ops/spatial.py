"""Spatial filtering by generalized eigendecomposition (port of
``ninwavelets_tpu.ops.spatial``): GED, CSP, SSD, correlated components
and xDAWN, with the Ledoit-Wolf covariance.

All are the generalized symmetric eigenproblem ``S w = lam R w``, solved
as the JAX package solves it: whiten with the symmetric inverse square
root of the shrunk R (one ``eigh``), then ``eigh`` the whitened S.
Filters come in descending eigenvalue order and each filter's sign makes
its pattern's largest-|.| coefficient positive, so order and sign do not
depend on the signs ``eigh`` gives its eigenvectors.  Patterns follow
Haufe 2014: ``(S w_k) / (w_k^T S w_k)``.  ``_ged_core`` takes stacks
(..., C, C), so ``ops.decoding`` solves every fold at once.  Every product
runs inside ``fp32_matmul("exact")``.  The band filters are
``ops.filtering``.

``_lw_jit``, ``_shrunk``, ``_ged_core``, ``_csp_select`` and
``_csp_from_covs`` keep the JAX package's names.  A numpy input goes to
``device`` (the card when None); a tensor stays on its device.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import as_float32
from . import filtering as _filt
from .scattering import fp32_matmul, sym_eigh

__all__ = [
    "SpatialResult", "covariance", "ledoit_wolf", "ged", "csp",
    "csp_features", "ssd", "spatial_apply", "corrca", "xdawn"]


class SpatialResult(NamedTuple):
    """Fitted spatial decomposition.  ``sources = filters.T @ x`` per
    epoch; ``patterns[:, k]`` is component k's forward topography."""
    filters: torch.Tensor    # (C, K) columns w_k
    patterns: torch.Tensor   # (C, K) Haufe forward models
    eigvals: torch.Tensor    # (K,) generalized eigenvalues, descending


def _eye(c, like):
    return torch.eye(c, dtype=like.dtype, device=like.device)


def _trace(m):
    return torch.diagonal(m, dim1=-2, dim2=-1).sum(-1)


def _cov_jit(x):
    e, c, n = x.shape
    xc = x - x.mean(2, keepdim=True)
    y = xc.transpose(0, 1).reshape(c, e * n)
    with fp32_matmul("exact"):
        cov = y @ y.T
    return cov / float(e * (n - 1))


def covariance(x, device=None) -> torch.Tensor:
    """Mean-removed channel covariance of (C, N) or of a stack of epochs
    (E, C, N) (per-epoch centering, epoch-summed, one normalizer)."""
    x = as_float32(x, device)
    if x.ndim == 2:
        x = x[None]
    if x.ndim != 3:
        raise ValueError(f"expected (C, N) or (E, C, N), got "
                         f"{tuple(x.shape)}")
    return _cov_jit(x)


def _lw_jit(x):
    """Ledoit-Wolf shrunk covariance and its weight of (..., C, N)."""
    c, n = x.shape[-2:]
    xc = x - x.mean(-1, keepdim=True)
    with fp32_matmul("exact"):
        s = (xc @ xc.transpose(-1, -2)) / n            # biased MLE cov
    mu = _trace(s) / c
    ss = (s * s).sum((-2, -1))
    d2 = (ss - c * mu * mu) / c
    # b^2 = (1/N^2) sum_n ||x_n x_n^T - S||_F^2 / C, its cross term
    # collapsed: sum_n ||x_n||^4 - N ||S||_F^2
    norm4 = ((xc * xc).sum(-2) ** 2).sum(-1)
    b2 = (norm4 / n - ss) / (n * c)
    b2 = torch.minimum(b2, d2)
    alpha = torch.where(d2 > 0, b2 / d2.clamp(min=1e-30),
                        torch.zeros_like(d2))
    a = alpha[..., None, None]
    return (1.0 - a) * s + a * mu[..., None, None] * _eye(c, s), alpha


def ledoit_wolf(x, device=None):
    """``(cov, shrinkage)``: the Ledoit-Wolf (2004) analytically shrunk
    covariance of a (C, N) recording (or (E, C, N) epochs, pooled after
    per-epoch centering), matching ``sklearn.covariance.ledoit_wolf``."""
    x = as_float32(x, device)
    if x.ndim == 3:
        e, c, n = x.shape
        x = (x - x.mean(-1, keepdim=True)).transpose(0, 1).reshape(c, e * n)
    if x.ndim != 2:
        raise ValueError(f"expected (C, N) or (E, C, N), got "
                         f"{tuple(x.shape)}")
    if x.shape[1] < 2:
        raise ValueError("need at least 2 samples")
    cov, alpha = _lw_jit(x)
    return cov, float(alpha)


def _shrunk(cov, shrink: float):
    c = cov.shape[-1]
    tr = _trace(cov) / c
    return (1.0 - shrink) * cov + shrink * tr[..., None, None] * _eye(c, cov)


def _ged_core(cov_s, cov_r, shrink: float):
    """Whiten-and-eigh generalized solve of (..., C, C) stacks; returns
    (eigvals desc, filters (C, C) columns, patterns (C, C))."""
    cov_s = 0.5 * (cov_s + cov_s.transpose(-1, -2))
    cov_r = _shrunk(0.5 * (cov_r + cov_r.transpose(-1, -2)), shrink)
    with fp32_matmul("exact"):
        s_r, e_r = sym_eigh(cov_r)
        inv_sqrt = (e_r / torch.sqrt(s_r.clamp(min=1e-12))[..., None, :]) \
            @ e_r.transpose(-1, -2)
        m = (inv_sqrt @ cov_s) @ inv_sqrt
        d, v = sym_eigh(0.5 * (m + m.transpose(-1, -2)))
        d = d.flip(-1)
        filters = inv_sqrt @ v.flip(-1)
        # Haufe patterns: W^T S W is diagonal at the solution
        sw = cov_s @ filters
    denom = (filters * sw).sum(-2).clamp(min=1e-20)
    patterns = sw / denom[..., None, :]
    # deterministic sign: largest-|.| pattern coefficient positive
    flip = torch.sign(torch.gather(
        patterns, -2, patterns.abs().argmax(-2, keepdim=True)))
    flip = torch.where(flip == 0, 1.0, flip)
    return d, filters * flip, patterns * flip


def _ged_jit(cov_s, cov_r, *, n_components: int, shrink: float):
    d, f, p = _ged_core(cov_s, cov_r, shrink)
    k = n_components
    return d[..., :k], f[..., :k], p[..., :k]


def ged(cov_s, cov_r, n_components: Optional[int] = None,
        shrink: float = 0.01, device=None) -> SpatialResult:
    """Generalized eigendecomposition ``S w = lam R w`` of two channel
    covariances: components (descending ``lam``) maximize the
    signal-to-reference variance ratio."""
    cov_s = as_float32(cov_s, device)
    cov_r = as_float32(cov_r, cov_s.device)
    if cov_s.shape != cov_r.shape or cov_s.ndim != 2 \
            or cov_s.shape[0] != cov_s.shape[1]:
        raise ValueError("cov_s/cov_r must be matching square matrices")
    c = cov_s.shape[0]
    k = c if n_components is None else int(n_components)
    if not (1 <= k <= c):
        raise ValueError("n_components must be in [1, C]")
    d, f, p = _ged_jit(cov_s, cov_r, n_components=k, shrink=float(shrink))
    return SpatialResult(f, p, d)


def _band_pair(xa, xb, f_lo, f_hi, sfreq):
    if f_lo is not None or f_hi is not None:
        if sfreq is None or f_lo is None or f_hi is None:
            raise ValueError("bandpass needs f_lo, f_hi AND sfreq")
        xa = _filt.bandpass(xa, sfreq, f_lo, f_hi)
        xb = _filt.bandpass(xb, sfreq, f_lo, f_hi)
    return xa, xb


def csp(xa, xb, n_components: int = 4, shrink: float = 0.01,
        f_lo: Optional[float] = None, f_hi: Optional[float] = None,
        sfreq: Optional[float] = None, device=None) -> SpatialResult:
    """Common spatial patterns for two-class epochs (E, C, N): GED of the
    class-A covariance against the pooled one (Blankertz 2008), keeping
    the ``n_components`` spectrum extremes, alternating top / bottom.
    ``f_lo`` / ``f_hi`` (with ``sfreq``) bandpass both classes first."""
    xa = as_float32(xa, device)
    xb = as_float32(xb, xa.device)
    if xa.ndim != 3 or xb.ndim != 3 or xa.shape[1:] != xb.shape[1:]:
        raise ValueError("xa/xb must be (E, C, N) with matching (C, N)")
    xa, xb = _band_pair(xa, xb, f_lo, f_hi, sfreq)
    c = xa.shape[1]
    k = int(n_components)
    if not (1 <= k <= c):
        raise ValueError("n_components must be in [1, C]")
    return _csp_from_covs(covariance(xa), covariance(xb), k, shrink)


def _csp_select(c: int, k: int) -> torch.Tensor:
    """Alternate eigen-spectrum extremes: 0, C-1, 1, C-2, ..."""
    idx = np.empty(c, dtype=np.int64)
    idx[0::2] = np.arange((c + 1) // 2)
    idx[1::2] = c - 1 - np.arange(c // 2)
    return torch.from_numpy(idx[:k])


def _csp_from_covs(ca, cb, k: int, shrink: float) -> SpatialResult:
    c = ca.shape[0]
    d, f, p = _ged_jit(ca, ca + cb, n_components=c, shrink=float(shrink))
    sel = _csp_select(c, k).to(ca.device)
    return SpatialResult(f[:, sel], p[:, sel], d[sel])


def _apply3_jit(x, filters):
    with fp32_matmul("exact"):
        return filters.T @ x                          # (E, K, N)


def spatial_apply(x, filters, device=None) -> torch.Tensor:
    """Project epochs (E, C, N) (or one (C, N) recording) onto component
    time series (E, K, N) / (K, N)."""
    x = as_float32(x, device)
    filters = as_float32(filters, x.device)
    if x.ndim == 2:
        return _apply3_jit(x[None], filters)[0]
    return _apply3_jit(x, filters)


def csp_features(x, filters, device=None) -> torch.Tensor:
    """Log-variance CSP features: (E, C, N) epochs -> (E, K), normalized
    to the per-epoch total."""
    src = spatial_apply(x, filters, device)
    v = src.var(2, correction=0)
    return torch.log((v / v.sum(1, keepdim=True)).clamp(min=1e-30))


def ssd(x, sfreq: float, f_lo: float, f_hi: float,
        n_components: Optional[int] = None, flank: float = 2.0,
        gap: float = 1.0, shrink: float = 0.01,
        device=None) -> SpatialResult:
    """Spatio-spectral decomposition (Nikulin 2011): power in
    [f_lo, f_hi] against its flanks ([f_lo - flank, f_hi + flank] with
    [f_lo - gap, f_hi + gap] notched out).  ``x`` is (C, N) or (E, C,
    N)."""
    x = as_float32(x, device)
    if f_lo - flank <= 0:
        raise ValueError("f_lo - flank must stay positive")
    if gap >= flank:
        raise ValueError("gap must be < flank (else the noise band is "
                         "empty)")
    xs = _filt.bandpass(x, sfreq, f_lo, f_hi)
    broad = _filt.bandpass(x, sfreq, f_lo - flank, f_hi + flank)
    center = 0.5 * (f_lo + f_hi)
    width = (f_hi - f_lo) + 2.0 * gap
    xn = _filt.notch(broad, sfreq, center, width)
    cov_s = covariance(xs)
    cov_n = covariance(xn)
    c = cov_s.shape[0]
    k = c if n_components is None else int(n_components)
    if not (1 <= k <= c):
        raise ValueError("n_components must be in [1, C]")
    d, f, p = _ged_jit(cov_s, cov_n, n_components=k, shrink=float(shrink))
    return SpatialResult(f, p, d)


def _sandwich_ged(cs, cr, k):
    """``eigh`` of ``cr^{-1/2} cs cr^{-1/2}`` (``cr``'s spectrum floored
    at 1e-12 of its top): the top ``k`` filters as unit rows (K, C)."""
    d, v = sym_eigh(cr)
    d = torch.maximum(d, 1e-12 * d[-1])
    isq = (v / torch.sqrt(d)[None, :]) @ v.T
    m = (isq @ cs) @ isq
    _, vecs = sym_eigh(0.5 * (m + m.T))      # ascending
    w = (isq @ vecs.flip(1)[:, :k]).T                 # (K, C)
    return w / torch.linalg.vector_norm(w, dim=1, keepdim=True).clamp(
        min=1e-30)


def _quad(w, m):
    """``w_k^T m w_k`` for each row k of w."""
    return ((w @ m) * w).sum(1)


def corrca(x, n_components: int = 3, shrink: float = 0.05, device=None):
    """Correlated components analysis / inter-subject correlation (Parra
    et al. 2019) of (S, C, N): ``R_between w = lambda R_within w`` with
    ``R_between = C_pooled - R_within``.  Returns ``(filters (K, C), isc
    (K,))``."""
    x = as_float32(x, device)
    if x.ndim != 3:
        raise ValueError("x must be (subjects, C, N)")
    s, c, n = x.shape
    if s < 2:
        raise ValueError("need at least 2 subjects/repeats")
    if not 1 <= int(n_components) <= c:
        raise ValueError("n_components must be in [1, C]")
    xm = x - x.mean(-1, keepdim=True)
    with fp32_matmul("exact"):
        rw = (xm @ xm.transpose(1, 2)).sum(0) / n
        pooled = xm.sum(0)
        cp = (pooled @ pooled.T) / n
        rb = cp - rw
        rw = rw + shrink * _trace(rw) / c * _eye(c, rw)
        w = _sandwich_ged(rb, rw, int(n_components))
        num = _quad(w, rb)
        den = _quad(w, rw)
    return w, num / ((s - 1.0) * den).clamp(min=1e-30)


def xdawn(x, events, window: int, n_components: int = 4,
          shrink: float = 0.05, device=None):
    """xDAWN evoked-response enhancement (Rivet et al. 2009): filters
    maximizing the evoked-to-noise power ratio for responses locked to
    ``events`` (sample indices) over ``window`` samples, the evoked
    waveform the least-squares estimate on the Toeplitz event design.
    Returns ``(filters (K, C), evoked (K, window), ratios (K,))``."""
    x = as_float32(x, device)
    if x.ndim != 2:
        raise ValueError("x must be (C, N)")
    c, n = x.shape
    ev = np.asarray(events, np.int64).ravel()
    ev = ev[(ev >= 0) & (ev + int(window) <= n)]
    if ev.size < 2:
        raise ValueError("need at least 2 in-bounds events")
    if not 1 <= int(n_components) <= c:
        raise ValueError("n_components must be in [1, C]")
    # the Toeplitz design as L shifted indicator rows, built on the host
    train = np.zeros(n, np.float32)
    train[ev] = 1.0
    L = int(window)
    rows_np = np.zeros((L, n), np.float32)
    for k in range(L):
        rows_np[k, k:] = train[:n - k] if k else train
    return _xdawn_jit(x, torch.from_numpy(rows_np).to(x.device),
                      n_components=int(n_components), shrink=float(shrink))


def _xdawn_jit(x, rows, *, n_components, shrink):
    c, n = x.shape
    L = rows.shape[0]
    with fp32_matmul("exact"):
        dtd = rows @ rows.T                           # (L, L)
        dtx = rows @ x.T                              # (L, C)
        dtd = dtd + 1e-6 * _trace(dtd) / L * _eye(L, dtd)
        a = torch.linalg.solve_ex(dtd, dtx)[0]        # (L, C) evoked
        # signal covariance of the evoked stream D A: A^T (D^T D) A
        cs = (a.T @ (dtd @ a)) / n
        cx = (x @ x.T) / n
        cx = cx + shrink * _trace(cx) / c * _eye(c, cx)
        w = _sandwich_ged(cs, cx, n_components)
        evoked = w @ a.T                              # (K, L)
        num = _quad(w, cs)
        den = _quad(w, cx)
    return w, evoked, num / den.clamp(min=1e-30)
