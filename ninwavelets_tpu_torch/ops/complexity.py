"""Signal complexity, port of ``ninwavelets_tpu.ops.complexity``: sample
entropy, multiscale entropy, permutation entropy (Bandt-Pompe), their
multiscale profiles and detrended fluctuation analysis.

* Sample entropy is O(N^2) template matching: the (N', N') plane of
  |x_i - x_j|, its running Chebyshev max over the ``m`` embedding offsets,
  and the counts at m and m + 1 off the same plane, for ``_CHUNK`` series
  at a time (the JAX package's ``lax.map`` chunks), so the card holds a
  bounded number of planes.  The counts are exact integers.
* Permutation entropy ranks each embedding window by pairwise
  comparison, ties broken by index (the Bandt-Pompe rule), encodes the
  ranks as ``sum_k rank_k m^k`` and counts the codes with one
  ``scatter_add`` into m^m bins per series (exact integer counts; the JAX
  package sums a one-hot float plane).
* Multiscale profiles coarse-grain by non-overlapping means, with the
  tolerance fixed from the scale-1 std (Costa's convention).
* DFA detrends the integrated profile per box by the closed-form
  least-squares line (two moment contractions, no solve).

A numpy input goes to ``device`` (the card when None); a tensor stays on
its device.
"""
from __future__ import annotations

from math import factorial as _factorial
from math import log

import numpy as np
import torch

from ..device import as_float32
from .signal_utils import row_cumsum

__all__ = ["sample_entropy", "multiscale_entropy",
           "permutation_entropy", "multiscale_permutation_entropy",
           "dfa"]

_CHUNK = 8  # series per step: bounds the live pair planes


def _sampen_counts(x, m: int, r):
    """Template-match counts for a (B, N) chunk: ``(B, A)`` (B,) int64,
    the ordered pairs (i != j) whose Chebyshev distance is < r at
    embedding dimension m and m + 1; ``r`` is (B,), already scaled."""
    n = x.shape[-1]
    np_ = n - m                                    # templates incl. m+1
    d = torch.abs(x[:, :, None] - x[:, None, :])   # (B, N, N)
    cheb = d[:, :np_, :np_]
    for k in range(1, m):
        cheb = torch.maximum(cheb, d[:, k:k + np_, k:k + np_])
    rr = r[:, None, None]
    b = torch.count_nonzero(cheb < rr, dim=(-2, -1))
    cheb = torch.maximum(cheb, d[:, m:m + np_, m:m + np_])
    a = torch.count_nonzero(cheb < rr, dim=(-2, -1))
    return b - np_, a - np_


def _sampen_rows(flat, rr, m: int):
    """(R, N) series, (R,) tolerances -> (R,) sample entropy (inf where
    no template matches)."""
    bs, as_ = [], []
    for i in range(0, flat.shape[0], _CHUNK):
        b, a = _sampen_counts(flat[i:i + _CHUNK], m, rr[i:i + _CHUNK])
        bs.append(b)
        as_.append(a)
    b = torch.cat(bs).to(torch.float32)
    a = torch.cat(as_).to(torch.float32)
    se = -torch.log(torch.clamp(a, min=1e-30) / torch.clamp(b, min=1e-30))
    return torch.where((a > 0) & (b > 0), se, torch.full_like(se, np.inf))


def sample_entropy(x, m: int = 2, r: float = 0.2, scale_r: bool = True,
                   device=None) -> torch.Tensor:
    """Sample entropy (Richman & Moorman 2000) of (..., N) series:
    ``-ln(A / B)`` with B / A the ordered template pairs within Chebyshev
    tolerance ``r`` at embedding dimension ``m`` / ``m + 1`` (self-matches
    excluded).  ``scale_r=True`` uses ``r * std`` per series, else ``r`` is
    absolute.  Series with no matches give ``inf``, never NaN."""
    x = as_float32(x, device)
    if x.shape[-1] < m + 2:
        raise ValueError(f"need N > m + 1 = {m + 1} samples")
    if not 1 <= int(m) <= 8:
        raise ValueError("m must be in 1..8")
    shape = x.shape[:-1]
    flat = x.reshape(-1, x.shape[-1])
    if scale_r:
        rr = float(r) * torch.std(flat, dim=-1, correction=0)
    else:
        rr = torch.full((flat.shape[0],), float(r), device=x.device)
    return _sampen_rows(flat, rr, int(m)).reshape(shape)


def _scales(scales):
    scales = tuple(range(1, int(scales) + 1)) if np.isscalar(scales) \
        else tuple(int(s) for s in scales)
    if any(s < 1 for s in scales):
        raise ValueError("scales must be >= 1")
    return scales


def _coarse(x, s: int):
    """Non-overlapping means of ``s`` samples along the last axis."""
    ncg = x.shape[-1] // s
    return torch.mean(x[..., :ncg * s].reshape(*x.shape[:-1], ncg, s),
                      dim=-1)


def multiscale_entropy(x, m: int = 2, r: float = 0.2, scales=10,
                       device=None) -> torch.Tensor:
    """Multiscale sample entropy (Costa, Goldberger & Peng 2002):
    (..., N) -> (..., S).  Scale s coarse-grains by non-overlapping means
    of s samples; the tolerance stays ``r * std`` of the ORIGINAL series.
    ``scales`` is an int (1..scales) or an explicit list."""
    x = as_float32(x, device)
    scales = _scales(scales)
    if x.shape[-1] // max(scales) < m + 2:
        raise ValueError("largest scale leaves fewer than m + 2 samples")
    rr = (float(r) * torch.std(x, dim=-1, correction=0)).reshape(-1)
    outs = []
    for s in scales:
        cg = _coarse(x, s)
        outs.append(_sampen_rows(cg.reshape(-1, cg.shape[-1]), rr,
                                 int(m)).reshape(x.shape[:-1]))
    return torch.stack(outs, dim=-1)


def _ordinal_codes(x, m: int, tau: int):
    """(..., L) int64 code of each length-m ordinal pattern (stride tau):
    each element ranked by pairwise comparison, ties by original index
    (the Bandt-Pompe rule), encoded as ``sum_k rank_k m^k``."""
    el = x.shape[-1] - (m - 1) * tau
    win = torch.stack([x[..., k * tau:k * tau + el] for k in range(m)],
                      dim=-1)                              # (..., L, m)
    a = win[..., :, None]
    b = win[..., None, :]
    idx = torch.arange(m, device=x.device)
    tie = (idx[:, None] > idx[None, :])
    ranks = ((b < a) | ((b == a) & tie)).sum(dim=-1)       # (..., L, m)
    return (ranks * (m ** idx)).sum(dim=-1)


def _perm_entropy(x, m: int, tau: int, normalized: bool):
    codes = _ordinal_codes(x, m, tau)
    shape = codes.shape[:-1]
    flat = codes.reshape(-1, codes.shape[-1])
    counts = torch.zeros((flat.shape[0], m ** m), dtype=torch.int64,
                         device=x.device)
    counts.scatter_add_(1, flat, torch.ones_like(flat))
    counts = counts.to(torch.float32)
    p = counts / counts.sum(dim=-1, keepdim=True)
    h = -torch.where(p > 0, p * torch.log(torch.clamp(p, min=1e-30)),
                     torch.zeros_like(p)).sum(dim=-1)
    if normalized:
        h = h / float(log(float(_factorial(m))))
    return h.reshape(shape)


def permutation_entropy(x, m: int = 3, tau: int = 1,
                        normalized: bool = True,
                        device=None) -> torch.Tensor:
    """Permutation entropy (Bandt & Pompe 2002) of (..., N) series: the
    Shannon entropy of the ordinal patterns of length-``m`` windows (delay
    ``tau``), ties by original order; ``normalized=True`` divides by
    ``ln(m!)`` (a ramp gives 0, white noise about 1)."""
    x = as_float32(x, device)
    if not 2 <= int(m) <= 6:
        raise ValueError("m must be in 2..6 (m^m pattern bins)")
    if x.shape[-1] < (m - 1) * tau + m:
        raise ValueError("series too short for the embedding")
    return _perm_entropy(x, int(m), int(tau), bool(normalized))


def multiscale_permutation_entropy(x, m: int = 3, tau: int = 1, scales=10,
                                   normalized: bool = True,
                                   device=None) -> torch.Tensor:
    """Permutation entropy over coarse-graining scales: (..., N) ->
    (..., S), the ordinal analog of :func:`multiscale_entropy`."""
    x = as_float32(x, device)
    scales = _scales(scales)
    if x.shape[-1] // max(scales) < (m - 1) * tau + m:
        raise ValueError("largest scale leaves too few samples for the "
                         "embedding")
    return torch.stack([_perm_entropy(_coarse(x, s), int(m), int(tau),
                                      bool(normalized)) for s in scales],
                       dim=-1)


def _dfa_fluct(y, s: int):
    """RMS fluctuation of the integrated profile ``y`` (..., N) around
    per-box least-squares lines at box size ``s`` (boxes from the front,
    the ragged tail dropped)."""
    nb = y.shape[-1] // s
    b = y[..., :nb * s].reshape(*y.shape[:-1], nb, s)
    t = torch.arange(s, dtype=torch.float32, device=y.device)
    tm = (s - 1) / 2.0
    tv = torch.sum((t - tm) ** 2)
    ym = torch.mean(b, dim=-1, keepdim=True)
    slope = torch.sum(b * (t - tm), dim=-1, keepdim=True) / tv
    resid = b - ym - slope * (t - tm)
    return torch.sqrt(torch.mean(resid ** 2, dim=(-2, -1)))


def dfa(x, scales=None, min_scale: int = 4, n_scales: int = 12,
        device=None):
    """Detrended fluctuation analysis (Peng 1995) of (..., N) series: the
    exponent alpha of ``F(s) ~ s^alpha`` (0.5 white noise, about 1 for
    1/f, 1.5 brown).  ``scales`` defaults to ``n_scales`` log-spaced box
    sizes from ``min_scale`` to N/4.  Returns ``(alpha (...,),
    fluctuations (..., S))``; the log-log fit is least squares over the
    scales."""
    x = as_float32(x, device)
    n = x.shape[-1]
    if scales is None:
        hi = n // 4
        if hi <= min_scale:
            raise ValueError("series too short for DFA (need N > "
                             f"4 * {min_scale})")
        scales = np.unique(np.round(np.geomspace(
            min_scale, hi, int(n_scales))).astype(int))
    scales = tuple(int(s) for s in scales)
    if len(scales) < 2 or min(scales) < 4 or max(scales) > n:
        raise ValueError("need >= 2 scales, each in [4, N]")
    y = row_cumsum(x - torch.mean(x, dim=-1, keepdim=True))
    f = torch.stack([_dfa_fluct(y, s) for s in scales], dim=-1)
    logs = torch.log(torch.tensor(scales, dtype=torch.float32,
                                  device=x.device))
    logf = torch.log(torch.clamp(f, min=1e-30))
    lm = torch.mean(logs)
    alpha = torch.sum((logs - lm) * (logf - torch.mean(
        logf, dim=-1, keepdim=True)), dim=-1) / torch.sum((logs - lm) ** 2)
    return alpha, f
