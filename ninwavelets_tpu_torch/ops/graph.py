"""Weighted graph metrics over connectivity matrices (port of
``ninwavelets_tpu.ops.graph``): the network-neuroscience layer (Rubinov &
Sporns, NeuroImage 2010) downstream of the (F, C, C) PLV / coherence / wPLI
/ envelope-correlation matrices: per-node strength, Onnela weighted
clustering, shortest-path characteristic length and global efficiency, a
weight-shuffle-null small-world index and Newman's leading-eigenvector
community split.

Everything batches over the leading (frequency) axes: clustering is two
matrix products of the cube-rooted weights (``diag(W'^3)``), shortest
paths a fixed ``ceil(log2(C - 1))``-step min-plus squaring.  Every matrix
product runs in full float32 (``fp32_matmul("exact")``).  The small-world
null shuffles the upper-triangle weights (for a complete weighted graph,
degree-preserving rewiring is a weight permutation); its permutations come
from a ``torch.Generator`` seeded with ``seed`` on the weights' device, so
one seed gives other nulls than the JAX package's.
"""
from __future__ import annotations

import math

import torch

from ..device import as_float32
from .scattering import fp32_matmul

__all__ = ["modularity_communities",
           "strength", "clustering_onnela", "shortest_paths",
           "global_efficiency", "char_path_length", "small_worldness"]


def _clean(w) -> torch.Tensor:
    """Symmetrize, clip at 0 from below, zero the diagonal (a NaN stays
    NaN)."""
    w = as_float32(w)
    w = 0.5 * (w + w.transpose(-1, -2))
    w = torch.clamp(w, min=0.0)
    c = w.shape[-1]
    return w * (1.0 - torch.eye(c, dtype=w.dtype, device=w.device))


def strength(w) -> torch.Tensor:
    """(..., C) weighted node strength: row sums of the cleaned (..., C, C)
    matrix."""
    return _clean(w).sum(-1)


def clustering_onnela(w, eps: float = 1e-12) -> torch.Tensor:
    """(..., C) Onnela weighted clustering coefficient: with weights
    normalized by the global max, ``C_i = (W'^3)_ii / (k_i (k_i - 1))``
    where ``W' = W^(1/3)`` and ``k_i`` the count of nonzero neighbours.
    1 on a fully-connected equal-weight graph.  The cube root is
    ``pow(x, 1/3)`` on x >= 0 (``jnp.cbrt`` in the JAX package; they
    differ by an ulp or so)."""
    w = _clean(w)
    wmax = torch.amax(w, dim=(-2, -1), keepdim=True)
    wp = torch.pow(w / torch.clamp(wmax, min=eps), 1.0 / 3.0)
    with fp32_matmul("exact"):
        tri = torch.diagonal(wp @ wp @ wp, dim1=-2, dim2=-1)
    k = (w > 0).to(torch.float32).sum(-1)
    denom = torch.clamp(k * (k - 1.0), min=1.0)
    return torch.where(k > 1, tri / denom, torch.zeros_like(tri))


def shortest_paths(w, eps: float = 1e-12) -> torch.Tensor:
    """(..., C, C) weighted shortest-path lengths with the length map
    ``len = 1 / weight`` (stronger coupling = shorter path); zero weights
    are unreachable (1e9, barring relays).

    Min-plus matrix squaring: ``D <- min(D, min_k D_ik + D_kj)`` repeated
    ``ceil(log2(C - 1))`` times (at least once), batched."""
    w = _clean(w)
    c = w.shape[-1]
    d = torch.where(w > eps, 1.0 / torch.clamp(w, min=eps),
                    torch.full_like(w, 1e9))
    d = d.masked_fill(torch.eye(c, dtype=torch.bool, device=w.device), 0.0)
    n_steps = max(1, int(math.ceil(math.log2(max(c - 1, 1)))))
    for _ in range(n_steps):
        # D_ij <- min(D_ij, min_k D_ik + D_kj): (i, k, 1) + (1, k, j)
        relax = torch.amin(d[..., :, :, None] + d[..., None, :, :], dim=-2)
        d = torch.minimum(d, relax)
    return d


def global_efficiency(w) -> torch.Tensor:
    """(...,) global efficiency: mean over node pairs of 1 / shortest path
    length (0 for unreachable pairs)."""
    d = shortest_paths(w)
    c = d.shape[-1]
    inv = torch.where(d < 1e8, 1.0 / torch.clamp(d, min=1e-12),
                      torch.zeros_like(d))
    off = inv * (1.0 - torch.eye(c, dtype=inv.dtype, device=inv.device))
    return off.sum((-2, -1)) / (c * (c - 1.0))


def char_path_length(w) -> torch.Tensor:
    """(...,) characteristic path length: mean shortest path over REACHABLE
    node pairs."""
    d = shortest_paths(w)
    c = d.shape[-1]
    mask = (d < 1e8) & ~torch.eye(c, dtype=torch.bool, device=d.device)
    total = torch.where(mask, d, torch.zeros_like(d)).sum((-2, -1))
    return total / torch.clamp(mask.sum((-2, -1)).to(d.dtype), min=1.0)


def _null_perms(n_nulls: int, n_edges: int, seed: int,
                device) -> torch.Tensor:
    """(n_nulls, P) weight permutations from a ``torch.Generator`` seeded
    with ``seed`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return torch.rand((n_nulls, n_edges), generator=gen,
                      device=device).argsort(-1)


def _null_stats_from_perms(w, perms: torch.Tensor):
    """Mean clustering and path length of the weight-shuffled nulls, one
    null per row of ``perms`` ((n_nulls, P), P = C (C - 1) / 2)."""
    w = _clean(w)
    c = w.shape[-1]
    iu = torch.triu_indices(c, c, 1, device=w.device)
    vals = w[..., iu[0], iu[1]]                           # (..., P)
    cs, ls = [], []
    for perm in perms:
        out = torch.zeros_like(w)
        out[..., iu[0], iu[1]] = vals[..., perm]
        out = out + out.transpose(-1, -2)
        cs.append(clustering_onnela(out).mean(-1))
        ls.append(char_path_length(out))
    return torch.stack(cs).mean(0), torch.stack(ls).mean(0)


def _small_worldness(w, c_null, l_null) -> torch.Tensor:
    c_obs = clustering_onnela(w).mean(-1)
    l_obs = char_path_length(w)
    return (c_obs / torch.clamp(c_null, min=1e-12)) / torch.clamp(
        l_obs / torch.clamp(l_null, min=1e-12), min=1e-12)


def small_worldness(w, n_nulls: int = 20, seed: int = 0) -> torch.Tensor:
    """(...,) small-world index ``sigma = (C/C_null) / (L/L_null)`` against
    weight-shuffled nulls (sigma > 1: more clustered than random at
    comparable path length)."""
    w = as_float32(w)
    c = w.shape[-1]
    perms = _null_perms(int(n_nulls), c * (c - 1) // 2, seed, w.device)
    return _small_worldness(w, *_null_stats_from_perms(w, perms))


def modularity_communities(w, n_iter: int = 50):
    """Two-community split by Newman's leading-eigenvector method (Newman
    2006, PNAS 103:8577) on a weighted undirected matrix: the modularity
    matrix ``B = W - k k^T / 2m`` (k = strengths, 2m = total weight), the
    SIGNS of its dominant eigenvector are the labels, and ``q`` is the
    modularity of that split (0 when the leading eigenvalue is not
    positive: no community structure).

    Returns ``(labels (..., C) int32 in {0, 1}, q (...,) float32)``.  The
    eigenvector's sign is arbitrary, so the labels are defined up to a
    global flip; ``q`` is not.  ``n_iter`` is kept for the JAX signature
    (the eigendecomposition is direct)."""
    w = _clean(w)
    # the wpli / ppc matrices carry a NaN diagonal by convention (eps = 0):
    # it survives _clean's eye mask and would poison k, B and eigh into a
    # silent all-zero "no structure" answer, so sanitize first
    w = torch.where(torch.isfinite(w), w, torch.zeros_like(w))
    k = w.sum(-1)                                         # (..., C)
    two_m = torch.clamp(k.sum(-1), min=1e-20)             # (...,)
    b = w - k[..., :, None] * k[..., None, :] / two_m[..., None, None]
    bs = 0.5 * (b + b.transpose(-1, -2))
    vals, vecs = torch.linalg.eigh(bs)
    lead = vecs[..., :, -1]
    s = torch.where(lead >= 0, 1.0, -1.0)
    with fp32_matmul("exact"):
        q = torch.einsum("...i,...ij,...j->...", s, b, s) / (2.0 * two_m)
    ok = vals[..., -1] > 0
    labels = ((s > 0) & ok[..., None]).to(torch.int32)
    return labels, torch.where(ok, q, torch.zeros_like(q))
