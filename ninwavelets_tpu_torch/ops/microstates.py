"""EEG microstate analysis (Pascual-Marqui, Michel & Lehmann 1995), port of
``ninwavelets_tpu.ops.microstates``: polarity-invariant topographic
clustering of a (C, T) recording into a few quasi-stable maps, the
recording as a symbol sequence, and its coverage / duration / occurrence /
transition statistics.

The modified k-means runs every restart at once: the E-step is one
(R, K, C) @ (C, T) product and an argmax of the squared activations; the
M-step builds the R x K per-state scatter matrices as weighted products
(restarts in chunks whose weighted copies of the data stay under 1 GiB)
and takes their dominant eigenvectors with one batched ``sym_eigh`` a
step.  GFP-peak restriction is a 0/1 sample weight.  Every
product runs in ``fp32_matmul("exact")``.  The restarts' seed samples are
drawn without replacement, weighted by that mask, by ``torch.multinomial``
from a ``torch.Generator``; ``_fit_from_idx`` takes given ones.

An eigenvector's sign is arbitrary, so a map is defined up to its sign
(the labels are not affected).  ``microstate_syntax_test`` is host numpy,
as in the JAX package.

A numpy input goes to ``device`` (the card when None); a tensor stays on
its device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import as_float32
from .scattering import fp32_matmul, sym_eigh

__all__ = ["MicrostateResult", "gfp", "microstate_fit",
           "microstate_backfit", "microstate_stats",
           "microstate_syntax_test"]

_SCATTER_BYTES = 1 << 30


class MicrostateResult(NamedTuple):
    """Fitted microstate decomposition of a (C, T) recording: ``maps``
    (K, C) unit-norm, average-referenced topographies (sign arbitrary;
    rows by descending coverage), ``labels`` (T,) int32 backfitted state
    per sample, ``gev`` the global explained variance in [0, 1],
    ``gev_per_state`` (K,)."""
    maps: torch.Tensor
    labels: torch.Tensor
    gev: torch.Tensor
    gev_per_state: torch.Tensor


def gfp(x, device=None) -> torch.Tensor:
    """Global field power of (..., C, T): the spatial standard deviation
    per sample (Lehmann & Skrandies 1980)."""
    return torch.std(as_float32(x, device), dim=-2, correction=0)


def _avg_ref(x):
    return x - torch.mean(x, dim=-2, keepdim=True)


def _peak_mask(g):
    """(T,) 0/1 mask of strict local GFP maxima (endpoints excluded)."""
    inner = (g[1:-1] > g[:-2]) & (g[1:-1] > g[2:])
    return torch.nn.functional.pad(inner.to(torch.float32), (1, 1))


def _mm(a, b):
    with fp32_matmul("exact"):
        return a @ b


def _fit_restarts(x, g2, w, idx, n_iter: int):
    """Every restart of the modified k-means at once on average-referenced
    (C, T) data; ``w`` the (T,) sample weight, ``g2`` the per-sample
    ``sum_c x_c^2``, ``idx`` the (R, K) seed samples.  Returns the (R, K,
    C) maps and the (R,) GEV of each restart on the weighted samples."""
    n_states = idx.shape[1]
    step = max(1, _SCATTER_BYTES // (4 * n_states * x.numel()))
    maps = x[:, idx].permute(1, 2, 0)                      # (R, K, C)
    maps = maps / torch.clamp(torch.linalg.vector_norm(
        maps, dim=-1, keepdim=True), min=1e-12)
    states = torch.arange(n_states, device=x.device)[:, None]
    for _ in range(n_iter):
        a = _mm(maps, x)                                   # (R, K, T)
        lab = torch.argmax(a * a, dim=1)                   # (R, T)
        wk = (lab[:, None, :] == states).to(torch.float32) * w
        # per-state scatter S_k = sum_t wk x x^T: batched products over
        # restart chunks, each (r, K, C, T) weighted copy under
        # _SCATTER_BYTES
        s = torch.cat([_mm(x * wk[i:i + step, :, None, :], x.T)
                       for i in range(0, wk.shape[0], step)])
        new = sym_eigh(s)[1][..., -1]                      # dominant
        empty = torch.sum(wk, dim=-1) < 0.5                # keep old
        maps = torch.where(empty[..., None], maps, new)
    a = _mm(maps, x)
    lab = torch.argmax(a * a, dim=1)
    best = torch.gather(a, 1, lab[:, None, :])[:, 0]
    gev = torch.sum(w * best * best, dim=-1) / torch.clamp(
        torch.sum(w * g2), min=1e-20)
    return maps, gev


def _prepare(x, n_states, peaks_only, device):
    x = as_float32(x, device)
    if x.ndim != 2:
        raise ValueError("x must be (C, T)")
    c, t = x.shape
    if not 1 < n_states < min(c, t):
        raise ValueError("need 1 < n_states < min(C, T)")
    x = _avg_ref(x)
    g = gfp(x)
    g2 = torch.sum(x * x, dim=0)
    w = _peak_mask(g) if peaks_only else torch.ones_like(g)
    if peaks_only:
        # fewer strict GFP maxima than states cannot seed the prototypes
        n_peaks = int(torch.sum(w))
        if n_peaks < n_states:
            raise ValueError(
                f"only {n_peaks} GFP peaks for {n_states} states — "
                "constant-GFP data has none; pass peaks_only=False")
    return x, g2, w


def _fit(x, g2, w, idx, n_iter: int) -> MicrostateResult:
    """The best restart of ``_fit_restarts``, its maps ordered by coverage
    (ties in index order), labels and GEV on all samples."""
    n_states = idx.shape[1]
    maps_all, gev_all = _fit_restarts(x, g2, w, idx, n_iter)
    maps = maps_all[int(torch.argmax(gev_all))]
    states = torch.arange(n_states, device=x.device)[:, None]
    labels = microstate_backfit(x, maps)
    cov = torch.mean((labels[None, :] == states).to(torch.float32), dim=1)
    maps = maps[torch.argsort(-cov, stable=True)]
    labels = microstate_backfit(x, maps)
    bestact = torch.gather(_mm(maps, x), 0, labels[None, :].long())[0]
    denom = torch.clamp(torch.sum(g2), min=1e-20)
    sq = bestact * bestact
    onehot = (labels[None, :] == states).to(torch.float32)
    return MicrostateResult(maps=maps, labels=labels,
                            gev=torch.sum(sq) / denom,
                            gev_per_state=torch.sum(onehot * sq[None, :],
                                                    dim=1) / denom)


def _fit_from_idx(x, idx, *, n_states: int = 4, peaks_only: bool = True,
                  n_iter: int = 40, device=None) -> MicrostateResult:
    """``microstate_fit`` from given (R, K) seed sample indices (one row a
    restart; the CPU tests feed the JAX package's draws)."""
    x, g2, w = _prepare(x, int(n_states), peaks_only, device)
    idx = torch.as_tensor(idx, dtype=torch.int64, device=x.device)
    if idx.shape[1] != int(n_states):
        raise ValueError("idx must be (n_init, n_states)")
    return _fit(x, g2, w, idx, int(n_iter))


def microstate_fit(x, n_states: int = 4, *, peaks_only: bool = True,
                   n_init: int = 8, n_iter: int = 40, seed: int = 0,
                   device=None) -> MicrostateResult:
    """Fit ``n_states`` microstate maps to a (C, T) recording.
    ``peaks_only`` fits on the GFP local maxima (backfitting labels every
    sample); ``n_init`` restarts, each seeded by ``n_states`` samples
    drawn without replacement from a ``torch.Generator`` seeded with
    ``seed`` (other draws than the JAX package's); the best global
    explained variance wins.  Maps are ordered by descending coverage."""
    x, g2, w = _prepare(x, int(n_states), peaks_only, device)
    gen = torch.Generator(device=x.device).manual_seed(int(seed))
    idx = torch.multinomial(w.expand(int(n_init), -1), int(n_states),
                            replacement=False, generator=gen)
    return _fit(x, g2, w, idx, int(n_iter))


def microstate_backfit(x, maps, device=None) -> torch.Tensor:
    """(T,) int32 label per sample: argmax of the squared spatial
    correlation with each unit-norm map (polarity-invariant).  ``x`` is
    (C, T), average-referenced here to match the fit space."""
    x = _avg_ref(as_float32(x, device))
    a = _mm(as_float32(maps, x.device), x)
    return torch.argmax(a * a, dim=0).to(torch.int32)


def microstate_stats(labels, n_states: int, sfreq: float) -> dict:
    """Sequence statistics of a backfitted label series, as host numpy:
    ``coverage`` (K,) fraction of samples, ``occurrence`` (K,) segments
    per second, ``duration`` (K,) mean segment length in seconds, and
    ``transitions`` (K, K), row-normalized probabilities between DISTINCT
    consecutive states."""
    labels = torch.as_tensor(np.asarray(labels) if not isinstance(
        labels, torch.Tensor) else labels).long()
    k = int(n_states)
    t = labels.shape[0]
    coverage = torch.bincount(labels, minlength=k)[:k].to(torch.float32) / t
    change = torch.ones_like(labels, dtype=torch.bool)
    change[1:] = labels[1:] != labels[:-1]
    starts = torch.bincount(labels[change], minlength=k)[:k]
    occurrence = starts.to(torch.float32) / (t / float(sfreq))
    duration = torch.where(occurrence > 0, coverage / torch.clamp(
        occurrence, min=1e-20), torch.zeros_like(coverage))
    prev, nxt = labels[:-1], labels[1:]
    move = nxt != prev
    counts = torch.bincount(prev[move] * k + nxt[move], minlength=k * k)[
        :k * k].reshape(k, k).to(torch.float32)
    transitions = counts / torch.clamp(counts.sum(dim=1, keepdim=True),
                                       min=1e-20)
    return {name: v.cpu().numpy() for name, v in
            (("coverage", coverage), ("occurrence", occurrence),
             ("duration", duration), ("transitions", transitions))}


def microstate_syntax_test(labels, n_states: int, n_shuffles: int = 500,
                           seed: int = 0):
    """Directional-syntax test: is the TRANSITION structure asymmetric
    (A->B more likely than B->A) beyond what coverage predicts?

    Statistic: ``sum_{i<j} |T_ij - T_ji| / sum_{i!=j} T_ij`` over the
    distinct-transition counts.  Null: the segment sequence shuffled
    (segment-level permutations from ``np.random.default_rng(seed)``);
    each shuffle is change-compressed before counting, so observed and
    null draws live on the same scale.  Returns ``(asym, p)``.  Host
    numpy, as in the JAX package."""
    labels = labels.cpu().numpy() if isinstance(labels, torch.Tensor) \
        else np.asarray(labels)
    seq = labels[np.concatenate([[True], labels[1:] != labels[:-1]])]
    if seq.size < 3:
        raise ValueError("need at least 3 segments")
    k = int(n_states)

    def asym_of(s):
        s = s[np.concatenate([[True], s[1:] != s[:-1]])]
        if s.size < 2:
            return 0.0
        t = np.zeros((k, k))
        np.add.at(t, (s[:-1], s[1:]), 1.0)
        return float(np.abs(t - t.T)[np.triu_indices(k, 1)].sum()
                     / max(t.sum(), 1.0))

    obs = asym_of(seq)
    rng = np.random.default_rng(int(seed))
    count = 1
    for _ in range(int(n_shuffles)):
        count += asym_of(rng.permutation(seq)) >= obs
    return obs, count / (int(n_shuffles) + 1)
