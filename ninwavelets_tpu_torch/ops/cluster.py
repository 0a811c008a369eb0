"""Cluster-based permutation inference on time-frequency planes (port of
``ninwavelets_tpu.ops.cluster``; Maris & Oostenveld 2007, J Neurosci
Methods 164:177) plus threshold-free cluster enhancement (Smith & Nichols
2009), the max-statistic (Nichols & Holmes) correction and FDR.

Design, as in the JAX package:

* every permutation's t-map (or F-map) is matmul work: a sign-flip
  (one-sample / paired) null needs only ``sum_e s_pe * x_e``, one
  (chunk, E) @ (E, plane) product per chunk of ``_CHUNK`` permutations (the
  sum of squares is sign-invariant); an independent two-sample null
  contracts {0,1} group indicators against x and x**2 (two products), the
  one-way ANOVA null the one-hot group indicators against the
  grand-centred stack (one), the regression null the permuted covariate
  (one).  Every product runs in full float32 (``fp32_matmul("exact")``,
  the JAX package's ``Precision.HIGHEST``): a TF32 null would bias every
  test;
* connected components are a fixed-point min-label relaxation batched over
  the chunk, with pointer jumps (label <- label of label).  Each pixel
  converges to the minimum flat index of its component, so the labels are
  the JAX package's exactly;
* only each permutation's maximum cluster mass leaves a chunk.

Where the port differs:

* the permutations come from a ``torch.Generator`` seeded with ``seed`` on
  the data's device (``sign_draws``, ``relabel_draws``, ``anova_draws``,
  ``regression_draws``): one seed gives other permutations than the JAX
  package's.  Each null has a ``*_from_draws`` entry that takes the draws
  in the JAX package's padded (n_chunks, chunk, ...) layout, whose first
  ``n_perm`` rows are used;
* each round of the labeler also hooks every pixel's root to the smallest
  label the pixel saw (a scatter-min), and jumps twice: threshold masks
  converge in a few rounds, where the neighbour minimum alone moves a
  label one pixel a sweep.  The host reads the "changed" flag every
  ``_CHECK`` rounds;
* a cluster's mass is summed in float64 and rounded to float32 once.  Above
  a threshold of 0.25 every |t| is a multiple of 2^-25, so every partial
  sum below 2^28 is exact in float64: the mass does not depend on the order
  of the adds (float atomics on the card add in a varying order), and one
  seed gives the same null and p-values on every run.  The JAX package sums
  in float32 in XLA's order, so masses agree with it to float32 round-off.
  The sums go by runs along each row (``_mass_bins``), so that no root's
  bin takes an atomic add from every pixel of its component;
* the corrected p of a mass counts the null masses at or above it through a
  sorted null (``searchsorted``), and ``_finish`` reads each cluster's
  size, mass and p at its root pixel on the device: the same counts and
  the same list as the JAX package's per-pixel comparison and host loop.

A numpy input goes to the card (``device.as_float32``); a tensor stays on
its device.  The result tuples hold numpy arrays, as the JAX package's do.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import as_float32, resolve_device
from .scattering import fp32_matmul

__all__ = [
    "t_one_sample", "t_independent", "t_regression", "label_components",
    "cluster_mass", "cluster_test_one_sample", "cluster_test_paired",
    "cluster_test_independent", "cluster_test_regression", "cluster_test_f",
    "f_oneway", "f_threshold", "max_stat_test_one_sample",
    "max_stat_test_independent", "max_stat_test_regression", "t_threshold",
    "ClusterResult", "TfceResult", "tfce_map", "tfce_test_one_sample",
    "tfce_test_independent", "fdr_correction", "sign_draws",
    "relabel_draws", "anova_draws", "regression_draws",
    "sign_chunk_max_mass", "relabel_chunk_max_mass", "anova_chunk_max_mass",
    "regression_chunk_max_mass",
]

_CHUNK = 64  # permutations per contraction: one product, bounded memory
_CHECK = 2   # rounds of sweep and jumps between two reads of "changed"
_LEVEL_PIXELS = 1 << 26   # TFCE level masks labelled at once (pixels)


def t_threshold(alpha: float, dof: int) -> float:
    """Two-sided Student-t critical value ``t`` with ``P(|T| > t) = alpha``.

    Exact via scipy when available; otherwise the Cornish-Fisher expansion
    of the normal quantile in 1/dof (relative error < 1e-3 for dof >= 8).
    """
    p = 1.0 - alpha / 2.0
    try:
        from scipy.stats import t as _t
        return float(_t.ppf(p, dof))
    except Exception:  # pragma: no cover - scipy is normally present
        from statistics import NormalDist
        z = NormalDist().inv_cdf(p)
        g1 = (z ** 3 + z) / 4.0
        g2 = (5 * z ** 5 + 16 * z ** 3 + 3 * z) / 96.0
        return z + g1 / dof + g2 / dof ** 2


def f_threshold(alpha: float, dfn: int, dfd: int) -> float:
    """Upper-tail F critical value with ``P(F > f) = alpha`` (the F test is
    one-sided by construction).

    Exact via scipy when available; otherwise the Paulson /
    Wilson-Hilferty cube-root-chi2 approximation (relative error < 5% over
    alpha in [0.001, 0.05], dfn in 1..10, dfd >= 10).
    """
    try:
        from scipy.stats import f as _f
        return float(_f.ppf(1.0 - alpha, dfn, dfd))
    except Exception:  # pragma: no cover - scipy is normally present
        from statistics import NormalDist
        z = NormalDist().inv_cdf(1.0 - alpha)
        # Paulson 1942: (1-b) h - (1-a) ~ z sqrt(b h^2 + a) for
        # h = F^{1/3}, a = 2/9dfn, b = 2/9dfd; solve the quadratic and
        # take the larger root.
        a, b = 2.0 / (9.0 * dfn), 2.0 / (9.0 * dfd)
        qa = (1.0 - b) ** 2 - z * z * b
        qb = -2.0 * (1.0 - b) * (1.0 - a)
        qc = (1.0 - a) ** 2 - z * z * a
        if qa <= 0:  # extreme alpha/dfd where the normal tail crosses
            raise ValueError("f_threshold approximation needs scipy "
                             "for alpha=%g, dfd=%d" % (alpha, dfd))
        h = (-qb + (qb * qb - 4.0 * qa * qc) ** 0.5) / (2.0 * qa)
        return float(h ** 3)


# ---------------------------------------------------------------------------
# t and F statistics from matmul-friendly moments
# ---------------------------------------------------------------------------

def _t_from_sign_sums(s1: torch.Tensor, s2: torch.Tensor,
                      n: int) -> torch.Tensor:
    """One-sample t from the signed sum ``s1`` and the (sign-invariant) sum
    of squares ``s2``: ``mean / sqrt(var / n)``.  Zero-variance pixels get
    t = 0 (no evidence, never +-inf)."""
    mean = s1 / n
    var = (s2 - n * mean * mean) / (n - 1)
    denom = torch.sqrt(torch.clamp(var, min=0.0) / n)
    ok = denom > 0
    return torch.where(ok, mean / torch.where(ok, denom, 1.0), 0.0)


def t_one_sample(x) -> torch.Tensor:
    """Pixelwise one-sample t of ``x`` (E, ...) against mean zero, as
    ``scipy.stats.ttest_1samp(x, 0)``."""
    x = as_float32(x)
    return _t_from_sign_sums(x.sum(0), (x * x).sum(0), x.shape[0])


def _t_pooled(s1a, s2a, s1_tot, s2_tot, na: int, nb: int) -> torch.Tensor:
    """Pooled-variance independent-samples t from group-A sums and the
    (permutation-invariant) totals, as ``scipy.stats.ttest_ind`` with
    ``equal_var=True``."""
    ma = s1a / na
    mb = (s1_tot - s1a) / nb
    ssa = s2a - na * ma * ma
    ssb = (s2_tot - s2a) - nb * mb * mb
    sp2 = torch.clamp(ssa + ssb, min=0.0) / (na + nb - 2)
    denom = torch.sqrt(sp2 * (1.0 / na + 1.0 / nb))
    ok = denom > 0
    return torch.where(ok, (ma - mb) / torch.where(ok, denom, 1.0), 0.0)


def t_independent(xa, xb) -> torch.Tensor:
    """Pixelwise pooled-variance two-sample t of (Ea, ...) vs (Eb, ...)."""
    xa = as_float32(xa)
    xb = as_float32(xb, xa.device)
    s1a, s2a = xa.sum(0), (xa * xa).sum(0)
    s1t = s1a + xb.sum(0)
    s2t = s2a + (xb * xb).sum(0)
    return _t_pooled(s1a, s2a, s1t, s2t, xa.shape[0], xb.shape[0])


def _t_from_r(r: torch.Tensor, dof: int) -> torch.Tensor:
    """Regression / correlation t from Pearson r at ``dof = E - 2``, as
    ``scipy.stats.linregress`` / ``pearsonr``."""
    r = torch.clamp(r, -0.999999, 0.999999)
    return r * torch.sqrt(dof / torch.clamp(1.0 - r * r, min=1e-12))


def t_regression(x, z) -> torch.Tensor:
    """Pixelwise regression t of trial planes (E, ...) against a continuous
    per-trial covariate ``z`` (E,): the massive-univariate GLM slope
    statistic (the same t as the Pearson correlation's)."""
    x = as_float32(x)
    z = as_float32(z, x.device)
    zc = z - z.mean()
    xc = x - x.mean(0)
    with fp32_matmul("exact"):
        num = torch.tensordot(zc, xc, dims=([0], [0]))
    den = torch.sqrt(torch.clamp((zc * zc).sum() * (xc * xc).sum(0),
                                 min=1e-30))
    return _t_from_r(num / den, x.shape[0] - 2)


def _f_from_group_sums(sg: torch.Tensor, sizes: tuple,
                       sst: torch.Tensor) -> torch.Tensor:
    """One-way F maps from per-group sums of GRAND-CENTRED data.

    ``sg`` is (..., G, M) (M = flattened plane) and ``sst`` (M,); centring
    makes the grand sum zero (and permutation-invariant), so
    ``SS_between = sum_g S_g^2 / n_g`` with no grand-term cancellation, and
    ``SS_total = sum x^2`` is permutation-invariant.
    ``F = (SSB / (G - 1)) / ((SST - SSB) / (n - G))``.
    """
    g = len(sizes)
    n = sum(sizes)
    inv = torch.tensor([1.0 / s for s in sizes], dtype=torch.float32,
                       device=sg.device)
    ssb = (sg * sg * inv[:, None]).sum(-2)
    ssw = torch.clamp(sst - ssb, min=1e-30)
    return (ssb / (g - 1)) / (ssw / (n - g))


def _f_oneway(x: torch.Tensor, sizes: tuple) -> torch.Tensor:
    plane = x.shape[1:]
    xc = (x - x.mean(0)).reshape(x.shape[0], -1)
    sst = (xc * xc).sum(0)
    starts = np.cumsum((0,) + sizes[:-1])
    sg = torch.stack([xc[int(s):int(s) + sz].sum(0)
                      for s, sz in zip(starts, sizes)])       # (G, M)
    return _f_from_group_sums(sg, sizes, sst).reshape(plane)


def f_oneway(groups) -> torch.Tensor:
    """Pixelwise one-way ANOVA F over a sequence of (E_g, ...) trial stacks
    (the multi-condition analogue of ``t_independent``)."""
    groups = _as_groups(groups)
    sizes = tuple(int(x.shape[0]) for x in groups)
    return _f_oneway(torch.cat(groups, 0), sizes)


def _as_groups(groups) -> list:
    """The trial stacks as float32 tensors on the first one's device."""
    groups = list(groups)
    if not groups:
        return []
    first = as_float32(groups[0])
    return [first] + [as_float32(x, first.device) for x in groups[1:]]


# ---------------------------------------------------------------------------
# connected components + cluster mass (batched over leading axes)
# ---------------------------------------------------------------------------

def _plane_ndim(adjacency) -> int:
    """Cluster-plane rank: (F, N) alone, or (C, F, N) when a channel
    adjacency couples a leading sensor axis."""
    return 2 if adjacency is None else 3


def _edges(adjacency, device) -> torch.Tensor:
    """The (M, 2) int64 channel edges on ``device``."""
    if isinstance(adjacency, torch.Tensor):
        return adjacency.to(device=device, dtype=torch.int64).reshape(-1, 2)
    return torch.as_tensor(np.asarray(adjacency, np.int64).reshape(-1, 2),
                           device=device)


def label_components(mask, adjacency=None) -> torch.Tensor:
    """Connected-component labels of a boolean mask: 4-connectivity over
    the trailing (F, N) plane, plus, when ``adjacency`` (an (M, 2) int
    array of undirected channel edges) is given, same-pixel links between
    adjacent channels of a (..., C, F, N) mask (the spatio-spectral
    clustering of MNE's spatio_temporal_cluster_test).

    Each True pixel gets the MINIMUM flat plane index of its component;
    False pixels get the sentinel (the plane size).  Batched over all
    leading axes; int64.

    Fixed-point iteration (``_relax``): each round takes the minimum over
    the 4-neighbourhood (and the channel edges, two scatter-mins), hooks
    each pixel's root to it, then compresses paths by two pointer jumps
    (label <- label[label]), so long snakes converge in about
    log(diameter) rounds.  The host reads whether anything changed every
    ``_CHECK`` rounds.
    """
    if isinstance(mask, torch.Tensor):
        mask = mask.to(torch.bool)
    else:
        mask = torch.as_tensor(np.asarray(mask, bool),
                               device=resolve_device())
    pnd = _plane_ndim(adjacency)
    plane = tuple(mask.shape[-pnd:])
    fn = int(np.prod(plane))
    m = mask.reshape(-1, *plane)
    edges = None if adjacency is None else _edges(adjacency, mask.device)
    if edges is not None and edges.shape[0] == 0:
        edges = None
    # One (B, fn + 1) buffer: the labels, and a last column that holds the
    # sentinel, so that the pointer jump is one gather with no padding.
    idx = torch.arange(fn + 1, device=mask.device)
    buf = idx.repeat(m.shape[0], 1)
    buf[:, :fn].masked_fill_(~m.reshape(-1, fn), fn)
    off = ~m
    while True:
        before = buf
        for _ in range(_CHECK):
            buf = _relax(buf, off, plane, fn, edges)
        if torch.equal(before, buf):
            break
    return buf[:, :fn].reshape(mask.shape)


def _relax(buf, off, plane, fn, edges):
    """One round: the neighbour minimum (Jacobi: every shift reads the old
    labels) with the sentinel back on unmasked pixels; each pixel's root
    hooked to the smallest label the pixel saw (a scatter-min, so a smaller
    label reaches the whole component at the next jump, not one pixel a
    sweep); two pointer jumps (a gather each, far cheaper than a sweep:
    threshold masks of t-maps converge in about half the rounds of one)."""
    lab = buf[:, :fn].view(-1, *plane)
    nlab = lab.clone()
    for a, b in (((..., slice(None, -1), slice(None)),
                  (..., slice(1, None), slice(None))),
                 ((..., slice(1, None), slice(None)),
                  (..., slice(None, -1), slice(None))),
                 ((..., slice(None), slice(None, -1)),
                  (..., slice(None), slice(1, None))),
                 ((..., slice(None), slice(1, None)),
                  (..., slice(None), slice(None, -1)))):
        torch.minimum(nlab[a], lab[b], out=nlab[a])
    if edges is not None:
        for u, v in ((0, 1), (1, 0)):
            src = lab.index_select(1, edges[:, u])
            index = edges[:, v].view(1, -1, 1, 1).expand_as(src)
            nlab.scatter_reduce_(1, index, src, "amin")
    nlab.masked_fill_(off, fn)
    flat = nlab.view(-1, fn)
    old = buf[:, :fn]
    new = torch.cat([flat, buf[:, fn:]], 1)
    # Only a pixel that saw a smaller label hooks its root; every other one
    # targets its own slot (a no-op), so that the atomic mins of a large
    # component do not all contend for its root.
    own = torch.arange(fn, device=buf.device)
    new.scatter_reduce_(1, torch.where(flat < old, old, own), flat, "amin")
    new = torch.gather(new, 1, new)
    return torch.gather(new, 1, new)


def _mass_bins(vals: torch.Tensor, labels: torch.Tensor, fn: int,
               plane_ndim: int = 2) -> torch.Tensor:
    """Sum ``vals`` by component label into (..., fn + 1) float32 bins (the
    trailing sentinel bin stays 0), accumulated in float64 (the module
    docstring says why).

    A pixel-by-pixel scatter-add makes every pixel of a large component
    contend for its root's bin.  So each run of one label along a row is
    summed first, as a difference of the row's float64 running sums (exact
    under the docstring's condition, like every other partial sum), and
    only each run's last pixel adds into its root's bin; every other pixel
    adds 0 to its own slot."""
    batch = vals.shape[:-plane_ndim]
    n = vals.shape[-1]
    v = vals.reshape(-1, fn // n, n).double()
    lab = labels.reshape(-1, fn // n, n)
    run_end = torch.ones_like(lab, dtype=torch.bool)
    run_end[..., :-1] = lab[..., 1:] != lab[..., :-1]
    csum = v.cumsum(-1)
    # the running sum at the previous run's end (none: 0)
    pos = torch.arange(n, device=vals.device).expand_as(lab)
    last = torch.where(run_end, pos, -1).cummax(-1).values
    prev = torch.cat([torch.full_like(last[..., :1], -1), last[..., :-1]],
                     -1)
    before = torch.where(prev >= 0, csum.gather(-1, prev.clamp(min=0)), 0.0)
    hot = run_end & (lab < fn)
    own = torch.arange(fn, device=vals.device).view(fn // n, n)
    bins = torch.zeros((v.shape[0], fn + 1), dtype=torch.float64,
                       device=vals.device)
    bins.scatter_add_(1, torch.where(hot, lab, own).reshape(-1, fn),
                      torch.where(hot, csum - before, 0.0).reshape(-1, fn))
    return bins.float().reshape(*batch, fn + 1)


def _one_sign(signed, threshold: float, adjacency, fn: int, pnd: int):
    """Labels and per-root mass bins of the excursions ``signed >
    threshold``."""
    above = signed > threshold
    labels = label_components(above, adjacency)
    return labels, _mass_bins(torch.where(above, signed, 0.0), labels, fn,
                              pnd)


def cluster_mass(tmap, threshold: float, adjacency=None):
    """Two-sided cluster decomposition of a (..., F, N) t-map (or
    (..., C, F, N) with channel ``adjacency`` edges).

    Positive (t > thr) and negative (t < -thr) excursions are clustered
    SEPARATELY (same-sign pixels only, the Maris-Oostenveld convention);
    mass = sum of |t| over the component.  Returns
    ``(pos_labels, neg_labels, pos_bins, neg_bins, max_mass)`` where the
    bins are per-component masses indexed by root label and ``max_mass`` is
    the per-map maximum over BOTH signs (the null statistic).
    """
    tmap = as_float32(tmap)
    pnd = _plane_ndim(adjacency)
    fn = int(np.prod(tmap.shape[-pnd:]))
    (pos_l, pos_b), (neg_l, neg_b) = (
        _one_sign(signed, threshold, adjacency, fn, pnd)
        for signed in (tmap, -tmap))
    max_mass = torch.maximum(pos_b[..., :fn].amax(-1),
                             neg_b[..., :fn].amax(-1))
    return pos_l, neg_l, pos_b, neg_b, max_mass


def _max_mass(tmap: torch.Tensor, threshold: float,
              adjacency=None) -> torch.Tensor:
    """``cluster_mass(...)[4]``, holding one sign's labels at a time."""
    pnd = _plane_ndim(adjacency)
    fn = int(np.prod(tmap.shape[-pnd:]))
    return torch.maximum(*[
        _one_sign(signed, threshold, adjacency, fn, pnd)[1][..., :fn]
        .amax(-1) for signed in (tmap, -tmap)])


def tfce_map(tmap, start: float = 0.2, step: float = 0.4,
             stop: float = 40.0, e: float = 0.5, h: float = 2.0,
             adjacency=None) -> torch.Tensor:
    """Signed two-sided TFCE enhancement of a (..., F, N) t-map (Smith &
    Nichols 2009): at each ladder level ``l`` every suprathreshold pixel
    accrues ``extent(l)**e * l**h * step`` where ``extent`` is the size of
    its component; negative excursions are enhanced on ``-t`` and
    subtracted.  Removes the arbitrary cluster-forming threshold of the
    mass statistic.

    The ladder is ``arange(start, stop, step)`` in float32, as in the JAX
    package; the levels at or above the map's maximum contribute exactly 0
    (empty masks), so they are not labelled.  The other levels are labelled
    together, as one batch of at most ``_LEVEL_PIXELS`` pixels, and their
    gains added level by level in ascending order.  The observed map and the
    null must use the SAME ladder.
    """
    tmap = as_float32(tmap)
    pnd = _plane_ndim(adjacency)
    fn = int(np.prod(tmap.shape[-pnd:]))
    levels = np.arange(start, stop, step).astype(np.float32)

    def enhance(signed):
        acc = torch.zeros_like(signed)
        top = float(signed.max()) if signed.numel() else -np.inf
        live = levels[levels < top]
        per = max(1, _LEVEL_PIXELS // max(1, signed.numel()))
        for i in range(0, len(live), per):
            lv = torch.as_tensor(live[i:i + per], device=signed.device)
            lv = lv.view(-1, *[1] * signed.ndim)
            masks = signed > lv                        # (L, *signed.shape)
            labels = label_components(masks, adjacency)
            counts = _mass_bins(masks.float(), labels, fn, pnd)
            ext = counts.reshape(-1, fn + 1).gather(
                1, labels.reshape(-1, fn)).reshape(masks.shape)
            for gain in torch.where(masks, ext ** e * lv ** h * step, 0.0):
                acc += gain
        return acc

    return enhance(tmap) - enhance(-tmap)


# ---------------------------------------------------------------------------
# permutation draws (a torch.Generator; the JAX package's padded layout)
# ---------------------------------------------------------------------------

def _pad_perms(n_perm: int, chunk: int) -> int:
    return -(-n_perm // chunk)


def _generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def _perms(seed: int, total: int, n_obs: int, device) -> torch.Tensor:
    """(total, n_obs) independent uniform permutations."""
    gen = _generator(seed, device)
    return torch.rand((total, n_obs), generator=gen,
                      device=device).argsort(-1)


def sign_draws(seed: int, n_perm: int, n_obs: int, chunk: int = _CHUNK,
               device=None) -> torch.Tensor:
    """(n_chunks, chunk, E) Rademacher sign draws from a ``torch.Generator``
    seeded with ``seed`` on ``device`` (the card when None)."""
    device = resolve_device(device)
    n_chunks = _pad_perms(n_perm, chunk)
    bits = torch.randint(0, 2, (n_chunks * chunk, n_obs),
                         generator=_generator(seed, device), device=device)
    return (2.0 * bits - 1.0).float().reshape(n_chunks, chunk, n_obs)


def relabel_draws(seed: int, n_perm: int, n_obs: int, na: int,
                  chunk: int = _CHUNK, device=None) -> torch.Tensor:
    """(n_chunks, chunk, E) {0,1} group-A indicator draws: the first ``na``
    places of each uniform permutation."""
    device = resolve_device(device)
    n_chunks = _pad_perms(n_perm, chunk)
    total = n_chunks * chunk
    perms = _perms(seed, total, n_obs, device)
    ind = torch.zeros((total, n_obs), dtype=torch.float32, device=device)
    ind.scatter_(1, perms[:, :na], 1.0)
    return ind.reshape(n_chunks, chunk, n_obs)


def anova_draws(seed: int, n_perm: int, sizes: tuple, chunk: int = _CHUNK,
                device=None) -> torch.Tensor:
    """(n_chunks, chunk, G, E) one-hot group indicators under label
    permutations of the concatenated stack."""
    device = resolve_device(device)
    n_chunks = _pad_perms(n_perm, chunk)
    total = n_chunks * chunk
    g, n = len(sizes), sum(sizes)
    base = torch.repeat_interleave(
        torch.arange(g, device=device),
        torch.as_tensor(sizes, device=device))
    labs = base[_perms(seed, total, n, device)]
    ind = torch.nn.functional.one_hot(labs, g).transpose(1, 2).float()
    return ind.reshape(n_chunks, chunk, g, n)


def regression_draws(seed: int, n_perm: int, zc: torch.Tensor,
                     chunk: int = _CHUNK) -> torch.Tensor:
    """(n_chunks, chunk, E) rows of PERMUTED centred covariate values, the
    exchangeability scheme for a continuous regressor (Maris & Oostenveld:
    shuffle the covariate across trials), on ``zc``'s device."""
    n_chunks = _pad_perms(n_perm, chunk)
    perms = _perms(seed, n_chunks * chunk, zc.shape[0], zc.device)
    return zc[perms].reshape(n_chunks, chunk, zc.shape[0])


# ---------------------------------------------------------------------------
# permutation nulls: one contraction per chunk, one statistic per map
# ---------------------------------------------------------------------------

def _sign_t(signs, xf, s2, n_obs: int, plane: tuple) -> torch.Tensor:
    with fp32_matmul("exact"):
        s1 = signs @ xf
    return _t_from_sign_sums(s1, s2, n_obs).reshape(-1, *plane)


def _relabel_t(ind, xf, x2f, s1t, s2t, na: int, nb: int,
               plane: tuple) -> torch.Tensor:
    with fp32_matmul("exact"):
        s1a, s2a = ind @ xf, ind @ x2f
    return _t_pooled(s1a, s2a, s1t, s2t, na, nb).reshape(-1, *plane)


def _anova_f(ind, xf, sst, sizes: tuple, plane: tuple) -> torch.Tensor:
    ch, g, e = ind.shape
    with fp32_matmul("exact"):
        sg = (ind.reshape(ch * g, e) @ xf).reshape(ch, g, -1)
    return _f_from_group_sums(sg, sizes, sst).reshape(-1, *plane)


def _regression_t(zp, xf, x2, z2, dof: int, plane: tuple) -> torch.Tensor:
    with fp32_matmul("exact"):
        num = zp @ xf
    r = num / torch.sqrt(torch.clamp(z2 * x2, min=1e-30))
    return _t_from_r(r, dof).reshape(-1, *plane)


def sign_chunk_max_mass(signs, xf, s2, n_obs: int, threshold: float,
                        plane: tuple, adjacency=None) -> torch.Tensor:
    """Max cluster mass of every sign-flip t-map in one chunk: the (chunk,
    E) @ (E, prod(plane)) contraction and the clustering (``plane`` is
    (F, N), or (C, F, N) with channel ``adjacency``)."""
    return _max_mass(_sign_t(signs, xf, s2, n_obs, plane), threshold,
                     adjacency)


def relabel_chunk_max_mass(ind, xf, x2f, s1t, s2t, na: int, nb: int,
                           threshold: float, plane: tuple,
                           adjacency=None) -> torch.Tensor:
    """Max cluster mass of every relabeling t-map in one chunk (two
    indicator products)."""
    return _max_mass(_relabel_t(ind, xf, x2f, s1t, s2t, na, nb, plane),
                     threshold, adjacency)


def anova_chunk_max_mass(ind, xf, sst, sizes: tuple, threshold: float,
                         plane: tuple, adjacency=None) -> torch.Tensor:
    """Max cluster mass of every relabeled F-map in one chunk: the group
    sums are ONE (chunk * G, E) @ (E, M) product over the grand-centred
    stack; SS_total is permutation-invariant."""
    return _max_mass(_anova_f(ind, xf, sst, sizes, plane), threshold,
                     adjacency)


def regression_chunk_max_mass(zp, xf, x2, z2, dof: int, threshold: float,
                              plane: tuple, adjacency=None) -> torch.Tensor:
    """Max cluster mass of every permuted-covariate t-map in one chunk: the
    numerators are ONE (chunk, E) @ (E, plane) product; the variance terms
    are permutation-invariant."""
    return _max_mass(_regression_t(zp, xf, x2, z2, dof, plane), threshold,
                     adjacency)


def _scan(per_chunk, draws, n_perm: int, device) -> torch.Tensor:
    """``per_chunk`` over the (n_chunks, chunk, ...) draws, the first
    ``n_perm`` statistics."""
    draws = as_float32(draws, device)
    return torch.cat([per_chunk(d) for d in draws])[:n_perm]


def _sign_moments(x):
    e, plane = x.shape[0], tuple(x.shape[1:])
    xf = x.reshape(e, -1)
    return e, plane, xf, (xf * xf).sum(0)


def _relabel_moments(x, na: int):
    e, plane = x.shape[0], tuple(x.shape[1:])
    xf = x.reshape(e, -1)
    x2f = xf * xf
    return e - na, plane, xf, x2f, xf.sum(0), x2f.sum(0)


def _regression_moments(x, z):
    e, plane = x.shape[0], tuple(x.shape[1:])
    zc = z - z.mean()
    xc = (x - x.mean(0)).reshape(e, -1)
    return e, plane, zc, xc, (xc * xc).sum(0), (zc * zc).sum()


def _sign_flip_null_from_draws(x, signs, *, n_perm: int, threshold: float,
                               adjacency=None) -> torch.Tensor:
    """(P,) null of max cluster masses under the epoch sign flips
    ``signs`` (n_chunks, chunk, E); ``x`` is (E, F, N), or (E, C, F, N)
    with channel ``adjacency`` edges."""
    x = as_float32(x)
    e, plane, xf, s2 = _sign_moments(x)
    return _scan(lambda s: sign_chunk_max_mass(s, xf, s2, e, threshold,
                                               plane, adjacency),
                 signs, n_perm, x.device)


def _sign_flip_null(x, seed: int, *, n_perm: int, threshold: float,
                    chunk: int = _CHUNK, adjacency=None) -> torch.Tensor:
    """(P,) null of max cluster masses under epoch sign flips drawn from
    ``seed``."""
    x = as_float32(x)
    return _sign_flip_null_from_draws(
        x, sign_draws(seed, n_perm, x.shape[0], chunk, x.device),
        n_perm=n_perm, threshold=threshold, adjacency=adjacency)


def _relabel_null_from_draws(x, ind, *, n_perm: int, threshold: float,
                             na: int, adjacency=None) -> torch.Tensor:
    """(P,) null of max cluster masses under the group-A indicators ``ind``
    (n_chunks, chunk, E) of the concatenated stack (first ``na`` = group A
    in the observed split)."""
    x = as_float32(x)
    nb, plane, xf, x2f, s1t, s2t = _relabel_moments(x, na)
    return _scan(lambda d: relabel_chunk_max_mass(
        d, xf, x2f, s1t, s2t, na, nb, threshold, plane, adjacency),
        ind, n_perm, x.device)


def _relabel_null(x, seed: int, *, n_perm: int, threshold: float, na: int,
                  chunk: int = _CHUNK, adjacency=None) -> torch.Tensor:
    """(P,) null of max cluster masses under label permutations of the
    concatenated stack drawn from ``seed``."""
    x = as_float32(x)
    return _relabel_null_from_draws(
        x, relabel_draws(seed, n_perm, x.shape[0], na, chunk, x.device),
        n_perm=n_perm, threshold=threshold, na=na, adjacency=adjacency)


def _anova_null_from_draws(x, ind, *, n_perm: int, threshold: float,
                           sizes: tuple, adjacency=None) -> torch.Tensor:
    """(P,) null of max cluster masses under the one-hot group indicators
    ``ind`` (n_chunks, chunk, G, E) of the concatenated stack."""
    x = as_float32(x)
    e, plane = x.shape[0], tuple(x.shape[1:])
    xf = (x - x.mean(0)).reshape(e, -1)
    sst = (xf * xf).sum(0)
    return _scan(lambda d: anova_chunk_max_mass(d, xf, sst, sizes,
                                                threshold, plane, adjacency),
                 ind, n_perm, x.device)


def _anova_null(x, seed: int, *, n_perm: int, threshold: float,
                sizes: tuple, chunk: int = _CHUNK,
                adjacency=None) -> torch.Tensor:
    """(P,) null of max cluster masses under group relabelings drawn from
    ``seed`` (one-way F)."""
    x = as_float32(x)
    return _anova_null_from_draws(
        x, anova_draws(seed, n_perm, sizes, chunk, x.device), n_perm=n_perm,
        threshold=threshold, sizes=sizes, adjacency=adjacency)


def _regression_null_from_draws(x, z, draws, *, n_perm: int,
                                threshold: float,
                                adjacency=None) -> torch.Tensor:
    """(P,) null of max cluster masses under the permuted centred
    covariate rows ``draws`` (n_chunks, chunk, E)."""
    x = as_float32(x)
    z = as_float32(z, x.device)
    e, plane, _, xc, x2, z2 = _regression_moments(x, z)
    return _scan(lambda d: regression_chunk_max_mass(
        d, xc, x2, z2, e - 2, threshold, plane, adjacency),
        draws, n_perm, x.device)


def _regression_null(x, z, seed: int, *, n_perm: int, threshold: float,
                     chunk: int = _CHUNK, adjacency=None) -> torch.Tensor:
    """(P,) null of max cluster masses under covariate shuffles drawn from
    ``seed``."""
    x = as_float32(x)
    z = as_float32(z, x.device)
    zc = z - z.mean()
    return _regression_null_from_draws(
        x, z, regression_draws(seed, n_perm, zc, chunk), n_perm=n_perm,
        threshold=threshold, adjacency=adjacency)


# ---------------------------------------------------------------------------
# observed decomposition + results
# ---------------------------------------------------------------------------

class ClusterResult(NamedTuple):
    """Outcome of a cluster permutation test on an (F, N) plane.

    ``p_map`` holds, at every suprathreshold pixel, the corrected p-value
    of the cluster containing it (1.0 elsewhere); ``mass_map`` the SIGNED
    mass of that cluster; ``clusters`` a host-side list of
    ``{"sign", "mass", "size", "p"}`` dicts sorted by p; ``null_max`` the
    (P,) permutation distribution of the max cluster mass.
    """
    t_obs: np.ndarray
    threshold: float
    p_map: np.ndarray
    mass_map: np.ndarray
    null_max: np.ndarray
    clusters: list


def _exceed_p(stat: torch.Tensor, null: torch.Tensor) -> torch.Tensor:
    """``(#{null >= stat} + 1) / (P + 1)`` at every element of ``stat``
    (the +1 counts the observed arrangement as one permutation), counted
    through the sorted null."""
    srt = torch.sort(null.reshape(-1)).values
    below = torch.searchsorted(srt, stat.reshape(-1).contiguous())
    counts = (srt.shape[0] - below).reshape(stat.shape)
    return (counts.float() + 1.0) / (srt.shape[0] + 1.0)


def _observed_maps(t_obs: torch.Tensor, null_max: torch.Tensor, *,
                   threshold: float, adjacency=None):
    """Per-pixel corrected p and signed mass maps of the observed t-map
    against the permutation null."""
    fn = t_obs.numel()
    pos_l, neg_l, pos_b, neg_b, _ = cluster_mass(t_obs, threshold,
                                                 adjacency)
    pos_mass = pos_b[pos_l.reshape(fn)].reshape(t_obs.shape)
    neg_mass = neg_b[neg_l.reshape(fn)].reshape(t_obs.shape)
    mass_map = (torch.where(pos_l < fn, pos_mass, 0.0)
                - torch.where(neg_l < fn, neg_mass, 0.0))
    abs_mass = mass_map.abs()
    p_map = torch.where(abs_mass > 0, _exceed_p(abs_mass, null_max), 1.0)
    return p_map, mass_map, pos_l, neg_l


def _finish(t_obs, null_max, threshold: float,
            adjacency=None) -> ClusterResult:
    t_obs = as_float32(t_obs)
    null_max = as_float32(null_max, t_obs.device)
    p_map, mass_map, pos_l, neg_l = _observed_maps(
        t_obs, null_max, threshold=float(threshold), adjacency=adjacency)
    fn = t_obs.numel()
    clusters = []
    for labels, sign in ((pos_l, 1), (neg_l, -1)):
        flat = labels.reshape(fn)
        roots = torch.nonzero(flat == torch.arange(fn, device=flat.device)
                              ).reshape(-1)         # ascending, as np.unique
        sizes = torch.bincount(flat, minlength=fn + 1)[roots]
        mass = mass_map.reshape(fn)[roots].abs()
        p = p_map.reshape(fn)[roots]
        for s, m, pv in zip(sizes.tolist(), mass.cpu().numpy(),
                            p.cpu().numpy()):
            clusters.append({"sign": sign, "mass": float(m), "size": int(s),
                             "p": float(pv)})
    clusters.sort(key=lambda c: (c["p"], -c["mass"]))
    return ClusterResult(t_obs.cpu().numpy(), float(threshold),
                         p_map.cpu().numpy(), mass_map.cpu().numpy(),
                         null_max.cpu().numpy(), clusters)


def _resolve_threshold(threshold, alpha, dof) -> float:
    if threshold is not None:
        return float(threshold)
    return t_threshold(alpha, dof)


def _check_stack(x, adjacency, name="x"):
    want = 3 + (0 if adjacency is None else 1)
    if x.ndim != want:
        raise ValueError(
            "%s: expected %s, got shape %s" % (
                name,
                "(epochs, F, N)" if want == 3
                else "(epochs, C, F, N) with channel adjacency",
                (tuple(x.shape),)))


def cluster_test_one_sample(x, n_perm: int = 999,
                            threshold: Optional[float] = None,
                            alpha: float = 0.05, seed: int = 0,
                            null_max=None, adjacency=None) -> ClusterResult:
    """Cluster permutation test of ``mean(x) != 0`` over (E, F, N)
    single-trial planes, with epoch sign flips as the exchangeable null
    (valid when each trial's map is symmetric about 0 under H0, e.g.
    baseline-corrected power or a paired difference).

    ``threshold`` defaults to the two-sided t critical value at ``alpha``
    with E-1 degrees of freedom.  ``null_max`` lets a precomputed null be
    reused.  With ``adjacency`` (an (M, 2) array of undirected channel
    edges; an empty list keeps channels independent) ``x`` is (E, C, F, N)
    and clusters extend across adjacent channels (spatio-spectral
    clustering).  The sign flips come from a ``torch.Generator`` seeded
    with ``seed``.
    """
    x = as_float32(x)
    _check_stack(x, adjacency)
    if x.shape[0] < 2:
        raise ValueError("need at least 2 epochs")
    thr = _resolve_threshold(threshold, alpha, x.shape[0] - 1)
    if null_max is None:
        null_max = _sign_flip_null(x, seed, n_perm=n_perm, threshold=thr,
                                   adjacency=adjacency)
    return _finish(t_one_sample(x), null_max, thr, adjacency)


def cluster_test_paired(xa, xb, **kw) -> ClusterResult:
    """Paired-samples cluster test: the one-sample sign-flip test on the
    per-epoch difference ``xa - xb`` (epochs must correspond)."""
    xa = as_float32(xa)
    xb = as_float32(xb, xa.device)
    if xa.shape != xb.shape:
        raise ValueError("paired conditions must have equal shapes")
    return cluster_test_one_sample(xa - xb, **kw)


def cluster_test_regression(x, z, n_perm: int = 999,
                            threshold: Optional[float] = None,
                            alpha: float = 0.05, seed: int = 0,
                            null_max=None, adjacency=None) -> ClusterResult:
    """Cluster permutation test of a CONTINUOUS per-trial covariate
    (reaction time, stimulus intensity, age...) against single-trial
    planes: pixelwise regression t (= Pearson-r t, dof E-2), covariate
    values shuffled across trials for the null.  ``x`` is (E, F, N), or
    (E, C, F, N) with channel ``adjacency``; ``z`` is (E,)."""
    x = as_float32(x)
    z = as_float32(z, x.device)
    _check_stack(x, adjacency, "x")
    e = x.shape[0]
    if tuple(z.shape) != (e,):
        raise ValueError(f"covariate must be ({e},), got {tuple(z.shape)}")
    if e < 4:
        raise ValueError("regression needs at least 4 trials")
    thr = _resolve_threshold(threshold, alpha, e - 2)
    if null_max is None:
        null_max = _regression_null(x, z, seed, n_perm=n_perm,
                                    threshold=thr, adjacency=adjacency)
    return _finish(t_regression(x, z), null_max, thr, adjacency)


def cluster_test_independent(xa, xb, n_perm: int = 999,
                             threshold: Optional[float] = None,
                             alpha: float = 0.05, seed: int = 0,
                             null_max=None, adjacency=None) -> ClusterResult:
    """Cluster permutation test of equal means between independent trial
    groups (Ea, F, N) vs (Eb, F, N): pooled-variance t, condition labels
    permuted across the concatenated stack.  With ``adjacency`` the groups
    are (E, C, F, N) and clusters extend across channel edges."""
    xa = as_float32(xa)
    xb = as_float32(xb, xa.device)
    _check_stack(xa, adjacency, "xa")
    _check_stack(xb, adjacency, "xb")
    if xa.shape[1:] != xb.shape[1:]:
        raise ValueError("group planes must match, got %s and %s"
                         % (tuple(xa.shape), tuple(xb.shape)))
    na, nb = xa.shape[0], xb.shape[0]
    if na < 2 or nb < 2:
        raise ValueError("need at least 2 epochs per group")
    thr = _resolve_threshold(threshold, alpha, na + nb - 2)
    if null_max is None:
        null_max = _relabel_null(torch.cat([xa, xb], 0), seed,
                                 n_perm=n_perm, threshold=thr, na=na,
                                 adjacency=adjacency)
    return _finish(t_independent(xa, xb), null_max, thr, adjacency)


def cluster_test_f(groups, n_perm: int = 999,
                   threshold: Optional[float] = None, alpha: float = 0.05,
                   seed: int = 0, null_max=None,
                   adjacency=None) -> ClusterResult:
    """Cluster permutation test of equal means across G >= 2 independent
    trial groups (one-way ANOVA, the multi-condition generalization of
    ``cluster_test_independent``): pixelwise F maps, condition labels
    permuted across the concatenated stack.  Each group is (E_g, F, N), or
    (E_g, C, F, N) with channel ``adjacency``.

    ``threshold`` defaults to the F critical value at ``alpha`` with
    (G-1, n-G) degrees of freedom.  F is one-sided, so all clusters are
    positive; the returned ``ClusterResult.t_obs`` holds the F map.
    """
    groups = _as_groups(groups)
    if len(groups) < 2:
        raise ValueError("need at least 2 groups")
    for x in groups:
        _check_stack(x, adjacency, "group")
        if x.shape[0] < 2:
            raise ValueError("need at least 2 epochs per group")
    plane = groups[0].shape[1:]
    if any(x.shape[1:] != plane for x in groups):
        raise ValueError("group planes must match")
    sizes = tuple(int(x.shape[0]) for x in groups)
    n, g = sum(sizes), len(sizes)
    if threshold is None:
        threshold = f_threshold(alpha, g - 1, n - g)
    thr = float(threshold)
    x = torch.cat(groups, 0)
    if null_max is None:
        null_max = _anova_null(x, seed, n_perm=n_perm, threshold=thr,
                               sizes=sizes, adjacency=adjacency)
    return _finish(_f_oneway(x, sizes), null_max, thr, adjacency)


# ---------------------------------------------------------------------------
# TFCE permutation tests (pixelwise corrected p, no threshold choice)
# ---------------------------------------------------------------------------

class TfceResult(NamedTuple):
    """Outcome of a TFCE permutation test: ``p_map`` is the pixelwise
    FWER-corrected p-value of the signed enhancement ``tfce_obs`` against
    the (P,) null of max-|TFCE| values."""
    t_obs: np.ndarray
    tfce_obs: np.ndarray
    p_map: np.ndarray
    null_max: np.ndarray


def _max_abs(maps: torch.Tensor) -> torch.Tensor:
    return maps.abs().reshape(maps.shape[0], -1).amax(-1)


def _sign_flip_tfce_null_from_draws(x, signs, *, n_perm: int,
                                    adjacency=None, **kw) -> torch.Tensor:
    """(P,) null of max |TFCE| under the sign flips ``signs``."""
    x = as_float32(x)
    e, plane, xf, s2 = _sign_moments(x)
    return _scan(lambda s: _max_abs(tfce_map(
        _sign_t(s, xf, s2, e, plane), adjacency=adjacency, **kw)),
        signs, n_perm, x.device)


def _relabel_tfce_null_from_draws(x, ind, *, n_perm: int, na: int,
                                  adjacency=None, **kw) -> torch.Tensor:
    """(P,) null of max |TFCE| under the group-A indicators ``ind``."""
    x = as_float32(x)
    nb, plane, xf, x2f, s1t, s2t = _relabel_moments(x, na)
    return _scan(lambda d: _max_abs(tfce_map(
        _relabel_t(d, xf, x2f, s1t, s2t, na, nb, plane),
        adjacency=adjacency, **kw)), ind, n_perm, x.device)


def _tfce_finish(t_obs, null_max, kw, adjacency=None) -> TfceResult:
    enh = tfce_map(t_obs, adjacency=adjacency, **kw)
    p = _exceed_p(enh.abs(), null_max)
    return TfceResult(t_obs.cpu().numpy(), enh.cpu().numpy(),
                      p.cpu().numpy(), null_max.cpu().numpy())


def tfce_test_one_sample(x, n_perm: int = 199, seed: int = 0,
                         start: float = 0.2, step: float = 0.4,
                         stop: float = 40.0, e: float = 0.5, h: float = 2.0,
                         adjacency=None) -> TfceResult:
    """TFCE permutation test of ``mean(x) != 0`` over (E, F, N) trial
    planes (sign-flip null): the threshold-free alternative to
    ``cluster_test_one_sample`` with pixelwise corrected p-values.  Costs
    up to ``(stop - start) / step`` labelings per permutation map (levels
    above a chunk's largest |t| are skipped)."""
    x = as_float32(x)
    _check_stack(x, adjacency)
    if x.shape[0] < 2:
        raise ValueError("need at least 2 epochs")
    kw = dict(start=start, step=step, stop=stop, e=e, h=h)
    null = _sign_flip_tfce_null_from_draws(
        x, sign_draws(seed, n_perm, x.shape[0], _CHUNK, x.device),
        n_perm=n_perm, adjacency=adjacency, **kw)
    return _tfce_finish(t_one_sample(x), null, kw, adjacency)


def tfce_test_independent(xa, xb, n_perm: int = 199, seed: int = 0,
                          start: float = 0.2, step: float = 0.4,
                          stop: float = 40.0, e: float = 0.5,
                          h: float = 2.0, adjacency=None) -> TfceResult:
    """TFCE permutation test between independent trial groups (relabeling
    null, pooled-variance t).  With ``adjacency`` the groups are
    (E, C, F, N) and the enhancement extends across channel edges."""
    xa = as_float32(xa)
    xb = as_float32(xb, xa.device)
    _check_stack(xa, adjacency, "xa")
    _check_stack(xb, adjacency, "xb")
    if xa.shape[1:] != xb.shape[1:]:
        raise ValueError("group planes must match, got %s and %s"
                         % (tuple(xa.shape), tuple(xb.shape)))
    kw = dict(start=start, step=step, stop=stop, e=e, h=h)
    x = torch.cat([xa, xb], 0)
    na = xa.shape[0]
    null = _relabel_tfce_null_from_draws(
        x, relabel_draws(seed, n_perm, x.shape[0], na, _CHUNK, x.device),
        n_perm=n_perm, na=na, adjacency=adjacency, **kw)
    return _tfce_finish(t_independent(xa, xb), null, kw, adjacency)


# ---------------------------------------------------------------------------
# max-statistic correction (no clustering: exact pixelwise FWER)
# ---------------------------------------------------------------------------

def _sign_flip_maxt_from_draws(x, signs, *, n_perm: int) -> torch.Tensor:
    x = as_float32(x)
    e, _, xf, s2 = _sign_moments(x)
    return _scan(lambda s: _max_abs(_sign_t(s, xf, s2, e, xf.shape[1:])),
                 signs, n_perm, x.device)


def _relabel_maxt_from_draws(x, ind, *, n_perm: int,
                             na: int) -> torch.Tensor:
    x = as_float32(x)
    nb, _, xf, x2f, s1t, s2t = _relabel_moments(x, na)
    return _scan(lambda d: _max_abs(_relabel_t(d, xf, x2f, s1t, s2t, na,
                                               nb, xf.shape[1:])),
                 ind, n_perm, x.device)


def _regression_maxt_from_draws(x, z, draws, *, n_perm: int) -> torch.Tensor:
    x = as_float32(x)
    z = as_float32(z, x.device)
    e, _, _, xc, x2, z2 = _regression_moments(x, z)
    return _scan(lambda d: _max_abs(_regression_t(d, xc, x2, z2, e - 2,
                                                  xc.shape[1:])),
                 draws, n_perm, x.device)


def _maxt_pmap(t_obs, null):
    p = _exceed_p(t_obs.abs(), null)
    return t_obs.cpu().numpy(), p.cpu().numpy()


def max_stat_test_one_sample(x, n_perm: int = 999, seed: int = 0):
    """(t_map, p_map) under the max-|t| sign-flip null: strong pixelwise
    FWER control with no clustering (conservative for smooth effects,
    exact for focal ones)."""
    x = as_float32(x)
    null = _sign_flip_maxt_from_draws(
        x, sign_draws(seed, n_perm, x.shape[0], _CHUNK, x.device),
        n_perm=n_perm)
    return _maxt_pmap(t_one_sample(x), null)


def max_stat_test_independent(xa, xb, n_perm: int = 999, seed: int = 0):
    """(t_map, p_map) under the max-|t| relabeling null for independent
    groups."""
    xa = as_float32(xa)
    xb = as_float32(xb, xa.device)
    x = torch.cat([xa, xb], 0)
    na = xa.shape[0]
    null = _relabel_maxt_from_draws(
        x, relabel_draws(seed, n_perm, x.shape[0], na, _CHUNK, x.device),
        n_perm=n_perm, na=na)
    return _maxt_pmap(t_independent(xa, xb), null)


def max_stat_test_regression(x, z, n_perm: int = 999, seed: int = 0):
    """(t_map, p_map) of a continuous covariate under the max-|t|
    covariate-shuffle null (see ``cluster_test_regression``)."""
    x = as_float32(x)
    z = as_float32(z, x.device)
    if tuple(z.shape) != (x.shape[0],):
        raise ValueError(f"covariate must be ({x.shape[0]},), got "
                         f"{tuple(z.shape)}")
    zc = z - z.mean()
    null = _regression_maxt_from_draws(
        x, z, regression_draws(seed, n_perm, zc, _CHUNK), n_perm=n_perm)
    return _maxt_pmap(t_regression(x, z), null)


def fdr_correction(p, alpha: float = 0.05, method: str = "bh"):
    """``(reject, p_adjusted)``: step-up false-discovery-rate control over
    every element of a p-value map of any shape: Benjamini-Hochberg
    (``"bh"``, valid under independence or positive regression dependence,
    the usual choice for TF maps) or Benjamini-Yekutieli (``"by"``, valid
    under arbitrary dependence).  ``reject = p_adjusted <= alpha``.
    """
    if method not in ("bh", "by"):
        raise ValueError("method must be 'bh' or 'by'")
    p = as_float32(p)
    flat = p.reshape(-1)
    m = flat.shape[0]
    ranked, order = torch.sort(flat, stable=True)
    denom = torch.arange(1, m + 1, dtype=torch.float32, device=p.device)
    factor = m / denom
    if method == "by":
        factor = factor * (1.0 / denom).sum()
    adj = ranked * factor
    # step-up: adjusted p_(i) = min over j >= i of p_(j) * m / j
    adj = torch.flip(torch.cummin(torch.flip(adj, (0,)), 0).values, (0,))
    adj = torch.clamp(adj, 0.0, 1.0)
    p_adj = torch.empty_like(flat).scatter_(0, order, adj).reshape(p.shape)
    return p_adj <= alpha, p_adj
