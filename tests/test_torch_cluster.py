"""The port's statistics (``ninwavelets_tpu_torch.ops.cluster`` and
``ops.bootstrap``, and the adapter's ``cluster_*`` methods) against the JAX
package on the same seeded inputs, on the CPU, and against
``tests/test_cluster.py``'s numpy oracles (``_numpy_max_mass``,
``_numpy_tfce``, ``_union_find_labels``), ``scipy.ndimage.label`` and
``scipy.stats``.  Nothing here reaches a Pallas kernel in the JAX package.

The two packages draw permutations from different generators, so every
null is fed the JAX package's own draws (``jc.sign_draws`` ... as its nulls
draw them) through its ``*_from_draws`` entry, and the adapter tests swap
the port's draw functions for the JAX package's.

Gates, each with its reason:

* labels: exact.  A converged label is the minimum flat index of its
  component, which is unique;
* t and F maps: 1e-5 of max|t| (float32 sums and products in another
  order);
* cluster masses, TFCE values and ``null_max``: rtol 1e-5.  The port sums a
  cluster in float64 (exact, ``test_mass_is_the_exact_sum``), the JAX
  package in float32 in XLA's order;
* p-values: a p is ``(1 + #{null >= stat}) / (P + 1)``, so the two
  packages' counts may differ only by the null values within rtol 1e-5 of
  the statistic (``_check_p``), plus the permutations left out by the next
  rule;
* a pixel whose statistic lies within ``NEAR`` = 1e-4 of a threshold (or of
  a TFCE level) may fall on either side of it in the two packages.  So the
  tests' thresholds are moved off the observed maps by rule
  (``_clear_threshold``: the first of thr, thr + 1e-3, ... with no pixel
  within NEAR), and a permutation whose float64 statistic map has a pixel
  within NEAR of the threshold (or of a level) is not compared
  (``_ambiguous``);
* bootstrap bounds: 1e-5 of the plane max, given the JAX package's counts;
* FDR: 1e-6 against JAX and against scipy.

The adapter tests compare with the JAX adapter on the same seeded
``ArrayEpochs``: the single-trial power planes differ at float32 round-off
(held in ``tests/test_torch_zoo.py``), so their t-maps are gated at 1e-4 of
max|t| and ``NEAR_ADAPTER`` = 1e-3 replaces NEAR there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage, stats

import ninwavelets_tpu as nw
import ninwavelets_tpu_torch as nt
from ninwavelets_tpu.ops import bootstrap as jbs
from ninwavelets_tpu.ops import cluster as jc
from ninwavelets_tpu_torch.ops import bootstrap as tbs
from ninwavelets_tpu_torch.ops import cluster as tc

from test_cluster import _numpy_max_mass, _numpy_tfce, _union_find_labels
from torch_threads import one_torch_thread  # noqa: F401

T_GATE = 1e-5
RTOL = 1e-5
NEAR = 1e-4
NEAR_ADAPTER = 1e-3
ADAPTER_T_GATE = 1e-4
FDR_ATOL = 1e-6
TFCE_KW = dict(start=0.5, step=0.5, stop=8.0, e=0.5, h=2.0)


def _rng(seed):
    return np.random.default_rng(seed)


def _noise(e=12, f=6, n=20, seed=7):
    return _rng(seed).standard_normal((e, f, n)).astype(np.float32)


def _effect(e=12, f=6, n=20, amp=3.0, seed=7):
    x = _noise(e, f, n, seed)
    x[:, 2:4, 5:12] += amp
    return x


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                      else x)


def _key(seed):
    return jax.random.PRNGKey(seed)


# -- the JAX package's draws, as its nulls draw them ----------------------

def _jax_signs(seed, n_perm, e, chunk=64):
    return np.array(jc.sign_draws(_key(seed), n_perm, e, chunk))


def _jax_relabel(seed, n_perm, e, na, chunk=64):
    return np.array(jc.relabel_draws(_key(seed), n_perm, e, na, chunk))


def _jax_anova(seed, n_perm, sizes, chunk=64):
    return np.array(jc.anova_draws(_key(seed), n_perm, sizes, chunk))


def _jax_regression(seed, n_perm, z, chunk=64):
    z = jnp.asarray(z, jnp.float32)
    return np.array(jc.regression_draws(_key(seed), n_perm, z - jnp.mean(z),
                                        chunk))


# -- float64 statistic maps of each permutation (the rule's input) --------

def _sign_maps(x, signs, n_perm):
    s = signs.reshape(-1, x.shape[0])[:n_perm].astype(np.float64)
    return np.stack([stats.ttest_1samp(sp.reshape(-1, *[1] * (x.ndim - 1))
                                       * x.astype(np.float64), 0.0,
                                       axis=0).statistic for sp in s])


def _relabel_maps(x, ind, n_perm):
    rows = ind.reshape(-1, x.shape[0])[:n_perm] > 0.5
    x64 = x.astype(np.float64)
    return np.stack([stats.ttest_ind(x64[r], x64[~r], axis=0,
                                     equal_var=True).statistic
                     for r in rows])


def _anova_maps(x, ind, n_perm):
    g = ind.shape[-2]
    labs = ind.reshape(-1, g, x.shape[0])[:n_perm].argmax(1)
    x64 = x.astype(np.float64)
    return np.stack([stats.f_oneway(*[x64[lab == k] for k in range(g)],
                                    axis=0).statistic for lab in labs])


def _regression_maps(x, draws, n_perm):
    zp = draws.reshape(-1, x.shape[0])[:n_perm].astype(np.float64)
    xc = x.astype(np.float64) - x.astype(np.float64).mean(0)
    zc = zp - zp.mean(-1, keepdims=True)
    num = np.tensordot(zc, xc, axes=(1, 0))
    den = np.sqrt((zc * zc).sum(-1).reshape(-1, *[1] * (x.ndim - 1))
                  * (xc * xc).sum(0))
    r = num / den
    return r * np.sqrt((x.shape[0] - 2) / (1 - r * r))


def _ambiguous(maps, thr, near=NEAR):
    """(P,) True where a permutation's map has a pixel within ``near`` of
    +-thr (it may fall on either side in the two packages)."""
    a = np.abs(maps).reshape(maps.shape[0], -1)
    return (np.abs(a - thr) < near).any(-1)


def _level_ambiguous(maps, kw=TFCE_KW, near=NEAR):
    levels = np.arange(kw["start"], kw["stop"], kw["step"])
    a = np.abs(maps).reshape(maps.shape[0], -1)
    return (np.abs(a[..., None] - levels) < near).any((-1, -2))


def _clear_threshold(tmap, thr, near=NEAR):
    """The first of thr, thr + 1e-3, ... with no |t| within ``near``."""
    a = np.abs(np.asarray(tmap, np.float64))
    while (np.abs(a - thr) < near).any():
        thr += 1e-3
    return thr


# -- comparisons ---------------------------------------------------------

def _check_t(got, want, gate=T_GATE):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= gate * np.abs(want).max()


def _check_null(got, want, skip=None, oracle=None, rtol=RTOL):
    """``null_max`` at ``rtol`` against JAX (and against the float64
    oracle at ``tests/test_cluster.py``'s 5e-4), the ambiguous permutations
    left out."""
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape
    keep = np.ones(got.shape, bool) if skip is None else ~skip
    np.testing.assert_allclose(got[keep], want[keep], rtol=rtol, atol=0)
    if oracle is not None:
        np.testing.assert_allclose(got[keep], oracle[keep], rtol=5e-4,
                                   atol=5e-4)
    return int((~keep).sum())


def _check_p(p_got, p_want, stat, null, slack=0, rtol=RTOL):
    """The count rule: each p's count of null values at or above its
    statistic may differ from JAX's only by the null values within rtol of
    the statistic (and the ``slack`` permutations left out)."""
    p_got, p_want = _np(p_got).ravel(), np.asarray(p_want).ravel()
    stat = np.abs(np.asarray(stat, np.float64)).ravel()
    null = np.asarray(null, np.float64)
    c_got = np.rint(p_got * (null.size + 1)) - 1
    c_want = np.rint(p_want * (null.size + 1)) - 1
    near = (np.abs(null[None, :] - stat[:, None])
            <= rtol * stat[:, None]).sum(-1)
    bad = np.abs(c_got - c_want) > near + slack
    assert not bad.any(), (p_got[bad], p_want[bad], stat[bad])


def _check_result(got, want, slack=0, t_gate=T_GATE, rtol=RTOL):
    """A ClusterResult against JAX's: t map, masks, masses, p map and the
    cluster list (sign, size, order; mass and p by the rules)."""
    _check_t(got.t_obs, want.t_obs, t_gate)
    assert got.threshold == want.threshold
    np.testing.assert_array_equal(got.mass_map != 0, want.mass_map != 0)
    np.testing.assert_allclose(got.mass_map, want.mass_map, rtol=rtol,
                               atol=0)
    _check_p(got.p_map, want.p_map, want.mass_map, want.null_max, slack,
             rtol)
    assert len(got.clusters) == len(want.clusters)
    key = lambda c: (c["sign"], c["size"], round(c["mass"], 2))
    for a, b in zip(sorted(got.clusters, key=key),
                    sorted(want.clusters, key=key)):
        assert (a["sign"], a["size"]) == (b["sign"], b["size"])
        assert a["mass"] == pytest.approx(b["mass"], rel=rtol)
        _check_p([a["p"]], [b["p"]], [b["mass"]], want.null_max, slack,
                 rtol)
    if [c["p"] for c in got.clusters] == [c["p"] for c in want.clusters]:
        assert ([(c["sign"], c["size"]) for c in got.clusters]
                == [(c["sign"], c["size"]) for c in want.clusters])


def _sorted_by_p(res):
    keys = [(c["p"], -c["mass"]) for c in res.clusters]
    return keys == sorted(keys)


class TestTStats:
    def test_one_sample_matches_jax_and_scipy(self):
        x = _noise()
        t = tc.t_one_sample(_t(x))
        _check_t(t, jc.t_one_sample(x))
        ref = stats.ttest_1samp(x.astype(np.float64), 0.0, axis=0).statistic
        np.testing.assert_allclose(_np(t), ref, rtol=2e-4, atol=2e-4)

    def test_independent_matches_jax_and_scipy(self):
        xa, xb = _noise(10, seed=1), _noise(14, seed=2)
        t = tc.t_independent(_t(xa), _t(xb))
        _check_t(t, jc.t_independent(xa, xb))
        ref = stats.ttest_ind(xa.astype(np.float64), xb.astype(np.float64),
                              axis=0, equal_var=True).statistic
        np.testing.assert_allclose(_np(t), ref, rtol=2e-4, atol=2e-4)

    def test_zero_variance_pixels_give_zero_t(self):
        x = torch.ones((8, 3, 4))
        assert bool((tc.t_one_sample(x) == 0.0).all())
        assert bool((tc.t_independent(x, x) == 0.0).all())

    def test_regression_matches_jax_and_scipy(self):
        rng = _rng(5)
        x = rng.standard_normal((16, 4, 7)).astype(np.float32)
        z = rng.standard_normal(16).astype(np.float32)
        t = tc.t_regression(_t(x), _t(z))
        _check_t(t, jc.t_regression(x, z))
        r = np.array([[stats.pearsonr(z.astype(np.float64),
                                      x[:, i, j].astype(np.float64))[0]
                       for j in range(7)] for i in range(4)])
        np.testing.assert_allclose(_np(t), r * np.sqrt(14 / (1 - r * r)),
                                   rtol=2e-4, atol=2e-4)

    @pytest.mark.parametrize("alpha,dof", [(0.05, 11), (0.01, 30)])
    def test_thresholds_match_jax(self, alpha, dof):
        assert tc.t_threshold(alpha, dof) == jc.t_threshold(alpha, dof)
        assert tc.f_threshold(alpha, 2, dof) == jc.f_threshold(alpha, 2,
                                                               dof)


class TestLabeling:
    @staticmethod
    def _check(mask, adjacency=None):
        ours = _np(tc.label_components(torch.from_numpy(mask), adjacency))
        want = np.asarray(jc.label_components(mask, adjacency))
        np.testing.assert_array_equal(ours, want)
        return ours

    @pytest.mark.parametrize("p", [0.2, 0.5, 0.8])
    def test_matches_jax_and_scipy(self, p):
        mask = _rng(int(p * 10)).random((9, 17)) < p
        ours = self._check(mask)
        ref, n_ref = ndimage.label(mask)
        assert np.all((ours < mask.size) == mask)
        pairs = set(zip(ref[mask].ravel(), ours[mask].ravel()))
        assert len(pairs) == n_ref == len(np.unique(ours[mask]))

    def test_batched(self):
        masks = _rng(3).random((5, 7, 13)) < 0.45
        self._check(masks)

    def test_snake_converges(self):
        # a long boustrophedon path stresses the pointer jumping
        mask = np.zeros((10, 10), bool)
        for r in range(10):
            mask[r, :] = True
            if r % 2 == 0:
                mask[r, 0] = r == 0
        mask[:, -1] = True
        ours = self._check(mask)
        assert len(np.unique(ours[mask])) == 1

    def test_long_spiral_converges(self):
        # one 1-pixel-wide spiral over a 31 x 31 plane: a component whose
        # diameter is most of its 500-odd pixels
        n = 31
        mask = np.zeros((n, n), bool)
        r0, c0, r1, c1 = 0, 0, n - 1, n - 1
        while r0 <= r1 and c0 <= c1:
            mask[r0, c0:c1 + 1] = mask[r0:r1 + 1, c1] = True
            mask[r1, c0:c1 + 1] = True
            mask[r0 + 2:r1 + 1, c0] = True
            if r0 + 2 <= r1:
                mask[r0 + 2, c0:c1 - 1] = True
            r0, c0, r1, c1 = r0 + 2, c0 + 2, r1 - 2, c1 - 2
        ours = self._check(mask)
        _, k = ndimage.label(mask)
        assert len(np.unique(ours[mask])) == k

    def test_diagonal_pixels_are_separate(self):
        mask = np.eye(4, dtype=bool)
        ours = self._check(mask)
        assert len(np.unique(ours[mask])) == 4

    @pytest.mark.parametrize("fill", [False, True])
    def test_empty_and_full_masks(self, fill):
        mask = np.full((2, 3, 5), fill)
        ours = self._check(mask)
        assert np.all(ours == (0 if fill else 15))


class TestClusterMass:
    def test_matches_jax_and_numpy(self):
        t = (_rng(4).standard_normal((4, 8, 15)) * 2.0).astype(np.float32)
        got = tc.cluster_mass(_t(t), 1.5)
        want = jc.cluster_mass(jnp.asarray(t), 1.5)
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(_np(g), np.asarray(w))
        for g, w in zip(got[2:], want[2:]):
            np.testing.assert_allclose(_np(g), np.asarray(w), rtol=RTOL,
                                       atol=0)
        for b in range(4):
            assert float(got[4][b]) == pytest.approx(
                _numpy_max_mass(t[b], 1.5), rel=RTOL)

    def test_mass_is_the_exact_sum(self):
        # every |t| above 0.25 is a multiple of 2^-25: the float64 sum is
        # exact, so each mass is the correctly rounded sum of its pixels
        t = (_rng(9).standard_normal((3, 16, 40)) * 3.0).astype(np.float32)
        pos_l, _, pos_b, _, _ = tc.cluster_mass(_t(t), 0.5)
        pos_l, pos_b = _np(pos_l), _np(pos_b)
        for b in range(3):
            for root in np.unique(pos_l[b][pos_l[b] < t[b].size]):
                vals = t[b][pos_l[b] == root].astype(np.float64)
                exact = np.float32(sum(sorted(vals)))
                assert pos_b[b, root] == exact

    def test_no_excursions_zero_mass(self):
        mx = tc.cluster_mass(torch.zeros((2, 4, 4)), 1.0)[4]
        assert bool((mx == 0.0).all())


class TestNullOracle:
    def test_sign_flip_null_matches_jax_and_numpy(self):
        x = _noise(e=8, f=5, n=9, seed=11)
        n_perm, chunk, thr = 10, 4, 1.2
        want = np.asarray(jc._sign_flip_null(
            jnp.asarray(x), _key(3), n_perm=n_perm, threshold=thr,
            chunk=chunk))
        signs = _jax_signs(3, n_perm, 8, chunk)
        got = tc._sign_flip_null_from_draws(_t(x), signs, n_perm=n_perm,
                                            threshold=thr)
        maps = _sign_maps(x, signs, n_perm)
        oracle = np.array([_numpy_max_mass(m, thr) for m in maps])
        _check_null(got, want, _ambiguous(maps, thr), oracle)

    def test_relabel_null_matches_jax_and_numpy(self):
        x = np.concatenate([_noise(6, 4, 7, 1), _noise(5, 4, 7, 2)], 0)
        n_perm, chunk, thr, na = 8, 8, 1.0, 6
        want = np.asarray(jc._relabel_null(
            jnp.asarray(x), _key(11), n_perm=n_perm, threshold=thr, na=na,
            chunk=chunk))
        ind = _jax_relabel(11, n_perm, 11, na, chunk)
        got = tc._relabel_null_from_draws(_t(x), ind, n_perm=n_perm,
                                          threshold=thr, na=na)
        maps = _relabel_maps(x, ind, n_perm)
        oracle = np.array([_numpy_max_mass(m, thr) for m in maps])
        _check_null(got, want, _ambiguous(maps, thr), oracle)

    def test_regression_null_matches_jax_and_numpy(self):
        rng = _rng(12)
        x = rng.standard_normal((14, 4, 9)).astype(np.float32)
        z = rng.standard_normal(14).astype(np.float32)
        n_perm, chunk, thr = 12, 8, 1.5
        want = np.asarray(jc._regression_null(
            jnp.asarray(x), jnp.asarray(z), _key(5), n_perm=n_perm,
            threshold=thr, chunk=chunk))
        draws = _jax_regression(5, n_perm, z, chunk)
        got = tc._regression_null_from_draws(_t(x), _t(z), draws,
                                             n_perm=n_perm, threshold=thr)
        maps = _regression_maps(x, draws, n_perm)
        oracle = np.array([_numpy_max_mass(m, thr) for m in maps])
        _check_null(got, want, _ambiguous(maps, thr), oracle)

    def test_port_draws(self):
        """The port's own draws: the JAX package's layout and meaning, one
        seed one draw."""
        s = tc.sign_draws(1, 70, 9, 32, "cpu")
        assert s.shape == (3, 32, 9) and bool((s.abs() == 1).all())
        assert torch.equal(s, tc.sign_draws(1, 70, 9, 32, "cpu"))
        assert not torch.equal(s, tc.sign_draws(2, 70, 9, 32, "cpu"))
        ind = tc.relabel_draws(1, 70, 9, 4, 32, "cpu")
        assert ind.shape == (3, 32, 9)
        assert bool((ind.sum(-1) == 4).all())
        a = tc.anova_draws(1, 70, (3, 2, 4), 32, "cpu")
        assert a.shape == (3, 32, 3, 9)
        assert bool((a.sum(-2) == 1).all())
        assert a.sum(-1)[0, 0].tolist() == [3.0, 2.0, 4.0]
        zc = torch.arange(9.0) - 4.0
        r = tc.regression_draws(1, 70, zc, 32)
        assert r.shape == (3, 32, 9)
        assert bool((r.sort(-1).values == zc).all())


class TestEndToEnd:
    def _one_sample(self, x, n_perm, seed, thr=None):
        e = x.shape[0]
        thr = _clear_threshold(jc.t_one_sample(x), thr or jc.t_threshold(
            0.05, e - 1))
        want = jc.cluster_test_one_sample(x, n_perm=n_perm, seed=seed,
                                          threshold=thr)
        signs = _jax_signs(seed, n_perm, e)
        null = tc._sign_flip_null_from_draws(_t(x), signs, n_perm=n_perm,
                                             threshold=thr)
        skipped = int(_ambiguous(_sign_maps(x, signs, n_perm), thr).sum())
        got = tc.cluster_test_one_sample(_t(x), threshold=thr,
                                         null_max=null)
        return got, want, skipped

    def test_one_sample_matches_jax(self):
        got, want, skipped = self._one_sample(_effect(), 99, 1)
        _check_result(got, want, skipped)
        assert got.clusters[0]["p"] < 0.05 and _sorted_by_p(got)

    def test_one_sample_on_noise_matches_jax(self):
        got, want, skipped = self._one_sample(_noise(e=16, seed=3), 99, 2,
                                              thr=1.5)
        assert len(got.clusters) > 3
        _check_result(got, want, skipped)

    def test_one_sample_detects_effect(self):
        res = tc.cluster_test_one_sample(_t(_effect()), n_perm=199, seed=1)
        sig = res.p_map < 0.05
        assert sig[2:4, 5:12].all()
        assert res.clusters[0]["p"] < 0.05
        # non-suprathreshold pixels report p = 1
        assert res.p_map[(np.abs(res.t_obs) <= res.threshold)].min() == 1.0
        assert isinstance(res.p_map, np.ndarray)

    def test_paired_equals_one_sample_of_difference(self):
        xa, xb = _t(_effect()), _t(_noise(seed=8))
        ra = tc.cluster_test_paired(xa, xb, n_perm=49, seed=5)
        rb = tc.cluster_test_one_sample(xa - xb, n_perm=49, seed=5)
        np.testing.assert_array_equal(ra.p_map, rb.p_map)
        np.testing.assert_array_equal(ra.null_max, rb.null_max)

    def test_independent_matches_jax(self):
        xa, xb = _effect(amp=2.0), _noise(e=10, seed=9)
        n_perm, seed = 99, 3
        thr = _clear_threshold(jc.t_independent(xa, xb),
                               jc.t_threshold(0.05, 20))
        want = jc.cluster_test_independent(xa, xb, n_perm=n_perm, seed=seed,
                                           threshold=thr)
        x = np.concatenate([xa, xb], 0)
        ind = _jax_relabel(seed, n_perm, 22, 12)
        null = tc._relabel_null_from_draws(_t(x), ind, n_perm=n_perm,
                                           threshold=thr, na=12)
        got = tc.cluster_test_independent(_t(xa), _t(xb), threshold=thr,
                                          null_max=null)
        skipped = int(_ambiguous(_relabel_maps(x, ind, n_perm), thr).sum())
        _check_result(got, want, skipped)
        assert got.clusters[0]["p"] < 0.05

    def test_regression_matches_jax(self):
        rng = _rng(21)
        e, f, n = 24, 6, 20
        z = rng.standard_normal(e).astype(np.float32)
        x = rng.standard_normal((e, f, n)).astype(np.float32)
        x[:, 2:4, 5:12] += 1.5 * z[:, None, None]
        n_perm, seed = 99, 6
        thr = _clear_threshold(jc.t_regression(x, z),
                               jc.t_threshold(0.05, e - 2))
        want = jc.cluster_test_regression(x, z, n_perm=n_perm, seed=seed,
                                          threshold=thr)
        draws = _jax_regression(seed, n_perm, z)
        null = tc._regression_null_from_draws(_t(x), _t(z), draws,
                                              n_perm=n_perm, threshold=thr)
        got = tc.cluster_test_regression(_t(x), _t(z), threshold=thr,
                                         null_max=null)
        skipped = int(_ambiguous(_regression_maps(x, draws, n_perm),
                                 thr).sum())
        _check_result(got, want, skipped)
        assert (got.p_map[2:4, 5:12] < 0.05).all()

    def test_nperm_not_multiple_of_chunk(self):
        res = tc.cluster_test_one_sample(_t(_noise()), n_perm=50, seed=4)
        assert res.null_max.shape == (50,)

    def test_deterministic(self):
        x = _t(_effect())
        a = tc.cluster_test_one_sample(x, n_perm=29, seed=9)
        b = tc.cluster_test_one_sample(x, n_perm=29, seed=9)
        np.testing.assert_array_equal(a.p_map, b.p_map)
        np.testing.assert_array_equal(a.null_max, b.null_max)
        assert a.clusters == b.clusters

    def test_precomputed_null_reused(self):
        x = _t(_effect())
        full = tc.cluster_test_one_sample(x, n_perm=29, seed=9)
        again = tc.cluster_test_one_sample(x, null_max=full.null_max,
                                           threshold=full.threshold)
        np.testing.assert_array_equal(full.p_map, again.p_map)

    def test_validation_errors(self):
        with pytest.raises(ValueError):
            tc.cluster_test_one_sample(torch.zeros((1, 3, 4)))
        with pytest.raises(ValueError):
            tc.cluster_test_one_sample(torch.zeros((4, 3)))
        with pytest.raises(ValueError):
            tc.cluster_test_independent(torch.zeros((3, 2, 2)),
                                        torch.zeros((3, 4, 2)))
        with pytest.raises(ValueError):
            tc.cluster_test_paired(torch.zeros((3, 2, 2)),
                                   torch.zeros((4, 2, 2)))

    def test_regression_validation(self):
        x = torch.zeros((8, 4, 5))
        with pytest.raises(ValueError):
            tc.cluster_test_regression(x, torch.zeros(7))
        with pytest.raises(ValueError):
            tc.cluster_test_regression(x[:3], torch.zeros(3))


class TestMaxStat:
    def test_one_sample_matches_jax(self):
        x = _effect(amp=2.0)
        n_perm, seed = 99, 0
        t_w, p_w = jc.max_stat_test_one_sample(x, n_perm=n_perm, seed=seed)
        signs = _jax_signs(seed, n_perm, x.shape[0])
        null = tc._sign_flip_maxt_from_draws(_t(x), signs, n_perm=n_perm)
        want = np.abs(_sign_maps(x, signs, n_perm)).reshape(n_perm, -1)
        np.testing.assert_allclose(_np(null), want.max(-1), rtol=RTOL)
        t_g, p_g = tc._maxt_pmap(tc.t_one_sample(_t(x)), null)
        _check_t(t_g, t_w)
        _check_p(p_g, p_w, t_w, want.max(-1))

    def test_independent_matches_jax(self):
        xa, xb = _effect(amp=2.0), _noise(e=10, seed=9)
        n_perm, seed = 99, 2
        t_w, p_w = jc.max_stat_test_independent(xa, xb, n_perm=n_perm,
                                                seed=seed)
        x = np.concatenate([xa, xb], 0)
        ind = _jax_relabel(seed, n_perm, 22, 12)
        null = tc._relabel_maxt_from_draws(_t(x), ind, n_perm=n_perm, na=12)
        want = np.abs(_relabel_maps(x, ind, n_perm)).reshape(n_perm, -1)
        np.testing.assert_allclose(_np(null), want.max(-1), rtol=RTOL)
        t_g, p_g = tc._maxt_pmap(tc.t_independent(_t(xa), _t(xb)), null)
        _check_t(t_g, t_w)
        _check_p(p_g, p_w, t_w, want.max(-1))

    def test_regression_matches_jax(self):
        rng = _rng(23)
        e = 24
        z = rng.standard_normal(e).astype(np.float32)
        x = rng.standard_normal((e, 6, 20)).astype(np.float32)
        x[:, 2, 8] += 3.0 * z         # one focal pixel
        n_perm, seed = 99, 0
        t_w, p_w = jc.max_stat_test_regression(x, z, n_perm=n_perm,
                                               seed=seed)
        draws = _jax_regression(seed, n_perm, z)
        null = tc._regression_maxt_from_draws(_t(x), _t(z), draws,
                                              n_perm=n_perm)
        want = np.abs(_regression_maps(x, draws, n_perm)).reshape(n_perm,
                                                                 -1)
        np.testing.assert_allclose(_np(null), want.max(-1), rtol=RTOL)
        t_g, p_g = tc._maxt_pmap(tc.t_regression(_t(x), _t(z)), null)
        _check_t(t_g, t_w)
        _check_p(p_g, p_w, t_w, want.max(-1))
        assert p_g[2, 8] < 0.05

    def test_detects_effect_and_calibrates(self):
        t, p = tc.max_stat_test_one_sample(_t(_effect(amp=4.0)), n_perm=199)
        assert (p[2:4, 5:12] < 0.05).all()
        _, pn = tc.max_stat_test_one_sample(_t(_noise(e=16, seed=3)),
                                            n_perm=199)
        assert pn.min() > 0.01
        _, pi = tc.max_stat_test_independent(_t(_effect(amp=4.0)),
                                             _t(_noise(seed=5)), n_perm=99)
        assert (pi[2:4, 5:12] < 0.05).all() and pi.shape == t.shape

    def test_regression_validation(self):
        with pytest.raises(ValueError):
            tc.max_stat_test_regression(torch.zeros((8, 4, 5)),
                                        torch.zeros(7))


class TestTfce:
    def test_map_matches_jax_and_numpy(self):
        t = (_rng(13).standard_normal((5, 9)) * 2.5).astype(np.float32)
        ours = _np(tc.tfce_map(_t(t), stop=10.0))
        np.testing.assert_allclose(ours, np.asarray(jc.tfce_map(t,
                                                                stop=10.0)),
                                   rtol=RTOL, atol=0)
        np.testing.assert_allclose(ours, _numpy_tfce(t, stop=10.0),
                                   rtol=1e-4, atol=1e-4)

    def test_map_batched_matches_jax(self):
        t = (_rng(14).standard_normal((3, 4, 7)) * 2.0).astype(np.float32)
        ours = _np(tc.tfce_map(_t(t), stop=8.0))
        np.testing.assert_allclose(ours, np.asarray(jc.tfce_map(t,
                                                                stop=8.0)),
                                   rtol=RTOL, atol=0)
        for b in range(3):
            np.testing.assert_allclose(ours[b], _numpy_tfce(t[b], stop=8.0),
                                       rtol=1e-4, atol=1e-4)

    def test_level_batches_change_nothing(self, monkeypatch):
        t = _t(_rng(25).standard_normal((2, 5, 9)) * 3.0)
        whole = tc.tfce_map(t, stop=12.0)
        monkeypatch.setattr(tc, "_LEVEL_PIXELS", 1)   # one level a batch
        assert torch.equal(whole, tc.tfce_map(t, stop=12.0))

    def test_sign_flip_null_matches_jax(self):
        x = _noise(e=8, f=4, n=6, seed=15)
        want = np.asarray(jc._sign_flip_tfce_null(
            jnp.asarray(x), _key(6), n_perm=6, chunk=2, **TFCE_KW))
        signs = _jax_signs(6, 6, 8, 2)
        got = tc._sign_flip_tfce_null_from_draws(_t(x), signs, n_perm=6,
                                                 **TFCE_KW)
        maps = _sign_maps(x, signs, 6)
        oracle = np.array([np.abs(_numpy_tfce(m, **TFCE_KW)).max()
                           for m in maps])
        _check_null(got, want, _level_ambiguous(maps), oracle)

    def test_relabel_null_matches_jax(self):
        x = np.concatenate([_noise(6, 4, 6, 16), _noise(5, 4, 6, 17)], 0)
        want = np.asarray(jc._relabel_tfce_null(
            jnp.asarray(x), _key(7), n_perm=6, na=6, chunk=3, **TFCE_KW))
        ind = _jax_relabel(7, 6, 11, 6, 3)
        got = tc._relabel_tfce_null_from_draws(_t(x), ind, n_perm=6, na=6,
                                               **TFCE_KW)
        _check_null(got, want,
                    _level_ambiguous(_relabel_maps(x, ind, 6)))

    def test_one_sample_result_matches_jax(self):
        x = _effect(e=14, amp=2.0, seed=18)
        n_perm, seed = 29, 1
        want = jc.tfce_test_one_sample(x, n_perm=n_perm, seed=seed,
                                       **TFCE_KW)
        signs = _jax_signs(seed, n_perm, 14)
        null = tc._sign_flip_tfce_null_from_draws(_t(x), signs,
                                                  n_perm=n_perm, **TFCE_KW)
        skipped = int(_level_ambiguous(_sign_maps(x, signs, n_perm)).sum())
        assert not _level_ambiguous(np.asarray(want.t_obs)[None])[0]
        got = tc._tfce_finish(tc.t_one_sample(_t(x)), null, TFCE_KW)
        _check_t(got.t_obs, want.t_obs)
        np.testing.assert_allclose(got.tfce_obs, want.tfce_obs, rtol=RTOL,
                                   atol=0)
        _check_p(got.p_map, want.p_map, want.tfce_obs, want.null_max,
                 skipped)

    def test_one_sample_detects_effect(self):
        res = tc.tfce_test_one_sample(_t(_effect(e=14, amp=3.0)), n_perm=99,
                                      seed=1, stop=20.0)
        assert (res.p_map[2:4, 6:11] < 0.05).all()
        assert res.tfce_obs.shape == res.t_obs.shape

    def test_null_calibrated_and_zero_pixels_p1(self):
        res = tc.tfce_test_one_sample(_t(_noise(e=16, seed=19)), n_perm=99,
                                      seed=2, stop=20.0)
        assert res.p_map.min() > 0.01
        assert res.p_map[res.tfce_obs == 0.0].min() == 1.0

    def test_independent(self):
        res = tc.tfce_test_independent(_t(_effect(amp=4.0)),
                                       _t(_noise(seed=20)), n_perm=99,
                                       seed=3, stop=20.0)
        assert (res.p_map[2:4, 6:11] < 0.05).all()

    def test_validation(self):
        with pytest.raises(ValueError):
            tc.tfce_test_one_sample(torch.zeros((1, 3, 3)))
        with pytest.raises(ValueError):
            tc.tfce_test_independent(torch.zeros((3, 2, 2)),
                                     torch.zeros((3, 3, 2)))


class TestChannelAdjacency:
    EDGES = np.array([[0, 1], [1, 2]], np.int32)

    @staticmethod
    def _stack(e=14, amp=4.0, seed=2):
        x = _rng(seed).standard_normal((e, 3, 5, 12)).astype(np.float32)
        x[:, 0, 1:3, 4:9] += amp  # effect on channels 0 and 1,
        x[:, 1, 1:3, 4:9] += amp  # which are adjacent
        return x

    @pytest.mark.parametrize("p", [0.3, 0.6])
    def test_labels_match_jax_and_union_find(self, p):
        mask = _rng(21).random((4, 5, 7)) < p
        edges = np.array([[0, 1], [2, 3]], np.int32)
        ours = _np(tc.label_components(torch.from_numpy(mask), edges))
        np.testing.assert_array_equal(ours, _union_find_labels(mask, edges))
        np.testing.assert_array_equal(
            ours, np.asarray(jc.label_components(mask, edges)))

    def test_batched_labels_match_jax(self):
        mask = _rng(22).random((3, 4, 5, 6)) < 0.5
        edges = torch.tensor([[0, 3], [1, 2], [2, 3]])
        ours = _np(tc.label_components(torch.from_numpy(mask), edges))
        np.testing.assert_array_equal(
            ours, np.asarray(jc.label_components(mask, edges.numpy())))
        for b in range(3):
            np.testing.assert_array_equal(
                ours[b], _union_find_labels(mask[b], edges.numpy()))

    def test_adjacent_channels_merge_nonadjacent_dont(self):
        mask = np.zeros((3, 2, 2), bool)
        mask[0, 0, 0] = mask[1, 0, 0] = mask[2, 0, 0] = True
        ours = _np(tc.label_components(torch.from_numpy(mask),
                                       np.array([[0, 1]], np.int32)))
        assert ours[0, 0, 0] == ours[1, 0, 0] != ours[2, 0, 0]

    def test_one_sample_matches_jax(self):
        x = self._stack(amp=1.5)
        n_perm, seed = 64, 1
        thr = _clear_threshold(jc.t_one_sample(x), jc.t_threshold(0.05, 13))
        want = jc.cluster_test_one_sample(x, n_perm=n_perm, seed=seed,
                                          threshold=thr,
                                          adjacency=self.EDGES)
        signs = _jax_signs(seed, n_perm, 14)
        null = tc._sign_flip_null_from_draws(_t(x), signs, n_perm=n_perm,
                                             threshold=thr,
                                             adjacency=self.EDGES)
        got = tc.cluster_test_one_sample(_t(x), threshold=thr,
                                         null_max=null,
                                         adjacency=self.EDGES)
        skipped = int(_ambiguous(_sign_maps(x, signs, n_perm), thr).sum())
        _check_result(got, want, skipped)
        assert got.t_obs.shape == (3, 5, 12)

    def test_one_sample_spatiospectral(self):
        res = tc.cluster_test_one_sample(_t(self._stack()), n_perm=99,
                                         seed=1, adjacency=self.EDGES)
        big = res.clusters[0]
        assert big["p"] < 0.05 and big["size"] == 2 * 2 * 5
        split = tc.cluster_test_one_sample(
            _t(self._stack()), n_perm=99, seed=1,
            adjacency=np.zeros((0, 2), np.int32))
        sizes = sorted(c["size"] for c in split.clusters if c["p"] < 0.05)
        assert sizes == [10, 10]

    def test_independent_4d_matches_jax(self):
        xa, xb = self._stack(amp=1.5, seed=3), self._stack(amp=0.0, seed=4)
        n_perm, seed = 64, 5
        thr = _clear_threshold(jc.t_independent(xa, xb),
                               jc.t_threshold(0.05, 26))
        want = jc.cluster_test_independent(xa, xb, n_perm=n_perm, seed=seed,
                                           threshold=thr,
                                           adjacency=self.EDGES)
        x = np.concatenate([xa, xb], 0)
        ind = _jax_relabel(seed, n_perm, 28, 14)
        null = tc._relabel_null_from_draws(_t(x), ind, n_perm=n_perm,
                                           threshold=thr, na=14,
                                           adjacency=self.EDGES)
        got = tc.cluster_test_independent(_t(xa), _t(xb), threshold=thr,
                                          null_max=null,
                                          adjacency=self.EDGES)
        skipped = int(_ambiguous(_relabel_maps(x, ind, n_perm), thr).sum())
        _check_result(got, want, skipped)

    def test_tfce_adjacency_matches_jax(self):
        t = (_rng(24).standard_normal((3, 4, 7)) * 2.0).astype(np.float32)
        np.testing.assert_allclose(
            _np(tc.tfce_map(_t(t), adjacency=self.EDGES, **TFCE_KW)),
            np.asarray(jc.tfce_map(t, adjacency=self.EDGES, **TFCE_KW)),
            rtol=RTOL, atol=0)
        x = self._stack()
        linked = tc.tfce_test_one_sample(_t(x), n_perm=29, seed=6,
                                         stop=25.0, adjacency=self.EDGES)
        split = tc.tfce_test_one_sample(
            _t(x), n_perm=29, seed=6, stop=25.0,
            adjacency=np.zeros((0, 2), np.int32))
        sel = np.abs(linked.t_obs) > 3.0
        assert (np.abs(linked.tfce_obs[sel])
                > np.abs(split.tfce_obs[sel])).all()
        assert (linked.p_map[:2, 1:3, 4:9] < 0.05).all()

    def test_shape_validation(self):
        with pytest.raises(ValueError):
            tc.cluster_test_one_sample(torch.zeros((5, 3, 4)),
                                       adjacency=self.EDGES)
        with pytest.raises(ValueError):
            tc.cluster_test_one_sample(torch.zeros((5, 2, 3, 4)))

    def test_as_edges_forms(self):
        from ninwavelets_tpu.utils.mne_adapter import EpochsWavelet as JEW
        m = np.zeros((4, 4), bool)
        m[0, 2] = m[2, 0] = m[1, 3] = m[3, 1] = True
        for arg in (m, [[0, 1]], (), m.astype(int)):
            got = nt.EpochsWavelet._as_edges(arg)
            np.testing.assert_array_equal(got, JEW._as_edges(arg))
            assert got.dtype == np.int32 and got.shape[-1] == 2


class TestBootstrap:
    @staticmethod
    def _jax_counts(seed, n_boot, e, chunk=64):
        """The JAX package's resampling counts, drawn as ``_boot_jit``
        draws them."""
        n_chunks = -(-n_boot // chunk)
        keys = jax.random.split(_key(seed), n_chunks * chunk)
        counts = jax.vmap(lambda k: jnp.bincount(
            jax.random.randint(k, (e,), 0, e), length=e))(keys)
        return np.array(counts).reshape(n_chunks, chunk, e)

    @pytest.mark.parametrize("n_boot,alpha", [(500, 0.05), (100, 0.1)])
    def test_matches_jax_given_its_counts(self, n_boot, alpha):
        trials = (2.0 + _rng(5).standard_normal((40, 6, 10))).astype(
            np.float32)
        lo_w, hi_w = jbs.bootstrap_ci(trials, alpha=alpha, n_boot=n_boot,
                                      seed=3)
        counts = self._jax_counts(3, n_boot, 40)
        lo, hi = tbs._boot_from_counts(_t(trials), counts, n_boot=n_boot,
                                       lower=alpha / 2,
                                       upper=1 - alpha / 2)
        scale = np.abs(trials.mean(0)).max()
        for got, want in ((lo, lo_w), (hi, hi_w)):
            assert np.abs(_np(got) - np.asarray(want)).max() <= 1e-5 * scale

    def test_pixel_chunks_change_nothing(self, monkeypatch):
        trials = _t(_rng(6).standard_normal((12, 5, 7)))
        counts = tbs._boot_counts(0, 90, 12, 64, "cpu")
        whole = tbs._boot_from_counts(trials, counts, n_boot=90, lower=0.025,
                                      upper=0.975)
        monkeypatch.setattr(tbs, "_PIXELS", 90 * 4)   # 4 pixels a chunk
        parts = tbs._boot_from_counts(trials, counts, n_boot=90,
                                      lower=0.025, upper=0.975)
        for a, b in zip(whole, parts):
            assert torch.equal(a, b)

    def test_counts_resample_every_trial(self):
        c = tbs._boot_counts(4, 130, 9, 64, "cpu")
        assert c.shape == (3, 64, 9) and bool((c.sum(-1) == 9).all())
        assert torch.equal(c, tbs._boot_counts(4, 130, 9, 64, "cpu"))

    def test_covers_truth(self):
        # trials ~ N(mu, 1): the 95% CI should bracket mu ~95% of pixels
        mu = 2.0
        trials = _t(mu + _rng(5).standard_normal((40, 6, 10)))
        lo, hi = (_np(b) for b in nt.ops.bootstrap_ci(trials, alpha=0.05,
                                                      n_boot=500))
        assert ((lo <= mu) & (mu <= hi)).mean() > 0.85
        assert np.all(lo < hi)
        np.testing.assert_allclose(0.5 * (lo + hi), _np(trials.mean(0)),
                                   atol=0.25)

    def test_validates_and_is_deterministic(self):
        x = _t(_rng(0).standard_normal((10, 3, 4)))
        a = tbs.bootstrap_ci(x, n_boot=100, seed=3)
        b = tbs.bootstrap_ci(x, n_boot=100, seed=3)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        with pytest.raises(ValueError):
            tbs.bootstrap_ci(x[:1])


class TestFdrCorrection:
    """fdr_correction against JAX's and scipy.stats.false_discovery_control."""

    @staticmethod
    def _ps(seed, m=257):
        rng = _rng(seed)
        # mixture: mostly uniform nulls plus a clump of small p-values
        p = rng.uniform(size=m)
        p[:40] = rng.uniform(0.0, 0.01, size=40)
        p[40:44] = p[44]           # ties
        return p.astype(np.float32)

    @pytest.mark.parametrize("method", ["bh", "by"])
    def test_matches_jax_and_scipy(self, method):
        from scipy.stats import false_discovery_control
        p = self._ps(0 if method == "bh" else 1)
        rej, padj = tc.fdr_correction(_t(p), alpha=0.05, method=method)
        rej_w, padj_w = jc.fdr_correction(p, alpha=0.05, method=method)
        ref = false_discovery_control(p.astype(np.float64), method=method)
        np.testing.assert_allclose(_np(padj), np.asarray(padj_w),
                                   atol=FDR_ATOL, rtol=0)
        np.testing.assert_allclose(_np(padj), ref, atol=FDR_ATOL, rtol=0)
        np.testing.assert_array_equal(_np(rej), np.asarray(rej_w))

    def test_shape_preserved_and_validation(self):
        p = _t(self._ps(2, m=60).reshape(3, 4, 5))
        rej, padj = tc.fdr_correction(p)
        assert rej.shape == p.shape and padj.shape == p.shape
        with pytest.raises(ValueError):
            tc.fdr_correction(p, method="holm")

    def test_null_only_rejects_nothing(self):
        p = _t(_rng(3).uniform(0.2, 1.0, size=500))
        rej, _ = tc.fdr_correction(p, alpha=0.05)
        assert not bool(rej.any())


class TestFOneway:
    def test_matches_jax_and_scipy(self):
        rng = _rng(0)
        gs = [rng.standard_normal((n, 4, 7)).astype(np.float32) + s
              for n, s in ((8, 0.0), (10, 0.3), (7, -0.2))]
        got = tc.f_oneway([_t(g) for g in gs])
        _check_t(got, jc.f_oneway(gs))
        want = stats.f_oneway(*[g.astype(np.float64) for g in gs],
                              axis=0).statistic
        np.testing.assert_allclose(_np(got), want, rtol=1e-4, atol=1e-4)

    def test_two_groups_f_is_t_squared(self):
        xa, xb = _t(_effect(amp=2.0)), _t(_noise(seed=30))
        f = _np(tc.f_oneway([xa, xb]))
        t = _np(tc.t_independent(xa, xb))
        np.testing.assert_allclose(f, t * t, rtol=1e-3, atol=1e-3)

    def test_anova_null_matches_jax_and_scipy(self):
        sizes = (5, 6, 4)
        x = _rng(1).standard_normal((15, 4, 6)).astype(np.float32)
        n_perm, chunk, thr = 8, 8, 2.0
        want = np.asarray(jc._anova_null(
            jnp.asarray(x), _key(3), n_perm=n_perm, threshold=thr,
            sizes=sizes, chunk=chunk))
        ind = _jax_anova(3, n_perm, sizes, chunk)
        got = tc._anova_null_from_draws(_t(x), ind, n_perm=n_perm,
                                        threshold=thr, sizes=sizes)
        maps = _anova_maps(x, ind, n_perm)
        oracle = np.array([_numpy_max_mass(m, thr) for m in maps])
        _check_null(got, want, _ambiguous(maps, thr), oracle)

    def test_cluster_f_matches_jax(self):
        groups = [_effect(amp=2.0, e=10, seed=31), _noise(e=9, seed=32),
                  _noise(e=11, seed=33)]
        n_perm, seed = 99, 7
        thr = _clear_threshold(jc.f_oneway(groups),
                               jc.f_threshold(0.05, 2, 27))
        want = jc.cluster_test_f(groups, n_perm=n_perm, seed=seed,
                                 threshold=thr)
        ind = _jax_anova(seed, n_perm, (10, 9, 11))
        x = np.concatenate(groups, 0)
        null = tc._anova_null_from_draws(_t(x), ind, n_perm=n_perm,
                                         threshold=thr, sizes=(10, 9, 11))
        got = tc.cluster_test_f([_t(g) for g in groups], threshold=thr,
                                null_max=null)
        skipped = int(_ambiguous(_anova_maps(x, ind, n_perm), thr).sum())
        _check_result(got, want, skipped)
        assert got.clusters[0]["p"] < 0.05
        assert all(c["sign"] == 1 for c in got.clusters)

    def test_null_calibrated(self):
        res = tc.cluster_test_f([_t(_noise(e=8, seed=34)),
                                 _t(_noise(e=9, seed=35)),
                                 _t(_noise(e=7, seed=36))],
                                n_perm=199, seed=8)
        assert all(c["p"] > 0.05 for c in res.clusters)

    def test_validation(self):
        with pytest.raises(ValueError):
            tc.cluster_test_f([_t(_noise())])
        with pytest.raises(ValueError):
            tc.cluster_test_f([_t(_noise()), _t(_noise()[:1])])
        with pytest.raises(ValueError):
            tc.cluster_test_f([_t(_noise(f=4)), _t(_noise(f=5))])


class TestAdapter:
    SF = 250.0
    FREQS = np.linspace(20, 60, 5)
    N_PERM = 64

    @staticmethod
    def _data(e=14, c=2, n=256, burst=False, seed=13, amp=6.0):
        rng = _rng(seed)
        t = np.arange(n) / 250.0
        x = rng.standard_normal((e, c, n)).astype(np.float32)
        if burst:
            win = (t > 0.5) & (t < 0.8)
            x[:, :2, :] += (amp * np.sin(2 * np.pi * 40 * t) * win)[None, None]
        return x

    def _pair(self, data):
        names = [f"c{i}" for i in range(data.shape[1])]
        ew_j = nw.EpochsWavelet(nw.ArrayEpochs(data, self.SF, names),
                                nw.Morse(self.SF))
        ew_t = nt.EpochsWavelet(nt.ArrayEpochs(data, self.SF, names),
                                nt.Morse(self.SF, device="cpu"))
        return ew_j, ew_t

    @staticmethod
    def _jax_draws(monkeypatch):
        """Swap the port's draw functions for the JAX package's."""
        monkeypatch.setattr(tc, "sign_draws", lambda seed, n_perm, e,
                            chunk=64, device=None: _t(
                                _jax_signs(seed, n_perm, e, chunk)))
        monkeypatch.setattr(tc, "relabel_draws", lambda seed, n_perm, e, na,
                            chunk=64, device=None: _t(
                                _jax_relabel(seed, n_perm, e, na, chunk)))
        monkeypatch.setattr(tc, "anova_draws", lambda seed, n_perm, sizes,
                            chunk=64, device=None: _t(
                                _jax_anova(seed, n_perm, sizes, chunk)))
        monkeypatch.setattr(tc, "regression_draws", lambda seed, n_perm, zc,
                            chunk=64: _t(np.array(jc.regression_draws(
                                _key(seed), n_perm, jnp.asarray(_np(zc)),
                                chunk))))

    @staticmethod
    def _check(got, want, maps):
        """The adapter's rule: t within ADAPTER_T_GATE of max|t|, masses,
        the null and the p count rule at that rtol, the permutations whose
        float64 map (from the JAX planes) has a pixel within NEAR_ADAPTER of
        the threshold left out."""
        skip = _ambiguous(maps, want.threshold, NEAR_ADAPTER)
        _check_null(got.null_max, want.null_max, skip, rtol=ADAPTER_T_GATE)
        _check_result(got, want, int(skip.sum()), t_gate=ADAPTER_T_GATE,
                      rtol=ADAPTER_T_GATE)

    def test_cluster_test_one_sample_matches_jax(self, monkeypatch):
        self._jax_draws(monkeypatch)
        ew_j, ew_t = self._pair(self._data(burst=True))
        x = np.asarray(ew_j.single_trial_power("c0", self.FREQS,
                                               (0.0, 0.4)))
        thr = _clear_threshold(jc.t_one_sample(x), jc.t_threshold(0.05, 13),
                               NEAR_ADAPTER)
        kw = dict(baseline=(0.0, 0.4), n_perm=self.N_PERM, seed=2,
                  threshold=thr)
        want = ew_j.cluster_test("c0", self.FREQS, **kw)
        got = ew_t.cluster_test("c0", self.FREQS, **kw)
        self._check(got, want, _sign_maps(x, _jax_signs(2, self.N_PERM, 14),
                                          self.N_PERM))
        sig = got.p_map < 0.05
        assert got.clusters[0]["p"] < 0.05 and sig[:, 130:195].any()

    @pytest.mark.parametrize("paired", [False, True])
    def test_cluster_test_two_conditions_match_jax(self, monkeypatch,
                                                   paired):
        self._jax_draws(monkeypatch)
        ja, ta = self._pair(self._data(burst=True))
        jb, tb = self._pair(self._data(burst=False, seed=14))
        xa = np.asarray(ja.single_trial_power("c0", self.FREQS))
        xb = np.asarray(jb.single_trial_power("c0", self.FREQS))
        if paired:
            t, dof = jc.t_one_sample(xa - xb), 13
            maps = _sign_maps(xa - xb, _jax_signs(4, self.N_PERM, 14),
                              self.N_PERM)
        else:
            t, dof = jc.t_independent(xa, xb), 26
            maps = _relabel_maps(np.concatenate([xa, xb]),
                                 _jax_relabel(4, self.N_PERM, 28, 14),
                                 self.N_PERM)
        thr = _clear_threshold(t, jc.t_threshold(0.05, dof), NEAR_ADAPTER)
        kw = dict(paired=paired, n_perm=self.N_PERM, seed=4, threshold=thr)
        want = ja.cluster_test("c0", self.FREQS, other=jb, **kw)
        got = ta.cluster_test("c0", self.FREQS, other=tb, **kw)
        self._check(got, want, maps)
        assert got.clusters[0]["p"] < 0.05

    def test_cluster_test_all_matches_jax(self, monkeypatch):
        self._jax_draws(monkeypatch)
        ew_j, ew_t = self._pair(self._data(e=12, c=3, burst=True))
        adj = np.zeros((3, 3), bool)
        adj[0, 1] = adj[1, 0] = True
        freqs = np.linspace(20, 60, 4)
        x = np.asarray(ew_j.single_trial_power_all(freqs, (0.0, 0.4),
                                                   decim=2))
        kw = dict(adjacency=adj, baseline=(0.0, 0.4), n_perm=self.N_PERM,
                  decim=2, threshold=_clear_threshold(
                      jc.t_one_sample(x), jc.t_threshold(0.05, 11),
                      NEAR_ADAPTER))
        want = ew_j.cluster_test_all(freqs, **kw)
        got = ew_t.cluster_test_all(freqs, **kw)
        self._check(got, want, _sign_maps(x, _jax_signs(0, self.N_PERM, 12),
                                          self.N_PERM))
        assert got.t_obs.shape == (3, 4, 128)
        sig = got.p_map < 0.05
        assert sig[0].any() and sig[1].any()

    def test_cluster_regression_matches_jax(self, monkeypatch):
        self._jax_draws(monkeypatch)
        z = _rng(21).standard_normal(16).astype(np.float32)
        data = self._data(e=16, seed=15)
        t = np.arange(256) / self.SF
        data[:, 0] += (2.0 * (z - z.min())[:, None]
                       * np.sin(2 * np.pi * 40 * t)
                       * ((t > 0.4) & (t < 0.7))).astype(np.float32)
        ew_j, ew_t = self._pair(data)
        x = np.asarray(ew_j.single_trial_power("c0", self.FREQS))
        kw = dict(n_perm=self.N_PERM, seed=6, threshold=_clear_threshold(
            jc.t_regression(x, z), jc.t_threshold(0.05, 14), NEAR_ADAPTER))
        want = ew_j.cluster_regression("c0", self.FREQS, z, **kw)
        got = ew_t.cluster_regression("c0", self.FREQS, z, **kw)
        self._check(got, want, _regression_maps(
            x, _jax_regression(6, self.N_PERM, z), self.N_PERM))
        assert got.clusters[0]["p"] < 0.05

    def test_cluster_f_matches_jax(self, monkeypatch):
        # F = SSB / (SST - SSB) loses digits as F grows (SST - SSB
        # cancels): at the 6.0 burst max F is 9.6e3 and the two packages'
        # F maps differ by up to 1.9e-4 of it; the 2.0 burst keeps max F
        # near 700, where they agree within 5e-6.
        self._jax_draws(monkeypatch)
        pairs = [self._pair(self._data(e=8, burst=b, seed=s, amp=2.0))
                 for b, s in ((True, 16), (False, 17), (False, 18))]
        planes = [np.asarray(j.single_trial_power("c0", self.FREQS))
                  for j, _ in pairs]
        kw = dict(n_perm=self.N_PERM, seed=5, threshold=_clear_threshold(
            jc.f_oneway(planes), jc.f_threshold(0.05, 2, 21),
            NEAR_ADAPTER))
        want = pairs[0][0].cluster_f("c0", self.FREQS,
                                     [j for j, _ in pairs[1:]], **kw)
        got = pairs[0][1].cluster_f("c0", self.FREQS,
                                    [t for _, t in pairs[1:]], **kw)
        self._check(got, want, _anova_maps(
            np.concatenate(planes), _jax_anova(5, self.N_PERM, (8, 8, 8)),
            self.N_PERM))
        assert got.clusters[0]["p"] < 0.05
        assert all(c["sign"] == 1 for c in got.clusters)

    def test_one_sample_requires_baseline(self):
        _, ew = self._pair(self._data())
        with pytest.raises(ValueError):
            ew.cluster_test("c0", [20.0, 40.0])
        with pytest.raises(ValueError):
            ew.cluster_test_all([20.0, 40.0])

    @pytest.mark.parametrize("baseline", [None, (0.0, 0.4)])
    def test_decimated_planes_are_copies(self, baseline):
        _, ew = self._pair(self._data())
        x = ew.single_trial_power_all(self.FREQS, baseline, decim=4)
        assert x.shape == (14, 2, 5, 64) and x.is_contiguous()
        full = ew.single_trial_power_all(self.FREQS, baseline)
        assert torch.equal(x, full[..., ::4])
