"""The port's graph measures (``ninwavelets_tpu_torch.ops.graph``) and
``EpochsWavelet.network`` against the JAX package on the same seeded
inputs, on the CPU, and against ``tests/test_graph.py``'s Floyd-Warshall
and brute-force oracles.  Nothing here reaches a Pallas kernel in the JAX
package.

Gates, each with its reason:

* strength, clustering, shortest paths, efficiency, path length and the
  small-world index: rtol 1e-5 against JAX and the oracles (float32 sums and
  products in another order; the cube root is ``pow(x, 1/3)`` where JAX
  has ``cbrt``: measured here to differ from it by at most 1 ulp,
  ``test_cube_root_is_within_an_ulp_of_cbrt``);
* modularity ``q``: rtol 1e-4 (a full-float32 quadratic form over a
  float32 eigenvector), with an absolute floor of 1e-6 (``Q_ATOL``): q lies
  in [-1/2, 1], and a split with no structure gives a round-off q (2.3e-9
  against 0 on the adapter's three channels).  Labels: the leading
  eigenvector's sign is arbitrary in both packages, so labels must agree up
  to a global flip, and only where the leading eigengap is at least 1e-3
  of the largest eigenvalue's magnitude and no entry of the float64 leading
  vector is within 1e-4 of 0 (there float32 eigensolvers may split
  differently);
* the small-world nulls: the two packages draw weight permutations from
  different generators, so ``_null_stats_from_perms`` (and, for the
  adapter, ``_null_perms``) is fed the JAX package's own permutations,
  drawn as JAX draws them;
* ``network`` end to end: the matrix within 1e-4 of its max (the
  ``*_matrix`` gate of ``tests/test_torch_connectivity.py`` and
  ``tests/test_torch_conn_matrices.py``), each measure within 1e-4 of its
  max of JAX's, NaN masks equal (the wPLI and PPC matrices carry a NaN
  diagonal at eps = 0, which the strength, clustering and path measures
  keep in both packages).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ninwavelets_tpu as nw
import ninwavelets_tpu_torch as nt
from ninwavelets_tpu.ops import graph as jg
from ninwavelets_tpu_torch.ops import graph as tg

from test_graph import _floyd
from torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-5
Q_RTOL, Q_ATOL = 1e-4, 1e-6
NET = 1e-4


def _rand_w(c=6, batch=(), seed=3):
    rng = np.random.default_rng(seed)
    w = rng.random(batch + (c, c)).astype(np.float32)
    w = 0.5 * (w + np.swapaxes(w, -1, -2))
    idx = np.arange(c)
    w[..., idx, idx] = 0.0
    return w


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def _jax_null_perms(seed, n_nulls, n_edges):
    """The JAX package's ``_null_stats`` permutations: one
    ``jax.random.permutation`` per key of ``split(PRNGKey(seed), n)``,
    under ``vmap`` as there."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n_nulls)
    return np.array(jax.vmap(
        lambda k: jax.random.permutation(k, n_edges))(keys))


@pytest.mark.parametrize("name", ["strength", "clustering_onnela",
                                  "shortest_paths", "global_efficiency",
                                  "char_path_length"])
@pytest.mark.parametrize("batch", [(), (3,)])
def test_measures_match_jax(name, batch):
    w = _rand_w(7, batch)
    w[..., 0, 3] = w[..., 3, 0] = 0.0           # relays matter
    w[..., 1, 2] = 0.3                            # asymmetric: symmetrized
    got = getattr(tg, name)(_t(w)).numpy()
    want = np.asarray(getattr(jg, name)(jnp.asarray(w)))
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_shortest_paths_match_floyd_warshall():
    w = _rand_w(c=7)
    w[0, 3] = w[3, 0] = 0.0
    np.testing.assert_allclose(tg.shortest_paths(_t(w)).numpy(), _floyd(w),
                               rtol=RTOL)
    wb = _rand_w(c=5, batch=(3,))
    d = tg.shortest_paths(_t(wb)).numpy()
    for f in range(3):
        np.testing.assert_allclose(d[f], _floyd(wb[f]), rtol=RTOL)


def test_disconnected_pair_unreachable():
    w = np.zeros((4, 4), np.float32)
    w[0, 1] = w[1, 0] = 1.0
    w[2, 3] = w[3, 2] = 1.0
    d = tg.shortest_paths(_t(w)).numpy()
    assert d[0, 1] == pytest.approx(1.0) and d[0, 2] > 1e8
    assert float(tg.global_efficiency(_t(w))) == pytest.approx(4.0 / 12.0)
    assert float(tg.char_path_length(_t(w))) == pytest.approx(1.0)


def test_clustering_limits_and_bruteforce():
    c = 5
    full = np.ones((c, c), np.float32)
    np.fill_diagonal(full, 0.0)
    np.testing.assert_allclose(tg.clustering_onnela(_t(full)).numpy(), 1.0,
                               atol=1e-6)
    star = np.zeros((c, c), np.float32)
    star[0, 1:] = star[1:, 0] = 1.0
    np.testing.assert_allclose(tg.clustering_onnela(_t(star)).numpy(), 0.0,
                               atol=1e-6)
    w = _rand_w(c=6)
    wp = np.cbrt(w / w.max())
    ref = np.zeros(6)
    for i in range(6):
        tri = sum(wp[i, j] * wp[j, h] * wp[h, i] for j in range(6)
                  for h in range(6) if len({i, j, h}) == 3)
        k = (w[i] > 0).sum()
        ref[i] = tri / (k * (k - 1)) if k > 1 else 0.0
    np.testing.assert_allclose(tg.clustering_onnela(_t(w)).numpy(), ref,
                               rtol=RTOL)


def test_cube_root_is_within_an_ulp_of_cbrt():
    x = np.random.default_rng(0).random(100_000).astype(np.float32)
    x[:3] = (0.0, 1.0, 0.125)
    got = torch.pow(_t(x), 1.0 / 3.0).numpy()
    want = np.asarray(jnp.cbrt(jnp.asarray(x)))
    ulp = np.spacing(np.maximum(np.abs(want), np.float32(1e-30)))
    assert (np.abs(got - want) <= ulp).all()
    assert got[:3].tolist() == [0.0, 1.0, 0.5]


@pytest.mark.parametrize("batch", [(), (2,)])
def test_small_worldness_fed_jax_permutations_matches_jax(batch):
    w = _rand_w(8, batch, seed=5)
    perms = _jax_null_perms(0, 6, 8 * 7 // 2)
    got = tg._small_worldness(
        _t(w), *tg._null_stats_from_perms(_t(w), torch.from_numpy(perms)))
    want = np.asarray(jg.small_worldness(jnp.asarray(w), n_nulls=6, seed=0))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)


def test_small_world_lattice_beats_uniform_on_the_port_draws():
    c = 16
    ring = np.zeros((c, c), np.float32)
    for i in range(c):
        for off in (1, 2):
            ring[i, (i + off) % c] = ring[(i + off) % c, i] = 1.0
    sig_ring = float(tg.small_worldness(_t(ring), n_nulls=10))
    flat = np.full((c, c), 0.3, np.float32)
    np.fill_diagonal(flat, 0.0)
    sig_flat = float(tg.small_worldness(_t(flat), n_nulls=10))
    assert sig_ring > sig_flat
    assert sig_flat == pytest.approx(1.0, abs=0.05)
    # one seed, one draw; another seed, other nulls
    assert float(tg.small_worldness(_t(ring), n_nulls=10)) == sig_ring
    p0 = tg._null_perms(10, 120, 0, torch.device("cpu"))
    assert (p0.sort(-1).values == torch.arange(120)).all()
    assert not torch.equal(p0, tg._null_perms(10, 120, 1,
                                              torch.device("cpu")))


# -- modularity ---------------------------------------------------------------

def _labels_agree_where_the_gap_allows(got, want, w):
    """Labels equal up to a global flip for each matrix of the batch whose
    float64 leading eigengap and leading-vector entries allow it; returns
    how many were checked."""
    w = np.asarray(w, np.float64).reshape(-1, *w.shape[-2:])
    got = np.asarray(got).reshape(-1, w.shape[-1])
    want = np.asarray(want).reshape(-1, w.shape[-1])
    checked = 0
    for wf, g, j in zip(w, got, want):
        wf = np.where(np.isfinite(wf), wf, 0.0)
        wf = np.maximum(0.5 * (wf + wf.T), 0.0)
        np.fill_diagonal(wf, 0.0)
        k = wf.sum(1)
        b = wf - np.outer(k, k) / max(k.sum(), 1e-20)
        vals, vecs = np.linalg.eigh(b)
        gap = (vals[-1] - vals[-2]) / max(np.abs(vals).max(), 1e-30)
        if vals[-1] <= 0 or gap < 1e-3 or np.abs(vecs[:, -1]).min() < 1e-4:
            continue
        assert np.array_equal(g, j) or np.array_equal(g, 1 - j), (g, j)
        checked += 1
    return checked


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_modularity_matches_jax(seed):
    rng = np.random.default_rng(seed)
    c = 12
    w = 0.05 * rng.random((4, c, c))
    w[:, :6, :6] += 0.6 * rng.random((4, 6, 6))
    w[:, 6:, 6:] += 0.6 * rng.random((4, 6, 6))
    w[3] = rng.random((c, c))                    # no planted structure
    w = (w + np.swapaxes(w, -1, -2)) / 2
    w = w.astype(np.float32)
    lt, qt = tg.modularity_communities(_t(w))
    lj, qj = jg.modularity_communities(jnp.asarray(w))
    assert lt.dtype == torch.int32 and tuple(lt.shape) == (4, c)
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=Q_RTOL,
                               atol=Q_ATOL)
    assert _labels_agree_where_the_gap_allows(lt.numpy(), np.asarray(lj),
                                              w) >= 3


def test_modularity_known_answers():
    rng = np.random.default_rng(0)
    c = 20
    w = 0.02 * rng.random((c, c))
    w[:10, :10] += 0.8 * rng.random((10, 10))
    w[10:, 10:] += 0.8 * rng.random((10, 10))
    w = (w + w.T) / 2
    np.fill_diagonal(w, 0.0)
    labels, q = tg.modularity_communities(_t(w))
    labels = labels.numpy()
    assert (labels[:10] == labels[0]).all() and \
        (labels[10:] == labels[10]).all() and labels[0] != labels[10]
    assert float(q) > 0.3
    full = np.ones((12, 12), np.float32)
    np.fill_diagonal(full, 0.0)
    labels, q = tg.modularity_communities(_t(full))
    assert float(q) <= 1e-6 and int(labels.sum()) == 0


def test_modularity_matches_the_numpy_oracle():
    rng = np.random.default_rng(1)
    w = rng.random((8, 8))
    w = (w + w.T) / 2
    np.fill_diagonal(w, 0.0)
    labels, q = tg.modularity_communities(_t(w))
    k = w.sum(1)
    b = w - np.outer(k, k) / k.sum()
    vals, vecs = np.linalg.eigh(b)
    s = np.where(vecs[:, -1] >= 0, 1.0, -1.0)
    assert vals[-1] > 0
    got = labels.numpy().astype(float) * 2 - 1
    assert abs(np.mean(got * s)) == 1.0
    np.testing.assert_allclose(float(q), s @ b @ s / (2 * k.sum()),
                               rtol=Q_RTOL)


def test_modularity_survives_nan_diagonal():
    """The wPLI / PPC matrices carry a NaN diagonal by convention: the split
    must sanitize it, in the port as in JAX."""
    rng = np.random.default_rng(3)
    w = 0.02 * rng.random((16, 16))
    w[:8, :8] += 0.8 * rng.random((8, 8))
    w[8:, 8:] += 0.8 * rng.random((8, 8))
    w = (w + w.T) / 2
    np.fill_diagonal(w, np.nan)
    labels, q = tg.modularity_communities(_t(w))
    labels = labels.numpy()
    assert float(q) > 0.3
    assert (labels[:8] == labels[0]).all() and \
        (labels[8:] == labels[8]).all() and labels[0] != labels[8]
    lj, qj = jg.modularity_communities(w)
    np.testing.assert_allclose(float(q), float(qj), rtol=Q_RTOL)
    assert _labels_agree_where_the_gap_allows(labels, np.asarray(lj), w) == 1
    lb, qb = tg.modularity_communities(_t(np.stack([w, w])))
    assert tuple(lb.shape) == (2, 16)
    np.testing.assert_allclose(qb.numpy(), float(q), rtol=RTOL)


# -- EpochsWavelet.network ----------------------------------------------------

def _network_epochs():
    """``tests/test_graph.py::test_adapter_network``'s inputs."""
    rng = np.random.default_rng(7)
    n, e = 256, 10
    t = np.arange(n) / 250.0
    shared = np.sin(2 * np.pi * 20 * t + 0.7)
    data = 0.5 * rng.standard_normal((e, 3, n)).astype(np.float32)
    data[:, 0] += shared.astype(np.float32)
    data[:, 1] += np.roll(shared, 7).astype(np.float32)
    names = ["a", "b", "c"]
    return (nw.EpochsWavelet(nw.ArrayEpochs(data, 250.0, ch_names=names),
                             nw.Morse(250.0)),
            nt.EpochsWavelet(nt.ArrayEpochs(data, 250.0, ch_names=names),
                             nt.Morse(250.0, device="cpu")))


def _close(got, want, gate, floor=0.0):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    if np.isnan(want).all():
        return
    d = np.nan_to_num(np.abs(got - want)).max()
    assert d <= gate * np.nanmax(np.abs(want)) + floor, d


@pytest.mark.parametrize("method", ["wpli", "plv", "coherence", "ppc",
                                    "pcoh"])
def test_network_matches_jax(monkeypatch, method):
    jew, tew = _network_epochs()
    freqs = [15.0, 20.0, 25.0]
    perms = _jax_null_perms(0, 5, 3)
    monkeypatch.setattr(tg, "_null_perms",
                        lambda *a: torch.from_numpy(perms))
    got = tew.network(freqs, method=method, n_nulls=5)
    want = jew.network(freqs, method=method, n_nulls=5)
    assert set(got) == set(want)
    for key in ("matrix", "strength", "clustering", "efficiency",
                "path_length", "small_world"):
        _close(got[key].numpy(), want[key], NET)
    _close(got["modularity"], want["modularity"], Q_RTOL, Q_ATOL)
    assert isinstance(got["communities"], np.ndarray)
    assert isinstance(got["modularity"], np.ndarray)
    assert got["communities"].shape == (3, 3)
    _labels_agree_where_the_gap_allows(got["communities"],
                                       want["communities"],
                                       np.asarray(want["matrix"]))


def test_network_known_answers():
    _, tew = _network_epochs()
    net = tew.network([15.0, 20.0, 25.0], method="plv", n_nulls=5)
    assert tuple(net["matrix"].shape) == (3, 3, 3)
    assert tuple(net["strength"].shape) == (3, 3)
    assert tuple(net["efficiency"].shape) == (3,)
    assert "small_world" in net
    s20 = net["strength"].numpy()[1]
    assert s20[2] < s20[0] and s20[2] < s20[1]
    assert net["modularity"].shape == (3,)
    assert "small_world" not in tew.network([20.0], method="plv")
    with pytest.raises(ValueError, match="wpli/plv/coherence/ppc/pcoh"):
        tew.network([20.0], method="nope")
