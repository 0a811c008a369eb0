"""The port's wavelet packets and best bases
(``ninwavelets_tpu_torch.ops.wpt``) against the JAX package on the same
seeded inputs, on the CPU, and against ``tests/test_wpt.py``'s known
answers.

Gates, each with its reason:

* the packet bank: exact (the same float64 numpy code, copied);
* packet tables and reconstructions: max|d| <= 1e-5 x max|ref| (float32
  FFT pipelines of the same bank, apart in the FFT's round-off);
* best basis: the "shannon" and "threshold" node costs at rtol 1e-5 (the
  same host arithmetic on tables that agree to round-off).  The
  "energy_log" cost sums ``log c^2`` over every coefficient, so a
  coefficient near zero turns the tables' round-off into an unbounded
  cost error: it is held to the tables' gate carried through the log,
  ``sum 2 d / min(|c_port|, |c_jax|)`` with ``d`` = 1e-5 x max|c| (the
  mean value theorem); it was measured up to 1.7e-5 relative.  The
  selected coefficients are held at 1e-5 of the largest of them.  The
  nodes are a discrete choice (``c <= child``) that float32 round-off can
  flip, so they are compared where every decision of the prune has a
  relative margin above 1e-4 (or where both packages' costs are equal, as
  the "threshold" counts are), and every case here is chosen so that they
  are;
* validation: the JAX package's exception type.
"""
import numpy as np
import pytest
import torch

from ninwavelets_tpu.ops import wpt as jw
from ninwavelets_tpu_torch.ops import dwt as td
from ninwavelets_tpu_torch.ops import wpt as tw

from test_torch_dwt import _close
from torch_threads import one_torch_thread  # noqa: F401

SFREQ = 1000.0
CPU = "cpu"
MARGIN = 1e-4


def _tone(f, n=2048, noise=0.0, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SFREQ
    return (np.sin(2 * np.pi * f * t)
            + noise * rng.standard_normal(n)).astype(np.float32)


def test_packet_bank_is_the_jax_packages():
    for args in (("db4", 3, 512), ("db8", 5, 1024), ("haar", 1, 8)):
        for a, b in zip(tw.modwpt_bank(*args), jw.modwpt_bank(*args)):
            np.testing.assert_array_equal(a, b)
    br, bi = tw.modwpt_bank("db4", 3, 512)
    np.testing.assert_allclose((br.astype(np.float64) ** 2
                                + bi.astype(np.float64) ** 2).sum(0), 1.0,
                               atol=1e-6)


def test_level1_packets_are_the_modwt():
    x = np.random.default_rng(0).standard_normal((2, 512)).astype(np.float32)
    w = tw.modwpt(x, "db4", 1, device=CPU)
    _close(w, jw.modwpt(x, "db4", 1))
    m = td.modwt(x, "db4", 1, device=CPU)
    np.testing.assert_array_equal(w[:, 0].numpy(), m[:, 1].numpy())
    np.testing.assert_array_equal(w[:, 1].numpy(), m[:, 0].numpy())


@pytest.mark.parametrize("level", [2, 3, 5])
def test_modwpt_and_inverse_match_jax(level):
    x = np.random.default_rng(level).standard_normal((3, 512)).astype(
        np.float32)
    w = tw.modwpt(x, "db4", level, device=CPU)
    wj = jw.modwpt(x, "db4", level)
    _close(w, wj)
    assert w.shape == (3, 2 ** level, 512)
    rec = tw.imodwpt(w, "db4")
    _close(rec, jw.imodwpt(wj, "db4"))
    np.testing.assert_allclose(rec.numpy(), x, atol=2e-6)
    np.testing.assert_allclose(float((w.double() ** 2).sum()),
                               float((x.astype(np.float64) ** 2).sum()),
                               rtol=1e-5)


@pytest.mark.parametrize("b", [0, 1, 3, 6, 7])
def test_tone_lands_in_its_packet(b):
    lo, hi = tw.node_band(3, b)
    assert (lo, hi) == jw.node_band(3, b)
    tone = _tone((lo + hi) / 2 * SFREQ)
    w = tw.modwpt(tone, "db8", 3, device=CPU)
    _close(w, jw.modwpt(tone, "db8", 3))
    e = (w.numpy() ** 2).sum(-1)
    assert int(np.argmax(e)) == b and e[b] > 0.7 * e.sum()


def test_validation_matches_jax():
    for pkg in (tw, jw):
        with pytest.raises(ValueError):
            pkg.modwpt_bank("db4", 0, 64)
        with pytest.raises(ValueError):
            pkg.modwpt_bank("db4", 8, 64)
    with pytest.raises(ValueError):
        jw.imodwpt(np.zeros((3, 64), np.float32))
    with pytest.raises(ValueError):
        tw.imodwpt(np.zeros((3, 64), np.float32), device=CPU)


def _jax_costs(x, wavelet, max_level, cost):
    """The JAX package's node costs: its own tables through the (copied)
    host cost functional."""
    tables = {j: np.asarray(jw.modwpt(x, wavelet, j))
              for j in range(1, max_level + 1)}
    tables[0] = np.asarray(x)[..., None, :]
    return tw._node_costs(tables, max_level, cost)


def _log_bound(x, wavelet, max_level):
    """{(level, b): the "energy_log" cost's error bound}: the tables' gate
    carried through ``log c^2`` of each scaled coefficient, over 2^j."""
    out = {(0, 0): 0.0}
    for j in range(1, max_level + 1):
        a = np.abs(tw.modwpt(x, wavelet, j, device=CPU).numpy())
        b = np.abs(np.asarray(jw.modwpt(x, wavelet, j)))
        d = 1e-5 * b.max()
        low = np.minimum(a, b)
        for k in range(2 ** j):
            keep = (a[..., k, :] != 0) & (b[..., k, :] != 0)
            out[(j, k)] = float(np.sum(2.0 * d / low[..., k, :][keep])
                                ) / 2.0 ** j
    return out


def _margin(costs, max_level):
    """The smallest relative margin |c - child| / max(|c|, |child|) over
    every decision of the bottom-up prune."""
    best, low = {}, np.inf
    for j in range(max_level, -1, -1):
        for b in range(2 ** j):
            c = costs[(j, b)]
            if j == max_level:
                best[(j, b)] = c
                continue
            child = best[(j + 1, 2 * b)] + best[(j + 1, 2 * b + 1)]
            scale = max(abs(c), abs(child))
            if scale:
                low = min(low, abs(c - child) / scale)
            best[(j, b)] = min(c, child)
    return low


@pytest.mark.parametrize("cost", ["shannon", "energy_log", "threshold"])
@pytest.mark.parametrize("case", [(166.0, 0.5, 1), (166.0, 0.0, 0),
                                  (60.0, 1.0, 3)])
def test_best_basis_matches_jax(cost, case):
    f, noise, seed = case
    x = _tone(f, n=1024, noise=noise, seed=seed)
    if cost == "threshold":
        x = 3.0 * x
    nodes, coeffs = tw.best_basis(x, "db8", 4, cost=cost, device=CPU)
    got = tw._node_costs({j: tw.modwpt(x, "db8", j, device=CPU).numpy()
                          for j in range(1, 5)} | {0: x[None, :]}, 4, cost)
    want = _jax_costs(x, "db8", 4, cost)
    if cost == "energy_log":
        bound = _log_bound(x, "db8", 4)
        for key in want:
            assert abs(got[key] - want[key]) <= bound[key], key
    else:
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5)
    assert got == want or _margin(want, 4) > MARGIN
    nodes_j, coeffs_j = jw.best_basis(x, "db8", 4, cost=cost)
    assert nodes == nodes_j
    _close(torch.stack([coeffs[nd] for nd in nodes]),
           np.stack([coeffs_j[nd] for nd in nodes]))
    bands = sorted(tw.node_band(*nd) for nd in nodes)
    assert bands[0][0] == 0.0 and bands[-1][1] == 0.5
    assert all(b1 == a2 for (_, b1), (a2, _) in zip(bands, bands[1:]))
    rec = tw.best_basis_reconstruct(nodes, coeffs, "db8")
    _close(rec, jw.best_basis_reconstruct(nodes_j, coeffs_j, "db8"))
    np.testing.assert_allclose(rec.numpy(), x, atol=1e-5 * np.abs(x).max())


def test_pure_tone_splits_deep():
    nodes, _ = tw.best_basis(_tone(166.0), "db8", 4, device=CPU)
    assert all(j == 4 for j, _ in nodes)


def test_band_selective_reconstruction_matches_jax():
    tone = _tone(166.0)
    noisy = _tone(166.0, noise=0.5, seed=2)
    nodes, coeffs = tw.best_basis(noisy, "db8", 4, device=CPU)
    nodes_j, coeffs_j = jw.best_basis(noisy, "db8", 4)
    assert nodes == nodes_j
    keep = [nd for nd in nodes
            if tw.node_band(*nd)[0] <= 166.0 / SFREQ < tw.node_band(*nd)[1]]
    xr = tw.best_basis_reconstruct(nodes, coeffs, "db8", keep=keep)
    _close(xr, jw.best_basis_reconstruct(nodes_j, coeffs_j, "db8",
                                         keep=keep))
    assert ((xr.numpy() - tone) ** 2).mean() < 0.15 * (
        (noisy - tone) ** 2).mean()
    with pytest.raises(ValueError):
        tw.best_basis_reconstruct(nodes, coeffs, "db8", keep=[])
    with pytest.raises(ValueError):
        jw.best_basis_reconstruct(nodes_j, coeffs_j, "db8", keep=[])


def test_best_basis_of_a_batch_and_the_root():
    x = np.random.default_rng(5).standard_normal((2, 256)).astype(np.float32)
    nodes, coeffs = tw.best_basis(x, "db4", 3, cost="energy_log",
                                  device=CPU)
    assert all(coeffs[nd].shape == (2, 256) for nd in nodes)
    assert isinstance(coeffs[nodes[0]], torch.Tensor)
    root = tw.best_basis_reconstruct([(0, 0)], {(0, 0): torch.from_numpy(x)})
    np.testing.assert_array_equal(root.numpy(), x)
    for pkg, kw in ((tw, {"device": CPU}), (jw, {})):
        with pytest.raises(ValueError):
            pkg.best_basis(x, "db4", 3, cost="nope", **kw)
