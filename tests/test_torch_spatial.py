"""The port's spatial filters (``ninwavelets_tpu_torch.ops.spatial``:
covariances, Ledoit-Wolf, GED, CSP, SSD, correlated components, xDAWN)
against the JAX package, on the CPU, on ``tests/test_spatial.py``'s
planted data.

Gates, each with its reason:

* covariances, the Ledoit-Wolf weight, eigenvalues, features and
  projections: max|d| <= 1e-5 x max|ref| (float32 products on both sides:
  ``Precision.HIGHEST`` there, ``fp32_matmul("exact")`` here);
* filters and patterns, column by column: 1e-5 + 1e-6 x max|lam| / gap_k
  of the column's max, gap_k the distance from component k's generalized
  eigenvalue to its nearest neighbour in the full spectrum (an eigenvector
  of a float32 ``eigh`` moves by about eps ||A|| / gap), each gap
  asserted above 1e-3 of the spectrum's range; the order and sign
  conventions make the columns comparable;
* ``corrca`` and ``xdawn`` fix no sign in either package: each filter is
  compared up to its sign.
"""
import numpy as np
import pytest
import torch

from ninwavelets_tpu.ops import filtering as jflt
from ninwavelets_tpu.ops import spatial as jsp
from ninwavelets_tpu_torch import convert
from ninwavelets_tpu_torch.ops import spatial as tsp

from test_spatial import TestXdawn as _Xd
from test_spatial import _planted, _spd, _two_class
from torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"
GATE = 1e-5
SF = 128.0


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want, gate=GATE):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got.astype(np.float64) - want).max() <= gate * np.abs(
        want).max()


def _gaps(spectrum):
    v = np.asarray(spectrum, np.float64)
    return (np.abs(v[:, None] - v[None, :])
            + np.diag(np.full(v.size, np.inf))).min(1)


def _cols_close(got, want, spectrum, pick=None):
    """Column k within the eigenvector gate of its generalized eigenvalue
    (``spectrum`` the full one, ``pick`` the columns' indices in it)."""
    spectrum = np.asarray(spectrum, np.float64)
    gaps = _gaps(spectrum)
    pick = np.arange(np.asarray(want).shape[1]) if pick is None else pick
    assert (gaps[pick] > 1e-3 * np.ptp(spectrum)).all(), gaps[pick]
    gate = GATE + 1e-6 * np.abs(spectrum).max() / gaps[pick]
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    d = np.abs(got.astype(np.float64) - want).max(0)
    assert (d <= gate * np.abs(want).max(0)).all(), (d, gate)


def _signed(got, want):
    """``got``'s rows flipped to ``want``'s signs."""
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    s = np.sign((got * np.asarray(want)).sum(1, keepdims=True))
    return got * s


@pytest.mark.parametrize("shape", [(7, 513), (4, 5, 257)])
def test_covariance_and_ledoit_wolf_match_jax(shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    _close(tsp.covariance(_t(x)), jsp.covariance(x))
    cov, alpha = tsp.ledoit_wolf(_t(x))
    jcov, jalpha = jsp.ledoit_wolf(x)
    _close(cov, jcov)
    assert abs(alpha - jalpha) <= GATE * abs(jalpha)
    with pytest.raises(ValueError):
        tsp.covariance(torch.zeros(2, 2, 2, 2))
    with pytest.raises(ValueError):
        tsp.ledoit_wolf(torch.zeros(3, 1))


@pytest.mark.parametrize("k,shrink", [(None, 0.01), (3, 0.0)])
def test_ged_matches_jax(k, shrink):
    rng = np.random.default_rng(2)
    s = _spd(rng, 6, 30.0).astype(np.float32)
    r = _spd(rng, 6, 3.0).astype(np.float32)
    ref = jsp.ged(s, r, n_components=k, shrink=shrink)
    got = tsp.ged(_t(s), _t(r), n_components=k, shrink=shrink)
    full = jsp.ged(s, r, shrink=shrink).eigvals
    _close(got.eigvals, ref.eigvals)
    _cols_close(got.filters, ref.filters, full)
    _cols_close(got.patterns, ref.patterns, full)
    with pytest.raises(ValueError):
        tsp.ged(_t(s), _t(r[:5, :5]))
    with pytest.raises(ValueError):
        tsp.ged(_t(s), _t(r), n_components=7)


@pytest.mark.parametrize("band", [False, True])
def test_csp_and_features_match_jax(band):
    xa, xb, _, _ = _two_class(np.random.default_rng(6), 16, 6, 512, SF)
    kw = dict(f_lo=9.0, f_hi=13.0, sfreq=SF) if band else {}
    ref = jsp.csp(xa, xb, n_components=2, **kw)
    got = tsp.csp(_t(xa), _t(xb), n_components=2, **kw)
    if band:
        fa = np.asarray(jflt.bandpass(xa, SF, 9.0, 13.0))
        fb = np.asarray(jflt.bandpass(xb, SF, 9.0, 13.0))
    else:
        fa, fb = xa, xb
    ca = np.asarray(jsp.covariance(fa))
    full = jsp.ged(ca, ca + np.asarray(jsp.covariance(fb)),
                   shrink=0.01).eigvals
    _close(got.eigvals, ref.eigvals)
    _cols_close(got.filters, ref.filters, full, pick=np.array([0, 5]))
    _cols_close(got.patterns, ref.patterns, full, pick=np.array([0, 5]))
    _close(tsp.csp_features(_t(xa), got.filters),
           jsp.csp_features(xa, ref.filters))
    with pytest.raises(ValueError):
        tsp.csp(_t(xa), _t(xb), f_lo=9.0)
    with pytest.raises(ValueError):
        tsp.csp(_t(xa), _t(xb[:, :5]))


def test_ssd_matches_jax():
    x, _ = _planted(np.random.default_rng(5), 10, 6, 1024, SF, 10.0)
    ref = jsp.ssd(x, SF, 8.0, 12.0, n_components=2)
    got = tsp.ssd(_t(x), SF, 8.0, 12.0, n_components=2)
    full = jsp.ssd(x, SF, 8.0, 12.0).eigvals
    _close(got.eigvals, ref.eigvals)
    _cols_close(got.filters[:, :1], ref.filters[:, :1], full, np.array([0]))
    _cols_close(got.patterns[:, :1], ref.patterns[:, :1], full,
                np.array([0]))
    for bad in (dict(f_lo=1.0, f_hi=4.0), dict(f_lo=8.0, f_hi=12.0,
                                               gap=2.5)):
        with pytest.raises(ValueError):
            tsp.ssd(_t(x[0]), SF, **bad)


def test_spatial_apply_on_a_jax_fit():
    """``convert.spatial_result_from_jax``: JAX's CSP filters applied by
    the port give JAX's component time series."""
    xa, xb, _, _ = _two_class(np.random.default_rng(7), 8, 6, 256, SF)
    ref = jsp.csp(xa, xb, n_components=4)
    res = convert.spatial_result_from_jax(ref, device=CPU)
    assert isinstance(res, tsp.SpatialResult)
    _close(tsp.spatial_apply(_t(xa), res.filters),
           jsp.spatial_apply(xa, ref.filters))
    _close(tsp.spatial_apply(_t(xa[0]), res.filters),
           jsp.spatial_apply(xa[0], ref.filters))


def test_corrca_matches_jax_up_to_sign():
    rng = np.random.default_rng(8)
    shared = rng.standard_normal(2000)
    topo = rng.standard_normal(5)
    x = (0.8 * topo[None, :, None] * shared[None, None, :]
         + rng.standard_normal((4, 5, 2000))).astype(np.float32)
    w, isc = tsp.corrca(_t(x), 2)
    jw, jisc = jsp.corrca(x, 2)
    _close(isc, jisc)
    # the ISCs are the generalized eigenvalues: rows at the eigenvector
    # gate of the full spectrum (the second component is noise, near its
    # neighbours)
    full = np.asarray(jsp.corrca(x, 5)[1])
    _cols_close(_signed(w, jw).T, np.asarray(jw).T, full, np.arange(2))
    with pytest.raises(ValueError):
        tsp.corrca(_t(x[:1]))


def test_xdawn_matches_jax_up_to_sign():
    x, ev, _, _, L = _Xd._p300(c=6, n=12000, n_ev=30, amp=2.0)
    w, evoked, ratios = tsp.xdawn(_t(x), ev, L, n_components=2)
    jw, jev, jr = jsp.xdawn(x, ev, L, n_components=2)
    _close(ratios, jr)
    full = np.asarray(jsp.xdawn(x, ev, L, n_components=6)[2])
    _cols_close(_signed(w, jw).T, np.asarray(jw).T, full, np.arange(2))
    s = np.sign((w.numpy() * np.asarray(jw)).sum(1, keepdims=True))
    _cols_close((evoked.numpy() * s).T, np.asarray(jev).T, full,
                np.arange(2))
    with pytest.raises(ValueError):
        tsp.xdawn(_t(x), [5], L)
