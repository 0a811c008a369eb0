"""The port's Riemannian geometry and decoders
(``ninwavelets_tpu_torch.ops.riemann``) and time-frequency, temporal
generalization, CSP and SSVEP decoding (``ops.decoding``) against the JAX
package, on the CPU, on ``tests/test_riemann.py``'s, ``tests/
test_decoding.py``'s and ``tests/test_spatial.py``'s planted data.

Gates, each with its reason:

* covariances, matrix functions, distances, means, tangent vectors and
  canonical correlations: max|d| <= 1e-5 x max|ref| (float32 products and
  ``eigh`` on both sides, ``Precision.HIGHEST`` there,
  ``fp32_matmul("exact")`` here; the Karcher mean and the tangent vectors
  through 15 fixed-point steps: 1e-4);
* ``decode_auc``: exact (every partial count is a multiple of 0.5, exact
  in any order), ties included;
* the cross-validated scores (MDM, tangent LDA, TF and temporal
  generalization maps, CSP + LDA) are decisions.  A held-out pair whose
  two scores (MDM: a trial whose two distances) are within 1e-5 of the
  fold's scale (about 100 ulps of float32) may rank the other way and
  move an AUC by a whole 1 / (na nb) (an accuracy by 1 / E).  Each
  output cell is held equal to
  the JAX package's (1e-6, the division) where the port's own per-fold
  scores have no such pair, else within those pairs' worth; at least 90%
  of the cells (of the trials, for MDM) must be free of them;
* SSVEP labels: equal, each trial's winning correlation above the runner-up
  by more than 1e-5 (asserted).
"""
import numpy as np
import pytest
import torch

from ninwavelets_tpu.ops import decoding as jdec
from ninwavelets_tpu.ops import riemann as jri
from ninwavelets_tpu_torch.ops import decoding as tdec
from ninwavelets_tpu_torch.ops import riemann as tri

from test_riemann import _spd
from test_riemann import _two_class as _cov_classes
from test_spatial import TestSSVEP as _Ssvep
from test_spatial import _two_class as _csp_classes
from torch_threads import one_torch_thread  # noqa: F401

GATE = 1e-5
MARGIN = 1e-5


def _groups(effect=0.0, e=20, c=4, f=5, n=16, seed=11):
    """``tests/test_decoding.py``'s planes: (E, C, F, N) noise, a channel
    pattern planted in rows 1-2, samples 4-9 of class a, from a local
    generator."""
    rng = np.random.default_rng(seed)
    xa = rng.standard_normal((e, c, f, n)).astype(np.float32)
    xb = rng.standard_normal((e, c, f, n)).astype(np.float32)
    pattern = np.array([1.0, -1.0, 0.5, 0.0])[:c]
    xa[:, :, 1:3, 4:10] += effect * pattern[None, :, None, None]
    return xa, xb


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want, gate=GATE):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got.astype(np.float64) - want).max() <= gate * np.abs(
        want).max()


def _near_ties(sa, sb, tr_a, tr_b):
    """Per output cell, the most an AUC can move by pairs that may rank
    the other way: for every fold, the held-out pairs whose |s_a - s_b| is
    within MARGIN of the fold's largest |score|, each worth 1 / (na nb),
    summed over the folds and divided by their count (the mean AUC)."""
    n_folds = tr_a.shape[0]
    out = 0.0
    for f in range(n_folds):
        a = sa[f][tr_a[f] == 0]
        b = sb[f][tr_b[f] == 0]
        scale = torch.cat([a.abs().flatten(), b.abs().flatten()]).max()
        close = (a[:, None] - b[None]).abs() <= MARGIN * scale
        out = out + close.sum((0, 1)).double() / (a.shape[0] * b.shape[0])
    return (out / n_folds).numpy()


def _auc_close(got, want, slack):
    """Equal (1e-6, the division) where no pair is near a tie; elsewhere
    within the near-tie pairs' worth.  Most cells must be sound."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    slack = np.broadcast_to(slack, want.shape)
    assert (slack == 0).mean() >= 0.9, (slack > 0).mean()
    assert (np.abs(got - want) <= 1e-6 + slack).all()


def test_epoch_covariances_match_jax():
    xa, _ = _cov_classes()
    _close(tri.epoch_covariances(_t(xa)), jri.epoch_covariances(xa))
    _close(tri.epoch_covariances(_t(xa), 0.2),
           jri.epoch_covariances(xa, 0.2))
    _close(tri.epoch_covariances(_t(xa), "lw"),
           jri.epoch_covariances(xa, "lw"))
    for bad in (dict(shrink="oas"),):
        with pytest.raises(ValueError):
            tri.epoch_covariances(_t(xa), **bad)
    with pytest.raises(ValueError):
        tri.epoch_covariances(_t(xa[0]))


def test_matrix_functions_and_geometry_match_jax():
    p = _spd(np.random.default_rng(0), c=5, batch=(7,)).astype(np.float32)
    _close(tri.spd_logm(_t(p)), jri.spd_logm(p))
    _close(tri.spd_sqrtm(_t(p)), jri.spd_sqrtm(p))
    sym = np.asarray(jri.spd_logm(p))
    _close(tri.spd_expm(_t(sym)), jri.spd_expm(sym))
    _close(tri.riemannian_distance(_t(p), _t(p[:1])[0]),
           jri.riemannian_distance(p, p[0]))
    _close(tri.riemannian_distance(_t(p[1:]), _t(p[:-1])),
           jri.riemannian_distance(p[1:], p[:-1]))
    _close(tri.riemannian_mean(_t(p)), jri.riemannian_mean(p), 1e-4)
    w = np.linspace(1.0, 3.0, 7).astype(np.float32)
    _close(tri.riemannian_mean(_t(p), w, n_iter=10),
           jri.riemannian_mean(p, w, n_iter=10), 1e-4)
    _close(tri.tangent_space(_t(p), _t(p[2])), jri.tangent_space(p, p[2]),
           1e-4)
    with pytest.raises(ValueError):
        tri.riemannian_mean(_t(p[0]))


@pytest.mark.parametrize("gap", [2.5, 1.15])
def test_mdm_decode_matches_jax(gap):
    xa, xb = _cov_classes(gap=gap)
    want = jri.mdm_decode(xa, xb)
    got = tri.mdm_decode(_t(xa), _t(xb))
    # the decisions' margins on the port's own distances
    # each held-out trial whose two distances are within MARGIN may be
    # labeled the other way: worth 1 / (all held-out trials)
    ca, cb, nf = tri._decode_setup(_t(xa), _t(xb), 5, 0.05)
    tr_a = tri._fold_masks(ca.shape[0], nf, "cpu")
    tr_b = tri._fold_masks(cb.shape[0], nf, "cpu")
    ma = tri._karcher_masked(ca, tr_a, 15)[:, None]
    mb = tri._karcher_masked(cb, tr_b, 15)[:, None]
    near = 0
    for cov, tr in ((ca, tr_a), (cb, tr_b)):
        d0 = tri.riemannian_distance(cov, ma)
        d1 = tri.riemannian_distance(cov, mb)
        close = (d0 - d1).abs() <= MARGIN * d0.abs().max()
        near += int((close & (tr == 0)).sum())
    assert near <= 0.1 * (ca.shape[0] + cb.shape[0])
    assert abs(got - want) <= 1e-6 + near / (ca.shape[0] + cb.shape[0])
    if gap == 2.5:
        assert want > 0.9


@pytest.mark.parametrize("gap", [2.5, 1.15])
def test_tangent_decode_matches_jax(gap):
    xa, xb = _cov_classes(gap=gap)
    want = jri.tangent_decode(xa, xb)
    got = tri.tangent_decode(_t(xa), _t(xb))
    ca, cb, nf = tri._decode_setup(_t(xa), _t(xb), 5, 0.05)
    sa, sb, tr_a, tr_b = tri._tangent_fold_scores(ca, cb, n_folds=nf,
                                                  n_iter=15, lam=1e-3)
    _auc_close(got, want, _near_ties(sa, sb, tr_a, tr_b))
    with pytest.raises(ValueError):
        tri.tangent_decode(_t(xa[:3]), _t(xb))


def test_decode_auc_counts_ties_exactly():
    rng = np.random.default_rng(3)
    sa = rng.integers(0, 4, (9, 3, 5)).astype(np.float32)
    sb = rng.integers(0, 4, (7, 3, 5)).astype(np.float32)
    va = (rng.random(9) > 0.3).astype(np.float32)
    vb = (rng.random(7) > 0.3).astype(np.float32)
    got = tdec.decode_auc(_t(sa), _t(sb), _t(va), _t(vb))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jdec.decode_auc(sa, sb, va, vb)))


def _lda_slack(xa, xb, n_folds, lam, scores):
    tr_a = tdec._fold_masks(xa.shape[0], n_folds, "cpu")
    tr_b = tdec._fold_masks(xb.shape[0], n_folds, "cpu")
    sa, sb = [], []
    for f in range(n_folds):
        w = tdec._lda_weights(xa, xb, tr_a[f], tr_b[f], lam)
        sa.append(scores(xa, w))
        sb.append(scores(xb, w))
    return _near_ties(sa, sb, tr_a, tr_b)


@pytest.mark.parametrize("effect", [0.0, 1.5])
def test_tf_decode_matches_jax(effect):
    xa, xb = _groups(effect)
    got = tdec.tf_decode(_t(xa), _t(xb))
    _auc_close(got, jdec.tf_decode(xa, xb),
               _lda_slack(_t(xa), _t(xb), 5, 1e-3, tdec._scores))
    if effect:
        assert float(got[1:3, 4:10].mean()) > 0.9
    with pytest.raises(ValueError):
        tdec.tf_decode(_t(xa[:3]), _t(xb))
    with pytest.raises(ValueError):
        tdec.tf_decode(_t(xa[..., 0]), _t(xb[..., 0]))


def test_tf_decode_chunks_are_the_whole():
    """Trial chunks of the plane statistics and the pairwise counts give
    the unchunked map (the budgets shrunk to one trial and one pair
    row)."""
    xa, xb = _groups(1.0)
    whole = tdec.tf_decode(_t(xa), _t(xb))
    budgets = tdec._AUC_BYTES, tdec._PLANE_BYTES
    try:
        tdec._AUC_BYTES, tdec._PLANE_BYTES = 1, 1
        chunked = tdec.tf_decode(_t(xa), _t(xb))
    finally:
        tdec._AUC_BYTES, tdec._PLANE_BYTES = budgets
    _close(chunked, whole, 1e-6)


def test_temporal_generalization_matches_jax():
    xa, xb = _groups(1.5)
    ya, yb = xa[:, :, 1], xb[:, :, 1]
    got = tdec.temporal_generalization(_t(ya), _t(yb))
    _auc_close(got, jdec.temporal_generalization(ya, yb),
               _lda_slack(_t(ya), _t(yb), 5, 1e-3, lambda x, w: w.T @ x))


@pytest.mark.parametrize("band", [False, True])
def test_csp_decode_matches_jax(band):
    xa, xb, _, _ = _csp_classes(np.random.default_rng(6), 16, 6, 256,
                                128.0)
    kw = dict(f_lo=9.0, f_hi=13.0, sfreq=128.0) if band else {}
    want = float(jdec.csp_decode(xa, xb, n_components=2, **kw))
    got = float(tdec.csp_decode(_t(xa), _t(xb), n_components=2, **kw))
    ta, tb = _t(xa), _t(xb)
    if band:
        from ninwavelets_tpu_torch.ops.filtering import bandpass
        ta, tb = bandpass(ta, 128.0, 9.0, 13.0), bandpass(tb, 128.0, 9.0,
                                                          13.0)
    filt = tdec._fold_ged_jit(tdec._fold_covs_jit(ta, n_folds=5),
                              tdec._fold_covs_jit(tb, n_folds=5),
                              n_components=2, shrink=0.01)
    sa, sb, tr_a, tr_b = tdec._csp_fold_scores(ta, tb, filt, n_folds=5,
                                               lam=1e-3)
    _auc_close(got, want, _near_ties(sa, sb, tr_a, tr_b))
    with pytest.raises(ValueError):
        tdec.csp_decode(_t(xa), _t(xb), f_lo=9.0)


def test_ssvep_matches_jax():
    stim = [8.0, 10.0, 12.0, 15.0]
    labels = np.arange(12) % 4
    x = _Ssvep._trials(stim, labels)
    np.testing.assert_array_equal(tdec.cca_reference(stim, 500, 250.0,
                                                     device="cpu").numpy(),
                                  np.asarray(jdec.cca_reference(stim, 500,
                                                                250.0)))
    got_l, got_rho = tdec.ssvep_cca(_t(x), stim, 250.0)
    want_l, want_rho = jdec.ssvep_cca(x, stim, 250.0)
    _close(got_rho, want_rho)
    top2 = np.sort(np.asarray(want_rho), -1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > 1e-5
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    assert got_l.dtype == torch.int32
    one_l, one_rho = tdec.ssvep_cca(_t(x[0]), stim, 250.0, n_harmonics=2)
    _close(one_rho, jdec.ssvep_cca(x[0], stim, 250.0, n_harmonics=2)[1])
    with pytest.raises(ValueError):
        tdec.ssvep_cca(_t(x), [], 250.0)
