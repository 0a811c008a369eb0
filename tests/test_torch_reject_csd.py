"""The port's trial rejection and channel QC
(``ninwavelets_tpu_torch.ops.reject``) and spherical splines
(``ops.csd``) against the JAX package, on the CPU, on
``tests/test_reject.py``'s planted epochs and montage.

Gates, each with its reason:

* the spline host math (Legendre series, kernels, the CSD and
  interpolation matrices) and the autoreject folds: exact (host numpy
  copied from the JAX package; the folds are the same seeded
  ``np.random.default_rng`` permutation);
* the candidate grid: within 2 ulps (the same float32 ranks and weights
  as ``jnp.quantile``, whose weighted sum XLA contracts into a fused
  multiply-add), and no trial's peak-to-peak that close to a candidate,
  so every keep mask of the search is the JAX package's;
* peak-to-peak: exact (a max minus a min);
* products in float32 on both sides (CV errors, regression, CSD and
  interpolation, the QC statistics): max|d| <= 1e-5 x max|ref|
  (``Precision.HIGHEST`` there, ``fp32_matmul("exact")`` here; sums in
  other orders);
* decisions held where the margin exceeds the tolerance, the margins
  asserted: autoreject's argmin (the runner-up's CV error above the
  winner's by more than the gate), each trial's keep decision against
  the winning threshold, and every criterion of ``find_bad_channels``
  (each robust z and |correlation| farther from its threshold than the
  statistics' gate carried through).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ninwavelets_tpu.ops import csd as jcsd
from ninwavelets_tpu.ops import reject as jrej
from ninwavelets_tpu_torch import convert
from ninwavelets_tpu_torch.ops import csd as tcsd
from ninwavelets_tpu_torch.ops import reject as trej

import test_reject
from test_reject import _epochs
from torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"
GATE = 1e-5


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want, gate=GATE):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got.astype(np.float64) - want).max() <= gate * np.abs(
        want).max()


def _montage():
    """``tests/test_reject.py``'s planted montage: flat 2, deviant 5,
    line noise 6, a bridge 0-7, uncorrelated 9."""
    x, t, rng = test_reject.TestFindBadChannels()._montage()
    x[2] = 1e-14
    x[5] *= 60
    x[6] = 3 * np.sin(2 * np.pi * 60 * t) + 0.1 * rng.standard_normal(t.size)
    x[7] = x[0] + 1e-3 * rng.standard_normal(t.size).astype(np.float32)
    x[9] = rng.standard_normal(t.size)
    return x.astype(np.float32)


def _positions(c):
    th = np.linspace(0, 2 * np.pi, c, endpoint=False)
    return np.stack([np.cos(th) * 0.9, np.sin(th) * 0.9,
                     np.full(c, 0.436)], 1)


def test_ptp_and_reject_match_jax():
    x, _ = _epochs()
    np.testing.assert_array_equal(trej.ptp(_t(x)).numpy(),
                                  np.asarray(jrej.ptp(x)))
    for thr in (5.0, 8.0):
        np.testing.assert_array_equal(trej.ptp_reject(_t(x), thr).numpy(),
                                      np.asarray(jrej.ptp_reject(x, thr)))
    with pytest.raises(ValueError):
        trej.ptp_reject(_t(x[0]), 1.0)


@pytest.mark.parametrize("grid,seed", [(None, 0), (None, 3),
                                       ("custom", 0)])
def test_autoreject_matches_jax(grid, seed):
    x, bad = _epochs()
    thresholds = (None if grid is None
                  else np.linspace(2.0, 20.0, 12).astype(np.float32))
    ref = jrej.autoreject_global(x, thresholds=thresholds, seed=seed)
    got = trej.autoreject_global(_t(x), thresholds=thresholds, seed=seed)
    grid = np.asarray(ref.thresholds)
    if thresholds is None:
        _close(got.thresholds, grid, 2.5e-7)
        # a candidate is a trial's own peak-to-peak (the 0 and 1
        # quantiles: equal in both packages) or far from every trial's
        worst = np.asarray(jrej.ptp(x)).max(-1)
        at = np.isin(grid, worst)
        np.testing.assert_array_equal(got.thresholds.numpy()[at], grid[at])
        assert np.abs(worst[:, None] - grid[None, ~at]).min() \
            > 2.5e-7 * grid.max()
    else:
        np.testing.assert_array_equal(got.thresholds.numpy(), grid)
    want = np.asarray(ref.cv_error)
    have = got.cv_error.numpy()
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(have), fin)
    _close(have[fin], want[fin])
    # the argmin is a decision.  Candidates that keep the same trials tie
    # exactly in both packages (the first wins); every other candidate is
    # farther than the gate
    tie = want == want.min()
    np.testing.assert_array_equal(have == have.min(), tie)
    assert (want[~tie & fin] - want.min()).min() \
        > 2 * GATE * np.abs(want[fin]).max()
    assert got.threshold == ref.threshold
    # every trial's keep decision is farther from the threshold than an
    # ulp of the peak-to-peak
    worst = np.asarray(jrej.ptp(x)).max(-1)
    assert np.abs(worst - ref.threshold).min() > 1e-6 * worst.max()
    np.testing.assert_array_equal(got.drop_mask.numpy(),
                                  np.asarray(ref.drop_mask))
    if grid is None:
        assert got.drop_mask.numpy()[bad].all()


def test_autoreject_validation():
    x, _ = _epochs(e=4, n_bad=1)
    with pytest.raises(ValueError):
        trej.autoreject_global(_t(x), n_folds=5)
    with pytest.raises(ValueError):
        trej.autoreject_global(_t(x[0]))
    with pytest.raises(ValueError):
        trej.autoreject_global(_t(_epochs()[0]), thresholds=np.ones((2, 2)))


def test_reject_result_from_jax():
    x, _ = _epochs()
    ref = jrej.autoreject_global(x)
    res = convert.reject_result_from_jax(ref, device=CPU)
    assert isinstance(res, trej.RejectResult)
    assert res.threshold == ref.threshold
    np.testing.assert_array_equal(res.cv_error.numpy(),
                                  np.asarray(ref.cv_error))
    # the JAX threshold applied by the port drops JAX's trials
    np.testing.assert_array_equal(
        trej.ptp_reject(_t(x), res.threshold).numpy(),
        res.drop_mask.numpy())


@pytest.mark.parametrize("batch", [False, True])
def test_regress_out_matches_jax(batch):
    rng = np.random.default_rng(4)
    shape = (6, 5, 400) if batch else (5, 400)
    refs = rng.standard_normal(shape[:-2] + (2, 400)).astype(np.float32)
    x = (rng.standard_normal(shape)
         + 3.0 * rng.standard_normal((5, 2)) @ refs).astype(np.float32)
    _close(trej.regress_out(_t(x), _t(refs)), jrej.regress_out(x, refs))
    one = refs[..., 0, :]
    if not batch:
        _close(trej.regress_out(_t(x), _t(one)), jrej.regress_out(x, one))
    with pytest.raises(ValueError):
        trej.regress_out(_t(x), _t(refs[..., :300]))


def test_chan_stats_match_jax():
    x = _montage()
    want = jrej._chan_stats_jit(jnp.asarray(x), sfreq=250.0, hf_hz=40.0)
    got = trej._chan_stats_jit(_t(x), sfreq=250.0, hf_hz=40.0)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    # the flat channel's centered samples are the round-off of its mean:
    # its spectrum and correlations are noise in both packages, and
    # find_bad_channels zeroes its correlations
    good = np.arange(16) != 2
    _close(got[1].numpy()[good], np.asarray(want[1])[good])
    _close(got[2].numpy()[np.ix_(good, good)],
           np.asarray(want[2])[np.ix_(good, good)])


@pytest.mark.parametrize("hf_hz", [40.0, 125.0])
def test_find_bad_channels_matches_jax(hf_hz):
    x = _montage()
    got = trej.find_bad_channels(_t(x), 250.0, hf_hz=hf_hz)
    want = jrej.find_bad_channels(x, 250.0, hf_hz=hf_hz)
    assert got == want
    # at Nyquist the hf criterion is off; the line-noise channel is still
    # uncorrelated
    assert want["bads"] == [2, 5, 6, 9]
    assert want["hf"] == ([6, 9] if hf_hz == 40.0 else [])
    # margins of the decisions: the statistics agree to GATE of their
    # max, far inside each criterion's distance from its threshold
    mad, hf, corr = (np.asarray(v) for v in jrej._chan_stats_jit(
        jnp.asarray(x), sfreq=250.0, hf_hz=40.0))
    good = ~np.isin(np.arange(16), want["flat"])
    z_amp = jrej._robust_z(np.log(np.maximum(mad, 1e-30)), good, 0.05)
    assert np.abs(z_amp[good] - 5.0).min() > 0.1
    z_hf = jrej._robust_z(hf, good, 0.1)
    assert np.abs(z_hf[good] - 5.0).min() > 0.1
    c = np.abs(corr[np.ix_(good, good)])
    assert np.abs(c.max(1) - 0.3).min() > 1e-3
    assert np.abs(c - 0.995).min() > 1e-4


def test_find_bad_channels_validation():
    with pytest.raises(ValueError):
        trej.find_bad_channels(torch.zeros(3, 4, 100), 250.0)
    with pytest.raises(ValueError):
        trej.find_bad_channels(torch.zeros(3, 5), 250.0)


def test_spline_host_math_is_jax_exactly():
    pos = _positions(16)
    for a, b in zip(tcsd.spline_matrices(pos), jcsd.spline_matrices(pos)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tcsd.csd_transform(pos, lam=1e-4),
                                  jcsd.csd_transform(pos, lam=1e-4))
    np.testing.assert_array_equal(
        tcsd.interpolation_matrix(pos, [3, 8], stiffness=3),
        jcsd.interpolation_matrix(pos, [3, 8], stiffness=3))
    np.testing.assert_array_equal(tcsd._bordered_system(np.eye(3), 0.1),
                                  jcsd._bordered_system(np.eye(3), 0.1))


@pytest.mark.parametrize("shape", [(16, 2000), (3, 16, 500)])
def test_csd_matches_jax(shape):
    x = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    pos = _positions(16)
    _close(tcsd.csd(_t(x), pos), jcsd.csd(x, pos))
    _close(tcsd.csd(_t(x), pos, stiffness=3, head_radius=0.09),
           jcsd.csd(x, pos, stiffness=3, head_radius=0.09))
    with pytest.raises(ValueError):
        tcsd.csd(_t(x), _positions(15))


@pytest.mark.parametrize("shape", [(16, 2000), (3, 16, 500)])
def test_interpolate_channels_matches_jax(shape):
    x = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    pos = _positions(16)
    got = tcsd.interpolate_channels(_t(x), pos, [2, 11])
    _close(got, jcsd.interpolate_channels(x, pos, [2, 11]))
    keep = [i for i in range(16) if i not in (2, 11)]
    np.testing.assert_array_equal(got.numpy()[..., keep, :], x[..., keep, :])
    for bad in ([], [2, 2], [16]):
        with pytest.raises(ValueError):
            tcsd.interpolate_channels(_t(x), pos, bad)
