"""The port's temporal response functions (``ninwavelets_tpu_torch.ops.trf``)
against the JAX package, on the CPU, on ``tests/test_trf.py``'s planted
kernels.

Gates, each with its reason:

* ``lagged_design``: exact (shifted copies with zero edges);
* weights and predictions: max|d| <= 1e-5 x max|ref| (float32 Gram
  products and solves on both sides: ``Precision.HIGHEST`` there,
  ``fp32_matmul("exact")`` here);
* ``trf_cv``'s held-out r: 1e-5 absolute (float32 correlations on both
  sides); the winning ridge is a decision, held equal where the best mean
  r beats the runner-up by more than 1e-4 (asserted).
"""
import numpy as np
import pytest
import torch

from ninwavelets_tpu.ops import trf as jtrf
from ninwavelets_tpu_torch import convert
from ninwavelets_tpu_torch.ops import trf as ttrf

from test_trf import _planted
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


@pytest.mark.parametrize("lags", [(0, 2, -1), tuple(range(-5, 9)),
                                  (0, 12, -12)])
def test_lagged_design_is_jax_exactly(lags):
    x = np.random.default_rng(0).standard_normal((2, 10)).astype(np.float32)
    np.testing.assert_array_equal(ttrf.lagged_design(_t(x), lags).numpy(),
                                  np.asarray(jtrf.lagged_design(x, lags)))
    np.testing.assert_array_equal(
        ttrf.lagged_design(_t(x[0]), lags).numpy(),
        np.asarray(jtrf.lagged_design(x[0], lags)))


@pytest.mark.parametrize("lam", [1e-2, 1.0])
def test_fit_and_predict_match_jax(lam):
    stim, resp, _ = _planted(n=6000)
    stim2 = np.stack([stim, np.random.default_rng(9).standard_normal(
        6000).astype(np.float32)])
    for s in (stim, stim2):
        ref = jtrf.trf_fit(s, resp, range(-4, 32), lam=lam)
        got = ttrf.trf_fit(_t(s), _t(resp), range(-4, 32), lam=lam)
        _close(got.weights, ref.weights)
        np.testing.assert_array_equal(got.lags, ref.lags)
        assert got.lam == ref.lam
        _close(ttrf.trf_predict(got, _t(s)), jtrf.trf_predict(ref, s))
    with pytest.raises(ValueError):
        ttrf.trf_fit(_t(stim), _t(resp[:, :100]), range(4))
    with pytest.raises(ValueError):
        ttrf.trf_fit(_t(stim), _t(resp), [])


def test_predict_on_a_jax_fit():
    """``convert.trf_result_from_jax``: the JAX package's kernels applied
    by the port predict what the JAX package predicts."""
    stim, resp, kern = _planted(n=6000)
    ref = jtrf.trf_fit(stim, resp, range(0, 40))
    res = convert.trf_result_from_jax(ref, device=CPU)
    assert isinstance(res, ttrf.TRFResult)
    _close(ttrf.trf_predict(res, _t(stim)), jtrf.trf_predict(ref, stim))
    # the planted kernels are recovered
    _close(res.weights[:, 0, :32], kern, 0.05)


def test_cv_matches_jax():
    stim, resp, _ = _planted(n=6000, seed=4)
    lams = (1e-2, 1.0, 10.0)
    res, r, lam = ttrf.trf_cv(_t(stim), _t(resp), range(0, 40), lams=lams,
                              n_folds=4)
    jres, jr, jlam = jtrf.trf_cv(stim, resp, range(0, 40), lams=lams,
                                 n_folds=4)
    assert isinstance(r, np.ndarray)
    assert np.abs(r - jr).max() <= GATE
    # the winning ridge's margin over the runner-up, from the JAX side
    means = []
    for lv in lams:
        _, rr, _ = jtrf.trf_cv(stim, resp, range(0, 40), lams=(lv,),
                               n_folds=4)
        means.append(rr.mean())
    srt = np.sort(means)
    assert srt[-1] - srt[-2] > 1e-4
    assert lam == jlam and res.lam == jres.lam
    _close(res.weights, jres.weights)
    with pytest.raises(ValueError):
        ttrf.trf_cv(_t(stim[:10]), _t(resp[:, :10]), range(4), n_folds=5)
