"""The port's FastICA (``ninwavelets_tpu_torch.ops.ica``) and artifact
subspace reconstruction (``ops.asr``) against the JAX package, on the CPU,
on ``tests/test_ica.py``'s and ``tests/test_asr.py``'s planted sources and
recordings.

Gates, each with its reason:

* FastICA fed the JAX package's initial unmixing (its ``jax.random``
  draw, through ``_fastica_from_w0``): the converged model, after the
  order and sign conventions, max|d| <= 1e-4 x max|ref|.  The whitening
  eigenvectors carry no sign convention, so the two packages reach the
  same fixed point along different paths; each stops within its last
  step's convergence (asserted below 1e-5) of it, on sources well apart in
  non-Gaussianity.  The trajectory is not compared step by step.
* products of a given model in float32 on both sides (``ica_transform``,
  ``ica_remove``, scores, kurtosis; ASR calibration): 1e-5 of the max
  (``Precision.HIGHEST`` there, ``fp32_matmul("exact")`` here);
* ``ica_find_bads``: equal indices where every robust z is farther than
  0.05 from the threshold (asserted);
* ASR processing: equal keep flags on every window whose eigenvalues are
  all farther from their limits than 1e-4 (a discrete decision; such
  windows asserted to be over 90%), and the output within 1e-5 of max|x|
  on the samples only agreeing windows cover (the reconstruction of an
  artifact window is R @ frame, whose round-off scales with the frame,
  not with the cleaned output);
* the overlap-add: exact against a float64 scatter-add of the same
  frames rounded once (every output sample sums at most two frames here);
  groups of three windows (win 125, hop 62) to 1 ulp.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ninwavelets_tpu.ops import asr as jasr
from ninwavelets_tpu.ops import ica as jica
from ninwavelets_tpu_torch import convert
from ninwavelets_tpu_torch.ops import asr as tasr
from ninwavelets_tpu_torch.ops import ica as tica

from test_asr import SFREQ, _recording
from test_ica import _match_corr, _mix, _sources
from torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"
GATE = 1e-5
ICA_GATE = 1e-4


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want, gate=GATE, scale=None):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max() if scale is None else scale
    assert np.abs(got.astype(np.float64) - want).max() <= gate * scale


def _jax_w0(k, seed):
    """The JAX package's initial unmixing draw (``_fastica_jit``)."""
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (k, k),
                                        jnp.float32))


def _blinky():
    """Six channels of the mixed sources plus a blink channel (EOG) that
    leaks into them: ``tests/test_ica.py``'s artifact setup, small."""
    s = _sources()
    x, _ = _mix(s)
    rng = np.random.default_rng(5)
    blink = np.zeros(s.shape[1])
    for c0 in rng.integers(100, s.shape[1] - 100, 25):
        blink[c0:c0 + 40] += np.hanning(40)
    x = np.concatenate([x, x[:2] * 0.5]) + 4.0 * blink * rng.uniform(
        0.5, 1.0, (6, 1))
    eog = 10.0 * blink + 0.1 * rng.standard_normal(s.shape[1])
    return x.astype(np.float32), eog.astype(np.float32)


@pytest.mark.parametrize("fun", ["logcosh", "exp", "cube"])
def test_fastica_fed_w0_matches_jax(fun):
    x, _ = _mix(_sources())
    ref = jica.fastica(x, fun=fun, n_iter=200, seed=1)
    got = tica._fastica_from_w0(_t(x), _t(_jax_w0(4, 1)), fun=fun,
                                n_iter=200)
    assert float(np.asarray(ref.convergence)[-1]) < 1e-5
    assert float(got.convergence[-1]) < 1e-5
    for f in ("unmixing", "mixing", "sources"):
        _close(getattr(got, f), getattr(ref, f), ICA_GATE)
    # the channel means of zero-mean sources are round-off: held at the
    # gate of the data
    _close(got.mean, ref.mean, GATE, np.abs(x).max())
    assert got.convergence.shape == (200,)


def test_fastica_generator_separates_and_is_deterministic():
    s = _sources()
    x, _ = _mix(s)
    a = tica.fastica(_t(x), n_iter=200, seed=3, device=CPU)
    b = tica.fastica(x, n_iter=200, seed=3, device=CPU)
    for f in a._fields:
        np.testing.assert_array_equal(getattr(a, f).numpy(),
                                      getattr(b, f).numpy())
    assert _match_corr(a.sources.numpy(), s).min() > 0.99
    # the same fixed point as the JAX package's own draw
    ref = jica.fastica(x, n_iter=200, seed=0)
    _close(a.mixing, ref.mixing, ICA_GATE)


def test_fastica_partial_components_and_validation():
    x, _ = _blinky()
    ref = jica.fastica(x, 4, n_iter=200, seed=2)
    got = tica._fastica_from_w0(_t(x), _t(_jax_w0(4, 2)), n_components=4,
                                n_iter=200)
    for f in ("unmixing", "mixing", "sources"):
        _close(getattr(got, f), getattr(ref, f), ICA_GATE)
    for bad in (dict(n_components=0), dict(n_components=9),
                dict(fun="tanh")):
        with pytest.raises(ValueError):
            tica.fastica(_t(x), **bad)
    with pytest.raises(ValueError):
        tica.fastica(_t(x[:, :4]))


def test_model_functions_match_jax_on_a_jax_fit():
    """``convert.ica_result_from_jax``: the JAX package's model applied by
    the port gives the JAX package's transform, removal, scores and
    flags."""
    x, eog = _blinky()
    ref = jica.fastica(x, n_iter=200, seed=0)
    res = convert.ica_result_from_jax(ref, device=CPU)
    assert isinstance(res, tica.ICAResult)
    _close(tica.ica_transform(_t(x), res), jica.ica_transform(x, ref))
    for exclude in ([], [0], [1, 3]):
        _close(tica.ica_remove(_t(x), res, exclude),
               jica.ica_remove(x, ref, exclude))
    _close(tica.ica_scores(res, _t(eog)), jica.ica_scores(ref, eog))
    _close(tica.ica_kurtosis(res), jica.ica_kurtosis(ref))
    for ref_trace, measure, thr in ((eog, "zscore", 3.0),
                                    (None, "zscore", 3.0),
                                    (eog, "absolute", 0.5)):
        bads, scores = tica.ica_find_bads(
            res, None if ref_trace is None else _t(ref_trace), thr, measure)
        jb, js = jica.ica_find_bads(ref, ref_trace, thr, measure)
        assert bads == jb
        _close(scores, js)
        if measure == "zscore":
            med = np.median(js)
            z = (js - med) / max(np.median(np.abs(js - med)) * 1.4826, 1e-12)
            assert np.abs(z - thr).min() > 0.05
    assert jb, "the blink component must be flagged"
    with pytest.raises(ValueError):
        tica.ica_remove(_t(x), res, [8])
    with pytest.raises(ValueError):
        tica.ica_transform(_t(x[:5]), res)
    with pytest.raises(ValueError):
        tica.ica_find_bads(res, _t(eog), measure="other")


def test_shared_private_names():
    """The names the JAX package's sharded FastICA imports."""
    for name in ("_whiten_from_cov", "_ica_step", "_finalize_components",
                 "_sym_decorrelate"):
        assert callable(getattr(tica, name))


def _asr_case():
    x, clean, mask = _recording(n_s=40)
    return x, clean, mask, clean[:, :int(20 * SFREQ)]


def test_asr_calibrate_matches_jax():
    """The mixing (a matrix square root) at 1e-5; each direction's
    threshold at 1e-5 of the largest plus the eigenvector gate of its
    direction, 1e-6 x ||cov|| / gap (the calibration's noise directions are
    nearly degenerate: their basis, and so their window RMS, is round-off
    between LAPACK builds)."""
    _, _, _, cal = _asr_case()
    c = cal.astype(np.float64) - cal.mean(-1, keepdims=True)
    d = np.linalg.eigvalsh(c @ c.T / c.shape[1])
    gap = np.abs(d[:, None] - d[None, :] + np.diag(np.full(d.size, np.inf))
                 ).min(1)
    for cutoff, win_s in ((5.0, 0.5), (3.0, 0.3)):
        ref = jasr.asr_calibrate(cal, SFREQ, cutoff=cutoff, win_s=win_s)
        got = tasr.asr_calibrate(_t(cal), SFREQ, cutoff=cutoff, win_s=win_s)
        _close(got.mixing, ref.mixing)
        th = np.asarray(ref.thresholds)
        gate = (GATE + 1e-6 * d.max() / gap) * th.max()
        assert (np.abs(got.thresholds.numpy() - th) <= gate).all()
    with pytest.raises(ValueError):
        tasr.asr_calibrate(_t(cal[:, :100]), SFREQ)
    with pytest.raises(ValueError):
        tasr.asr_calibrate(_t(cal[0]), SFREQ)


def _keep_margin(x, model, win):
    """(W,) each window's smallest relative distance between an eigenvalue
    and its limit (the keep test's margin), in float64 from the JAX
    model."""
    x = np.asarray(x, np.float64)
    x = x - x.mean(-1, keepdims=True)
    hop = win // 2
    xp = np.pad(x, ((0, 0), (hop, win)))
    w = (xp.shape[-1] - win) // hop + 1
    idx = np.arange(win)[None, :] + hop * np.arange(w)[:, None]
    fr = xp[:, idx].transpose(1, 0, 2)
    hann = 0.5 - 0.5 * np.cos(2 * np.pi * (np.arange(win) + 0.5) / win)
    frw = fr * hann
    cov = np.einsum("wct,wdt->wcd", frw, frw) / np.sum(hann * hann)
    dw, vw = np.linalg.eigh(cov)
    v_cal = np.asarray(model.v_cal, np.float64)
    th = np.asarray(model.thresholds, np.float64)
    limit = np.einsum("c,wcj->wj", th ** 2,
                      np.einsum("ic,wij->wcj", v_cal, vw) ** 2)
    return (np.abs(dw - limit) / np.abs(limit)).min(-1)


def test_asr_process_matches_jax_on_a_jax_model():
    """``convert.asr_model_from_jax``: the JAX package's calibration
    applied by the port cleans as the JAX package cleans.  Windows whose
    keep test is within 1e-4 of its limit may decide either way; all
    others must agree (at least 90% of them here), and the output is held
    on the samples that only agreeing windows cover."""
    x, clean, mask, cal = _asr_case()
    ref_model = jasr.asr_calibrate(cal, SFREQ)
    model = convert.asr_model_from_jax(ref_model, device=CPU)
    assert isinstance(model, tasr.ASRModel)
    want, want_keep = jasr.asr_process(x, SFREQ, ref_model)
    got, keep = tasr.asr_process(_t(x), SFREQ, model)
    want_keep = np.asarray(want_keep)
    sound = _keep_margin(x, ref_model, 124) > 1e-4
    assert sound.mean() > 0.9
    np.testing.assert_array_equal(keep.numpy()[sound], want_keep[sound])
    assert not want_keep.all() and want_keep.any()
    same = (keep.numpy() == want_keep).all(-1)
    hop, n = 62, x.shape[-1]
    covered = np.ones(n, bool)
    for w in np.flatnonzero(~same):         # padded start at -hop
        covered[max(0, hop * w - hop):max(0, hop * w - hop + 124)] = False
    _close(got.numpy()[:, covered], np.asarray(want)[:, covered],
           scale=np.abs(x).max())
    # the port's own calibration cleans the artifacts as well
    # (``tests/test_asr.py``'s gate)
    own, _ = tasr.asr_process(_t(x), SFREQ, tasr.asr_calibrate(_t(cal),
                                                              SFREQ))
    err = np.abs(own.numpy() - clean)[:, mask].mean()
    assert err < 0.25 * np.abs(x - clean)[:, mask].mean()
    with pytest.raises(ValueError):
        tasr.asr_process(_t(x[:3]), SFREQ, model)


@pytest.mark.parametrize("win,hop", [(124, 62), (8, 4), (125, 62)])
def test_overlap_add_is_the_scatter_add(win, hop):
    rng = np.random.default_rng(7)
    w, c = 13, 3
    fr = rng.standard_normal((w, c, win)).astype(np.float32)
    length = hop * (w - 1) + win
    got = tasr._overlap_add(_t(fr), hop, length).numpy()
    idx = (np.arange(win)[None, :] + hop * np.arange(w)[:, None]).ravel()
    want = np.zeros((c, length))
    np.add.at(want, (slice(None), idx),
              fr.transpose(1, 0, 2).reshape(c, -1).astype(np.float64))
    if win <= 2 * hop:
        np.testing.assert_array_equal(got, want.astype(np.float32))
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2.5e-7 * np.abs(want).max())
    # the same frames added twice give the same bits (no atomics)
    np.testing.assert_array_equal(got, tasr._overlap_add(
        _t(fr), hop, length).numpy())
