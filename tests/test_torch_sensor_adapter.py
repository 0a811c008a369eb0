"""The adapter methods of sensor-space preprocessing and decoding against
the JAX package's, on the same small fake epochs and recordings, on
CPU-device adapters: ``EpochsWavelet.decode`` / ``decode_generalization``
/ ``ssvep`` / ``riemann_decode`` / ``regress_out`` / ``drop_bad`` / ``csd``
/ ``interpolate_bads`` / ``csp`` / ``csp_decode`` / ``ged`` / ``ssd`` /
``spatial_epochs`` and ``RawWavelet.interpolate_bads`` /
``find_bad_channels`` / ``ica`` / ``ica_clean`` / ``ica_find_bads`` /
``trf`` / ``asr_clean``.

On the CPU ``single_trial_power_all`` and ``power_all`` take the plain
path, so ``decode``, ``decode_generalization`` and the components'
``power_all`` compare the plain twins of K4 and K1 with the JAX package's
planes; on the card the planes come from the kernels, which
``chip_smoke.py`` holds against the plain path.  ``RawWavelet.ica`` is fed
the JAX package's initial unmixing by swapping the adapter's ``fastica``
for ``_fastica_from_w0``.

Gates, each with its reason:

* derived adapters' data, interpolations, CSD, regression, cleaned
  recordings, eigenvalues, correlations, TRF weights and r: 1e-5 of the
  max (float32 products on both sides);
* filters and patterns: ``tests/test_torch_spatial.py``'s eigenvector
  gate (``ged`` / ``ssd`` on the adapter data: the patterns; the filters
  pass through the whitener of a montage whose EOG channel dominates);
  FastICA: ``tests/test_torch_ica_asr.py``'s 1e-4 for a converged model;
* AUC maps and scalar AUCs / accuracies:
  ``tests/test_torch_riemann_decoding.py``'s near-tie rule, the planes of
  the two CWT pipelines about 1e-6 apart before the fit;
* decisions (bad channels, dropped trials, ICA flags, SSVEP labels, ASR
  keep flags): equal, with ``tests/test_torch_reject_csd.py``'s and
  ``tests/test_torch_ica_asr.py``'s margins;
* return types: host numpy where the JAX package returns numpy, tensors
  where it returns device arrays, new adapters carrying the event codes.
"""
import numpy as np
import pytest
import torch

import ninwavelets_tpu as nw
import ninwavelets_tpu_torch as nt
from ninwavelets_tpu.utils.mne_adapter import ArrayEpochs as JArrayEpochs
from ninwavelets_tpu_torch.ops import ica as tica
from ninwavelets_tpu_torch.ops import riemann as tri
from ninwavelets_tpu_torch.utils import mne_adapter as tad

from test_torch_ica_asr import _jax_w0
from test_torch_reject_csd import _montage, _positions
from test_torch_riemann_decoding import _auc_close, _lda_slack, _near_ties
from test_spatial import _two_class as _csp_classes
from test_torch_spatial import _cols_close
from test_trf import _planted
from torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"
SF = 128.0
GATE = 1e-5
FREQS = np.array([6.0, 9.0, 11.0, 14.0, 20.0])
NAMES = ["Fz", "C3", "Cz", "C4", "Pz", "EOG"]


def _close(got, want, gate=GATE, scale=None):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max() if scale is None else scale
    assert np.abs(got.astype(np.float64) - want).max() <= gate * scale


def _data(e=16, n=256, seed=0):
    """Two classes of epochs (odd trials class 2: an 11 Hz burst on C3 /
    C4 in the middle half), an EOG channel leaking into Fz, one trial with
    a huge transient."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SF
    x = rng.standard_normal((e, len(NAMES), n))
    codes = np.where(np.arange(e) % 2, 2, 1)
    burst = np.sin(2 * np.pi * 11.0 * t) * ((t > 0.5) & (t < 1.5))
    x[codes == 2, 1] += 3.0 * burst
    x[codes == 2, 3] -= 2.0 * burst
    x[:, 5] += 5.0 * np.sin(2 * np.pi * 1.5 * t + rng.uniform(0, 6, (e, 1)))
    x[:, 0] += 0.6 * x[:, 5]
    x[3, 2, 40:70] += 40.0
    return x.astype(np.float32), codes


def _pair(e=16, n=256, seed=0):
    x, codes = _data(e, n, seed)
    ew = nt.EpochsWavelet(nt.ArrayEpochs(x, SF, NAMES),
                          nt.Morse(SF, device=CPU))
    ej = nw.EpochsWavelet(JArrayEpochs(x, SF, NAMES), nw.Morse(SF))
    ew.event_codes = codes
    ej.event_codes = codes
    return ew, ej, x, codes


def _same_adapter(a, b, gate=GATE):
    assert isinstance(a, tad.EpochsWavelet)
    assert list(a.epochs.ch_names) == list(b.epochs.ch_names)
    assert isinstance(a._host_data(), np.ndarray)
    _close(a._host_data(), b._host_data(), gate)
    np.testing.assert_array_equal(a.event_codes, b.event_codes)
    np.testing.assert_array_equal(a.epochs.times, b.epochs.times)


# -- EpochsWavelet ------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(log_power=False, decim=2),
                                dict(baseline=(0.0, 0.3))])
def test_decode_matches_jax(kw):
    ew, ej, _, _ = _pair()
    ga, gb = ew.split()[1], ew.split()[2]
    ja, jb = ej.split()[1], ej.split()[2]
    got = ga.decode(gb, FREQS, **kw)
    want = ja.decode(jb, FREQS, **kw)
    assert isinstance(got, torch.Tensor)
    # the near-tie slack from the port's own planes
    xa = ga.single_trial_power_all(FREQS, decim=kw.get("decim", 1))
    xb = gb.single_trial_power_all(FREQS, decim=kw.get("decim", 1))
    if kw.get("log_power", True):
        xa, xb = torch.log1p(xa), torch.log1p(xb)
    if "baseline" in kw:
        from ninwavelets_tpu_torch.ops.baseline import baseline_tf
        xa = baseline_tf(xa, SF, 0.0, 0.3, "zscore")
        xb = baseline_tf(xb, SF, 0.0, 0.3, "zscore")
    _auc_close(got, want, _lda_slack(xa, xb, 5, 1e-3,
                                     nt.ops.decoding._scores))


def test_decode_generalization_matches_jax():
    ew, ej, _, _ = _pair()
    ga, gb = ew.split()[1], ew.split()[2]
    got = ga.decode_generalization(gb, FREQS, decim=8)
    want = ej.split()[1].decode_generalization(ej.split()[2], FREQS,
                                               decim=8)
    xa = torch.log1p(ga.single_trial_power_all(FREQS, decim=8).mean(-2))
    xb = torch.log1p(gb.single_trial_power_all(FREQS, decim=8).mean(-2))
    _auc_close(got, want, _lda_slack(xa, xb, 5, 1e-3,
                                     lambda x, w: w.T @ x))
    assert got.shape == (32, 32)


def test_ssvep_matches_jax():
    ew, ej, _, _ = _pair()
    labels, rho = ew.ssvep([6.0, 11.0, 15.0])
    jl, jrho = ej.ssvep([6.0, 11.0, 15.0])
    _close(rho, jrho)
    top2 = np.sort(np.asarray(jrho), -1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > 1e-5
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jl))


@pytest.mark.parametrize("method", ["tangent", "mdm"])
def test_riemann_decode_matches_jax(method):
    ew, ej, _, _ = _pair()
    ga, gb = ew.split()[1], ew.split()[2]
    got = ga.riemann_decode(gb, method=method, n_folds=4)
    want = ej.split()[1].riemann_decode(ej.split()[2], method=method,
                                        n_folds=4)
    assert isinstance(got, float)
    ca, cb, nf = tri._decode_setup(ga._all_data(), gb._all_data(), 4, 0.05)
    if method == "tangent":
        sa, sb, tr_a, tr_b = tri._tangent_fold_scores(ca, cb, n_folds=nf,
                                                      n_iter=15, lam=1e-3)
        _auc_close(got, want, _near_ties(sa, sb, tr_a, tr_b))
    else:
        assert abs(got - want) <= 1e-6
    with pytest.raises(ValueError):
        ga.riemann_decode(gb, method="euclid")


def test_regress_out_matches_jax():
    ew, ej, _, _ = _pair()
    got = ew.regress_out(["EOG"])
    _same_adapter(got, ej.regress_out(["EOG"]))
    assert "EOG" not in got.epochs.ch_names
    with pytest.raises(ValueError):
        ew.regress_out(["HEOG"])
    with pytest.raises(ValueError):
        ew.regress_out(NAMES)


@pytest.mark.parametrize("threshold", [None, 20.0])
def test_drop_bad_matches_jax(threshold):
    ew, ej, x, codes = _pair(e=20)
    got = ew.drop_bad(threshold, n_folds=4) if threshold is None \
        else ew.drop_bad(threshold)
    want = ej.drop_bad(threshold, n_folds=4) if threshold is None \
        else ej.drop_bad(threshold)
    _same_adapter(got, want)
    assert got._host_data().shape[0] < x.shape[0]
    if threshold is None:
        assert got.reject_result.threshold == want.reject_result.threshold
        np.testing.assert_array_equal(
            got.reject_result.drop_mask.numpy(),
            np.asarray(want.reject_result.drop_mask))
    else:
        assert got.reject_result is None
    with pytest.raises(ValueError):
        ew.drop_bad(1e-3)


def test_csd_and_interpolate_bads_match_jax():
    ew, ej, _, _ = _pair()
    pos = _positions(len(NAMES))
    _same_adapter(ew.csd(pos), ej.csd(pos))
    _same_adapter(ew.csd(pos, stiffness=3), ej.csd(pos, stiffness=3))
    got = ew.interpolate_bads(pos, ["Cz"])
    _same_adapter(got, ej.interpolate_bads(pos, ["Cz"]))
    with pytest.raises(ValueError):
        ew.csd(pos[:5])
    with pytest.raises(ValueError):
        ew.interpolate_bads(pos, ["T7"])


def _full_spectrum(result_fn):
    return np.asarray(result_fn().eigvals)


@pytest.mark.parametrize("band", [None, (9.0, 13.0)])
def test_csp_and_csp_decode_match_jax(band):
    """On ``tests/test_spatial.py``'s two planted classes."""
    xa, xb, _, _ = _csp_classes(np.random.default_rng(6), 16, 6, 256, SF)
    x = np.concatenate([xa, xb])
    codes = np.repeat([1, 2], 16)
    ew = nt.EpochsWavelet(nt.ArrayEpochs(x, SF), nt.Morse(SF, device=CPU))
    ej = nw.EpochsWavelet(JArrayEpochs(x, SF), nw.Morse(SF))
    kw = {} if band is None else dict(f_lo=band[0], f_hi=band[1])
    got = ew.csp(codes, n_components=2, **kw)
    want = ej.csp(codes, n_components=2, **kw)
    full = _full_spectrum(lambda: ej.csp(codes, n_components=6, **kw))
    _close(got.eigvals, want.eigvals)
    _cols_close(got.filters, want.filters, full, np.array([0, 5]))
    _cols_close(got.patterns, want.patterns, full, np.array([0, 5]))
    auc = float(ew.csp_decode(codes, n_components=2, **kw))
    ta, tb = ew._two_classes(codes)
    if band is not None:
        ta = nt.ops.bandpass(ta, SF, *band)
        tb = nt.ops.bandpass(tb, SF, *band)
    dec = nt.ops.decoding
    filt = dec._fold_ged_jit(dec._fold_covs_jit(ta, n_folds=5),
                             dec._fold_covs_jit(tb, n_folds=5),
                             n_components=2, shrink=0.01)
    sa, sb, tr_a, tr_b = dec._csp_fold_scores(ta, tb, filt, n_folds=5,
                                              lam=1e-3)
    _auc_close(auc, float(ej.csp_decode(codes, n_components=2, **kw)),
               _near_ties(sa, sb, tr_a, tr_b))
    assert auc > 0.9
    with pytest.raises(ValueError):
        ew.csp(codes[:-1])
    with pytest.raises(ValueError):
        ew.csp_decode(np.arange(32) % 3)


def test_ged_and_ssd_match_jax():
    ew, ej, _, _ = _pair()
    got = ew.ged(9.0, 13.0, n_components=2)
    want = ej.ged(9.0, 13.0, n_components=2)
    full = _full_spectrum(lambda: ej.ged(9.0, 13.0))
    _close(got.eigvals, want.eigvals)
    _cols_close(got.patterns[:, :1], want.patterns[:, :1], full,
                np.array([0]))
    got = ew.ssd(9.0, 13.0, n_components=2)
    want = ej.ssd(9.0, 13.0, n_components=2)
    full = _full_spectrum(lambda: ej.ssd(9.0, 13.0))
    _close(got.eigvals, want.eigvals)
    _cols_close(got.patterns[:, :1], want.patterns[:, :1], full,
                np.array([0]))


def test_spatial_epochs_matches_jax():
    ew, ej, _, codes = _pair()
    want_res = ej.csp(codes, n_components=4)
    res = nt.convert.spatial_result_from_jax(want_res, device=CPU)
    got = ew.spatial_epochs(res, n_components=3)
    want = ej.spatial_epochs(want_res, n_components=3)
    _same_adapter(got, want)
    assert got.epochs.ch_names == ["comp0", "comp1", "comp2"]
    _close(got.power_all(FREQS), want.power_all(FREQS))
    # a bare filter matrix works too
    _same_adapter(ew.spatial_epochs(res.filters),
                  ej.spatial_epochs(want_res.filters))


# -- RawWavelet ---------------------------------------------------------------

class FakeRaw:
    def __init__(self, data, sfreq, names=None):
        self._data = data
        self.info = {"sfreq": sfreq}
        self.ch_names = names or [f"EEG {i}" for i in range(data.shape[0])]

    def get_data(self):
        return self._data


def _raws(data, sfreq, names=None):
    return (nt.RawWavelet(FakeRaw(data, sfreq, names),
                          nt.Morse(sfreq, device=CPU)),
            nw.RawWavelet(FakeRaw(data, sfreq, names), nw.Morse(sfreq)))


def test_raw_find_bad_channels_and_interpolate_match_jax():
    x = _montage()
    rw, rj = _raws(x, 250.0)
    got = rw.find_bad_channels()
    assert got == rj.find_bad_channels()
    assert got["bads"] == ["EEG 2", "EEG 5", "EEG 6", "EEG 9"]
    pos = _positions(16)
    out = rw.interpolate_bads(pos, got["bads"])
    assert isinstance(out, np.ndarray)
    _close(out, rj.interpolate_bads(pos, got["bads"]))
    with pytest.raises(ValueError):
        rw.interpolate_bads(pos, ["EEG 99"])


def _blink_raw(n=6000, seed=3):
    """Eight channels of mixed non-Gaussian sources, a blink channel
    (EOG) leaking into the first two."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 250.0
    s = np.stack([np.sign(np.sin(2 * np.pi * 1.3 * t)),
                  2.0 * ((2.1 * t) % 1.0) - 1.0,
                  rng.laplace(size=n),
                  np.sin(2 * np.pi * 10.0 * t) * np.sin(2 * np.pi * 0.2 * t)])
    x = rng.standard_normal((8, 4)) @ s + 0.05 * rng.standard_normal((8, n))
    blink = np.zeros(n)
    for c0 in rng.integers(100, n - 100, 20):
        blink[c0:c0 + 40] += np.hanning(40)
    eog = 8.0 * blink + 0.1 * rng.standard_normal(n)
    x[:2] += 0.5 * eog
    return np.concatenate([x, eog[None]]).astype(np.float32)


def _fed_fastica(x, n_components=None, fun="logcosh", n_iter=200, seed=0,
                 device=None):
    k = x.shape[0] if n_components is None else int(n_components)
    return tica._fastica_from_w0(x, torch.from_numpy(_jax_w0(k, seed)),
                                 n_components=k, fun=fun, n_iter=n_iter)


def test_raw_ica_clean_and_find_bads_match_jax(monkeypatch):
    monkeypatch.setattr(tica, "fastica", _fed_fastica)
    x = _blink_raw()
    names = [f"EEG {i}" for i in range(8)] + ["EOG"]
    rw, rj = _raws(x, 250.0, names)
    picks = names[:8]
    res = rw.ica(n_components=5, picks=picks, seed=2)
    jres = rj.ica(n_components=5, picks=picks, seed=2)
    assert isinstance(res.mixing, torch.Tensor)
    for f in ("unmixing", "mixing", "sources"):
        _close(getattr(res, f), getattr(jres, f), 1e-4)
    bads, scores = rw.ica_find_bads(res, ref="EOG")
    jbads, jscores = rj.ica_find_bads(jres, ref="EOG")
    assert bads == jbads and bads
    _close(scores, jscores, 1e-4)
    kb, _ = rw.ica_find_bads(res)
    assert kb == rj.ica_find_bads(jres)[0]
    out = rw.ica_clean(res, bads, picks=picks)
    assert isinstance(out, np.ndarray)
    _close(out, rj.ica_clean(jres, jbads, picks=picks), 1e-4)
    np.testing.assert_array_equal(out[8], x[8])
    before = abs(np.corrcoef(x[0], x[8])[0, 1])
    after = abs(np.corrcoef(out[0], x[8])[0, 1])
    assert after < 0.5 * before


def test_raw_ica_full_channels_matches_jax(monkeypatch):
    monkeypatch.setattr(tica, "fastica", _fed_fastica)
    x = _blink_raw()[:8]
    rw, rj = _raws(x, 250.0)
    res = rw.ica(n_components=4)
    jres = rj.ica(n_components=4)
    _close(rw.ica_clean(res, [0]), rj.ica_clean(jres, [0]), 1e-4)


def test_raw_trf_matches_jax():
    stim, resp, _ = _planted(n=6000, seed=4)
    rw, rj = _raws(resp, 128.0)
    res, r, lam = rw.trf(stim, tmin_s=0.0, tmax_s=0.3,
                         lams=(1e-2, 1.0, 10.0), n_folds=4)
    jres, jr, jlam = rj.trf(stim, tmin_s=0.0, tmax_s=0.3,
                            lams=(1e-2, 1.0, 10.0), n_folds=4)
    assert lam == jlam
    assert np.abs(r - jr).max() <= GATE
    _close(res.weights, jres.weights)
    np.testing.assert_array_equal(res.lags, jres.lags)
    _, r1, _ = rw.trf(stim, picks=["EEG 1"], lams=(1.0,), n_folds=4)
    assert r1.shape == (1,)


def test_raw_asr_clean_matches_jax():
    """The calibration's directions are kept well apart (distinct channel
    gains), so both packages calibrate the same thresholds; windows within
    1e-4 of a keep decision may differ, as in
    ``tests/test_torch_ica_asr.py``."""
    rng = np.random.default_rng(2)
    n = int(40 * 250)
    x = rng.standard_normal((6, n)) * np.arange(1.0, 7.0)[:, None]
    for s in (3000, 6000, 8000):
        x[:, s:s + 125] += 25.0 * rng.standard_normal((6, 1)) \
            * np.hanning(125)
    x = x.astype(np.float32)
    rw, rj = _raws(x, 250.0)
    got, keep = rw.asr_clean(return_keep=True)
    want, jkeep = rj.asr_clean(return_keep=True)
    assert isinstance(got, np.ndarray) and isinstance(keep, torch.Tensor)
    jkeep = np.asarray(jkeep)
    assert not jkeep.all()
    same = (keep.numpy() == jkeep).all(-1)
    assert same.mean() > 0.9
    hop = 62
    covered = np.ones(n, bool)
    for w in np.flatnonzero(~same):
        covered[max(0, hop * w - hop):max(0, hop * w - hop + 124)] = False
    _close(got[:, covered], np.asarray(want)[:, covered],
           scale=np.abs(x).max())
    np.testing.assert_array_equal(rw.asr_clean(), got)
