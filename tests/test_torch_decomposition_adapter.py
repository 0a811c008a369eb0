"""The adapter methods of the decompositions against the JAX package's on
the same small fake epochs and recordings, on the CPU:
``EpochsWavelet.specparam`` / ``psd`` / ``cycles`` / ``cp_power`` /
``matching_pursuit``, ``RawWavelet.irasa`` / ``psd`` / ``states`` /
``specparam`` and the module's ``_welch_of``.

On the CPU ``power``, ``power_all`` and ``single_trial_power(_all)`` take
the plain path, so these compare the plain twins of K1 and K4 with the
JAX package's planes; on the card the planes come from the kernels, which
``chip_smoke.py`` holds against the plain path.  The draws of
``cp_power`` and ``states`` are the JAX package's, fed in by swapping the
adapter's ``cp_decompose`` / ``hmm_fit`` for ``_cp_from_factors`` /
``_hmm_from_perms`` with the JAX package's initial factors and
permutations.

Gates, each with its reason:

* PSDs and IRASA parts: 1e-5 of the max (float32 FFT pipelines);
* specparam at 50 steps: ``tests/test_torch_specparam.py``'s trajectory
  gate, rtol 2e-5, but 1e-4 here: the spectra come from two CWT
  pipelines, about 1e-6 apart, before the fit;
* cycles: exact (``tests/test_torch_cycles.py``);
* matching pursuit: ``tests/test_torch_mp.py``'s gates;
* ``cp_power``: factors and weights 1e-4 of the max and the fit 1e-4
  absolute (the power tensors differ by about 1e-6 of the max before 30
  sweeps: 1.3e-5 in the fit of the 4-way tensor);
* ``states``: ``tests/test_torch_hmm.py``'s gates (gamma and transitions
  1e-4, means 1e-3, log-likelihood rtol 1e-5, equal paths);
* return types: host numpy where the JAX package returns numpy
  (``SpectralFit``, ``psd``), tensors where it returns device arrays.
"""
import importlib

import numpy as np
import pytest
import torch

import ninwavelets_tpu as nw
import ninwavelets_tpu_torch as nt
from ninwavelets_tpu.utils import mne_adapter as jad
from ninwavelets_tpu.utils.mne_adapter import ArrayEpochs as JArrayEpochs
from ninwavelets_tpu_torch.utils import mne_adapter as tad

from test_torch_cpd import _jax_factors
from test_torch_hmm import _jax_perms
from torch_threads import one_torch_thread  # noqa: F401

tc = importlib.import_module("ninwavelets_tpu_torch.ops.cpd")
th = importlib.import_module("ninwavelets_tpu_torch.ops.hmm")

SFREQ = 250.0
CPU = "cpu"


def _close(got, want, gate=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got.astype(np.float64) - want).max() <= gate * np.abs(
        want).max()


def _epochs(e=4, c=2, n=512, seed=5):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SFREQ
    data = (np.sin(2 * np.pi * 10 * t)[None, None, :]
            + 0.3 * rng.standard_normal((e, c, n))).astype(np.float32)
    names = ["A", "B"][:c]
    return (nt.EpochsWavelet(nt.ArrayEpochs(data, SFREQ, names),
                             nt.Morse(SFREQ, device=CPU)),
            nw.EpochsWavelet(JArrayEpochs(data, SFREQ, names),
                             nw.Morse(SFREQ)))


class FakeRaw:
    def __init__(self, data, sfreq):
        self._data = data
        self.info = {"sfreq": sfreq}
        self.ch_names = [f"EEG {i}" for i in range(data.shape[0])]

    def get_data(self):
        return self._data


def _raw(n=6000, seed=2):
    """Three channels whose rhythm switches between 10 and 25 Hz every 4 s
    (the HMM's states), with a 1/f-ish background."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SFREQ
    regime = (t // 4.0).astype(int) % 2
    sig = np.where(regime, np.sin(2 * np.pi * 25 * t),
                   np.sin(2 * np.pi * 10 * t))
    walk = np.cumsum(rng.standard_normal((3, n)), -1) * 0.02
    data = (sig[None] + walk + 0.3 * rng.standard_normal((3, n))).astype(
        np.float32)
    return (nt.RawWavelet(FakeRaw(data, SFREQ), nt.Morse(SFREQ, device=CPU)),
            nw.RawWavelet(FakeRaw(data, SFREQ), nw.Morse(SFREQ)))


@pytest.mark.parametrize("kw", [dict(picks=None, band=None),
                                dict(picks=["B"], band=(2.0, 40.0)),
                                dict(epoch_mean=True, picks=None,
                                     band=(5.0, 30.0))])
def test_welch_of_matches_jax(kw):
    data = np.random.default_rng(0).standard_normal((3, 2, 700)).astype(
        np.float32)
    f, p = tad._welch_of(data, ["A", "B"], SFREQ, nperseg=1024,
                         device=CPU, **kw)
    jf, jp = jad._welch_of(data, ["A", "B"], SFREQ, nperseg=1024, **kw)
    np.testing.assert_array_equal(f, jf)
    assert isinstance(p, np.ndarray)
    _close(p, jp)
    with pytest.raises(ValueError):
        tad._welch_of(data[..., :3], ["A", "B"], SFREQ, None, 1024, None,
                      device=CPU)


@pytest.mark.parametrize("average", [True, False])
def test_epochs_psd_matches_jax(average):
    ew, ej = _epochs()
    f, p = ew.psd(nperseg=256, band=(1.0, 40.0), average=average)
    jf, jp = ej.psd(nperseg=256, band=(1.0, 40.0), average=average)
    np.testing.assert_array_equal(f, jf)
    _close(p, jp)


def test_epochs_specparam_matches_jax():
    ew, ej = _epochs()
    freqs = np.arange(2.0, 40.0)
    got = ew.specparam("A", freqs, n_steps=50)
    want = ej.specparam("A", freqs, n_steps=50)
    for name in got._fields:
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert isinstance(g, np.ndarray)
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * np.abs(
            w).max(), err_msg=name)


def test_epochs_cycles_matches_jax():
    ew, ej = _epochs(n=1024)
    got = ew.cycles("B", (6.0, 15.0), min_n_cycles=2)
    want = ej.cycles("B", (6.0, 15.0), min_n_cycles=2)
    for name, a, b in zip(got._fields, got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)


def test_epochs_matching_pursuit_matches_jax():
    ew, ej = _epochs()
    got = ew.matching_pursuit("A", n_atoms=4)
    want = ej.matching_pursuit("A", n_atoms=4)
    for f in ("scale_s", "freq_hz"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    np.testing.assert_array_equal(np.round(got.time_s.numpy() * SFREQ),
                                  np.round(np.asarray(want.time_s) * SFREQ))
    for f in ("amplitude", "energy", "residual"):
        _close(getattr(got, f), getattr(want, f), 1e-4)


def _cp_fed_jax(x, rank, n_iter=100, nonneg=False, seed=0):
    f0 = [torch.from_numpy(f) for f in _jax_factors(tuple(x.shape), rank,
                                                     seed, nonneg)]
    return tc._cp_from_factors(x, f0, n_iter=n_iter, nonneg=nonneg,
                               ridge=1e-6)


@pytest.mark.parametrize("kw", [dict(tensor="cfn"),
                                dict(tensor="efn", ch_name="B"),
                                dict(tensor="ecfn", decim=4),
                                dict(tensor="cfn", baseline=(0.0, 0.5),
                                     nonneg=False)])
def test_cp_power_matches_jax(monkeypatch, kw):
    monkeypatch.setattr(tad, "cp_decompose", _cp_fed_jax)
    ew, ej = _epochs()
    freqs = np.arange(6.0, 30.0, 2.0)
    w, facs, fit = ew.cp_power(freqs, 2, n_iter=30, **kw)
    jw, jf, jfit = ej.cp_power(freqs, 2, n_iter=30, **kw)
    assert isinstance(w, torch.Tensor)
    _close(w, jw, 1e-4)
    for a, b in zip(facs, jf):
        _close(a, b, 1e-4)
    assert abs(float(fit) - float(jfit)) <= 1e-4


def test_cp_power_validation():
    ew, _ = _epochs()
    for kw in (dict(nonneg=True, baseline=(0.0, 0.5)), dict(tensor="efn"),
               dict(tensor="bogus")):
        with pytest.raises(ValueError):
            ew.cp_power([10.0, 20.0], 2, **kw)


def test_raw_irasa_and_psd_match_jax():
    rw, rj = _raw()
    got = rw.irasa(band=(2.0, 40.0), nperseg=512)
    want = rj.irasa(band=(2.0, 40.0), nperseg=512)
    assert isinstance(got.psd, torch.Tensor)
    scale = np.abs(np.asarray(want.psd)).max()
    for f in ("psd", "fractal", "oscillatory"):
        assert np.abs(getattr(got, f).numpy() - np.asarray(
            getattr(want, f))).max() <= 1e-5 * scale
    got = rw.irasa(picks=["EEG 2"], hset=(1.2, 1.5), nperseg=256)
    want = rj.irasa(picks=["EEG 2"], hset=(1.2, 1.5), nperseg=256)
    _close(got.fractal, want.fractal)
    for kw in (dict(), dict(picks=["EEG 1", "EEG 0"], band=(5.0, 30.0),
                            nperseg=300)):
        f, p = rw.psd(**kw)
        jf, jp = rj.psd(**kw)
        np.testing.assert_array_equal(f, jf)
        _close(p, jp)


def test_raw_specparam_matches_jax():
    rw, rj = _raw()
    freqs = np.arange(2.0, 40.0, 2.0)
    got = rw.specparam(freqs, n_steps=50)
    want = rj.specparam(freqs, n_steps=50)
    assert got.exponent.shape == (3,)
    for name in got._fields:
        w = np.asarray(getattr(want, name))
        np.testing.assert_allclose(getattr(got, name), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)


def _hmm_fed_jax(features, n_states, n_iter=50, stickiness=0.9, seed=0):
    x = features[None]
    res = th._hmm_from_perms(x, _jax_perms(x.shape[1], seed, 1),
                             n_states=n_states, n_iter=n_iter,
                             stickiness=stickiness)
    return res._replace(gamma=res.gamma[0], states=res.states[0])


def test_raw_states_matches_jax(monkeypatch):
    monkeypatch.setattr(tad, "hmm_fit", _hmm_fed_jax)
    rw, rj = _raw()
    bands = ((8.0, 13.0), (20.0, 30.0))
    got = rw.states(n_states=2, bands=bands, n_iter=20)
    want = rj.states(n_states=2, bands=bands, n_iter=20)
    np.testing.assert_allclose(got.gamma.numpy(), np.asarray(want.gamma),
                               atol=1e-4)
    np.testing.assert_allclose(got.transition.numpy(),
                               np.asarray(want.transition), atol=1e-4)
    np.testing.assert_allclose(got.means.numpy(), np.asarray(want.means),
                               atol=1e-3)
    np.testing.assert_allclose(got.loglik.numpy(), np.asarray(want.loglik),
                               rtol=1e-5)
    np.testing.assert_array_equal(got.states.numpy(),
                                  np.asarray(want.states))
    assert got.states.shape == (6000 // 12,)


def test_raw_states_with_own_draws_finds_the_regimes():
    rw, _ = _raw()
    res = rw.states(n_states=2, bands=((8.0, 13.0), (20.0, 30.0)),
                    n_iter=30)
    t = np.arange(res.states.shape[0]) * 12 / SFREQ
    truth = (t // 4.0).astype(int) % 2
    acc = max(np.mean(res.states.numpy() == truth),
              np.mean(res.states.numpy() == 1 - truth))
    assert acc > 0.85
