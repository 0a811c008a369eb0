"""The adapter methods of the last slice against the JAX package's, on the
same small fake epochs and recordings, on CPU-device adapters:
``EpochsWavelet.evoked`` / ``_event_window`` / ``erp_peak`` / ``erp_onset``
/ ``sample_entropy`` / ``permutation_entropy`` / ``multiscale_entropy`` /
``fit_dipole`` and ``RawWavelet.dfa`` / ``spindles`` /
``slow_oscillations`` / ``microstates``.

On the CPU ``RawWavelet.power_channel`` takes the plain path, so ``dfa``
compares the plain twin of K4 with the JAX package's plane; on the card
the envelope comes from the kernel, which ``chip_smoke.py`` holds against
the plain path.  ``microstates`` is fed the JAX package's seed samples by
swapping the module's ``microstate_fit`` for ``_fit_from_idx``.

Gates, each with its reason:

* waveforms, amplitudes, entropies and DFA: 1e-5 of the max (float32
  on both sides; the DFA envelopes come from two CWT pipelines about 1e-6
  apart);
* latencies, onsets, event tables and labels: exact (the planted
  components and events clear their criteria by far more than
  round-off);
* the dipole fit: ``tests/test_torch_leadfield_beamformer.py``'s gates;
* microstate maps up to sign at 1e-5 (the planted maps' scatter gaps are
  large), GEV 1e-5, statistics 1e-6;
* return types: tensors where the JAX package returns device arrays, a
  dict of host values from ``fit_dipole``, host numpy statistics.
"""
import numpy as np
import pytest
import torch

import ninwavelets_tpu as nw
import ninwavelets_tpu_torch as nt
from ninwavelets_tpu.ops.leadfield import fibonacci_electrodes, \
    sphere_leadfield
from ninwavelets_tpu.utils.mne_adapter import ArrayEpochs as JArrayEpochs
from ninwavelets_tpu_torch.ops import microstates as tm

from test_microstates import _planted
from test_sleep import SFREQ as SLEEP_SF, _so_signal, _spindle_signal
from test_torch_leadfield_beamformer import _same_fit
from test_torch_sleep_microstates import _jax_idx, _same_table

CPU = "cpu"
SF = 1000.0
GATE = 1e-5


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, gate=GATE):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got.astype(np.float64) - want).max() <= gate * max(
        np.abs(want).max(), 1e-30)


def _erp_epochs(times=True, e=16, n=600, seed=2):
    """A positive component on channel 0 and a negative one on channel 1,
    both at 300 samples, in noisy trials; with ``times`` the epochs start
    at -0.1 s."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    w = 5.0 * np.exp(-0.5 * ((t - 300) / 30.0) ** 2)
    data = np.stack([np.stack([w + 0.3 * rng.standard_normal(n),
                               -w + 0.3 * rng.standard_normal(n),
                               rng.standard_normal(n)])
                     for _ in range(e)]).astype(np.float32)
    tt = (np.arange(n) / SF - 0.1) if times else None
    tw = nt.EpochsWavelet(nt.ArrayEpochs(data, SF, times=tt),
                          nt.Morse(SF, device=CPU))
    jw = nw.EpochsWavelet(JArrayEpochs(data, SF, times=tt), nw.Morse(SF))
    if not times:
        del tw.epochs.times, jw.epochs.times
    return tw, jw


@pytest.mark.parametrize("times", [True, False])
def test_erp_adapters_match_jax(times):
    tw, jw = _erp_epochs(times)
    ev = tw.evoked()
    assert isinstance(ev, torch.Tensor) and ev.device.type == "cpu"
    _close(ev, jw.evoked())
    for window in (None, (0.1, 0.3), (0.15, 0.45)):
        assert tw._event_window(window) == jw._event_window(window)
        for pol in (1, -1):
            got, ref = tw.erp_peak(window, pol), jw.erp_peak(window, pol)
            np.testing.assert_array_equal(got.latency.numpy(), ref.latency)
            _close(got.amplitude, ref.amplitude)
    for pol in (1, -1):
        got = tw.erp_onset((0.15, 0.45), polarity=pol)
        ref = jw.erp_onset((0.15, 0.45), polarity=pol)
        np.testing.assert_array_equal(got[0][:, :2].numpy(),
                                      np.asarray(ref[0])[:, :2])
        _close(got[1][:2], np.asarray(ref[1])[:2])
        _close(got[2][:2], np.asarray(ref[2])[:2])
    if times:          # the epochs start at -0.1 s: 0.2 s is sample 300
        assert int(tw.erp_peak((0.15, 0.25)).latency[0]) in range(290, 311)


def test_entropy_adapters_match_jax():
    rng = np.random.default_rng(13)
    t = np.arange(512) / SF
    data = np.stack([np.stack([np.sin(2 * np.pi * 10 * t)
                               + 0.01 * rng.standard_normal(512),
                               rng.standard_normal(512)])
                     for _ in range(3)]).astype(np.float32)
    tw = nt.EpochsWavelet(nt.ArrayEpochs(data, SF), nt.Morse(SF, device=CPU))
    jw = nw.EpochsWavelet(JArrayEpochs(data, SF), nw.Morse(SF))
    se = tw.sample_entropy()
    _close(se, jw.sample_entropy())
    pe = tw.permutation_entropy(m=4)
    _close(pe, jw.permutation_entropy(m=4))
    _close(tw.multiscale_entropy(scales=3), jw.multiscale_entropy(scales=3))
    assert torch.all(se[:, 0] < se[:, 1]) and torch.all(pe[:, 0] < pe[:, 1])


def test_fit_dipole_adapter_matches_jax():
    elec = fibonacci_electrodes(16, 0.09)
    lf = np.asarray(sphere_leadfield(elec, np.array([[0.02, 0.01, 0.05]])))
    topo = lf[:, 0, :] @ np.array([1.0, 2.0, -1.0]) * 1e-8
    t = np.arange(200)
    wave = np.exp(-0.5 * ((t - 100) / 15.0) ** 2)
    rng = np.random.default_rng(3)
    data = (topo[None, :, None] * wave[None, None, :]
            + 1e-3 * topo.std() * rng.standard_normal((6, 16, 200))
            ).astype(np.float32)
    tw = nt.EpochsWavelet(nt.ArrayEpochs(data, SF), nt.Morse(SF, device=CPU))
    jw = nw.EpochsWavelet(JArrayEpochs(data, SF), nw.Morse(SF))
    kw = dict(spacing=0.02, n_terms=60, n_steps=40)
    got = tw.fit_dipole(elec, **kw)
    ref = jw.fit_dipole(elec, **kw)
    _same_fit(got, ref)
    assert got["peak_sample"] == ref["peak_sample"] == 100
    with pytest.raises(ValueError):
        tw.fit_dipole(elec[:5])


class FakeRaw:
    def __init__(self, data, sfreq):
        self._data = data
        self.info = {"sfreq": sfreq}
        self.ch_names = [f"EEG {i:03d}" for i in range(data.shape[0])]

    def get_data(self):
        return self._data


def _raws(data, sfreq, **kw):
    return (nt.RawWavelet(FakeRaw(data, sfreq), nt.Morse(sfreq, device=CPU),
                          **kw),
            nw.RawWavelet(FakeRaw(data, sfreq), nw.Morse(sfreq), **kw))


def test_raw_dfa_matches_jax():
    rng = np.random.default_rng(14)
    n = 16384
    t = np.arange(n) / 250.0
    env = np.cumsum(rng.standard_normal(n))
    env = 1.0 + 0.8 * (env - env.min()) / (env.max() - env.min())
    x = np.stack([env * np.sin(2 * np.pi * 10 * t),
                  np.abs(rng.standard_normal(n)) * np.sin(
                      2 * np.pi * 10 * t)]).astype(np.float32)
    tr, jr = _raws(x, 250.0, window=4096)
    for ch in ("EEG 000", "EEG 001"):
        got, ref = tr.dfa(ch, 10.0), jr.dfa(ch, 10.0)
        _close(got[0], ref[0])
        _close(got[1], ref[1])
    got = tr.dfa("EEG 000", 10.0, scales=(8, 16, 32, 64), decim=2)
    _close(got[0], jr.dfa("EEG 000", 10.0, scales=(8, 16, 32, 64),
                          decim=2)[0])


def test_raw_sleep_adapters_match_jax():
    x0, _ = _spindle_signal(seed=5)
    so, _ = _so_signal(n_s=60, events=(20.0, 40.0), seed=6)
    data = np.stack([x0, so])
    tr, jr = _raws(data, SLEEP_SF)
    sp = tr.spindles(kmax=128)
    _same_table(sp, jr.spindles(kmax=128))
    assert int(sp.valid[0].sum()) == 3
    so_tab = tr.slow_oscillations(kmax=1024)
    _same_table(so_tab, jr.slow_oscillations(kmax=1024))
    assert int(so_tab.valid[1].sum()) == 2
    picked = tr.spindles(picks=["EEG 001", "EEG 000"], kmax=128)
    assert torch.equal(picked.start[1], sp.start[0])


def test_raw_microstates_match_jax(monkeypatch):
    x, _, _ = _planted(c=12, t=1200, seed=4)
    tr, jr = _raws(x, 250.0)
    idx = _jax_idx(x, 4, 3, 0)

    def fit_from_jax_draws(data, n_states, *, peaks_only, n_init, n_iter,
                           seed):
        return tm._fit_from_idx(data, idx, n_states=n_states,
                                peaks_only=peaks_only, n_iter=n_iter)

    monkeypatch.setattr(tm, "microstate_fit", fit_from_jax_draws)
    res, stats = tr.microstates(n_init=3, n_iter=6)
    ref, rstats = jr.microstates(n_init=3, n_iter=6)
    np.testing.assert_array_equal(res.labels.numpy(), np.asarray(ref.labels))
    sign = np.sign(np.sum(res.maps.numpy() * np.asarray(ref.maps), -1))
    _close(sign[:, None] * res.maps.numpy(), ref.maps)
    _close(res.gev, ref.gev)
    for k in rstats:
        assert isinstance(stats[k], np.ndarray)
        _close(stats[k], rstats[k], 1e-6)
