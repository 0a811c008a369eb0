"""The adapter methods of the other transforms against the JAX package's on
the same small fake epochs and recordings, on the CPU:
``EpochsWavelet.tfr_power2d`` / ``modwt_var`` / ``modwt_denoise`` and
``RawWavelet.filter`` / ``resample`` / ``modwt_denoise`` / ``modwt_var``.

On the CPU ``EpochsWavelet.power`` takes the plain path, so
``tfr_power2d`` compares the plain twin of K1 "power" with the JAX
package's plane (its fused path on the CPU); on the card the plane comes
from K1, which ``chip_smoke.py`` holds against the plain path.  The
denoised adapter's ``power_all`` / ``itc_all`` likewise.

Gates, each with its reason:

* planes, variances, filtered, resampled and denoised signals, and the
  denoised adapter's power: max|d| <= 1e-5 x max|ref| (the modules'
  gate: float32 FFT pipelines apart in round-off);
* the denoised adapter's ITC: ``tests/test_torch_cwt.py::assert_itc_close``
  (1e-5 on cells where every epoch's |c| is at least 1e-2 of its row
  maximum, 2e-3 elsewhere: the unit phase of a near-zero coefficient is
  round-off);
* return types: the JAX package's host numpy where it returns numpy; a
  tensor where it returns a device array.
"""
import numpy as np
import pytest
import torch

import ninwavelets_tpu as nw
import ninwavelets_tpu_torch as nt
from ninwavelets_tpu.utils.mne_adapter import ArrayEpochs as JArrayEpochs

from test_torch_cwt import assert_itc_close
from test_torch_dwt import _close
from torch_threads import one_torch_thread  # noqa: F401

SFREQ = 250.0
CPU = "cpu"


def _epochs(e=4, c=2, n=300, seed=5):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SFREQ
    data = (np.sin(2 * np.pi * 20 * t)[None, None, :]
            + 0.3 * rng.standard_normal((e, c, n))).astype(np.float32)
    ew = nt.EpochsWavelet(nt.ArrayEpochs(data, SFREQ, ["A", "B"][:c]),
                          nt.Morse(SFREQ, device=CPU))
    ej = nw.EpochsWavelet(JArrayEpochs(data, SFREQ, ["A", "B"][:c]),
                          nw.Morse(SFREQ))
    return ew, ej, data


class FakeRaw:
    def __init__(self, data, sfreq):
        self._data = data
        self.info = {"sfreq": sfreq}
        self.ch_names = [f"EEG {i}" for i in range(data.shape[0])]

    def get_data(self):
        return self._data


def _raw(n=3000, sfreq=500.0, seed=2):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sfreq
    data = np.stack([np.sin(2 * np.pi * 10 * t)
                     + 2 * np.sin(2 * np.pi * 50 * t)
                     + 0.4 * rng.standard_normal(n),
                     np.sin(2 * np.pi * 25 * t) + 0.4 * rng.standard_normal(n),
                     rng.standard_normal(n)]).astype(np.float32)
    rw = nt.RawWavelet(FakeRaw(data, sfreq), nt.Morse(sfreq, device=CPU))
    rj = nw.RawWavelet(FakeRaw(data, sfreq), nw.Morse(sfreq))
    return rw, rj, data


@pytest.mark.parametrize("log_power", [True, False])
def test_tfr_power2d_matches_jax(log_power):
    ew, ej, _ = _epochs()
    freqs = np.arange(5.0, 37.0)
    p, crop = ew.tfr_power2d("A", freqs, log_power=log_power)
    pj, crop_j = ej.tfr_power2d("A", freqs, log_power=log_power)
    assert isinstance(p, torch.Tensor) and crop == crop_j == (32, 300)
    assert p.shape == (4, 6, 32, 512)
    _close(p, pj)


def test_tfr_power2d_of_one_frequency_pads_its_row():
    """One frequency gives a (1, N) plane, which ``pow2_pad2`` reflects to
    (2, N) by repeating the row, as ``jnp.pad`` does."""
    ew, ej, _ = _epochs()
    p, crop = ew.tfr_power2d("B", [20.0], img_freqs=(0.01, 0.02),
                             thetas=[0.0, np.pi / 4])
    pj, crop_j = ej.tfr_power2d("B", [20.0], img_freqs=(0.01, 0.02),
                                thetas=[0.0, np.pi / 4])
    assert crop == crop_j == (1, 300) and p.shape == (2, 2, 2, 512)
    _close(p, pj)
    np.testing.assert_array_equal(p[..., 0, :].numpy(), p[..., 1, :].numpy())


@pytest.mark.parametrize("mean", [True, False])
def test_epochs_modwt_var_matches_jax(mean):
    ew, ej, _ = _epochs(e=6, n=1500)
    v = ew.modwt_var("A", wavelet="db4", mean=mean)
    assert isinstance(v, torch.Tensor)
    _close(v, ej.modwt_var("A", wavelet="db4", mean=mean))
    assert v.shape == ((8,) if mean else (6, 8))


def test_epochs_modwt_denoise_matches_jax_and_composes():
    ew, ej, data = _epochs(e=5, n=300)
    ew.event_codes = np.array([1, 2, 1, 2, 1])
    den = ew.modwt_denoise(wavelet="db8")
    den_j = ej.modwt_denoise(wavelet="db8")
    assert isinstance(den, nt.EpochsWavelet)
    assert den.epochs.ch_names == ["A", "B"] and den.wavelet is ew.wavelet
    _close(den._host_data(), den_j._host_data())
    assert den._host_data().shape == data.shape
    np.testing.assert_array_equal(den.event_codes, ew.event_codes)
    assert set(den.split()) == {1, 2}
    freqs = np.arange(6.0, 40.0, 2.0)
    _close(den.power_all(freqs), den_j.power_all(freqs))
    coeffs = den.cwt_all(freqs).numpy()
    assert_itc_close(den.itc_all(freqs).numpy(),
                     np.asarray(den_j.itc_all(freqs)), coeffs)


@pytest.mark.parametrize("kw", [dict(f_lo=5.0, f_hi=40.0),
                                dict(f_hi=30.0), dict(f_lo=30.0),
                                dict(f_lo=5.0, f_hi=40.0, notch_hz=50.0),
                                dict(notch_hz=[50.0, 100.0]),
                                dict(f_lo=5.0, picks=["EEG 2", "EEG 0"])])
def test_raw_filter_matches_jax(kw):
    rw, rj, _ = _raw()
    y = rw.filter(**kw)
    assert isinstance(y, np.ndarray)
    _close(y, rj.filter(**kw))


def test_raw_filter_kills_the_line():
    rw, _, _ = _raw(n=4096)
    y = rw.filter(f_lo=5.0, f_hi=40.0, notch_hz=50.0)
    line = np.sin(2 * np.pi * 50 * np.arange(4096) / 500.0)
    mid = slice(512, -512)
    assert abs(np.dot(y[0][mid], line[mid])
               / np.dot(line[mid], line[mid])) < 0.05


@pytest.mark.parametrize("new", [125.0, 250.0, 300.0, 1000.0])
def test_raw_resample_matches_jax(new):
    rw, rj, _ = _raw()
    y, sf = rw.resample(new)
    yj, sfj = rj.resample(new)
    assert isinstance(y, np.ndarray) and sf == sfj == new
    _close(y, yj)
    y, _ = rw.resample(new, picks=["EEG 1"])
    _close(y, rj.resample(new, picks=["EEG 1"])[0])


@pytest.mark.parametrize("mode", ["soft", "hard"])
def test_raw_modwt_denoise_and_var_match_jax(mode):
    rw, rj, _ = _raw()
    y = rw.modwt_denoise(wavelet="db8", mode=mode)
    assert isinstance(y, np.ndarray) and y.shape == (3, 3000)
    _close(y, rj.modwt_denoise(wavelet="db8", mode=mode))
    y = rw.modwt_denoise(picks=["EEG 1"], wavelet="db4", level=5,
                         mode=mode)
    _close(y, rj.modwt_denoise(picks=["EEG 1"], wavelet="db4", level=5,
                               mode=mode))
    v = rw.modwt_var("EEG 0", wavelet="db4")
    assert isinstance(v, np.ndarray)
    _close(v, rj.modwt_var("EEG 0", wavelet="db4"))
