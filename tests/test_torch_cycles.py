"""The port's cycle-by-cycle features (``ninwavelets_tpu_torch.ops.cycles``)
against the JAX package on the same seeded signals, on the CPU, and
against ``tests/test_cycles.py``'s loop oracle.

Gates, each with its reason:

* the bandpassed trace: max|d| <= 1e-5 x max|ref| (two float32 FFT round
  trips of the reflect-padded row; about 1e-7 in practice);
* the cycle counts, burst flags and every per-cycle feature: exact.  The
  features are integer sample positions and the raw signal's own samples
  turned into seconds, ratios and fractions by the same float32
  operations; what could move them is a zero crossing of the bandpassed
  trace that sits within round-off of zero, and
  ``test_crossings_are_the_same`` checks that the two traces have the
  same signs on these signals;
* validation: the JAX package's exception type.
"""
import importlib

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401

jcy = importlib.import_module("ninwavelets_tpu.ops.cycles")
tcy = importlib.import_module("ninwavelets_tpu_torch.ops.cycles")

from test_cycles import SFREQ, T, _oracle, _sig

CPU = "cpu"


def _signals():
    rng = np.random.default_rng(3)
    saw = 2 * (8.0 * T % 1.0) - 1.0
    gate = (np.sin(2 * np.pi * 0.5 * T) > 0.3)
    return {
        "harmonic": (_sig(np.sin(2 * np.pi * 8.0 * T)
                          + 0.3 * np.sin(2 * np.pi * 16.0 * T + 1.0),
                          noise=0.02), (5.0, 12.0)),
        "sawtooth": (_sig(saw, noise=0.01), (5.0, 12.0)),
        "gated_batch": (np.stack([
            _sig(gate * np.sin(2 * np.pi * 10.0 * T), noise=0.05, seed=s)
            for s in range(3)]), (7.0, 14.0)),
        "noise": (rng.standard_normal((2, 2, 1500)).astype(np.float32),
                  (8.0, 20.0)),
    }


CASES = sorted(_signals())


@pytest.mark.parametrize("case", CASES)
def test_bandpass_matches_jax(case):
    x, (lo, hi) = _signals()[case]
    flat = x.reshape(-1, x.shape[-1])
    got = tcy._bandpass(torch.from_numpy(flat), SFREQ, lo, hi).numpy()
    want = np.asarray(jcy._bandpass(flat, SFREQ, lo, hi))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("case", CASES)
def test_crossings_are_the_same(case):
    """Both packages' bandpassed traces are non-negative at the same
    samples, so both cut the same half-cycles."""
    x, (lo, hi) = _signals()[case]
    flat = x.reshape(-1, x.shape[-1])
    xf = tcy._bandpass(torch.from_numpy(flat), SFREQ, lo, hi).numpy()
    np.testing.assert_array_equal(
        xf >= 0, np.asarray(jcy._bandpass(flat, SFREQ, lo, hi)) >= 0)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("kw", [{}, dict(amp_fraction=0.2,
                                         amp_consistency=0.3,
                                         min_n_cycles=2)])
def test_cycle_features_match_jax(case, kw):
    x, band = _signals()[case]
    got = tcy.cycle_features(x, SFREQ, band, device=CPU, **kw)
    want = jcy.cycle_features(x, SFREQ, band, **kw)
    for name, a, b in zip(got._fields, got, want):
        assert isinstance(a, torch.Tensor)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)


def test_segmentation_matches_the_loop_oracle():
    x, band = _signals()["harmonic"]
    tab = tcy.cycle_features(x, SFREQ, band, device=CPU)
    ref = _oracle(x, band)
    k = int(tab.n_cycles)
    assert k == len(ref)
    np.testing.assert_array_equal(np.round(tab.time_trough[:k].numpy()
                                           * SFREQ), [c[0] for c in ref])
    np.testing.assert_array_equal(np.round(tab.time_peak[:k].numpy()
                                           * SFREQ), [c[1] for c in ref])


def test_known_shapes():
    """A sine is symmetric, a rising sawtooth rises slowly, and a sine
    that is on half of the time bursts only where it is on."""
    tab = tcy.cycle_features(_sig(np.sin(2 * np.pi * 8.0 * T)), SFREQ,
                             (5.0, 12.0), device=CPU)
    k = int(tab.n_cycles)
    assert abs(float(tab.rdsym[:k].median()) - 0.5) < 0.05
    assert abs(float(tab.freq_hz[:k].median()) - 8.0) < 0.3
    x, band = _signals()["sawtooth"]
    tab = tcy.cycle_features(x, SFREQ, band, device=CPU)
    assert float(tab.rdsym[:int(tab.n_cycles)].median()) > 0.7
    x, band = _signals()["gated_batch"]
    tab = tcy.cycle_features(x, SFREQ, band, device=CPU)
    assert tab.is_burst.any(-1).all()


def test_validation():
    x = _sig(np.sin(2 * np.pi * 8.0 * T))
    for band, sfreq, xx in (((12.0, 5.0), SFREQ, x),
                            ((5.0, 300.0), SFREQ, x),
                            ((5.0, 12.0), SFREQ, x[:8])):
        with pytest.raises(ValueError):
            jcy.cycle_features(xx, sfreq, band)
        with pytest.raises(ValueError):
            tcy.cycle_features(xx, sfreq, band, device=CPU)
