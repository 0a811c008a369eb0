"""The port's empirical wavelet transform and variational mode
decomposition (``ninwavelets_tpu_torch.ops.ewt`` / ``ops.vmd``: EWT, VMD,
multivariate VMD, the instantaneous attributes and the Hilbert spectrum)
against the JAX package on the same seeded inputs, on the CPU.

Gates, each with its reason:

* boundaries and filterbanks: exact (the same float64 host numpy code,
  copied, cast once to float32);
* EWT modes, VMD modes, the instantaneous frequency and amplitude:
  max|d| <= 1e-5 x max|ref| (float32 FFT pipelines; the 200 ADMM
  iterations carry the FFT round-off, about 1e-6 of the max);
* without smoothing, the instantaneous frequency at 1e-5 of the max only
  where a mode's amplitude and the previous sample's are at least 1e-2
  of its max (the phase step of a near-zero analytic sample is
  round-off: 2.5e-5 of the max at an amplitude 1e-3 of it), 1e-4
  elsewhere; with ``smooth`` > 1 the boxcar averages such a step over the
  window and the 1e-5 gate holds everywhere;
* VMD center frequencies: rtol 1e-5;
* the Hilbert spectrum: each cell holds one mode's energy at the row of
  its instantaneous frequency, so a frequency within round-off of a row
  edge may land in the neighbouring row: the planes are compared at 1e-5
  of the max on the columns where every mode's frequency is at least
  1e-3 of a row from an edge, and every column's total energy at 1e-5;
  on the card each cell is written once and the modes summed in order,
  so the plane is the same on every run.
"""
import importlib

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401

jw = importlib.import_module("ninwavelets_tpu.ops.ewt")
jv = importlib.import_module("ninwavelets_tpu.ops.vmd")
tw = importlib.import_module("ninwavelets_tpu_torch.ops.ewt")
tv = importlib.import_module("ninwavelets_tpu_torch.ops.vmd")

import ninwavelets_tpu_torch.ops as tops

CPU = "cpu"
SFREQ = 250.0
N = 2048


def _close(got, want, gate=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    d = np.abs(got.astype(np.float64) - want).max()
    assert d <= gate * np.abs(want).max(), (d, np.abs(want).max())


def _tones(shape=(), seed=0, freqs=(5.0, 25.0, 60.0)):
    rng = np.random.default_rng(seed)
    t = np.arange(N) / SFREQ
    x = sum(np.sin(2 * np.pi * f * t + i) for i, f in enumerate(freqs))
    return (x + 0.1 * rng.standard_normal(shape + (N,))).astype(np.float32)


def test_exports_keep_the_jax_packages_names():
    """``ops.ewt`` / ``ops.vmd`` are the submodules; the transforms have
    the long names, as in the JAX package."""
    assert tops.ewt is tw and tops.vmd is tv
    assert tops.empirical_wavelet_transform is tw.ewt
    assert tops.variational_mode_decomposition is tv.vmd


@pytest.mark.parametrize("smooth", [0, 5])
def test_ewt_boundaries_and_filterbank_are_the_jax_packages(smooth):
    x = _tones(seed=1)
    b = tw.ewt_boundaries(x, SFREQ, 3, smooth)
    np.testing.assert_array_equal(b, jw.ewt_boundaries(x, SFREQ, 3, smooth))
    for gamma in (None, 0.05):
        np.testing.assert_array_equal(
            tw.ewt_filterbank(b, N, SFREQ, gamma, device=CPU).numpy(),
            np.asarray(jw.ewt_filterbank(b, N, SFREQ, gamma)))


@pytest.mark.parametrize("shape,n_modes", [((), 3), ((2, 3), 3), ((), 2)])
def test_ewt_matches_jax_and_reconstructs(shape, n_modes):
    x = _tones(shape, seed=2)
    modes, b = tw.ewt(x, SFREQ, n_modes, device=CPU)
    jm, jb = jw.ewt(x, SFREQ, n_modes)
    np.testing.assert_array_equal(b, jb)
    _close(modes, jm)
    _close(tw.ewt_reconstruct(modes), x)


def test_ewt_given_boundaries_and_validation():
    x = _tones(seed=3)
    modes, b = tw.ewt(x, SFREQ, boundaries=[15.0, 40.0], device=CPU)
    _close(modes, jw.ewt(x, SFREQ, boundaries=[15.0, 40.0])[0])
    for bad in ([0.0, 10.0], [200.0]):
        with pytest.raises(ValueError):
            jw.ewt_filterbank(bad, N, SFREQ)
        with pytest.raises(ValueError):
            tw.ewt_filterbank(bad, N, SFREQ, device=CPU)
    with pytest.raises(ValueError):
        tw.ewt_boundaries(x, SFREQ, 1)


@pytest.mark.parametrize("kw", [dict(), dict(n_modes=2, alpha=500.0),
                                dict(tau=0.1, n_iter=60)])
def test_vmd_matches_jax(kw):
    x = _tones((2,), seed=4)
    modes, w = tv.vmd(x, SFREQ, device=CPU, **kw)
    jm, jwk = jv.vmd(x, SFREQ, **kw)
    _close(modes, jm)
    np.testing.assert_allclose(w.numpy(), np.asarray(jwk), rtol=1e-5)
    assert np.all(np.diff(w.numpy(), axis=-1) >= 0)


def test_mvmd_matches_jax():
    x = np.stack([_tones(seed=5), _tones(seed=6, freqs=(5.0, 40.0))])
    modes, w = tv.mvmd(x, SFREQ, n_modes=3, n_iter=80, device=CPU)
    jm, jwk = jv.mvmd(x, SFREQ, n_modes=3, n_iter=80)
    assert modes.shape == (3, 2, N) and w.shape == (3,)
    _close(modes, jm)
    np.testing.assert_allclose(w.numpy(), np.asarray(jwk), rtol=1e-5)
    with pytest.raises(ValueError):
        tv.mvmd(x[0], SFREQ, device=CPU)


@pytest.mark.parametrize("smooth", [0, 1, 5, 8])
def test_instantaneous_matches_jax(smooth):
    modes = np.array(jv.vmd(_tones((2,), seed=7), SFREQ)[0])
    f, a = tv.instantaneous(modes, SFREQ, smooth, device=CPU)
    jf, ja = jv.instantaneous(modes, SFREQ, smooth)
    _close(a, ja)
    if smooth > 1:
        _close(f, jf)
        return
    # the phase step of a near-zero analytic sample is round-off
    jf, ja = np.asarray(jf), np.asarray(ja)
    amp = ja / ja.max(-1, keepdims=True)
    sound = (amp >= 1e-2) & (np.roll(amp, 1, -1) >= 1e-2)
    d = np.abs(f.numpy() - jf)
    scale = np.abs(jf).max()
    assert sound.mean() > 0.9
    assert d[sound].max() <= 1e-5 * scale
    assert d.max() <= 1e-4 * scale


@pytest.mark.parametrize("kw", [dict(), dict(n_bins=32, fmax=80.0,
                                             smooth=0)])
def test_hilbert_spectrum_matches_jax(kw):
    modes = np.array(jv.vmd(_tones((2,), seed=8), SFREQ)[0])
    got = tv.hilbert_spectrum(modes, SFREQ, device=CPU, **kw).numpy()
    want = np.asarray(jv.hilbert_spectrum(modes, SFREQ, **kw))
    assert got.shape == want.shape
    n_bins = kw.get("n_bins", 64)
    step = kw.get("fmax", SFREQ / 2) / n_bins
    f, _ = jv.instantaneous(modes, SFREQ, kw.get("smooth", 5))
    pos = np.asarray(f) / step
    sound = (np.abs(pos - np.round(pos)) >= 1e-3).all(-2)   # (B, N)
    assert sound.mean() > 0.9
    scale = np.abs(want).max()
    d = np.abs(got - want).max(-2)                          # (B, N)
    assert d[sound].max() <= 1e-5 * scale
    np.testing.assert_allclose(got.sum(-2), want.sum(-2),
                               atol=1e-5 * scale)
