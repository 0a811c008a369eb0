"""The port's Welch PSD and IRASA (``ninwavelets_tpu_torch.ops.irasa``)
against the JAX package on the same seeded inputs, on the CPU, and against
``tests/test_irasa.py``'s oracles.

Gates, each with its reason:

* ``_eval_scaled``: exact against the JAX function run op by op (the same
  float32 positions, floors, clips and blend, each an exactly rounded
  operation);
* Welch spectra, the fractal and oscillatory parts: max|d| <= 1e-5 x
  max|psd| (float32 FFT pipelines apart in round-off, about 1e-7);
* ``aperiodic_fit``: rtol 1e-5 on the offset and 2e-5 on the exponent (a
  least-squares slope of float32 logs: the logs' round-off over the
  centred frequencies);
* ``fractal + oscillatory`` against ``psd``: 1e-6 of the max (the
  subtraction that makes the oscillatory part rounds once);
* the median over an even ``hset``: the mean of the two middle values,
  exactly as the numpy median of the port's own stack computes it;
* validation: the JAX package's exception type.
"""
import importlib

import numpy as np
import pytest
import torch
from scipy import signal as ss

from torch_threads import one_torch_thread  # noqa: F401

ji = importlib.import_module("ninwavelets_tpu.ops.irasa")
ti = importlib.import_module("ninwavelets_tpu_torch.ops.irasa")

from test_irasa import SFREQ, _fractal_plus_tone

CPU = "cpu"
GATE = 1e-5


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, scale, gate=GATE):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    d = np.abs(got.astype(np.float64) - want).max()
    assert d <= gate * scale, (d, scale)


@pytest.mark.parametrize("shape,nperseg", [((3, 5000), 256),
                                           ((2, 2, 4096), 512),
                                           ((4000,), 255),
                                           ((2, 100), 256)])
def test_welch_psd_matches_jax(shape, nperseg):
    """Even and odd segments, batched and 1-D, and a record shorter than a
    segment (its samples past the end repeat the last one, as the JAX
    package's clamped gather reads them)."""
    x = _x(shape, 1)
    got = ti.welch_psd(x, sfreq=SFREQ, nperseg=nperseg, device=CPU)
    want = np.asarray(ji.welch_psd(x, sfreq=SFREQ, nperseg=nperseg))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    _close(got, want, np.abs(want).max())


def test_welch_psd_matches_scipy():
    sig = _fractal_plus_tone(20_000)
    got = ti.welch_psd(sig, sfreq=SFREQ, nperseg=1024, device=CPU).numpy()
    _, ref = ss.welch(sig, fs=SFREQ, window="hamming", nperseg=1024,
                      noverlap=512, detrend="constant")
    np.testing.assert_allclose(got, ref, atol=1e-3 * ref.max(), rtol=5e-3)


@pytest.mark.parametrize("scale", [1.1, 1.35, 1.0 / 1.9, 1.0 / 1.45])
def test_eval_scaled_is_the_jax_packages(scale):
    psd = np.abs(_x((3, 257), 2))
    got = ti._eval_scaled(torch.from_numpy(psd), np.float32(scale))
    want = ji._eval_scaled(psd, np.float32(scale))    # op by op
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("hset", [None, (1.1, 1.3, 1.5, 1.7),
                                  (1.2, 1.4, 1.6, 1.8, 1.9, 1.25)])
def test_irasa_matches_jax(hset):
    """The default 17 factors (odd), and two even sets."""
    x = np.stack([_fractal_plus_tone(8000, seed=s) for s in range(2)])
    got = ti.irasa(x, SFREQ, band=(1.0, 60.0), hset=hset, nperseg=512,
                   device=CPU)
    want = ji.irasa(x, SFREQ, band=(1.0, 60.0), hset=hset, nperseg=512)
    np.testing.assert_array_equal(got.freqs.numpy(), np.asarray(want.freqs))
    scale = np.abs(np.asarray(want.psd)).max()
    for f in ("psd", "fractal", "oscillatory"):
        _close(getattr(got, f), getattr(want, f), scale)
    # psd - fractal is rounded once, so adding the fractal back is within
    # an ulp of the psd's magnitude, not always equal
    _close(got.fractal + got.oscillatory, got.psd, scale, 1e-6)


def test_even_hset_median_averages_the_middle_pair():
    """``torch.median`` takes the lower middle value; the port averages the
    two, as ``jnp.median`` does, and the two differ here."""
    x = _fractal_plus_tone(6000, seed=4)
    hset = (1.1, 1.3, 1.6, 1.9)
    psd = ti.welch_psd(x, sfreq=SFREQ, nperseg=256, device=CPU)
    geo = torch.stack([
        (ti._eval_scaled(psd, np.float32(h))
         * ti._eval_scaled(psd, np.float32(1.0 / h))).clamp(min=0).sqrt()
        for h in hset], -1).numpy()
    got = ti.irasa(x, SFREQ, band=(0.0, SFREQ / 2), hset=hset, nperseg=256,
                   device=CPU).fractal.numpy()
    s = np.sort(geo, -1)
    np.testing.assert_array_equal(got, (s[..., 1] + s[..., 2]) * np.float32(
        0.5))
    assert np.abs(got - s[..., 1]).max() > 0
    want = ji.irasa(x, SFREQ, band=(0.0, SFREQ / 2), hset=hset, nperseg=256)
    _close(got, want.fractal, np.abs(np.asarray(want.psd)).max())


def test_aperiodic_fit_matches_jax_and_recovers_the_exponent():
    x = np.stack([_fractal_plus_tone(seed=s) for s in range(2)])
    res = ti.irasa(x, SFREQ, band=(1.0, 40.0), device=CPU)
    off, chi = ti.aperiodic_fit(res.freqs, res.fractal)
    joff, jchi = ji.aperiodic_fit(np.asarray(res.freqs),
                                  res.fractal.numpy())
    np.testing.assert_allclose(off.numpy(), np.asarray(joff), rtol=1e-5)
    np.testing.assert_allclose(chi.numpy(), np.asarray(jchi), rtol=2e-5)
    assert np.all(np.abs(chi.numpy() - 2.0) < 0.35)        # true 1/f^2
    f = res.freqs.numpy()
    assert np.all(np.abs(f[res.oscillatory.argmax(-1).numpy()] - 10.0)
                  < 0.5)


def test_tensor_input_stays_on_its_device():
    x = torch.from_numpy(_x((2, 3000), 3))
    assert ti.welch_psd(x, sfreq=SFREQ, nperseg=256).device == x.device
    assert ti.irasa(x, SFREQ, nperseg=256).psd.device == x.device


def test_validation():
    x = _x(4096, 5)
    for kw in (dict(hset=[1.0, 1.5]), dict(band=(300.0, 400.0))):
        with pytest.raises(ValueError):
            ji.irasa(x, SFREQ, nperseg=256, **kw)
        with pytest.raises(ValueError):
            ti.irasa(x, SFREQ, nperseg=256, device=CPU, **kw)
