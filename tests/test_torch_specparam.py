"""The port's specparam (``ninwavelets_tpu_torch.ops.specparam``) against
the JAX package on the same seeded spectra, on the CPU, and against
``tests/test_specparam.py``'s planted answers.

Gates, each with its reason:

* the seeds (``n_steps=0``): rtol 1e-6 (the same float64 host code, copied,
  then cast to float32 and passed through exp / softplus);
* the closed-form gradient against ``torch.autograd`` in float64: 1e-12
  of its largest entry;
* a short Adam trajectory (50 steps): rtol 2e-5 on every field (the same
  loop in float32; the closed-form gradient and ``jax.grad`` round
  differently, by about 1e-7 a step);
* the default 2000 steps: the fitted model within 5e-3 of its max,
  ``r_squared`` within 1e-4, the exponent and offset within 2e-3 of their
  max.  Adam divides each step by the root of a running mean of squared
  gradients, so a gradient that sits near zero (an unused peak slot, a
  flat direction of the loss) takes steps of the size of its round-off,
  and over 2000 steps the two trajectories drift apart in those
  directions while the fit itself stays put: the model, its quality and
  the aperiodic exponent are what a user reads, and those are held;
* validation: the JAX package's exception type.
"""
import importlib

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401

js = importlib.import_module("ninwavelets_tpu.ops.specparam")
ts = importlib.import_module("ninwavelets_tpu_torch.ops.specparam")

from test_specparam import FREQS, _spectrum

CPU = "cpu"


def _bench_spectra(b=6, seed=0):
    """``benchmarks/extensions_bench.py:749``'s planted spectra: 10 /
    f^1.2 plus a 10 Hz peak plus a little noise."""
    rng = np.random.default_rng(seed)
    f = np.linspace(2.0, 60.0, 117)
    p = (10.0 / f[None, :] ** 1.2
         + 2.0 * np.exp(-0.5 * ((f[None, :] - 10.0) / 1.5) ** 2)
         + 0.05 * rng.random((b, f.size))).astype(np.float32)
    return p, f


def _fields(got, want, rtol, names=ts.SpectralFit._fields):
    for name in names:
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert isinstance(g, np.ndarray) and g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol * np.abs(
            w).max(), err_msg=name)


@pytest.mark.parametrize("fit_knee", [False, True])
def test_closed_form_gradient_is_autograds(fit_knee):
    """``_grad`` against ``torch.autograd`` of the same loss, in float64
    (1e-12 of the largest entry: both are exact formulas)."""
    rng = np.random.default_rng(3)
    b, k = 3, 4
    f = torch.linspace(2.0, 60.0, 50, dtype=torch.float64)
    y = torch.from_numpy(rng.standard_normal((b, 50)))
    p = torch.from_numpy(rng.standard_normal((b, 3 + 3 * k)))
    p[:, 3 + k:3 + 2 * k] = torch.from_numpy(rng.uniform(5, 50, (b, k)))
    got = ts._grad(p, f, y, k, fit_knee)
    leaf = p.clone().requires_grad_(True)
    groups = ts._split(leaf, k)
    if not fit_knee:
        groups = (groups[0], torch.full_like(groups[1], -20.0), *groups[2:])
    r = ts._model(f, groups) - y
    (want,) = torch.autograd.grad((r * r).mean(), leaf)
    assert (got - want).abs().max() <= 1e-12 * want.abs().max()


@pytest.mark.parametrize("fit_knee", [False, True])
def test_seeds_match_jax(fit_knee):
    p, f = _bench_spectra()
    got = ts.specparam(p, f, n_steps=0, fit_knee=fit_knee, device=CPU)
    want = js.specparam(p, f, n_steps=0, fit_knee=fit_knee)
    _fields(got, want, 1e-6)


@pytest.mark.parametrize("fit_knee,max_peaks", [(False, 4), (True, 2)])
def test_short_trajectory_matches_jax(fit_knee, max_peaks):
    p, f = _bench_spectra()
    got = ts.specparam(p, f, n_steps=50, fit_knee=fit_knee,
                       max_peaks=max_peaks, device=CPU)
    want = js.specparam(p, f, n_steps=50, fit_knee=fit_knee,
                        max_peaks=max_peaks)
    _fields(got, want, 2e-5)


def test_default_steps_hold_the_fit():
    p, f = _bench_spectra()
    got = ts.specparam(p, f, device=CPU)
    want = js.specparam(p, f)
    np.testing.assert_allclose(got.model, np.asarray(want.model),
                               atol=5e-3 * np.abs(want.model).max())
    np.testing.assert_allclose(got.r_squared, np.asarray(want.r_squared),
                               atol=1e-4)
    for name in ("exponent", "offset"):
        w = np.asarray(getattr(want, name))
        np.testing.assert_allclose(getattr(got, name), w,
                                   atol=2e-3 * np.abs(w).max())


def test_recovers_the_planted_spectrum():
    """``tests/test_specparam.py``'s two-peak spectrum, with a batch shape
    and a 1-D spectrum."""
    power = _spectrum(1.2, 1.5, [(10.0, 0.6, 1.5), (22.0, 0.3, 3.0)])
    fit = ts.specparam(power, FREQS, device=CPU)
    assert fit.exponent.shape == () and fit.centers.shape == (4,)
    assert float(fit.offset) == pytest.approx(1.2, abs=0.05)
    assert float(fit.exponent) == pytest.approx(1.5, abs=0.05)
    peaks = fit.peaks()
    assert abs(peaks[0]["center"] - 10.0) < 0.5
    batch = np.stack([power, power])[None]
    fb = ts.specparam(batch, FREQS, n_steps=200, device=CPU)
    assert fb.exponent.shape == (1, 2) and fb.model.shape == (1, 2,
                                                              FREQS.size)


def test_tensor_input_and_device():
    p, f = _bench_spectra(2)
    fit = ts.specparam(torch.from_numpy(p), f, n_steps=10)
    ref = ts.specparam(p, f, n_steps=10, device=CPU)
    assert isinstance(fit.model, np.ndarray)
    np.testing.assert_array_equal(fit.model, ref.model)


def test_validation():
    p, f = _bench_spectra(2)
    for args in ((p, -f), (p, f[:-1])):
        with pytest.raises(ValueError):
            js.specparam(*args)
        with pytest.raises(ValueError):
            ts.specparam(*args, device=CPU)
