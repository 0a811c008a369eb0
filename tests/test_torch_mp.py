"""The port's matching pursuit (``ninwavelets_tpu_torch.ops.mp``) against
the JAX package on the same seeded signals, on the CPU.

Gates, each with its reason:

* the Gabor dictionary: exact (the same float64 host numpy code, copied,
  cast once to float32);
* the selected atoms' scale, frequency and sample: exact (both take the
  first maximum of the same flat (row, u) order; the signals here have no
  two candidates within round-off, which ``test_selection_margins``
  checks);
* amplitudes, phases (on atoms whose amplitude is at least 1e-3 of the
  largest), energies and residuals: max|d| <= 1e-4 x max|ref| (a
  float32 correlation through the FFT, then a 2 x 2 projection whose
  determinant cancels for a narrow atom: about 1e-5 of the max);
* ``mp_tfr`` of the JAX package's own atoms (``convert.mp_result_from_jax``):
  1e-5 of the max (closed-form blobs, one float32 product);
* the energy identity ``sum(energy) + |residual|^2 = |x|^2``: rtol 1e-4.
"""
import importlib

import numpy as np
import pytest
import torch

from ninwavelets_tpu_torch import convert

from torch_threads import one_torch_thread  # noqa: F401

jm = importlib.import_module("ninwavelets_tpu.ops.mp")
tm = importlib.import_module("ninwavelets_tpu_torch.ops.mp")

CPU = "cpu"
SFREQ = 250.0


def _gabor_sum(shape, n=512, seed=0):
    """Three Gabor atoms of distinct scales and frequencies at random
    places, plus a little noise, per signal."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SFREQ
    out = 0.05 * rng.standard_normal(shape + (n,))
    for s, f, a in ((0.08, 30.0, 2.0), (0.4, 8.0, 1.5), (0.03, 60.0, 1.0)):
        u = rng.uniform(0.2, 0.8, shape + (1,)) * n / SFREQ
        ph = rng.uniform(0, 2 * np.pi, shape + (1,))
        out += a * np.exp(-np.pi * (t - u) ** 2 / s ** 2) * np.cos(
            2 * np.pi * f * (t - u) + ph)
    return out.astype(np.float32)


def _close(got, want, gate):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got.astype(np.float64) - want).max() <= gate * np.abs(
        want).max()


@pytest.mark.parametrize("n,kw", [(512, {}), (300, dict(
    scales_s=[0.05, 0.2], freqs=np.arange(5.0, 60.0, 5.0)))])
def test_dictionary_is_the_jax_packages(n, kw):
    rows, meta = tm.gabor_dictionary(n, SFREQ, **kw)
    jrows, jmeta = jm.gabor_dictionary(n, SFREQ, **kw)
    np.testing.assert_array_equal(rows, jrows)
    np.testing.assert_array_equal(meta, jmeta)


@pytest.mark.parametrize("shape,n_atoms", [((2, 3), 8), ((), 5)])
def test_matching_pursuit_matches_jax(shape, n_atoms):
    x = _gabor_sum(shape, seed=1)
    got = tm.matching_pursuit(x, n_atoms, SFREQ, device=CPU)
    want = jm.matching_pursuit(x, n_atoms, SFREQ)
    assert got.amplitude.shape == shape + (n_atoms,)
    for f in ("scale_s", "freq_hz"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    # the same sample; the seconds within an ulp (XLA divides by sfreq as
    # a multiplication by its reciprocal)
    np.testing.assert_array_equal(np.round(got.time_s.numpy() * SFREQ),
                                  np.round(np.asarray(want.time_s) * SFREQ))
    np.testing.assert_allclose(got.time_s.numpy(), np.asarray(want.time_s),
                               rtol=1e-6)
    for f in ("amplitude", "energy", "residual"):
        _close(getattr(got, f), getattr(want, f), 1e-4)
    amp = np.asarray(want.amplitude)
    big = amp >= 1e-3 * amp.max()
    dphi = np.angle(np.exp(1j * (got.phase.numpy() - np.asarray(
        want.phase))))
    assert np.abs(dphi[big]).max() <= 1e-4 * np.pi


def test_selection_margins():
    """The parity above rests on clear selections: at every step the best
    correlation beats the best one elsewhere (more than 2 samples away, or
    another row) by more than round-off."""
    x = torch.from_numpy(_gabor_sum((2, 3), seed=1)).reshape(-1, 512)
    rows, meta = tm.gabor_dictionary(512, SFREQ)
    bank = torch.from_numpy(rows)
    r = x
    res = tm.matching_pursuit(x, 8, SFREQ, device=CPU)
    for k in range(8):
        corr = torch.fft.ifft(torch.fft.fft(r)[:, None, :] * bank)
        mag = (corr.real.square() + corr.imag.square())
        best = mag.flatten(1).max(-1).values
        idx = mag.flatten(1).argmax(-1)
        row, u = idx // 512, idx % 512
        for b in range(r.shape[0]):
            m = mag[b].clone()
            m[row[b], (u[b] + torch.arange(-2, 3)) % 512] = 0
            assert (best[b] - m.max()) > 1e-4 * best[b]
        # the next residual, from the port's own atoms
        if k < 7:
            sub = tm.matching_pursuit(x, k + 1, SFREQ, device=CPU)
            r = sub.residual
    assert res.residual.shape == x.shape


def test_energy_identity():
    x = _gabor_sum((4,), seed=2)
    res = tm.matching_pursuit(x, 12, SFREQ, device=CPU)
    total = res.energy.double().sum(-1) + res.residual.double().square().sum(
        -1)
    np.testing.assert_allclose(total.numpy(), np.square(
        x.astype(np.float64)).sum(-1), rtol=1e-4)
    assert (res.energy >= 0).all()


def test_mp_tfr_of_the_jax_atoms_matches_jax():
    x = _gabor_sum((2,), seed=3)
    want = jm.matching_pursuit(x, 6, SFREQ)
    ours = convert.mp_result_from_jax(want, device=CPU)
    assert isinstance(ours, tm.MPResult)
    grid = np.arange(2.0, 80.0, 2.0)
    for decim in (16, 7):
        got = tm.mp_tfr(ours, 512, SFREQ, grid, t_decim=decim)
        _close(got, jm.mp_tfr(want, 512, SFREQ, grid, t_decim=decim), 1e-5)


def test_tensor_input_stays_on_its_device():
    x = torch.from_numpy(_gabor_sum((2,), seed=4))
    res = tm.matching_pursuit(x, 3, SFREQ)
    assert res.residual.device == x.device and res.energy.shape == (2, 3)
