"""The port's S-transform (``ninwavelets_tpu_torch.ops.stockwell``) against the
JAX package on the same seeded signals, on the CPU, and against
``tests/test_stockwell.py``'s numpy transcription and known answers.  The
JAX package returns the transform as a float pair (``stockwell_ri``) or a
host complex array; the port returns one complex64 tensor, compared with
``r + 1j i``.

Gates, each with its reason:

* S-transform planes and inverses: max|d| <= 1e-5 x max|ref| (the same
  float32 gather, Gaussian rows and FFTs; apart in the FFT's round-off);
* the numpy transcription: ``tests/test_stockwell.py``'s 2e-5 absolute;
* ``istockwell`` writes each analysis bin with a scatter, which is
  unordered in both packages when two frequencies round to one bin, so
  the inverse is tested on distinct bins only; at the Nyquist bin the
  conjugate's write comes second in both and is compared;
* validation: the JAX package's exception type.
"""
import importlib

import numpy as np
import pytest
import torch

from ninwavelets_tpu_torch.ops import istockwell, stockwell

from test_stockwell import N, SFREQ, _numpy_st
from test_torch_dwt import _close
from torch_threads import one_torch_thread  # noqa: F401

js = importlib.import_module("ninwavelets_tpu.ops.stockwell")
CPU = "cpu"


def _jst(x, freqs, sfreq=SFREQ):
    r, i = js.stockwell_ri(x, freqs, sfreq)
    return np.asarray(r) + 1j * np.asarray(i)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("freqs", [[8.0, 32.0, 64.0], [0.5, 128.0],
                                   list(np.arange(1.0, 129.0, 3.0))])
def test_matches_jax_and_numpy(freqs):
    x = _x(N)
    got = stockwell(x, freqs, SFREQ, device=CPU)
    assert got.dtype == torch.complex64 and got.shape == (len(freqs), N)
    _close(got.numpy(), _jst(x, freqs))
    np.testing.assert_allclose(got.numpy(), _numpy_st(
        x.astype(np.float64), freqs), atol=2e-5)


def test_fourier_mean_identity():
    x = _x(N, 1)
    freqs = [16.0, 40.0]
    st = stockwell(x, freqs, SFREQ, device=CPU).numpy()
    spec = np.fft.fft(x.astype(np.float64))
    for row, f in zip(st, freqs):
        k = int(round(f * N / SFREQ))
        np.testing.assert_allclose(row.mean() * N, spec[k], rtol=1e-4,
                                   atol=1e-4)


def test_absolute_phase_reference():
    t = np.arange(N) / SFREQ
    x = np.cos(2 * np.pi * 32.0 * t).astype(np.float32)
    st = stockwell(x, [32.0], SFREQ, device=CPU).numpy()[0]
    assert np.abs(np.angle(st[N // 4: -N // 4])).max() < 0.05


@pytest.mark.parametrize("freqs", [[16.0, 48.0], [16.0, 48.0, 128.0]])
def test_inverse_matches_jax_on_a_banded_signal(freqs):
    t = np.arange(N) / SFREQ
    x = (np.sin(2 * np.pi * 16 * t) + 0.5 * np.cos(2 * np.pi * 48 * t)
         + 0.25 * np.cos(2 * np.pi * 128 * t)).astype(np.float32)
    st = stockwell(x, freqs, SFREQ, device=CPU)
    rec = istockwell(st, freqs, SFREQ, N)
    r, i = js.stockwell_ri(x, freqs, SFREQ)
    _close(rec, js.istockwell(r, i, freqs, SFREQ, N))
    if len(freqs) == 3:            # the Nyquist row: X(N/2) is real
        np.testing.assert_allclose(rec.numpy(), x, atol=1e-4)


def test_inverse_of_a_host_array_and_a_batch():
    x = _x((3, N), 2)
    freqs = [16.0, 32.0]
    st = stockwell(x, freqs, SFREQ, device=CPU)
    want = istockwell(st, freqs, SFREQ, N)
    got = istockwell(st.numpy(), freqs, SFREQ, N, device=CPU)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert got.shape == (3, N)
    r, i = js.stockwell_ri(x, freqs, SFREQ)
    _close(got, js.istockwell(r, i, freqs, SFREQ, N))


def test_spectrogram_localizes():
    t = np.arange(N) / SFREQ
    burst = np.zeros(N, np.float32)
    sel = (t > 1.0) & (t < 1.5)
    burst[sel] = np.sin(2 * np.pi * 40 * t[sel]).astype(np.float32)
    p = np.abs(stockwell(burst, [20.0, 40.0, 80.0], SFREQ,
                         device=CPU).numpy()) ** 2
    assert p[1].max() > 5 * max(p[0].max(), p[2].max())
    assert abs(p[1].argmax() / SFREQ - 1.25) < 0.3


@pytest.mark.parametrize("freqs", [[0.0], [200.0], [-8.0], [0.2]])
def test_validation_matches_jax(freqs):
    x = np.zeros(N, np.float32)
    with pytest.raises(ValueError):
        js.stockwell(x, freqs, SFREQ)
    with pytest.raises(ValueError):
        stockwell(x, freqs, SFREQ, device=CPU)
    with pytest.raises(ValueError):
        istockwell(torch.zeros(1, N, dtype=torch.complex64), freqs, SFREQ, N)


def test_batched_rows_equal_single_rows():
    x = _x((3, N), 2)
    st = stockwell(x, [16.0, 32.0], SFREQ, device=CPU)
    assert st.shape == (3, 2, N)
    _close(st.numpy(), _jst(x, [16.0, 32.0]))
    one = stockwell(x[1], [16.0, 32.0], SFREQ, device=CPU)
    np.testing.assert_allclose(st[1].numpy(), one.numpy(), atol=1e-6)
