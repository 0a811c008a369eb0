"""The port's scattering transform (``ninwavelets_tpu_torch.ops.scattering``
and ``WaveletBase.scattering``) against the JAX package at N = 1024.

On the CPU the port's fused path is ``fused_power_from_bank``'s plain
version; the JAX fused path runs its Pallas kernel with ``interpret=True``.
Gate: max|d| / max|ref| <= 1e-5 on S1 and S2.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ninwavelets_tpu as nw
from ninwavelets_tpu_torch.convert import wavelet_from_jax
from ninwavelets_tpu_torch.ops import scattering as tscat

from torch_threads import one_torch_thread  # noqa: F401

# ``ninwavelets_tpu.ops`` exports the function under the module's name.
jscat = importlib.import_module("ninwavelets_tpu.ops.scattering")

SFREQ = 1000.0
N = 1024
STRIDE = 32
FREQS1 = np.geomspace(8.0, 400.0, 8)
FREQS2 = np.geomspace(1.0, 64.0, 5)
RTOL = 1e-5


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _signal(shape=(2, N), seed=3):
    rng = np.random.default_rng(seed)
    t = np.arange(shape[-1]) / SFREQ
    # A 100 Hz tone tremolo'd at 8 Hz: energy in S2 at (8 Hz, 100 Hz).
    tone = np.sin(2 * np.pi * 100.0 * t) * (1 + 0.8 * np.sin(
        2 * np.pi * 8.0 * t))
    return (tone + 0.3 * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("lowpass", ["matmul", "fft"])
def test_scattering_method_matches_jax(lowpass):
    jw = nw.Morse(SFREQ, interpolate=True)
    tw = wavelet_from_jax(jw, device="cpu")
    sig = _signal()
    want = jw.scattering(sig, FREQS1, FREQS2, stride=STRIDE, lowpass=lowpass)
    s1, s2 = tw.scattering(sig, FREQS1, FREQS2, stride=STRIDE,
                           lowpass=lowpass)
    assert s1.shape == (2, 8, N // STRIDE)
    assert s2.shape == (2, 5, 8, N // STRIDE)
    assert _rel(s1.numpy(), want[0]) <= RTOL
    assert _rel(s2.numpy(), want[1]) <= RTOL


def _banks():
    jw = nw.Morse(SFREQ, interpolate=True)
    from ninwavelets_tpu.ops.bank import make_fft_bank
    b1 = np.array(make_fft_bank(jw._wdef(), jnp.asarray(FREQS1), N, SFREQ,
                                True), np.float32)
    b2 = np.array(make_fft_bank(jw._wdef(), jnp.asarray(FREQS2), N, SFREQ,
                                False), np.float32)
    return b1, b2


@pytest.mark.parametrize("use_fused", [False, True])
@pytest.mark.parametrize("lowpass", ["matmul", "fft"])
def test_scattering_from_banks_matches_jax(use_fused, lowpass):
    b1, b2 = _banks()
    sig = _signal()
    want = jscat.scattering(jnp.asarray(sig), jnp.asarray(b1),
                            jnp.asarray(b2), SFREQ, stride=STRIDE,
                            use_fused=False, lowpass=lowpass)
    got = tscat.scattering(torch.from_numpy(sig), torch.from_numpy(b1),
                           torch.from_numpy(b2), SFREQ, stride=STRIDE,
                           use_fused=use_fused, lowpass=lowpass)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) <= RTOL


@pytest.mark.parametrize("shape", [(N,), (3, N)])
def test_fused_scattering_matches_jax_interpret(shape):
    b1, b2 = _banks()
    sig = _signal(shape, seed=5)
    want = jscat.scattering(jnp.asarray(sig), jnp.asarray(b1),
                            jnp.asarray(b2), SFREQ, stride=STRIDE,
                            use_fused=True, interpret=True)
    got = tscat.scattering(torch.from_numpy(sig), torch.from_numpy(b1),
                           torch.from_numpy(b2), SFREQ, stride=STRIDE,
                           use_fused=True)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) <= RTOL


def test_ragged_stride_takes_the_fft_lowpass():
    b1, b2 = _banks()
    sig = torch.from_numpy(_signal())
    s1, s2 = tscat.scattering(sig, torch.from_numpy(b1),
                              torch.from_numpy(b2), SFREQ, stride=48)
    assert s1.shape == (2, 8, -(-N // 48))
    with pytest.raises(ValueError, match="stride"):
        tscat.scattering_from_banks(sig, torch.from_numpy(b1),
                                    torch.from_numpy(b2), SFREQ, stride=48,
                                    lowpass="matmul")


def test_lowpass_pieces_match_jax():
    got = tscat.lowpass_spectrum(N, SFREQ, 15.625)
    want = np.asarray(jscat.lowpass_spectrum(N, SFREQ, 15.625))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(
        tscat._smooth_decimate_operator(N, STRIDE, SFREQ, 15.625),
        jscat._smooth_decimate_operator(N, STRIDE, SFREQ, 15.625))


def test_matmul_runs_in_fp32_and_restores_the_setting(monkeypatch):
    prev = torch.get_float32_matmul_precision()
    seen = []
    real = torch.matmul

    def spy(a, b):
        seen.append(torch.get_float32_matmul_precision())
        return real(a, b)

    monkeypatch.setattr(torch, "matmul", spy)
    b1, b2 = _banks()
    try:
        torch.set_float32_matmul_precision("medium")
        tscat.scattering(torch.from_numpy(_signal()), torch.from_numpy(b1),
                         torch.from_numpy(b2), SFREQ, stride=STRIDE)
        assert seen == ["highest", "highest"]
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(prev)


def test_scattering_rejects_complex_bank_families():
    from ninwavelets_tpu_torch import MexicanHat
    with pytest.raises(ValueError, match="real-bank"):
        MexicanHat(SFREQ, device="cpu").scattering(_signal(), FREQS1, FREQS2)
