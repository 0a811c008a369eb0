"""The port's reassignment, inverse CWT and denoising
(``ninwavelets_tpu_torch.ops.reassign``, ``ops.icwt``, ``ops.denoise`` and
the entry points that reach them) against the JAX package on the same
seeded inputs, on the CPU.

Gates: reassigned planes conserve the energy of each signal (rtol 1e-5;
every cell lands in exactly one bin) and match at SNR >= 60 dB, which
leaves room for the cells whose centroid sits on a bin edge; reconstructions
and denoised signals max|d| / max|ref| <= 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ninwavelets_tpu as nw
from ninwavelets_tpu.ops import cwt as jcwt
from ninwavelets_tpu.ops import icwt as jicwt
from ninwavelets_tpu.ops import reassign as jreassign
from ninwavelets_tpu.ops.bank import make_fft_bank as jbank
from ninwavelets_tpu.ops.denoise import denoise as jax_denoise
import ninwavelets_tpu_torch as nt
from ninwavelets_tpu_torch.convert import wavelet_from_jax
from ninwavelets_tpu_torch.ops import cwt as tcwt
from ninwavelets_tpu_torch.ops import denoise as tdenoise
from ninwavelets_tpu_torch.ops import icwt as ticwt
from ninwavelets_tpu_torch.ops import reassign as treassign

from torch_threads import one_torch_thread  # noqa: F401

SFREQ = 1000.0


def _bank(freqs, n, interpolate=True):
    return np.array(jbank(nw.Morse(SFREQ)._wdef(),
                          jnp.asarray(freqs, jnp.float32), n, SFREQ,
                          interpolate), np.float32)


def _signals(shape, seed=0, tone=60.0, noise=0.1):
    t = np.arange(shape[-1]) / SFREQ
    rng = np.random.default_rng(seed)
    return (np.sin(2 * np.pi * tone * t)
            + noise * rng.standard_normal(shape)).astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _snr(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return 10 * np.log10((want ** 2).sum() / max(((got - want) ** 2).sum(),
                                                 1e-300))


# -- reassignment -------------------------------------------------------------

@pytest.mark.parametrize("freqs,t_decim", [
    (np.arange(20.0, 81.0, 2.0), 16),
    (np.geomspace(8.0, 120.0, 24), 8),
])
def test_reassigned_power_matches_jax(freqs, t_decim):
    n = 1024
    sig = _signals((2, 2, n), seed=1)
    bank = _bank(freqs, n)
    got = treassign.reassigned_power(torch.from_numpy(sig),
                                     torch.from_numpy(bank), freqs, SFREQ,
                                     interpolate=True, t_decim=t_decim)
    want = np.asarray(jreassign.reassigned_power(
        sig, bank, freqs, SFREQ, interpolate=True, t_decim=t_decim))
    assert got.shape == (2, 2, freqs.size, -(-n // t_decim))
    assert got.dtype == torch.float32
    total = np.asarray(want, np.float64).sum((-2, -1))
    np.testing.assert_allclose(got.numpy().astype(np.float64).sum((-2, -1)),
                               total, rtol=1e-5)
    assert _snr(got.numpy(), want) >= 60.0


def test_reassigned_mean_power_is_the_mean():
    freqs = np.arange(30.0, 91.0, 3.0)
    sig = torch.from_numpy(_signals((3, 512), seed=2))
    bank = torch.from_numpy(_bank(freqs, 512))
    got = treassign.reassigned_mean_power(sig, bank, freqs, SFREQ,
                                          interpolate=True)
    each = treassign.reassigned_power(sig, bank, freqs, SFREQ,
                                      interpolate=True)
    torch.testing.assert_close(got, each.mean(0))
    want = np.asarray(jreassign.reassigned_mean_power(
        sig.numpy(), bank.numpy(), freqs, SFREQ, interpolate=True))
    assert _snr(got.numpy(), want) >= 60.0


def test_reassigned_power_rejects_complex_banks():
    bank = torch.ones((2, 512), dtype=torch.complex64)
    with pytest.raises(ValueError, match="analytic"):
        treassign.reassigned_power(torch.zeros(512), bank, [40.0, 50.0],
                                   SFREQ)


def test_epochs_reassigned_power_matches_jax():
    data = _signals((3, 2, 1024), seed=3, tone=45.0)
    freqs = np.arange(20.0, 81.0, 2.0)
    jew = nw.EpochsWavelet(nw.ArrayEpochs(data, SFREQ),
                           nw.Morse(SFREQ, interpolate=True))
    tew = nt.EpochsWavelet(nt.ArrayEpochs(data, SFREQ),
                           nt.Morse(SFREQ, interpolate=True, device="cpu"))
    got = tew.reassigned_power("ch1", freqs)
    want = np.asarray(jew.reassigned_power("ch1", freqs))
    assert got.shape == (freqs.size, 1024 // 16)
    assert _snr(got.numpy(), want) >= 60.0


# -- inverse CWT --------------------------------------------------------------

def _band_limited(n, seed=4):
    t = np.arange(n) / SFREQ
    rng = np.random.default_rng(seed)
    return (np.sin(2 * np.pi * 31.25 * t) + 0.5 * np.cos(2 * np.pi * 62.5 * t)
            + 0.01 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("support_floor", [0.0, 1e-3])
def test_icwt_matches_jax_and_round_trips(support_floor):
    n = 1024
    freqs = np.arange(5.0, 200.0, 2.5)
    bank = _bank(freqs, n, interpolate=False)
    sig = _band_limited(n)
    coeffs = tcwt.cwt_from_bank(torch.from_numpy(sig),
                                torch.from_numpy(bank), False)
    got = ticwt.icwt_from_bank(coeffs, torch.from_numpy(bank),
                               support_floor=support_floor)
    want = np.asarray(jicwt.icwt_from_bank(
        jcwt.cwt_from_bank(jnp.asarray(sig), jnp.asarray(bank), False),
        jnp.asarray(bank), support_floor=support_floor))
    assert got.dtype == torch.complex64
    assert _rel(got.numpy(), want) <= 1e-5
    # The bank covers the tones: the real part comes back.
    t = np.arange(n) / SFREQ
    clean = np.sin(2 * np.pi * 31.25 * t) + 0.5 * np.cos(2 * np.pi * 62.5 * t)
    assert np.abs(got.real.numpy() - clean)[100:-100].max() < 0.1


def test_icwt_complex_signal_and_coverage():
    n = 512
    bank = _bank(np.arange(10.0, 100.0, 5.0), n, interpolate=False)
    z = (_band_limited(n) + 1j * _band_limited(n, seed=5)).astype(
        np.complex64)
    coeffs = tcwt.cwt_from_bank(torch.from_numpy(z), torch.from_numpy(bank))
    got = ticwt.icwt_from_bank(coeffs, torch.from_numpy(bank),
                               real_signal=False)
    want = np.asarray(jicwt.icwt_from_bank(
        jcwt.cwt_from_bank(jnp.asarray(z), jnp.asarray(bank)),
        jnp.asarray(bank), real_signal=False))
    assert _rel(got.numpy(), want) <= 1e-5
    assert _rel(ticwt.coverage(torch.from_numpy(bank)).numpy(),
                np.asarray(jicwt.coverage(jnp.asarray(bank)))) <= 1e-6


# -- denoising ----------------------------------------------------------------

@pytest.mark.parametrize("method", ["soft", "hard"])
@pytest.mark.parametrize("n", [1024, 1023])
def test_denoise_matches_jax(method, n):
    """n = 1023 takes the median's odd branch; 1024 its mean of the two
    middle values (``jnp.median``'s rule)."""
    freqs = np.arange(5.0, 200.0, 2.5)
    bank = _bank(freqs, n, interpolate=False)
    sig = _signals((2, n), seed=6, tone=31.25, noise=0.5)
    got = tdenoise.denoise(torch.from_numpy(sig), torch.from_numpy(bank),
                           method=method, threshold_scale=0.8)
    want = np.asarray(jax_denoise(sig, bank, method=method,
                                       threshold_scale=0.8))
    assert got.shape == (2, n) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= 1e-5


def test_denoise_rejects_unknown_methods():
    with pytest.raises(ValueError, match="soft"):
        tdenoise.denoise_from_bank(torch.zeros(256), torch.ones(3, 256),
                                   method="median")


def test_wavelet_denoise_matches_jax():
    jw = nw.Morse(SFREQ)
    tw = wavelet_from_jax(jw, device="cpu")
    freqs = np.arange(5.0, 200.0, 2.5)
    sig = _signals((1024,), seed=7, tone=31.25, noise=0.5)
    got = tw.denoise(sig, freqs, method="soft")
    want = np.asarray(jw.denoise(sig, freqs, method="soft"))
    assert _rel(got.numpy(), want) <= 1e-5
    with pytest.raises(ValueError, match="real signal"):
        tw.denoise(sig + 1j * sig, freqs)
