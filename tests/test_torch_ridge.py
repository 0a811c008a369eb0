"""The port's ridges and modes (``ninwavelets_tpu_torch.ops.ridge``,
``WaveletBase.extract_modes``) and the Torrence & Compo statistics
(``ops.tc_stats``) against the JAX package on the same seeded inputs, on the
CPU.

Gates: ridge rows equal (the planes have no ties), refined positions and
modes max|d| / max|ref| <= 1e-4 (the modes are sums of float32 CWT rows
taken along the track), the statistics <= 1e-5 (float32 formulas), the
e-folding times within one sample (XLA's and torch's float32 ``exp`` differ
by ulps, which can move an envelope crossing by a sample, as for the
streaming halo).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ninwavelets_tpu as nw
from ninwavelets_tpu.ops import ridge as jridge
from ninwavelets_tpu.ops import tc_stats as jtc
from ninwavelets_tpu.ops.bank import make_fft_bank as jbank
from ninwavelets_tpu_torch.convert import wavelet_from_jax
from ninwavelets_tpu_torch.ops import cwt as tcwt
from ninwavelets_tpu_torch.ops import ridge as tridge
from ninwavelets_tpu_torch.ops import tc_stats as ttc

SFREQ = 1000.0
N = 1024
FREQS = np.arange(10.0, 130.0, 4.0)


def _bank(freqs=FREQS, n=N, interpolate=False):
    return np.array(jbank(nw.Morse(SFREQ)._wdef(),
                          jnp.asarray(freqs, jnp.float32), n, SFREQ,
                          interpolate), np.float32)


def _two_modes(seed=0):
    """A 30 -> 50 Hz chirp plus a weaker 100 Hz tone and noise."""
    t = np.arange(N) / SFREQ
    rng = np.random.default_rng(seed)
    chirp = np.sin(2 * np.pi * (30.0 * t + 10.0 * t * t))
    return (chirp + 0.5 * np.sin(2 * np.pi * 100.0 * t)
            + 0.05 * rng.standard_normal(N)).astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _plane(sig, bank):
    return tcwt.power_from_bank(torch.from_numpy(sig), torch.from_numpy(bank))


@pytest.mark.parametrize("penalty", [0.0, 0.5, 4.0])
def test_extract_ridge_matches_jax(penalty):
    plane = _plane(_two_modes(), _bank())
    idx, pos = tridge.extract_ridge(plane, penalty)
    j_idx, j_pos = jridge.extract_ridge(jnp.asarray(plane.numpy()), penalty)
    assert idx.dtype == torch.int32 and pos.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    assert _rel(pos.numpy(), j_pos) <= 1e-4


def test_ridge_follows_the_chirp_and_matches_the_viterbi_oracle():
    """The forward-backward path scores as well as the JAX package's
    sequential Viterbi oracle, and tracks the 30 -> 50 Hz chirp."""
    plane = _plane(_two_modes(seed=1), _bank())
    log_e = torch.log(torch.clamp(plane, min=1e-30))
    got = tridge._ridge_indices(log_e, 0.5).numpy()
    oracle = np.asarray(jridge._ridge_indices_seq(jnp.asarray(log_e.numpy()),
                                                  0.5))

    def score(path):
        le = log_e.numpy().astype(np.float64)
        return (le[path, np.arange(N)].sum()
                - 0.5 * (np.diff(path.astype(np.float64)) ** 2).sum())

    assert abs(score(got) - score(oracle)) <= 1e-6 * abs(score(oracle))
    hz = tridge.ridge_frequencies(plane, FREQS, 0.5)
    assert hz.shape == (N,)
    np.testing.assert_allclose(hz, jridge.ridge_frequencies(
        jnp.asarray(plane.numpy()), FREQS, 0.5), rtol=1e-5)
    inst = 30.0 + 20.0 * np.arange(N) / SFREQ
    assert np.abs(hz - inst)[100:-100].max() < 4.0


@pytest.mark.parametrize("interpolate", [False, True])
def test_extract_modes_matches_jax(interpolate):
    sig = _two_modes(seed=2)
    bank = _bank(interpolate=interpolate)
    modes, tracks, resid = tridge.extract_modes(
        torch.from_numpy(sig), torch.from_numpy(bank), n_modes=2,
        interpolate=interpolate)
    j_modes, j_tracks, j_resid = jridge.extract_modes(
        jnp.asarray(sig), jnp.asarray(bank), n_modes=2,
        interpolate=interpolate)
    assert modes.shape == tracks.shape == (2, N) and resid.shape == (N,)
    assert _rel(modes.numpy(), j_modes) <= 1e-4
    assert _rel(tracks.numpy(), j_tracks) <= 1e-4
    assert _rel(resid.numpy(), j_resid) <= 1e-4


def test_wavelet_extract_modes_matches_jax():
    jw = nw.Morse(SFREQ)
    tw = wavelet_from_jax(jw, device="cpu")
    sig = _two_modes(seed=3)
    got = tw.extract_modes(sig, FREQS, n_modes=2)
    want = jw.extract_modes(sig, FREQS, n_modes=2)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) <= 1e-4
    got_ri = tridge.extract_modes_ri(torch.from_numpy(sig),
                                     tw.fft_wavelets, n_modes=2)
    torch.testing.assert_close(got_ri[0], got[0])
    with pytest.raises(ValueError, match="one"):
        tw.extract_modes(np.stack([sig, sig]), FREQS)
    with pytest.raises(ValueError, match="real signal"):
        tw.extract_modes(sig + 1j * sig, FREQS)


# -- Torrence & Compo statistics ----------------------------------------------

def _red_noise(alpha=0.7, n=4096, seed=4):
    rng = np.random.default_rng(seed)
    x = np.zeros(n)
    e = rng.standard_normal(n)
    for i in range(1, n):
        x[i] = alpha * x[i - 1] + e[i]
    return x.astype(np.float32)


def test_ar1_and_red_noise_spectrum_match_jax():
    x = _red_noise()
    alpha = ttc.ar1_coefficient(x)
    assert alpha == jtc.ar1_coefficient(x)
    assert 0.6 < alpha < 0.8
    assert ttc.ar1_coefficient(np.zeros(16)) == 0.0
    got = ttc.red_noise_spectrum(FREQS, SFREQ, alpha)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), jtc.red_noise_spectrum(FREQS, SFREQ, alpha)) \
        <= 1e-6


@pytest.mark.parametrize("n_epochs", [1, 5])
def test_significance_matches_jax(n_epochs):
    bank = _bank(interpolate=True)
    x = _red_noise(n=N)
    alpha, var = ttc.ar1_coefficient(x), float(np.var(x))
    tb = torch.from_numpy(bank)
    assert _rel(ttc.background_power(tb, SFREQ, alpha, var).numpy(),
                jtc.background_power(bank, SFREQ, alpha, var)) <= 1e-5
    thr = ttc.significance_level(tb, SFREQ, alpha, var, 0.95, n_epochs)
    j_thr = np.asarray(jtc.significance_level(bank, SFREQ, alpha, var, 0.95,
                                              n_epochs))
    assert _rel(thr.numpy(), j_thr) <= 1e-5
    power = tcwt.power_from_bank(torch.from_numpy(x), tb, True)
    mask = ttc.significant_mask(power, tb, SFREQ, alpha, var, 0.95, n_epochs)
    j_mask = np.asarray(jtc.significant_mask(power.numpy(), bank, SFREQ,
                                             alpha, var, 0.95, n_epochs))
    clear = np.abs(power.numpy() - j_thr[:, None]) > 1e-4 * j_thr[:, None]
    np.testing.assert_array_equal(mask.numpy()[clear], j_mask[clear])


def test_global_spectrum_and_coi_match_jax():
    wdef = nw.Morse(SFREQ)._wdef()
    twdef = wavelet_from_jax(nw.Morse(SFREQ), device="cpu")._wdef()
    efold = ttc.efolding_times(twdef, FREQS, SFREQ)
    j_efold = jtc.efolding_times(wdef, FREQS, SFREQ)
    assert np.abs(efold - j_efold).max() <= 1.0 / SFREQ
    coi = ttc.coi_mask(N, SFREQ, j_efold)
    np.testing.assert_array_equal(coi, jtc.coi_mask(N, SFREQ, j_efold))
    power = _plane(_two_modes(seed=5), _bank())
    assert _rel(ttc.global_spectrum(power).numpy(),
                jtc.global_spectrum(power.numpy())) <= 1e-6
    assert _rel(ttc.global_spectrum(power, torch.from_numpy(coi)).numpy(),
                jtc.global_spectrum(power.numpy(), coi)) <= 1e-6


def test_itc_inference_matches_jax():
    itc = torch.from_numpy(np.random.default_rng(6).uniform(
        0, 1, (3, 50)).astype(np.float32))
    assert _rel(ttc.itc_pvalue(itc, 20).numpy(),
                jtc.itc_pvalue(itc.numpy(), 20)) <= 1e-6
    assert ttc.itc_threshold(0.05, 20) == jtc.itc_threshold(0.05, 20)
    assert ttc._chi2_ppf(0.95, 10) == jtc._chi2_ppf(0.95, 10)
