"""Grids, spectra and bank synthesis of the PyTorch port against the JAX
package (same inputs, max|d| / max <= 1e-5) and against the float64 oracle
``reference_oracle.py`` (SNR > 90 dB, the gate of ``test_parity.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reference_oracle as oracle

import ninwavelets_tpu as nw
import ninwavelets_tpu_torch as nt
from ninwavelets_tpu.ops import bank as jbank
from ninwavelets_tpu.ops import grids as jgrids
from ninwavelets_tpu.ops import signal_utils as jsig
from ninwavelets_tpu.ops import spectra as jspec
from ninwavelets_tpu_torch import convert
from ninwavelets_tpu_torch.ops import bank as tbank
from ninwavelets_tpu_torch.ops import grids as tgrids
from ninwavelets_tpu_torch.ops import signal_utils as tsig
from ninwavelets_tpu_torch.ops import spectra as tspec

from torch_threads import one_torch_thread  # noqa: F401

SFREQ = 1000.0
RTOL = 1e-5
FAMILIES = {
    "morse": lambda m, **kw: m.Morse(SFREQ, **kw),
    "morlet": lambda m, **kw: m.Morlet(SFREQ, **kw),
    "shannon": lambda m, **kw: m.Shannon(SFREQ, **kw),
    "mexican_hat": lambda m, **kw: m.MexicanHat(SFREQ, **kw),
    "haar": lambda m, **kw: m.Haar(SFREQ, **kw),
}


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    return np.abs(got - want).max() / (scale if scale else 1.0)


@pytest.mark.parametrize("n", [1024, 2048])
def test_grids_match_jax(n):
    assert _rel(tgrids.fft_bin_freqs(n, SFREQ),
                jgrids.fft_bin_freqs(n, SFREQ)) == 0.0
    assert np.array_equal(np.asarray(tgrids.analytic_mask(n)),
                          np.asarray(jgrids.analytic_mask(n)))
    assert int(tgrids.analytic_mask(n).sum()) == n // 2
    for freq, peak in [(7.0, 1.0), (40.0, 6.97)]:
        assert _rel(tgrids.wavelet_timeline(SFREQ, freq, peak),
                    jgrids.wavelet_timeline(SFREQ, freq, peak)) <= RTOL
        assert _rel(tgrids.reverse_timeline(SFREQ, freq, n / SFREQ),
                    jgrids.reverse_timeline(SFREQ, freq, n / SFREQ)) <= RTOL


@pytest.mark.parametrize("m,n", [(7, 12), (8, 13), (10, 10), (12, 7)])
def test_pad_semantics_match_jax(m, n):
    """Head-truncate when longer, center-pad with the extra zero on the
    tail when shorter."""
    x = np.random.default_rng(m).standard_normal((2, m)).astype(np.float32)
    got = tsig.pad_last_axis_to(torch.from_numpy(x), n).numpy()
    np.testing.assert_array_equal(got, np.asarray(jsig.pad_last_axis_to(x, n)))
    np.testing.assert_array_equal(
        tsig.pad_to(torch.from_numpy(x), torch.zeros(n)).numpy(), got)
    if m < n:
        assert got[0, (n - m) // 2] == x[0, 0]


def test_size_error_is_an_exception():
    with pytest.raises(tsig.SizeError, match="boom"):
        raise tsig.SizeError("boom")


def _spectra_cases():
    grid = np.arange(2048, dtype=np.float32) * (SFREQ / 2048)
    t = np.linspace(-8.0, 8.0, 501, dtype=np.float32)
    return [
        ("morse", grid, lambda m, g: m.morse_spectrum(g, 10.0, 17.5, 3.0)),
        ("morse_b5", grid, lambda m, g: m.morse_spectrum(g, 60.0, 5.0, 2.0)),
        ("taper0", grid,
         lambda m, g: m.morse_taper_spectrum(g, 10.0, order=0)),
        ("taper2", grid,
         lambda m, g: m.morse_taper_spectrum(g, 10.0, order=2)),
        ("morlet", grid, lambda m, g: m.morlet_spectrum(g, 10.0, 7.0)),
        ("gabor", grid,
         lambda m, g: m.morlet_spectrum(g, 10.0, 7.0, gabor=True)),
        ("morlet_time", t, lambda m, g: m.morlet_time(g, 7.0)),
        ("mexican_hat", t, lambda m, g: m.mexican_hat_time(g, 7.0)),
        ("shannon", grid, lambda m, g: m.shannon_spectrum(g, 10.0)),
        ("haar", t, lambda m, g: m.haar_time(g)),
    ]


@pytest.mark.parametrize("name,x,fn", _spectra_cases(),
                         ids=[c[0] for c in _spectra_cases()])
def test_spectra_match_jax(name, x, fn):
    got = fn(tspec, torch.from_numpy(x)).numpy()
    want = np.asarray(fn(jspec, jnp.asarray(x)))
    assert got.dtype == want.dtype
    assert _rel(got, want) <= RTOL, name


def test_morse_log_space_survives_float32_overflow():
    """``w ** b`` overflows float32 at w > ~148 for b = 17.5: the log-space
    form must give finite values (0 far above the peak)."""
    grid = torch.arange(0, 1000, dtype=torch.float32)
    out = tspec.morse_spectrum(grid, 1.0)
    assert bool(torch.isfinite(out).all())
    assert float(out[0]) == 0.0 and float(out[500]) == 0.0
    assert float(out[1]) == pytest.approx(2.0)


def test_morlet_norm_quirk():
    """``c`` uses exp(-sigma**2), not the textbook exp(-sigma**2 / 2)."""
    assert tspec.morlet_norm_constants(2.0) == jspec.morlet_norm_constants(
        2.0)
    c, k = tspec.morlet_norm_constants(2.0, gabor=True)
    assert c == pytest.approx((1 + np.exp(-4.0) - 2 * np.exp(-3.0)) ** -0.5)
    assert k == 0.0


def _banks(family, interpolate, n):
    jw = FAMILIES[family](nw)
    jw.interpolate = interpolate
    tw = convert.wavelet_from_jax(jw, device="cpu")
    freqs = np.arange(1.0, 100.0, 7.0, dtype=np.float32)    # F = 15
    want = np.asarray(jbank.make_fft_bank(
        jw._wdef(), jnp.asarray(freqs), n, SFREQ, interpolate,
        jw.real_wave_length))
    got = tbank.make_fft_bank(tw._wdef(), freqs, n, SFREQ, interpolate,
                              tw.real_wave_length).numpy()
    return freqs, got, want


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("interpolate", [False, True])
def test_make_fft_bank_matches_jax_and_oracle(family, interpolate):
    n = 1024
    freqs, got, want = _banks(family, interpolate, n)
    assert got.dtype == want.dtype
    assert got.dtype == (np.complex64 if family in ("mexican_hat", "haar")
                         else np.float32)
    assert _rel(got, want) <= RTOL
    ref = oracle.make_bank(family, freqs, n, SFREQ, interpolate)
    assert oracle.snr_db(ref, got) > 90.0
    if interpolate:
        assert not np.any(got[:, n // 2:])


@pytest.mark.parametrize("family", ["morse", "morlet", "mexican_hat"])
def test_make_fft_bank_n2048(family):
    freqs, got, want = _banks(family, True, 2048)
    assert _rel(got, want) <= RTOL


def test_twice_quirks():
    """Normal/Twice rows are abs-of-parts (both parts >= 0) and their FFT is
    sized by the constructor's real_wave_length, then pad_to the signal."""
    jw, tw = nw.MexicanHat(SFREQ, real_wave_length=0.5), nt.MexicanHat(
        SFREQ, real_wave_length=0.5, device="cpu")
    freqs = np.array([5.0, 20.0], np.float32)
    got = tbank.make_fft_bank(tw._wdef(), freqs, 1024, SFREQ, False, 0.5)
    want = np.asarray(jbank.make_fft_bank(jw._wdef(), jnp.asarray(freqs),
                                          1024, SFREQ, False, 0.5))
    assert _rel(got.numpy(), want) <= RTOL
    assert bool((got.real >= 0).all()) and bool((got.imag >= 0).all())
    # 500-sample spectrum center-padded into 1024: 262 zeros on the head.
    assert not got[:, :262].any() and got[:, 262].abs().max() > 0


def test_twice_mode_reverse_family():
    """A Reverse formula run in Twice mode goes through the time-domain
    iFFT path (the reverse timeline) before the abs-of-parts FFT."""
    jw, tw = nw.Morse(SFREQ), nt.Morse(SFREQ, device="cpu")
    jw.mode = jbank.WaveletMode.Twice
    tw.mode = tbank.WaveletMode.Twice
    freqs = np.array([10.0, 30.0], np.float32)
    got = tbank.make_fft_bank(tw._wdef(), freqs, 1024, SFREQ, True)
    want = np.asarray(jbank.make_fft_bank(jw._wdef(), jnp.asarray(freqs),
                                          1024, SFREQ, True))
    assert got.dtype == torch.complex64
    assert _rel(got.numpy(), want) <= RTOL


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_single_wavelets_match_jax(family):
    jw, tw = FAMILIES[family](nw), FAMILIES[family](nt, device="cpu")
    assert _rel(tw.make_fft_wavelet(10.0).numpy(),
                np.asarray(jw.make_fft_wavelet(10.0))) <= RTOL
    got = tw.make_wavelet(15.0).numpy()
    assert _rel(got, np.asarray(jw.make_wavelet(15.0))) <= RTOL
    assert oracle.snr_db(oracle.make_time_wavelet(family, 15.0, SFREQ),
                         got) > 80.0
    assert len(tw.make_wavelets([5.0, 15.0])) == 2
