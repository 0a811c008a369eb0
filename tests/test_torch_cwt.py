"""The port's plain CWT path (``ninwavelets_tpu_torch.ops.cwt``) against
``ninwavelets_tpu.ops.cwt`` on the same inputs: max|d| / max|ref| <= 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ninwavelets_tpu as nw
from ninwavelets_tpu.ops import cwt as jcwt
from ninwavelets_tpu.ops.bank import make_fft_bank as jbank
from ninwavelets_tpu_torch.ops import cwt as tcwt

from torch_threads import one_torch_thread  # noqa: F401

SFREQ = 1000.0
RTOL = 1e-5


def _inputs(n=1024, e=3, c=2, f=12, complex_bank=False, seed=0):
    w = nw.MexicanHat(SFREQ) if complex_bank else nw.Morse(SFREQ)
    bank = np.array(jbank(w._wdef(), jnp.arange(2.0, 2.0 + 4 * f, 4.0), n,
                          SFREQ, False))
    sig = np.random.default_rng(seed).standard_normal((e, c, n)).astype(
        np.float32)
    return sig, bank


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    return np.abs(got - want).max() / np.abs(want).max()


def assert_itc_close(got, want, coeffs):
    """ITC within RTOL on cells where every epoch's |c| is at least 1e-2 of
    its row maximum, and within 2e-3 elsewhere: the unit phase of a
    coefficient near zero is round-off (the near-zero caveat of
    ``ninwavelets_tpu.ops.fused.fused_itc_from_bank``).  NaN masks equal."""
    mag = np.abs(np.asarray(coeffs))                       # (E, C, F, N)
    sound = mag.min(0) >= 1e-2 * mag.max(axis=(0, 3))[..., None]
    assert np.array_equal(np.isnan(got), np.isnan(want))
    d = np.nan_to_num(np.abs(got - want))
    assert d[sound].max() <= RTOL, d[sound].max()
    assert d.max() <= 2e-3, d.max()


@pytest.mark.parametrize("interpolate", [False, True])
@pytest.mark.parametrize("n", [1024, 2048])
def test_analytic_spectrum_matches_jax(interpolate, n):
    sig, _ = _inputs(n=n)
    got = tcwt.analytic_spectrum(torch.from_numpy(sig), interpolate).numpy()
    want = np.asarray(jcwt.analytic_spectrum(jnp.asarray(sig), interpolate))
    assert _rel(got, want) <= RTOL
    if interpolate:     # Nyquist bin and above are zero
        assert not np.any(got[..., n // 2:])


def test_analytic_spectrum_of_complex_signal_is_masked():
    sig, _ = _inputs()
    z = sig + 1j * sig[::-1]
    got = tcwt.analytic_spectrum(torch.from_numpy(z.astype(np.complex64)),
                                 True).numpy()
    want = np.asarray(jcwt.analytic_spectrum(jnp.asarray(z, jnp.complex64),
                                             True))
    assert _rel(got, want) <= RTOL


@pytest.mark.parametrize("name", ["cwt", "power", "abs"])
@pytest.mark.parametrize("interpolate", [False, True])
@pytest.mark.parametrize("complex_bank", [False, True])
def test_per_signal_transforms_match_jax(name, interpolate, complex_bank):
    sig, bank = _inputs(complex_bank=complex_bank)
    fn = {"cwt": "cwt_from_bank", "power": "power_from_bank",
          "abs": "abs_from_bank"}[name]
    got = getattr(tcwt, fn)(torch.from_numpy(sig), torch.from_numpy(bank),
                            interpolate).numpy()
    want = np.asarray(getattr(jcwt, fn)(jnp.asarray(sig), jnp.asarray(bank),
                                        interpolate))
    assert got.shape == sig.shape[:-1] + bank.shape
    assert _rel(got, want) <= RTOL


@pytest.mark.parametrize("interpolate", [False, True])
@pytest.mark.parametrize("complex_bank", [False, True])
@pytest.mark.parametrize("e", [1, 5])
def test_epoch_reductions_match_jax(interpolate, complex_bank, e):
    sig, bank = _inputs(e=e, complex_bank=complex_bank, n=2048 if e == 1
                        else 1024)
    ts, tb = torch.from_numpy(sig), torch.from_numpy(bank)
    js, jb = jnp.asarray(sig), jnp.asarray(bank)
    got = tcwt.mean_power_from_bank(ts, tb, interpolate).numpy()
    want = np.asarray(jcwt.mean_power_from_bank(js, jb, interpolate))
    assert got.shape == (sig.shape[1], bank.shape[0], sig.shape[2])
    assert _rel(got, want) <= RTOL
    got = tcwt.itc_from_bank(ts, tb, interpolate).numpy()
    want = np.asarray(jcwt.itc_from_bank(js, jb, interpolate))
    assert_itc_close(got, want, tcwt.cwt_from_bank(ts, tb, interpolate))


def test_itc_eps_floor_matches_jax():
    sig, bank = _inputs()
    sig[:, 1] = 0.0
    got = tcwt.itc_from_bank(torch.from_numpy(sig), torch.from_numpy(bank),
                             True, eps=1e-6).numpy()
    want = np.asarray(jcwt.itc_from_bank(jnp.asarray(sig), jnp.asarray(bank),
                                         True, eps=1e-6))
    assert np.isfinite(got).all() and np.all(got[1] == 0.0)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("interpolate", [False, True])
def test_zero_channel_itc_is_nan_in_both(interpolate):
    """At eps=0 an exactly-zero coefficient gives 0/0 = NaN (the
    reference's behaviour), in both packages."""
    sig, bank = _inputs()
    sig[:, 0] = 0.0
    got = tcwt.itc_from_bank(torch.from_numpy(sig), torch.from_numpy(bank),
                             interpolate).numpy()
    want = np.asarray(jcwt.itc_from_bank(jnp.asarray(sig), jnp.asarray(bank),
                                         interpolate))
    assert np.isnan(got[0]).all() and np.isnan(want[0]).all()
    assert np.isfinite(got[1]).all()
    np.testing.assert_allclose(got[1], want[1], rtol=RTOL, atol=RTOL)


def test_identical_epochs_have_unit_itc():
    sig, bank = _inputs(e=4)
    sig[:] = sig[0]
    got = tcwt.itc_from_bank(torch.from_numpy(sig), torch.from_numpy(bank),
                             True).numpy()
    np.testing.assert_allclose(got, 1.0, atol=1e-5)
