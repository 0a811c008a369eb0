"""The port's single-trial smoothed wavelet coherence, its AR(1) Monte-Carlo
significance levels and the wavelet entropy (``ninwavelets_tpu_torch.ops.
extensions``), ``RawWavelet.coherence`` and ``EpochsWavelet.
wavelet_entropy``, against the JAX package on the same seeded inputs, on
the CPU.  No function here reaches a Pallas kernel in the JAX package.

The two packages draw their AR(1) noise from different generators, so the
tests feed the port's ``_wtc_null`` the JAX package's own (2, S, N) noise,
``jax.random.normal(PRNGKey(seed), (2, S, N))``.

Gates, each with its reason:

* coherence, entropy and levels against JAX: max|d| / max|ref| <= 1e-4
  (float32 FFTs and products in another order); the levels are quantiles
  of coherences in [0, 1], so 1e-4 of their max;
* the smoothed phase: ``atan2`` of the smoothed cross-spectrum z moves by
  at most |dz| / |z|, so each cell is held at 1e-4 max|z| / |z| radians;
* the blocked AR(1) filter (``ar1_filter``, blocks of 128 samples, a
  carry at every level) against a float64 recurrence: max|d| <= 1e-5
  max|x| sqrt(min(1 / (1 - alpha), N)).  The round-off of each block
  product (1e-5 covers a 128-term float32 sum) adds up as a random walk
  over the filter's memory, 1 / (1 - alpha) samples, or all N of them;
  alpha runs to 0.999999, ``tc_stats.ar1_coefficient``'s clip.  Against the
  JAX package's sequential float32 ``lax.scan`` at the same gate;
* the row quantile against ``numpy.quantile(method="linear")`` on a row
  of 2^24 + 3 elements (past ``torch.quantile``'s limit): within 4 float32
  ulps of the value (the interpolation's rounding);
* validation errors: same type and message as JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import ninwavelets_tpu as nw
from ninwavelets_tpu.ops import extensions as jext
from ninwavelets_tpu.ops.bank import make_fft_bank as jbank
from ninwavelets_tpu.ops.bank import make_fft_bank_ri
import ninwavelets_tpu_torch as nt
from ninwavelets_tpu_torch.convert import wavelet_from_jax
from ninwavelets_tpu_torch.ops import extensions as text

from torch_threads import one_torch_thread  # noqa: F401

SFREQ = 1000.0
RTOL = 1e-4
FREQS = np.arange(10.0, 40.0, 5.0)             # F = 6


def _bank(freqs, n, interpolate=True, family="Morse"):
    return np.array(jbank(getattr(nw, family)(SFREQ)._wdef(),
                          jnp.asarray(np.asarray(freqs, np.float32)), n,
                          SFREQ, interpolate))


def _t(x):
    return torch.from_numpy(np.array(x))


def assert_rel(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    d = np.nanmax(np.abs(got - want))
    assert d <= rtol * np.nanmax(np.abs(want)), d


def _pair(n=1024, seed=1, batch=()):
    """A shared 20 Hz tone plus 0.5 noise in each of two signals."""
    rng = np.random.default_rng(seed)
    shared = np.sin(2 * np.pi * 20 * np.arange(n) / SFREQ)
    a = shared + 0.5 * rng.standard_normal(batch + (n,))
    b = shared + 0.5 * rng.standard_normal(batch + (n,))
    return a.astype(np.float32), b.astype(np.float32)


# -- the smoothed wavelet coherence -------------------------------------------

@pytest.mark.parametrize("interpolate", [True, False])
@pytest.mark.parametrize("batch", [(), (3,)])
def test_wavelet_coherence_matches_jax(interpolate, batch):
    a, b = _pair(batch=batch)
    bank = _bank(FREQS, 1024, interpolate)
    got, phase = text.wavelet_coherence(_t(a), _t(b), _t(bank), FREQS,
                                        SFREQ, interpolate, cycles=1.5,
                                        scale_width=0.8, return_phase=True)
    want, want_phase = jext.wavelet_coherence(
        a, b, bank, FREQS, SFREQ, interpolate=interpolate, cycles=1.5,
        scale_width=0.8, return_phase=True)
    assert_rel(got, want)
    # The phase gate: |d atan2(z)| <= 1e-4 max|z| / |z|, z the smoothed
    # cross-spectrum (the port's own, from the public pieces).
    f_grid = _t(FREQS.astype(np.float32))
    x = (text.cwt_from_bank(_t(a), _t(bank), interpolate)
         * torch.conj(text.cwt_from_bank(_t(b), _t(bank), interpolate)))
    sm = text._coherence_smooth(torch.stack([x.real, x.imag])
                                * f_grid[:, None], f_grid, SFREQ, 1.5, 0.8)
    z = np.hypot(sm[0].numpy(), sm[1].numpy()).astype(np.float64)
    d = np.angle(np.exp(1j * (phase.numpy() - np.asarray(want_phase))))
    assert (np.abs(d) <= RTOL * z.max() / z).all()


def test_wavelet_coherence_complex_bank_matches_jax():
    a, b = _pair(n=512, seed=2)
    jw = nw.MexicanHat(SFREQ, interpolate=False)
    br, bi = make_fft_bank_ri(jw._wdef(), jnp.asarray(FREQS, jnp.float32),
                              512, SFREQ, False, 1.0)
    bank = np.asarray(br) + 1j * np.asarray(bi)
    got = text.wavelet_coherence(_t(a), _t(b), _t(bank.astype(np.complex64)),
                                 FREQS, SFREQ)
    want = jext.wavelet_coherence(a, b, np.asarray(br), FREQS, SFREQ,
                                  bank_i=np.asarray(bi))
    assert_rel(got, want)


def test_wavelet_coherence_of_a_signal_with_itself_is_one():
    a, _ = _pair(seed=3)
    bank = _t(_bank(FREQS, 1024))
    coh = text.wavelet_coherence(_t(a), _t(a), bank, FREQS, SFREQ, True)
    np.testing.assert_allclose(coh.numpy(), 1.0, atol=1e-5)


# -- wavelet entropy ----------------------------------------------------------

@pytest.mark.parametrize("normalized", [True, False])
def test_wavelet_entropy_matches_jax(normalized):
    p = np.random.default_rng(8).random((5, 6, 9)).astype(np.float32)
    p[0, :, 0] = 0.0                            # an all-zero column
    p[1, 2] = 0.0                               # a dead band
    got = text.wavelet_entropy(_t(p), normalized)
    assert_rel(got, jext.wavelet_entropy(p, normalized))
    assert torch.equal(text.wavelet_entropy(p, normalized, device="cpu"),
                       got)


def test_wavelet_entropy_of_one_band_is_zero():
    p = np.random.default_rng(0).random((3, 1, 7)).astype(np.float32)
    got = text.wavelet_entropy(_t(p))
    assert torch.equal(got, torch.zeros(3, 7))
    assert np.array_equal(np.asarray(jext.wavelet_entropy(p)),
                          np.zeros((3, 7)))


def test_wavelet_entropy_flat_and_peaked():
    flat = torch.ones(4, 10, 7)
    torch.testing.assert_close(text.wavelet_entropy(flat),
                               torch.ones(4, 7), rtol=1e-5, atol=1e-6)
    peak = torch.zeros(10, 7)
    peak[3] = 1.0
    assert torch.equal(text.wavelet_entropy(peak), torch.zeros(7))


# -- the blocked AR(1) filter -------------------------------------------------

def _ar1_64(alpha, e):
    x = np.zeros(e.shape, np.float64)
    prev = np.zeros(e.shape[:-1])
    for t in range(e.shape[-1]):
        prev = alpha * prev + e[..., t]
        x[..., t] = prev
    return x


def _ar1_jax(alpha, e):
    """The JAX package's sequential float32 recurrence
    (``extensions._wtc_null_jit``)."""
    def step(x, v):
        x = alpha * x + v
        return x, x

    return np.asarray(lax.scan(step, jnp.zeros(e.shape[0]),
                               jnp.asarray(e).T)[1].T)


@pytest.mark.parametrize("alpha", [0.0, 0.5, 0.9, 0.999, 0.999999])
@pytest.mark.parametrize("n", [1, 100, 128, 1000, 20000])
def test_ar1_filter_matches_the_recurrence(alpha, n):
    e = np.random.default_rng(n).standard_normal((3, n)).astype(np.float32)
    got = text.ar1_filter(alpha, _t(e)).numpy()
    want = _ar1_64(np.float32(alpha), e.astype(np.float64))
    gate = 1e-5 * np.abs(want).max() * np.sqrt(min(1.0 / (1.0 - alpha), n))
    assert np.abs(got - want).max() <= gate
    scan = _ar1_jax(np.float32(alpha), e)
    assert np.abs(got - scan).max() <= gate


# -- the row quantile ---------------------------------------------------------

def test_row_quantile_past_the_torch_quantile_limit():
    m = (1 << 24) + 3
    x = np.random.default_rng(0).standard_normal(m).astype(np.float32)
    for q in (0.95, 0.5, 0.01):
        got = float(text.row_quantile(_t(x), q))
        want = float(np.quantile(x, q, method="linear"))
        assert abs(got - want) <= 4 * np.spacing(np.float32(abs(want)))


@pytest.mark.parametrize("m", [1, 2, 7, 1000])
def test_row_quantile_matches_jax(m):
    x = np.random.default_rng(m).random((4, m)).astype(np.float32)
    for q in (0.0, 0.3, 0.95, 1.0):
        got = text.row_quantile(_t(x), q).numpy()
        want = np.asarray(jnp.quantile(jnp.asarray(x), q, axis=-1,
                                       method="linear"))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# -- the Monte-Carlo significance levels --------------------------------------

@pytest.mark.parametrize("interpolate", [True, False])
def test_wtc_null_matches_jax_on_its_noise(interpolate):
    n, s = 512, 12
    bank = _bank(FREQS, n, interpolate)
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(4), (2, s, n),
                                         jnp.float32))
    f_grid = FREQS.astype(np.float32)
    want = jext._wtc_null_jit(jnp.asarray(bank), jnp.asarray(f_grid),
                              jnp.asarray(noise), jnp.float32(0.6),
                              jnp.float32(0.3), sfreq=SFREQ,
                              interpolate=interpolate, cycles=1.0,
                              scale_width=0.6, eps=1e-12, q=0.9,
                              n_surrogates=s)
    got = text._wtc_null(_t(bank), _t(f_grid), _t(noise), 0.6, 0.3, SFREQ,
                         interpolate, q=0.9)
    assert got.shape == (FREQS.size,)
    assert_rel(got, want)


def test_wtc_significance_levels_and_known_answer():
    """A shared 20 Hz tone is coherent above its red-noise level, an
    uncoupled row mostly below (``tests/test_envelope.py``)."""
    a, b = _pair(seed=1)
    bank = _t(_bank(FREQS, 1024))
    wtc = text.wavelet_coherence(_t(a), _t(b), bank, FREQS, SFREQ, True)
    thr = text.wtc_significance(a, b, bank, FREQS, SFREQ, n_surrogates=50,
                                interpolate=True)
    assert thr.shape == (6,)
    assert bool(((0.3 < thr) & (thr < 0.999)).all())
    assert float((wtc[2] > thr[2]).float().mean()) > 0.9
    assert float((wtc[5] > thr[5]).float().mean()) < 0.35
    again = text.wtc_significance(a, b, bank, FREQS, SFREQ, n_surrogates=50,
                                  interpolate=True)
    other = text.wtc_significance(a, b, bank, FREQS, SFREQ, n_surrogates=50,
                                  interpolate=True, seed=1)
    assert torch.equal(thr, again) and not torch.equal(thr, other)
    host = text.wtc_significance(a, b, bank.numpy(), FREQS, SFREQ,
                                 n_surrogates=50, interpolate=True,
                                 device="cpu")
    assert torch.equal(host, thr)


# -- the adapters -------------------------------------------------------------

class _Raw:
    """The duck-typed raw surface: ``info``, ``ch_names``, ``get_data``."""

    def __init__(self, data):
        self.info = {"sfreq": SFREQ}
        self.ch_names = ["a", "b"]
        self._data = data

    def get_data(self):
        return self._data


def _raw_data(n=512, seed=9):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SFREQ
    return (np.sin(2 * np.pi * 20 * t)[None]
            + 0.3 * rng.standard_normal((2, n))).astype(np.float32)


@pytest.mark.parametrize("interpolate", [True, False])
def test_raw_coherence_matches_jax(interpolate):
    data = _raw_data()
    jw = nw.Morse(SFREQ, interpolate=interpolate)
    jr = nw.RawWavelet(_Raw(data), jw, window=256)
    tr = nt.RawWavelet(_Raw(data), wavelet_from_jax(jw, device="cpu"),
                       window=256)
    got, phase = tr.coherence("a", "b", FREQS, cycles=2.0, return_phase=True)
    want, _ = jr.coherence("a", "b", FREQS, cycles=2.0, return_phase=True)
    assert_rel(got, want)
    assert phase.shape == got.shape == (6, 512)
    wtc, thr = tr.coherence("a", "b", FREQS, significance=20, seed=3)
    assert torch.equal(wtc, tr.coherence("a", "b", FREQS))
    bank = nt.ops.make_fft_bank(tr.wavelet._wdef(), FREQS, 512, SFREQ,
                                interpolate, device="cpu")
    assert torch.equal(thr, text.wtc_significance(
        data[0], data[1], bank, FREQS, SFREQ, n_surrogates=20, seed=3,
        interpolate=interpolate))
    assert (wtc[2] > thr[2]).float().mean() > 0.8
    coh, ph, thr3 = tr.coherence("a", "b", FREQS, return_phase=True,
                                 significance=5)
    assert thr3.shape == (6,) and ph.shape == coh.shape


def test_raw_coherence_significance_needs_a_real_bank():
    data = _raw_data(n=256)
    jr = nw.RawWavelet(_Raw(data), nw.MexicanHat(SFREQ), window=256)
    tr = nt.RawWavelet(_Raw(data), nt.MexicanHat(SFREQ, device="cpu"),
                       window=256)
    assert_rel(tr.coherence("a", "b", FREQS), jr.coherence("a", "b", FREQS))
    for raw in (jr, tr):
        with pytest.raises(ValueError, match="significance levels need an "
                           "analytic"):
            raw.coherence("a", "b", FREQS, significance=5)


def test_adapter_wavelet_entropy_matches_jax():
    data = _raw_data()[None]
    jw = nw.Morse(SFREQ)
    jew = nw.EpochsWavelet(nw.ArrayEpochs(data, SFREQ, ch_names=["a", "b"]),
                           jw)
    tew = nt.EpochsWavelet(nt.ArrayEpochs(data, SFREQ, ch_names=["a", "b"]),
                           wavelet_from_jax(jw, device="cpu"))
    got = tew.wavelet_entropy("a", FREQS)
    assert_rel(got, jew.wavelet_entropy("a", FREQS))
    assert_rel(tew.wavelet_entropy("b", FREQS, normalized=False),
               jew.wavelet_entropy("b", FREQS, normalized=False))
    assert got.shape == (512,)
    assert bool(((got >= 0) & (got <= 1 + 1e-5)).all())
