"""The port's pair-connectivity path (``ninwavelets_tpu_torch.ops.extensions``,
``ops.connectivity``, the pair wrappers of ``ops.fused`` and the
``EpochsWavelet`` pair and matrix methods) against the JAX package on the
same seeded inputs, on the CPU.

The JAX Pallas kernel's cross-pair epilogues run in interpret mode at
``precision="exact"``; the port's pair wrappers run their plain sums (the
tensors lie on the CPU).  The CUDA kernel itself (``csrc/fused_pair.cu``)
is held against those plain sums on the card by ``chip_smoke.py``.

Gates, each with its reason:

* coherence, imaginary coherency, the phase slope index, the coherence
  sums and the phase-lag sums: max|d| / max|ref| <= 1e-4, NaN masks equal;
* unit-phase statistics (PLV, PPC): within 1e-5 on sound cells (every
  epoch's |a| and |b| at least 1e-2 of their row maximum) and 2e-3
  elsewhere, the ITC rule of ``tests/test_torch_cwt.py``: the unit phase of
  a coefficient near zero is round-off.  PPC's gates are scaled by
  2E / (E - 1), the most its derivative in PLV reaches;
* the sign counts behind PLI (sum sign(Im)): at most 1e-4 of the cells
  differ, each by at most 2 per epoch whose |Im| lies within 1e-5 of
  |a| max|b| + |b| max|a| of 0 (float64 coefficients, the maxima over the
  epoch's row): a sign flip moves the sum by 2, a flip to a pinned 0 by 1;
* NaN masks equal everywhere, self-pairs included: both packages pin
  Im(a conj b) to 0 where its two rounded products agree.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ninwavelets_tpu as nw
from ninwavelets_tpu.ops import connectivity as jconn
from ninwavelets_tpu.ops import extensions as jext
from ninwavelets_tpu.ops import fused as jfused
from ninwavelets_tpu.ops.bank import make_fft_bank as jbank
import ninwavelets_tpu_torch as nt
from ninwavelets_tpu_torch import kernels
from ninwavelets_tpu_torch.convert import wavelet_from_jax
from ninwavelets_tpu_torch.ops import connectivity as tconn
from ninwavelets_tpu_torch.ops import extensions as text
from ninwavelets_tpu_torch.ops import fused as tfused

from torch_threads import one_torch_thread  # noqa: F401

SFREQ = 1000.0
RTOL = 1e-4
UNIT_SOUND, UNIT_ELSE = 1e-5, 2e-3
SIGN_ROUNDOFF, SIGN_CELLS = 1e-5, 1e-4
FREQS = np.arange(8.0, 70.0, 4.0)          # F = 16
LAYOUTS = [("pairs", 8), ("pairs", 5), ("single", 5)]


def _bank(freqs, n, interpolate=True, family="Morse"):
    return np.array(jbank(getattr(nw, family)(SFREQ)._wdef(),
                          jnp.asarray(np.asarray(freqs, np.float32)), n,
                          SFREQ, interpolate))


def _pairs(layout="pairs", e=5, c=2, n=1024, seed=0):
    """Channel a and a channel b that is 0.6 x a lagged 5 samples plus 0.8
    x its own noise, float32: (E, C, N) pairs or a single (E, N) pair."""
    rng = np.random.default_rng(seed)
    shape = (e, c, n) if layout == "pairs" else (e, n)
    a = rng.standard_normal(shape)
    b = 0.6 * np.roll(a, 5, -1) + 0.8 * rng.standard_normal(shape)
    return a.astype(np.float32), b.astype(np.float32)


def _tone_pairs(e=6, n=1024, lag=1.0, seed=0):
    """A 40 Hz tone with a random phase per epoch plus 0.3 noise, and the
    same tone ``lag`` radians later plus its own noise: (E, 1, N)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SFREQ
    pa = rng.uniform(0, 2 * np.pi, (e, 1, 1))
    a = np.sin(2 * np.pi * 40 * t + pa) + 0.3 * rng.standard_normal((e, 1, n))
    b = (np.sin(2 * np.pi * 40 * t + pa + lag)
         + 0.3 * rng.standard_normal((e, 1, n)))
    return a.astype(np.float32), b.astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in arrays]


def _coeffs64(sig, bank, interpolate):
    """(E, ..., F, N) float64 coefficients: the reference for the rules."""
    n = sig.shape[-1]
    spec = np.fft.fft(np.asarray(sig, np.float64))
    if interpolate:
        spec[..., n // 2:] = 0.0
    return np.fft.ifft(spec[..., None, :] * np.asarray(bank, np.complex128))


def assert_rel(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    d = np.abs(got[fin] - want[fin]).max() if fin.any() else 0.0
    scale = np.abs(want[fin]).max() if fin.any() else 0.0
    assert d <= rtol * scale, (d, scale)


def assert_unit_close(got, want, wa, wb, scale=1.0):
    """The unit-phase gates of the module docstring; ``wa``, ``wb`` are the
    float64 coefficients of the two channels."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    sound = np.ones(got.shape, bool)
    for w in (wa, wb):
        mag = np.abs(w)
        sound &= mag.min(0) >= 1e-2 * mag.max(axis=(0, -1))[..., None]
    d = np.nan_to_num(np.abs(got - want))
    assert d[sound].max(initial=0.0) <= scale * UNIT_SOUND
    assert d.max() <= scale * UNIT_ELSE


def assert_sign_sums_close(got, want, wa, wb):
    """The sign-count rule of the module docstring."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    d = np.abs(got - want)
    assert (d > 0).sum() <= SIGN_CELLS * d.size, int((d > 0).sum())
    im = (wa * np.conj(wb)).imag
    ma = np.abs(wa).max(-1, keepdims=True)
    mb = np.abs(wb).max(-1, keepdims=True)
    near = np.abs(im) <= SIGN_ROUNDOFF * (np.abs(wa) * mb + np.abs(wb) * ma)
    assert (d <= 2 * near.sum(0)).all()


# -- the plain path against the JAX package -----------------------------------

@pytest.mark.parametrize("layout,e", LAYOUTS)
@pytest.mark.parametrize("interpolate", [True, False])
def test_coherence_family_matches_jax(interpolate, layout, e):
    a, b = _pairs(layout, e)
    bank = _bank(FREQS, a.shape[-1], interpolate)
    ta, tb, tk = _t(a, b, bank)
    for got, want in zip(text.coherence_sums(ta, tb, tk, interpolate),
                         jext.coherence_sums(a, b, bank, interpolate)):
        assert_rel(got, want)
    for got, want in zip(text.cross_power_from_bank(ta, tb, tk, interpolate),
                         jext.cross_power_from_bank(a, b, bank, interpolate)):
        assert_rel(got, want)
    for eps in (0.0, 1e-12):
        got = text.epoch_coherence(ta, tb, tk, interpolate, eps)
        assert got.shape == a.shape[1:-1] + (len(FREQS), a.shape[-1])
        assert_rel(got, jext.epoch_coherence(a, b, bank,
                                             interpolate=interpolate,
                                             eps=eps))
        assert_rel(text.imcoh(ta, tb, tk, interpolate, eps),
                   jext.imcoh(a, b, bank, interpolate=interpolate, eps=eps))
    for band, normalize in ((None, True), ((2, 11), True), (None, False)):
        assert_rel(text.psi(ta, tb, tk, band, interpolate, 1e-12, normalize),
                   jext.psi(a, b, bank, band=band, interpolate=interpolate,
                            normalize=normalize))


@pytest.mark.parametrize("eps", [0.0, 0.05])
@pytest.mark.parametrize("layout,e", LAYOUTS)
@pytest.mark.parametrize("interpolate", [True, False])
def test_plv_and_ppc_match_jax(interpolate, layout, e, eps):
    a, b = _pairs(layout, e, seed=1)
    bank = _bank(FREQS, a.shape[-1], interpolate)
    ta, tb, tk = _t(a, b, bank)
    wa, wb = _coeffs64(a, bank, interpolate), _coeffs64(b, bank, interpolate)
    for got, want in zip(tconn.plv_sums(ta, tb, tk, interpolate, eps),
                         jconn.plv_sums(a, b, bank, interpolate, eps)):
        assert_unit_close(got / e, np.asarray(want) / e, wa, wb)
    assert_unit_close(tconn.plv(ta, tb, tk, interpolate, eps),
                      jconn.plv(a, b, bank, interpolate, eps), wa, wb)
    assert_unit_close(tconn.ppc(ta, tb, tk, interpolate, eps),
                      jconn.ppc(a, b, bank, interpolate, eps), wa, wb,
                      scale=2 * e / (e - 1))


@pytest.mark.parametrize("eps", [0.0, 1e-3])
@pytest.mark.parametrize("layout,e", LAYOUTS)
@pytest.mark.parametrize("interpolate", [True, False])
def test_phase_lag_matches_jax(interpolate, layout, e, eps):
    a, b = _pairs(layout, e, seed=2)
    bank = _bank(FREQS, a.shape[-1], interpolate)
    ta, tb, tk = _t(a, b, bank)
    got = tconn.phase_lag_sums(ta, tb, tk, interpolate)
    want = jconn.phase_lag_sums(a, b, bank, interpolate)
    for i in (0, 1, 3):
        assert_rel(got[i], want[i])
    assert_sign_sums_close(got[2], want[2], _coeffs64(a, bank, interpolate),
                           _coeffs64(b, bank, interpolate))
    for method in ("wpli", "dwpli"):
        assert_rel(tconn.phase_lag(ta, tb, tk, method, interpolate, eps),
                   jconn.phase_lag(a, b, bank, method, interpolate, eps))
    pli = tconn.phase_lag(ta, tb, tk, "pli", interpolate, eps).numpy()
    want_pli = np.asarray(jconn.phase_lag(a, b, bank, "pli", interpolate,
                                          eps))
    assert np.abs(pli - want_pli).max() <= (
        np.abs(got[2].numpy() - np.asarray(want[2])).max() / e)
    with pytest.raises(ValueError, match="method"):
        tconn.phase_lag_from_sums(got, e, "nope")


@pytest.mark.parametrize("interpolate", [True, False])
def test_self_pair_and_zero_channel_match_jax(interpolate):
    """A channel against itself: both packages pin Im to exact 0, so wPLI
    and dwPLI are 0/0 = NaN (0 with an eps floor) and PLI is exactly 0; a
    zero channel gives PLV NaN in both."""
    a, _ = _pairs("pairs", 6, c=3, seed=3)
    b = a.copy()
    b[:, 2] = 0.0
    bank = _bank(FREQS, a.shape[-1], interpolate)
    ta, tb, tk = _t(a, b, bank)
    for method in ("wpli", "dwpli"):
        got = tconn.phase_lag(ta, tb, tk, method, interpolate).numpy()
        want = np.asarray(jconn.phase_lag(a, b, bank, method, interpolate))
        assert np.isnan(got).all() and np.isnan(want).all()
        assert (tconn.phase_lag(ta, tb, tk, method, interpolate, 1e-12)
                == 0).all()
    assert (tconn.phase_lag(ta, tb, tk, "pli", interpolate) == 0).all()
    got = tconn.plv(ta, tb, tk, interpolate).numpy()
    want = np.asarray(jconn.plv(a, b, bank, interpolate))
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[2]).all() and not np.isnan(got[:2]).any()
    np.testing.assert_allclose(got[:2], 1.0, rtol=0, atol=1e-5)


@pytest.mark.parametrize("time_range", [None, (100, 400)])
@pytest.mark.parametrize("interpolate", [True, False])
def test_matrices_match_jax(interpolate, time_range):
    rng = np.random.default_rng(4)
    sig = rng.standard_normal((6, 4, 512)).astype(np.float32)
    sig[:, 1] = 0.7 * np.roll(sig[:, 0], 3, -1) + 0.7 * sig[:, 1]
    bank = _bank(FREQS[:8], 512, interpolate)
    ts, tk = _t(sig, bank)
    kw = dict(interpolate=interpolate, time_range=time_range)
    got = tconn.plv_matrix(ts, tk, **kw)
    assert got.shape == (8, 4, 4)
    assert_rel(got, jconn.plv_matrix(sig, bank, **kw))
    assert_rel(tconn.ppc_matrix(ts, tk, **kw),
               jconn.ppc_matrix(sig, bank, **kw))
    for eps in (0.0, 1e-12):
        assert_rel(tconn.coherence_matrix(ts, tk, eps=eps, **kw),
                   jconn.coherence_matrix(sig, bank, eps=eps, **kw))
    for method in tconn.PHASE_LAG_METHODS:
        got = tconn.wpli_matrix(ts, tk, method, **kw).numpy()
        want = np.asarray(jconn.wpli_matrix(sig, bank, method, **kw))
        if method == "pli":
            assert np.array_equal(np.isnan(got), np.isnan(want))
            assert np.nanmax(np.abs(got - want)) <= 1e-2   # a few flips
        else:
            assert_rel(got, want)
            assert np.isnan(np.diagonal(got, axis1=1, axis2=2)).all()
    with pytest.raises(ValueError, match="method"):
        tconn.wpli_matrix(ts, tk, "nope")


@pytest.mark.parametrize("time_range", [(100, 600), (-5, 10), (300, 200)])
def test_wpli_matrix_refuses_a_window_outside_the_signal(time_range):
    # JAX's (C, C, stop - start) epoch sums fail to broadcast against the
    # sliced coefficients; the port says why, before any transform.
    rng = np.random.default_rng(4)
    sig = rng.standard_normal((3, 4, 512)).astype(np.float32)
    bank = _bank(FREQS[:2], 512, True)
    ts, tk = _t(sig, bank)
    with pytest.raises(TypeError):
        jconn.wpli_matrix(sig, bank, interpolate=True, time_range=time_range)
    with pytest.raises(ValueError, match="time_range"):
        tconn.wpli_matrix(ts, tk, interpolate=True, time_range=time_range)


@pytest.mark.parametrize("unit", [False, True])
def test_pair_sums_and_scan_match_jax(unit):
    rng = np.random.default_rng(5)
    sig = rng.standard_normal((5, 3, 256)).astype(np.float32)
    bank = _bank(FREQS[:6], 256)
    w = (rng.standard_normal((5, 3, 64))
         + 1j * rng.standard_normal((5, 3, 64))).astype(np.complex64)
    for got, want in zip(tconn._pair_sums(torch.from_numpy(w)),
                         jconn._pair_sums(jnp.asarray(w))):
        assert_rel(got, want, 1e-5)

    def per_row(sr, si):
        return sr.sum(-1) - 2.0 * si.sum(-1)

    got = tconn.pair_matrix_scan(*_t(sig, bank), per_row, True, unit=unit,
                                 time_range=(10, 200))
    want = jconn.pair_matrix_scan(jnp.asarray(sig), jnp.asarray(bank),
                                  per_row, True, unit=unit,
                                  time_range=(10, 200))
    assert got.shape == (6, 3, 3)
    assert_rel(got, want, 1e-5)


def test_complex_bank_coherence_matches_jax():
    """Normal/Twice-mode (MexicanHat) banks are complex: coherence and
    imcoh take them on the plain path in both packages."""
    a, b = _pairs("pairs", 5)
    bank = _bank(FREQS, 1024, True, "MexicanHat").astype(np.complex64)
    ta, tb, tk = _t(a, b, bank)
    br, bi = np.real(bank).copy(), np.imag(bank).copy()
    assert_rel(text.epoch_coherence_auto(ta, tb, tk, True),
               jext.epoch_coherence_auto(a, b, br, bi, interpolate=True))
    assert_rel(text.imcoh_auto(ta, tb, tk, True),
               jext.imcoh_auto(a, b, br, bi, interpolate=True))
    sig = np.concatenate([a, b], 1)
    assert_rel(tconn.coherence_matrix(torch.from_numpy(sig), tk, True),
               jconn.coherence_matrix(sig, br, bi, interpolate=True))


# -- the JAX Pallas kernel against the port's wrappers ------------------------
# Self-pairs are left out here: the Pallas "phaselag" epilogue does not pin
# Im to 0, so a self-pair's statistics are amplified round-off there.

@pytest.mark.parametrize("e,n", [(4, 2048), (4, 1024), (8, 2048)])
@pytest.mark.parametrize("interpolate", [True, False])
def test_fused_coherence_matches_pallas(interpolate, e, n):
    a, b = _pairs("pairs", e, n=n, seed=6)
    b = (0.6 * a + 0.8 * b).astype(np.float32)
    bank = _bank(np.arange(1.0, 14.0) * 7.0, n, interpolate).astype(
        np.float32)
    want = np.asarray(jfused.fused_epoch_coherence(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(bank), interpolate,
        interpret=True, precision="exact"))
    got = tfused.fused_epoch_coherence(*_t(a, b, bank), interpolate).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("e", [4, 7])
def test_fused_plv_matches_pallas(e):
    a, b = _pairs("pairs", e, n=2048, seed=7)
    b = (0.6 * a + 0.8 * b).astype(np.float32)
    bank = _bank(np.arange(1.0, 14.0) * 7.0, 2048).astype(np.float32)
    want = np.asarray(jfused._plv_from_sums(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(bank), True, True,
        "exact"))
    got = tfused._plv_from_sums(*_t(a, b, bank), True, "fast3").numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-3,
                               atol=1e-4)


@pytest.mark.parametrize("stat", ["wpli", "dwpli", "ppc", "imcoh"])
def test_fused_lag_statistics_match_pallas(stat):
    a, b = _tone_pairs(e=6, lag=1.0)
    a = np.concatenate([a, 0.5 * a], 1)
    b = np.concatenate([b, np.roll(b, 3, -1)], 1)
    bank = _bank(np.arange(20.0, 80.0, 4.0), 1024).astype(np.float32)
    ja, jb, jk = jnp.asarray(a), jnp.asarray(b), jnp.asarray(bank)
    ta, tb, tk = _t(a, b, bank)
    kw = dict(interpolate=True)
    if stat == "ppc":
        want = jfused.fused_ppc(ja, jb, jk, interpret=True,
                                precision="exact", **kw)
        got = tfused.fused_ppc(ta, tb, tk, **kw)
    elif stat == "imcoh":
        want = jfused.fused_imcoh(ja, jb, jk, interpret=True,
                                  precision="exact", **kw)
        got = tfused.fused_imcoh(ta, tb, tk, **kw)
    else:
        want = jfused.fused_phase_lag(ja, jb, jk, method=stat,
                                      interpret=True, precision="exact", **kw)
        got = tfused.fused_phase_lag(ta, tb, tk, method=stat, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


# -- what surrounds the kernel, with the kernel replaced by its contract ------

def emulated_pair(epilogue, spec_a, spec_b, bank, k_bins):
    """The contract of ``kernels.fused_cwt_pair``: the epoch sums of the
    epilogue's planes of a = ifft(bank x spectrum a) and b likewise (the
    first ``k_bins`` bins of each spectrum row), each (C, F, N)."""
    n = bank.shape[-1]

    def coeffs(spec):
        s = torch.nn.functional.pad(spec[..., :k_bins], (0, n - k_bins))
        return torch.fft.ifft(s[:, :, None] * bank)

    wa, wb = coeffs(spec_a), coeffs(spec_b)
    if epilogue == "coherence":
        x = wa * wb.conj()
        planes = (x.real, x.imag, wa.abs() ** 2, wb.abs() ** 2)
    elif epilogue == "phaselag":
        p, q = wa.imag * wb.real, wa.real * wb.imag
        im = torch.where(p == q, torch.zeros_like(p), p - q)
        planes = (im, im.abs(), im.sign(), im * im)
    else:
        u = (wa / wa.abs()) * (wb / wb.abs()).conj()
        planes = (u.real, u.imag)
    return [x.sum(0) for x in planes]


@pytest.fixture
def contract_pair(monkeypatch):
    calls = []

    def fake(epilogue, spec_a, spec_b, bank, k_bins):
        calls.append((epilogue, tuple(spec_a.shape), tuple(spec_b.shape),
                      bank.dtype, k_bins))
        return emulated_pair(epilogue, spec_a, spec_b, bank, k_bins)

    monkeypatch.setattr(kernels, "fused_cwt_pair", fake)
    return calls


@pytest.mark.parametrize("epilogue", ["coherence", "phaselag", "plv"])
@pytest.mark.parametrize("interpolate", [True, False])
def test_pair_launch_around_the_kernel(contract_pair, epilogue, interpolate):
    """Both spectra (an rFFT of N/2 + 1 bins read to N/2 on the analytic
    path, the full FFT otherwise), a float32 bank, one launch for any E,
    and planes equal to the plain sums: the 1/N scale is the plain path's."""
    a, b = _pairs("pairs", 7, c=3, n=512, seed=8)
    bank = _bank(FREQS, 512, interpolate).astype(np.float32)
    ta, tb, tk = _t(a, b, bank)
    got = tfused._pair_launch(epilogue, ta, tb, tk.double(), interpolate)
    bins = 257 if interpolate else 512
    assert contract_pair == [(epilogue, (7, 3, bins), (7, 3, bins),
                              torch.float32, 256 if interpolate else 512)]
    plain = {"coherence": text.coherence_sums,
             "phaselag": tconn.phase_lag_sums,
             "plv": tconn.plv_sums}[epilogue](ta, tb, tk, interpolate)
    assert len(got) == len(plain) == kernels.PAIR_PLANES[epilogue]
    for i, (g, p) in enumerate(zip(got, plain)):
        if epilogue == "phaselag" and i == 2:
            assert (g - p).abs().max() <= 2.0       # a rare sign flip
        elif epilogue == "plv":                     # the unit-phase gates
            assert_unit_close(g.numpy() / 7, p.numpy() / 7,
                              _coeffs64(a, bank, interpolate),
                              _coeffs64(b, bank, interpolate))
        else:
            torch.testing.assert_close(g, p, rtol=1e-5, atol=1e-5 * float(
                p.abs().max()), equal_nan=True)


def test_pair_launch_rejects_what_the_kernel_does_not_take(contract_pair):
    a, b = _t(*_pairs("pairs", 3, n=512))
    bank = torch.from_numpy(_bank(FREQS, 512).astype(np.float32))
    for sa, sb, bk in [(a, b[:2], bank),                    # shapes differ
                       (a[:, 0], b[:, 0], bank),            # an (E, N) pair
                       (a, b.to(torch.complex64), bank),    # complex b
                       (a, b, bank.to(torch.complex64)),    # complex bank
                       (a[..., :500], b[..., :500], bank)]:
        with pytest.raises(ValueError, match="supports"):
            tfused._pair_launch("plv", sa, sb, bk, True)
    assert contract_pair == []


def test_pair_launcher_rejects_before_any_build(monkeypatch):
    def no_build():
        raise AssertionError("the launcher tried to build")
    monkeypatch.setattr(kernels, "_load", no_build)
    spec = torch.zeros((2, 3, 513), dtype=torch.complex64)
    bank = torch.zeros((5, 1024))
    before = dict(kernels.launches)
    for args, match in [
            (("nope", spec, spec, bank, 512), "epilogue"),
            (("plv", spec, spec[:1].contiguous(), bank, 512), "spec_b"),
            (("plv", spec, spec.real.contiguous(), bank, 512), "spec_b"),
            (("coherence", spec, spec, bank, 512), "CUDA"),
            (("phaselag", spec, spec, torch.zeros((5, 1000)), 500),
             "power of")]:
        with pytest.raises(ValueError, match=match):
            kernels.fused_cwt_pair(*args)
    assert kernels.launches == before
    assert {"coherence", "phaselag", "plv"} <= set(kernels.launches)


# -- dispatch -----------------------------------------------------------------

@pytest.fixture
def fused_calls(monkeypatch):
    calls = []
    for name in ("fused_coherence", "fused_imcoh", "fused_plv", "fused_ppc",
                 "fused_phase_lag"):
        real = getattr(tfused, name)

        def record(*args, _name=name, _real=real, **kw):
            calls.append(_name)
            return _real(*args, **kw)

        monkeypatch.setattr(tfused, name, record)
    return calls


def test_auto_dispatch_follows_the_jax_rules(fused_calls):
    """(E, C, N) real pairs take the wrappers; (E, N) pairs, complex banks
    (coherence, imcoh) and eps > 0 (plv, ppc) take the plain path;
    phase_lag takes the wrapper at any eps.  Either way the result is the
    plain statistic on the CPU."""
    a, b = _t(*_pairs("pairs", 4, n=512, seed=9))
    bank = torch.from_numpy(_bank(FREQS, 512).astype(np.float32))
    cbank = bank.to(torch.complex64)
    assert tfused.route("coherence", a, bank).takes
    assert not tfused.route("coherence", a[:, 0], bank).takes
    assert not tfused.route("coherence", a.to(torch.complex64), bank).takes
    assert not tfused.route("coherence", a, cbank).takes
    assert not tfused.route("coherence", a[..., :500], bank).takes
    cases = [
        (lambda: text.epoch_coherence_auto(a, b, bank, True),
         "fused_coherence", text.epoch_coherence(a, b, bank, True)),
        (lambda: text.epoch_coherence_auto(a, b, cbank, True), None,
         text.epoch_coherence(a, b, cbank, True)),
        (lambda: text.epoch_coherence_auto(a[:, 0], b[:, 0], bank, True),
         None, text.epoch_coherence(a[:, 0], b[:, 0], bank, True)),
        (lambda: text.imcoh_auto(a, b, bank, True), "fused_imcoh",
         text.imcoh(a, b, bank, True)),
        (lambda: text.imcoh_auto(a, b, cbank, True), None,
         text.imcoh(a, b, cbank, True)),
        (lambda: tconn.plv_auto(a, b, bank, True), "fused_plv",
         tconn.plv(a, b, bank, True)),
        (lambda: tconn.plv_auto(a, b, bank, True, eps=0.1), None,
         tconn.plv(a, b, bank, True, 0.1)),
        (lambda: tconn.ppc_auto(a, b, bank, True), "fused_ppc",
         tconn.ppc(a, b, bank, True)),
        (lambda: tconn.ppc_auto(a, b, bank, True, eps=0.1), None,
         tconn.ppc(a, b, bank, True, 0.1)),
        (lambda: tconn.phase_lag_auto(a, b, bank, "dwpli", True, eps=0.1),
         "fused_phase_lag", tconn.phase_lag(a, b, bank, "dwpli", True, 0.1)),
        (lambda: tconn.phase_lag_auto(a[:, 0], b[:, 0], bank, "pli", True),
         None, tconn.phase_lag(a[:, 0], b[:, 0], bank, "pli", True)),
    ]
    for run, wrapper, want in cases:
        fused_calls.clear()
        got = run()
        assert fused_calls == ([wrapper] if wrapper else [])
        torch.testing.assert_close(got, want, equal_nan=True)


# -- the adapter --------------------------------------------------------------

def _adapters(family="Morse", e=6, c=3, n=1024, seed=10):
    a, b = _pairs("pairs", e, c=c, n=n, seed=seed)
    data = np.concatenate([a, b[:, :1]], 1)
    jw = getattr(nw, family)(SFREQ, interpolate=True)
    return (data, nw.EpochsWavelet(nw.ArrayEpochs(data, SFREQ), jw),
            nt.EpochsWavelet(nt.ArrayEpochs(data, SFREQ),
                             wavelet_from_jax(jw, device="cpu")))


def test_adapter_pair_methods_match_jax():
    data, jew, tew = _adapters()
    bank = _bank(FREQS, data.shape[-1])
    wa = _coeffs64(data[:, 0], bank, True)
    wb = _coeffs64(data[:, 3], bank, True)
    e = data.shape[0]
    pair = ("ch0", "ch3", FREQS)
    assert_unit_close(tew.plv(*pair), jew.plv(*pair), wa, wb)
    assert_unit_close(tew.ppc(*pair), jew.ppc(*pair), wa, wb,
                      scale=2 * e / (e - 1))
    for name in ("coherence", "imcoh", "wpli", "psi"):
        got = getattr(tew, name)(*pair)
        assert got.shape == ((data.shape[-1],) if name == "psi"
                             else (len(FREQS), data.shape[-1]))
        assert_rel(got, getattr(jew, name)(*pair))
    assert_rel(tew.psi(*pair, band=(3, 12)), jew.psi(*pair, band=(3, 12)))
    assert_rel(tew.phase_lag(*pair, method="dwpli"),
               jew.phase_lag(*pair, method="dwpli"))
    got = tew.pli(*pair).numpy()
    assert np.abs(got - np.asarray(jew.pli(*pair))).max() <= 2.0 / e
    assert_rel(tew.plv(*pair, eps=0.05), jew.plv(*pair, eps=0.05), 1e-3)
    with pytest.raises(ValueError, match="ascending"):
        tew.psi("ch0", "ch3", FREQS[::-1])


@pytest.mark.parametrize("time_range", [None, (0.1, 0.4)])
def test_adapter_matrices_match_jax(time_range):
    data, jew, tew = _adapters(c=2, n=512)
    freqs = FREQS[:6]
    for name in ("plv_matrix", "ppc_matrix", "coherence_matrix"):
        got = getattr(tew, name)(freqs, time_range=time_range)
        assert got.shape == (6, 3, 3)
        assert_rel(got, getattr(jew, name)(freqs, time_range=time_range))
    for method in ("wpli", "dwpli"):
        assert_rel(tew.wpli_matrix(freqs, method, time_range),
                   jew.wpli_matrix(freqs, method, time_range))
    assert tew._samples(time_range) == jew._samples(time_range)


def test_adapter_phase_metrics_need_a_real_bank():
    data, jew, tew = _adapters("MexicanHat", n=512)
    for name in ("plv", "wpli", "ppc"):
        with pytest.raises(ValueError, match="real-bank"):
            getattr(tew, name)("ch0", "ch1", FREQS)
    with pytest.raises(ValueError, match="real-bank"):
        tew.plv_matrix(FREQS)
    assert_rel(tew.coherence("ch0", "ch1", FREQS),
               jew.coherence("ch0", "ch1", FREQS))
    assert_rel(tew.coherence_matrix(FREQS[:4]),
               jew.coherence_matrix(FREQS[:4]))
