"""The port's conditional and global connectivity matrices
(``ninwavelets_tpu_torch.ops.connectivity``: partial coherence, the phase
slope index matrix, the Kuramoto order; ``ops.multitaper``: multitaper
partial coherence; ``ops.envelope``: envelope correlations; and their
``EpochsWavelet`` methods) against the JAX package on the same seeded
inputs, on the CPU.  No function here reaches a Pallas kernel in the JAX
package, so both sides run their plain code.

Gates, each with its reason:

* every statistic against JAX: max|d| / max|ref| <= 1e-4 (float32 FFTs and
  sums in another order).  Partial coherence inverts the (C, C)
  cross-spectral matrix, which multiplies the relative round-off of S by
  its condition number; on these inputs (a chain of three channels, lam =
  1e-5) that number is below 1e2, so the inverse keeps the 1e-4 gate, and
  the test asserts the condition number it relies on;
* the Kuramoto order and the envelope correlations take unit phases or
  logs of powers: a coefficient near zero makes its unit phase round-off,
  so their gate is 1e-4 of the max like the rest, which these inputs pass
  with room (no epoch's coefficient is zero);
* PSI and partial coherence against the float64 oracles of
  ``tests/test_connectivity.py`` at those tests' own tolerances (PSI atol
  2e-3 unnormalized; partial coherence rtol 2e-2, atol 2e-3);
* PSI's diagonal exactly 0, pinned by ``* (1 - eye)`` in both packages;
* ``multitaper_coherence_matrix`` on ``_mt_pair_scan`` bit-identical to its
  former inline loop (same operations in the same order);
* the validation errors: same type and message as JAX's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ninwavelets_tpu as nw
from ninwavelets_tpu.ops import connectivity as jconn
from ninwavelets_tpu.ops import envelope as jenv
from ninwavelets_tpu.ops import multitaper as jmt
from ninwavelets_tpu.ops.bank import make_fft_bank as jbank
import ninwavelets_tpu_torch as nt
from ninwavelets_tpu_torch.convert import wavelet_from_jax
from ninwavelets_tpu_torch.ops import connectivity as tconn
from ninwavelets_tpu_torch.ops import envelope as tenv
from ninwavelets_tpu_torch.ops import multitaper as tmt
from ninwavelets_tpu_torch.ops.connectivity import _pair_sums
from ninwavelets_tpu_torch.ops.cwt import analytic_spectrum

from torch_threads import one_torch_thread  # noqa: F401

SFREQ = 1000.0
RTOL = 1e-4
PCOH_FREQS = np.arange(16.0, 64.0, 6.0)          # F = 8
PSI_FREQS = np.arange(16.0, 80.0, 4.0)           # F = 16


def _bank(freqs, n, interpolate=True):
    return np.array(jbank(nw.Morse(SFREQ)._wdef(),
                          jnp.asarray(np.asarray(freqs, np.float32)), n,
                          SFREQ, interpolate))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def assert_rel(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    d = np.nanmax(np.abs(got - want))
    assert d <= rtol * np.nanmax(np.abs(want)), d


def _chain(e=24, n=1024, seed=0):
    """x1 = z, x2 = z + e2, x3 = x2 + e3: coh(1, 3) is high, but x1 and x3
    are independent given x2 (``tests/test_connectivity.py``)."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((e, n))
    e2 = 0.5 * rng.standard_normal((e, n))
    e3 = 0.5 * rng.standard_normal((e, n))
    return np.stack([z, z + e2, z + e2 + e3], axis=1).astype(np.float32)


def _delayed(e=16, n=1024, delay=8, seed=0):
    """ch0 leads ch1 by ``delay`` samples; ch2 independent noise."""
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((e, n + delay))
    x = np.stack([s[:, delay:], s[:, :n], rng.standard_normal((e, n))],
                 axis=1)
    x += 0.2 * rng.standard_normal(x.shape)
    return x.astype(np.float32)


# -- the complex solve --------------------------------------------------------

def test_solve_complex_matches_numpy():
    rng = np.random.default_rng(0)
    a = (rng.standard_normal((4, 5, 5)) + 1j * rng.standard_normal((4, 5, 5))
         + 5 * np.eye(5)).astype(np.complex64)
    b = (rng.standard_normal((4, 5, 2))
         + 1j * rng.standard_normal((4, 5, 2))).astype(np.complex64)
    got = tconn._solve_complex(_t(a), _t(b)).numpy()
    want = np.linalg.solve(a.astype(np.complex128), b.astype(np.complex128))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# -- partial coherence --------------------------------------------------------

@pytest.mark.parametrize("interpolate", [True, False])
@pytest.mark.parametrize("time_range", [None, (100, 900)])
def test_partial_coherence_matches_jax(interpolate, time_range):
    x = _chain(e=8, seed=1)
    bank = _bank(PCOH_FREQS, x.shape[-1], interpolate)
    # The gate's premise: the cross-spectral matrices are well conditioned.
    spec = np.fft.fft(x.astype(np.float64))
    for row in bank:
        w = np.fft.ifft(spec * row)
        s = np.einsum("ean,ebn->ab", w, w.conj())
        assert np.linalg.cond(s) < 1e2
    got = tconn.partial_coherence(_t(x), _t(bank), interpolate,
                                  time_range=time_range)
    want = jconn.partial_coherence(x, bank, interpolate,
                                   time_range=time_range)
    assert_rel(got, want)


def test_partial_coherence_matches_float64_oracle():
    x = _chain(e=8, n=1024, seed=1)
    bank = _bank(PCOH_FREQS, 1024, interpolate=False)
    got = tconn.partial_coherence(_t(x), _t(bank), lam=1e-5).numpy()
    spec = np.fft.fft(x.astype(np.float64))
    for f, row in enumerate(bank.astype(np.float64)):
        w = np.fft.ifft(spec * row)
        s = np.einsum("ean,ebn->ab", w, w.conj()) / (8 * 1024)
        s = s + 1e-5 * np.real(np.trace(s)) / 3 * np.eye(3)
        si = np.linalg.inv(s)
        d = np.real(np.diag(si))
        want = np.abs(si) ** 2 / (d[:, None] * d[None, :])
        np.testing.assert_allclose(got[f], want, rtol=2e-2, atol=2e-3)


def test_partial_coherence_removes_the_mediated_link():
    x = _chain()
    bank = _t(_bank(PCOH_FREQS, x.shape[-1], interpolate=False))
    pc = tconn.partial_coherence(_t(x), bank).mean(0).numpy()
    coh = tconn.coherence_matrix(_t(x), bank).mean(0).numpy()
    assert coh[0, 2] > 0.5 and pc[0, 2] < 0.1
    assert pc[0, 1] > 20 * pc[0, 2] and pc[1, 2] > 20 * pc[0, 2]
    np.testing.assert_allclose(np.diagonal(pc), 1.0, atol=1e-4)
    np.testing.assert_allclose(pc, pc.T, atol=1e-5)


def test_partial_coherence_of_a_dead_row_is_nan_in_both_packages():
    """A row with no spectral support (1 Hz at N = 512: bank max 1e-11)
    gives NaN in both packages: the 1e-30 trace floor makes S^-1 ~ 1e35,
    whose square overflows float32 (ROADMAP queue 3).  The port keeps the
    reference's result; the other rows agree at the usual gate."""
    x = np.random.default_rng(0).standard_normal((6, 4, 512)).astype(
        np.float32)
    bank = _bank(np.arange(1.0, 7.0), 512)
    got = tconn.partial_coherence(_t(x), _t(bank), True)
    want = np.asarray(jconn.partial_coherence(x, bank, True))
    assert bool(got[0].isnan().all()) and np.isnan(want[0]).all()
    assert_rel(got[1:], want[1:])


def test_partial_coherence_needs_two_channels():
    bank = _t(_bank(PCOH_FREQS, 256, interpolate=False))
    with pytest.raises(ValueError,
                       match="partial coherence needs at least 2 channels"):
        tconn.partial_coherence_from_bank(torch.zeros(4, 1, 256), bank)


@pytest.mark.parametrize("interpolate", [True, False])
def test_multitaper_partial_coherence_matches_jax(interpolate):
    x = _chain(e=4, n=512, seed=2)
    got = tmt.multitaper_partial_coherence(_t(x), PCOH_FREQS, SFREQ,
                                           n_tapers=3,
                                           interpolate=interpolate)
    want = jmt.multitaper_partial_coherence(x, PCOH_FREQS, SFREQ,
                                            n_tapers=3,
                                            interpolate=interpolate)
    assert_rel(got, want)


def _former_multitaper_coherence_matrix(sigs, freqs, sfreq, n_tapers,
                                        interpolate, eps, time_range):
    """``multitaper_coherence_matrix`` as it was before it moved onto
    ``_mt_pair_scan``: the same loop, inline."""
    n = int(sigs.shape[-1])
    banks = tmt.multitaper_banks(freqs, n, sfreq, 17.5, 3.0, n_tapers,
                                 interpolate, device=sigs.device)
    spec = analytic_spectrum(sigs, interpolate)
    n0, n1 = time_range if time_range is not None else (0, n)
    rows = []
    for bank_f in banks:
        w = torch.fft.ifft(spec[None] * bank_f[:, None, None, :])
        sr, si = _pair_sums(w.reshape(-1, *w.shape[2:])[..., n0:n1])
        s_r, s_i = sr.sum(-1), si.sum(-1)
        p = torch.diagonal(s_r)
        den = p[:, None] * p[None, :]
        den = torch.maximum(den, eps * den.max())
        rows.append((s_r * s_r + s_i * s_i) / den)
    return torch.stack(rows)


@pytest.mark.parametrize("time_range", [None, (64, 448)])
def test_multitaper_coherence_matrix_unchanged_by_the_move(time_range):
    x = _t(_chain(e=3, n=512, seed=3))
    got = tmt.multitaper_coherence_matrix(x, PCOH_FREQS, SFREQ,
                                          time_range=time_range)
    want = _former_multitaper_coherence_matrix(x, PCOH_FREQS, SFREQ, 3,
                                               False, 1e-12, time_range)
    assert torch.equal(got, want)


# -- the phase slope index matrix ---------------------------------------------

@pytest.mark.parametrize("interpolate", [True, False])
@pytest.mark.parametrize("normalize", [True, False])
def test_psi_matrix_matches_jax(interpolate, normalize):
    x = _delayed(e=8)
    bank = _bank(PSI_FREQS, x.shape[-1], interpolate)
    got = tconn.psi_matrix(_t(x), _t(bank), interpolate,
                           normalize=normalize)
    want = jconn.psi_matrix(x, bank, interpolate, normalize=normalize)
    assert_rel(got, want)
    assert torch.equal(torch.diagonal(got), torch.zeros(3))


def test_psi_matrix_matches_float64_oracle():
    x = _delayed(e=8, n=1024)
    bank = _bank(PSI_FREQS, 1024, interpolate=False)
    got = tconn.psi_matrix(_t(x), _t(bank), normalize=False).numpy()
    spec = np.fft.fft(x.astype(np.float64))
    s = np.zeros((bank.shape[0], 3, 3), complex)
    for f, row in enumerate(bank.astype(np.float64)):
        w = np.fft.ifft(spec * row)
        s[f] = np.einsum("ean,ebn->ab", w, w.conj())
    p = np.real(np.einsum("faa->fa", s))
    coh = s / np.sqrt(p[:, :, None] * p[:, None, :])
    want = np.imag(np.sum(coh[:-1].conj() * coh[1:], axis=0))
    np.testing.assert_allclose(got, want, atol=2e-3)


def test_psi_matrix_direction_and_antisymmetry():
    x = _delayed(n=2048)
    bank = _t(_bank(PSI_FREQS, 2048, interpolate=False))
    z = tconn.psi_matrix(_t(x), bank).numpy()
    assert z[0, 1] > 2.0 and z[1, 0] < -2.0
    assert abs(z[0, 2]) < 4.0 and abs(z[1, 2]) < 4.0
    # Antisymmetric up to float32 round-off of z-scores near 1e2.
    np.testing.assert_allclose(z, -z.T, rtol=1e-5, atol=1e-4)
    assert np.array_equal(np.diag(z), np.zeros(3))


def test_psi_reps_scan_complete_hook():
    """``complete`` sees each row's two total sums; the identity gives the
    single-device replicates."""
    x = _t(_delayed(e=5, n=512))
    bank = _t(_bank(PSI_FREQS[:4], 512))
    seen = []

    def complete(t):
        seen.append(tuple(t.shape))
        return t

    got = tconn.psi_reps_scan(x, bank, 0, 512, 5, 1e-12, True, complete)
    want = tconn.psi_reps_scan(x, bank, 0, 512, 5, 1e-12, True)
    assert torch.equal(got, want) and got.shape == (6, 3, 3)
    assert seen == [(3, 3)] * 8


@pytest.mark.parametrize("shape,rows,match", [
    ((1, 2, 256), 4, "psi needs at least 2 epochs"),
    ((4, 2, 256), 1, "psi needs at least 2 bank rows")])
def test_psi_matrix_validation(shape, rows, match):
    bank = _bank(PSI_FREQS[:rows], 256)
    with pytest.raises(ValueError, match=match):
        jconn.psi_matrix_from_bank(jnp.zeros(shape), jnp.asarray(bank))
    with pytest.raises(ValueError, match=match):
        tconn.psi_matrix_from_bank(torch.zeros(shape), _t(bank))


# -- the Kuramoto order -------------------------------------------------------

@pytest.mark.parametrize("interpolate", [True, False])
@pytest.mark.parametrize("mean_epochs", [True, False])
def test_kuramoto_order_matches_jax(interpolate, mean_epochs):
    x = _delayed(e=6, n=512, seed=4)
    bank = _bank(PSI_FREQS, 512, interpolate)
    got = tconn.kuramoto_order(_t(x), _t(bank), interpolate,
                               mean_epochs=mean_epochs)
    want = jconn.kuramoto_order(x, bank, interpolate,
                                mean_epochs=mean_epochs)
    assert_rel(got, want)


def test_kuramoto_order_locked_against_independent():
    rng = np.random.default_rng(5)
    e, c, n = 6, 5, 1024
    t = np.arange(n) / SFREQ
    phase = rng.uniform(0, 2 * np.pi, (e, 1, 1))
    locked = (np.sin(2 * np.pi * 40 * t + phase)
              + 0.1 * rng.standard_normal((e, c, n))).astype(np.float32)
    noise = rng.standard_normal((e, c, n)).astype(np.float32)
    bank = _t(_bank([40.0], n))
    r_locked = tconn.kuramoto_order(_t(locked), bank, True)[0, 200:-200]
    r_noise = tconn.kuramoto_order(_t(noise), bank, True)[0, 200:-200]
    assert float(r_locked.min()) > 0.95
    assert float(r_noise.mean()) < 0.7


# -- envelope correlations ----------------------------------------------------

@pytest.mark.parametrize("orthogonalize", [True, False])
@pytest.mark.parametrize("log", [True, False])
def test_env_corr_matches_jax(orthogonalize, log):
    x = _delayed(e=4, n=512, seed=6)
    bank = _bank(PSI_FREQS[::4], 512)
    got = tenv.env_corr_matrix(_t(x), _t(bank), orthogonalize, True, log,
                               time_range=(32, 480))
    want = jenv.env_corr_matrix(x, bank, orthogonalize, True, log,
                                time_range=(32, 480))
    assert_rel(got, want)
    if orthogonalize:
        assert torch.equal(torch.diagonal(got, dim1=1, dim2=2),
                           torch.zeros(4, 3))


def test_env_corr_seed_chunks(monkeypatch):
    """The orthogonalized path gives the same matrix whatever the seed
    chunk (one seed channel at a time, or all at once)."""
    from ninwavelets_tpu_torch.ops import extensions as text
    x = _t(_delayed(e=3, n=256, seed=7))
    bank = _t(_bank(PSI_FREQS[::4], 256))
    whole = tenv.env_corr_matrix(x, bank)
    monkeypatch.setattr(text, "CHUNK_ELEMS", 1)
    one = tenv.env_corr_matrix(x, bank)
    torch.testing.assert_close(one, whole, rtol=0, atol=1e-6)


# -- the adapter --------------------------------------------------------------

def _adapter(x, interpolate=False):
    jw = nw.Morse(SFREQ, interpolate=interpolate)
    return (nw.EpochsWavelet(nw.ArrayEpochs(x, SFREQ), jw),
            nt.EpochsWavelet(nt.ArrayEpochs(x, SFREQ),
                             wavelet_from_jax(jw, device="cpu")))


@pytest.mark.parametrize("time_range", [None, (0.1, 0.9)])
def test_adapter_matrices_match_jax(time_range):
    jew, tew = _adapter(_chain(e=6, seed=8))
    assert_rel(tew.partial_coherence(PCOH_FREQS, time_range=time_range),
               jew.partial_coherence(PCOH_FREQS, time_range=time_range))
    assert_rel(tew.multitaper_partial_coherence(PCOH_FREQS,
                                                time_range=time_range),
               jew.multitaper_partial_coherence(PCOH_FREQS,
                                                time_range=time_range))
    assert_rel(tew.env_corr(PCOH_FREQS, time_range=time_range),
               jew.env_corr(PCOH_FREQS, time_range=time_range))
    assert_rel(tew.env_corr(PCOH_FREQS, orthogonalize=False, log=False),
               jew.env_corr(PCOH_FREQS, orthogonalize=False, log=False))


def test_adapter_psi_and_kuramoto_match_jax():
    jew, tew = _adapter(_delayed(e=6, n=1024, seed=9), interpolate=True)
    shuffled = PSI_FREQS[::-1]                 # psi_matrix sorts them
    got = tew.psi_matrix(shuffled)
    assert_rel(got, jew.psi_matrix(shuffled))
    assert_rel(got, tew.psi_matrix(PSI_FREQS))
    assert_rel(tew.psi_matrix(PSI_FREQS, time_range=(0.1, 0.9),
                              normalize=False),
               jew.psi_matrix(PSI_FREQS, time_range=(0.1, 0.9),
                              normalize=False))
    assert_rel(tew.kuramoto_order(PSI_FREQS), jew.kuramoto_order(PSI_FREQS))
    assert_rel(tew.kuramoto_order(PSI_FREQS, mean_epochs=False),
               jew.kuramoto_order(PSI_FREQS, mean_epochs=False))


def test_adapter_phase_matrices_need_a_real_bank():
    x = _chain(e=3, n=256)
    tew = nt.EpochsWavelet(nt.ArrayEpochs(x, SFREQ),
                           nt.MexicanHat(SFREQ, device="cpu"))
    for call in (lambda: tew.partial_coherence([20.0, 30.0]),
                 lambda: tew.psi_matrix([20.0, 30.0]),
                 lambda: tew.kuramoto_order([20.0, 30.0]),
                 lambda: tew.env_corr([20.0, 30.0])):
        with pytest.raises(ValueError, match="phase metrics need an "
                           "analytic"):
            call()
