"""The port's spectral Granger causality (``ninwavelets_tpu_torch.ops.granger``
and ``EpochsWavelet.granger``) against the JAX package on the same seeded
inputs, on the CPU, and against ``tests/test_granger.py``'s analytic VAR
oracles.  Nothing of the module reaches a Pallas kernel in the JAX package.

Gates, each with its reason:

* Wilson factors: H, Sigma and the reconstructed S = H Sigma H^dagger within
  1e-4 of their max of JAX's (``WILSON``): the same 60-100 float32 steps,
  LU solves and FFTs in another library;
* GC, DTF / PDC and conditional GC within 5e-4 absolute of JAX's
  (``GC_ATOL``); the largest difference measured on these inputs is about
  5e-6, on GC values up to 30;
* the JAX tests' known answers on the port at that file's own tolerances:
  GC against the analytic factors 2e-3 absolute, Sigma and H 5e-3, DTF / PDC
  against the closed-form normalizations 5e-3;
* significance: the two packages draw trial permutations from different
  generators, so ``_significance_from_perms`` is fed the JAX package's own
  (S, C, E) table, built as JAX builds it.  A surrogate GC within 1e-5 of
  the observed plane's max of the observed GC (``TIE``) may count in one
  package and not the other: each cell's p may differ by at most its number
  of such near-ties in units of 1 / (S + 1), and at most 1 % of the cells
  (``TIE_CELLS``) may differ at all (the rule of
  ``tests/test_torch_coupling.py`` for the circular-shift surrogates);
* chunks: the pairwise path factorizes its (time, pair) systems in balanced
  chunks of at most ``_PAIR_CHUNK``, the CWT its epochs in chunks of
  ``_CWT_CHUNK`` coefficients; small chunks and one chunk agree within 1e-6
  of the max.  The pairwise chunks are tested at 2 and 5 systems (bits
  equal here): a chunk of one system takes the CPU FFT's unvectorized path
  along the frequency axis, which rounds differently (measured 2.7e-6
  absolute on one transform, 1.1e-6 of the GC max after 40 Wilson steps),
  which is why the chunks are balanced and no lone system is split off;
* validation errors: JAX's types and messages; a singular block gives
  non-finite values where JAX's solve gives them, never an exception.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ninwavelets_tpu as nw
import ninwavelets_tpu_torch as nt
from ninwavelets_tpu.ops import granger as jgr
from ninwavelets_tpu_torch.ops import connectivity as tconn
from ninwavelets_tpu_torch.ops import granger as tgr

from test_granger import (FS, _simulate, _simulate3, _true_spectrum,
                          _var_system)
from torch_threads import one_torch_thread  # noqa: F401

WILSON = 1e-4
GC_ATOL = 5e-4
TIE, TIE_CELLS = 1e-5, 1e-2


def _c(s):
    return torch.from_numpy(np.asarray(s).astype(np.complex64))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    return np.abs(got - want).max() / np.abs(want).max()


def _chain():
    """x <- z <- y chain (no direct y -> x), order [x, y, z]."""
    a = np.diag([0.5, 0.5, 0.5])
    a[0, 2] = 0.5
    a[2, 1] = 0.5
    return a, np.diag([1.0, 0.8, 0.9])


def _chain_spectrum(k=65):
    a, sig = _chain()
    freqs = jgr.uniform_freqs(k, FS)
    s = np.zeros((k, 3, 3), np.complex128)
    a_true = np.zeros((k, 3, 3), np.complex128)
    for idx, f in enumerate(freqs):
        at = np.eye(3) - a * np.exp(-2j * np.pi * f / FS)
        a_true[idx] = at
        h = np.linalg.inv(at)
        s[idx] = h @ sig @ h.conj().T
    return s, a_true


@pytest.fixture(scope="module")
def var_factors():
    """The VAR(2) system's true spectrum on 129 bins, factorized by both
    packages (100 steps, as ``tests/test_granger.py`` does)."""
    coeffs, sig = _var_system()
    s, h_true = _true_spectrum(coeffs, sig, jgr.uniform_freqs(129, FS))
    hj, sj = jgr.wilson_factorize(s, n_iter=100)
    ht, st = tgr.wilson_factorize(_c(s), n_iter=100)
    return dict(s=s, h_true=h_true, sig=sig, jax=(np.asarray(hj),
                                                   np.asarray(sj)),
                port=(ht.numpy(), st.numpy()))


# -- Wilson factorization -----------------------------------------------------

def test_wilson_factors_match_jax(var_factors):
    (hj, sj), (ht, st) = var_factors["jax"], var_factors["port"]
    assert ht.dtype == np.complex64 and st.dtype == np.float32
    assert _rel(ht, hj) <= WILSON
    assert _rel(st, sj) <= WILSON
    recon_t = ht @ st[None] @ np.conj(np.swapaxes(ht, -1, -2))
    recon_j = hj @ sj[None] @ np.conj(np.swapaxes(hj, -1, -2))
    assert _rel(recon_t, recon_j) <= WILSON


def test_wilson_factors_match_jax_on_a_batched_chain():
    s, _ = _chain_spectrum()
    s2 = np.stack([s, 1.7 * s])
    hj, sj = jgr.wilson_factorize(s2, n_iter=60)
    ht, st = tgr.wilson_factorize(_c(s2), n_iter=60)
    assert _rel(ht.numpy(), np.asarray(hj)) <= WILSON
    assert _rel(st.numpy(), np.asarray(sj)) <= WILSON


def test_wilson_reconstructs_spectrum(var_factors):
    h, sig = (np.asarray(x, np.float64 if x.dtype == np.float32
                         else np.complex128) for x in var_factors["port"])
    s = var_factors["s"]
    recon = h @ sig[None] @ np.conj(np.swapaxes(h, -1, -2))
    assert np.abs(recon - s).max() / np.abs(s).max() < 1e-4


def test_wilson_recovers_covariance_and_transfer(var_factors):
    h, sig = var_factors["port"]
    np.testing.assert_allclose(sig, var_factors["sig"], atol=5e-3)
    h_true = var_factors["h_true"]
    np.testing.assert_allclose(h, h_true, atol=5e-3 * np.abs(h_true).max())


def test_wilson_batched_matches_loop(var_factors):
    s = var_factors["s"]
    h, sig = tgr.wilson_factorize(_c(np.stack([s, 1.7 * s])), n_iter=80)
    h0, _ = tgr.wilson_factorize(_c(s), n_iter=80)
    np.testing.assert_allclose(h.numpy()[0], h0.numpy(), rtol=2e-4,
                               atol=2e-5)
    # scaling S by c scales Sigma by c, H unchanged
    np.testing.assert_allclose(sig.numpy()[1], 1.7 * sig.numpy()[0],
                               rtol=2e-3, atol=1e-6)


# -- pairwise GC --------------------------------------------------------------

def test_pairwise_gc_matches_jax_and_the_analytic_factors(var_factors):
    s, h_true, sig = (var_factors[k] for k in ("s", "h_true", "sig"))
    gc = tgr.spectral_granger_pairwise(_c(s), n_iter=100).numpy()
    want = np.asarray(jgr.spectral_granger_pairwise(
        jnp.asarray(s, jnp.complex64), n_iter=100))
    np.testing.assert_allclose(gc, want, rtol=0, atol=GC_ATOL)
    analytic = tgr.granger_from_factors(
        _c(h_true), torch.from_numpy(sig.astype(np.float32)), _c(s)).numpy()
    np.testing.assert_allclose(gc[:, 0, 1], analytic[:, 0], atol=2e-3)
    np.testing.assert_allclose(gc[:, 1, 0], analytic[:, 1], atol=2e-3)
    assert gc[:, 0, 1].max() > 0.05         # y drives x ...
    assert gc[:, 1, 0].max() < 1e-3         # ... never the reverse
    assert np.all(gc[..., range(2), range(2)] == 0.0)


def test_granger_from_factors_matches_jax(var_factors):
    s, h_true, sig = (var_factors[k] for k in ("s", "h_true", "sig"))
    got = tgr.granger_from_factors(
        _c(h_true), torch.from_numpy(sig.astype(np.float32)), _c(s)).numpy()
    want = np.asarray(jgr.granger_from_factors(
        jnp.asarray(h_true, jnp.complex64), jnp.asarray(sig, jnp.float32),
        jnp.asarray(s, jnp.complex64)))
    np.testing.assert_allclose(got, want, rtol=0, atol=GC_ATOL)


@pytest.mark.parametrize("chunk", [2, 5])
def test_pairwise_chunks_agree_with_one_chunk(monkeypatch, chunk):
    """(time, pair) chunks of at most 2 and 5 systems against one chunk: a
    (4, K, 4, 4) batch is 24 systems, so 5 gives a ragged split."""
    rng = np.random.default_rng(3)
    s, _ = _chain_spectrum(33)
    mix = rng.standard_normal((4, 4, 3)) * 0.3 + np.eye(4, 3)[None]
    s4 = np.einsum("tac,kcd,tbd->tkab", mix, s, mix)
    s4 = s4 + 0.05 * np.eye(4)
    whole = tgr.spectral_granger_pairwise(_c(s4), n_iter=40).numpy()
    monkeypatch.setattr(tgr, "_PAIR_CHUNK", chunk)
    parts = tgr.spectral_granger_pairwise(_c(s4), n_iter=40).numpy()
    assert np.abs(parts - whole).max() <= 1e-6 * np.abs(whole).max()


def test_cwt_chunks_agree_with_one_chunk(monkeypatch):
    coeffs, sig = _var_system()
    data = torch.from_numpy(_simulate(coeffs, sig, e=6, n=256, seed=2))
    whole = tgr.wavelet_granger(data, FS, n_bins=9, time_decim=32,
                                n_iter=30).numpy()
    monkeypatch.setattr(tgr, "_CWT_CHUNK", 1)        # one epoch a chunk
    parts = tgr.wavelet_granger(data, FS, n_bins=9, time_decim=32,
                                n_iter=30).numpy()
    assert np.abs(parts - whole).max() <= 1e-6 * np.abs(whole).max()


@pytest.mark.parametrize("c", [2, 3, 4, 5])
def test_small_products_match_matmul(c):
    """``_mm`` forms products of matrices up to 4 x 4 elementwise (5 x 5
    goes through ``matmul``): within 1e-6 of the max of ``matmul``'s."""
    rng = np.random.default_rng(c)
    a, b = (_c(rng.standard_normal((7, 3, c, c))
               + 1j * rng.standard_normal((7, 3, c, c))) for _ in range(2))
    got = tgr._mm(a, b).numpy()
    want = (a @ b).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    eye = torch.eye(c, dtype=torch.complex64)
    assert torch.equal(tgr._mm(a, eye), a)


# -- DTF / PDC and conditional GC -------------------------------------------

def test_dtf_pdc_match_jax_and_the_closed_form():
    s, a_true = _chain_spectrum()
    dtf, pdc = (x.numpy() for x in tgr.dtf_pdc(_c(s), n_iter=100))
    jd, jp = (np.asarray(x) for x in jgr.dtf_pdc(s, n_iter=100))
    np.testing.assert_allclose(dtf, jd, rtol=0, atol=GC_ATOL)
    np.testing.assert_allclose(pdc, jp, rtol=0, atol=GC_ATOL)
    # PDC: only DIRECT links; DTF: the cascade shows up
    assert pdc[:, 0, 1].max() < 0.02
    assert pdc[:, 0, 2].max() > 0.3 and pdc[:, 2, 1].max() > 0.3
    assert dtf[:, 0, 1].max() > 0.1
    h_true = np.linalg.inv(a_true)
    dtf_true = np.abs(h_true) / np.sqrt(
        (np.abs(h_true) ** 2).sum(-1, keepdims=True))
    pdc_true = np.abs(a_true) / np.sqrt(
        (np.abs(a_true) ** 2).sum(-2, keepdims=True))
    np.testing.assert_allclose(dtf, dtf_true, atol=5e-3)
    np.testing.assert_allclose(pdc, pdc_true, atol=5e-3)


def test_conditional_gc_matches_jax_and_suppresses_the_mediated_link():
    s, _ = _chain_spectrum()
    cg = tgr.conditional_granger(_c(s), n_iter=100).numpy()
    want = np.asarray(jgr.conditional_granger(s, n_iter=100))
    np.testing.assert_allclose(cg, want, rtol=0, atol=GC_ATOL)
    pw = tgr.spectral_granger_pairwise(_c(s), n_iter=100).numpy()
    assert pw[:, 0, 1].max() > 0.2          # pairwise is fooled ...
    assert cg[:, 0, 1].max() < 1e-3         # ... conditional is not
    assert cg[:, 0, 2].max() > 0.3 and cg[:, 2, 1].max() > 0.3
    assert cg[:, 1, 0].max() < 1e-3 and cg[:, 1, 2].max() < 1e-3
    assert np.all(cg[:, range(3), range(3)] == 0.0)


def test_conditional_reduces_to_pairwise_with_an_independent_channel():
    coeffs, _ = _var_system()
    a = np.zeros((3, 3))
    a[:2, :2] = coeffs[0]
    a[2, 2] = 0.3
    a2 = np.zeros((3, 3))
    a2[:2, :2] = coeffs[1]
    sig3 = np.diag([1.0, 0.7, 0.5])
    freqs = jgr.uniform_freqs(129, FS)
    s = np.zeros((129, 3, 3), np.complex128)
    for idx, f in enumerate(freqs):
        z1 = np.exp(-2j * np.pi * f / FS)
        h = np.linalg.inv(np.eye(3) - a * z1 - a2 * z1 * z1)
        s[idx] = h @ sig3 @ h.conj().T
    cg = tgr.conditional_granger(_c(s), n_iter=150).numpy()
    pw = tgr.spectral_granger_pairwise(_c(s[:, :2, :2]), n_iter=150).numpy()
    np.testing.assert_allclose(cg[:, 0, 1], pw[:, 0, 1], atol=2e-3)
    np.testing.assert_allclose(cg[:, 1, 0], pw[:, 1, 0], atol=2e-3)


# -- the wavelet pipeline ---------------------------------------------------

@pytest.fixture(scope="module")
def chain_data():
    a, sig = _chain()
    return _simulate3([a], sig, e=8, n=512, seed=14)


@pytest.mark.parametrize("interpolate", [True, False])
def test_wavelet_granger_matches_jax(interpolate):
    coeffs, sig = _var_system()
    data = _simulate(coeffs, sig, e=8, n=512, seed=8)
    got = tgr.wavelet_granger(torch.from_numpy(data), FS, n_bins=17,
                              time_decim=64, n_iter=40,
                              interpolate=interpolate).numpy()
    want = np.asarray(jgr.wavelet_granger(data, FS, n_bins=17, time_decim=64,
                                          n_iter=40, interpolate=interpolate))
    assert got.shape == want.shape == (8, 17, 2, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=GC_ATOL)


def test_wavelet_dtf_pdc_matches_jax(chain_data):
    got = tgr.wavelet_dtf_pdc(torch.from_numpy(chain_data), FS, n_bins=17,
                              time_decim=128, n_iter=40)
    want = jgr.wavelet_dtf_pdc(chain_data, FS, n_bins=17, time_decim=128,
                               n_iter=40)
    for g, w in zip(got, want):
        assert tuple(g.shape) == (4, 17, 3, 3)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=GC_ATOL)
        assert float(g.max()) <= 1.0 + 1e-5


def test_wavelet_conditional_granger_matches_jax(chain_data):
    got = tgr.wavelet_conditional_granger(
        torch.from_numpy(chain_data), FS, n_bins=17, time_decim=128,
        n_iter=40).numpy()
    want = np.asarray(jgr.wavelet_conditional_granger(
        chain_data, FS, n_bins=17, time_decim=128, n_iter=40))
    np.testing.assert_allclose(got, want, rtol=0, atol=GC_ATOL)
    assert np.all(got[..., range(3), range(3)] == 0.0)


def test_wavelet_granger_direction_on_simulated_var():
    coeffs, sig = _var_system()
    data = _simulate(coeffs, sig, e=24, n=2048)
    gc = tgr.wavelet_granger(torch.from_numpy(data), FS, n_bins=33,
                             time_decim=32, n_iter=60).numpy()
    assert gc.shape == (64, 33, 2, 2)
    m = gc.mean(0)
    assert m[:, 0, 1].max() > 5 * max(m[:, 1, 0].max(), 1e-6)
    assert jgr.uniform_freqs(33, FS)[m[:, 0, 1].argmax()] > 25.0


def test_wavelet_conditional_on_simulated_chain():
    a, sig = _chain()
    data = torch.from_numpy(_simulate3([a], sig, e=24, n=2048, seed=6))
    m_c = tgr.wavelet_conditional_granger(data, FS, n_bins=33,
                                          time_decim=64).numpy().mean(0)
    m_p = tgr.wavelet_granger(data, FS, n_bins=33,
                              time_decim=64).numpy().mean(0)
    assert m_c[:, 0, 1].max() < 0.4 * m_p[:, 0, 1].max()
    assert m_c[:, 0, 2].max() > 0.5 * m_p[:, 0, 2].max()


def test_wavelet_granger_scale_invariance():
    coeffs, sig = _var_system()
    data = _simulate(coeffs, sig, e=8, n=1024, seed=3)
    a = tgr.wavelet_granger(torch.from_numpy(data), FS, n_bins=17,
                            time_decim=64, n_iter=40).numpy()
    b = tgr.wavelet_granger(torch.from_numpy(3.0 * data), FS, n_bins=17,
                            time_decim=64, n_iter=40).numpy()
    np.testing.assert_allclose(a, b, rtol=5e-3, atol=1e-5)


# -- significance ------------------------------------------------------------

def _jax_perms(seed, s, c, e):
    """The (S, C, E) trial permutations of the JAX package's
    ``wavelet_granger_significance``, drawn as it draws them."""
    keys = jax.random.split(jax.random.PRNGKey(seed), s * c).reshape(s, c, 2)
    return np.array(jnp.stack([
        jnp.stack([jax.random.permutation(keys[i, ch], e)
                   for ch in range(c)]) for i in range(s)]))


def test_significance_fed_jax_permutations_matches_jax():
    coeffs, sig = _var_system()
    data = _simulate(coeffs, sig, e=16, n=1024, seed=7)
    n_s, kw = 19, dict(n_bins=17, time_decim=128, n_iter=40)
    gc_j, p_j = (np.asarray(x) for x in jgr.wavelet_granger_significance(
        data, FS, n_surrogates=n_s, **kw))
    perms = _jax_perms(0, n_s, 2, 16)
    sigs, bank = tgr._granger_inputs(torch.from_numpy(data), FS, 17, True)
    gc_t, p_t = (x.numpy() for x in tgr._significance_from_perms(
        sigs, bank, torch.from_numpy(perms), 128, 40, True))
    np.testing.assert_allclose(gc_t, gc_j, rtol=0, atol=GC_ATOL)
    # near-ties: JAX's surrogate planes, from its own pieces
    sj, bj = jgr._granger_inputs(data, FS, 17, True)
    wr, wi = jgr._decimated_cwt(sj, bj, time_decim=128, interpolate=True)
    pairs = jnp.asarray(jgr._pair_list(2))
    surr = np.stack([np.asarray(jgr._pairwise_assemble(
        *jgr._cross_from_tableau(wr, wi, jnp.asarray(p)), pairs, n_iter=40))
        for p in perms])
    ties = (np.abs(surr - gc_j[None]) <= TIE * np.abs(gc_j).max()).sum(0)
    diff = np.abs(p_t - p_j) * (n_s + 1)
    assert np.all(diff <= ties + 1e-3)
    assert (diff > 1e-3).mean() <= TIE_CELLS
    assert (p_t[..., range(2), range(2)] == 1.0).all()


def test_significance_known_answers_on_the_port_draws():
    coeffs, sig = _var_system()
    data = torch.from_numpy(_simulate(coeffs, sig, e=16, n=1024, seed=7))
    gc, p = (x.numpy() for x in tgr.wavelet_granger_significance(
        data, FS, n_surrogates=19, n_bins=17, time_decim=128, n_iter=40))
    assert gc.shape == p.shape == (8, 17, 2, 2)
    band = gc.mean(0)[:, 0, 1].argmax()
    assert p[:, band, 0, 1].min() == pytest.approx(0.05, abs=1e-6)
    assert (p[..., range(2), range(2)] == 1.0).all()
    assert (p[..., 0, 1] <= 0.05).sum() > (p[..., 1, 0] <= 0.05).sum()
    plain = tgr.wavelet_granger(data, FS, n_bins=17, time_decim=128,
                                n_iter=40).numpy()
    np.testing.assert_allclose(gc, plain, rtol=2e-4, atol=2e-5)
    # one seed, one draw; another seed, other surrogates
    again = tgr.wavelet_granger_significance(
        data, FS, n_surrogates=19, n_bins=17, time_decim=128, n_iter=40)[1]
    assert np.array_equal(again.numpy(), p)
    perms = tgr._trial_perms(19, 2, 16, 0, torch.device("cpu"))
    assert perms.shape == (19, 2, 16)
    assert (perms.sort(-1).values == torch.arange(16)).all()
    assert not torch.equal(perms, tgr._trial_perms(19, 2, 16, 1,
                                                   torch.device("cpu")))


# -- the adapter --------------------------------------------------------------

@pytest.mark.parametrize("conditional", [False, True])
def test_epochs_wavelet_granger_matches_jax(conditional):
    coeffs, sig = _var_system()
    data3 = np.concatenate(
        [_simulate(coeffs, sig, e=8, n=512, seed=5),
         np.random.default_rng(9).standard_normal(
             (8, 1, 512)).astype(np.float32)], axis=1)
    names = ["x", "y", "z"]
    jew = nw.EpochsWavelet(nw.ArrayEpochs(data3, FS, ch_names=names),
                           nw.Morse(FS))
    tew = nt.EpochsWavelet(nt.ArrayEpochs(data3, FS, ch_names=names),
                           nt.Morse(FS, device="cpu"))
    kw = dict(n_bins=17, time_decim=64, n_iter=40, conditional=conditional)
    got = tew.granger(**kw).numpy()
    want = np.asarray(jew.granger(**kw))
    assert got.shape == (8, 17, 3, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=GC_ATOL)
    if not conditional:
        sub = tew.granger(picks=["y", "x"], **kw).numpy()
        np.testing.assert_allclose(sub, np.asarray(
            jew.granger(picks=["y", "x"], **kw)), rtol=0, atol=GC_ATOL)
        assert sub.mean(0)[:, 1, 0].max() > sub.mean(0)[:, 0, 1].max()


# -- validation and singular solves -------------------------------------------

@pytest.mark.parametrize("call", [
    lambda m, z: m.wilson_factorize(z((4, 2, 3))),
    lambda m, z: m.wilson_factorize(z((2, 2, 2))),
    lambda m, z: m.dtf_pdc(z((4, 2, 3))),
    lambda m, z: m.conditional_granger(z((8, 2, 2))),
    lambda m, z: m.wavelet_conditional_granger(z((4, 2, 128), real=True),
                                               FS),
    lambda m, z: m.wavelet_granger(z((4, 128), real=True), FS),
])
def test_validation_errors_match_jax(call):
    def jax_zeros(shape, real=False):
        return np.zeros(shape, np.float32 if real else np.complex64)

    def port_zeros(shape, real=False):
        return torch.zeros(shape, dtype=torch.float32 if real
                           else torch.complex64)

    with pytest.raises(ValueError) as want:
        call(jgr, jax_zeros)
    with pytest.raises(ValueError) as got:
        call(tgr, port_zeros)
    assert str(got.value) == str(want.value)


def test_singular_blocks_give_non_finite_values_as_in_jax():
    rng = np.random.default_rng(0)
    a = (rng.standard_normal((3, 2, 2))
         + 1j * rng.standard_normal((3, 2, 2))).astype(np.complex64)
    a[1] = 0.0                                        # a singular block
    b = (rng.standard_normal((3, 2, 2))
         + 1j * rng.standard_normal((3, 2, 2))).astype(np.complex64)
    got = tconn._solve_complex(_c(a), _c(b)).numpy()
    want = np.asarray(jgr._solve_complex(jnp.asarray(a), jnp.asarray(b)))
    bad_t = ~np.isfinite(got).all((-2, -1))
    bad_j = ~np.isfinite(want).all((-2, -1))
    assert bad_t.tolist() == bad_j.tolist() == [False, True, False]
    assert _rel(got[[0, 2]], want[[0, 2]]) <= 1e-5
    ar = rng.standard_normal((2, 3, 3)).astype(np.float32)
    ar[0] = 0.0
    br = rng.standard_normal((2, 3, 1)).astype(np.float32)
    got = tgr._solve_real(torch.from_numpy(ar), torch.from_numpy(br)).numpy()
    want = np.asarray(jgr._solve_real(jnp.asarray(ar), jnp.asarray(br)))
    assert (~np.isfinite(got).all((-2, -1))).tolist() \
        == (~np.isfinite(want).all((-2, -1))).tolist() == [True, False]
