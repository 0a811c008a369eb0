"""The port's coupling statistics (``ninwavelets_tpu_torch.ops.connectivity``:
n:m PLV, the surrogate significance functions, PAC and ERPAC, lagged
coherence; ``ops.extensions``: bicoherence and cross-frequency
directionality; and their ``EpochsWavelet`` methods) against the JAX
package on the same seeded inputs, on the CPU.  No function here reaches a
Pallas kernel in the JAX package.

The two packages draw surrogates from different generators, so the tests
feed the port's ``surrogate_pvalues_from_shifts`` the JAX package's own
(S, E) shift table, built as JAX builds it: ``jax.random.split(
PRNGKey(seed), S)``, then ``randint(k, (E,), lo, N - lo)`` per key.

Gates, each with its reason:

* statistics (n:m PLV, PAC "mvl", ERPAC, bicoherence, CFD, lagged
  coherence, the observed planes of the significance functions):
  max|d| / max|ref| <= 1e-4, float32 FFTs and sums in another order.  The
  unit phases of n:m PLV are the PLV rule's: these inputs have no
  coefficient near zero, so the plain 1e-4 holds;
* p-values: a surrogate statistic within round-off of the observed one
  (|s - obs| <= 1e-5 of the plane's max, ``TIE``) may count in one package
  and not the other.  Each cell's p may differ by at most its number of
  such near-ties in units of 1/(S + 1), and at most 1 % of the cells
  (``TIE_CELLS``) may differ at all;
* Tort PAC: a sample whose phase lies within 1e-5 rad (``EDGE``) of a bin
  edge may land in either neighbouring bin.  The bins of the two packages
  may differ only at such samples, at most 1e-3 of the samples
  (``EDGE_SHARE``) may lie there, and the MI may differ by at most 1e-4 of
  its max plus the difference those moved samples make to a float64
  transcription of the estimator (the same amplitudes binned both ways);
* epoch chunks: the pair sums (coherence, PLV, phase lag, n:m PLV), PAC
  and bicoherence give the same result one epoch a chunk as all epochs in
  one chunk, within 1e-6 of the max (float32 sums of a few terms in
  another order).  One-epoch chunks, which the cross-pair kernel's serving
  shape (64 pairs x 100 rows x 2048 samples) takes, give the bits of the
  one-epoch-at-a-time loop the plain pair sums ran before they were
  chunked (``loop_epoch_sums``);
* validation errors: same type and message as JAX's.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ninwavelets_tpu as nw
from ninwavelets_tpu.ops import connectivity as jconn
from ninwavelets_tpu.ops import extensions as jext
from ninwavelets_tpu.ops.bank import make_fft_bank as jbank
import ninwavelets_tpu_torch as nt
from ninwavelets_tpu_torch.convert import wavelet_from_jax
from ninwavelets_tpu_torch.ops import connectivity as tconn
from ninwavelets_tpu_torch.ops import cwt as tcwt
from ninwavelets_tpu_torch.ops import extensions as text

from torch_threads import one_torch_thread  # noqa: F401

SFREQ = 1000.0
RTOL = 1e-4
TIE, TIE_CELLS = 1e-5, 1e-2
EDGE, EDGE_SHARE = 1e-5, 1e-3


def _bank(freqs, n, interpolate=True, sfreq=SFREQ):
    return np.array(jbank(nw.Morse(sfreq)._wdef(),
                          jnp.asarray(np.asarray(freqs, np.float32)), n,
                          sfreq, interpolate))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def assert_rel(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    d = np.nanmax(np.abs(got - want))
    assert d <= rtol * np.nanmax(np.abs(want)), d


def jax_shifts(seed, n_surrogates, n_epochs, nt_, min_shift=None):
    """The JAX package's (S, E) surrogate offsets for ``seed``."""
    lo = nt_ // 8 if min_shift is None else min_shift
    keys = jax.random.split(jax.random.PRNGKey(seed), n_surrogates)
    return torch.from_numpy(np.stack([
        np.asarray(jax.random.randint(k, (n_epochs,), lo, nt_ - lo))
        for k in keys]).astype(np.int64))


def assert_pvalues_close(p_port, p_jax, stat_fn, obs, sigs_b, shifts):
    """The p-value rule of the module docstring."""
    p_port, p_jax = np.asarray(p_port), np.asarray(p_jax)
    s = shifts.shape[0]
    steps = np.abs(p_port - p_jax) * (s + 1)
    obs_np = np.asarray(obs, np.float64)
    scale = np.nanmax(np.abs(obs_np))
    ties = np.zeros(obs_np.shape)
    for row in shifts:
        sur = np.asarray(stat_fn(tconn.roll_epochs(sigs_b, row)), np.float64)
        ties += np.abs(sur - obs_np) <= TIE * scale
    assert (np.round(steps) <= ties).all()
    assert (steps > 0.5).mean() <= TIE_CELLS


def _harmonic(locked=True, e=12, n=1024, seed=0):
    """ch a: 10 Hz with a random phase per epoch; ch b: 20 Hz at twice that
    phase (locked) or an independent phase, drawn epoch by epoch as
    ``tests/test_connectivity.py`` draws them."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SFREQ
    a = np.empty((e, n), np.float32)
    b = np.empty((e, n), np.float32)
    for i in range(e):
        pa = rng.uniform(0, 2 * np.pi)
        pb = 2 * pa + 0.7 if locked else rng.uniform(0, 2 * np.pi)
        a[i] = np.sin(2 * np.pi * 10 * t + pa) + 0.2 * rng.standard_normal(n)
        b[i] = np.sin(2 * np.pi * 20 * t + pb) + 0.2 * rng.standard_normal(n)
    return a, b


def _coupled(e=8, n=512, lag=1.0, seed=7):
    """A 40 Hz tone per epoch with a random phase plus 0.4 noise, and the
    same tone ``lag`` radians later plus its own noise: (E, 1, N)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SFREQ
    pa = rng.uniform(0, 2 * np.pi, (e, 1, 1))
    a = np.sin(2 * np.pi * 40 * t + pa) + 0.4 * rng.standard_normal((e, 1, n))
    b = (np.sin(2 * np.pi * 40 * t + pa + lag)
         + 0.4 * rng.standard_normal((e, 1, n)))
    return a.astype(np.float32), b.astype(np.float32)


def _theta_gamma(e=8, n=1024, sfreq=500.0, seed=0):
    """6 Hz theta modulating the amplitude of 60 Hz gamma, random phases
    per epoch, plus noise (``tests/test_envelope.py``)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sfreq
    sig = np.zeros((e, n), np.float32)
    for ep in range(e):
        th = np.sin(2 * np.pi * 6 * t + rng.uniform(0, 6.3))
        gam = (1 + 0.8 * th) * np.sin(2 * np.pi * 60 * t
                                      + rng.uniform(0, 6.3))
        sig[ep] = th + 0.5 * gam + 0.3 * rng.standard_normal(n)
    return sig


# -- n:m phase locking --------------------------------------------------------

@pytest.mark.parametrize("interpolate", [True, False])
@pytest.mark.parametrize("n,m", [(2, 1), (1, 1), (3, 2)])
def test_nm_plv_matches_jax(interpolate, n, m):
    a, b = _harmonic(seed=1)
    fa = np.array([8.0, 10.0, 12.0])
    ba, bb = _bank(fa, 1024, interpolate), _bank(fa * n / m, 1024,
                                                 interpolate)
    got = tconn.nm_plv(_t(a[:, None]), _t(b[:, None]), _t(ba), _t(bb),
                       n=n, m=m, interpolate=interpolate)
    want = jconn.nm_plv(a[:, None], b[:, None], ba, bb, n=n, m=m,
                        interpolate=interpolate)
    assert_rel(got, want)


def test_nm_plv_reduces_to_plv_at_1_1():
    rng = np.random.default_rng(5)
    sa = _t(rng.standard_normal((6, 1, 1024)).astype(np.float32))
    sb = _t(rng.standard_normal((6, 1, 1024)).astype(np.float32))
    bank = _t(_bank(np.arange(20.0, 60.0, 8.0), 1024))
    torch.testing.assert_close(
        tconn.nm_plv(sa, sb, bank, bank, n=1, m=1, interpolate=True),
        tconn.plv_from_bank(sa, sb, bank, True), rtol=1e-5, atol=1e-6)


def test_nm_plv_sees_the_harmonic_lock_only_at_its_ratio():
    """The JAX package's known answer, on its own data."""
    fa = np.array([8.0, 10.0, 12.0])
    ba, bb = _t(_bank(fa, 2048)), _t(_bank(2 * fa, 2048))
    a, b = _harmonic(e=20, n=2048)
    v21 = tconn.nm_plv(_t(a), _t(b), ba, bb, n=2, m=1, interpolate=True)
    v11 = tconn.nm_plv(_t(a), _t(b), ba, ba, n=1, m=1, interpolate=True)
    a0, b0 = _harmonic(False, e=20, n=2048, seed=3)
    v0 = tconn.nm_plv(_t(a0), _t(b0), ba, bb, n=2, m=1, interpolate=True)
    assert float(v21[1, 400:-400].mean()) > 0.85
    assert float(v11[1, 400:-400].mean()) < 0.4
    assert float(v0[1, 400:-400].mean()) < 0.45


@pytest.mark.parametrize("n,m", [(0, 1), (1, 0)])
def test_nm_plv_needs_positive_ratio(n, m):
    bank = _bank([10.0], 256)
    with pytest.raises(ValueError, match="n and m must be positive"):
        jconn.nm_plv_sums(jnp.zeros((2, 256)), jnp.zeros((2, 256)), bank,
                          bank, n, m)
    with pytest.raises(ValueError, match="n and m must be positive"):
        tconn.nm_plv_sums(torch.zeros(2, 256), torch.zeros(2, 256),
                          _t(bank), _t(bank), n, m)


# -- surrogate significance ---------------------------------------------------

def test_roll_epochs_is_a_per_epoch_roll():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 3, 64)).astype(np.float32)
    shifts = torch.tensor([0, 5, 63, 17])
    got = tconn.roll_epochs(_t(x), shifts).numpy()
    for e, s in enumerate(shifts.tolist()):
        assert np.array_equal(got[e], np.roll(x[e], s, -1))


def test_surrogate_shifts_range_and_determinism():
    g = torch.Generator().manual_seed(3)
    s = tconn.surrogate_shifts(256, 7, g, n_surrogates=50)
    assert s.shape == (50, 7)
    assert int(s.min()) >= 32 and int(s.max()) < 224
    again = tconn.surrogate_shifts(256, 7, torch.Generator().manual_seed(3),
                                   n_surrogates=50)
    assert torch.equal(s, again)


@pytest.mark.parametrize("min_shift", [0, 32, 40])
def test_min_shift_leaves_no_offsets(min_shift):
    with pytest.raises(ValueError, match=f"min_shift {min_shift} leaves no "
                       "admissible offsets"):
        jconn.surrogate_pvalues(lambda s: jnp.zeros(()), jnp.zeros(()),
                                jnp.zeros((2, 64)), jax.random.PRNGKey(0), 9,
                                min_shift=min_shift)
    with pytest.raises(ValueError, match=f"min_shift {min_shift} leaves no "
                       "admissible offsets"):
        tconn.surrogate_pvalues(lambda s: torch.zeros(()), torch.zeros(()),
                                torch.zeros(2, 64), torch.Generator(), 9,
                                min_shift=min_shift)


@pytest.mark.parametrize("coupled", [True, False])
def test_plv_significance_matches_jax_on_its_shifts(coupled):
    a, b = _coupled(seed=7 if coupled else 8)
    if not coupled:
        b = np.random.default_rng(9).standard_normal(b.shape).astype(
            np.float32)
    bank = _bank(np.arange(30.0, 55.0, 8.0), 512)
    s, seed = 49, 1
    obs_j, p_j = jconn.plv_significance(a, b, bank, interpolate=True,
                                        n_surrogates=s, seed=seed)
    sa, sb, bk = _t(a), _t(b), _t(bank)

    def stat(shifted):
        return tconn.plv_from_bank(sa, shifted, bk, True)

    obs, _ = tconn.plv_significance(sa, sb, bk, interpolate=True,
                                    n_surrogates=s, seed=seed)
    assert_rel(obs, obs_j)
    shifts = jax_shifts(seed, s, a.shape[0], 512)
    p = tconn.surrogate_pvalues_from_shifts(stat, obs, sb, shifts)
    assert_pvalues_close(p, p_j, stat, obs, sb, shifts)


@pytest.mark.parametrize("method", ["pli", "wpli", "dwpli"])
def test_phase_lag_significance_matches_jax_on_its_shifts(method):
    a, b = _coupled(seed=11)
    bank = _bank(np.arange(30.0, 55.0, 8.0), 512)
    s, seed = 39, 2
    obs_j, p_j = jconn.phase_lag_significance(a, b, bank, method=method,
                                              interpolate=True,
                                              n_surrogates=s, seed=seed)
    sa, sb, bk = _t(a), _t(b), _t(bank)

    def stat(shifted):
        return tconn.phase_lag_from_bank(sa, shifted, bk, method, True)

    obs, p_api = tconn.phase_lag_significance(sa, sb, bk, method=method,
                                              interpolate=True,
                                              n_surrogates=s, seed=seed)
    assert_rel(obs, obs_j)
    assert p_api.shape == obs.shape
    shifts = jax_shifts(seed, s, a.shape[0], 512)
    p = tconn.surrogate_pvalues_from_shifts(stat, obs, sb, shifts)
    assert_pvalues_close(p, p_j, stat, obs, sb, shifts)


def test_phase_lag_significance_bad_method():
    for mod, zeros in ((jconn, jnp.zeros((2, 1, 64))),
                       (tconn, torch.zeros(2, 1, 64))):
        with pytest.raises(ValueError, match="method must be one of"):
            mod.phase_lag_significance(zeros, zeros, _bank([30.0], 64),
                                       method="nope")


def test_plv_significance_known_answers():
    """Coupled cells sit at the floor; independent channels give p near
    uniform (``tests/test_connectivity.py``)."""
    a, b = _coupled(e=16, n=1024, seed=7)
    bank = _t(_bank(np.arange(30.0, 55.0, 8.0), 1024))
    obs, p = tconn.plv_significance(_t(a), _t(b), bank, interpolate=True,
                                    n_surrogates=99, seed=1)
    again = tconn.plv_significance(_t(a), _t(b), bank, interpolate=True,
                                   n_surrogates=99, seed=1)[1]
    assert torch.equal(p, again)
    assert float(obs[0, 1, 300:-300].mean()) > 0.85
    assert float(p[0, 1, 300:-300].median()) <= 0.02 + 1e-9
    b2 = np.random.default_rng(2).standard_normal(b.shape).astype(
        np.float32)
    _, p0 = tconn.plv_significance(_t(a), _t(b2), bank, interpolate=True,
                                   n_surrogates=99, seed=2)
    assert 0.2 < float(p0[0, :, 300:-300].median()) < 0.8


# -- phase-amplitude coupling -------------------------------------------------

PAC_PHASE, PAC_AMP = np.array([3.0, 6.0, 9.0]), np.array([30.0, 60.0])


def _pac_banks(n, sfreq=500.0, interpolate=True):
    return (_bank(PAC_PHASE, n, interpolate, sfreq),
            _bank(PAC_AMP, n, interpolate, sfreq))


@pytest.mark.parametrize("interpolate", [True, False])
@pytest.mark.parametrize("mean_epochs", [True, False])
def test_pac_mvl_matches_jax(interpolate, mean_epochs):
    sig = _theta_gamma(seed=1)
    bp, ba = _pac_banks(1024, interpolate=interpolate)
    got = tconn.pac(_t(sig), _t(bp), _t(ba), interpolate, "mvl",
                    mean_epochs=mean_epochs)
    want = jconn.pac(sig, bp, ba, interpolate, "mvl",
                     mean_epochs=mean_epochs)
    assert_rel(got, want)


def _bins(phase_r, phase_i, n_bins, lib):
    """Tort bin indices as each package forms them."""
    if lib == "jax":
        ph = jnp.arctan2(phase_i, phase_r)
        return np.asarray(jnp.clip(((ph + jnp.pi) * (n_bins / (2 * jnp.pi)))
                                   .astype(jnp.int32), 0, n_bins - 1))
    ph = torch.atan2(phase_i, phase_r)
    return torch.clamp(((ph + math.pi) * (n_bins / (2 * math.pi)))
                       .to(torch.int32), 0, n_bins - 1).numpy()


def _tort64(idx, amp, n_bins):
    """Float64 Tort MI per epoch from (E, Fp, N) bins and (E, Fa, N)
    amplitudes, averaged over epochs: (Fp, Fa)."""
    onehot = (idx[:, :, None, :] == np.arange(n_bins)[:, None]).astype(float)
    counts = onehot.sum(-1)
    sums = onehot @ np.swapaxes(amp, -1, -2)[:, None].astype(np.float64)
    mean_amp = sums / np.maximum(counts, 1.0)[..., None]
    p = mean_amp / np.maximum(mean_amp.sum(-2, keepdims=True), 1e-20)
    plogp = np.where(p > 0, p * np.log(np.where(p > 0, p, 1.0)), 0.0)
    return ((np.log(n_bins) + plogp.sum(-2)) / np.log(n_bins)).mean(0)


@pytest.mark.parametrize("interpolate", [True, False])
@pytest.mark.parametrize("n_bins", [18, 12])
def test_pac_tort_matches_jax_up_to_bin_edges(interpolate, n_bins):
    sig = _theta_gamma(seed=2)
    bp, ba = _pac_banks(1024, interpolate=interpolate)
    got = tconn.pac(_t(sig), _t(bp), _t(ba), interpolate, "tort", n_bins,
                    mean_epochs=True).numpy()
    want = np.asarray(jconn.pac(sig, bp, ba, interpolate, "tort", n_bins,
                                mean_epochs=True))
    uj, aj = jconn._phase_amp(jnp.asarray(sig), jnp.asarray(bp),
                              jnp.asarray(ba), interpolate, 1e-20)
    ut, at = tconn._phase_amp(_t(sig), _t(bp), _t(ba), interpolate, 1e-20)
    idx_j = _bins(jnp.real(uj), jnp.imag(uj), n_bins, "jax")
    idx_t = _bins(ut.real, ut.imag, n_bins, "torch")
    phase = np.angle(np.asarray(uj, np.complex128)) + np.pi
    width = 2 * np.pi / n_bins
    near = np.abs(phase / width - np.round(phase / width)) * width <= EDGE
    moved = idx_j != idx_t
    assert not (moved & ~near).any()
    assert near.mean() <= EDGE_SHARE
    amp = np.asarray(aj, np.float64)
    allowed = np.abs(_tort64(idx_t, amp, n_bins) - _tort64(idx_j, amp,
                                                           n_bins))
    assert (np.abs(got - want) <= RTOL * np.abs(want).max() + allowed).all()


@pytest.mark.parametrize("method", ["mvl", "tort"])
def test_pac_pair_matches_jax(method):
    rng = np.random.default_rng(3)
    sig = _theta_gamma(seed=3)
    other = (sig + 0.5 * rng.standard_normal(sig.shape)).astype(np.float32)
    bp, ba = _pac_banks(1024)
    got = tconn.pac_pair(_t(sig), _t(other), _t(bp), _t(ba),
                         interpolate=True, method=method)
    want = jconn.pac_pair(sig, other, bp, ba, interpolate=True,
                          method=method)
    assert_rel(got, want)


def loop_epoch_sums(sigs_a, sigs_b, bank, interpolate, per_epoch,
                    bank_b=None):
    """The plain pair sums' epoch loop before chunking: one epoch at a time,
    each epoch's coefficients without a leading axis."""
    bank_b = bank if bank_b is None else bank_b
    totals = None
    for sa, sb in zip(sigs_a, sigs_b):
        terms = per_epoch(tcwt.cwt_from_bank(sa, bank, interpolate),
                          tcwt.cwt_from_bank(sb, bank_b, interpolate))
        totals = (list(terms) if totals is None
                  else [t + u for t, u in zip(totals, terms)])
    return tuple(totals)


def _chunk_case(name):
    """A function of nothing giving each chunked statistic's result as a
    tuple: 5 epochs x 3 pairs x 256 samples and 6 rows, PAC on 5 epochs x
    512 samples."""
    rng = np.random.default_rng(11)
    sa = _t(rng.standard_normal((5, 3, 256)).astype(np.float32))
    sb = _t((0.5 * np.asarray(sa)
             + rng.standard_normal((5, 3, 256))).astype(np.float32))
    fr = np.arange(20.0, 80.0, 10.0)
    bank, bank2 = _t(_bank(fr, 256)), _t(_bank(2 * fr, 256))
    pac_sig = _t(_theta_gamma(e=5, n=512, seed=4))
    bp, ba = (_t(b) for b in _pac_banks(512))
    cases = {
        "coherence_sums": lambda: text.coherence_sums(sa, sb, bank, True),
        "plv_sums": lambda: tconn.plv_sums(sa, sb, bank, True),
        "phase_lag_sums": lambda: tconn.phase_lag_sums(sa, sb, bank, True),
        "nm_plv_sums": lambda: tconn.nm_plv_sums(sa, sb, bank, bank2, 2, 1,
                                                 True),
        "pac": lambda: (tconn.pac(pac_sig, bp, ba, True, "mvl",
                                  mean_epochs=True),),
        "bicoherence": lambda: (text.bicoherence(
            sa, bank[:3], bank[3:], _t(_bank(
                (fr[:3, None] + fr[None, 3:]).ravel(), 256)), True),),
    }
    return cases[name]


PAIR_SUMS = ["coherence_sums", "plv_sums", "phase_lag_sums", "nm_plv_sums"]


@pytest.mark.parametrize("name", PAIR_SUMS + ["pac", "bicoherence"])
def test_epoch_chunks_agree(monkeypatch, name):
    """One epoch a chunk gives the sums of one chunk of every epoch."""
    fn = _chunk_case(name)
    whole = fn()
    monkeypatch.setattr(text, "CHUNK_ELEMS", 1)
    one = fn()
    for u, w in zip(one, whole):
        scale = w.abs().max().item()
        torch.testing.assert_close(u, w, rtol=0, atol=1e-6 * scale)


@pytest.mark.parametrize("name", PAIR_SUMS)
def test_one_epoch_chunks_are_the_epoch_loop_bits(monkeypatch, name):
    """At the serving shape a chunk holds one epoch, and one-epoch chunks
    give the bits of the one-epoch-at-a-time loop."""
    assert text.chunk_size(64 * 100 * 2048) == 1
    fn = _chunk_case(name)
    monkeypatch.setattr(text, "CHUNK_ELEMS", 1)
    chunked = fn()
    monkeypatch.setattr(text, "epoch_sums", loop_epoch_sums)
    monkeypatch.setattr(tconn, "epoch_sums", loop_epoch_sums)
    looped = fn()
    assert len(chunked) == len(looped)
    for u, w in zip(chunked, looped):
        assert torch.equal(u, w)


def test_pac_bad_method():
    bp, ba = _pac_banks(256)
    with pytest.raises(ValueError, match="method must be 'mvl' or 'tort'"):
        jconn.pac(np.zeros((1, 256), np.float32), bp, ba, method="x")
    with pytest.raises(ValueError, match="method must be 'mvl' or 'tort'"):
        tconn.pac(torch.zeros(1, 256), _t(bp), _t(ba), method="x")


@pytest.mark.parametrize("method", ["mvl", "tort"])
def test_pac_significance_matches_jax_on_its_shifts(method):
    sig = _theta_gamma(seed=5)
    bp, ba = _pac_banks(1024)
    s, seed = 29, 3
    obs_j, p_j = jconn.pac_significance(sig, bp, ba, interpolate=True,
                                        method=method, n_surrogates=s,
                                        seed=seed)
    x, bpt, bat = _t(sig), _t(bp), _t(ba)

    def stat(shifted):
        return tconn.pac_pair_mean(x, shifted, bpt, bat, True, method, 18)

    obs, _ = tconn.pac_significance(x, bpt, bat, interpolate=True,
                                    method=method, n_surrogates=s, seed=seed)
    assert_rel(obs, obs_j)
    shifts = jax_shifts(seed, s, sig.shape[0], 1024)
    p = tconn.surrogate_pvalues_from_shifts(stat, obs, x, shifts)
    assert_pvalues_close(p, p_j, stat, obs, x, shifts)


def test_pac_significance_detects_coupling_and_warns_on_few_cycles(caplog):
    sig = _theta_gamma(n=2048)
    bp = _t(_bank([3.0, 6.0], 2048, sfreq=500.0))
    ba = _t(_bank([30.0, 60.0], 2048, sfreq=500.0))
    pac_, p = tconn.pac_significance(_t(sig), bp, ba, interpolate=True,
                                     n_surrogates=99)
    assert p.shape == pac_.shape == (2, 2)
    assert float(p[1, 1]) == pytest.approx(0.01)
    assert float(p[0, 0]) > 0.05 and float(pac_[1, 1]) > 2 * float(
        pac_[0, 0])
    short = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 256)).astype(np.float32))
    caplog.clear()
    with caplog.at_level("WARNING", logger="ninwavelets_tpu_torch"):
        tconn.pac_significance(short, _t(_bank([6.0], 256, sfreq=250.0)),
                               _t(_bank([50.0], 256, sfreq=250.0)),
                               interpolate=True, n_surrogates=9)
    assert "only 6 cycles" in caplog.text


# -- event-related PAC --------------------------------------------------------

@pytest.mark.parametrize("interpolate", [True, False])
def test_erpac_matches_jax(interpolate):
    sig = _theta_gamma(e=16, n=512, seed=6)
    bp, ba = _pac_banks(512, interpolate=interpolate)
    got = tconn.erpac(_t(sig), _t(bp), _t(ba), interpolate)
    want = jconn.erpac(sig, bp, ba, interpolate)
    assert_rel(got, want)
    np_got = tconn.erpac(sig, bp, ba, interpolate, device="cpu")
    assert torch.equal(np_got, got)


def test_erpac_needs_a_trial_stack():
    bp, ba = _pac_banks(256)
    for mod, x in ((jconn, np.zeros((2, 1, 256), np.float32)),
                   (tconn, torch.zeros(2, 1, 256))):
        with pytest.raises(ValueError, match="erpac needs an"):
            mod.erpac(x, bp, ba)


# -- bicoherence and cross-frequency directionality ---------------------------

def _quadratic(e=8, n=1024, seed=0):
    """10 Hz and 25 Hz with random phases and a 35 Hz component at their
    phase SUM (quadratic coupling), plus noise: (E, 1, N)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SFREQ
    p1 = rng.uniform(0, 2 * np.pi, (e, 1, 1))
    p2 = rng.uniform(0, 2 * np.pi, (e, 1, 1))
    x = (np.sin(2 * np.pi * 10 * t + p1) + np.sin(2 * np.pi * 25 * t + p2)
         + 0.5 * np.sin(2 * np.pi * 35 * t + p1 + p2)
         + 0.3 * rng.standard_normal((e, 1, n)))
    return x.astype(np.float32)


F1, F2 = np.array([6.0, 10.0, 14.0]), np.array([15.0, 25.0, 35.0])


@pytest.mark.parametrize("interpolate", [True, False])
def test_bicoherence_matches_jax(interpolate):
    x = _quadratic()
    sums = (F1[:, None] + F2[None, :]).ravel()
    b1, b2, b12 = (_bank(f, 1024, interpolate) for f in (F1, F2, sums))
    got = text.bicoherence(_t(x), _t(b1), _t(b2), _t(b12), interpolate)
    want = jext.bicoherence(x, b1, b2, b12, interpolate)
    assert_rel(got, want)
    peak = np.unravel_index(int(got[0].argmax()), (3, 3))
    assert peak == (1, 1)                      # (10, 25) Hz


@pytest.mark.parametrize("interpolate", [True, False])
@pytest.mark.parametrize("band", [None, (1, 4)])
def test_cfd_matches_jax(interpolate, band):
    sig = _theta_gamma(seed=7)
    bs = _bank(np.arange(4.0, 10.0, 1.0), 1024, interpolate, 500.0)
    bf = _bank([50.0, 60.0, 70.0], 1024, interpolate, 500.0)
    got = text.cfd(_t(sig), _t(bs), _t(bf), band, interpolate)
    want = jext.cfd(sig, bs, bf, band, interpolate)
    assert_rel(got, want)


# -- lagged coherence ---------------------------------------------------------

@pytest.mark.parametrize("interpolate", [True, False])
@pytest.mark.parametrize("lag,pooled", [(1, False), (2, True), (3, False)])
def test_lagged_coherence_matches_jax(interpolate, lag, pooled):
    x = _quadratic()[:, 0]
    freqs = np.arange(8.0, 40.0, 4.0)
    bank = _bank(freqs, 1024, interpolate)
    got = tconn.lagged_coherence(_t(x), _t(bank), freqs, SFREQ, lag,
                                 interpolate, pooled)
    want = jconn.lagged_coherence(x, bank, freqs, SFREQ, lag, interpolate,
                                  pooled)
    assert_rel(got, want)


@pytest.mark.parametrize("pooled", [True, False])
def test_lagged_coherence_morse_matches_jax(pooled):
    x = _quadratic(e=4, n=2048)[:, 0]
    freqs = np.arange(5.0, 45.0, 5.0)
    got = tconn.lagged_coherence_morse(x, freqs, SFREQ, pooled=pooled,
                                       device="cpu")
    want = jconn.lagged_coherence_morse(x, freqs, SFREQ, pooled=pooled)
    assert_rel(got, want)


def test_lagged_coherence_rhythm_beats_noise():
    rng = np.random.default_rng(0)
    t = np.arange(4096) / SFREQ
    rhythm = (np.sin(2 * np.pi * 20 * t)
              + 0.3 * rng.standard_normal((4, 4096))).astype(np.float32)
    noise = rng.standard_normal((4, 4096)).astype(np.float32)
    lr = tconn.lagged_coherence_morse(rhythm, [20.0], SFREQ, pooled=True,
                                      device="cpu")
    ln = tconn.lagged_coherence_morse(noise, [20.0], SFREQ, pooled=True,
                                      device="cpu")
    assert float(lr[0]) > 0.9 and float(ln[0]) < 0.3


@pytest.mark.parametrize("kind,match", [
    ("shape", "bank must be"), ("lag", "lag must be"),
    ("short", "signal too short")])
def test_lagged_coherence_validation(kind, match):
    freqs = np.array([10.0, 20.0])
    n = 64 if kind == "short" else 512
    bank = _bank(freqs, n)
    args = dict(lag=0 if kind == "lag" else 1)
    if kind == "shape":
        bank = bank[:1]
    x = np.zeros((2, n), np.float32)
    with pytest.raises(ValueError, match=match):
        jconn.lagged_coherence(x, bank, freqs, SFREQ, **args)
    with pytest.raises(ValueError, match=match):
        tconn.lagged_coherence(_t(x), _t(bank), freqs, SFREQ, **args)


# -- the adapter --------------------------------------------------------------

def _adapter(data, sfreq=SFREQ, interpolate=True):
    names = [f"c{i}" for i in range(data.shape[1])]
    jw = nw.Morse(sfreq, interpolate=interpolate)
    return (nw.EpochsWavelet(nw.ArrayEpochs(data, sfreq, ch_names=names),
                             jw),
            nt.EpochsWavelet(nt.ArrayEpochs(data, sfreq, ch_names=names),
                             wavelet_from_jax(jw, device="cpu")))


def test_adapter_nm_plv_and_significance_match_jax():
    a, b = _harmonic(e=8)
    jew, tew = _adapter(np.stack([a, b], axis=1))
    assert_rel(tew.nm_plv("c0", "c1", [10.0, 11.0], n=2, m=1),
               jew.nm_plv("c0", "c1", [10.0, 11.0], n=2, m=1))
    obs, p = tew.plv_significance("c0", "c1", [10.0, 20.0], n_surrogates=19)
    obs_j, _ = jew.plv_significance("c0", "c1", [10.0, 20.0],
                                    n_surrogates=19)
    assert_rel(obs, obs_j)
    assert p.shape == obs.shape == (2, 1024)
    assert float(p.min()) >= 1 / 20 and float(p.max()) <= 1.0


def test_adapter_pac_matches_jax():
    rng = np.random.default_rng(0)
    n, e, sf = 2048, 6, 500.0
    t = np.arange(n) / sf
    data = np.zeros((e, 2, n), np.float32)
    for ep in range(e):
        th = np.sin(2 * np.pi * 6 * t + rng.uniform(0, 6.3))
        gam = (1 + 0.8 * th) * np.sin(2 * np.pi * 60 * t
                                      + rng.uniform(0, 6.3))
        data[ep, 0] = th + 0.3 * rng.standard_normal(n)
        data[ep, 1] = 0.5 * gam + 0.3 * rng.standard_normal(n)
    jew, tew = _adapter(data, sf)
    cross = tew.pac("c0", [6.0], [60.0], ch_amp="c1")
    same = tew.pac("c0", [6.0], [60.0])
    assert_rel(cross, jew.pac("c0", [6.0], [60.0], ch_amp="c1"))
    assert_rel(same, jew.pac("c0", [6.0], [60.0]))
    assert_rel(tew.pac("c0", [4.0, 6.0], [40.0, 60.0], method="tort"),
               jew.pac("c0", [4.0, 6.0], [40.0, 60.0], method="tort"))
    assert float(cross[0, 0]) > 3 * float(same[0, 0])
    pacv, p = tew.pac("c0", [6.0], [60.0], significance=19)
    assert_rel(pacv, same)
    assert p.shape == (1, 1)
    # Validated before any data is fetched: the channel need not exist.
    for ew in (jew, tew):
        with pytest.raises(ValueError, match="same-channel only"):
            ew.pac("c0", [6.0], [60.0], ch_amp="nope", significance=9)


def test_adapter_rhythm_and_cross_frequency_match_jax():
    x = _quadratic(e=6, n=2048)
    rng = np.random.default_rng(1)
    data = np.concatenate([x, rng.standard_normal(x.shape).astype(
        np.float32)], axis=1)
    jew, tew = _adapter(data)
    freqs = np.arange(8.0, 40.0, 4.0)
    assert_rel(tew.lagged_coherence("c0", freqs),
               jew.lagged_coherence("c0", freqs))
    assert_rel(tew.lagged_coherence("c1", freqs, n_cycles=4.0, lag=2),
               jew.lagged_coherence("c1", freqs, n_cycles=4.0, lag=2))
    assert_rel(tew.cfd("c0", [8.0, 9.0, 10.0, 11.0], [30.0, 35.0]),
               jew.cfd("c0", [8.0, 9.0, 10.0, 11.0], [30.0, 35.0]))
    assert_rel(tew.erpac("c0", [10.0], [35.0]),
               jew.erpac("c0", [10.0], [35.0]))
    got = tew.bicoherence("c0", F1, F2)
    assert_rel(got, jew.bicoherence("c0", F1, F2))
    assert got.shape == (3, 3)
    assert_rel(tew.bicoherence("c0", F1), jew.bicoherence("c0", F1))


def test_adapter_bicoherence_checks_nyquist_first(monkeypatch):
    _, tew = _adapter(_quadratic(e=2, n=256))

    def no_bank(*a, **k):
        raise AssertionError("a bank was built before the Nyquist check")

    monkeypatch.setattr(tew, "_conn_bank", no_bank)
    with pytest.raises(ValueError, match="Nyquist"):
        tew.bicoherence("c0", [200.0, 300.0])
