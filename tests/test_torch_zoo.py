"""The rest of the wavelet zoo in the port against the JAX package: the
Paul / DOG / Bump spectra and classes, the multitaper Morse family, superlets,
``MorseMNE``'s missing-mne path, the ``EpochsWavelet`` power variants, and
the full-float32 pairwise sums behind the matrices.

The same seeded numpy inputs go to both packages; every port object runs on
the CPU (``device="cpu"``), where ``power_auto`` and ``mean_power_auto`` take
the plain path.  On the card the same calls reach the fused kernels ("power"
for the multitaper epoch mean, "power_each" for superlets and single-trial
power), which ``chip_smoke.py`` holds against the plain path.  Gates: banks
and spectra max|d| / max|ref| <= 1e-5; power planes and matrices <= 1e-4
(``tests/test_fused.py``'s power gate).
"""
import importlib.util
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ninwavelets_tpu as nw
import ninwavelets_tpu_torch as nt
from ninwavelets_tpu.ops import extensions as jext
from ninwavelets_tpu.ops import multitaper as jmt
from ninwavelets_tpu.ops import superlets as jsl
from ninwavelets_tpu_torch.ops import connectivity as tconn
from ninwavelets_tpu_torch.ops import cwt as tcwt
from ninwavelets_tpu_torch.ops import extensions as text
from ninwavelets_tpu_torch.ops import grids as tgrids
from ninwavelets_tpu_torch.ops import multitaper as tmt
from ninwavelets_tpu_torch.ops import superlets as tsl

from torch_threads import one_torch_thread  # noqa: F401

SFREQ = 1000.0
N = 1024
FREQS = np.arange(8.0, 72.0, 8.0)                        # F = 8
RTOL = 1e-4


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    return np.abs(got - want).max() / np.abs(want).max()


def _signals(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _tone(n=N, seed=0):
    t = np.arange(n) / SFREQ
    return (np.sin(2 * np.pi * 40.0 * t)
            + 0.1 * _signals(n, seed=seed)).astype(np.float32)


# -- Paul, DOG, Bump ----------------------------------------------------------

SPECTRA = [("paul_spectrum", 4.0), ("paul_spectrum", 2.0),
           ("dog_spectrum", 2.0), ("dog_spectrum", 6.0),
           ("bump_spectrum", 0.6), ("bump_spectrum", 0.2)]


@pytest.mark.parametrize("name,param", SPECTRA)
def test_spectra_match_jax(name, param):
    grid = np.asarray(tgrids.fft_bin_freqs(N, SFREQ))
    col = FREQS[:, None].astype(np.float32)
    got = getattr(text, name)(torch.from_numpy(grid[None]),
                              torch.from_numpy(col), param)
    want = getattr(jext, name)(jnp.asarray(grid[None]), jnp.asarray(col),
                               param)
    assert got.dtype == torch.float32 and got.shape == (len(FREQS), N)
    assert _rel(got.numpy(), want) <= 1e-5
    peak = grid[np.asarray(got).argmax(-1)]
    np.testing.assert_allclose(peak, FREQS, atol=SFREQ / N)   # peak at freq
    assert float(got.max()) <= 2.0 + 1e-5


@pytest.mark.parametrize("interpolate", [False, True])
@pytest.mark.parametrize("family", ["Paul", "DOG", "Bump"])
def test_extension_families_match_jax(family, interpolate):
    jw = getattr(nw, family)(SFREQ, interpolate=interpolate)
    tw = getattr(nt, family)(SFREQ, interpolate=interpolate, device="cpu")
    assert tw.mode.name == jw.mode.name == "Reverse"
    bank = tw.make_fft_wavelets(FREQS, N / SFREQ)
    assert bank.dtype == torch.float32
    assert _rel(bank.numpy(), jw.make_fft_wavelets(FREQS, N / SFREQ)) <= 1e-5
    sig = _signals(2, N)
    assert _rel(tw.power(sig, FREQS, reuse=False).numpy(),
                jw.power(sig, FREQS, reuse=False)) <= RTOL
    p = tw.power(_tone(), FREQS, reuse=False)
    assert FREQS[int(p.mean(-1).argmax())] == 40.0


def test_extension_family_parameters():
    assert nt.Paul(SFREQ, m=6.0, device="cpu").m == 6.0
    assert nt.DOG(SFREQ, device="cpu").m == 2.0
    assert nt.Bump(SFREQ, device="cpu").sigma == 0.6
    assert nt.Paul(SFREQ, cuda=False).device == torch.device("cpu")


# -- MorseMNE -----------------------------------------------------------------

def test_morse_mne_without_mne_raises_import_error():
    if importlib.util.find_spec("mne") is not None:
        pytest.skip("mne is installed")
    w = nt.MorseMNE(SFREQ, device="cpu")
    assert isinstance(w, nt.Morse)
    with pytest.raises(ImportError, match="mne"):
        w.cwt(_tone(), FREQS)
    # the rest of the class is Morse's
    assert _rel(w.power(_tone(), FREQS).numpy(),
                nt.Morse(SFREQ, device="cpu").power(_tone(), FREQS)) == 0


def test_morse_mne_sends_a_tensor_to_the_host(monkeypatch):
    """``MorseMNE.cwt`` hands mne a host numpy array even for a tensor that
    numpy cannot read directly (one on the card, or one that needs grad, as
    here), and returns the epoch mean as a tensor.  A stand-in ``tfr``
    module records what mne would get."""
    seen = {}

    def cwt(wave, wavelets, use_fft, mode, decim):
        seen["wave"] = wave
        return np.ones((wave.shape[0], len(wavelets), wave.shape[-1]),
                       np.complex64)

    tfr = types.SimpleNamespace(cwt=cwt)
    monkeypatch.setitem(sys.modules, "mne", types.ModuleType("mne"))
    monkeypatch.setitem(sys.modules, "mne.time_frequency",
                        types.SimpleNamespace(tfr=tfr))
    wave = torch.from_numpy(_tone()).requires_grad_()
    out = nt.MorseMNE(SFREQ, device="cpu").cwt(wave, FREQS)
    assert isinstance(seen["wave"], np.ndarray)
    np.testing.assert_array_equal(seen["wave"], _tone()[None])
    assert isinstance(out, torch.Tensor) and out.shape == (len(FREQS), N)


# -- multitaper ---------------------------------------------------------------

@pytest.mark.parametrize("interpolate", [False, True])
def test_multitaper_banks_match_jax(interpolate):
    got = tmt.multitaper_banks(FREQS, N, SFREQ, n_tapers=4,
                               interpolate=interpolate, device="cpu")
    want = jmt.multitaper_banks(FREQS, N, SFREQ, n_tapers=4,
                                interpolate=interpolate)
    assert got.shape == (len(FREQS), 4, N) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= 1e-5
    assert tmt.morse_taper_def(17.5, 3.0, 2) is tmt.morse_taper_def(
        17.5, 3.0, 2)


@pytest.mark.parametrize("interpolate", [False, True])
def test_multitaper_power_matches_jax(interpolate):
    sig = _signals(3, N)
    got = tmt.multitaper_power(torch.from_numpy(sig), FREQS, SFREQ,
                               interpolate=interpolate)
    want = jmt.multitaper_power(sig, FREQS, SFREQ, interpolate=interpolate)
    assert got.shape == (3, len(FREQS), N)
    assert _rel(got.numpy(), want) <= RTOL
    banks = tmt.multitaper_banks(FREQS, N, SFREQ, interpolate=interpolate,
                                 device="cpu")
    plain = tcwt.power_from_bank(torch.from_numpy(sig),
                                 banks.reshape(-1, N), interpolate)
    torch.testing.assert_close(got, plain.reshape(3, len(FREQS), 3, N)
                               .mean(-2))


def test_multitaper_weights_and_one_taper_is_morse():
    sig = torch.from_numpy(_signals(2, N))
    banks = tmt.multitaper_banks(FREQS, N, SFREQ, n_tapers=3, device="cpu")
    w = [0.5, 0.3, 0.2]
    got = tmt.multitaper_power_from_banks(sig, banks, weights=w)
    want = jmt.multitaper_power_from_banks(jnp.asarray(sig.numpy()),
                                           jnp.asarray(banks.numpy()),
                                           weights=w)
    assert _rel(got.numpy(), want) <= RTOL
    one = tmt.multitaper_power(sig, FREQS, SFREQ, n_tapers=1)
    morse = nt.Morse(SFREQ, device="cpu").power(sig, FREQS)
    assert _rel(one.numpy(), morse.numpy()) <= 1e-5


@pytest.mark.parametrize("interpolate", [False, True])
def test_multitaper_mean_power_matches_jax(interpolate):
    sig = _signals(5, 2, N)
    got = tmt.multitaper_mean_power(torch.from_numpy(sig), FREQS, SFREQ,
                                    interpolate=interpolate)
    want = jmt.multitaper_mean_power(sig, FREQS, SFREQ,
                                     interpolate=interpolate)
    assert got.shape == (2, len(FREQS), N)
    assert _rel(got.numpy(), want) <= RTOL
    cls = nt.MorseMultitaper(SFREQ, interpolate=interpolate, device="cpu")
    torch.testing.assert_close(cls.mean_power(sig, FREQS), got)
    jcls = nw.MorseMultitaper(SFREQ, interpolate=interpolate)
    assert _rel(cls.power(sig[0], FREQS).numpy(),
                jcls.power(sig[0], FREQS)) <= RTOL


@pytest.mark.parametrize("time_range", [None, (100, 900)])
@pytest.mark.parametrize("interpolate", [False, True])
def test_multitaper_coherence_matrix_matches_jax(interpolate, time_range):
    sig = _signals(3, 4, N, seed=2)
    sig[:, 1] += 0.8 * sig[:, 0]                          # a coherent pair
    got = tmt.multitaper_coherence_matrix(torch.from_numpy(sig), FREQS,
                                          SFREQ, interpolate=interpolate,
                                          time_range=time_range)
    want = jmt.multitaper_coherence_matrix(sig, FREQS, SFREQ,
                                           interpolate=interpolate,
                                           time_range=time_range)
    assert got.shape == (len(FREQS), 4, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-5)
    np.testing.assert_allclose(torch.diagonal(got, dim1=1, dim2=2).numpy(),
                               1.0, rtol=1e-5)


def test_pair_sums_run_in_full_float32_and_restore_the_setting(monkeypatch):
    """``_pair_sums`` runs its products at "highest" whatever the process
    set ("high" would allow TF32 on the card), and gives the setting back:
    through ``plv_matrix`` and ``multitaper_coherence_matrix``."""
    prev = torch.get_float32_matmul_precision()
    seen = []
    bmm = torch.bmm

    def spy(*args, **kw):
        seen.append(torch.get_float32_matmul_precision())
        return bmm(*args, **kw)

    monkeypatch.setattr(torch, "bmm", spy)
    sig = torch.from_numpy(_signals(3, 4, 512))
    bank = nt.Morse(SFREQ, device="cpu").make_fft_wavelets(FREQS, 0.512)
    try:
        torch.set_float32_matmul_precision("high")
        out = tconn.plv_matrix(sig, bank)
        assert torch.get_float32_matmul_precision() == "high"
        tmt.multitaper_coherence_matrix(sig, FREQS[:2], SFREQ)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)
    assert seen and set(seen) == {"highest"}
    assert len(seen) == 2 * (len(FREQS) + 2)
    np.testing.assert_allclose(torch.diagonal(out, dim1=1, dim2=2).numpy(),
                               1.0, rtol=1e-5)


# -- superlets ----------------------------------------------------------------

@pytest.mark.parametrize("order_min,order_max,adaptive", [
    (1, 8, True), (2, 5, True), (1, 4, False)])
def test_superlet_weights_match_jax(order_min, order_max, adaptive):
    got = tsl.superlet_weights(FREQS, order_min, order_max, adaptive)
    want = jsl.superlet_weights(FREQS, order_min, order_max, adaptive)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_superlet_weights_reject_bad_orders():
    with pytest.raises(ValueError):
        tsl.superlet_weights(FREQS, 3, 2)


@pytest.mark.parametrize("interpolate", [False, True])
def test_superlet_banks_match_jax(interpolate):
    got = tsl.superlet_banks(FREQS, N, SFREQ, 3.0, 5, interpolate,
                             device="cpu")
    want = jsl.superlet_banks(FREQS, N, SFREQ, 3.0, 5, interpolate)
    assert got.shape == (5, len(FREQS), N) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("adaptive", [True, False])
@pytest.mark.parametrize("interpolate", [False, True])
def test_superlet_power_matches_jax(interpolate, adaptive):
    sig = _signals(2, N, seed=3)
    kw = dict(order_min=1, order_max=5, adaptive=adaptive,
              interpolate=interpolate)
    got = tsl.superlet_power(torch.from_numpy(sig), FREQS, SFREQ, **kw)
    want = jsl.superlet_power(jnp.asarray(sig), FREQS, SFREQ, **kw)
    assert got.shape == (2, len(FREQS), N)
    assert _rel(got.numpy(), want) <= RTOL
    banks = tsl.superlet_banks(FREQS, N, SFREQ, 3.0, 5, interpolate,
                               device="cpu")
    w = torch.from_numpy(tsl.superlet_weights(FREQS, 1, 5, adaptive))
    logs = torch.stack([torch.log(torch.clamp(tcwt.power_from_bank(
        torch.from_numpy(sig), b, interpolate), min=1e-30)) for b in banks])
    plain = torch.exp((w[:, None, :, None] * logs).sum(0) / w.sum(0)[:, None])
    torch.testing.assert_close(got, plain)


@pytest.mark.parametrize("adaptive", [True, False])
def test_superlet_mean_power_matches_jax(monkeypatch, adaptive):
    """The epoch mean in chunks (here of 2 epochs, forced by a small
    ``CHUNK_BYTES``) equals the JAX package's one-epoch scan."""
    sig = _signals(5, 2, N, seed=4)
    kw = dict(order_min=1, order_max=4, adaptive=adaptive, interpolate=True)
    want = jsl.superlet_mean_power(jnp.asarray(sig), FREQS, SFREQ, **kw)
    got = tsl.superlet_mean_power(torch.from_numpy(sig), FREQS, SFREQ, **kw)
    assert got.shape == (2, len(FREQS), N)
    assert _rel(got.numpy(), want) <= RTOL
    monkeypatch.setattr(tsl, "CHUNK_BYTES", 2 * 4 * 2 * len(FREQS) * N)
    chunked = tsl.superlet_mean_power(torch.from_numpy(sig), FREQS, SFREQ,
                                      **kw)
    assert _rel(chunked.numpy(), want) <= RTOL
    cls = nt.Superlet(SFREQ, order_max=4, adaptive=adaptive,
                      interpolate=True, device="cpu")
    torch.testing.assert_close(cls.mean_power(sig, FREQS), got)
    jcls = nw.Superlet(SFREQ, order_max=4, adaptive=adaptive,
                       interpolate=True)
    assert _rel(cls.power(sig[0], FREQS).numpy(),
                jcls.power(sig[0], FREQS)) <= RTOL


# -- the adapter's power variants ---------------------------------------------

def _adapters(interpolate, e=4, c=3, n=N, seed=0):
    data = np.random.default_rng(seed).standard_normal((e, c, n))
    data[:, 0] += np.sin(2 * np.pi * 40.0 * np.arange(n) / SFREQ)
    jw = nw.Morse(SFREQ, b=12.0, r=3.0, interpolate=interpolate)
    tw = nt.Morse(SFREQ, b=12.0, r=3.0, interpolate=interpolate,
                  device="cpu")
    return (nw.EpochsWavelet(nw.ArrayEpochs(data, SFREQ), jw),
            nt.EpochsWavelet(nt.ArrayEpochs(data, SFREQ), tw))


METHODS = [
    ("superlet_power", ("ch0", FREQS), dict(order_max=4)),
    ("multitaper_power", ("ch1", FREQS), dict(n_tapers=2)),
    ("induced_power", ("ch0", FREQS), {}),
    ("induced_power", ("ch2", FREQS),
     dict(baseline=(0.0, 0.1), baseline_method="mean", decim=2)),
    ("evoked_power", ("ch0", FREQS), {}),
    ("evoked_power", ("ch1", FREQS),
     dict(baseline=(0.0, 0.1), baseline_method="mean", decim=4)),
    ("single_trial_power", ("ch2", FREQS), {}),
    ("single_trial_power_all", (FREQS,), {}),
    ("single_trial_power_all", (FREQS,),
     dict(baseline=(0.0, 0.1), baseline_method="mean", decim=2)),
]


@pytest.mark.parametrize("interpolate", [False, True])
@pytest.mark.parametrize("method,args,kw", METHODS)
def test_adapter_power_variants_match_jax(method, args, kw, interpolate):
    jew, tew = _adapters(interpolate)
    got = getattr(tew, method)(*args, **kw)
    want = getattr(jew, method)(*args, **kw)
    assert got.device == torch.device("cpu")
    assert _rel(got.numpy(), want) <= RTOL


@pytest.mark.parametrize("time_range", [None, (0.1, 0.9)])
def test_adapter_multitaper_coherence_matrix_matches_jax(time_range):
    jew, tew = _adapters(True)
    got = tew.multitaper_coherence_matrix(FREQS, n_tapers=2,
                                          time_range=time_range)
    want = jew.multitaper_coherence_matrix(FREQS, n_tapers=2,
                                           time_range=time_range)
    assert got.shape == (len(FREQS), 3, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-5)


def test_adapter_evoked_of_a_phase_locked_tone_peaks_at_its_row():
    _, tew = _adapters(True)
    p = tew.evoked_power("ch0", FREQS)
    assert FREQS[int(p.mean(-1).argmax())] == 40.0
    induced = tew.induced_power("ch0", FREQS)
    assert float(induced[FREQS == 40.0].mean()) < float(
        p[FREQS == 40.0].mean())
