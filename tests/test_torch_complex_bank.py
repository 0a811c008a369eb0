"""The complex-bank (Normal/Twice-mode: MexicanHat, Haar) path of the port
against the JAX package: the three fused epoch reductions and the power's
backward, what surrounds the complex-bank kernels with each kernel replaced
by its contract, the launchers' validation, the dispatch rules, and the
MexicanHat slice end to end through ``EpochsWavelet``.

The same seeded numpy inputs go to both packages.  The JAX Pallas kernels
run with ``interpret=True`` at ``precision="exact"`` and take the complex
bank as its (real, imag) float pair; the port's wrappers run their plain
versions, because the tensors lie on the CPU.  The CUDA kernels themselves
are held against those plain versions on the card by ``chip_smoke.py``.
Gates are ``tests/test_fused.py``'s: power max|d| / max|ref| <= 1e-4, ITC
``rtol=1e-4, atol=1e-5`` on finite cells; gradients ``rtol=1e-4,
atol=1e-5 * max|ref|``.  Where two routes to the same ITC differ in their
FFTs (a real-input against a complex FFT, XLA against torch), ITC is gated
as ``tests/test_torch_cwt.py`` gates it: 1e-4 on cells where every epoch's
|c| is at least 1e-2 of its row max, 2e-3 elsewhere.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ninwavelets_tpu as nw
import ninwavelets_tpu_torch as nt
from ninwavelets_tpu.ops import fused as jfused
from ninwavelets_tpu.ops.bank import make_fft_bank as jbank
from ninwavelets_tpu_torch import kernels
from ninwavelets_tpu_torch.ops import connectivity as tconn
from ninwavelets_tpu_torch.ops import cwt as tcwt
from ninwavelets_tpu_torch.ops import extensions as text
from ninwavelets_tpu_torch.ops import fused as tfused
from ninwavelets_tpu_torch.parallel import StreamingCWT
from test_torch_cwt import assert_itc_close
from test_torch_fit import emulated_fused_cwt_bwd
from torch_threads import one_torch_thread  # noqa: F401

SFREQ = 1000.0
N = 1024
FREQS = np.arange(10.0, 50.0, 5.0)                       # F = 8


def _bank(family, n=N, interpolate=True, freqs=FREQS):
    """A complex Normal-mode bank, built by the JAX package (complex64)."""
    w = getattr(nw, family)(SFREQ)
    bank = np.asarray(jbank(w._wdef(), jnp.asarray(freqs), n, SFREQ,
                            interpolate)).astype(np.complex64)
    assert np.iscomplexobj(bank) and np.abs(bank.imag).max() > 0
    return bank


def _signals(e, c=2, n=N, seed=0):
    return np.random.default_rng(seed).standard_normal((e, c, n)).astype(
        np.float32)


def _check(kind, got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    if kind == "power":
        assert np.abs(got - want).max() / np.abs(want).max() <= 1e-4
    else:
        finite = np.isfinite(want)
        assert np.array_equal(finite, np.isfinite(got))
        np.testing.assert_allclose(got[finite], want[finite], rtol=1e-4,
                                   atol=1e-5)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


# -- forward: the three fused wrappers against the Pallas kernel --------------

JAX_WRAPPERS = {"power": "fused_mean_power", "itc": "fused_itc",
                "power_itc": "fused_power_itc"}
PORT_WRAPPERS = {"power": "fused_mean_power_from_bank",
                 "itc": "fused_itc_from_bank",
                 "power_itc": "fused_power_itc_from_bank"}


@pytest.mark.parametrize("name", ["power", "itc", "power_itc"])
@pytest.mark.parametrize("e", [3, 19])
@pytest.mark.parametrize("interpolate", [True, False])
@pytest.mark.parametrize("family", ["MexicanHat", "Haar"])
def test_complex_bank_wrappers_match_pallas(family, interpolate, e, name):
    """Both families at both ``interpolate`` settings, E = 3 and a ragged
    19 (past the Pallas kernel's 16-epoch chunk)."""
    bank = _bank(family, interpolate=interpolate)
    sig = _signals(e)
    got = getattr(tfused, PORT_WRAPPERS[name])(
        torch.from_numpy(sig), torch.from_numpy(bank), interpolate,
        precision="exact")
    want = getattr(jfused, JAX_WRAPPERS[name])(
        jnp.asarray(sig), jnp.asarray(bank.real), jnp.asarray(bank.imag),
        interpolate=interpolate, interpret=True, precision="exact")
    if name != "power_itc":
        got, want = (got,), (want,)
    for kind, g, w in zip(name.split("_"), got, want):
        _check(kind, g.numpy(), w)


# -- backward: the plain adjoint against the Pallas backward kernel -----------

@pytest.mark.parametrize("interpolate", [True, False])
def test_mean_power_bwd_complex_matches_pallas_backward(interpolate):
    """``mean_power_bwd`` with a complex MexicanHat bank at F = 13 (a ragged
    row group) against the JAX fused backward in interpret mode; dbank is
    PyTorch's convention, the conjugate of JAX's."""
    freqs = np.arange(8.0, 60.0, 4.0)                    # F = 13
    bank = _bank("MexicanHat", n=512, interpolate=interpolate, freqs=freqs)
    rng = np.random.default_rng(7)
    sig = rng.standard_normal((5, 2, 512)).astype(np.float32)
    g = rng.standard_normal((2, 13, 512)).astype(np.float32)
    ds, dbank = tfused.mean_power_bwd(torch.from_numpy(sig),
                                      torch.from_numpy(bank), interpolate,
                                      torch.from_numpy(g))
    assert dbank.dtype == torch.complex64
    ds_k, db_k = jax.jit(lambda s, b, gg: jfused._fused_power_bwd(
        s, b, gg, interpolate, True, "exact"))(
            jnp.asarray(sig), jnp.asarray(bank), jnp.asarray(g))
    db_k = np.asarray(db_k)
    _close(ds, ds_k)
    _close(dbank.real, db_k.real)
    _close(dbank.imag, -db_k.imag)                       # conj(JAX's)


@pytest.mark.parametrize("interpolate", [True, False])
def test_fused_bwd_assembly_around_the_complex_kernel(monkeypatch,
                                                      interpolate):
    """``_fused_power_bwd`` with the complex-bank backward kernel replaced
    by its contract (dbank_part = sum_e u conj(S), t = conj(bank) u, two
    rows a group), at a ragged row group: the complex dbank it completes
    equals ``mean_power_bwd``."""
    freqs = np.arange(8.0, 60.0, 4.0)
    bank = torch.from_numpy(_bank("Haar", n=512, interpolate=interpolate,
                                  freqs=freqs))
    rng = np.random.default_rng(8)
    sig = torch.from_numpy(rng.standard_normal((3, 2, 512)).astype(
        np.float32))
    g = torch.from_numpy(rng.standard_normal((2, 13, 512)).astype(
        np.float32))
    calls = []

    def kernel(spec, bank_, g_, k_bins):
        calls.append((bank_.dtype, bank_.is_contiguous(), k_bins))
        return emulated_fused_cwt_bwd(spec, bank_, g_, k_bins, rows=2)

    monkeypatch.setattr(kernels, "fused_cwt_bwd", kernel)
    ds, dbank = tfused._fused_power_bwd(sig, bank, g, interpolate)
    assert calls == [(torch.complex64, True, 256 if interpolate else 512)]
    assert dbank.dtype == torch.complex64 and ds.dtype == torch.float32
    ds_ref, dbank_ref = tfused.mean_power_bwd(sig, bank, interpolate, g)
    _close(ds, ds_ref.numpy())
    _close(torch.view_as_real(dbank), torch.view_as_real(dbank_ref).numpy())


def emulated_fused_cwt(epilogue, spec, bank, k_bins, precision):
    """The contract of ``kernels.fused_cwt`` for the epoch reductions, in
    plain torch, for a real or complex bank."""
    del precision
    n = bank.shape[-1]
    s = torch.nn.functional.pad(spec[..., :k_bins], (0, n - k_bins))
    x = torch.fft.ifft(s[:, :, None] * bank)                  # (E, C, F, N)
    power = (x.real ** 2 + x.imag ** 2).mean(0)
    itc = (x / x.abs()).mean(0).abs()
    return {"power": [power], "itc": [itc], "power_itc": [power, itc]}[
        epilogue]


@pytest.mark.parametrize("epilogue", ["power", "itc", "power_itc"])
@pytest.mark.parametrize("interpolate", [True, False])
def test_launch_with_complex_bank_contract(monkeypatch, epilogue,
                                           interpolate):
    """``_launch`` hands a complex bank to the kernel as contiguous
    complex64 with the spectra of the right length, and the kernel's
    contract gives the plain reductions."""
    bank = torch.from_numpy(_bank("MexicanHat", interpolate=interpolate))
    sig = torch.from_numpy(_signals(4))
    calls = []

    def kernel(epi, spec, bank_, k_bins, precision):
        calls.append((epi, tuple(spec.shape), bank_.dtype, k_bins))
        return emulated_fused_cwt(epi, spec, bank_, k_bins, precision)

    monkeypatch.setattr(kernels, "fused_cwt", kernel)
    got = tfused._launch(epilogue, sig, bank.to(torch.complex128),
                         interpolate, "exact")
    k = N // 2 if interpolate else N
    assert calls == [(epilogue, (4, 2, N // 2 + 1 if interpolate else N),
                      torch.complex64, k)]
    want = {"power": [tcwt.mean_power_from_bank(sig, bank, interpolate)],
            "itc": [tcwt.itc_from_bank(sig, bank, interpolate)]}
    want["power_itc"] = want["power"] + want["itc"]
    coeffs = tcwt.cwt_from_bank(sig, bank, interpolate)
    for kind, g, w in zip(epilogue.split("_"), got, want[epilogue]):
        if kind == "power":
            _check(kind, g.numpy(), w.numpy())
        else:       # two FFT routes: the launch's real-input FFT, the plain
            assert_itc_close(g.numpy(), w.numpy(), coeffs)    # complex one


def test_launch_refuses_complex_bank_for_per_signal_power():
    bank = torch.from_numpy(_bank("MexicanHat"))
    with pytest.raises(ValueError, match="power_each"):
        tfused._fused_power_each_into(torch.zeros(4, 1, N), bank, True,
                                      torch.zeros((4, 1, 5, N)), (0, N))


# -- the launchers' validation (no build attempted) ---------------------------

@pytest.fixture
def no_build(monkeypatch):
    def fail():
        raise AssertionError("the launcher tried to build")
    monkeypatch.setattr(kernels, "_load", fail)


def _spec(e=2, c=3, n=N):
    return torch.zeros((e, c, n // 2 + 1), dtype=torch.complex64)


@pytest.mark.parametrize("epilogue", ["power", "itc", "power_itc"])
def test_launcher_takes_complex64_for_the_reductions(no_build, epilogue):
    """A contiguous complex64 bank passes every check but the device one
    (these tensors lie on the CPU)."""
    with pytest.raises(ValueError, match="CUDA"):
        kernels.fused_cwt(epilogue, _spec(), torch.zeros(
            (5, N), dtype=torch.complex64), N // 2, "exact")
    with pytest.raises(ValueError, match="CUDA"):
        kernels.fused_cwt_bwd(_spec(), torch.zeros((5, N),
                                                   dtype=torch.complex64),
                              torch.zeros((3, 5, N)), N // 2)


@pytest.mark.parametrize("call,match", [
    (lambda b: kernels.fused_cwt("power", _spec(), b.to(torch.complex128),
                                 N // 2, "exact"), "complex64"),
    (lambda b: kernels.fused_power_each(_spec(), b, N // 2, torch.zeros(
        (2, 3, 5, N)), (0, N)), "power_each"),
    (lambda b: kernels.fused_cwt("amax", _spec(), b, N // 2, "exact"),
     "amax"),
    (lambda b: kernels.fused_cwt_bwd(_spec(), b.to(torch.complex128),
                                     torch.zeros((3, 5, N)), N // 2),
     "complex64"),
    (lambda b: kernels.fused_cwt_pair("coherence", _spec(), _spec(), b,
                                      N // 2), "float32"),
    (lambda b: kernels.fused_cwt_pair("plv", _spec(), _spec(), b, N // 2),
     "float32"),
    (lambda b: kernels.fused_ssq(_spec(), b, torch.zeros((3, 2)),
                                 ("lin", 1.0, 1.0), SFREQ), "float32"),
    (lambda b: kernels.fused_cwt("power", _spec(), b[:, ::2], N // 2,
                                 "exact"), "contiguous"),
])
def test_launchers_reject_complex_banks_elsewhere(no_build, call, match):
    """complex128; a complex bank for "power_each", "amax", the pair kernel
    and the synchrosqueezing kernel; a strided complex bank."""
    before = dict(kernels.launches)
    with pytest.raises(ValueError, match=match):
        call(torch.zeros((5, N), dtype=torch.complex64))
    assert kernels.launches == before


def test_complex_launch_counters_have_their_own_keys():
    for key in ("power_cx", "itc_cx", "power_itc_cx", "power_bwd_cx"):
        assert key in kernels.launches
    assert kernels.COMPLEX_EPILOGUES == ("power", "itc", "power_itc")


# -- dispatch -----------------------------------------------------------------

def test_supports_rejects_complex_banks_the_reductions_ask_the_real_part():
    bank = torch.from_numpy(_bank("MexicanHat"))
    sig = torch.from_numpy(_signals(3))
    assert not tfused.supports(sig.shape, bank)
    assert not tfused.route("power_each", sig, bank).takes
    assert tfused.route("power", sig, bank).key == "power_cx"
    assert not tfused.route("power", sig.to(torch.complex64), bank).takes
    assert not tfused.route("power", sig[..., :1000], bank[:, :1000]).takes
    assert not tfused.supports_ssq(sig.shape, bank, ("lin", 1.0, 1.0), True)
    # What scattering's "auto" asks of each bank.
    assert not tfused.route("power_each", (1, 1, N), bank,
                            device=sig.device).takes


@pytest.mark.parametrize("auto,wrapper", [
    ("mean_power_auto", "fused_mean_power_from_bank"),
    ("itc_auto", "fused_itc_from_bank"),
    ("power_itc_auto", "fused_power_itc_from_bank")])
def test_reduction_autos_route_complex_banks_to_the_kernel(monkeypatch, auto,
                                                           wrapper):
    bank = torch.from_numpy(_bank("Haar"))
    sig = torch.from_numpy(_signals(3))
    calls = []
    monkeypatch.setattr(tfused, wrapper, lambda *a: calls.append(a) or "k")
    assert getattr(tfused, auto)(sig, bank, interpolate=True) == "k"
    assert len(calls) == 1 and calls[0][1] is bank


def _refuse(*args, **kw):
    raise AssertionError("a complex bank reached a kernel wrapper")


def test_other_dispatchers_keep_the_plain_path(monkeypatch):
    """``power_auto`` and every pair ``*_auto`` run the plain path for a
    complex bank; fused streaming refuses it."""
    for name in ("fused_power_from_bank", "fused_coherence", "fused_imcoh",
                 "fused_plv", "fused_ppc", "fused_phase_lag"):
        monkeypatch.setattr(tfused, name, _refuse)
    bank = torch.from_numpy(_bank("MexicanHat"))
    a = torch.from_numpy(_signals(4, seed=1))
    b = torch.from_numpy(_signals(4, seed=2))
    torch.testing.assert_close(tfused.power_auto(a, bank, interpolate=True),
                               tcwt.power_from_bank(a, bank, True))
    torch.testing.assert_close(
        text.epoch_coherence_auto(a, b, bank, interpolate=True),
        text.epoch_coherence(a, b, bank, True))
    torch.testing.assert_close(text.imcoh_auto(a, b, bank, interpolate=True),
                               text.imcoh(a, b, bank, True))
    torch.testing.assert_close(tconn.plv_auto(a, b, bank, interpolate=True),
                               tconn.plv(a, b, bank, True))
    torch.testing.assert_close(tconn.ppc_auto(a, b, bank, interpolate=True),
                               tconn.ppc(a, b, bank, True))
    torch.testing.assert_close(
        tconn.phase_lag_auto(a, b, bank, interpolate=True),
        tconn.phase_lag(a, b, bank, "wpli", True))
    with pytest.raises(ValueError, match="real bank"):
        StreamingCWT(nt.MexicanHat(SFREQ, device="cpu")._wdef(), FREQS,
                     SFREQ, window=800, halo=100, use_fused=True,
                     device="cpu")


def test_cpu_complex_bank_calls_launch_nothing():
    bank = torch.from_numpy(_bank("MexicanHat"))
    sig = torch.from_numpy(_signals(3))
    before = dict(kernels.launches)
    tfused.mean_power_auto(sig, bank, interpolate=True)
    tfused.itc_auto(sig, bank, interpolate=True)
    tfused.power_itc_auto(sig, bank, interpolate=True)
    assert kernels.launches == before


def test_complex_bank_autograd_on_cpu_is_the_plain_adjoint():
    """The autograd Function with a complex bank on the CPU: its backward is
    ``mean_power_bwd``, equal to torch autograd of the plain forward."""
    bank = torch.from_numpy(_bank("MexicanHat", n=512, interpolate=False))
    sig = torch.from_numpy(_signals(3, n=512))
    w = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, len(FREQS), 512)).astype(np.float32))
    grads = []
    for fn in (tfused.fused_mean_power_from_bank, tcwt.mean_power_from_bank):
        s, b = sig.clone().requires_grad_(True), bank.clone().requires_grad_(
            True)
        grads.append(torch.autograd.grad((w * fn(s, b, False)).sum(),
                                         (s, b)))
    _close(grads[0][0], grads[1][0].numpy())
    _close(torch.view_as_real(grads[0][1]),
           torch.view_as_real(grads[1][1]).numpy())


# -- the MexicanHat slice end to end ------------------------------------------

RTOL = 1e-4


def _adapters(family, interpolate, e=4, c=3, n=N, seed=0):
    data = np.random.default_rng(seed).standard_normal((e, c, n))
    jw = getattr(nw, family)(SFREQ, interpolate=interpolate)
    tw = getattr(nt, family)(SFREQ, interpolate=interpolate, device="cpu")
    return (nw.EpochsWavelet(nw.ArrayEpochs(data, SFREQ), jw),
            nt.EpochsWavelet(nt.ArrayEpochs(data, SFREQ), tw))


def _zscores_close(got, want, power, baseline):
    """The z-score gate of ``test_torch_slice.py``: a power error of at
    most RTOL x the row's max P moves z by at most 2 RTOL P (1 + |z|) /
    std, cell by cell."""
    got, want, power = (np.asarray(x, np.float64) for x in (got, want, power))
    window = power[..., int(baseline[0] * SFREQ):int(baseline[1] * SFREQ)]
    std = window.std(-1, keepdims=True)
    std = np.where(std > 0, std, 1.0)
    bound = 2 * RTOL * power.max(-1, keepdims=True) * (1 + np.abs(want)) / std
    assert (np.abs(got - want) <= bound).all()


@pytest.mark.parametrize("interpolate", [False, True])
@pytest.mark.parametrize("family", ["MexicanHat", "Haar"])
def test_epochs_wavelet_complex_family_matches_jax(family, interpolate):
    """``EpochsWavelet`` over a Normal-mode family: ``power_all`` with a
    z-score baseline, ``itc_all`` and ``power_itc_all`` against the JAX
    adapter (which runs the XLA path on the CPU)."""
    jew, tew = _adapters(family, interpolate)
    assert tew.wavelet.device == torch.device("cpu")
    got = tew.power_all(FREQS, baseline=(0.0, 0.2))
    assert tew.wavelet.fft_wavelets.dtype == torch.complex64
    _zscores_close(got.numpy(), jew.power_all(FREQS, baseline=(0.0, 0.2)),
                   jew.power_all(FREQS), (0.0, 0.2))
    coeffs = tew.cwt_all(FREQS)
    assert_itc_close(tew.itc_all(FREQS).numpy(), np.asarray(jew.itc_all(
        FREQS)), coeffs)
    p, i = tew.power_itc_all(FREQS)
    wp, wi = jew.power_itc_all(FREQS)
    _check("power", p.numpy(), wp)
    assert_itc_close(i.numpy(), np.asarray(wi), coeffs)
