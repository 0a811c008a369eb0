"""The port's gradient path against the JAX package: the plain adjoint
``mean_power_bwd``, the autograd Functions around the fused wrappers, and the
training entry points ``learn_bank`` / ``fit_frequencies``.

The same seeded numpy inputs go to both packages.  The JAX Pallas kernels run
with ``interpret=True`` at ``precision="exact"``; the port's wrappers run
their plain versions, because the tensors lie on the CPU.  The fused
backward kernel itself is held against ``mean_power_bwd`` on the card by
``chip_smoke.py``.  Gradient gates are ``tests/test_fused.py``'s:
``rtol=1e-4, atol=1e-5 * max|ref|``; training gates are
``tests/test_fit.py``'s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ninwavelets_tpu as nw
import ninwavelets_tpu_torch as nt
from ninwavelets_tpu.ops import fit as jfit
from ninwavelets_tpu.ops import fused as jfused
from ninwavelets_tpu.ops.bank import make_fft_bank as jbank
from ninwavelets_tpu.ops.bank import make_fft_bank_ri as jbank_ri
from ninwavelets_tpu.ops.cwt import mean_power_from_bank as jpower
from ninwavelets_tpu_torch import kernels
from ninwavelets_tpu_torch.ops import cwt as tcwt
from ninwavelets_tpu_torch.ops import fit as tfit
from ninwavelets_tpu_torch.ops import fused as tfused

from torch_threads import one_torch_thread  # noqa: F401

SFREQ = 1000.0


def _workload(e, c, f, n=2048, interpolate=True, seed=0):
    bank = np.array(jbank(nw.Morse(SFREQ)._wdef(), jnp.arange(1.0, f + 1.0),
                          n, SFREQ, interpolate), np.float32)
    rng = np.random.default_rng(seed)
    sig = rng.standard_normal((e, c, n)).astype(np.float32)
    g = rng.standard_normal((c, f, n)).astype(np.float32)
    return sig, bank, g


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


def _t(*arrays, grad=False):
    return [torch.tensor(a).requires_grad_(grad) for a in arrays]


# -- (a) the plain adjoint ---------------------------------------------------

@pytest.mark.parametrize("interpolate", [True, False])
def test_mean_power_bwd_matches_jax_adjoint_and_kernel(interpolate):
    """Against the JAX plain adjoint and the JAX fused backward kernel in
    interpret mode, at a bank count (F = 13) that leaves a ragged
    frequency block."""
    sig, bank, g = _workload(e=5, c=2, f=13, interpolate=interpolate)
    ds, dbank = tfused.mean_power_bwd(*_t(sig, bank), interpolate,
                                      torch.from_numpy(g))
    assert ds.dtype == torch.float32 and dbank.dtype == torch.float32
    js, jb, jg = jnp.asarray(sig), jnp.asarray(bank), jnp.asarray(g)
    ds_w, db_w = jfused._mean_power_bwd(js, jb, interpolate, jg)
    _close(ds, ds_w)
    _close(dbank, db_w)
    ds_k, db_k = jax.jit(lambda s, b, gg: jfused._fused_power_bwd(
        s, b, gg, interpolate, True, "exact"))(js, jb, jg)
    _close(ds, ds_k)
    _close(dbank, db_k)


@pytest.mark.parametrize("interpolate", [True, False])
def test_mean_power_bwd_complex_bank_convention(interpolate):
    """A complex bank gets PyTorch's convention, the conjugate of the JAX
    package's: compared with JAX through the real and imaginary parts, and
    with torch autograd of the plain forward directly."""
    rng = np.random.default_rng(3)
    e, c, f, n = 4, 2, 6, 1024
    sig = rng.standard_normal((e, c, n)).astype(np.float32)
    bank = (rng.standard_normal((f, n))
            + 1j * rng.standard_normal((f, n))).astype(np.complex64)
    g = rng.standard_normal((c, f, n)).astype(np.float32)
    ts, tb = _t(sig, bank, grad=True)
    ds, dbank = tfused.mean_power_bwd(ts.detach(), tb.detach(), interpolate,
                                      torch.from_numpy(g))
    ds_w, db_w = jfused._mean_power_bwd_complex(
        jnp.asarray(sig), jnp.asarray(bank), interpolate, jnp.asarray(g))
    _close(ds, ds_w)
    db_w = np.asarray(db_w)
    _close(dbank.real, db_w.real)
    _close(dbank.imag, -db_w.imag)                   # conj(JAX's)
    p = tcwt.mean_power_from_bank(ts, tb, interpolate)
    gs, gb = torch.autograd.grad(p, (ts, tb), torch.from_numpy(g))
    _close(ds, gs.numpy())
    _close(torch.view_as_real(dbank), torch.view_as_real(gb).numpy())


# -- (b), (c) gradients through the fused power wrapper ----------------------

def _weighted_grads(fn, sig, bank, w, interpolate, wrt=(0, 1)):
    ts, tb = _t(sig, bank)
    args = [ts, tb]
    for i in wrt:
        args[i].requires_grad_(True)
    loss = (torch.from_numpy(w) * fn(*args, interpolate)).sum()
    return [x.numpy() for x in
            torch.autograd.grad(loss, [args[i] for i in wrt])]


@pytest.mark.parametrize("interpolate", [True, False])
def test_fused_power_grads_match_jax_fused(interpolate):
    """Both gradients of a weighted loss, at E = 19 (ragged for the JAX
    package's 16-epoch chunks), against ``jax.grad`` of the JAX fused
    wrapper (fused forward and fused backward, interpret mode)."""
    sig, bank, w = _workload(e=19, c=2, f=16, interpolate=interpolate,
                             seed=7)
    got = _weighted_grads(tfused.fused_mean_power_from_bank, sig, bank, w,
                          interpolate)
    jw = jnp.asarray(w)

    def loss(s, b):
        return jnp.sum(jw * jfused.fused_mean_power_from_bank(
            s, b, interpolate, interpret=True, precision="exact"))

    want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(sig), jnp.asarray(bank))
    for gt, wt in zip(got, want):
        _close(gt, wt)


@pytest.mark.parametrize("wrt", [(0, 1), (0,), (1,)])
@pytest.mark.parametrize("interpolate", [True, False])
def test_fused_power_grads_match_plain_autograd(interpolate, wrt):
    """The Function's backward against torch autograd of the plain
    forward, for each set of inputs that requires grad."""
    sig, bank, w = _workload(e=6, c=2, f=9, n=1024, interpolate=interpolate,
                             seed=8)
    got = _weighted_grads(tfused.fused_mean_power_from_bank, sig, bank, w,
                          interpolate, wrt)
    want = _weighted_grads(tcwt.mean_power_from_bank, sig, bank, w,
                           interpolate, wrt)
    assert len(got) == len(wrt)
    for gt, wt in zip(got, want):
        _close(gt, wt)


def test_fused_power_is_a_function_on_the_cpu():
    """The CPU goes through the autograd Function too, and saves no graph
    of the plain forward: the output's grad_fn is the Function's."""
    sig, bank, _ = _workload(e=2, c=1, f=3, n=512)
    ts, tb = _t(sig, bank, grad=True)
    out = tfused.fused_mean_power_from_bank(ts, tb)
    assert type(out.grad_fn).__name__ == "_FusedMeanPowerBackward"
    torch.testing.assert_close(out.detach(),
                               tcwt.mean_power_from_bank(ts, tb, True)
                               .detach())


# -- (d) the ITC gradient ----------------------------------------------------

def test_fused_itc_grads_match_jax():
    """The signals gradient of sum(ITC) against ``jax.grad`` of the JAX
    fused ITC, on ``tests/test_fused.py``'s inputs and gate.  The ITC
    gradient weighs each coefficient by 1/|c|, so it is ill-conditioned in
    float32: for other seeds and weights, JAX and torch each differ from a
    float64 reference by ~5e-4 of the max, more than the gate.  The bank
    gradient is held against torch autograd of the plain ITC, the
    computation the Function's backward runs."""
    sig, bank, _ = _workload(e=4, c=2, f=16, seed=0)
    ones = np.ones((2, 16, 2048), np.float32)
    got = _weighted_grads(tfused.fused_itc_from_bank, sig, bank, ones, True)
    want = jax.grad(lambda s: jnp.sum(jfused.fused_itc_from_bank(
        s, jnp.asarray(bank), True, interpret=True, precision="exact")))(
        jnp.asarray(sig))
    _close(got[0], want)
    plain = _weighted_grads(tcwt.itc_from_bank, sig, bank, ones, True)
    _close(got[1], plain[1])
    ts, tb = _t(sig, bank, grad=True)
    out = tfused.fused_itc_from_bank(ts, tb)
    assert type(out.grad_fn).__name__ == "_FusedItcBackward"


# -- (g) power_itc never returns detached planes ----------------------------

@pytest.mark.parametrize("wrt", [0, 1])
def test_power_itc_outputs_carry_the_graph_on_the_cpu(wrt):
    sig, bank, _ = _workload(e=3, c=1, f=4, n=512)
    args = _t(sig, bank)
    args[wrt].requires_grad_(True)
    p, i = tfused.fused_power_itc_from_bank(*args)
    assert p.grad_fn is not None and i.grad_fn is not None
    (p.sum() + i.sum()).backward()
    assert args[wrt].grad is not None
    assert bool(args[wrt].grad.isfinite().all())


# -- (e), (f) the training entry points --------------------------------------

N_FIT = 1024


def _tone_epochs(f0=60.0, e=6, seed=0, n=N_FIT):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SFREQ
    return np.stack([
        np.sin(2 * np.pi * f0 * t + rng.uniform(0, 2 * np.pi))
        + 0.2 * rng.standard_normal(n) for _ in range(e)
    ]).astype(np.float32)[:, None, :]


@pytest.mark.parametrize("use_fused", [False, True])
def test_learn_bank_matches_jax(use_fused):
    """Ten steps from a perturbed Morse bank, against the JAX package's
    ``learn_bank`` (XLA path) at ``tests/test_fit.py``'s trajectory gates:
    losses rtol 1e-3, bank rtol 1e-2 (Adam turns float32 gradient
    differences near eps into lr-sized steps)."""
    freqs = np.arange(30.0, 90.0, 10.0, np.float32)
    bank0 = np.array(jbank(nw.Morse(SFREQ)._wdef(), jnp.asarray(freqs), 2048,
                           SFREQ, True), np.float32)
    sig = np.random.default_rng(2).standard_normal((4, 1, 2048)).astype(
        np.float32)
    target = np.asarray(jpower(jnp.asarray(sig), jnp.asarray(bank0), True))
    b_j, l_j = jfit.learn_bank(jnp.asarray(sig), jnp.asarray(bank0 * 1.2),
                               jnp.asarray(target), steps=10, lr=1e-3)
    b_t, l_t = tfit.learn_bank(*_t(sig, bank0 * 1.2, target), loss="mse",
                               steps=10, lr=1e-3, use_fused=use_fused)
    assert l_t.shape == (10,) and b_t.shape == bank0.shape
    assert not b_t.requires_grad
    np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j), rtol=1e-3,
                               atol=1e-7)
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), rtol=1e-2,
                               atol=1e-5)
    assert float(l_t[-1]) < float(l_t[0])


def test_learn_bank_power_loss_and_errors():
    freqs = np.arange(30.0, 90.0, 5.0, np.float32)
    bank0 = np.array(jbank(nw.Morse(SFREQ)._wdef(), jnp.asarray(freqs), N_FIT,
                           SFREQ, True), np.float32)
    sig = _tone_epochs(seed=1)
    _, l_j = jfit.learn_bank(jnp.asarray(sig), jnp.asarray(bank0),
                             loss="power", steps=5, lr=1e-3)
    _, l_t = tfit.learn_bank(*_t(sig, bank0), loss="power", steps=5,
                             lr=1e-3, use_fused=True)
    assert float(l_t[-1]) <= float(l_t[0])
    np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j), rtol=1e-3)
    with pytest.raises(ValueError, match="target"):
        tfit.learn_bank(*_t(sig, bank0), None, loss="mse", steps=1)
    with pytest.raises(ValueError, match="loss"):
        tfit.learn_bank(*_t(sig, bank0, bank0), loss="nope", steps=1)


def test_learn_bank_complex_float_pair():
    """A complex (MexicanHat) start enters and leaves as a float pair and
    follows the JAX package's loss trajectory.  (Its first-step gradient is
    pinned by ``test_mean_power_bwd_complex_bank_convention``; the bank
    after 20 Adam steps differs by up to lr-sized steps where a gradient
    sits near zero.)"""
    mh = nw.MexicanHat(SFREQ)
    br, bi = jbank_ri(mh._wdef(), jnp.asarray(np.arange(20.0, 60.0, 5.0),
                                              jnp.float32),
                      N_FIT, SFREQ, True, mh.real_wave_length)
    br, bi = np.array(br), np.array(bi)
    sig = _tone_epochs(f0=40.0, seed=3)
    target = tcwt.mean_power_from_bank(
        torch.from_numpy(sig), torch.complex(*_t(br, bi)), True).numpy()
    (jr, ji), l_j = jfit.learn_bank(
        jnp.asarray(sig), jnp.asarray(br * 1.2), jnp.asarray(target),
        steps=20, lr=2e-3, bank0_i=jnp.asarray(bi * 1.2))
    (tr, ti), l_t = tfit.learn_bank(
        *_t(sig, br * 1.2, target), steps=20, lr=2e-3,
        bank0_i=torch.from_numpy(bi * 1.2), use_fused=True)
    assert tr.dtype == torch.float32 and ti.dtype == torch.float32
    assert float(l_t[-1]) < float(l_t[0])
    np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j), rtol=1e-3,
                               atol=1e-7)
    assert tr.shape == jr.shape and ti.shape == ji.shape


def test_fit_frequencies_converges_to_tone():
    """Rows started far from a 60 Hz tone descend onto it, as in the JAX
    package (``tests/test_fit.py``), log-space rows staying positive."""
    wdef = nt.Morse(SFREQ, device="cpu")._wdef()
    f_fit, losses = tfit.fit_frequencies(*_t(_tone_epochs()), wdef,
                                         [40.0, 75.0], SFREQ, steps=150,
                                         lr=0.02)
    assert f_fit.shape == (2,) and losses.shape == (150,)
    np.testing.assert_allclose(f_fit.numpy(), 60.0, atol=1.0)
    assert float(losses[-1]) < float(losses[0])
    j_fit, j_losses = jfit.fit_frequencies(
        _tone_epochs(), nw.Morse(SFREQ)._wdef(), [40.0, 75.0], SFREQ,
        steps=150, lr=0.02)
    np.testing.assert_allclose(losses[:10].numpy(),
                               np.asarray(j_losses)[:10], rtol=1e-3)


def test_training_entry_points_default_to_the_card():
    """With no tensor argument, the training entry points place their data
    on the card, and raise without CUDA."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    sig = _tone_epochs(e=2)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tfit.learn_bank(sig, np.ones((2, N_FIT), np.float32), loss="power",
                        steps=1)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tfit.fit_frequencies(sig, nt.Morse(SFREQ, device="cpu")._wdef(),
                             [40.0], SFREQ, steps=1)
    assert nt.learn_bank is tfit.learn_bank
    assert nt.ops.fit_frequencies is tfit.fit_frequencies


# -- what surrounds the fused backward kernel ---------------------------------

def emulated_fused_cwt_bwd(spec, bank, g, k_bins, rows=4):
    """The contract of ``kernels.fused_cwt_bwd`` in plain torch: the
    per-channel dbank partials and the per-row-group t partials.  For a
    complex bank: dbank_part = sum_e u conj(S), complex, and t sums
    conj(bank) u."""
    e, c, _ = spec.shape
    f, n = bank.shape
    s = spec[..., :k_bins]
    x = torch.fft.ifft(torch.nn.functional.pad(s, (0, n - k_bins))[:, :, None]
                       * bank, norm="forward")           # unnormalised iDFT
    u = torch.fft.fft(2.0 / (e * n) * g * x)[..., :k_bins]   # (E, C, F, K)
    prod = u * s[:, :, None].conj()
    dbank_part = prod.sum(0) if bank.is_complex() else prod.real.sum(0)
    groups = -(-f // rows)
    cbank = bank.conj() if bank.is_complex() else bank
    bu = torch.nn.functional.pad(cbank[:, :k_bins] * u,
                                 (0, 0, 0, groups * rows - f))
    t_part = bu.reshape(e, c, groups, rows, k_bins).sum(3)
    return dbank_part, t_part.permute(2, 0, 1, 3).contiguous()


@pytest.mark.parametrize("interpolate", [True, False])
def test_fused_bwd_assembly_around_the_kernel(monkeypatch, interpolate):
    """The spectra, the sums over channels and row groups, the 1/N, the
    zero upper bins and the final inverse FFT that ``_fused_power_bwd``
    wraps around the kernel, with the kernel replaced by its contract, at a
    ragged row group (F = 13)."""
    sig, bank, g = _workload(e=3, c=2, f=13, n=512, interpolate=interpolate)
    calls = []

    def kernel(spec, bank_, g_, k_bins):
        calls.append((tuple(spec.shape), k_bins))
        return emulated_fused_cwt_bwd(spec, bank_, g_, k_bins)

    monkeypatch.setattr(kernels, "fused_cwt_bwd", kernel)
    ts, tb, tg = _t(sig, bank, g)
    ds, dbank = tfused._fused_power_bwd(ts, tb, tg, interpolate)
    assert calls == [((3, 2, 257 if interpolate else 512),
                      256 if interpolate else 512)]
    ds_ref, dbank_ref = tfused.mean_power_bwd(ts, tb, interpolate, tg)
    _close(ds, ds_ref.numpy())
    _close(dbank, dbank_ref.numpy())


# -- (h) the backward launcher's validation ----------------------------------

def _bwd_args(n=1024, e=2, c=3, f=5):
    return (torch.zeros((e, c, n // 2 + 1), dtype=torch.complex64),
            torch.zeros((f, n)), torch.zeros((c, f, n)), n // 2)


@pytest.mark.parametrize("change,match", [
    ({}, "CUDA"),
    ({0: torch.zeros((2, 3, 513))}, "spec"),                   # not complex
    ({1: torch.zeros((5, 1024), dtype=torch.float64)}, "bank"),
    ({2: torch.zeros((3, 5, 1024), dtype=torch.float16)}, "g"),
    ({2: torch.zeros((3, 4, 1024))}, "g must be"),              # wrong F
    ({2: torch.zeros((3, 5, 2048))[..., ::2]}, "contiguous"),
    ({1: torch.zeros((5, 1000)), 2: torch.zeros((3, 5, 1000))}, "power of"),
    ({3: 100}, "k_bins"),
    ({0: torch.zeros((0, 3, 513), dtype=torch.complex64)}, "empty"),
])
def test_bwd_launcher_rejects_before_any_build(monkeypatch, change, match):
    def no_build():
        raise AssertionError("the launcher tried to build")
    monkeypatch.setattr(kernels, "_load", no_build)
    args = list(_bwd_args())
    for i, v in change.items():
        args[i] = v
    before = dict(kernels.launches)
    with pytest.raises(ValueError, match=match):
        kernels.fused_cwt_bwd(*args)
    assert kernels.launches == before
    assert "power_bwd" in kernels.launches
