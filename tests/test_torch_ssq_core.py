"""The synchrosqueezing kernels' dataflow on the register-resident FFT core
(``csrc/fused_cwt.cu``: ``fused_amax_kernel``, K5a; ``csrc/fused_ssq.cu``,
K5b), emulated in numpy float32 and put in place of the kernels around the
port's own wrappers (``ops.fused._fused_ssq_sum``), on the CPU.

Both kernels form W from ``csrc/ssq_row.cuh``: stage 0 is the spectrum
times bank / N on the bins k < N/2, then the core's inverse DFT
(``test_torch_fft_plan.emulate``), and p = Re(W)^2 + Im(W)^2 with each
square and the sum rounded on its own.  K5a takes the max of p over each
row; K5b transforms i nu_k S too, and adds every cell's p into its row
(its instantaneous frequency's row where p passes the (epoch, channel)
floor, its own row otherwise).  The CUDA kernels themselves run only on
the card, where ``chip_smoke.py`` holds them against the plain path.

Gates, as the smoke's: each time column's energy within rtol 1e-5 (the
reassignment only moves energy between rows), SNR >= 40 dB, and a zero
plane for an all-zero channel."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ninwavelets_tpu.ops import fused as jfused
from ninwavelets_tpu_torch import kernels
from ninwavelets_tpu_torch.ops import fused as tfused
from ninwavelets_tpu_torch.ops import sst as tsst
from test_torch_fft_plan import emulate
from test_torch_sst import GRIDS, REL, SFREQ, _bank, _signals

COLSUM_RTOL, SNR_DB = 1e-5, 40.0


def emulated_w(spec: np.ndarray, bank: np.ndarray):
    """(S, W), (E, C, F, N) complex64: stage 0 and the core's inverse DFT of
    every (epoch, channel, row), as both kernels form them
    (``ssq_row.cuh``): the bins k < N/2 times the bank scaled by 1/N."""
    n = bank.shape[-1]
    k = n // 2
    s = np.zeros(spec.shape[:2] + (n,), np.complex64)
    s[..., :k] = spec[..., :k]
    b = np.zeros(bank.shape, np.float32)
    b[:, :k] = bank[:, :k] * np.float32(1.0 / n)
    stage0 = s[:, :, None, :] * b
    return stage0, emulate(stage0)


def power(w: np.ndarray) -> np.ndarray:
    """``ssq::power``: each square and the sum rounded in float32."""
    return w.real * w.real + w.imag * w.imag


def emulated_amax(epilogue, spec, bank, k_bins, precision):
    """``kernels.fused_cwt("amax", ...)`` as ``fused_amax_kernel`` computes
    it: (C, F, E) max over N of p.  The max is order-free, so a thread's
    max, the warp's shuffle and the atomicMax of the warps give this."""
    assert epilogue == "amax" and k_bins == bank.shape[-1] // 2
    _, w = emulated_w(spec.numpy(), bank.numpy())
    return [torch.from_numpy(power(w).max(-1).transpose(1, 2, 0).copy())]


class EmulatedSsq:
    """``kernels.fused_ssq`` as ``fused_ssq_kernel`` computes it, in float32;
    records, per (epoch, channel), the largest p it formed and how many
    cells passed the gate."""

    def __init__(self):
        self.max_p, self.passed = [], []

    def __call__(self, spec, bank, floors, uniform_grid, sfreq):
        f_count, n = bank.shape
        assert tuple(floors.shape) == (spec.shape[1], spec.shape[0])
        stage0, w = emulated_w(spec.numpy(), bank.numpy())
        nu = np.float32(2.0 * np.pi * float(sfreq) / n) * np.arange(
            n, dtype=np.float32)
        ds = np.empty_like(stage0)
        ds.real = -(nu * stage0.imag)
        ds.imag = nu * stage0.real
        dw = emulate(ds)
        p = power(w)
        num = dw.imag * w.real - dw.real * w.imag
        omega = num / (np.float32(6.283185307179586)
                       * np.maximum(p, np.float32(1e-30)))
        kind, e0, step = uniform_grid
        e0, step = np.float32(e0), np.float32(step)
        if kind == "log":
            cnt = np.where(omega > 0, np.ceil(
                (np.log(np.maximum(omega, np.float32(1e-30))) - e0) / step),
                np.float32(0))
        else:
            cnt = np.ceil((omega - e0) / step)
        gate = p >= floors.numpy().T[:, :, None, None]
        own = np.broadcast_to(np.arange(f_count)[:, None], p.shape)
        row = np.where(gate, np.clip(cnt, 0, f_count - 1).astype(np.int64),
                       own)
        self.max_p.append(p.max(axis=(2, 3)).T)
        self.passed.append(gate.sum(axis=(2, 3)).T)
        e_count, c_count = p.shape[:2]
        out = np.zeros((c_count, f_count, n), np.float32)
        chan = np.broadcast_to(np.arange(c_count)[None, :, None, None],
                               p.shape)
        col = np.broadcast_to(np.arange(n), p.shape)
        np.add.at(out, (chan, row, col), p)
        return torch.from_numpy(out)


@pytest.fixture
def core_kernels(monkeypatch):
    ssq = EmulatedSsq()
    monkeypatch.setattr(kernels, "fused_cwt", emulated_amax)
    monkeypatch.setattr(kernels, "fused_ssq", ssq)
    return ssq


def _case(grid, n, e=3, c=4):
    """A ragged E of tone-plus-noise channels, channel 1 all zero."""
    freqs = GRIDS[grid][:24]
    sig = _signals((e, c, n), tone=15.0, seed=n + len(grid))
    sig[:, 1] = 0.0
    bank = _bank(freqs, n)
    hint = tsst.uniform_grid_hint(freqs)
    assert hint[0] == grid
    return freqs, sig, bank, hint


def _assert_ssq_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    colsum = (np.abs(got.sum(-2) - want.sum(-2)).max()
              / np.abs(want.sum(-2)).max())
    assert colsum <= COLSUM_RTOL, colsum
    err = ((got - want) ** 2).sum()
    snr = 10 * np.log10((want ** 2).sum() / max(err, 1e-300))
    assert snr >= SNR_DB, snr


@pytest.mark.parametrize("n", [256, 2048])
@pytest.mark.parametrize("grid", ["lin", "log"])
def test_ssq_dataflow_on_the_core_matches_the_plain_path(core_kernels, grid,
                                                         n):
    freqs, sig, bank, hint = _case(grid, n)
    x, b = torch.from_numpy(sig), torch.from_numpy(bank)
    got = tfused._fused_ssq_sum(x, b, hint, SFREQ, REL) / sig.shape[0]
    want = tsst.ssq_mean_power_from_bank(x, b, freqs, SFREQ, True, REL, hint)
    _assert_ssq_close(got.numpy(), want.numpy())
    assert bool((got[1] == 0).all())
    assert len(core_kernels.max_p) == 1


@pytest.mark.parametrize("grid", ["lin", "log"])
def test_ssq_dataflow_on_the_core_matches_pallas(core_kernels, grid):
    """Against the JAX package's Pallas kernels in interpret mode, at their
    smallest signal length (N = 1024: the Pallas geometry takes N = 128 N1
    with N1 >= 8)."""
    freqs, sig, bank, hint = _case(grid, 1024)
    got = tfused._fused_ssq_sum(torch.from_numpy(sig), torch.from_numpy(bank),
                                hint, SFREQ, REL) / sig.shape[0]
    want = jfused.fused_ssq_mean_power(jnp.asarray(sig), jnp.asarray(bank),
                                       uniform_grid=hint, sfreq=SFREQ,
                                       interpret=True, precision="exact")
    _assert_ssq_close(got.numpy(), np.asarray(want))
    assert bool((got[1] == 0).all())


@pytest.mark.parametrize("n", [256, 2048])
@pytest.mark.parametrize("grid", ["lin", "log"])
def test_amax_peak_is_the_largest_p_the_reassignment_forms(core_kernels,
                                                           grid, n):
    """K5a's peak of every (epoch, channel) equals, bit for bit, the largest
    p that K5b forms; at rel_threshold = 1 the peak cell passes its own
    gate."""
    _, sig, bank, hint = _case(grid, n)
    x, b = torch.from_numpy(sig), torch.from_numpy(bank)
    peaks = tfused._peaks(*tfused._spectra(x, b))
    tfused._fused_ssq_sum(x, b, hint, SFREQ, 1.0)
    (max_p,), (passed,) = core_kernels.max_p, core_kernels.passed
    assert max_p.shape == tuple(peaks.shape) == (sig.shape[1], sig.shape[0])
    assert np.array_equal(peaks.numpy().view(np.int32),
                          max_p.view(np.int32))
    assert (passed >= 1).all()
    strong = np.ones(sig.shape[1], bool)
    strong[1] = False
    assert (peaks.numpy()[strong] > 0).all()
