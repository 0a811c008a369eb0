"""The register-resident FFT core of the kernels (``csrc/fft_regs.cuh``),
emulated in numpy from what the host code says about it: the plan, the
twiddle table, where each pass puts its outputs, and the sample each
thread holds at the end (``ninwavelets_tpu_torch.kernels``).  The CUDA
kernels themselves run only on the card, where ``chip_smoke.py`` holds them
against the plain path at every N; this checks the decomposition they
implement, at every N, and the dataflow of the two kernels built on it
that do more than one transform a row: the power backward (K3, real and
complex bank: the inverse, the product by the cotangent, the forward DFT
as the inverse between two conjugations, the partial sums by row group)
and the per-signal power's kept-range write (K4)."""
import numpy as np
import pytest
import torch

import ninwavelets_tpu_torch as nt
from ninwavelets_tpu_torch import kernels
from ninwavelets_tpu_torch.ops import fused as tfused
from ninwavelets_tpu_torch.parallel import StreamingCWT
from ninwavelets_tpu_torch.parallel import streaming as tstreaming

from torch_threads import one_torch_thread  # noqa: F401

SIZES = [1 << k for k in range(8, 15)]       # 256 ... 16384


def emulate(spec: np.ndarray) -> np.ndarray:
    """The core's unnormalised inverse DFT of complex64 rows (..., N), in
    float32 arithmetic: thread t starts with bin t + T i in slot i; pass s
    runs the Q = R / P DFTs of P points on slots m + Q r, after the
    twiddles of ``core_twiddles``, and (but the last pass) writes output q
    of DFT m to ``core_exchange_positions`` and reads slot i back from
    ``core_pad(t + T i)``; slot i then holds sample ``core_output_map``
    (R = ``core_r(n)`` samples a thread, T = N / R threads)."""
    n = spec.shape[-1]
    R = kernels.core_r(n)
    t_count = n // R
    plan = kernels.core_plan(n)
    table = kernels.core_twiddles(n)
    t = np.arange(t_count)[:, None]
    slot = np.arange(R)[None, :]
    x = spec[..., t + t_count * slot].astype(np.complex64)  # (..., T, R)
    ns = 1
    for s, p in enumerate(plan):
        q_count = R // p
        dft = np.exp(2j * np.pi * np.outer(np.arange(p), np.arange(p))
                     / p).astype(np.complex64)
        y = np.empty_like(x)
        for m in range(q_count):
            cols = m + q_count * np.arange(p)
            v = x[..., cols].copy()
            if s:
                k = (np.arange(t_count) + m * t_count) % ns
                idx = ns - 16 + (np.arange(1, p)[None, :] - 1) * ns + k[:, None]
                v[..., 1:] *= table[idx]
            y[..., cols] = v @ dft
        if s + 1 < len(plan):
            buf = np.zeros(x.shape[:-2] + (kernels.core_pad(n - 1) + 1,),
                           np.complex64)
            buf[..., kernels.core_exchange_positions(n, s)] = y
            x = buf[..., kernels.core_pad(t + t_count * slot)]
        else:
            x = y
        ns *= p
    out = np.empty(x.shape[:-2] + (n,), np.complex64)
    out[..., kernels.core_output_map(n)] = x
    return out


def emulate_forward(y: np.ndarray) -> np.ndarray:
    """The forward DFT as the kernels run it (``fft_regs::forward_fft``):
    the core's inverse between two conjugations."""
    return np.conj(emulate(np.conj(y)))


@pytest.mark.parametrize("n", SIZES)
def test_core_is_the_inverse_dft(n):
    rng = np.random.default_rng(n)
    for _ in range(3):
        spec = (rng.standard_normal(n)
                + 1j * rng.standard_normal(n)).astype(np.complex64)
        want = np.fft.ifft(spec.astype(np.complex128)) * n
        got = emulate(spec)
        # float32 round-off over log2 N radix-2 stages' worth of products
        assert np.abs(got - want).max() <= 2e-6 * np.abs(want).max()


@pytest.mark.parametrize("n", SIZES)
def test_forward_is_the_dft(n):
    rng = np.random.default_rng(n + 1)
    y = (rng.standard_normal((2, n))
         + 1j * rng.standard_normal((2, n))).astype(np.complex64)
    want = np.fft.fft(y.astype(np.complex128))
    got = emulate_forward(y)
    assert np.abs(got - want).max() <= 2e-6 * np.abs(want).max()


@pytest.mark.parametrize("n", SIZES)
def test_plan_and_maps_are_permutations(n):
    plan = kernels.core_plan(n)
    R = kernels.core_r(n)
    assert int(np.prod(plan)) == n and all(1 < p <= 16 for p in plan)
    assert all(p == 16 for p in plan[:-1]) and R in (16, 32)
    t_count = n // R
    assert np.array_equal(np.sort(kernels.core_output_map(n).ravel()),
                          np.arange(n))
    reads = kernels.core_pad(np.arange(n))
    for s in range(len(plan) - 1):
        writes = kernels.core_exchange_positions(n, s)
        assert writes.shape == (t_count, R)
        # every padded slot a pass writes is one a thread reads back
        assert np.array_equal(np.sort(writes.ravel()), reads)
    with pytest.raises(ValueError, match="exchange"):
        kernels.core_exchange_positions(n, len(plan) - 1)


@pytest.mark.parametrize("n", SIZES)
def test_twiddle_table_is_its_float64_definition(n):
    table = kernels.core_twiddles(n)
    assert table.dtype == np.complex64 and table.shape == (n - 16,)
    want, ns = [], 16
    for p in kernels.core_plan(n)[1:]:
        for r in range(1, p):
            for k in range(ns):
                want.append(complex(np.exp(2j * np.pi * r * k / (ns * p))))
        ns *= p
    assert np.array_equal(table, np.array(want).astype(np.complex64))


def _ways(addresses):
    """The most 8-byte accesses to distinct words that share one of the 16
    bank pairs in a half-warp (the card serves 64-bit shared-memory
    accesses a half-warp at a time)."""
    worst = 1
    for h in range(0, addresses.size, 16):
        words = np.unique(addresses[h:h + 16])
        worst = max(worst, np.bincount(words % 16).max())
    return worst


@pytest.mark.parametrize("n", SIZES)
def test_exchanges_are_free_of_bank_conflicts(n):
    R = kernels.core_r(n)
    t_count = n // R
    for s in range(len(kernels.core_plan(n)) - 1):
        writes = kernels.core_exchange_positions(n, s)
        for i in range(R):
            assert _ways(writes[:, i]) == 1, (s, i, "write")
            read = kernels.core_pad(np.arange(t_count) + t_count * i)
            assert _ways(read) == 1, (s, i, "read")


@pytest.mark.parametrize("n", [128, 300, 32768])
def test_core_plan_refuses_other_lengths(n):
    with pytest.raises(ValueError, match="power of two"):
        kernels.core_plan(n)
    with pytest.raises(ValueError, match="power of two"):
        kernels.core_r(n)


# -- K3: the backward's dataflow on the core -----------------------------------

def emulated_bwd_kernel(spec, bank, g, k_bins):
    """``kernels.fused_cwt_bwd`` as ``csrc/fused_cwt_bwd.cu`` computes it,
    in numpy float32: a block per (row group of G = ``bwd_rows`` rows,
    channel); per epoch and row, stage 0 (bank x bins, zero at k >= K), the
    core's inverse, the product by (2 / (E N)) g at the sample slots, the
    forward DFT as the inverse between two conjugations, then the dbank and
    t sums on the first K bins, in the kernel's order (epochs outer, the
    group's rows inner)."""
    e_count, c_count, _ = spec.shape
    f_count, n = bank.shape
    cx = np.iscomplexobj(bank)
    rows = kernels.bwd_rows(n, cx)
    groups = -(-f_count // rows)
    scale = np.float32(2.0 / (e_count * n))
    s = np.zeros((e_count, c_count, n), np.complex64)
    s[..., :k_bins] = spec[..., :k_bins]
    b = np.zeros((f_count, n), bank.dtype)
    b[:, :k_bins] = bank[:, :k_bins]
    dbank = np.zeros((c_count, f_count, k_bins), bank.dtype)
    t_part = np.zeros((groups, e_count, c_count, k_bins), np.complex64)
    for grp in range(groups):
        for e in range(e_count):
            t = np.zeros((c_count, k_bins), np.complex64)
            for f in range(grp * rows, min(grp * rows + rows, f_count)):
                x = emulate(s[e] * b[f])                       # (C, N)
                u = emulate_forward(x * (scale * g[:, f]))[:, :k_bins]
                prod = u * np.conj(s[e, :, :k_bins])
                dbank[:, f] += prod if cx else prod.real
                t += (np.conj(b[f, :k_bins]) if cx else b[f, :k_bins]) * u
            t_part[grp, e] = t
    return dbank, t_part


@pytest.mark.parametrize("n", [256, 2048])
@pytest.mark.parametrize("cx", [False, True])
@pytest.mark.parametrize("interpolate", [True, False])
def test_bwd_dataflow_on_the_core_is_the_adjoint(monkeypatch, n, cx,
                                                 interpolate):
    """K3's per-block dataflow, finished by ``_fused_power_bwd`` (the sums
    over channels and row groups, the 1/N, the zero upper bins, the inverse
    FFT of t), against the plain adjoint ``mean_power_bwd``: float32
    round-off, max|d| <= 1e-5 of the max, at a ragged row group (F = 5)."""
    rng = np.random.default_rng(n)
    e, c, f = 3, 2, 5
    sig = torch.from_numpy(rng.standard_normal((e, c, n), dtype=np.float32))
    g = torch.from_numpy(rng.standard_normal((c, f, n), dtype=np.float32))
    wavelet = (nt.MexicanHat if cx else nt.Morse)(
        1000.0, interpolate=interpolate, device="cpu")
    bank = wavelet.make_fft_wavelets(np.arange(1.0, f + 1.0) * 9, n / 1000.0)
    assert bank.is_complex() == cx

    def kernel(spec, bank_, g_, k_bins):
        assert k_bins == (n // 2 if interpolate else n)
        d, t = emulated_bwd_kernel(spec.numpy(), bank_.numpy(), g_.numpy(),
                                   k_bins)
        assert t.shape[0] == -(-f // kernels.bwd_rows(n, cx))
        return torch.from_numpy(d), torch.from_numpy(t)

    monkeypatch.setattr(kernels, "fused_cwt_bwd", kernel)
    ds, dbank = tfused._fused_power_bwd(sig, bank, g, interpolate)
    ds_ref, dbank_ref = tfused.mean_power_bwd(sig, bank, interpolate, g)
    assert dbank.dtype == bank.dtype
    for got, want in ((ds, ds_ref), (dbank, dbank_ref)):
        got, want = torch.view_as_real(got.to(torch.complex64)), \
            torch.view_as_real(want.to(torch.complex64))
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("n,cx,want", [
    (256, False, 4), (4096, False, 4), (8192, False, 2), (16384, False, 1),
    (256, True, 2), (4096, True, 2), (8192, True, 1), (16384, True, 1)])
def test_bwd_rows(n, cx, want):
    assert kernels.bwd_rows(n, cx) == want


# -- K4: the kept-range write ----------------------------------------------------

def emulated_power_each(spec, bank, k_bins, dst, keep):
    """``kernels.fused_power_each`` as ``csrc/fused_cwt.cu`` computes it:
    each signal's rows through the core (``emulate``), |x|^2 / N^2, and
    column n of signal b's row f stored at the offset the kernel computes
    from what ``kernels.each_layout`` gives it, counted from dst's first
    element."""
    group, s_group, s_signal, s_row, lo, hi = kernels.each_layout(
        dst, spec.shape[0] * spec.shape[1], bank.shape[0], keep)
    n = bank.shape[-1]
    bins = np.zeros((spec.shape[0] * spec.shape[1], n), np.complex64)
    bins[:, :k_bins] = spec.reshape(-1, spec.shape[-1])[:, :k_bins].numpy()
    b_row = np.zeros(bank.shape, np.float32)
    b_row[:, :k_bins] = bank[:, :k_bins].numpy()
    x = emulate(bins[:, None] * b_row)                       # (B, F, N)
    power = (x.real * x.real + x.imag * x.imag) / np.float32(n * n)
    flat = torch.as_strided(dst, (dst.untyped_storage().nbytes() // 4,),
                            (1,), 0)
    b, f, col = np.meshgrid(np.arange(x.shape[0]), np.arange(x.shape[1]),
                            np.arange(lo, hi), indexing="ij")
    offset = (dst.storage_offset() + (b // group) * s_group
              + (b % group) * s_signal + f * s_row + (col - lo))
    flat[torch.from_numpy(offset.ravel())] = torch.from_numpy(
        power[b, f, col].ravel())
    return dst


@pytest.mark.parametrize("lead", [(), (3,), (2, 3)])
def test_power_each_kept_range_lands_where_the_paste_puts_it(monkeypatch,
                                                             lead):
    """``StreamingCWT``'s fused path with the kernel replaced by the
    emulation of its kept-range write lands every interior sample where
    the plain path's crop and paste puts it: a ragged last batch, channel
    dims riding the batch, extended windows of 1024 points."""
    freqs = np.arange(20.0, 70.0, 10.0)
    wdef = nt.Morse(1000.0, device="cpu")._wdef()
    kw = dict(window=768, halo=128, interpolate=True, batch=3, device="cpu")
    sig = np.random.default_rng(7).standard_normal(
        lead + (5000,)).astype(np.float32)

    def kernel_path(ext, bank, interpolate, dst, keep):
        tfused._fused_power_each_into(ext, bank, interpolate, dst, keep)

    monkeypatch.setattr(tstreaming, "_power_each_into", kernel_path)
    monkeypatch.setattr(kernels, "fused_power_each", emulated_power_each)
    fused = StreamingCWT(wdef, freqs, 1000.0, use_fused=True, **kw)
    plain = StreamingCWT(wdef, freqs, 1000.0, use_fused=False, **kw)
    got = fused.power_device(sig)
    want = plain.power_device(sig)
    assert got.shape == want.shape == lead + (len(freqs), 5000)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_streaming_fused_path_on_the_cpu_is_the_plain_path():
    freqs = np.arange(20.0, 70.0, 10.0)
    wdef = nt.Morse(1000.0, device="cpu")._wdef()
    kw = dict(window=768, halo=128, interpolate=True, batch=3, device="cpu")
    sig = np.random.default_rng(8).standard_normal((2, 4000)).astype(
        np.float32)
    before = dict(kernels.launches)
    got = StreamingCWT(wdef, freqs, 1000.0, use_fused=True, **kw
                       ).power_device(sig)
    want = StreamingCWT(wdef, freqs, 1000.0, use_fused=False, **kw
                        ).power_device(sig)
    assert torch.equal(got, want)
    assert kernels.launches == before


@pytest.mark.parametrize("shape,strides,keep,match", [
    ((2, 3, 5, 100), None, (10, 110), None),
    ((2, 3, 5, 100), None, (10, 100), "keep"),
    ((3, 3, 5, 100), None, (10, 110), "keep"),
    ((2, 3, 4, 100), None, (10, 110), "keep"),
    ((2, 3, 5, 100), (1500, 500, 100, 2), (10, 110), "strides"),
    ((2, 3, 5, 100), (100, 1000, 200, 1), (10, 110), None),
])
def test_each_layout(shape, strides, keep, match):
    base = torch.zeros(8000)
    if strides is None:
        strides = torch.empty(shape).stride()
    dst = torch.as_strided(base, shape, strides)
    if match is None:
        assert kernels.each_layout(dst, 6, 5, keep) == (
            3, *strides[:3], *keep)
    else:
        with pytest.raises(ValueError, match=match):
            kernels.each_layout(dst, 6, 5, keep)


def test_power_each_launcher_rejects_before_any_build(monkeypatch):
    def no_build():
        raise AssertionError("the launcher tried to build")
    monkeypatch.setattr(kernels, "_load", no_build)
    spec = torch.zeros((6, 1, 513), dtype=torch.complex64)
    dst = torch.zeros((2, 3, 4, 100))
    before = dict(kernels.launches)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.fused_power_each(spec, torch.zeros(4, 1024), 512, dst,
                                 (0, 100))
    with pytest.raises(ValueError, match="bank"):
        kernels.fused_power_each(spec, torch.zeros(4, 1024,
                                                   dtype=torch.complex64),
                                 512, dst, (0, 100))
    assert kernels.launches == before
