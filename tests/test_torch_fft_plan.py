"""The register-resident FFT core of the epoch reductions and the cross-pair
sums (``csrc/fft_regs.cuh``), emulated in numpy from what the host code
says about it: the plan, the twiddle table, where each pass puts its
outputs, and the sample each thread holds at the end
(``ninwavelets_tpu_torch.kernels``).  The CUDA kernels themselves run only
on the card, where ``chip_smoke.py`` holds them against the plain path at
every N; this checks the decomposition they implement, at every N."""
import numpy as np
import pytest

from ninwavelets_tpu_torch import kernels

SIZES = [1 << k for k in range(8, 15)]       # 256 ... 16384


def emulate(spec: np.ndarray) -> np.ndarray:
    """The core's unnormalised inverse DFT of one complex64 row, in float32
    arithmetic: thread t starts with bin t + T i in slot i; pass s runs the
    Q = R / P DFTs of P points on slots m + Q r, after the twiddles of
    ``core_twiddles``, and (but the last pass) writes output q of DFT m to
    ``core_exchange_positions`` and reads slot i back from
    ``core_pad(t + T i)``; slot i then holds sample ``core_output_map``
    (R = ``core_r(n)`` samples a thread, T = N / R threads)."""
    n = spec.shape[-1]
    R = kernels.core_r(n)
    t_count = n // R
    plan = kernels.core_plan(n)
    table = kernels.core_twiddles(n)
    t = np.arange(t_count)[:, None]
    slot = np.arange(R)[None, :]
    x = spec[t + t_count * slot].astype(np.complex64)       # (T, R)
    ns = 1
    for s, p in enumerate(plan):
        q_count = R // p
        dft = np.exp(2j * np.pi * np.outer(np.arange(p), np.arange(p))
                     / p).astype(np.complex64)
        y = np.empty_like(x)
        for m in range(q_count):
            cols = m + q_count * np.arange(p)
            v = x[:, cols].copy()
            if s:
                k = (np.arange(t_count) + m * t_count) % ns
                idx = ns - 16 + (np.arange(1, p)[None, :] - 1) * ns + k[:, None]
                v[:, 1:] *= table[idx]
            y[:, cols] = v @ dft
        if s + 1 < len(plan):
            buf = np.zeros(kernels.core_pad(n - 1) + 1, np.complex64)
            buf[kernels.core_exchange_positions(n, s)] = y
            x = buf[kernels.core_pad(t + t_count * slot)]
        else:
            x = y
        ns *= p
    out = np.empty(n, np.complex64)
    out[kernels.core_output_map(n)] = x
    return out


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
