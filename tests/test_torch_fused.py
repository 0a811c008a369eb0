"""The port's fused wrappers (``ninwavelets_tpu_torch.ops.fused``) against
the JAX package's Pallas kernel in interpret mode at ``precision="exact"``.

Here the tensors lie on the CPU, so the wrappers run their plain versions;
the CUDA kernel itself is held against those plain versions on the card by
``chip_smoke.py``.  Gates are ``tests/test_fused.py``'s: power max|d| /
max|ref| <= 1e-4, ITC ``rtol=1e-4, atol=1e-5``.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ninwavelets_tpu as nw
from ninwavelets_tpu.ops import fused as jfused
from ninwavelets_tpu.ops.bank import make_fft_bank as jbank
import ninwavelets_tpu_torch as nt
from ninwavelets_tpu_torch import kernels
from ninwavelets_tpu_torch.ops import cwt as tcwt
from ninwavelets_tpu_torch.ops import fused as tfused

from torch_threads import one_torch_thread  # noqa: F401

SFREQ = 1000.0
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _workload(n=1024, e=3, c=2, f=8, interpolate=True, seed=0):
    bank = np.array(jbank(nw.Morse(SFREQ)._wdef(), jnp.arange(1.0, f + 1.0),
                          n, SFREQ, interpolate), np.float32)
    sig = np.random.default_rng(seed).standard_normal((e, c, n)).astype(
        np.float32)
    return sig, bank


def _both(name, sig, bank, interpolate):
    """(port, JAX) results of one fused wrapper on the same inputs."""
    fn = {"power": "fused_mean_power_from_bank",
          "itc": "fused_itc_from_bank",
          "power_itc": "fused_power_itc_from_bank"}[name]
    got = getattr(tfused, fn)(torch.from_numpy(sig), torch.from_numpy(bank),
                              interpolate, precision="exact")
    want = getattr(jfused, fn)(jnp.asarray(sig), jnp.asarray(bank),
                               interpolate, interpret=True, precision="exact")
    if name != "power_itc":
        got, want = (got,), (want,)
    return ([g.numpy() for g in got], [np.asarray(w) for w in want])


def _check(name, got, want):
    for kind, g, w in zip(name.split("_"), got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        if kind == "power":
            assert np.abs(g - w).max() / np.abs(w).max() <= 1e-4
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["power", "itc", "power_itc"])
@pytest.mark.parametrize("n,interpolate", [(1024, True), (1024, False),
                                           (2048, True)])
def test_fused_wrappers_match_pallas(name, n, interpolate):
    sig, bank = _workload(n=n, interpolate=interpolate)
    _check(name, *_both(name, sig, bank, interpolate))


@pytest.mark.parametrize("name,e", [("power", 17), ("itc", 17),
                                    ("itc", 19), ("power_itc", 19)])
def test_ragged_epoch_counts_match_pallas(name, e):
    """E = 17 and 19 are ragged for the Pallas kernel's 16-epoch chunks
    (power zero-pads the tail; itc and power_itc run a remainder call)."""
    sig, bank = _workload(e=e, c=1, f=6)
    _check(name, *_both(name, sig, bank, True))


def test_power_itc_is_the_two_reductions():
    sig, bank = _workload()
    ts, tb = torch.from_numpy(sig), torch.from_numpy(bank)
    p, i = tfused.fused_power_itc_from_bank(ts, tb, True)
    torch.testing.assert_close(p, tcwt.mean_power_from_bank(ts, tb, True))
    torch.testing.assert_close(i, tcwt.itc_from_bank(ts, tb, True))


@pytest.mark.parametrize("auto,plain", [
    ("mean_power_auto", "mean_power_from_bank"),
    ("itc_auto", "itc_from_bank")])
@pytest.mark.parametrize("complex_bank", [False, True])
def test_auto_dispatch_on_cpu_is_the_plain_path(auto, plain, complex_bank):
    sig, bank = _workload(f=4)
    tb = torch.from_numpy(bank)
    if complex_bank:
        tb = tb.to(torch.complex64) * (1 + 0.5j)
    ts = torch.from_numpy(sig)
    got = getattr(tfused, auto)(ts, tb, interpolate=True)
    want = getattr(tcwt, plain)(ts, tb, True)
    torch.testing.assert_close(got, want)
    p, i = tfused.power_itc_auto(ts, tb, interpolate=True)
    torch.testing.assert_close(p, tcwt.mean_power_from_bank(ts, tb, True))


def test_complex_signals_take_the_plain_path():
    """The kernel takes real signals only; ``*_auto`` sends complex ones to
    the plain path."""
    sig, bank = _workload(f=4)
    z = torch.from_numpy(sig + 1j * sig[:, ::-1].copy()).to(torch.complex64)
    tb = torch.from_numpy(bank)
    assert not tfused.route("power_each", z, tb).takes
    assert tfused.route("power_each", torch.from_numpy(sig), tb).takes
    torch.testing.assert_close(tfused.itc_auto(z, tb, interpolate=True),
                               tcwt.itc_from_bank(z, tb, True))
    with pytest.raises(ValueError, match="complex64 signals"):
        tfused._launch("power", z, tb, True, "exact")


def test_cpu_calls_launch_nothing():
    before = dict(kernels.launches)
    sig, bank = _workload(f=4)
    tfused.power_itc_auto(torch.from_numpy(sig), torch.from_numpy(bank),
                          interpolate=True)
    assert kernels.launches == before


@pytest.mark.parametrize("shape,bank,ok", [
    ((3, 2, 2048), torch.ones(5, 2048), True),
    ((1, 1, 256), torch.ones(1, 256), True),
    ((19, 64, 16384), torch.ones(2, 16384), True),
    ((200, 64, 1024), torch.ones(100, 1024, dtype=torch.float64), True),
    ((3, 2048), torch.ones(5, 2048), False),                 # no channel axis
    ((3, 2, 2000), torch.ones(5, 2000), False),              # N not 2^k
    ((3, 2, 128), torch.ones(5, 128), False),                # N below range
    ((3, 2, 32768), torch.ones(5, 32768), False),            # N above range
    ((3, 2, 2048), torch.ones(5, 1024), False),              # bank for other N
    ((3, 2, 2048), torch.ones(5, 2048, dtype=torch.complex64), False),
    ((3, 2, 2048), torch.ones(2048), False),                 # 1-D bank
    ((0, 2, 2048), torch.ones(5, 2048), False),              # no epochs
    ((3, 65536, 256), torch.ones(5, 256), False),            # C > 65535
    ((3, 2, 2048), None, False),
])
def test_supports_geometry(shape, bank, ok):
    assert tfused.supports(shape, bank) is ok
    assert tfused.supports(shape, bank, epilogue="itc") is ok


@pytest.mark.parametrize("precision", ["fast3", "exact", "bf16"])
def test_precisions_accepted(precision):
    sig, bank = _workload(e=2, c=1, f=3)
    out = tfused.fused_mean_power_from_bank(
        torch.from_numpy(sig), torch.from_numpy(bank), precision=precision)
    assert out.shape == (1, 3, 1024)


@pytest.mark.parametrize("precision", ["mixed", "nope"])
@pytest.mark.parametrize("fn", ["fused_mean_power_from_bank",
                                "fused_itc_from_bank",
                                "fused_power_itc_from_bank"])
def test_unknown_precision_raises(fn, precision):
    sig, bank = _workload(e=2, c=1, f=3)
    with pytest.raises(ValueError, match="precision"):
        getattr(tfused, fn)(torch.from_numpy(sig), torch.from_numpy(bank),
                            precision=precision)


def test_kernel_launcher_rejects_cpu_tensors():
    spec = torch.zeros((2, 1, 513), dtype=torch.complex64)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.fused_cwt("power", spec, torch.zeros(3, 1024), 512, "exact")
    with pytest.raises(ValueError, match="epilogue"):
        kernels.fused_cwt("plv", spec, torch.zeros(3, 1024), 512, "exact")


def test_build_without_nvcc_raises(monkeypatch):
    """No nvcc: the build raises (there is no fallback)."""
    import torch.utils.cpp_extension as ext
    monkeypatch.setattr(ext, "CUDA_HOME", None)
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.build()


def test_import_attempts_no_build():
    """Importing the package (kernels and native gathers included)
    compiles and loads nothing: the builds happen at first use."""
    code = ("import os, ninwavelets_tpu_torch as nt\n"
            "from ninwavelets_tpu_torch import kernels\n"
            "from ninwavelets_tpu_torch.io import native\n"
            "assert kernels._lib is None\n"
            "assert native._lib is None and not native._tried\n"
            "assert all(v == 0 for v in kernels.launches.values())\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# -- "power_each" at N = 32768: two 16384-point transforms ------------------

SPLIT_N = 2 * kernels.MAX_N


def _split_power(sig, bank, interpolate, keep):
    """The split "power_each" kernel (``fused_each_split_kernel``) in torch:
    Z = bank x spectrum on the kernel's K bins, the radix-2 butterfly on
    the output index, w^k from ``kernels.split_twiddles``, one unnormalised
    16384-point inverse DFT for each output parity, the parities
    interleaved, |x|^2 / N^2, the columns ``keep``."""
    n = sig.shape[-1]
    h = n // 2
    k_bins = h if interpolate else n
    spec = (torch.fft.rfft(sig) if interpolate else torch.fft.fft(sig))
    z = torch.nn.functional.pad(spec[..., None, :k_bins] * bank[:, :k_bins],
                                (0, n - k_bins))
    lo, hi = z[..., :h], z[..., h:]
    w = torch.from_numpy(kernels.split_twiddles(n))
    even = torch.fft.ifft(lo + hi, norm="forward")
    odd = torch.fft.ifft((lo - hi) * w, norm="forward")
    y = torch.stack([even, odd], -1).flatten(-2)
    return ((y.real ** 2 + y.imag ** 2) / float(n) ** 2)[..., keep[0]:keep[1]]


@pytest.mark.parametrize("interpolate", [False, True])
@pytest.mark.parametrize("keep", [(0, SPLIT_N), (8192, 24576)])
def test_split_power_each_matches_the_plain_power(interpolate, keep):
    """The even and odd output parities of the 32768-point inverse DFT as
    two 16384-point transforms give ``power_from_bank``'s plane, to float32
    rounding, on the whole window and on the recording's kept interior."""
    sig = torch.from_numpy(np.random.default_rng(27).standard_normal(
        (3, SPLIT_N), dtype=np.float32))
    bank = nt.Morse(SFREQ, interpolate=interpolate,
                    device="cpu").make_fft_wavelets(
                        np.array([1.0, 10.0, 40.0, 100.0]), SPLIT_N / SFREQ)
    want = tcwt.power_from_bank(sig, bank, interpolate)[..., keep[0]:keep[1]]
    got = _split_power(sig, bank, interpolate, keep)
    assert got.shape == want.shape == (3, 4, keep[1] - keep[0])
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5


def test_split_twiddles_are_the_odd_parity_rotation():
    w = kernels.split_twiddles(SPLIT_N)
    assert w.dtype == np.complex64 and w.shape == (SPLIT_N // 2,)
    k = np.arange(SPLIT_N // 2)
    np.testing.assert_array_equal(
        w, np.exp(2j * np.pi * k / SPLIT_N).astype(np.complex64))
    assert w[0] == 1 and abs(w[SPLIT_N // 4] - 1j) < 1e-7


@pytest.mark.parametrize("family,n,key,why", [
    ("power_each", SPLIT_N, "power_each_split", None),
    ("power_each", kernels.MAX_N, "power_each", None),
    ("power_each", 2 * SPLIT_N, None, "n_range"),
    ("power", SPLIT_N, None, "n_range"),
    ("itc", SPLIT_N, None, "n_range"),
    ("power_itc", SPLIT_N, None, "n_range"),
    ("coherence", SPLIT_N, None, "n_range"),
    ("phaselag", SPLIT_N, None, "n_range"),
    ("plv", SPLIT_N, None, "n_range"),
])
def test_only_power_each_takes_32768(family, n, key, why):
    """``route()`` on a card: "power_each" launches at N = 32768 under
    "power_each_split"; every other family keeps [256, 16384], and
    "power_each" stops at 32768."""
    r = tfused.route(family, (1, 1, n), torch.ones(3, n), device="cuda")
    assert (r.key, r.why, r.launch) == (key, why, why is None)
    assert r.span == tfused.transform_span(key, why)
    assert tfused.supports((1, 1, n), torch.ones(3, n), family) == (
        why is None)


def test_ssq_and_complex_banks_stay_plain_at_32768():
    bank = torch.ones(3, SPLIT_N)
    assert tfused.route("ssq", (1, 1, SPLIT_N), bank, device="cuda",
                        grid=("lin", 5.0, 5.0)).why == "n_range"
    cx = bank.to(torch.complex64)
    assert tfused.route("power_each", (1, 1, SPLIT_N), cx,
                        device="cuda").why == "complex_bank"


def test_split_launcher_checks_before_the_device():
    """The launcher takes N = 32768 for "power_each" (it reaches the CUDA
    check) and refuses 65536 by its shape rule."""
    spec = torch.zeros((2, 1, SPLIT_N // 2 + 1), dtype=torch.complex64)
    dst = torch.zeros((2, 1, 3, SPLIT_N))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.fused_power_each(spec, torch.zeros(3, SPLIT_N),
                                 SPLIT_N // 2, dst, (0, SPLIT_N))
    with pytest.raises(ValueError, match="power of two"):
        kernels.fused_power_each(
            torch.zeros((2, 1, SPLIT_N + 1), dtype=torch.complex64),
            torch.zeros(3, 2 * SPLIT_N), SPLIT_N,
            torch.zeros((2, 1, 3, 2 * SPLIT_N)), (0, 2 * SPLIT_N))
    assert "power_each_split" in kernels.launches
