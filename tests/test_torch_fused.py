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
