"""The port's multi-device layer, world 4: the epoch reductions (plain and
fused, real and complex banks), the training step, the zoo, synchrosqueezing
and reassignment, ``distributed_mean_power`` / ``distributed_itc`` and the
halo-exchanged chunked CWT, on the (2,2,1), (4,1,1), (1,4,1) and (1,1,4)
meshes.

One ``run_on_mesh`` group of four gloo CPU ranks runs every case
(``torch_parallel_cases.reduction_cases``).  Each result is held against the
JAX package's sharded function on the conftest's virtual CPU mesh of the
same shape (Pallas bodies in interpret mode at "exact"), at the JAX sharded
tests' tolerances, and against the port's single-device function.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ninwavelets_tpu as nw
import ninwavelets_tpu_torch as nt
from ninwavelets_tpu import parallel as jpar
from ninwavelets_tpu.ops import multitaper as jmt
from ninwavelets_tpu.ops import sst as jsst
from ninwavelets_tpu.ops import superlets as jsl
from ninwavelets_tpu.ops.bank import make_fft_bank
from ninwavelets_tpu_torch.ops import cwt as tcwt
from ninwavelets_tpu_torch.ops import fused as tfused
from ninwavelets_tpu_torch.ops import reassign as treassign
from ninwavelets_tpu_torch.ops import sst as tsst

import torch_parallel_cases as cases
from test_torch_sst import _ambiguous, _ssq_close
from torch_threads import one_torch_thread  # noqa: F401

RED = dict(rtol=2e-5, atol=1e-6)           # the JAX sharded reductions
FUSED_POWER = dict(rtol=1e-4, atol=1e-5)   # its fused sharded kernels,
FUSED_ITC = dict(rtol=1e-3, atol=1e-4)     # interpret mode at "exact"
SF = 1000.0
N = 256
FREQS = np.arange(20.0, 52.0, 4.0, dtype=np.float32)     # 8 rows
WINDOW, MIN_HALO = 256, 40


def _jbank(n, freqs=FREQS, interpolate=False, wavelet=None):
    w = nw.Morse(SF) if wavelet is None else wavelet
    return make_fft_bank(w._wdef(), jnp.asarray(freqs), n, SF, interpolate,
                         getattr(w, "real_wave_length", 1.0))


def _signals(e, c, n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SF
    sig = np.sin(2 * np.pi * 36 * t)[None, None]
    return (sig + 0.3 * rng.standard_normal((e, c, n))).astype(np.float32)


def _np(x):
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def inp():
    cx = _jbank(N, wavelet=nw.MexicanHat(SF))
    halo = jpar.pow2_halo(WINDOW, MIN_HALO)
    rng = np.random.default_rng(3)
    return dict(
        sig=_signals(4, 2, N, 0), sig6=_signals(6, 2, N, 1),
        bank=_np(_jbank(N)), bank_t=_np(_jbank(N, interpolate=True)),
        cx_r=_np(cx.real), cx_i=_np(cx.imag), freqs=FREQS,
        g=rng.standard_normal((2, FREQS.size, N)).astype(np.float32),
        sl_banks=_np(jsl.superlet_banks(FREQS, N, SF, order_max=3)),
        sl_w=_np(jsl.superlet_weights(FREQS, 1, 3)),
        mt_banks=_np(jmt.multitaper_banks(FREQS, N, SF, n_tapers=2)),
        hint=list(jsst.uniform_grid_hint(FREQS)),
        long=_signals(1, 2, 4 * WINDOW, 2)[0], halo=halo,
        chunk_bank=_np(_jbank(WINDOW + 2 * halo, interpolate=True)))


def _jx(inp, *keys):
    return [jnp.asarray(inp[k]) for k in keys]


def _jchunk(fn, inp, **kw):
    return fn(jnp.asarray(inp["long"]), jnp.asarray(inp["chunk_bank"]),
              mesh=jpar.make_mesh(1, 1, 4), halo=inp["halo"],
              interpolate=True, **kw)


def _jfused(fn, inp, banks, shape, **kw):
    return fn(jnp.asarray(inp["sig"]), *_jx(inp, *banks),
              mesh=jpar.make_mesh(*shape), precision="exact",
              interpret=True, **kw)


#: The JAX package's sharded results, by case.
JAX = {
    "mean_power_22": lambda i: jpar.sharded_mean_power(
        *_jx(i, "sig", "bank"), mesh=jpar.make_mesh(2, 2, 1)),
    "mean_power_41": lambda i: jpar.sharded_mean_power(
        *_jx(i, "sig", "bank"), mesh=jpar.make_mesh(4, 1, 1)),
    "mean_power_cx_22": lambda i: jpar.sharded_mean_power(
        *_jx(i, "sig", "cx_r", "cx_i"), mesh=jpar.make_mesh(2, 2, 1)),
    "itc_22": lambda i: jpar.sharded_itc(
        *_jx(i, "sig", "bank"), mesh=jpar.make_mesh(2, 2, 1)),
    "itc_14": lambda i: jpar.sharded_itc(
        *_jx(i, "sig", "bank"), mesh=jpar.make_mesh(1, 4, 1)),
    "cwt_ri_41": lambda i: jpar.sharded_cwt_ri(
        *_jx(i, "sig", "bank"), mesh=jpar.make_mesh(4, 1, 1)),
    "power_22": lambda i: jpar.sharded_power(
        *_jx(i, "sig", "bank"), mesh=jpar.make_mesh(2, 2, 1)),
    "fused_mean_power_22": lambda i: _jfused(
        jpar.sharded_fused_mean_power, i, ["bank_t"], (2, 2, 1)),
    "fused_mean_power_cx_41": lambda i: _jfused(
        jpar.sharded_fused_mean_power, i, ["cx_r", "cx_i"], (4, 1, 1),
        interpolate=False),
    "fused_itc_22": lambda i: _jfused(
        jpar.sharded_fused_itc, i, ["bank_t"], (2, 2, 1)),
    "fused_itc_cx_22": lambda i: _jfused(
        jpar.sharded_fused_itc, i, ["cx_r", "cx_i"], (2, 2, 1),
        interpolate=False),
    "fused_power_itc_41": lambda i: _jfused(
        jpar.sharded_fused_power_itc, i, ["bank_t"], (4, 1, 1)),
    "grad_22": lambda i: jpar.sharded_mean_power_grad(
        *_jx(i, "sig", "bank", "g"), mesh=jpar.make_mesh(2, 2, 1)),
    "superlet_22": lambda i: jpar.sharded_superlet_mean_power(
        *_jx(i, "sig", "sl_banks", "sl_w"), mesh=jpar.make_mesh(2, 2, 1)),
    "multitaper_22": lambda i: jpar.sharded_multitaper_mean_power(
        *_jx(i, "sig", "mt_banks"), mesh=jpar.make_mesh(2, 2, 1)),
    "ssq_22": lambda i: jpar.sharded_ssq_mean_power(
        *_jx(i, "sig", "bank_t"), jnp.asarray(FREQS),
        mesh=jpar.make_mesh(2, 2, 1), sfreq=SF, interpolate=True),
    "reassigned_22": lambda i: jpar.sharded_reassigned_mean_power(
        *_jx(i, "sig", "bank_t"), jnp.asarray(FREQS),
        mesh=jpar.make_mesh(2, 2, 1), sfreq=SF, interpolate=True),
    "dist_power_22": lambda i: jpar.distributed_mean_power(
        i["sig"], nw.Morse(SF), FREQS, SF, mesh=jpar.make_mesh(2, 2, 1)),
    "dist_power_ragged_41": lambda i: jpar.distributed_mean_power(
        i["sig6"], nw.Morse(SF), FREQS, SF, mesh=jpar.make_mesh(4, 1, 1)),
    "dist_itc_22": lambda i: jpar.distributed_itc(
        i["sig"], nw.Morse(SF), FREQS, SF, mesh=jpar.make_mesh(2, 2, 1)),
    "chunked_power": lambda i: _jchunk(jpar.chunked_power, i),
    "chunked_abs": lambda i: _jchunk(jpar.chunked_abs, i),
    "chunked_cwt_ri": lambda i: _jchunk(jpar.chunked_cwt_ri, i),
    "chunked_fused": lambda i: _jchunk(jpar.chunked_fused_power, i,
                                       interpret=True, precision="exact"),
}


@pytest.fixture(scope="module")
def run(inp):
    return cases.start(cases.reduction_cases, (2, 2, 1), inp)


@pytest.fixture(scope="module")
def want(run, inp):
    """Computed while the ranks run."""
    return {k: jax.tree_util.tree_map(np.asarray, f(inp))
            for k, f in JAX.items()}


@pytest.fixture(scope="module")
def got(run, want):
    return run.result().result


_ok = cases.ok


def _close(a, b, rtol, atol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def _t(x):
    return torch.from_numpy(np.array(x))


# -- plain epoch reductions -------------------------------------------------------

@pytest.mark.parametrize("case", ["mean_power_22", "mean_power_41"])
def test_mean_power(got, want, inp, case):
    _close(_ok(got, case), want[case], **RED)
    _close(_ok(got, case), tcwt.mean_power_from_bank(
        _t(inp["sig"]), _t(inp["bank"])), **RED)


def test_mean_power_complex_bank(got, want):
    _close(_ok(got, "mean_power_cx_22"), want["mean_power_cx_22"], **RED)


@pytest.mark.parametrize("case", ["itc_22", "itc_14"])
def test_itc(got, want, case):
    _close(_ok(got, case), want[case], **RED)


def test_cwt_ri_and_power(got, want):
    for g, w in zip(_ok(got, "cwt_ri_41"), want["cwt_ri_41"]):
        _close(g, w, 2e-5, 1e-5)
    _close(_ok(got, "power_22"), want["power_22"], **RED)


# -- the fused kernels per rank (plain versions on the CPU) ---------------------------

@pytest.mark.parametrize("case,cx", [("fused_mean_power_22", False),
                                     ("fused_mean_power_cx_41", True)])
def test_fused_mean_power(got, want, inp, case, cx):
    _close(_ok(got, case), want[case], **FUSED_POWER)
    bank = (_t(inp["cx_r"]) + 1j * _t(inp["cx_i"]) if cx
            else _t(inp["bank_t"]))
    _close(_ok(got, case), tfused.fused_mean_power_from_bank(
        _t(inp["sig"]), bank, not cx), **RED)


@pytest.mark.parametrize("case", ["fused_itc_22", "fused_itc_cx_22"])
def test_fused_itc(got, want, case):
    _close(_ok(got, case), want[case], **FUSED_ITC)


def test_fused_power_itc(got, want, inp):
    p, i = _ok(got, "fused_power_itc_41")
    wp, wi = want["fused_power_itc_41"]
    _close(p, wp, **FUSED_POWER)
    _close(i, wi, **FUSED_ITC)
    sp, si = tfused.fused_power_itc_from_bank(_t(inp["sig"]),
                                              _t(inp["bank_t"]))
    _close(p, sp, **RED)
    _close(i, si, **RED)


def test_fused_power_itc_needs_divisible_epochs(got):
    cases.raised(got, "fused_power_itc_odd", ValueError,
                 "must divide the data axis (4)")


# -- the training step ------------------------------------------------------------------

def test_mean_power_grad(got, want, inp):
    wp, wds, wdb = want["grad_22"]
    p, ds, db = _ok(got, "grad_22")
    _close(p, wp, **RED)
    _close(ds, wds, 1e-4, 1e-5 * np.abs(wds).max())
    _close(db, wdb, 1e-4, 1e-5 * np.abs(wdb).max())
    sds, sdb = tfused.mean_power_bwd(_t(inp["sig"]), _t(inp["bank"]), False,
                                     _t(inp["g"]))
    _close(ds, sds, 1e-4, 1e-6 * np.abs(sds.numpy()).max())
    _close(db, sdb, 1e-4, 1e-6 * np.abs(sdb.numpy()).max())


# -- the zoo ------------------------------------------------------------------------------

def test_superlet_mean_power(got, want):
    _close(_ok(got, "superlet_22"), want["superlet_22"], 1e-4, 1e-6)


def test_multitaper_mean_power(got, want):
    _close(_ok(got, "multitaper_22"), want["multitaper_22"], **RED)


# -- synchrosqueezing and reassignment -------------------------------------------------------

@pytest.mark.parametrize("case,hint", [("ssq_22", False),
                                       ("ssq_hint_14", True)])
def test_ssq_mean_power(got, want, inp, case, hint):
    """Equal to the port's single device (the same cells, another summation
    order), and to the JAX package's sharded plane under the single-device
    SSQ gates of ``test_torch_sst``."""
    grid = tuple(inp["hint"]) if hint else None
    single = tsst.ssq_mean_power_from_bank(_t(inp["sig"]), _t(inp["bank_t"]),
                                           FREQS, SF, True, 1e-6, grid)
    _close(_ok(got, case), single, 2e-5, 1e-7)
    allow = _ambiguous(inp["sig"], inp["bank_t"], FREQS).mean(0)
    _ssq_close(_ok(got, case), want["ssq_22"], allow)


def test_reassigned_mean_power(got, want, inp):
    single = treassign.reassigned_mean_power(
        _t(inp["sig"]), _t(inp["bank_t"]), FREQS, SF, interpolate=True)
    got_p, want_p = _ok(got, "reassigned_22"), want["reassigned_22"]
    _close(got_p, single, 2e-5, 1e-6 * single.numpy().max())
    assert got_p.shape == want_p.shape == (2, 8, 16)
    np.testing.assert_allclose(got_p.astype(np.float64).sum((-2, -1)),
                               want_p.astype(np.float64).sum((-2, -1)),
                               rtol=1e-5)


# -- distributed_mean_power / distributed_itc ---------------------------------------------------

@pytest.mark.parametrize("case", ["dist_power_22", "dist_power_ragged_41",
                                  "dist_itc_22"])
def test_distributed(got, want, case):
    _close(_ok(got, case), want[case], **RED)


def test_distributed_itc_needs_divisible_epochs(got):
    cases.raised(got, "dist_itc_odd", ValueError,
                 "must divide the data axis (4)")


def test_distributed_on_the_default_mesh_complex_family(got, inp):
    """``mesh=None`` takes ``auto_mesh()`` over the four ranks, on the
    signals' device; a MexicanHat (complex) bank rides the plain path on
    the CPU."""
    mex = nt.MexicanHat(SF, device="cpu")
    single = tcwt.mean_power_from_bank(
        _t(inp["sig"]), nt.ops.bank.make_fft_bank(
            mex._wdef(), FREQS, N, SF, False, 1.0, device="cpu"))
    _close(_ok(got, "dist_power_auto_mesh"), single, **RED)


# -- the halo-exchanged chunked CWT on (1,1,4) ---------------------------------------------------

def test_chunked_power_abs_cwt_ri(got, want):
    _close(_ok(got, "chunked_power"), want["chunked_power"], **RED)
    _close(_ok(got, "chunked_abs"), want["chunked_abs"], **RED)
    for g, w in zip(_ok(got, "chunked_cwt_ri"), want["chunked_cwt_ri"]):
        _close(g, w, 2e-5, 1e-5)


def test_chunked_fused_power_and_auto(got, want):
    _close(_ok(got, "chunked_fused"), want["chunked_fused"], **FUSED_POWER)
    # on the CPU the auto dispatch takes the plain chunked path
    np.testing.assert_array_equal(_ok(got, "chunked_auto"),
                                  _ok(got, "chunked_power"))
