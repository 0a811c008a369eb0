"""The port's multi-device layer, world 4: pair connectivity (cross power,
coherence and imaginary coherency with the global denominator floor, the
phase-lag family, PLV / PPC / n:m PLV, the all-pairs matrices, the phase
slope index, PAC, envelope correlation, wavelet Granger) and the fused
cross-pair sums per rank, on the (2,2,1), (4,1,1) and (1,4,1) meshes.

One ``run_on_mesh`` group of four gloo CPU ranks runs every case
(``torch_parallel_cases.pair_cases``).  Each result is held against the JAX
package's sharded function on the conftest's virtual CPU mesh of the same
shape (Pallas bodies in interpret mode at "exact") under the single-device
connectivity gates of ``test_torch_connectivity`` (pair paths 1e-4 of the
plane's maximum; the unit-phase and sign-count rules), and against the
port's single-device function.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ninwavelets_tpu as nw
from ninwavelets_tpu import parallel as jpar
from ninwavelets_tpu.ops import granger as jgranger
from ninwavelets_tpu.ops.bank import make_fft_bank
from ninwavelets_tpu_torch.ops import connectivity as tconn
from ninwavelets_tpu_torch.ops import extensions as text

import torch_parallel_cases as cases
from test_torch_connectivity import (_coeffs64, assert_rel,
                                     assert_unit_close)
from torch_threads import one_torch_thread  # noqa: F401

SF = 1000.0
N = 256
FREQS = np.arange(20.0, 52.0, 4.0, dtype=np.float32)     # 8 rows
PAIR = dict(rtol=1e-4, atol=1e-5)         # the JAX sharded pair paths
FUSED_PAIR = dict(rtol=1e-3, atol=1e-4)   # its fused pair kernels


def _jbank(n, freqs=FREQS, interpolate=False, wavelet=None):
    w = nw.Morse(SF) if wavelet is None else wavelet
    return make_fft_bank(w._wdef(), jnp.asarray(freqs), n, SF, interpolate,
                         getattr(w, "real_wave_length", 1.0))


def _np(x):
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def inp():
    rng = np.random.default_rng(21)
    t = np.arange(N) / SF
    tone = np.sin(2 * np.pi * 36 * t)
    sa = (tone + 0.5 * rng.standard_normal((4, 2, N))).astype(np.float32)
    lag = np.sin(2 * np.pi * 36 * t - 0.7)
    sb = (lag + 0.5 * rng.standard_normal((4, 2, N))).astype(np.float32)
    sigs = (tone + 0.6 * rng.standard_normal((4, 3, N))).astype(np.float32)
    sigs[:, 1] += 0.8 * np.roll(sigs[:, 0], 3, -1)
    cx = _jbank(N, wavelet=nw.MexicanHat(SF))
    bank = _np(_jbank(N))
    dead = bank.copy()
    dead[4:] = 0.0            # the last two freq ranks of (1,4,1) hold no power
    slow = np.sin(2 * np.pi * 8 * t)
    pac_sig = ((1 + 0.8 * slow) * np.sin(2 * np.pi * 60 * t) + slow
               + 0.2 * rng.standard_normal((4, 2, N))).astype(np.float32)
    _, gc_bank = jgranger._granger_inputs(sigs, SF, 5, True)
    return dict(
        sa=sa, sb=sb, sigs=sigs, bank=bank,
        bank_t=_np(_jbank(N, interpolate=True)),
        bank2=_np(_jbank(N, 2 * FREQS)), cx_r=_np(cx.real),
        cx_i=_np(cx.imag), dead_bank=dead, pac_sig=pac_sig,
        pac_bp=_np(_jbank(N, np.array([6, 8, 10, 12], np.float32))),
        pac_ba=_np(_jbank(N, np.array([50, 60, 70], np.float32))),
        gc_bank=_np(gc_bank))


def _jx(inp, *keys):
    return [jnp.asarray(inp[k]) for k in keys]


def _m(*shape):
    return jpar.make_mesh(*shape)


#: The JAX package's sharded results, by case.
JAX = {
    "cross_power": lambda i: jpar.sharded_cross_power(
        *_jx(i, "sa", "sb", "bank"), mesh=_m(2, 2, 1)),
    "coherence": lambda i: jpar.sharded_coherence(
        *_jx(i, "sa", "sb", "bank"), mesh=_m(2, 2, 1)),
    "coherence_cx": lambda i: jpar.sharded_coherence(
        *_jx(i, "sa", "sb", "cx_r", "cx_i"), mesh=_m(4, 1, 1)),
    "coherence_dead": lambda i: jpar.sharded_coherence(
        *_jx(i, "sa", "sb", "dead_bank"), mesh=_m(1, 4, 1)),
    "imcoh": lambda i: jpar.sharded_imcoh(
        *_jx(i, "sa", "sb", "bank"), mesh=_m(2, 2, 1)),
    "fused_coherence": lambda i: jpar.sharded_fused_coherence(
        *_jx(i, "sa", "sb", "bank_t"), mesh=_m(2, 2, 1), interpret=True,
        precision="exact"),
    "phase_lag_pli": lambda i: jpar.sharded_phase_lag(
        *_jx(i, "sa", "sb", "bank"), mesh=_m(2, 2, 1), method="pli"),
    "phase_lag_wpli": lambda i: jpar.sharded_phase_lag(
        *_jx(i, "sa", "sb", "bank"), mesh=_m(2, 2, 1), method="wpli"),
    "phase_lag_dwpli": lambda i: jpar.sharded_phase_lag(
        *_jx(i, "sa", "sb", "bank"), mesh=_m(2, 2, 1), method="dwpli"),
    "fused_phase_lag": lambda i: jpar.sharded_fused_phase_lag(
        *_jx(i, "sa", "sb", "bank_t"), mesh=_m(2, 2, 1), method="dwpli",
        interpret=True, precision="exact"),
    "ppc": lambda i: jpar.sharded_ppc(
        *_jx(i, "sa", "sb", "bank"), mesh=_m(2, 2, 1)),
    "plv": lambda i: jpar.sharded_plv(
        *_jx(i, "sa", "sb", "bank"), mesh=_m(4, 1, 1)),
    "nm_plv": lambda i: jpar.sharded_nm_plv(
        *_jx(i, "sa", "sb", "bank", "bank2"), mesh=_m(2, 2, 1), n=1, m=2),
    "plv_matrix": lambda i: jpar.sharded_plv_matrix(
        *_jx(i, "sigs", "bank"), mesh=_m(2, 2, 1), time_range=(16, 240)),
    "coherence_matrix": lambda i: jpar.sharded_coherence_matrix(
        *_jx(i, "sigs", "bank"), mesh=_m(2, 2, 1)),
    "coherence_matrix_cx": lambda i: jpar.sharded_coherence_matrix(
        *_jx(i, "sigs", "cx_r", "cx_i"), mesh=_m(4, 1, 1)),
    "partial_coherence": lambda i: jpar.sharded_partial_coherence(
        *_jx(i, "sigs", "bank"), mesh=_m(2, 2, 1)),
    "psi": lambda i: jpar.sharded_psi_matrix(
        *_jx(i, "sigs", "bank_t"), mesh=_m(2, 2, 1)),
    "psi_raw": lambda i: jpar.sharded_psi_matrix(
        *_jx(i, "sigs", "bank_t"), mesh=_m(4, 1, 1), normalize=False),
    "pac": lambda i: jpar.sharded_pac(
        *_jx(i, "pac_sig", "pac_bp", "pac_ba"), mesh=_m(2, 2, 1)),
    "pac_tort": lambda i: jpar.sharded_pac(
        *_jx(i, "pac_sig", "pac_bp", "pac_ba"), mesh=_m(4, 1, 1),
        method="tort", n_bins=6),
    "env_corr": lambda i: jpar.sharded_env_corr(
        *_jx(i, "sigs", "bank"), mesh=_m(2, 2, 1)),
    "granger": lambda i: jpar.sharded_wavelet_granger(
        *_jx(i, "sigs", "gc_bank"), mesh=_m(2, 2, 1), n_iter=8),
}


@pytest.fixture(scope="module")
def run(inp):
    return cases.start(cases.pair_cases, (2, 2, 1), inp)


@pytest.fixture(scope="module")
def want(run, inp):
    """Computed while the ranks run."""
    return {k: jax.tree_util.tree_map(np.asarray, f(inp))
            for k, f in JAX.items()}


@pytest.fixture(scope="module")
def got(run, want):
    return run.result().result


_ok = cases.ok


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(a, b, rtol, atol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


# -- pair statistics ---------------------------------------------------------------

def test_cross_power(got, want):
    for g, w in zip(_ok(got, "cross_power"), want["cross_power"]):
        _close(g, w, 2e-5, 1e-5 * np.abs(w).max())


@pytest.mark.parametrize("case", ["coherence", "coherence_cx", "imcoh",
                                  "phase_lag_wpli", "phase_lag_dwpli"])
def test_pair_statistic(got, want, case):
    assert_rel(_ok(got, case), want[case], PAIR["rtol"])


@pytest.mark.parametrize("case,fn", [
    ("coherence_dead", text.epoch_coherence_from_bank),
    ("imcoh_dead", text.imcoh_from_bank)])
def test_denominator_floor_takes_the_global_max(got, want, inp, case, fn):
    """Two of the four freq ranks hold only dead rows: their floor must
    come from the whole plane's maximum, so they read 0 as on one device,
    not 0/0."""
    out = _ok(got, case)
    single = fn(_t(inp["sa"]), _t(inp["sb"]), _t(inp["dead_bank"])).numpy()
    assert np.isfinite(out).all()
    assert (out[..., 4:, :] == 0).all()
    assert_rel(out, single, 1e-5)
    if case in want:
        assert_rel(out, want[case], PAIR["rtol"])


def test_fused_coherence(got, want, inp):
    _close(_ok(got, "fused_coherence"), want["fused_coherence"],
           **FUSED_PAIR)
    single = text.epoch_coherence_from_bank(
        _t(inp["sa"]), _t(inp["sb"]), _t(inp["bank_t"]), True).numpy()
    assert_rel(_ok(got, "fused_coherence"), single, 1e-5)


def test_fused_phase_lag(got, want, inp):
    _close(_ok(got, "fused_phase_lag"), want["fused_phase_lag"],
           **FUSED_PAIR)
    single = tconn.phase_lag(_t(inp["sa"]), _t(inp["sb"]),
                             _t(inp["bank_t"]), "dwpli", True)
    assert_rel(_ok(got, "fused_phase_lag"), single.numpy(), 1e-5)


def test_pli_sign_counts(got, want, inp):
    """PLI is a count of signs: equal to the port's single device exactly
    (integer sums), and within the sign-count rule of the JAX package."""
    pli = _ok(got, "phase_lag_pli")
    single = tconn.phase_lag(_t(inp["sa"]), _t(inp["sb"]), _t(inp["bank"]),
                             "pli", False)
    np.testing.assert_array_equal(pli, single.numpy())
    wa = _coeffs64(inp["sa"], inp["bank"], False)
    wb = _coeffs64(inp["sb"], inp["bank"], False)
    im = (wa * np.conj(wb)).imag
    ma = np.abs(wa).max(-1, keepdims=True)
    mb = np.abs(wb).max(-1, keepdims=True)
    near = np.abs(im) <= 1e-5 * (np.abs(wa) * mb + np.abs(wb) * ma)
    assert (np.abs(pli - want["phase_lag_pli"]) * 4
            <= 2 * near.sum(0) + 1e-6).all()


@pytest.mark.parametrize("case,scale", [("plv", 1.0), ("ppc", 8.0 / 3.0)])
def test_unit_phase_statistics(got, want, inp, case, scale):
    wa = _coeffs64(inp["sa"], inp["bank"], False)
    wb = _coeffs64(inp["sb"], inp["bank"], False)
    assert_unit_close(_ok(got, case), want[case], wa, wb, scale)


def test_nm_plv(got, want):
    _close(_ok(got, "nm_plv"), want["nm_plv"], 2e-3, 2e-3)


# -- the all-pairs matrices, PSI ------------------------------------------------------

@pytest.mark.parametrize("case", ["plv_matrix", "coherence_matrix",
                                  "coherence_matrix_cx", "partial_coherence",
                                  "env_corr"])
def test_matrix(got, want, case):
    assert_rel(_ok(got, case), want[case], PAIR["rtol"])


@pytest.mark.parametrize("case", ["psi", "psi_raw"])
def test_psi_matrix(got, want, inp, case):
    out = _ok(got, case)
    assert_rel(out, want[case], PAIR["rtol"])
    single = tconn.psi_matrix_from_bank(_t(inp["sigs"]), _t(inp["bank_t"]),
                                        normalize=case == "psi").numpy()
    assert_rel(out, single, 1e-5)
    np.testing.assert_allclose(out, -out.T, atol=1e-6)


@pytest.mark.parametrize("case,match", [("psi_one_epoch", "2 epochs"),
                                        ("psi_one_row", "2 bank rows")])
def test_psi_errors(got, case, match):
    cases.raised(got, case, ValueError, match)


# -- PAC, Granger ---------------------------------------------------------------------

@pytest.mark.parametrize("case", ["pac", "pac_tort"])
def test_pac(got, want, case):
    _close(_ok(got, case), want[case], 1e-4, 1e-5 * np.abs(want[case]).max())


def test_wavelet_granger(got, want):
    out = _ok(got, "granger")
    assert out.shape == (16, 5, 3, 3)
    assert_rel(out, want["granger"], 1e-3)
