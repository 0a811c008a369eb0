"""The port's multi-device layer, world 2: the mesh helpers, the collectives,
the launcher, the exports, and the epoch reductions and chunked transform on
the (2,1,1), (1,2,1) and (1,1,2) meshes.

One ``run_on_mesh`` group of two gloo CPU ranks runs every case of this file
(``torch_parallel_cases.mesh_cases``); each result is held against the JAX
package's sharded function on the conftest's virtual CPU mesh of the same
shape (Pallas bodies in interpret mode), at the JAX sharded tests'
tolerances, and against the port's single-device function.
"""
import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ninwavelets_tpu as nw
import ninwavelets_tpu_torch as nt
from ninwavelets_tpu import parallel as jpar
from ninwavelets_tpu.ops.bank import make_fft_bank
from ninwavelets_tpu_torch import parallel as par
from ninwavelets_tpu_torch.ops import cwt as tcwt
from ninwavelets_tpu_torch.ops import fused as tfused

import torch_parallel_cases as cases
from torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 2e-5, 1e-6          # the JAX package's sharded reductions
FUSED_POWER = dict(rtol=1e-4, atol=1e-5)   # its fused sharded kernels,
FUSED_ITC = dict(rtol=1e-3, atol=1e-4)     # in interpret mode at "exact"
SF = 1000.0
FREQS = np.arange(20.0, 52.0, 4.0, dtype=np.float32)     # 8 rows
PORT = pathlib.Path(nt.__file__).parent


def _jbank(n, freqs=FREQS, interpolate=False, wavelet=None):
    w = nw.Morse(SF) if wavelet is None else wavelet
    return np.array(make_fft_bank(w._wdef(), jnp.asarray(freqs), n, SF,
                                  interpolate), np.float32)


def _signals(e, c, n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SF
    sig = np.sin(2 * np.pi * 36 * t)[None, None]
    return (sig + 0.3 * rng.standard_normal((e, c, n))).astype(np.float32)


def _jmesh(*shape):
    return jpar.make_mesh(*shape)


@pytest.fixture(scope="module")
def inp():
    n = 256
    window, min_halo = 256, 40
    halo = jpar.pow2_halo(window, min_halo)
    return dict(
        sig=_signals(4, 2, n, 0), bank=_jbank(n),
        bank_t=_jbank(n, interpolate=True), freqs=FREQS,
        long=_signals(1, 2, 2 * window, 1)[0], halo=halo,
        chunk_bank=_jbank(window + 2 * halo, interpolate=True))


def _jx(inp, *keys):
    return [jnp.asarray(inp[k]) for k in keys]


#: The JAX package's sharded results, by case.
JAX = {
    "mean_power_f2": lambda i: jpar.sharded_mean_power(
        *_jx(i, "sig", "bank"), mesh=_jmesh(1, 2, 1)),
    "mean_power_d2": lambda i: jpar.sharded_mean_power(
        *_jx(i, "sig", "bank"), mesh=_jmesh(2, 1, 1)),
    "fused_itc_d2": lambda i: jpar.sharded_fused_itc(
        *_jx(i, "sig", "bank_t"), mesh=_jmesh(2, 1, 1), interpret=True,
        precision="exact"),
    "fused_power_itc_f2": lambda i: jpar.sharded_fused_power_itc(
        *_jx(i, "sig", "bank_t"), mesh=_jmesh(1, 2, 1), interpret=True,
        precision="exact"),
    "distributed_ragged": lambda i: jpar.distributed_mean_power(
        i["sig"][:3], nw.Morse(SF), FREQS, SF, mesh=_jmesh(2, 1, 1)),
    "chunked_power_t2": lambda i: jpar.chunked_power(
        *_jx(i, "long", "chunk_bank"), mesh=_jmesh(1, 1, 2), halo=i["halo"],
        interpolate=True),
    "chunked_fused_t2": lambda i: jpar.chunked_fused_power(
        *_jx(i, "long", "chunk_bank"), mesh=_jmesh(1, 1, 2), halo=i["halo"],
        interpolate=True, interpret=True, precision="exact"),
}


@pytest.fixture(scope="module")
def run(inp):
    return cases.start(cases.mesh_cases, (2, 1, 1), inp, timeout=120)


@pytest.fixture(scope="module")
def want(run, inp):
    """Computed while the ranks run."""
    return {k: jax.tree_util.tree_map(np.asarray, f(inp))
            for k, f in JAX.items()}


@pytest.fixture(scope="module")
def got(run, want):
    return run.result().result


_ok = cases.ok
_raised = cases.raised


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


# -- the mesh, the collectives, the launcher -------------------------------------

def test_meshes_carry_the_three_axes(got):
    assert _ok(got, "mesh_names") == [["data", "freq", "time"]] * 3
    assert _ok(got, "mesh_shapes") == [[2, 1, 1], [1, 2, 1], [1, 1, 2]]
    assert got["backend"] == "gloo" and got["rank"] == 0


def test_auto_and_flat_mesh(got):
    assert _ok(got, "auto_mesh") == [2, 1, 1]
    names, shape = _ok(got, "flat_mesh")
    assert names == ["time"] and shape == [2]


@pytest.mark.parametrize("case,match", [("too_big", "needs 4 devices"),
                                        ("too_small", "every rank")])
def test_mesh_size_errors(got, case, match):
    _raised(got, case, ValueError, match)


def test_init_multihost_is_a_noop_in_a_group(got):
    assert _ok(got, "init_multihost_noop") == 2


def test_shard_batch_places_blocks(got, inp):
    shape, placements, full = _ok(got, "shard_batch")
    assert shape == [2, 2, 256]
    assert placements == ["R", "S(0)", "R"]
    np.testing.assert_array_equal(full, inp["sig"])


def test_collectives_over_the_time_axis(got):
    s, mean, mx, gathered, csum, right, left = _ok(got, "collectives")
    np.testing.assert_array_equal(s, [3.0, 6.0])
    np.testing.assert_array_equal(mean, [1.5])
    np.testing.assert_array_equal(mx, [2.0, -1.0])
    np.testing.assert_array_equal(gathered, [[1.0, 2.0]])
    np.testing.assert_array_equal(csum, [3.0 - 3.0j])
    # rank 0 (time coordinate 0) receives zeros from the left edge, and
    # rank 1's block (2.0) from the right
    np.testing.assert_array_equal(right, [0.0])
    np.testing.assert_array_equal(left, [2.0])


def test_exchange_halos_zero_pads_the_global_edges(got):
    ext = _ok(got, "halos")
    # rank 0: zeros | 0..7 | rank 1's first three samples
    np.testing.assert_array_equal(
        ext, np.concatenate([[0, 0, 0], np.arange(8.0), [100, 101, 102]])
        .reshape(1, 14))


def test_launcher_returns_every_rank_launches(run, got):
    launches = run.result().launches
    assert len(launches) == 2
    # CPU ranks run the kernels' plain versions: nothing launches
    assert all(not any(counts.values()) for counts in launches)


def test_launcher_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank 0 failed"):
        par.run_on_mesh(cases.failing_case, (1, 1, 1), device="cpu",
                        timeout=60)


def test_pad_to_multiple_matches_jax():
    x = np.arange(10.0).reshape(5, 2)
    np.testing.assert_array_equal(par.pad_to_multiple(x, 4, 0),
                                  jpar.pad_to_multiple(x, 4, 0))
    assert par.pad_to_multiple(x, 5, 0) is x


# -- the epoch reductions on (1,2,1) and (2,1,1) ------------------------------------

def test_mean_power_freq_split_matches_jax(got, want, inp):
    _close(_ok(got, "mean_power_f2"), want["mean_power_f2"])
    single = tcwt.mean_power_from_bank(torch.from_numpy(inp["sig"]),
                                       torch.from_numpy(inp["bank"]))
    _close(_ok(got, "mean_power_f2"), single)


def test_dtensor_inputs_take_the_same_path(got, want):
    np.testing.assert_array_equal(_ok(got, "mean_power_dtensor"),
                                  _ok(got, "mean_power_d2"))
    _close(_ok(got, "mean_power_d2"), want["mean_power_d2"])


def test_fused_itc_data_split_matches_jax(got, want, inp):
    _close(_ok(got, "fused_itc_d2"), want["fused_itc_d2"], **FUSED_ITC)
    single = tfused.fused_itc_from_bank(torch.from_numpy(inp["sig"]),
                                        torch.from_numpy(inp["bank_t"]))
    _close(_ok(got, "fused_itc_d2"), single)


def test_fused_power_itc_freq_split_matches_jax(got, want):
    p, i = _ok(got, "fused_power_itc_f2")
    wp, wi = want["fused_power_itc_f2"]
    _close(p, wp, **FUSED_POWER)
    _close(i, wi, **FUSED_ITC)


@pytest.mark.parametrize("case,match", [
    ("odd_freq", "'freq' mesh axis (2)"),
    ("odd_epochs", "must divide the data axis (2)"),
    ("distributed_itc_odd", "must divide the data axis (2)")])
def test_divisibility_errors(got, case, match):
    _raised(got, case, ValueError, match)


def test_distributed_mean_power_pads_ragged_epochs(got, want):
    _close(_ok(got, "distributed_ragged"), want["distributed_ragged"])


# -- the chunked transform on (1,1,2) -------------------------------------------------

def test_chunked_power_matches_jax(got, want):
    _close(_ok(got, "chunked_power_t2"), want["chunked_power_t2"])


def test_chunked_fused_power_matches_jax(got, want):
    _close(_ok(got, "chunked_fused_t2"), want["chunked_fused_t2"],
           **FUSED_POWER)
    _close(_ok(got, "chunked_fused_t2"), _ok(got, "chunked_power_t2"))


# -- exports and imports --------------------------------------------------------------

def test_parallel_exports_every_jax_name():
    missing = sorted(set(jpar.__all__) - set(par.__all__))
    assert not missing, missing
    for name in jpar.__all__:
        assert hasattr(par, name), name
    assert len([n for n in par.__all__ if n.startswith("sharded_")]) == 39


def test_top_level_reexports_the_jax_surface():
    assert set(nw.__all__) <= set(nt.__all__)
    assert nt.parallel is par


def test_parallel_imports_neither_jax_nor_the_jax_package():
    for path in sorted((PORT / "parallel").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "ninwavelets_tpu"), \
                    f"{path.name} imports {name}"
