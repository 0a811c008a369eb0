"""Rank-side cases of the port's multi-device tests (``test_torch_parallel_*``).

Each ``*_cases(mesh, inp)`` runs on every rank of one ``run_on_mesh`` group
(gloo, CPU ranks) and returns ``{case: result}``; the test module holds the
results against the JAX package's sharded functions and the port's
single-device functions.  A case that raises records its traceback instead,
so one failing case does not take the others with it.  This module imports
the port only (the ranks never import JAX).
"""
from __future__ import annotations

import traceback

import numpy as np
import torch
import torch.distributed as dist

import ninwavelets_tpu_torch as nt
from ninwavelets_tpu_torch import parallel as par
from ninwavelets_tpu_torch.parallel import collectives


def start(fn, shape, inp, timeout=180.0):
    """``run_on_mesh(fn, shape)`` on gloo CPU ranks in a background thread:
    the test module computes its JAX references while the ranks work.
    Returns the future of the ``MeshRun``."""
    from concurrent.futures import ThreadPoolExecutor
    pool = ThreadPoolExecutor(1)
    fut = pool.submit(par.run_on_mesh, fn, shape, device="cpu",
                      args=(inp,), timeout=timeout)
    pool.shutdown(wait=False)
    return fut


def ok(got: dict, name: str):
    """The result of case ``name``; a case that raised fails the test with
    its rank-side traceback."""
    import pytest
    r = got[name]
    if isinstance(r, tuple) and r and isinstance(r[0], str) \
            and r[0] == "error":
        pytest.fail(f"{name}: {r[3]}")
    return r


def raised(got: dict, name: str, exc: type, match: str) -> None:
    """Case ``name`` raised ``exc`` with ``match`` in its message."""
    r = got[name]
    assert isinstance(r, tuple) and r and r[0] == "error", r
    assert r[1] == exc.__name__ and match in r[2], r[2]


def _run(results: dict, name: str, fn) -> None:
    try:
        results[name] = fn()
    except Exception as exc:  # recorded, checked by the test of the case
        results[name] = ("error", type(exc).__name__, str(exc),
                         traceback.format_exc())


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _meshes(shapes):
    return {s: par.make_mesh(*s, devices="cpu") for s in shapes}


# -- mesh helpers, collectives, small epoch reductions, chunking (world 2) ----

def mesh_cases(mesh, inp):
    out = {}
    m = _meshes([(2, 1, 1), (1, 2, 1), (1, 1, 2)])
    out["rank"] = dist.get_rank()
    out["backend"] = collectives.backend()
    _run(out, "mesh_names", lambda: [list(mm.mesh_dim_names)
                                    for mm in m.values()])
    _run(out, "mesh_shapes", lambda: [list(mm.mesh.shape)
                                     for mm in m.values()])
    _run(out, "auto_mesh", lambda: list(par.auto_mesh(devices="cpu")
                                        .mesh.shape))
    _run(out, "flat_mesh", lambda: (list(par.flat_mesh(devices="cpu")
                                         .mesh_dim_names),
                                    list(par.flat_mesh("data", "cpu")
                                         .mesh.shape)))
    _run(out, "too_big", lambda: par.make_mesh(4, 1, 1, devices="cpu"))
    _run(out, "too_small", lambda: par.make_mesh(1, 1, 1, devices="cpu"))
    _run(out, "init_multihost_noop",
         lambda: (par.init_multihost("127.0.0.1:1", 9, 0), dist.get_world_size())[1])
    x = _t(inp["sig"])
    _run(out, "shard_batch", lambda: (
        list(par.shard_batch(x, m[(2, 1, 1)], ("data",)).to_local().shape),
        [str(p) for p in par.shard_batch(inp["bank"], m[(1, 2, 1)],
                                         ("freq", None)).placements],
        par.shard_batch(x, m[(2, 1, 1)], ("data",)).full_tensor()))
    r = float(dist.get_rank() + 1)
    tg = m[(1, 1, 2)].get_group("time")
    _run(out, "collectives", lambda: (
        collectives.psum(torch.tensor([r, 2 * r]), tg),
        collectives.pmean(torch.tensor([r]), tg),
        collectives.pmax(torch.tensor([r, -r]), tg),
        collectives.all_gather(torch.tensor([[r]]), tg, dim=1),
        collectives.psum(torch.tensor([complex(r, -r)]), tg),
        collectives.shift(torch.tensor([r]), tg, +1),
        collectives.shift(torch.tensor([r]), tg, -1)))
    _run(out, "halos", lambda: par.chunked._exchange_halos(
        torch.arange(8.0).reshape(1, 8) + 100 * dist.get_rank(), 3, tg))
    bank, bank_t = _t(inp["bank"]), _t(inp["bank_t"])
    _run(out, "mean_power_f2", lambda: par.sharded_mean_power(
        x, bank, mesh=m[(1, 2, 1)]))
    _run(out, "mean_power_d2", lambda: par.sharded_mean_power(
        x, bank, mesh=m[(2, 1, 1)]))
    _run(out, "mean_power_dtensor", lambda: par.sharded_mean_power(
        par.shard_batch(x, m[(2, 1, 1)], ("data",)),
        par.shard_batch(bank, m[(2, 1, 1)], (None, None)),
        mesh=m[(2, 1, 1)]))
    _run(out, "fused_itc_d2", lambda: par.sharded_fused_itc(
        x, bank_t, mesh=m[(2, 1, 1)]))
    _run(out, "fused_power_itc_f2", lambda: par.sharded_fused_power_itc(
        x, bank_t, mesh=m[(1, 2, 1)]))
    _run(out, "odd_freq", lambda: par.sharded_mean_power(
        x, bank[:3], mesh=m[(1, 2, 1)]))
    _run(out, "odd_epochs", lambda: par.sharded_fused_power_itc(
        x[:3], bank_t, mesh=m[(2, 1, 1)]))
    _run(out, "distributed_ragged", lambda: par.distributed_mean_power(
        x[:3], nt.Morse(1000.0, device="cpu"), inp["freqs"], 1000.0,
        mesh=m[(2, 1, 1)]))
    _run(out, "distributed_itc_odd", lambda: par.distributed_itc(
        x[:3], nt.Morse(1000.0, device="cpu"), inp["freqs"], 1000.0,
        mesh=m[(2, 1, 1)]))
    long, cb = _t(inp["long"]), _t(inp["chunk_bank"])
    h = int(inp["halo"])
    _run(out, "chunked_power_t2", lambda: par.chunked_power(
        long, cb, mesh=m[(1, 1, 2)], halo=h, interpolate=True))
    _run(out, "chunked_fused_t2", lambda: par.chunked_fused_power(
        long, cb, mesh=m[(1, 1, 2)], halo=h, interpolate=True))
    return out


def _raise(mesh):
    raise RuntimeError("rank failure on purpose")


def failing_case(mesh):
    """A case that fails on rank 0 only (the launcher must report it)."""
    if dist.get_rank() == 0:
        _raise(mesh)
    return {}


# -- epoch reductions, training step, zoo, SSQ, API, chunking (world 4) -------

def reduction_cases(mesh, inp):
    out = {}
    m = _meshes([(2, 2, 1), (4, 1, 1), (1, 4, 1), (1, 1, 4)])
    x = _t(inp["sig"])
    bank, bank_t = _t(inp["bank"]), _t(inp["bank_t"])
    br, bi = _t(inp["cx_r"]), _t(inp["cx_i"])
    m22, m41, m14 = m[(2, 2, 1)], m[(4, 1, 1)], m[(1, 4, 1)]
    _run(out, "mean_power_22", lambda: par.sharded_mean_power(
        x, bank, mesh=m22))
    _run(out, "mean_power_41", lambda: par.sharded_mean_power(
        x, bank, mesh=m41))
    _run(out, "mean_power_cx_22", lambda: par.sharded_mean_power(
        x, br, bi, mesh=m22))
    _run(out, "itc_22", lambda: par.sharded_itc(x, bank, mesh=m22))
    _run(out, "itc_14", lambda: par.sharded_itc(x, bank, mesh=m14))
    _run(out, "cwt_ri_41", lambda: par.sharded_cwt_ri(x, bank, mesh=m41))
    _run(out, "power_22", lambda: par.sharded_power(x, bank, mesh=m22))
    _run(out, "fused_mean_power_22", lambda: par.sharded_fused_mean_power(
        x, bank_t, mesh=m22))
    _run(out, "fused_mean_power_cx_41", lambda: par.sharded_fused_mean_power(
        x, br, bi, mesh=m41, interpolate=False))
    _run(out, "fused_itc_22", lambda: par.sharded_fused_itc(
        x, bank_t, mesh=m22))
    _run(out, "fused_itc_cx_22", lambda: par.sharded_fused_itc(
        x, br, bi, mesh=m22, interpolate=False))
    _run(out, "fused_power_itc_41", lambda: par.sharded_fused_power_itc(
        x, bank_t, mesh=m41))
    _run(out, "fused_power_itc_odd", lambda: par.sharded_fused_power_itc(
        x[:2], bank_t, mesh=m41))
    _run(out, "grad_22", lambda: par.sharded_mean_power_grad(
        x, bank, _t(inp["g"]), mesh=m22))
    _run(out, "superlet_22", lambda: par.sharded_superlet_mean_power(
        x, _t(inp["sl_banks"]), _t(inp["sl_w"]), mesh=m22))
    _run(out, "multitaper_22", lambda: par.sharded_multitaper_mean_power(
        x, _t(inp["mt_banks"]), mesh=m22))
    _run(out, "ssq_22", lambda: par.sharded_ssq_mean_power(
        x, bank_t, inp["freqs"], mesh=m22, sfreq=1000.0))
    _run(out, "ssq_hint_14", lambda: par.sharded_ssq_mean_power(
        x, bank_t, inp["freqs"], mesh=m14, sfreq=1000.0,
        uniform_grid=tuple(inp["hint"])))
    _run(out, "reassigned_22", lambda: par.sharded_reassigned_mean_power(
        x, bank_t, inp["freqs"], mesh=m22, sfreq=1000.0))
    mo = nt.Morse(1000.0, device="cpu")
    _run(out, "dist_power_22", lambda: par.distributed_mean_power(
        x, mo, inp["freqs"], 1000.0, mesh=m22))
    _run(out, "dist_power_ragged_41", lambda: par.distributed_mean_power(
        _t(inp["sig6"]), mo, inp["freqs"], 1000.0, mesh=m41))
    _run(out, "dist_itc_22", lambda: par.distributed_itc(
        x, mo, inp["freqs"], 1000.0, mesh=m22))
    _run(out, "dist_itc_odd", lambda: par.distributed_itc(
        _t(inp["sig6"]), mo, inp["freqs"], 1000.0, mesh=m41))
    _run(out, "dist_power_auto_mesh", lambda: par.distributed_mean_power(
        x, nt.MexicanHat(1000.0, device="cpu"), inp["freqs"], 1000.0))
    long, cb = _t(inp["long"]), _t(inp["chunk_bank"])
    h, m4 = int(inp["halo"]), m[(1, 1, 4)]
    kw = dict(mesh=m4, halo=h, interpolate=True)
    _run(out, "chunked_power", lambda: par.chunked_power(long, cb, **kw))
    _run(out, "chunked_abs", lambda: par.chunked_abs(long, cb, **kw))
    _run(out, "chunked_cwt_ri", lambda: par.chunked_cwt_ri(long, cb, **kw))
    _run(out, "chunked_fused", lambda: par.chunked_fused_power(
        long, cb, **kw))
    _run(out, "chunked_auto", lambda: par.chunked_power_auto(long, cb, **kw))
    return out


# -- pair connectivity (world 4) ----------------------------------------------

def pair_cases(mesh, inp):
    out = {}
    m = _meshes([(2, 2, 1), (4, 1, 1), (1, 4, 1)])
    m22, m41, m14 = m[(2, 2, 1)], m[(4, 1, 1)], m[(1, 4, 1)]
    sa, sb = _t(inp["sa"]), _t(inp["sb"])
    bank, bank_t = _t(inp["bank"]), _t(inp["bank_t"])
    br, bi = _t(inp["cx_r"]), _t(inp["cx_i"])
    _run(out, "cross_power", lambda: par.sharded_cross_power(
        sa, sb, bank, mesh=m22))
    _run(out, "coherence", lambda: par.sharded_coherence(
        sa, sb, bank, mesh=m22))
    _run(out, "coherence_cx", lambda: par.sharded_coherence(
        sa, sb, br, bi, mesh=m41))
    _run(out, "coherence_dead", lambda: par.sharded_coherence(
        sa, sb, _t(inp["dead_bank"]), mesh=m14))
    _run(out, "imcoh", lambda: par.sharded_imcoh(sa, sb, bank, mesh=m22))
    _run(out, "imcoh_dead", lambda: par.sharded_imcoh(
        sa, sb, _t(inp["dead_bank"]), mesh=m14))
    _run(out, "fused_coherence", lambda: par.sharded_fused_coherence(
        sa, sb, bank_t, mesh=m22))
    for method in ("pli", "wpli", "dwpli"):
        _run(out, f"phase_lag_{method}", lambda method=method:
             par.sharded_phase_lag(sa, sb, bank, mesh=m22, method=method))
    _run(out, "fused_phase_lag", lambda: par.sharded_fused_phase_lag(
        sa, sb, bank_t, mesh=m22, method="dwpli"))
    _run(out, "ppc", lambda: par.sharded_ppc(sa, sb, bank, mesh=m22))
    _run(out, "plv", lambda: par.sharded_plv(sa, sb, bank, mesh=m41))
    _run(out, "nm_plv", lambda: par.sharded_nm_plv(
        sa, sb, bank, _t(inp["bank2"]), mesh=m22, n=1, m=2))
    sg = _t(inp["sigs"])
    _run(out, "plv_matrix", lambda: par.sharded_plv_matrix(
        sg, bank, mesh=m22, time_range=(16, 240)))
    _run(out, "coherence_matrix", lambda: par.sharded_coherence_matrix(
        sg, bank, mesh=m22))
    _run(out, "coherence_matrix_cx", lambda: par.sharded_coherence_matrix(
        sg, br, bi, mesh=m41))
    _run(out, "partial_coherence", lambda: par.sharded_partial_coherence(
        sg, bank, mesh=m22))
    _run(out, "psi", lambda: par.sharded_psi_matrix(sg, bank_t, mesh=m22))
    _run(out, "psi_raw", lambda: par.sharded_psi_matrix(
        sg, bank_t, mesh=m41, normalize=False))
    _run(out, "psi_one_epoch", lambda: par.sharded_psi_matrix(
        sg[:1], bank_t, mesh=m22))
    _run(out, "psi_one_row", lambda: par.sharded_psi_matrix(
        sg, bank_t[:1], mesh=m22))
    _run(out, "pac", lambda: par.sharded_pac(
        _t(inp["pac_sig"]), _t(inp["pac_bp"]), _t(inp["pac_ba"]), mesh=m22))
    _run(out, "pac_tort", lambda: par.sharded_pac(
        _t(inp["pac_sig"]), _t(inp["pac_bp"]), _t(inp["pac_ba"]), mesh=m41,
        method="tort", n_bins=6))
    _run(out, "env_corr", lambda: par.sharded_env_corr(sg, bank, mesh=m22))
    _run(out, "granger", lambda: par.sharded_wavelet_granger(
        sg, _t(inp["gc_bank"]), mesh=m22, n_iter=8))
    return out


# -- statistics, transforms, decoders, state model (world 2) ------------------

def stats_cases(mesh, inp):
    out = {}
    m = _meshes([(2, 1, 1), (1, 2, 1)])
    md, mf = m[(2, 1, 1)], m[(1, 2, 1)]
    x, thr = _t(inp["cl_x"]), float(inp["cl_thr"])
    kw = dict(mesh=md, n_perm=int(inp["n_perm"]), threshold=thr)
    _run(out, "null_sign", lambda: par.sharded._sharded_cluster_null_from_draws(
        x, _t(inp["signs"]), **kw))
    _run(out, "null_relabel",
         lambda: par.sharded._sharded_cluster_null_from_draws(
             x, _t(inp["relabel"]), na=int(inp["na"]), **kw))
    _run(out, "null_anova",
         lambda: par.sharded._sharded_cluster_null_from_draws(
             x, _t(inp["anova"]), sizes=tuple(inp["sizes"]), **kw))
    xa = _t(inp["cl_x"])
    xb = _t(inp["cl_y"])
    ckw = dict(mesh=md, n_perm=30, seed=3)
    _run(out, "test_one", lambda: par.sharded_cluster_test_one_sample(
        xa, **ckw))
    _run(out, "test_ind", lambda: par.sharded_cluster_test_independent(
        xa, xb, **ckw))
    _run(out, "test_f", lambda: par.sharded_cluster_test_f(
        [xa, xb, xa[:4] - 0.5], **ckw))
    _run(out, "null_seed", lambda: par.sharded_cluster_null(
        x, 5, mesh=md, n_perm=20, threshold=thr, chunk=8))
    ew = nt.EpochsWavelet(
        nt.ArrayEpochs(inp["epochs"], 250.0, ["c0", "c1"]),
        nt.Morse(250.0, device="cpu"))
    freqs = inp["ad_freqs"]
    akw = dict(baseline=(0.0, 0.4), n_perm=20, seed=2)
    for mesh_name, mm in (("none", None), ("mesh", md)):
        _run(out, f"adapter_test_{mesh_name}", lambda mm=mm: ew.cluster_test(
            "c0", freqs, mesh=mm, **akw))
        _run(out, f"adapter_paired_{mesh_name}",
             lambda mm=mm: ew.cluster_test("c0", freqs, other=ew,
                                           paired=True, mesh=mm, **akw))
        _run(out, f"adapter_ind_{mesh_name}",
             lambda mm=mm: ew.cluster_test("c0", freqs, other=inp["other"],
                                           mesh=mm, n_perm=20, seed=2))
        _run(out, f"adapter_all_{mesh_name}",
             lambda mm=mm: ew.cluster_test_all(freqs, adjacency=[[0, 1]],
                                               mesh=mm, **akw))
        _run(out, f"adapter_f_{mesh_name}",
             lambda mm=mm: ew.cluster_f("c0", freqs, [ew, inp["other"]],
                                        mesh=mm, n_perm=20, seed=2))
    sig = _t(inp["sig"])
    _run(out, "modwt", lambda: par.sharded_modwt(sig, mesh=md, level=3))
    _run(out, "modwt_denoise", lambda: par.sharded_modwt(
        sig, mesh=md, denoise=True, mode="hard"))
    _run(out, "stockwell", lambda: par.sharded_stockwell(
        sig, inp["st_freqs"], mesh=mf, sfreq=1000.0))
    _run(out, "stockwell_bad", lambda: par.sharded_stockwell(
        sig, [0.0, 40.0], mesh=mf, sfreq=1000.0))
    ta, tb = _t(inp["tf_a"]), _t(inp["tf_b"])
    _run(out, "tf_decode", lambda: par.sharded_tf_decode(
        ta, tb, mesh=mf, n_folds=3))
    _run(out, "tf_decode_few", lambda: par.sharded_tf_decode(
        ta[:2], tb, mesh=mf, n_folds=3))
    hx = _t(inp["hmm_x"])
    hkw = dict(mesh=md, n_states=3, n_iter=5, stickiness=0.8)
    _run(out, "hmm", lambda: par.sharded._sharded_hmm_from_perm(
        hx, _t(inp["hmm_perm"]), **hkw))
    _run(out, "hmm_seed", lambda: par.sharded_hmm_fit(hx, seed=1, **hkw))
    _run(out, "hmm_odd", lambda: par.sharded_hmm_fit(hx[:3], **hkw))
    ix = _t(inp["ica_x"])
    _run(out, "ica", lambda: par.sharded._sharded_fastica_from_w0(
        ix, _t(inp["ica_w0"]), mesh=md, n_iter=200))
    _run(out, "ica_seed", lambda: par.sharded_fastica(ix, mesh=md, n_iter=4))
    _run(out, "ica_odd", lambda: par.sharded_fastica(ix[:, :-1], mesh=md))
    cx = _t(inp["cov_x"])
    _run(out, "covariance", lambda: par.sharded_covariance(cx, mesh=md))
    _run(out, "covariance_odd", lambda: par.sharded_covariance(
        cx[:3], mesh=md))
    _run(out, "csp", lambda: par.sharded_csp(cx, _t(inp["cov_y"]), mesh=md,
                                             n_components=2))
    return out
