"""Sharded batch transforms: the epoch reductions, connectivity, statistics,
transforms and decoders scaled over a mesh (port of
``ninwavelets_tpu.parallel.sharded``).

The JAX package runs each of these as a ``shard_map`` program over a
(data, freq, time) mesh from one process.  Here every rank of the mesh calls
the same function with the same arguments (SPMD), each argument either a
tensor that every rank holds whole or a ``DTensor`` split as the JAX
``in_specs`` split it.  Each rank takes its own block by its mesh
coordinate, runs the port's single-device body on it, and finishes with the
collective the JAX code names (``parallel.collectives``):

* the (E, C, N) epochs split over ``data`` on the epoch axis, the (F, N)
  bank over ``freq`` on its rows;
* epoch means finish with an all-reduce over ``data`` (``pmean``/``psum``);
  the frequency axis needs none, except where energy moves between rows
  (synchrosqueezing, reassignment) or a floor spans the whole plane;
* results are ``DTensor``s placed as the JAX ``out_specs`` place them:
  ``full_tensor`` (or ``DTensor.full_tensor()``) is the JAX global array.

Every split axis must divide by its mesh axis (``ValueError`` otherwise, as
``shard_map`` refuses it).  On the card the ``sharded_fused_*`` functions
launch the fused kernels on each rank's block (K1/K2 for the epoch
reductions, K6 for the pair sums); on the CPU they run the kernels' plain
versions, as every other function here does everywhere.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops.cwt import (_epoch_mean, cwt_from_bank, mean_power_from_bank,
                       power_from_bank, unit_phase)
from . import collectives
from .mesh import DATA_AXIS, FREQ_AXIS, axis_index, axis_size, placements

_BANK = (FREQ_AXIS, None)


# -- blocks, collectives over mesh axes, DTensor results ---------------------

def _dtensor_cls():
    from torch.distributed.tensor import DTensor
    return DTensor


def _on_mesh(x, mesh) -> torch.Tensor:
    """``x`` (a tensor or array) as a tensor on the mesh's device type."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    if x.device.type != mesh.device_type:
        x = x.to(resolve_device(mesh.device_type))
    return x


def local_block(x, mesh, spec) -> torch.Tensor:
    """This rank's block of ``x`` under the JAX-style partition ``spec`` (the
    mesh axis each leading tensor dimension is split over, or None).  A
    ``DTensor`` placed otherwise is redistributed first."""
    if isinstance(x, _dtensor_cls()):
        want = placements(mesh, spec)
        if list(x.placements) != want:
            x = x.redistribute(mesh, want)
        return x.to_local()
    t = _on_mesh(x, mesh)
    for dim, name in enumerate(spec):
        if name is None:
            continue
        n = axis_size(mesh, name)
        if t.shape[dim] % n:
            raise ValueError(
                f"dimension {dim} (size {t.shape[dim]}) must divide the "
                f"{name!r} mesh axis ({n})")
        step = t.shape[dim] // n
        t = t.narrow(dim, axis_index(mesh, name) * step, step)
    return t


def _whole(x, mesh) -> torch.Tensor:
    """``x`` whole on every rank (a DTensor gathered)."""
    if isinstance(x, _dtensor_cls()):
        return full_tensor(x)
    return _on_mesh(x, mesh)


def _sig(x, mesh, spec) -> torch.Tensor:
    t = local_block(x, mesh, spec)
    return t if t.is_complex() else t.to(torch.float32)


def _bank(mesh, bank_r, bank_i=None, spec=_BANK) -> torch.Tensor:
    """This rank's rows of the bank: ``bank_r`` (float32, or complex64
    already), or the complex bank of the float pair ``(bank_r, bank_i)``."""
    b = local_block(bank_r, mesh, spec)
    if bank_i is not None:
        return torch.complex(b.to(torch.float32),
                             local_block(bank_i, mesh, spec).to(torch.float32))
    return b if b.is_complex() else b.to(torch.float32)


def _has(mesh, axis) -> bool:
    return axis in (mesh.mesh_dim_names or ())


def _psum(t, mesh, axis):
    return collectives.psum(t, mesh.get_group(axis)) if _has(mesh, axis) \
        else t


def _pmean(t, mesh, axis):
    return collectives.pmean(t, mesh.get_group(axis)) if _has(mesh, axis) \
        else t


def _freq_group(mesh):
    return mesh.get_group(FREQ_AXIS) if _has(mesh, FREQ_AXIS) else None


def _gather(t, mesh, axis, dim=0):
    return collectives.all_gather(t, mesh.get_group(axis), dim) \
        if _has(mesh, axis) else t


def _out(local: torch.Tensor, mesh, spec):
    """``local`` as the DTensor of the partition ``spec`` (no
    communication)."""
    return _dtensor_cls().from_local(local.contiguous(), mesh,
                                     placements(mesh, spec), run_check=False)


def full_tensor(x) -> torch.Tensor:
    """The global value of a DTensor (a plain tensor passes through),
    gathered through ``parallel.collectives`` and so under any backend,
    gloo on CUDA tensors included."""
    if not isinstance(x, _dtensor_cls()):
        return x
    t, mesh = x.to_local(), x.device_mesh
    for dim in reversed(range(mesh.ndim)):
        p = x.placements[dim]
        if p.is_shard():
            t = collectives.all_gather(t, mesh.get_group(dim), p.dim)
        elif p.is_partial():
            t = collectives.psum(t, mesh.get_group(dim))
    return t


def _tf_spec(ndim: int):
    """(E, ..., N) signals -> (..., F, N) planes split over ``freq``."""
    return (None,) * (ndim - 2) + (FREQ_AXIS, None)


def _each_spec(ndim: int):
    """(E, ..., N) signals -> (E, ..., F, N) planes over (data, freq)."""
    return (DATA_AXIS,) + (None,) * (ndim - 2) + (FREQ_AXIS, None)


def _ndim(x) -> int:
    return x.ndim if hasattr(x, "ndim") else np.ndim(x)


def _n_epochs(x) -> int:
    return int(x.shape[0])


# -- the epoch reductions -----------------------------------------------------

def sharded_mean_power(signals_r, bank_r, bank_i=None, *, mesh,
                       interpolate: bool = False):
    """Epoch-mean power TFR over the mesh: (E, ..., N) -> (..., F, N).

    Epochs split over ``data``, bank rows over ``freq``; each rank takes the
    epoch mean of its block (``ops.cwt.mean_power_from_bank``), one
    all-reduce over ``data`` completes the global mean.  E must divide the
    ``data`` axis (``pad_to_multiple`` on the host otherwise)."""
    sig = _sig(signals_r, mesh, (DATA_AXIS,))
    local = mean_power_from_bank(sig, _bank(mesh, bank_r, bank_i),
                                 interpolate)
    return _out(_pmean(local, mesh, DATA_AXIS), mesh,
                _tf_spec(_ndim(signals_r)))


def sharded_itc(signals_r, bank_r, bank_i=None, *, mesh,
                interpolate: bool = False, eps: float = 0.0):
    """Inter-trial coherence over the mesh: (E, ..., N) -> (..., F, N).
    The unit-phase mean is linear in epochs: each rank means its own, one
    all-reduce over ``data`` completes it, and |.| is taken last."""
    sig = _sig(signals_r, mesh, (DATA_AXIS,))
    local = _epoch_mean(sig, _bank(mesh, bank_r, bank_i), interpolate,
                        lambda c: unit_phase(c, eps))
    return _out(torch.abs(_pmean(local, mesh, DATA_AXIS)), mesh,
                _tf_spec(_ndim(signals_r)))


def sharded_cwt_ri(signals_r, bank_r, bank_i=None, *, mesh,
                   interpolate: bool = False):
    """Raw CWT coefficients over the mesh: (E, ..., N) -> (E, ..., F, N) as
    a (real, imag) pair, split over (data, freq), no collective.  The name
    and the pair are kept because callers name them."""
    sig = _sig(signals_r, mesh, (DATA_AXIS,))
    c = cwt_from_bank(sig, _bank(mesh, bank_r, bank_i), interpolate)
    spec = _each_spec(_ndim(signals_r))
    return _out(c.real, mesh, spec), _out(c.imag, mesh, spec)


def sharded_power(signals_r, bank_r, bank_i=None, *, mesh,
                  interpolate: bool = False):
    """Per-epoch power (no epoch mean): (E, ..., N) -> (E, ..., F, N),
    split over (data, freq), no collective."""
    sig = _sig(signals_r, mesh, (DATA_AXIS,))
    p = power_from_bank(sig, _bank(mesh, bank_r, bank_i), interpolate)
    return _out(p, mesh, _each_spec(_ndim(signals_r)))


def sharded_fused_mean_power(signals_r, bank_r, bank_i=None, *, mesh,
                             interpolate: bool = True,
                             precision: str = "fast3"):
    """``sharded_mean_power`` with the fused kernel (K1, real or complex
    bank) as each rank's compute: (E, C, N) -> (C, F, N).  On the card each
    block runs ``ops.fused.fused_mean_power_from_bank`` (it launches or
    raises: N a power of two in [256, 16384]); on the CPU its plain
    version."""
    from ..ops.fused import fused_mean_power_from_bank
    sig = _sig(signals_r, mesh, (DATA_AXIS,))
    local = fused_mean_power_from_bank(sig, _bank(mesh, bank_r, bank_i),
                                       interpolate, precision)
    return _out(_pmean(local, mesh, DATA_AXIS), mesh,
                _tf_spec(_ndim(signals_r)))


def sharded_fused_itc(signals_r, bank_r, bank_i=None, *, mesh,
                      interpolate: bool = True, precision: str = "fast3"):
    """Inter-trial coherence over the mesh with the fused kernel (K2) per
    rank: each block's unit-phase SUMS (``ops.fused._itc_sums``), divided by
    its epoch count, all-reduced over ``data``; |.| last."""
    from ..ops.fused import _itc_sums
    sig = _sig(signals_r, mesh, (DATA_AXIS,))
    e = sig.shape[0]
    sr, si = _itc_sums(sig, _bank(mesh, bank_r, bank_i), interpolate,
                       precision)
    sr = _pmean(sr / e, mesh, DATA_AXIS)
    si = _pmean(si / e, mesh, DATA_AXIS)
    return _out(torch.sqrt(sr * sr + si * si), mesh,
                _tf_spec(_ndim(signals_r)))


def sharded_fused_power_itc(signals_r, bank_r, bank_i=None, *, mesh,
                            interpolate: bool = True,
                            precision: str = "fast3"):
    """Epoch-mean power AND inter-trial coherence over the mesh off one
    fused pass a rank (K2 "power_itc"): the three epoch sums
    (``ops.fused._power_itc_sums``) over the local count, all-reduced over
    ``data``.  E must divide the ``data`` axis."""
    from ..ops.fused import _power_itc_sums
    e_all, d = _n_epochs(signals_r), axis_size(mesh, DATA_AXIS)
    if e_all % d:
        raise ValueError(f"epochs ({e_all}) must divide the data axis ({d})")
    sig = _sig(signals_r, mesh, (DATA_AXIS,))
    e = sig.shape[0]
    ps, sr, si = _power_itc_sums(sig, _bank(mesh, bank_r, bank_i),
                                 interpolate, precision)
    ps, sr, si = (_pmean(t / e, mesh, DATA_AXIS) for t in (ps, sr, si))
    spec = _tf_spec(_ndim(signals_r))
    return _out(ps, mesh, spec), _out(torch.sqrt(sr * sr + si * si), mesh,
                                      spec)


def sharded_mean_power_grad(signals_r, bank_r, g, *, mesh,
                            interpolate: bool = False):
    """One distributed training step on the epoch-mean power: the power and
    the analytic adjoint (``ops.fused.mean_power_bwd``) against a cotangent
    ``g`` (C, F, N) split over ``freq`` like the power.  The global mean is
    the mean of the ranks' means, so each rank's adjoint takes g / n_data;
    the signal gradient sums every row (all-reduce over ``freq``), the bank
    gradient every epoch (over ``data``).  Returns (power, dsignals,
    dbank), placed as (C, F, N) over ``freq``, (E, ...) over ``data`` and
    (F, N) over ``freq``."""
    from ..ops.fused import mean_power_bwd
    nd = _ndim(signals_r)
    p_spec = _tf_spec(nd)
    sig = _sig(signals_r, mesh, (DATA_AXIS,))
    bank = _bank(mesh, bank_r)
    gg = local_block(g, mesh, p_spec).to(torch.float32)
    p = _pmean(mean_power_from_bank(sig, bank, interpolate), mesh,
               DATA_AXIS)
    ds, db = mean_power_bwd(sig, bank, interpolate,
                            gg / axis_size(mesh, DATA_AXIS))
    return (_out(p, mesh, p_spec),
            _out(_psum(ds, mesh, FREQ_AXIS), mesh, (DATA_AXIS,)),
            _out(_psum(db, mesh, DATA_AXIS), mesh, _BANK))


def sharded_superlet_mean_power(signals_r, banks, weights, *, mesh,
                                interpolate: bool = False,
                                eps: float = 1e-30):
    """Epoch-mean superlet power over the mesh: (E, ..., N) -> (..., F, N).
    The (O, F, N) member banks and (O, F) weights split their F axis over
    ``freq`` (the geometric fusion is per cell); one all-reduce over
    ``data``."""
    from ..ops.superlets import superlet_power_from_banks
    sig = _sig(signals_r, mesh, (DATA_AXIS,))
    bks = local_block(banks, mesh, (None, FREQ_AXIS)).to(torch.float32)
    w = local_block(weights, mesh, (None, FREQ_AXIS)).to(torch.float32)
    total = None
    for s in sig:
        term = superlet_power_from_banks(s, bks, w, interpolate, eps)
        total = term if total is None else total.add_(term)
    return _out(_pmean(total / sig.shape[0], mesh, DATA_AXIS), mesh,
                _tf_spec(_ndim(signals_r)))


def sharded_multitaper_mean_power(signals_r, banks, *, mesh,
                                  interpolate: bool = False):
    """Epoch-mean multitaper Morse power over the mesh: (E, ..., N) ->
    (..., F, N).  The (F, K, n) taper banks split F over ``freq``, so every
    frequency's K tapers sit on one rank and the taper mean is local; one
    all-reduce over ``data``.  Each block runs ``ops.fused.mean_power_auto``
    (K1 on the card where it takes the (F*K, N) bank), as the single-device
    ``multitaper_mean_power`` does."""
    from ..ops.fused import mean_power_auto
    sig = _sig(signals_r, mesh, (DATA_AXIS,))
    bks = local_block(banks, mesh, (FREQ_AXIS,)).to(torch.float32)
    f_loc, k, n = bks.shape
    p = mean_power_auto(sig, bks.reshape(f_loc * k, n),
                        interpolate=interpolate)
    p = _pmean(p, mesh, DATA_AXIS)
    p = p.reshape(*p.shape[:-2], f_loc, k, p.shape[-1]).mean(-2)
    return _out(p, mesh, _tf_spec(_ndim(signals_r)))


# -- synchrosqueezing and reassignment ----------------------------------------

def sharded_ssq_mean_power(signals_r, bank_r, f_grid, *, mesh, sfreq: float,
                           interpolate: bool = True,
                           rel_threshold: float = 1e-6, uniform_grid=None):
    """Epoch-mean synchrosqueezed power over the mesh: (E, ..., N) ->
    (..., F, N), replicated.  Reassignment moves energy between rows, so
    each ``freq`` rank scatters its SOURCE rows into a full-height partial
    plane (``ops.sst._reassigned_power`` with ``row_offset`` /
    ``n_rows_out``), gated against the whole plane's peak (a max over
    ``freq``); an all-reduce over ``freq`` completes the rows, one over
    ``data`` the epoch mean.  F must divide ``freq``, E ``data``."""
    from ..ops.sst import _reassigned_power
    e = _n_epochs(signals_r)
    f_np = np.asarray(full_tensor(f_grid).cpu() if torch.is_tensor(f_grid)
                      else f_grid, np.float32)
    sig = _sig(signals_r, mesh, (DATA_AXIS,))
    bank = _bank(mesh, bank_r)
    offset = axis_index(mesh, FREQ_AXIS) * bank.shape[0]
    total = None
    for s in sig:
        term = _reassigned_power(
            s, bank, f_np, float(sfreq), interpolate, rel_threshold,
            uniform_grid, row_offset=offset, n_rows_out=f_np.shape[0],
            freq_group=_freq_group(mesh))
        total = term if total is None else total.add_(term)
    total = _psum(total, mesh, FREQ_AXIS)
    return _out(_psum(total, mesh, DATA_AXIS) / e, mesh,
                (None,) * _ndim(signals_r))


def sharded_reassigned_mean_power(signals_r, bank_r, f_grid, *, mesh,
                                  sfreq: float, interpolate: bool = True,
                                  rel_threshold: float = 1e-6,
                                  t_decim: int = 16):
    """Epoch-mean 2-D reassigned scalogram over the mesh: (E, ..., N) ->
    (..., F, ceil(N / t_decim)), replicated.  As
    ``sharded_ssq_mean_power``: SOURCE rows over ``freq``, each signal gated
    against its whole plane's peak, cells landing by value on the whole
    grid; all-reduces over ``freq`` and ``data``."""
    from ..ops.reassign import _reassign_one
    e = _n_epochs(signals_r)
    sig = _sig(signals_r, mesh, (DATA_AXIS,))
    bank = _bank(mesh, bank_r)
    fg = _whole(f_grid, mesh).to(sig.device, torch.float32)
    offset = axis_index(mesh, FREQ_AXIS) * bank.shape[0]
    f_own = fg[offset:offset + bank.shape[0]]
    flat = sig.reshape(-1, sig.shape[-1])
    planes = torch.stack([
        _reassign_one(s, bank, fg, float(sfreq), bool(interpolate),
                      float(rel_threshold), int(t_decim), f_own=f_own,
                      freq_group=_freq_group(mesh)) for s in flat])
    planes = planes.reshape(*sig.shape[:-1], *planes.shape[1:])
    total = _psum(planes.sum(0), mesh, FREQ_AXIS)
    return _out(_psum(total, mesh, DATA_AXIS) / e, mesh,
                (None,) * _ndim(signals_r))


# -- pair connectivity ----------------------------------------------------------

def _pair_blocks(mesh, sigs_a, sigs_b):
    return (_sig(sigs_a, mesh, (DATA_AXIS,)), _sig(sigs_b, mesh, (DATA_AXIS,)))


def sharded_cross_power(sigs_a, sigs_b, bank_r, bank_i=None, *, mesh,
                        interpolate: bool = False):
    """Cross-wavelet product ``Wa * conj(Wb)`` over the mesh as a (real,
    imag) pair: (E, ..., N) x2 -> (E, ..., F, N) x2, no collective."""
    from ..ops.extensions import cross_power_from_bank
    sa, sb = _pair_blocks(mesh, sigs_a, sigs_b)
    xr, xi = cross_power_from_bank(sa, sb, _bank(mesh, bank_r, bank_i),
                                   interpolate)
    spec = _each_spec(_ndim(sigs_a))
    return _out(xr, mesh, spec), _out(xi, mesh, spec)


def _coherence_sums(mesh, sigs_a, sigs_b, bank_r, bank_i, interpolate):
    from ..ops.extensions import coherence_sums
    sa, sb = _pair_blocks(mesh, sigs_a, sigs_b)
    sums = coherence_sums(sa, sb, _bank(mesh, bank_r, bank_i), interpolate)
    return [_psum(s, mesh, DATA_AXIS) for s in sums]


def sharded_coherence(sigs_a, sigs_b, bank_r, bank_i=None, *, mesh,
                      interpolate: bool = False, eps: float = 1e-12):
    """Epoch-wise wavelet coherence over the mesh: (E, ..., N) x2 ->
    (..., F, N).  Each rank's four epoch sums, one all-reduce each over
    ``data``, the ratio on the global sums; the relative denominator floor
    takes the whole plane's maximum (a max over ``freq``)."""
    from ..ops.extensions import coherence_from_sums
    xr, xi, pa, pb = _coherence_sums(mesh, sigs_a, sigs_b, bank_r, bank_i,
                                     interpolate)
    coh = coherence_from_sums(xr, xi, pa, pb, _n_epochs(sigs_a), eps,
                              freq_group=_freq_group(mesh))
    return _out(coh, mesh, _tf_spec(_ndim(sigs_a)))


def sharded_imcoh(sigs_a, sigs_b, bank_r, bank_i=None, *, mesh,
                  interpolate: bool = False, eps: float = 1e-12):
    """Imaginary coherency over the mesh: (E, ..., N) x2 -> (..., F, N);
    ``sharded_coherence``'s sums and floor, another finisher."""
    from ..ops.extensions import imcoh_from_sums
    xr, xi, pa, pb = _coherence_sums(mesh, sigs_a, sigs_b, bank_r, bank_i,
                                     interpolate)
    out = imcoh_from_sums(xr, xi, pa, pb, eps, freq_group=_freq_group(mesh))
    return _out(out, mesh, _tf_spec(_ndim(sigs_a)))


def sharded_fused_coherence(sigs_a, sigs_b, bank_r, *, mesh,
                            interpolate: bool = True,
                            precision: str = "fast3", eps: float = 1e-12):
    """``sharded_coherence`` with the cross-pair kernel's "coherence"
    epilogue (K6) per rank (real banks): each block's sums
    (``ops.fused.fused_coherence_sums``) over its epoch count, all-reduced
    over ``data``; the ratio is invariant to that common scale."""
    from ..ops.extensions import coherence_from_sums
    from ..ops.fused import fused_coherence_sums
    sa, sb = _pair_blocks(mesh, sigs_a, sigs_b)
    e = sa.shape[0]
    sums = fused_coherence_sums(sa, sb, _bank(mesh, bank_r), interpolate,
                                precision)
    xr, xi, pa, pb = (_pmean(s / e, mesh, DATA_AXIS) for s in sums)
    coh = coherence_from_sums(xr, xi, pa, pb, 1, eps,
                              freq_group=_freq_group(mesh))
    return _out(coh, mesh, _tf_spec(_ndim(sigs_a)))


def sharded_phase_lag(sigs_a, sigs_b, bank_r, *, mesh, method: str = "wpli",
                      interpolate: bool = False, eps: float = 0.0):
    """PLI / wPLI / debiased wPLI^2 over the mesh: (E, ..., N) x2 ->
    (..., F, N).  The four phase-lag sums are all-reduced RAW over ``data``
    (dwPLI mixes squares of sums with sums of squares, so no common scale
    is admissible) and finished with the true epoch count."""
    from ..ops.connectivity import phase_lag_from_sums, phase_lag_sums
    sa, sb = _pair_blocks(mesh, sigs_a, sigs_b)
    sums = [_psum(s, mesh, DATA_AXIS)
            for s in phase_lag_sums(sa, sb, _bank(mesh, bank_r),
                                    interpolate)]
    out = phase_lag_from_sums(sums, _n_epochs(sigs_a), method, eps)
    return _out(out, mesh, _tf_spec(_ndim(sigs_a)))


def sharded_fused_phase_lag(sigs_a, sigs_b, bank_r, *, mesh,
                            method: str = "wpli", interpolate: bool = True,
                            precision: str = "fast3", eps: float = 0.0):
    """``sharded_phase_lag`` with the cross-pair kernel's "phaselag"
    epilogue (K6) per rank (real banks; raw sums all-reduced)."""
    from ..ops.connectivity import phase_lag_from_sums
    from ..ops.fused import fused_phase_lag_sums
    sa, sb = _pair_blocks(mesh, sigs_a, sigs_b)
    sums = [_psum(s, mesh, DATA_AXIS)
            for s in fused_phase_lag_sums(sa, sb, _bank(mesh, bank_r),
                                          interpolate, precision)]
    out = phase_lag_from_sums(sums, _n_epochs(sigs_a), method, eps)
    return _out(out, mesh, _tf_spec(_ndim(sigs_a)))


def _plv_global_sums(mesh, sigs_a, sigs_b, bank_r, interpolate, eps):
    from ..ops.connectivity import plv_sums
    sa, sb = _pair_blocks(mesh, sigs_a, sigs_b)
    sr, si = plv_sums(sa, sb, _bank(mesh, bank_r), interpolate, eps)
    return _psum(sr, mesh, DATA_AXIS), _psum(si, mesh, DATA_AXIS)


def sharded_plv(sigs_a, sigs_b, bank_r, *, mesh, interpolate: bool = False,
                eps: float = 0.0):
    """Phase-locking value over the mesh: (E, ..., N) x2 -> (..., F, N);
    the unit cross-phase sums all-reduced over ``data``, |.| last."""
    sr, si = _plv_global_sums(mesh, sigs_a, sigs_b, bank_r, interpolate, eps)
    out = torch.sqrt(sr * sr + si * si) / _n_epochs(sigs_a)
    return _out(out, mesh, _tf_spec(_ndim(sigs_a)))


def sharded_ppc(sigs_a, sigs_b, bank_r, *, mesh, interpolate: bool = False,
                eps: float = 0.0):
    """Pairwise phase consistency over the mesh: ``sharded_plv``'s global
    sums, ``(|sum u|^2 - E) / (E (E - 1))``."""
    sr, si = _plv_global_sums(mesh, sigs_a, sigs_b, bank_r, interpolate, eps)
    e = _n_epochs(sigs_a)
    out = (sr * sr + si * si - e) / (e * (e - 1.0))
    return _out(out, mesh, _tf_spec(_ndim(sigs_a)))


def sharded_nm_plv(sigs_a, sigs_b, bank_a_r, bank_b_r, *, mesh, n: int = 1,
                   m: int = 1, interpolate: bool = False, eps: float = 0.0):
    """n:m cross-frequency phase locking over the mesh: the row-paired
    banks split together over ``freq`` (row k of both on one rank), the
    complex sums all-reduced over ``data``, |.| last."""
    from ..ops.connectivity import nm_plv_sums
    sa, sb = _pair_blocks(mesh, sigs_a, sigs_b)
    sr, si = nm_plv_sums(sa, sb, _bank(mesh, bank_a_r), _bank(mesh, bank_b_r),
                         n, m, interpolate, eps)
    sr, si = _psum(sr, mesh, DATA_AXIS), _psum(si, mesh, DATA_AXIS)
    out = torch.sqrt(sr * sr + si * si) / _n_epochs(sigs_a)
    return _out(out, mesh, _tf_spec(_ndim(sigs_a)))


def sharded_plv_matrix(sigs, bank_r, *, mesh, interpolate: bool = False,
                       eps: float = 0.0, time_range=None):
    """All-pairs phase-locking matrix over the mesh: (E, C, N) -> (F, C, C),
    split over ``freq``; each bank row's pairwise sums all-reduced over
    ``data`` before the magnitude."""
    from ..ops.connectivity import pair_matrix_scan
    e = _n_epochs(sigs)

    def per_row(sr, si):
        sr, si = _psum(sr, mesh, DATA_AXIS), _psum(si, mesh, DATA_AXIS)
        return torch.mean(torch.sqrt(sr * sr + si * si), dim=-1) / e

    out = pair_matrix_scan(_sig(sigs, mesh, (DATA_AXIS,)), _bank(mesh, bank_r),
                           per_row, interpolate, unit=True, eps=eps,
                           time_range=time_range)
    return _out(out, mesh, (FREQ_AXIS, None, None))


def sharded_coherence_matrix(sigs, bank_r, bank_i=None, *, mesh,
                             interpolate: bool = False, eps: float = 1e-12,
                             time_range=None):
    """All-pairs epoch-wise coherence over the mesh: (E, C, N) -> (F, C, C);
    the cross and power sums (the diagonal) complete in one all-reduce a
    row, the ratio on global values."""
    from ..ops.connectivity import pair_matrix_scan
    e = _n_epochs(sigs)

    def per_row(sr, si):
        sr, si = _psum(sr, mesh, DATA_AXIS), _psum(si, mesh, DATA_AXIS)
        num = (sr * sr + si * si) / (e * e)
        p = torch.diagonal(sr, dim1=0, dim2=1).T / e
        den = p[:, None, :] * p[None, :, :]
        if eps:
            den = torch.maximum(den, eps * den.max())
        return torch.mean(num / den, dim=-1)

    out = pair_matrix_scan(_sig(sigs, mesh, (DATA_AXIS,)),
                           _bank(mesh, bank_r, bank_i), per_row, interpolate,
                           time_range=time_range)
    return _out(out, mesh, (FREQ_AXIS, None, None))


def sharded_partial_coherence(sigs, bank_r, *, mesh,
                              interpolate: bool = False, lam: float = 1e-5,
                              time_range=None):
    """All-pairs partial coherence over the mesh: (E, C, N) -> (F, C, C);
    the (C, C) precision-matrix solve runs on the global sums."""
    from ..ops.connectivity import pair_matrix_scan, partial_coherence_per_row
    e = _n_epochs(sigs)

    def per_row(sr, si):
        return partial_coherence_per_row(_psum(sr, mesh, DATA_AXIS),
                                         _psum(si, mesh, DATA_AXIS), e, lam)

    out = pair_matrix_scan(_sig(sigs, mesh, (DATA_AXIS,)), _bank(mesh, bank_r),
                           per_row, interpolate, time_range=time_range)
    return _out(out, mesh, (FREQ_AXIS, None, None))


def sharded_psi_matrix(sigs, bank_r, *, mesh, interpolate: bool = False,
                       eps: float = 1e-12, time_range=None,
                       normalize: bool = True):
    """Phase-slope index over the mesh: (E, C, N) -> (C, C), replicated.
    Epochs split over ``data``; the bank is REPLICATED (adjacent rows form
    the slope).  ``psi_reps_scan``'s ``complete`` hook all-reduces each
    row's total sums, so every rank holds the full-sample replicate and its
    own epochs' leave-one-out replicates; two more all-reduces finish the
    jackknife moments."""
    from ..ops.connectivity import psi_reps_scan
    e = _n_epochs(sigs)
    if e < 2:
        raise ValueError("psi needs at least 2 epochs (>= 3 for a "
                         "meaningful jackknife)")
    if bank_r.shape[0] < 2:
        raise ValueError("psi needs at least 2 bank rows (adjacent "
                         "frequency pairs form the slope)")
    n0, n1 = time_range if time_range is not None else (0, sigs.shape[-1])
    ndev = axis_size(mesh, DATA_AXIS)
    reps = psi_reps_scan(_sig(sigs, mesh, (DATA_AXIS,)),
                         _bank(mesh, bank_r, spec=(None, None)), n0, n1, e,
                         eps, interpolate,
                         complete=lambda s: _psum(s, mesh, DATA_AXIS))
    psi = _psum(reps[-1], mesh, DATA_AXIS) / ndev
    if normalize:
        jk = reps[:-1]
        jk_mean = _psum(jk.sum(0), mesh, DATA_AXIS) / e
        var = (e - 1.0) / e * _psum(((jk - jk_mean) ** 2).sum(0), mesh,
                                    DATA_AXIS)
        std = torch.sqrt(torch.clamp(var, min=0.0))
        psi = torch.where(std > 0, psi / torch.where(std > 0, std,
                                                     torch.ones_like(std)),
                          torch.zeros_like(psi))
    return _out(psi, mesh, ())


def sharded_pac(sigs_r, bank_phase_r, bank_amp_r, *, mesh,
                interpolate: bool = False, method: str = "mvl",
                n_bins: int = 18):
    """Epoch-mean phase-amplitude comodulogram over the mesh: (E, ..., N) ->
    (..., Fp, Fa), split over ``freq`` on the phase rows (the amp bank is
    replicated); one all-reduce over ``data``."""
    from ..ops.connectivity import pac_mean_from_banks
    sig = _sig(sigs_r, mesh, (DATA_AXIS,))
    total = pac_mean_from_banks(sig, _bank(mesh, bank_phase_r),
                                _bank(mesh, bank_amp_r, spec=(None, None)),
                                interpolate, method, n_bins)
    return _out(_pmean(total, mesh, DATA_AXIS), mesh,
                _tf_spec(_ndim(sigs_r)))


def sharded_env_corr(sigs, bank_r, *, mesh, orthogonalize: bool = True,
                     interpolate: bool = False, log: bool = True,
                     eps: float = 1e-12, time_range=None):
    """All-pairs power-envelope correlation over the mesh: (E, C, N) ->
    (F, C, C); the epoch mean of per-epoch correlations is linear, one
    all-reduce over ``data``."""
    from ..ops.envelope import env_corr_matrix_from_bank
    r = env_corr_matrix_from_bank(_sig(sigs, mesh, (DATA_AXIS,)),
                                  _bank(mesh, bank_r), orthogonalize,
                                  interpolate, log, eps, time_range)
    return _out(_pmean(r, mesh, DATA_AXIS), mesh, (FREQ_AXIS,))


def sharded_wavelet_granger(sigs, bank_r, *, mesh, time_decim: int = 16,
                            n_iter: int = 60, interpolate: bool = True):
    """Time-resolved pairwise Granger causality over the mesh: (E, C, N) and
    the energy-normalized uniform-grid bank (``ops.granger._granger_inputs``)
    -> (T', K, C, C), replicated.  Two stages: each rank's epoch cross
    spectra, all-reduced over ``data`` (the mean); then the Wilson
    factorizations of a block of T' per ``data`` rank, gathered.  T' =
    ceil(N / time_decim) must divide the ``data`` axis."""
    from ..ops.granger import _decimated_cwt, _pair_list, _pairwise_gc
    from ..ops.scattering import fp32_matmul
    e, c, _ = sigs.shape
    bank = _bank(mesh, bank_r, spec=(None, None))
    w = _decimated_cwt(_sig(sigs, mesh, (DATA_AXIS,)), bank, int(time_decim),
                       bool(interpolate))
    with fp32_matmul("exact"):
        cross = torch.einsum("eakt,ebkt->tkab", w, w.conj())
    cross = _psum(cross, mesh, DATA_AXIS) / e
    pairs = torch.from_numpy(_pair_list(c)).to(cross.device)
    gc = _pairwise_gc(local_block(cross, mesh, (DATA_AXIS,)), pairs,
                      int(n_iter))
    gc = _gather(gc, mesh, DATA_AXIS)
    out = torch.zeros(*cross.shape, dtype=torch.float32, device=cross.device)
    i, j = pairs[:, 0], pairs[:, 1]
    out[..., i, j] = gc[..., 0].movedim(-2, -1)
    out[..., j, i] = gc[..., 1].movedim(-2, -1)
    return _out(out, mesh, ())


# -- transforms ----------------------------------------------------------------

def sharded_modwt(x, *, mesh, wavelet: str = "db4", level: int | None = None,
                  denoise: bool = False, mode: str = "soft"):
    """MODWT (or MODWT shrinkage with ``denoise=True``) over the mesh: the
    leading batch axis splits over ``data`` and each rank transforms its
    signals, no collective.  (..., N) -> (..., J+1, N), or (..., N) with
    ``denoise``."""
    from ..ops.dwt import max_level, modwt, modwt_denoise
    lvl = max_level(x.shape[-1], wavelet) if level is None else int(level)
    blk = _sig(x, mesh, (DATA_AXIS,))
    if denoise:
        return _out(modwt_denoise(blk, wavelet, lvl, mode), mesh,
                    (DATA_AXIS,))
    return _out(modwt(blk, wavelet, lvl), mesh, (DATA_AXIS,))


def sharded_stockwell(signals_r, freqs, *, mesh, sfreq: float):
    """S-transform over the mesh: (E, ..., N) at the analysis frequencies
    (Hz, validated to FFT bins in (0, Nyquist]) -> (real, imag) (E, ..., F,
    N), split over (data, freq), no collective."""
    from ..ops.stockwell import _bins, _stockwell_bins
    bins = torch.from_numpy(_bins(freqs, signals_r.shape[-1], sfreq))
    sig = _sig(signals_r, mesh, (DATA_AXIS,))
    st = _stockwell_bins(sig, local_block(bins, mesh, (FREQ_AXIS,)),
                         float(sfreq))
    spec = _each_spec(_ndim(signals_r))
    return _out(st.real, mesh, spec), _out(st.imag, mesh, spec)


# -- decoders and the state model ---------------------------------------------

def sharded_tf_decode(xa, xb, *, mesh, n_folds: int = 5, lam: float = 1e-3):
    """Cross-validated TF decoding AUC over the mesh: (Ea, C, F, N) vs
    (Eb, C, F, N) -> (F, N), split over ``freq`` with no collective (every
    pixel's classifier is its own; trials replicate)."""
    from ..ops.decoding import _tf_decode_jit
    if _ndim(xa) != 4 or _ndim(xb) != 4 or \
            tuple(xa.shape[1:]) != tuple(xb.shape[1:]):
        raise ValueError("expected (Ea, C, F, N) and (Eb, C, F, N) with "
                         "matching planes, got %s and %s"
                         % (tuple(xa.shape), tuple(xb.shape)))
    if min(xa.shape[0], xb.shape[0]) < n_folds:
        raise ValueError("need at least n_folds trials per class")
    spec = (None, None, FREQ_AXIS, None)
    auc = _tf_decode_jit(_sig(xa, mesh, spec), _sig(xb, mesh, spec),
                         n_folds=int(n_folds), lam=float(lam))
    return _out(auc, mesh, (FREQ_AXIS, None))


def _sharded_hmm_from_perm(x, perm, *, mesh, n_states: int, n_iter: int,
                           stickiness: float):
    """``sharded_hmm_fit`` from a given permutation of the B*T frames (the
    EM seeding draw; the CPU tests feed the JAX package's)."""
    from ..ops.hmm import (_VAR_FLOOR, HMMResult, _e_step, _init_params,
                           _viterbi)
    from ..ops.scattering import fp32_matmul
    xw = _whole(x, mesh).to(torch.float32)
    b, t, d = xw.shape
    k = int(n_states)
    pi, a, means, variances = _init_params(
        xw, _on_mesh(perm, mesh).to(torch.int64), k, float(stickiness))
    xl = local_block(xw, mesh, (DATA_AXIS,))
    flat = xl.reshape(-1, d)
    trace = []
    for _ in range(int(n_iter)):
        gamma, xi, ll = _e_step(xl, pi, a, means, variances)
        g = gamma.reshape(-1, k)
        nk = _psum(g.sum(0), mesh, DATA_AXIS) + 1e-8
        with fp32_matmul("exact"):
            m1 = _psum(g.T @ flat, mesh, DATA_AXIS)
            m2 = _psum(g.T @ (flat * flat), mesh, DATA_AXIS)
        means = m1 / nk[:, None]
        variances = torch.clamp(m2 / nk[:, None] - means * means,
                                min=_VAR_FLOOR)
        xi_tot = _psum(xi.sum(0), mesh, DATA_AXIS) + 1e-8
        a = xi_tot / xi_tot.sum(1, keepdim=True)
        pi = _psum(gamma[:, 0, :].sum(0), mesh, DATA_AXIS) + 1e-8
        pi = pi / pi.sum()
        trace.append(_psum(ll.sum(), mesh, DATA_AXIS))
    gamma, _, _ = _e_step(xl, pi, a, means, variances)
    states = _viterbi(xl, pi, a, means, variances)
    trace = torch.stack(trace) if trace else torch.zeros(0, device=xl.device)
    rep = ()
    return HMMResult(_out(pi, mesh, rep), _out(a, mesh, rep),
                     _out(means, mesh, rep), _out(variances, mesh, rep),
                     _out(gamma, mesh, (DATA_AXIS,)),
                     _out(states, mesh, (DATA_AXIS,)), _out(trace, mesh, rep))


def sharded_hmm_fit(x, *, mesh, n_states: int, n_iter: int = 50,
                    stickiness: float = 0.9, seed: int = 0):
    """Mesh-parallel ``ops.hmm.hmm_fit``: the (B, T, D) sequences split over
    ``data``, and every EM sufficient statistic (state weights, moment
    products, transition counts, initial mass, log-likelihood) is one
    all-reduce, so the fit is the single-device EM up to float32 summation
    order.  ``gamma`` / ``states`` come back split over sequences, the
    parameters replicated (an ``HMMResult`` of DTensors).  B must divide
    the ``data`` axis.  The seeding permutation comes from a
    ``torch.Generator`` seeded with ``seed``, as ``hmm_fit``'s."""
    if _ndim(x) != 3:
        raise ValueError("expected (B, T, D) sequences")
    b, t, _ = x.shape
    nd = axis_size(mesh, DATA_AXIS)
    if b % nd:
        raise ValueError(f"B={b} must be divisible by the data axis ({nd})")
    dev = resolve_device(mesh.device_type)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    perm = torch.randperm(b * t, generator=gen, device=dev)
    return _sharded_hmm_from_perm(x, perm, mesh=mesh, n_states=n_states,
                                  n_iter=n_iter, stickiness=stickiness)


def _ica_components(x, mesh, n_components, fun) -> int:
    """The component count of a sharded FastICA, after the JAX package's
    checks."""
    if _ndim(x) != 2:
        raise ValueError("expected (channels, samples)")
    c, n = x.shape
    nd = axis_size(mesh, DATA_AXIS)
    if n % nd:
        raise ValueError(f"N={n} must be divisible by the data axis ({nd})")
    k = c if n_components is None else int(n_components)
    if not (1 <= k <= c):
        raise ValueError("n_components must be in [1, channels]")
    if fun not in ("logcosh", "exp", "cube"):
        raise ValueError("fun must be 'logcosh', 'exp' or 'cube'")
    return k


def _sharded_fastica_from_w0(x, w0, *, mesh, n_components=None,
                             fun: str = "logcosh", n_iter: int = 200):
    """``sharded_fastica`` from a given (K, K) initial unmixing ``w0``
    (before its symmetric decorrelation; the CPU tests feed the JAX
    package's draw)."""
    from ..ops.ica import (ICAResult, _finalize_components, _ica_step,
                           _sym_decorrelate, _whiten_from_cov)
    from ..ops.scattering import fp32_matmul
    k = _ica_components(x, mesh, n_components, fun)
    n = x.shape[1]
    xl = _sig(x, mesh, (None, DATA_AXIS))
    mean = _psum(xl.sum(1), mesh, DATA_AXIS) / n
    xc = xl - mean[:, None]
    with fp32_matmul("exact"):
        cov = _psum(xc @ xc.T, mesh, DATA_AXIS) / n
    whiten, z, e_top, s_top = _whiten_from_cov(cov, xc, k)
    w = _sym_decorrelate(_on_mesh(w0, mesh).to(torch.float32))
    conv = []
    for _ in range(int(n_iter)):
        w, cv = _ica_step(w, z, fun, n,
                          reduce_m=lambda m: _psum(m, mesh, DATA_AXIS),
                          reduce_gp=lambda g: _psum(g, mesh, DATA_AXIS))
        conv.append(cv)
    conv = torch.stack(conv) if conv else torch.zeros(0, device=xl.device)
    un, mix, src = _finalize_components(w, whiten, e_top, s_top, xc)
    return ICAResult(_out(un, mesh, ()), _out(mix, mesh, ()),
                     _out(mean, mesh, ()), _out(src, mesh, (None, DATA_AXIS)),
                     _out(conv, mesh, ()))


def sharded_fastica(x, *, mesh, n_components: int | None = None,
                    fun: str = "logcosh", n_iter: int = 200, seed: int = 0):
    """Mesh-parallel ``ops.ica.fastica``: SAMPLES split over ``data`` (one
    long recording); the channel covariance, the nonlinearity's moment
    products and derivative means are each one all-reduce, the K x K
    eigendecompositions run replicated, through the helpers the
    single-device fit shares (``_whiten_from_cov``, ``_ica_step``,
    ``_finalize_components``).  Returns an ``ICAResult`` of DTensors with
    ``sources`` split over time; N must divide the ``data`` axis.  The
    initial unmixing is standard normal from a ``torch.Generator`` seeded
    with ``seed``, as ``fastica``'s."""
    k = _ica_components(x, mesh, n_components, fun)
    dev = resolve_device(mesh.device_type)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    w0 = torch.randn((k, k), generator=gen, device=dev, dtype=torch.float32)
    return _sharded_fastica_from_w0(x, w0, mesh=mesh, n_components=k,
                                    fun=fun, n_iter=n_iter)


def sharded_covariance(x, *, mesh):
    """Mesh-parallel ``ops.spatial.covariance``: epochs split over
    ``data``; each rank's per-epoch-centred (C, C) sum, one all-reduce,
    one normalizer.  E must divide the ``data`` axis.  Replicated."""
    from ..ops.scattering import fp32_matmul
    if _ndim(x) != 3:
        raise ValueError("expected (E, C, N)")
    e, _, n = x.shape
    nd = axis_size(mesh, DATA_AXIS)
    if e % nd:
        raise ValueError(f"E={e} must be divisible by the data axis ({nd})")
    xl = _sig(x, mesh, (DATA_AXIS,))
    xc = xl - xl.mean(2, keepdim=True)
    y = xc.transpose(0, 1).reshape(xl.shape[1], -1)
    with fp32_matmul("exact"):
        s = y @ y.T
    return _out(_psum(s, mesh, DATA_AXIS) / float(e * (n - 1)), mesh, ())


def sharded_csp(xa, xb, *, mesh, n_components: int = 4,
                shrink: float = 0.01):
    """Mesh-parallel ``ops.spatial.csp``: both class covariances pool over
    epoch shards (``sharded_covariance``); the small C x C generalized
    eigensolve runs on every rank on the replicated covariances, so the
    ``SpatialResult`` holds plain (replicated) tensors.  No bandpass here:
    filter before sharding."""
    from ..ops.spatial import _csp_from_covs
    if _ndim(xa) != 3 or _ndim(xb) != 3 or \
            tuple(xa.shape[1:]) != tuple(xb.shape[1:]):
        raise ValueError("xa/xb must be (E, C, N) with matching (C, N)")
    k = int(n_components)
    if not (1 <= k <= xa.shape[1]):
        raise ValueError("n_components must be in [1, C]")
    ca = sharded_covariance(xa, mesh=mesh).to_local()
    cb = sharded_covariance(xb, mesh=mesh).to_local()
    return _csp_from_covs(ca, cb, k, float(shrink))


# -- cluster statistics --------------------------------------------------------

def _sharded_cluster_null_from_draws(x, draws, *, mesh, n_perm: int,
                                     threshold: float, na=None, sizes=None,
                                     adjacency=None) -> torch.Tensor:
    """(P,) permutation null of max cluster masses over the mesh from the
    given (n_chunks, chunk, ...) ``draws`` (the CPU tests feed the JAX
    package's): the chunk axis, padded with copies of the first chunk to a
    multiple of the ``data`` axis, splits over ``data``; each rank runs its
    chunks through the single-device chunk kernels on the replicated stack,
    and the blocks are gathered.  For the same draws this equals the
    single-device null bit for bit."""
    from ..ops.cluster import (anova_chunk_max_mass, relabel_chunk_max_mass,
                               sign_chunk_max_mass)
    x = _whole(x, mesh).to(torch.float32)
    draws = _on_mesh(draws, mesh).to(torch.float32)
    e, plane = x.shape[0], tuple(x.shape[1:])
    xf = x.reshape(e, -1)
    if sizes is not None:
        xf = xf - xf.mean(0)
        sst = (xf * xf).sum(0)

        def chunk_fn(d):
            return anova_chunk_max_mass(d, xf, sst, tuple(sizes),
                                        threshold, plane, adjacency)
    elif na is None:
        s2 = (xf * xf).sum(0)

        def chunk_fn(d):
            return sign_chunk_max_mass(d, xf, s2, e, threshold, plane,
                                       adjacency)
    else:
        x2f = xf * xf
        s1t, s2t = xf.sum(0), x2f.sum(0)

        def chunk_fn(d):
            return relabel_chunk_max_mass(d, xf, x2f, s1t, s2t, na, e - na,
                                          threshold, plane, adjacency)
    n_chunks, nd = draws.shape[0], axis_size(mesh, DATA_AXIS)
    pad = -(-n_chunks // nd) * nd - n_chunks
    if pad:
        draws = torch.cat([draws, draws[:1].expand(pad, *draws.shape[1:])])
    mine = local_block(draws, mesh, (DATA_AXIS,))
    out = torch.stack([chunk_fn(d) for d in mine])
    return _gather(out, mesh, DATA_AXIS).reshape(-1)[:n_perm]


def sharded_cluster_null(x, seed: int, *, mesh, n_perm: int,
                         threshold: float, na=None, sizes=None,
                         chunk: int = 64, adjacency=None) -> torch.Tensor:
    """Permutation null of max cluster masses over the mesh: (P,), on every
    rank.  The draws are the single-device null's (``ops.cluster``'s
    ``sign_draws`` / ``relabel_draws`` / ``anova_draws`` for ``seed``), so
    the result equals ``_sign_flip_null`` / ``_relabel_null`` /
    ``_anova_null`` bit for bit.  ``na=None`` is the one-sample sign flip;
    ``na=k`` the independent-groups relabeling (first k trials group A);
    ``sizes`` the one-way-F relabeling over groups stacked in order.  With
    channel ``adjacency`` edges the stack is (E, C, F, N)."""
    from ..ops.cluster import anova_draws, relabel_draws, sign_draws
    x = _whole(x, mesh).to(torch.float32)
    e = x.shape[0]
    if sizes is not None:
        draws = anova_draws(seed, n_perm, tuple(sizes), chunk, x.device)
    elif na is None:
        draws = sign_draws(seed, n_perm, e, chunk, x.device)
    else:
        draws = relabel_draws(seed, n_perm, e, na, chunk, x.device)
    return _sharded_cluster_null_from_draws(
        x, draws, mesh=mesh, n_perm=n_perm, threshold=threshold, na=na,
        sizes=sizes, adjacency=adjacency)


def sharded_cluster_test_one_sample(x, *, mesh, n_perm: int = 999,
                                    threshold=None, alpha: float = 0.05,
                                    seed: int = 0, adjacency=None):
    """``ops.cluster.cluster_test_one_sample`` with the permutation null
    computed over the mesh (same seed, same result as one device)."""
    from ..ops.cluster import _resolve_threshold, cluster_test_one_sample
    x = _whole(x, mesh).to(torch.float32)
    thr = _resolve_threshold(threshold, alpha, x.shape[0] - 1)
    null = sharded_cluster_null(x, seed, mesh=mesh, n_perm=n_perm,
                                threshold=thr, adjacency=adjacency)
    return cluster_test_one_sample(x, threshold=thr, null_max=null,
                                   adjacency=adjacency)


def sharded_cluster_test_independent(xa, xb, *, mesh, n_perm: int = 999,
                                     threshold=None, alpha: float = 0.05,
                                     seed: int = 0, adjacency=None):
    """``ops.cluster.cluster_test_independent`` with the relabeling null
    computed over the mesh."""
    from ..ops.cluster import _resolve_threshold, cluster_test_independent
    xa = _whole(xa, mesh).to(torch.float32)
    xb = _whole(xb, mesh).to(torch.float32)
    na = xa.shape[0]
    thr = _resolve_threshold(threshold, alpha, na + xb.shape[0] - 2)
    null = sharded_cluster_null(torch.cat([xa, xb]), seed, mesh=mesh,
                                n_perm=n_perm, threshold=thr, na=na,
                                adjacency=adjacency)
    return cluster_test_independent(xa, xb, threshold=thr, null_max=null,
                                    adjacency=adjacency)


def sharded_cluster_test_f(groups, *, mesh, n_perm: int = 999,
                           threshold=None, alpha: float = 0.05,
                           seed: int = 0, adjacency=None):
    """``ops.cluster.cluster_test_f`` (one-way ANOVA clusters) with the
    relabeling null computed over the mesh."""
    from ..ops.cluster import cluster_test_f, f_threshold
    groups = [_whole(g, mesh).to(torch.float32) for g in groups]
    sizes = tuple(int(g.shape[0]) for g in groups)
    if threshold is None:
        threshold = f_threshold(alpha, len(sizes) - 1,
                                sum(sizes) - len(sizes))
    thr = float(threshold)
    null = sharded_cluster_null(torch.cat(groups), seed, mesh=mesh,
                                n_perm=n_perm, threshold=thr, sizes=sizes,
                                adjacency=adjacency)
    return cluster_test_f(groups, threshold=thr, null_max=null,
                          adjacency=adjacency)


__all__ = [name for name in dir() if name.startswith("sharded_")]
