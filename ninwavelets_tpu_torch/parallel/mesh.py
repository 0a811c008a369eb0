"""Device meshes for the sharded engine (port of
``ninwavelets_tpu.parallel.mesh``).

The JAX package scales the workload's three axes over a
``jax.sharding.Mesh`` in one process:

* ``data``: epochs x channels (data parallel);
* ``freq``: the analysis-frequency rows of the (F, N) bank;
* ``time``: the signal's time axis of a long recording (sequence parallel,
  ``parallel.chunked``).

Here a mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with those
dimension names over the ranks of the process group, one process a rank
(SPMD): every rank calls the same ``sharded_*`` function with the same
arguments and works on its own block.  ``init_multihost`` joins the group
(``torchrun`` or explicit arguments); ``run_on_mesh`` starts the ranks of one
host itself.  Collectives go through ``parallel.collectives``.
"""
from __future__ import annotations

import datetime
import math
import os
import socket
import time
import traceback
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

DATA_AXIS = "data"
FREQ_AXIS = "freq"
TIME_AXIS = "time"

#: Seconds a collective waits for a peer before it raises (a dead rank must
#: not hang the others).
DEFAULT_TIMEOUT_S = 300.0


def _device_type(devices) -> str:
    """The device type of a mesh: ``devices`` is None (the card), a device
    or device name, or a sequence of devices of one type."""
    if devices is None or isinstance(devices, (str, torch.device)):
        return resolve_device(devices).type
    types = {torch.device(d).type for d in devices}
    if len(types) != 1:
        raise ValueError(f"a mesh's devices must share one type, got {types}")
    return types.pop()


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_multihost() (or "
                           "torch.distributed.init_process_group) on every "
                           "rank first, or start the ranks with run_on_mesh")
    return dist.get_world_size()


def _mesh(shape: tuple, names: tuple, devices):
    from torch.distributed.device_mesh import DeviceMesh
    n, world = math.prod(shape), _world()
    dims = "x".join(str(s) for s in shape)
    if n > world:
        raise ValueError(f"mesh {dims} needs {n} devices, have {world}")
    if n < world:
        raise ValueError(f"mesh {dims} covers {n} of the {world} ranks: "
                         "every rank of the process group must be on it")
    return DeviceMesh(_device_type(devices),
                      torch.arange(n).reshape(shape), mesh_dim_names=names)


def make_mesh(data: int = 1, freq: int = 1, time: int = 1, devices=None):
    """A (data, freq, time) mesh over the ``data * freq * time`` ranks of the
    process group.  Axes of size 1 are kept, so one program text serves any
    factorization.  ``devices`` names the device type of the ranks' tensors
    ("cuda" by default, "cpu" for CPU ranks)."""
    return _mesh((int(data), int(freq), int(time)),
                 (DATA_AXIS, FREQ_AXIS, TIME_AXIS), devices)


def flat_mesh(axis: str = TIME_AXIS, devices=None):
    """A 1-D mesh over every rank along the single axis ``axis``."""
    return _mesh((_world(),), (axis,), devices)


def auto_mesh(n_devices: Optional[int] = None, devices=None):
    """Factor ``n_devices`` (every rank by default) into (data, freq) with
    data >= freq: data parallelism is the cheap axis (the epoch-mean
    all-reduce is its only collective)."""
    if n_devices is None:
        n_devices = _world()
    freq = 1
    for cand in range(int(math.isqrt(n_devices)), 0, -1):
        if n_devices % cand == 0:
            freq = cand
            break
    return make_mesh(data=n_devices // freq, freq=freq, time=1,
                     devices=devices)


def axis_size(mesh, axis: str) -> int:
    """Ranks along ``axis`` (1 for an axis the mesh lacks)."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(axis)) if axis in names else 1


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (``lax.axis_index``)."""
    names = mesh.mesh_dim_names or ()
    return mesh.get_local_rank(axis) if axis in names else 0


def placements(mesh, spec) -> list:
    """DTensor placements of a JAX-style partition spec: ``spec`` holds, per
    tensor dimension, the mesh axis it is split over or None."""
    from torch.distributed.tensor import Replicate, Shard
    spec = tuple(spec)
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, s in enumerate(spec) if s == name]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def shard_batch(x, mesh, spec):
    """``x``, which every rank holds whole, as a DTensor split by the
    partition spec ``spec`` (no communication: each rank keeps its block)."""
    from torch.distributed.tensor import distribute_tensor
    t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                        else x, device=mesh.device_type)
    return distribute_tensor(t, mesh, placements(mesh, spec),
                             src_data_rank=None)


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int) -> np.ndarray:
    """Zero-pad ``axis`` up to the next multiple (host-side helper for making
    batch axes divisible by their mesh axis)."""
    size = x.shape[axis]
    rem = (-size) % multiple
    if rem == 0:
        return x
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, rem)
    return np.pad(x, pad)


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   backend: Optional[str] = None,
                   timeout: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the process group so a mesh can span processes and hosts; a
    no-op when a group exists.  With ``coordinator_address`` ("host:port")
    the group meets there (``tcp://``) with the given size and rank;
    without it the ``torchrun`` environment is read (``env://``).
    ``backend`` defaults to NCCL when CUDA is available, else gloo."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = dict(backend=backend,
              timeout=datetime.timedelta(seconds=float(timeout)))
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes "
                             "and process_id")
        kw.update(init_method=f"tcp://{coordinator_address}",
                  world_size=int(num_processes), rank=int(process_id))
    else:
        kw.update(init_method="env://")
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", process_id or 0))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(**kw)


# -- one host, several ranks --------------------------------------------------

class MeshRun(NamedTuple):
    """What ``run_on_mesh`` returns: rank 0's result (numpy), and each
    rank's ``kernels.launches`` after ``fn``."""
    result: object
    launches: list


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _to_numpy(x):
    """Tensors (DTensors gathered) -> numpy, through tuples, lists, dicts
    and NamedTuples."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        from .sharded import full_tensor
        x = full_tensor(x)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_numpy(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to_numpy(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_to_numpy(v) for v in x)
    return x


def _rank_main(rank, world, port, fn, mesh_shape, backend, device, args,
               threads, timeout, queue) -> None:
    from .. import kernels
    try:
        torch.set_num_threads(int(threads))
        if device != "cpu":
            torch.cuda.set_device(torch.device(device).index or 0)
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout))
        mesh = make_mesh(*mesh_shape, devices=device)
        kernels.reset_launches()
        out = _to_numpy(fn(mesh, *args))
        queue.put((rank, True, out if rank == 0 else None,
                   dict(kernels.launches)))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        queue.put((rank, False, traceback.format_exc(), None))


def run_on_mesh(fn, mesh_shape: Sequence[int], *, backend: str = "gloo",
                device=None, args: tuple = (), threads: int = 1,
                timeout: float = DEFAULT_TIMEOUT_S) -> MeshRun:
    """Run ``fn(mesh, *args)`` on ``prod(mesh_shape)`` ranks of this host
    and return rank 0's result as numpy (a ``MeshRun``).

    The ranks start with the ``spawn`` method (this process may hold a CUDA
    context), meet on a free local port, build ``make_mesh(*mesh_shape)``
    on ``device`` ("cuda" by default, "cpu" for CPU ranks) and each run
    ``fn``; ``fn`` and ``args`` (numpy arrays and plain values) are pickled
    to them, so ``fn`` is a module-level function.  Several ranks on one
    card take gloo; NCCL needs a card a rank.  On the card the caller builds
    the kernel library first (``kernels.build()``) so that the ranks only
    load it.  A rank that raises, dies or outlives ``timeout`` seconds makes
    this raise (every collective also times out after ``timeout``), and no
    rank is left running.
    """
    import queue as _queue

    import torch.multiprocessing as mp
    world = math.prod(int(s) for s in mesh_shape)
    device = str(resolve_device(device))
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, port, fn, tuple(mesh_shape),
                               backend, device, tuple(args), threads,
                               float(timeout), results))
             for r in range(world)]
    for p in procs:
        p.start()
    got, error = {}, None
    deadline = time.monotonic() + timeout + 60.0
    try:
        while len(got) < world and error is None:
            try:
                rank, ok, out, launches = results.get(timeout=1.0)
            except _queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if not p.is_alive() and r not in got]
                if dead:
                    error = f"ranks {dead} died without a result"
                elif time.monotonic() > deadline:
                    error = f"no result within {timeout + 60.0:.0f} s"
                continue
            if not ok:
                error = f"rank {rank} failed:\n{out}"
            else:
                got[rank] = (out, launches)
        for p in procs:
            p.join(timeout=30.0 if error is None else 1.0)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if error is not None:
        raise RuntimeError(f"run_on_mesh {tuple(mesh_shape)}: {error}")
    bad = [r for r, p in enumerate(procs) if p.exitcode not in (0, None)]
    if bad:
        raise RuntimeError(f"run_on_mesh {tuple(mesh_shape)}: ranks {bad} "
                           "exited with an error after reporting")
    return MeshRun(got[0][0], [got[r][1] for r in range(world)])
