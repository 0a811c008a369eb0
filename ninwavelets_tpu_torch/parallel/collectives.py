"""The collectives of the sharded engine, over ``torch.distributed`` groups.

This is the one module that knows which backend a group runs.  The JAX
package finishes its ``shard_map`` programs with XLA collectives; here each
maps to one call:

* ``psum`` / ``pmean`` -> ``all_reduce`` (SUM, then a division for the mean);
* ``pmax`` -> ``all_reduce`` with MAX;
* ``ppermute`` by one step -> ``shift``: one point-to-point exchange along
  the group's rank order, zeros where no rank sends (the global edges);
* gathering a sharded axis -> ``all_gather``.

NCCL runs one rank a card.  Several ranks that share one card run gloo, which
takes CUDA tensors for its all-reduce and all-gather but not for
point-to-point sends: a send of a CUDA tensor fails and leaves the group
unusable.  So under gloo ``shift`` copies a CUDA block to the host, exchanges
it there and copies the result back, and counts each such call in
``staged``.  That is the caller's choice of backend, not a fallback: the
compute stays on the card, only the exchanged bytes pass through host memory.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

#: ``shift`` calls this process staged through host memory (gloo on CUDA
#: tensors).
staged = 0


def backend(group=None) -> str:
    """The backend of ``group`` (the default group when None)."""
    return str(dist.get_backend(group))


def size(group=None) -> int:
    return dist.get_world_size(group)


def all_reduce(t: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """A new tensor holding the reduction of ``t`` over ``group`` ("sum" or
    "max"); a complex tensor is reduced as its real view."""
    out = t.clone(memory_format=torch.contiguous_format)
    buf = torch.view_as_real(out) if out.is_complex() else out
    dist.all_reduce(buf, op={"sum": dist.ReduceOp.SUM,
                             "max": dist.ReduceOp.MAX}[op], group=group)
    return out


def psum(t: torch.Tensor, group=None) -> torch.Tensor:
    return all_reduce(t, "sum", group)


def pmean(t: torch.Tensor, group=None) -> torch.Tensor:
    return all_reduce(t, "sum", group) / size(group)


def pmax(t: torch.Tensor, group=None) -> torch.Tensor:
    return all_reduce(t, "max", group)


def all_gather(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """The blocks of every rank of ``group``, in rank order, joined along
    ``dim`` (every rank's block has ``t``'s shape)."""
    src = t.contiguous()
    buf = torch.view_as_real(src) if src.is_complex() else src
    parts = [torch.empty_like(buf) for _ in range(size(group))]
    dist.all_gather(parts, buf, group=group)
    if src.is_complex():
        parts = [torch.view_as_complex(p) for p in parts]
    return torch.cat(parts, dim)


def shift(t: torch.Tensor, group, step: int) -> torch.Tensor:
    """``ppermute`` by ``step`` (+1 or -1) along ``group``'s rank order: the
    block that the rank ``step`` places before this one holds, or zeros
    where there is none (the global edge).  One send and one receive;
    through host memory under gloo for a CUDA block."""
    global staged
    ranks = dist.get_process_group_ranks(group)
    me = ranks.index(dist.get_rank())
    src, dst = me - step, me + step
    send = t.contiguous()
    stage = send.is_cuda and backend(group) == "gloo"
    if stage:
        send = send.cpu()
        staged += 1
    recv = torch.zeros_like(send)
    ops = []
    if 0 <= dst < len(ranks):
        ops.append(dist.isend(send, ranks[dst], group=group))
    if 0 <= src < len(ranks):
        ops.append(dist.irecv(recv, ranks[src], group=group))
    for o in ops:
        o.wait()
    return recv.to(t.device) if stage else recv
