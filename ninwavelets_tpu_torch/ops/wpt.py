"""Maximal-overlap wavelet packet transform (MODWPT) and best-basis
selection (port of ``ninwavelets_tpu.ops.wpt``).

Where the MODWT only re-splits the lowpass branch, the packet transform
splits every node, tiling the frequency axis into 2^j equal bands at level
j.  Each node's transfer function is a product of a-trous-upsampled base
filter DFTs built once on the host in float64 (Percival & Walden ch. 6:
the rule ``b mod 4 in {0, 3} -> g`` puts the nodes in frequency order),
and a level is the real part of ``ifft(bank * fft(x))``, one node at a
time (``ops.dwt._analysis``).  Every level is a tight frame, so its
inverse is the conjugate bank.

Best-basis selection (Coifman-Wickerhauser) prunes the tree on the host
over the packet tables computed on the device: a data-dependent choice,
made in the JAX package's float arithmetic on the same tables.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import as_float32
from .dwt import _analysis, _complex, _synthesis, wavelet_filter

__all__ = ["modwpt_bank", "modwpt", "imodwpt", "best_basis",
           "best_basis_reconstruct", "node_band"]


@functools.lru_cache(maxsize=32)
def modwpt_bank(name: str, level: int, n: int):
    """(2^level, n) frequency-domain MODWPT bank for one level, as a
    float32 numpy (real, imag) pair.  Node ``b`` is FREQUENCY-ordered:
    its transfer function concentrates on ``[b, b+1] / 2^{level+1}``
    cycles/sample (P&W sequency rule)."""
    if level < 1:
        raise ValueError("level must be >= 1")
    if 2 ** level > n:
        raise ValueError(f"level {level} needs 2^level <= N, got N={n}")
    g, h = wavelet_filter(name)
    gt, ht = g / np.sqrt(2.0), h / np.sqrt(2.0)
    k = np.arange(n)
    tw = np.exp(-2j * np.pi * np.outer(k, np.arange(g.size)) / n)
    G, H = tw @ gt, tw @ ht
    rows = [np.ones(n, np.complex128)]
    for j in range(1, level + 1):
        nxt = []
        for b in range(2 ** j):
            base = G if b % 4 in (0, 3) else H        # sequency ordering
            nxt.append(rows[b // 2] * base[(2 ** (j - 1) * k) % n])
        rows = nxt
    bank = np.stack(rows)
    return (np.ascontiguousarray(bank.real, np.float32),
            np.ascontiguousarray(bank.imag, np.float32))


def _bank(name: str, level: int, n: int, device) -> torch.Tensor:
    return _complex(*modwpt_bank(name, int(level), int(n)), device)


def modwpt(x, wavelet: str = "db4", level: int = 3,
           device=None) -> torch.Tensor:
    """Level-``level`` MODWPT packet table: (..., N) -> (..., 2^level, N)
    float32.  Row ``b`` carries the band ``[b, b+1] / 2^{level+1}``
    cycles/sample; rows are shift-invariant and the table preserves energy
    (tight frame)."""
    x = as_float32(x, device)
    return _analysis(x, _bank(wavelet, level, x.shape[-1], x.device))


def imodwpt(w, wavelet: str = "db4", device=None) -> torch.Tensor:
    """Exact inverse of ``modwpt``: (..., 2^level, N) -> (..., N)."""
    w = as_float32(w, device)
    level = int(np.log2(w.shape[-2]))
    if 2 ** level != w.shape[-2]:
        raise ValueError(f"packet axis must be 2^level, got {w.shape[-2]}")
    return _synthesis(w, _bank(wavelet, level, w.shape[-1], w.device))


def node_band(level: int, b: int):
    """Frequency band (lo, hi) in cycles/sample covered by packet node
    ``(level, b)`` under the sequency ordering."""
    return b / 2.0 ** (level + 1), (b + 1) / 2.0 ** (level + 1)


def _cost(c: np.ndarray, kind: str) -> float:
    """Additive node cost over coefficients ``c`` (flattened)."""
    if kind == "energy_log":
        v = c[c != 0.0]
        return float(np.sum(np.log(v * v))) if v.size else 0.0
    if kind == "shannon":
        # -sum p log p against the NODE energy is not additive across a
        # split; the standard CW functional uses -sum c^2 log c^2.
        v = c[c != 0.0].astype(np.float64)
        v2 = v * v
        return float(-np.sum(v2 * np.log(v2)))
    if kind == "threshold":
        return float(np.count_nonzero(np.abs(c) > 1.0))
    raise ValueError(f"cost must be 'shannon', 'energy_log' or "
                     f"'threshold', got {kind!r}")


def _node_costs(tables: dict, max_level: int, cost: str) -> dict:
    """{(level, b): cost} over host tables ``{level: (..., 2^level, N)}``.

    Each redundant node stands for a DECIMATED node: its N/2^j
    orthonormal coefficients are a subsample of the MODWPT row scaled by
    2^{j/2}, so the scaled row is scored and weighted by 2^{-j} (the
    subsampling fraction).  Without both factors the additive costs are
    level-degenerate and the prune collapses to the root."""
    return {(j, b): _cost(2.0 ** (j / 2.0)
                          * np.ravel(tables[j][..., b, :]), cost) / 2.0 ** j
            for j in range(max_level + 1) for b in range(2 ** j)}


def _prune(costs: dict, max_level: int) -> list:
    """Bottom-up Coifman-Wickerhauser prune: a parent is kept when its
    cost does not exceed its children's best cover.  Returns the kept
    nodes in frequency order."""
    best_cost: dict = {}
    best_cover: dict = {}
    for j in range(max_level, -1, -1):
        for b in range(2 ** j):
            c = costs[(j, b)]
            if j == max_level:
                best_cost[(j, b)] = c
                best_cover[(j, b)] = [(j, b)]
                continue
            child = best_cost[(j + 1, 2 * b)] + best_cost[(j + 1, 2 * b + 1)]
            if c <= child:
                best_cost[(j, b)] = c
                best_cover[(j, b)] = [(j, b)]
            else:
                best_cost[(j, b)] = child
                best_cover[(j, b)] = (best_cover[(j + 1, 2 * b)]
                                      + best_cover[(j + 1, 2 * b + 1)])
    return sorted(best_cover[(0, 0)],
                  key=lambda jb: node_band(jb[0], jb[1])[0])


def best_basis(x, wavelet: str = "db4", max_level: int = 4,
               cost: str = "shannon", device=None):
    """Coifman-Wickerhauser best basis over the MODWPT tree.

    Computes the packet tables for levels 1..``max_level`` on the device,
    then prunes bottom-up on the host: a parent node is kept when its
    additive ``cost`` does not exceed its children's combined best cover.

    Returns ``(nodes, coeffs)``: ``nodes`` is a list of ``(level, b)``
    pairs whose bands tile ``[0, 1/2)`` cycles/sample exactly, and
    ``coeffs`` maps each node to its (..., N) float32 coefficient tensor on
    the input's device (the JAX package returns host arrays);
    ``best_basis_reconstruct`` inverts the selection.

    Costs: ``"shannon"`` (the CW ``-sum c^2 log c^2`` functional,
    default), ``"energy_log"``, ``"threshold"`` (count above 1 — scale
    the signal accordingly).
    """
    x = as_float32(x, device)
    max_level = int(max_level)
    dev = {j: modwpt(x, wavelet, j) for j in range(1, max_level + 1)}
    dev[0] = x[..., None, :]
    host = {j: t.cpu().numpy() for j, t in dev.items()}
    nodes = _prune(_node_costs(host, max_level, cost), max_level)
    return nodes, {jb: dev[jb[0]][..., jb[1], :] for jb in nodes}


def best_basis_reconstruct(nodes, coeffs, wavelet: str = "db4",
                           keep=None, device=None) -> torch.Tensor:
    """Invert a ``best_basis`` selection: synthesize each node through its
    conjugate transfer and sum.  ``keep``: optional subset of nodes to
    reconstruct from (band-selective filtering — drop the rest).  A
    degenerate selection ``[(0, 0)]`` returns the signal itself."""
    keep = set(nodes if keep is None else keep)
    out = None
    for (j, b) in nodes:
        if (j, b) not in keep:
            continue
        c = as_float32(coeffs[(j, b)], device)
        if j == 0:
            part = c
        else:
            br, bi = modwpt_bank(wavelet, j, c.shape[-1])
            tr = _complex(br[b], bi[b], c.device)
            part = torch.fft.ifft(torch.conj(tr) * torch.fft.fft(c)).real
        out = part if out is None else out + part
    if out is None:
        raise ValueError("keep selects no nodes")
    return out
