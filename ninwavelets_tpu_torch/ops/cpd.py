"""Canonical Polyadic (PARAFAC) decomposition of time-frequency tensors
(Harshman 1970; Kolda & Bader, SIAM Rev. 2009), port of
``ninwavelets_tpu.ops.cpd``: a (channel x frequency x time) or (epoch x
frequency x time) power tensor factors into rank-R components, each an
outer product of mode signatures (the ERPWAVELAB workflow).

Every ALS step is an MTTKRP, one ``einsum`` over the dense tensor, then an
R x R solve (``nonneg=False``) or HALS column updates (``nonneg=True``).
The JAX package asks ``Precision.HIGHEST`` of every product, since the fit
cancels three O(||X||^2) terms; here every MTTKRP and Gram product runs
inside ``fp32_matmul("exact")``, so TF32 on and off give equal results.
The initial factors come from a ``torch.Generator`` (uniform on [0.1, 1)
for the nonnegative mode, standard normal otherwise); ``_cp_from_factors``
takes given ones.

A numpy input goes to ``device`` (the card when None); a tensor stays on
its device.
"""
from __future__ import annotations

import string

import torch

from ..device import as_float32
from .scattering import fp32_matmul

__all__ = ["cp_decompose", "cp_reconstruct"]


def _mttkrp(x, factors, mode):
    """``einsum('ijk,jr,kr->ir', x, B, C)``-style MTTKRP for any ndim."""
    letters = string.ascii_lowercase[:x.ndim]
    ins, ops = [letters], [x]
    for m in range(x.ndim):
        if m != mode:
            ins.append(letters[m] + "r")
            ops.append(factors[m])
    return torch.einsum(",".join(ins) + "->" + letters[mode] + "r", *ops)


def _gram_product(factors, skip):
    v = None
    for m, f in enumerate(factors):
        if m != skip:
            g = f.T @ f
            v = g if v is None else v * g
    return v


def _col_norm(f):
    return f.square().sum(0).sqrt().clamp(min=1e-12)


def _cp_from_factors(x, factors, *, n_iter, nonneg, ridge):
    """ALS (or HALS) sweeps from the given initial factors; returns
    ``(weights, factors, fit)`` as ``cp_decompose``."""
    nd = x.ndim
    rank = factors[0].shape[1]
    factors = [f.clone() for f in factors]
    eye = torch.eye(rank, dtype=torch.float32, device=x.device)
    with fp32_matmul("exact"):
        for _ in range(int(n_iter)):
            for mode in range(nd):
                m = _mttkrp(x, factors, mode)            # (I_mode, R)
                v = _gram_product(factors, mode)         # (R, R)
                if nonneg:
                    a = factors[mode]
                    for r in range(rank):
                        num = m[:, r] - a @ v[:, r] + a[:, r] * v[r, r]
                        a[:, r] = (num / v[r, r].clamp(min=1e-12)).clamp(
                            min=1e-12)
                else:
                    factors[mode] = torch.linalg.solve_ex(
                        v + ridge * eye, m.T)[0].T
                # renormalize all but the last mode (it keeps the scale)
                if mode != nd - 1:
                    norm = _col_norm(factors[mode])[None, :]
                    factors[mode] = factors[mode] / norm
                    factors[nd - 1] = factors[nd - 1] * norm

        # ||X - Xh||^2 = ||X||^2 - 2 <X, Xh> + ||Xh||^2 from the Grams
        m_last = _mttkrp(x, factors, nd - 1)
        inner = (m_last * factors[nd - 1]).sum()
        vfull = _gram_product(factors, nd - 1) * (
            factors[nd - 1].T @ factors[nd - 1])
    norm_x2 = (x * x).sum()
    resid2 = (norm_x2 - 2.0 * inner + vfull.sum()).clamp(min=0.0)
    fit = 1.0 - resid2.sqrt() / norm_x2.sqrt().clamp(min=1e-30)

    # unit-norm columns everywhere, the scale in the weights
    weights = torch.ones(rank, dtype=torch.float32, device=x.device)
    for mode in range(nd):
        norm = _col_norm(factors[mode])
        factors[mode] = factors[mode] / norm
        weights = weights * norm
    order = torch.argsort(-weights, stable=True)
    return weights[order], [f[:, order] for f in factors], fit


def cp_decompose(tensor, rank: int, n_iter: int = 100,
                 nonneg: bool = False, seed: int = 0,
                 ridge: float = 1e-6, device=None):
    """``(weights, factors, fit)``: the rank-``rank`` CP / PARAFAC model of
    a dense >= 2-way float tensor, ``tensor ~= sum_r weights[r] *
    outer(factors[0][:, r], factors[1][:, r], ...)``.

    Factor columns are unit-norm, components sorted by descending weight;
    ``fit`` is ``1 - ||X - Xhat|| / ||X||``.  ``nonneg=True`` runs HALS
    nonnegative updates (for power tensors); ``n_iter`` is the fixed sweep
    count.  The initial factors come from a ``torch.Generator`` seeded with
    ``seed`` (other draws than the JAX package's for one seed)."""
    x = as_float32(tensor, device)
    if x.ndim < 2:
        raise ValueError("CP needs a tensor of >= 2 modes")
    if rank < 1 or rank > min(x.shape):
        # rank > min dim is legal for CP in general but pointless for the
        # TF use cases here and destabilizes ALS; refuse loudly.
        raise ValueError("rank must be in [1, min(tensor.shape)]")
    gen = torch.Generator(device=x.device).manual_seed(int(seed))
    draw = torch.rand if nonneg else torch.randn
    factors = [draw((s, int(rank)), generator=gen, device=x.device)
               for s in x.shape]
    if nonneg:
        factors = [0.1 + 0.9 * f for f in factors]
    return _cp_from_factors(x, factors, n_iter=n_iter, nonneg=bool(nonneg),
                            ridge=float(ridge))


def cp_reconstruct(weights, factors) -> torch.Tensor:
    """Dense tensor from a CP model (the inverse of ``cp_decompose``)."""
    weights = as_float32(weights)
    nd = len(factors)
    letters = string.ascii_lowercase[:nd]
    ins = ["r"] + [letters[m] + "r" for m in range(nd)]
    with fp32_matmul("exact"):
        return torch.einsum(",".join(ins) + "->" + letters, weights,
                            *[as_float32(f, weights.device)
                              for f in factors])
