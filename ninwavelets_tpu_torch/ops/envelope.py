"""Power-envelope correlations, plain and pairwise-orthogonalized (Hipp,
Hawellek, Corbetta, Siegel & Engel, Nat. Neurosci. 2012); port of
``ninwavelets_tpu.ops.envelope``.

The orthogonalized variant projects channel b's coefficients off channel
a's instantaneous phase before correlating,
``Y_{b|a}(f, t) = Im(W_b conj(W_a) / |W_a|)``, so a component shared at zero
lag (volume conduction) cancels exactly while lagged envelope coupling
survives.

One signal FFT; the bank rows stream (the (E, C, F, N) coefficient tensor
never exists), and within a row the seed channels a go in chunks of
``extensions.chunk_size``: one chunk's projections, log envelopes and
per-epoch Pearson correlations are a few batched tensor operations.
Correlations run over time within each epoch, then average over epochs.
Products run in full float32.
"""
from __future__ import annotations

import torch

from ..device import as_float32
from .cwt import analytic_spectrum
from .extensions import chunk_size

__all__ = ["env_corr_matrix", "env_corr_matrix_from_bank"]


def _log_env(power: torch.Tensor, log: bool, eps: float) -> torch.Tensor:
    return torch.log(power + eps) if log else power


def _epoch_mean_corr(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean over epochs of the per-epoch Pearson correlation over time
    between x (E, S, N) and y (E, S, C, N): (S, C).  Zero-variance rows
    give 0."""
    from .scattering import fp32_matmul    # scattering imports ops.fused
    xc = x - x.mean(-1, keepdim=True)
    yc = y - y.mean(-1, keepdim=True)
    with fp32_matmul("exact"):
        num = torch.einsum("esn,escn->esc", xc, yc)
    den = torch.sqrt((xc * xc).sum(-1)[..., None] * (yc * yc).sum(-1))
    r = torch.where(den > 0, num / torch.where(den > 0, den,
                                               torch.ones_like(den)),
                    torch.zeros_like(num))
    return r.mean(0)


def _sym_full(env: torch.Tensor) -> torch.Tensor:
    """All-pairs plain envelope correlation of one (E, C, N) slab."""
    from .scattering import fp32_matmul    # scattering imports ops.fused
    xc = env - env.mean(-1, keepdim=True)
    with fp32_matmul("exact"):
        cov = torch.einsum("ean,ebn->eab", xc, xc)
        sd = torch.sqrt(torch.einsum("ean,ean->ea", xc, xc))
    den = sd[:, :, None] * sd[:, None, :]
    r = torch.where(den > 0, cov / torch.where(den > 0, den,
                                               torch.ones_like(den)),
                    torch.zeros_like(cov))
    return r.mean(0)


def env_corr_matrix_from_bank(sigs: torch.Tensor, bank: torch.Tensor,
                              orthogonalize: bool = True,
                              interpolate: bool = False,
                              log: bool = True, eps: float = 1e-12,
                              time_range=None) -> torch.Tensor:
    """(F, C, C) power-envelope correlation matrix of an (E, C, N) epoch
    batch against an (F, N) bank: ``out[f, a, b]`` correlates channel a's
    (log) power envelope with channel b's, orthogonalized with respect to
    a first when ``orthogonalize`` (then symmetrized, ``(R + R^T) / 2``,
    with a zero diagonal; the plain AEC keeps its diagonal of 1)."""
    spec = analytic_spectrum(sigs, interpolate)               # (E, C, N)
    n0, n1 = time_range if time_range is not None else (0, sigs.shape[-1])
    e, c = sigs.shape[0], sigs.shape[-2]
    step = chunk_size(e * c * (n1 - n0))
    rows = []
    for bank_row in bank:
        w = torch.fft.ifft(spec * bank_row)[..., n0:n1]       # (E, C, n)
        env = _log_env(torch.square(torch.abs(w)), log, eps)
        if not orthogonalize:
            rows.append(_sym_full(env))
            continue
        mag = torch.clamp(torch.abs(w), min=1e-20)
        parts = []
        for a0 in range(0, c, step):
            wa = w[:, a0:a0 + step]                           # (E, S, n)
            proj = (torch.imag(w[:, None] * torch.conj(wa)[:, :, None])
                    / mag[:, a0:a0 + step, None])             # (E, S, C, n)
            envp = _log_env(torch.square(proj), log, eps)
            parts.append(_epoch_mean_corr(env[:, a0:a0 + step], envp))
        r = torch.cat(parts)                                  # (C, C)
        r = 0.5 * (r + r.T)
        rows.append(r * (1.0 - torch.eye(c, dtype=r.dtype, device=r.device)))
    return torch.stack(rows)


def env_corr_matrix(sigs_r, bank, orthogonalize: bool = True,
                    interpolate: bool = False, log: bool = True,
                    eps: float = 1e-12, time_range=None,
                    device=None) -> torch.Tensor:
    """``env_corr_matrix_from_bank`` at the float boundary (real banks:
    envelope coupling needs an analytic family).  A tensor stays on its
    device; other input goes to ``device`` (the card when None)."""
    sigs = as_float32(sigs_r, device)
    tr = None if time_range is None else (int(time_range[0]),
                                          int(time_range[1]))
    return env_corr_matrix_from_bank(sigs, as_float32(bank, sigs.device),
                                     bool(orthogonalize), bool(interpolate),
                                     bool(log), float(eps), tr)
