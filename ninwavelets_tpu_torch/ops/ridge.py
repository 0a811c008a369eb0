"""Ridge extraction from time-frequency planes (port of
``ninwavelets_tpu.ops.ridge``).

Given a scalogram (power or the synchrosqueezed plane of ``ops.sst``), the
dominant instantaneous-frequency track is the max-energy path under a
frequency-jump penalty, the penalized dynamic program of Carmona, Hwang &
Torresani (1997).  As in the JAX package, the path is read off forward and
backward scores rather than a sequential backtrack: each column's row is
``argmax(alpha + beta)``, the best score through it from the left plus the
best completion to the right.  Plain torch on every device: one (F, F)
relaxation per column, a Python loop over time.
"""
from __future__ import annotations

import numpy as np
import torch

from .cwt import cwt_from_bank

__all__ = ["extract_ridge", "ridge_frequencies", "extract_modes",
           "extract_modes_ri"]


def _ridge_indices(log_e: torch.Tensor, penalty: float) -> torch.Tensor:
    """(F, N) log-energy -> (N,) int64 row indices of the optimal path,
    maximizing ``sum_t log_e[f_t, t] - penalty * (f_t - f_{t-1})^2`` (index
    units)."""
    n_f, n = log_e.shape
    fi = torch.arange(n_f, dtype=log_e.dtype, device=log_e.device)
    jump = penalty * torch.square(fi[:, None] - fi[None, :])   # (to, from)
    cols = log_e.T                                             # (N, F)
    alpha = [cols[0]]
    for t in range(1, n):
        alpha.append(cols[t] + torch.amax(alpha[-1][None, :] - jump, dim=1))
    # beta_t[f] = max_g (cols[t+1][g] - jump[f, g] + beta_{t+1}[g]); jump is
    # symmetric, so one matrix serves both directions.
    beta = [torch.zeros_like(cols[0])]
    for t in range(n - 2, -1, -1):
        beta.append(torch.amax((cols[t + 1] + beta[-1])[None, :] - jump,
                               dim=1))
    score = torch.stack(alpha) + torch.stack(beta[::-1])
    return torch.argmax(score, dim=-1)


def extract_ridge(tf: torch.Tensor, penalty: float = 0.5,
                  floor: float = 1e-30):
    """Dominant ridge of a (F, N) time-frequency plane.

    Args:
      tf: (F, N) nonnegative energy plane (power or synchrosqueezed).
      penalty: frequency-jump penalty in (log-energy per squared row-index)
        units; 0 reduces to per-column argmax.

    Returns:
      (indices, refined): (N,) int32 row indices and (N,) float32
      sub-row positions from a parabolic fit of log-energy around the ridge
      (clamped to +-0.5 rows; the edge rows keep the integer position).
    """
    log_e = torch.log(torch.clamp(tf, min=floor))
    idx = _ridge_indices(log_e, float(penalty))
    n_f, n = tf.shape
    t = torch.arange(n, device=tf.device)
    up = torch.clamp(idx + 1, max=n_f - 1)
    dn = torch.clamp(idx - 1, min=0)
    c = log_e[idx, t]
    lft, rgt = log_e[dn, t], log_e[up, t]
    denom = lft - 2.0 * c + rgt
    delta = torch.where(torch.abs(denom) > 1e-12, 0.5 * (lft - rgt) / denom,
                        torch.zeros_like(denom))
    delta = torch.clamp(delta, -0.5, 0.5)
    delta = torch.where((idx == 0) | (idx == n_f - 1),
                        torch.zeros_like(delta), delta)
    return idx.to(torch.int32), idx.to(torch.float32) + delta


def ridge_frequencies(tf, freqs, penalty: float = 0.5) -> np.ndarray:
    """(N,) ridge in Hz: ``extract_ridge`` positions linearly interpolated
    onto the analysis-frequency grid (host numpy)."""
    freqs = np.asarray(freqs, np.float64)
    _, pos = extract_ridge(tf, penalty)
    pos = pos.cpu().numpy().astype(np.float64)
    return np.interp(pos, np.arange(freqs.size), freqs)


def extract_modes(signal: torch.Tensor, bank: torch.Tensor,
                  n_modes: int = 2, penalty: float = 0.5,
                  bw_rows: float = 2.0, interpolate: bool = False,
                  eps: float = 1e-6):
    """Iterative multi-component (mode) retrieval: ridge-follow,
    reconstruct along the ridge, subtract, ``n_modes`` times.

    Each round CWTs the residual, tracks its dominant ridge
    (``extract_ridge``) and solves the time-local least squares for the
    analytic mode: with the per-row gains ``g_r = B_r`` read from the bank
    at the ridge frequency's FFT bin,
    ``x_a(t) = 2 * sum_r W_r conj(g_r) / sum_r |g_r|^2`` over the rows
    within ``bw_rows`` of the track.

    Args:
      signal: (N,) real.
      bank: (F, N) frequency-domain bank covering the modes' band.

    Returns:
      (modes, tracks, residual): (K, N) float32 modes, (K, N) float32 ridge
      positions in row units, and the (N,) residual.
    """
    n_f, n = bank.shape
    rows = torch.arange(n_f, dtype=torch.float32, device=bank.device)[:, None]
    # Each row's peak FFT bin: the bin its response is centered on.
    peak_bins = torch.argmax(torch.abs(bank), dim=1).to(torch.float32)
    sig = signal.to(torch.float32)
    cbank = bank.conj() if bank.is_complex() else bank
    zero = torch.zeros((), dtype=cbank.dtype, device=bank.device)
    modes, tracks = [], []
    for _ in range(int(n_modes)):
        w = cwt_from_bank(sig, bank, interpolate)                  # (F, N)
        p = torch.square(w.real) + torch.square(w.imag)
        _, pos = extract_ridge(p, penalty)
        # Ridge FFT bin: the rows' peak bins interpolated at the refined
        # sub-row position.
        lo = torch.clamp(torch.floor(pos), 0, n_f - 1).to(torch.int64)
        hi = torch.clamp(lo + 1, max=n_f - 1)
        frac = pos - lo
        bin_t = torch.clamp(torch.round(peak_bins[lo] * (1.0 - frac)
                                        + peak_bins[hi] * frac),
                            0, n - 1).to(torch.int64)
        mask = torch.abs(rows - pos[None, :]) <= bw_rows
        gc = torch.where(mask, cbank[:, bin_t], zero)
        num = torch.sum(w * gc, dim=0)                             # (N,)
        den = torch.sum(torch.square(torch.abs(bank[:, bin_t])) * mask, dim=0)
        mode = (2.0 * num / torch.clamp(den, min=eps)).real
        modes.append(mode)
        tracks.append(pos)
        sig = sig - mode
    return torch.stack(modes), torch.stack(tracks), sig


def extract_modes_ri(signal: torch.Tensor, bank_r: torch.Tensor,
                     bank_i=None, *, n_modes: int = 2, penalty: float = 0.5,
                     bw_rows: float = 2.0, interpolate: bool = False,
                     eps: float = 1e-6):
    """``extract_modes`` with the bank as a (real, imag-or-None) pair, the
    JAX package's float-boundary form."""
    bank = bank_r if bank_i is None else torch.complex(bank_r, bank_i)
    return extract_modes(signal, bank, n_modes, penalty, bw_rows,
                         interpolate, eps)
