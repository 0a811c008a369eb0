"""Reassigned scalogram: 2-D time-frequency reassignment of the CWT (port of
``ninwavelets_tpu.ops.reassign``).

Reassignment (Kodera 1976; Auger & Flandrin 1995) sharpens both axes of the
scalogram: each (f, t) cell's energy moves to the local energy centroid

    omega(f, t) = Im[ dW * conj(W) ] / (2 pi |W|^2)        (Hz)
    t_hat(f, t) = t + Re[ Wt * conj(W) ] / |W|^2           (s)

where ``dW`` is the CWT against the time-derivative wavelet (spectrum x
``i 2 pi nu``) and ``Wt`` the CWT against the time-weighted wavelet
``tau psi(tau)`` (spectrum ``(i/2pi) d psi_hat / d nu``, central
differences on the FFT grid).  Synchrosqueezing (:mod:`.sst`) is the
frequency-only special case.

The 2-D scatter is a batched product, as in the JAX package: for a block of
source rows, the frequency-interval mask times power (K, F_out, N) against
the time-bin one-hot (K, N, T'), summed over the block.  It runs as a
``torch.matmul`` in true float32 (no TF32: the JAX package asks for
``Precision.HIGHEST``).  Output time is decimated by ``t_decim``.  Plain
torch on every device.
"""
from __future__ import annotations

import math

import torch

from .cwt import analytic_spectrum
from .scattering import fp32_matmul
from .sst import _bin_nu

__all__ = ["reassigned_power", "reassigned_mean_power"]

#: Source rows per batched product.
_ROWS_PER_STEP = 16


def _edges(f_grid: torch.Tensor) -> torch.Tensor:
    """(F+1,) interval edges around the monotone analysis grid, open at both
    ends (out-of-range centroids clip into the edge rows)."""
    mid = 0.5 * (f_grid[1:] + f_grid[:-1])
    big = torch.full((1,), 3.4e38, dtype=torch.float32, device=f_grid.device)
    return torch.cat([-big, mid, big])


def _reassign_one(signal: torch.Tensor, bank: torch.Tensor,
                  f_grid: torch.Tensor, sfreq: float, interpolate: bool,
                  rel_threshold: float, t_decim: int, f_own=None,
                  freq_group=None) -> torch.Tensor:
    """(N,) x (F_local, N) -> (F, T') reassigned power of one signal.

    For the frequency-sharded ``parallel.sharded_reassigned_mean_power``,
    ``bank`` may be a slice of the bank on ``f_grid`` with ``f_own`` its own
    rows' frequencies (where gated cells stay): cells land by value on the
    whole grid, and over the ranks of ``freq_group`` the gate's peak is the
    signal's whole plane's.  The defaults (one device) leave the result as
    it is."""
    if f_own is None:
        f_own = f_grid
    n = signal.shape[-1]
    n_f = bank.shape[0]
    n_t = -(-n // t_decim)
    spec = analytic_spectrum(signal, interpolate)[None, :]
    nu = _bin_nu(n, sfreq, bank.device)
    w = torch.fft.ifft(spec * bank)
    dw = torch.fft.ifft(spec * (bank * (2j * math.pi * nu)))
    # FT[tau psi](nu) = (i / 2pi) d psi_hat / d nu, by central differences
    # over the FFT bin grid (d nu = sfreq / n per bin).
    dbank = torch.gradient(bank, dim=-1)[0] * (n / sfreq)
    wt = torch.fft.ifft(spec * (dbank * (1j / (2.0 * math.pi))))

    power = torch.square(w.real) + torch.square(w.imag)
    guard = torch.clamp(power, min=1e-30)
    omega = (dw.imag * w.real - dw.real * w.imag) / (2.0 * math.pi * guard)
    t_off = (wt.real * w.real + wt.imag * w.imag) / guard       # seconds
    t_idx = torch.arange(n, dtype=torch.float32, device=bank.device)
    t_hat = t_idx[None, :] + t_off * sfreq                       # samples

    # Noise gate: cells below rel_threshold x peak keep their own bin.
    peak = torch.amax(power)
    if freq_group is not None:
        from ..parallel.collectives import pmax
        peak = pmax(peak, freq_group)
    gate = power < rel_threshold * peak
    omega = torch.where(gate, f_own[:, None], omega)
    t_hat = torch.where(gate, t_idx[None, :], t_hat)
    col = torch.clamp(torch.floor(t_hat / t_decim), 0, n_t - 1).to(
        torch.int64)
    edges = _edges(f_grid)
    cols = torch.arange(n_t, device=bank.device)

    out = torch.zeros((f_grid.shape[0], n_t), dtype=torch.float32,
                      device=bank.device)
    for lo in range(0, n_f, _ROWS_PER_STEP):
        om = omega[lo:lo + _ROWS_PER_STEP, None, :]
        lhs = ((om > edges[None, :-1, None]) & (om <= edges[None, 1:, None])
               ).to(torch.float32) * power[lo:lo + _ROWS_PER_STEP, None, :]
        rhs = (col[lo:lo + _ROWS_PER_STEP, :, None] == cols).to(torch.float32)
        with fp32_matmul("exact"):
            out += torch.matmul(lhs, rhs).sum(0)
    return out


def reassigned_power(signals: torch.Tensor, bank: torch.Tensor, f_grid,
                     sfreq: float, interpolate: bool = False,
                     rel_threshold: float = 1e-6,
                     t_decim: int = 16) -> torch.Tensor:
    """(..., F, ceil(N / t_decim)) reassigned scalogram power.

    ``signals``: (..., N) real; ``bank``: (F, N) real analytic bank (phase
    is required, so a complex Normal/Twice-mode bank is rejected);
    ``f_grid``: the ascending analysis frequencies in Hz.  Energy is
    conserved: every cell lands in exactly one output bin (out-of-range
    centroids clip to the edge rows and the first / last time bins).  The
    noise gate is per signal.
    """
    if bank.ndim != 2 or bank.is_complex():
        raise ValueError("bank must be (F, N) real: reassignment needs an "
                         "analytic (real-spectrum) family")
    signals = signals.to(torch.float32)
    bank = bank.to(torch.float32)
    f_grid = torch.as_tensor(f_grid, dtype=torch.float32, device=bank.device)
    lead, n = signals.shape[:-1], signals.shape[-1]
    out = torch.stack([
        _reassign_one(sig, bank, f_grid, float(sfreq), bool(interpolate),
                      float(rel_threshold), int(t_decim))
        for sig in signals.reshape(-1, n)])
    return out.reshape(*lead, *out.shape[1:])


def reassigned_mean_power(signals: torch.Tensor, bank: torch.Tensor, f_grid,
                          sfreq: float, interpolate: bool = False,
                          rel_threshold: float = 1e-6,
                          t_decim: int = 16) -> torch.Tensor:
    """Epoch-mean reassigned power: the mean over axis 0 of
    :func:`reassigned_power` (per-trial reassignment, then the average)."""
    return torch.mean(reassigned_power(
        signals, bank, f_grid, sfreq, interpolate=interpolate,
        rel_threshold=rel_threshold, t_decim=t_decim), dim=0)
