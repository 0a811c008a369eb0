"""Shape and spectrum helpers (port of ``ninwavelets_tpu.ops.signal_utils``),
the reference's free functions ``pad_to``, ``hamming_window``,
``normalize`` and ``interpolate_alias``, and the port's ``row_cumsum``.  A
tensor argument keeps its device; other input becomes a CPU tensor."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


class SizeError(Exception):
    """Shape-mismatch error (raised with its message, unlike the reference,
    which prints it)."""


def pad_last_axis_to(x: torch.Tensor, n: int) -> torch.Tensor:
    """Reference ``pad_to`` semantics on the last axis: head-truncate if
    longer than ``n``, otherwise center-pad with the extra zero on the
    tail."""
    m = x.shape[-1]
    if m == n:
        return x
    if m > n:
        return x[..., :n]
    side1 = (n - m) // 2
    return F.pad(x, (side1, n - m - side1))


def row_cumsum(x: torch.Tensor) -> torch.Tensor:
    """``torch.cumsum`` along the last axis, the same bits on every run on
    the card: a tensor with one row goes through CUB's device-wide scan,
    whose float sums vary from run to run, so a single row is scanned
    beside a copy of itself (two rows take the per-row scan)."""
    flat = x.reshape(-1, x.shape[-1])
    if flat.shape[0] == 1:
        return torch.cumsum(torch.cat([flat, flat]), dim=-1)[:1].reshape(
            x.shape)
    return torch.cumsum(x, dim=-1)


def pad_to(wave_from: torch.Tensor, wave_to: torch.Tensor) -> torch.Tensor:
    """Length-match ``wave_from`` to ``wave_to`` along the last axis."""
    return pad_last_axis_to(wave_from, wave_to.shape[-1])


def hamming_window(wave) -> torch.Tensor:
    """(N,) float32 Hamming window sized to the wave's last axis."""
    wave = torch.as_tensor(wave)
    length = wave.shape[-1]
    window = torch.arange(length, dtype=torch.float32,
                          device=wave.device) / length
    return 0.54 - 0.46 * torch.cos(2.0 * math.pi * window)


def normalize(wave, length: float) -> torch.Tensor:
    """The (complex) wave scaled to the L2 norm ``length`` (the norm of all
    its elements)."""
    wave = torch.as_tensor(wave)
    return wave * (length / torch.linalg.norm(wave))


def interpolate_alias(wave) -> torch.Tensor:
    """Everything at and above the Nyquist bin (``n // 2``) of the last axis
    zeroed: the lower half of the spectrum kept, the upper half dropped."""
    wave = torch.as_tensor(wave)
    n = wave.shape[-1]
    keep = torch.arange(n, device=wave.device) < n // 2
    return torch.where(keep, wave, torch.zeros((), dtype=wave.dtype,
                                               device=wave.device))
