"""Shape helpers (port of ``ninwavelets_tpu.ops.signal_utils``)."""
from __future__ import annotations

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


def pad_to(wave_from: torch.Tensor, wave_to: torch.Tensor) -> torch.Tensor:
    """Length-match ``wave_from`` to ``wave_to`` along the last axis."""
    return pad_last_axis_to(wave_from, wave_to.shape[-1])
