"""Where the port places its data when the caller does not say.

The rule, for every entry point that takes ``device`` (and, on the wavelet
classes, the reference's ``cuda`` flag): ``device=`` wins; else
``cuda=False`` given explicitly means the CPU; else the CUDA card, and a
``RuntimeError`` naming ``device="cpu"`` when CUDA is absent.  There is no
quiet fallback to the CPU.
"""
from __future__ import annotations

from typing import Optional

import torch


def resolve_device(device=None, cuda: Optional[bool] = None) -> torch.device:
    """The device an entry point places its data on (see the module
    docstring)."""
    if device is not None:
        return torch.device(device)
    if cuda is False:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError('CUDA is not available: the port runs on the card '
                           'by default; pass device="cpu" to run on the CPU')
    return torch.device("cuda")


def as_float32(x, device=None) -> torch.Tensor:
    """``x`` as a float32 tensor: on ``device`` when given, else where ``x``
    already lies (a tensor), else on the default of ``resolve_device``."""
    if device is None:
        device = (x.device if isinstance(x, torch.Tensor)
                  else resolve_device())
    return torch.as_tensor(x, dtype=torch.float32, device=device)
