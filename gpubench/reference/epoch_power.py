"""The epoch-mean power before the baseline, with the coherence: the
planes of ``epochs_planes`` (``cwt.py``, same formulas and precisions)
with the power left un-z-scored."""
from __future__ import annotations

import numpy as np
import torch

from .cwt import Precision, _coefficients, morse_bank


def epochs_power_planes(data: np.ndarray, freqs, sfreq: float, b: float,
                        r: float, analytic: bool, prec: Precision, device,
                        channels_per_block: int = 4):
    """Yield ``(channels, epoch-mean power, itc)`` for blocks of channels
    of the (E, C, N) epochs ``data``: two (c, F, N) planes a block, in
    ``prec.real``."""
    n_epochs, n_channels, n = data.shape
    bank = morse_bank(freqs, n, sfreq, b, r, analytic, prec, device)
    for c0 in range(0, n_channels, channels_per_block):
        sel = slice(c0, min(c0 + channels_per_block, n_channels))
        x = torch.from_numpy(np.ascontiguousarray(data[:, sel])).to(device)
        coef = _coefficients(x, bank, analytic, prec)
        power = prec.round(prec.round(coef.real ** 2 + coef.imag ** 2)
                           .sum(0) / n_epochs)
        itc = prec.round(torch.abs(prec.round(coef / torch.abs(coef))
                                   .sum(0) / n_epochs))
        del coef
        yield sel, power, itc
