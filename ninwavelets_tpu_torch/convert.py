"""Carry a wavelet and its bank across from the JAX package.

A wavelet's "weights" are its hyper-parameters and its (F, N) bank.  Both are
read here as plain Python and numpy values, so this module imports neither
``jax`` nor ``ninwavelets_tpu``: hand it the JAX object or arrays, or anything
with the same attributes.
"""
from __future__ import annotations

import numpy as np
import torch

from .models import zoo
from .ops.bank import WaveletMode

_CLASSES = {cls.__name__: cls for cls in
            (zoo.Morse, zoo.Morlet, zoo.MexicanHat, zoo.Shannon, zoo.Haar)}
_PARAMS = ("b", "r", "sigma", "gabor")


def wavelet_from_jax(w, device=None):
    """The port's wavelet of the same class as ``w`` (a JAX-package wavelet),
    with the same ``sfreq``, ``b``, ``r``, ``sigma``, ``gabor``,
    ``real_wave_length``, ``interpolate`` and ``mode``."""
    name = type(w).__name__
    if name not in _CLASSES:
        raise TypeError(f"no port of wavelet class {name!r}; one of "
                        f"{sorted(_CLASSES)}")
    kwargs = {k: getattr(w, k) for k in _PARAMS if hasattr(w, k)}
    out = _CLASSES[name](sfreq=float(w.sfreq),
                         real_wave_length=float(w.real_wave_length),
                         interpolate=bool(w.interpolate), device=device,
                         **kwargs)
    out.mode = WaveletMode[w.mode.name]
    return out


def bank_from_jax(bank_r, bank_i=None, device=None) -> torch.Tensor:
    """The JAX float-pair bank (real part, imaginary part or None) as the
    port's (F, N) bank: float32 when real, complex64 otherwise."""
    real = np.asarray(bank_r, dtype=np.float32)
    if bank_i is None:
        return torch.from_numpy(real.copy()).to(device)
    bank = real + 1j * np.asarray(bank_i, dtype=np.float32)
    return torch.from_numpy(bank.astype(np.complex64)).to(device)
