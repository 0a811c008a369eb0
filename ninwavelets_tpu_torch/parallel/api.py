"""High-level distributed transforms: a wavelet in, a sharded TFR out (port
of ``ninwavelets_tpu.parallel.api``).

The ``sharded_*`` functions take a prebuilt (F, N) bank; these build the
bank, choose the mesh, pad the batch and dispatch: the fused kernels on each
rank's block where the card's kernel takes the workload (K1 for the power,
K2 for ITC, a real or complex bank), the plain path elsewhere.  As every
sharded function, each rank of the mesh calls them with the same arguments.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import as_float32
from ..ops.bank import WaveletDef, make_fft_bank
from ..ops.fused import route
from .mesh import DATA_AXIS, auto_mesh, axis_size
from .sharded import (_out, full_tensor, sharded_fused_itc,
                      sharded_fused_mean_power, sharded_itc,
                      sharded_mean_power)


def _resolve(wavelet):
    """(wdef, interpolate) of a ``WaveletBase`` or a raw ``WaveletDef``."""
    if isinstance(wavelet, WaveletDef):
        return wavelet, False
    return wavelet._wdef(), bool(getattr(wavelet, "interpolate", False))


def _build(wavelet, freqs, n, sfreq, interpolate, device) -> torch.Tensor:
    """The (F, n) bank on ``device`` (float32, or complex64 for a
    Normal/Twice family)."""
    wdef, _ = _resolve(wavelet)
    rwl = float(getattr(wavelet, "real_wave_length", 1.0))
    return make_fft_bank(wdef, np.asarray(freqs, np.float32), n,
                         float(sfreq), interpolate, rwl, device=device)


def _default_mesh(signals, mesh):
    """``mesh``, else ``auto_mesh()`` over every rank, on the device of
    ``signals`` where they are a tensor (the card otherwise)."""
    if mesh is not None:
        return mesh
    plain = isinstance(signals, torch.Tensor) and not hasattr(
        signals, "device_mesh")
    return auto_mesh(devices=signals.device if plain else None)


def _signals(signals, mesh) -> torch.Tensor:
    if not isinstance(signals, torch.Tensor):
        return as_float32(np.asarray(signals), mesh.device_type)
    return as_float32(full_tensor(signals), mesh.device_type)


def distributed_mean_power(signals, wavelet, freqs, sfreq: float, mesh=None,
                           interpolate: Optional[bool] = None):
    """Epoch-mean power TFR of an (E, C, N) batch over a mesh: (C, F, N),
    a DTensor split over ``freq``.

    Epochs split over ``data``, zero-padded to a multiple of it (zero epochs
    add zero power; the mean is rescaled to the true count); bank rows over
    ``freq``.  ``wavelet`` is a ``WaveletBase`` (its ``interpolate`` unless
    overridden) or a raw ``WaveletDef``; ``mesh`` defaults to ``auto_mesh()``
    over every rank."""
    _, w_interp = _resolve(wavelet)
    interpolate = w_interp if interpolate is None else interpolate
    mesh = _default_mesh(signals, mesh)
    signals = _signals(signals, mesh)
    e, _, n = signals.shape
    pad_e = (-e) % axis_size(mesh, DATA_AXIS)
    if pad_e:
        signals = F.pad(signals, (0, 0, 0, 0, 0, pad_e))
    bank = _build(wavelet, freqs, n, sfreq, interpolate, signals.device)
    fn = (sharded_fused_mean_power if route("power", signals, bank).launch
          else sharded_mean_power)
    out = fn(signals, bank, mesh=mesh, interpolate=interpolate)
    if pad_e:
        out = _out(out.to_local() * ((e + pad_e) / e), mesh,
                   (None, "freq", None))
    return out


def distributed_itc(signals, wavelet, freqs, sfreq: float, mesh=None,
                    interpolate: Optional[bool] = None):
    """Inter-trial coherence of an (E, C, N) batch over a mesh: (C, F, N),
    a DTensor split over ``freq``.  E must divide the ``data`` axis (zero
    epochs cannot pad a unit-phase mean: they have no phase)."""
    _, w_interp = _resolve(wavelet)
    interpolate = w_interp if interpolate is None else interpolate
    mesh = _default_mesh(signals, mesh)
    signals = _signals(signals, mesh)
    e, _, n = signals.shape
    d = axis_size(mesh, DATA_AXIS)
    if e % d:
        raise ValueError(f"epochs ({e}) must divide the data axis ({d}) "
                         "for itc: zero-padding would inject NaN phases")
    bank = _build(wavelet, freqs, n, sfreq, interpolate, signals.device)
    fn = (sharded_fused_itc if route("itc", signals, bank).launch
          else sharded_itc)
    return fn(signals, bank, mesh=mesh, interpolate=interpolate)
