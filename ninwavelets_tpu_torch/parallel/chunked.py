"""Halo geometry of the overlap-discard long-recording paths (port of the
single-device parts of ``ninwavelets_tpu.parallel.chunked``).

A long recording is cut into windows, each extended by ``halo`` samples of
real signal on both sides and convolved against a bank synthesized at the
extended length; the halos are discarded.  The interiors match the
whole-signal transform to float32 for any wavelet whose time support fits in
the halo (``halo_samples``).  The bank grid maps bin i to ``i * sfreq / n``
for any n (``ops.grids.fft_bin_freqs``), so the same transfer function is
sampled at window resolution.

The same geometry runs over a mesh (port of the sharded half): the signal's
time axis is split over the mesh's ``time`` axis, each rank fetches ``halo``
samples from both neighbours (one ``collectives.shift`` each way; zeros at
the global edges, so the global boundary is zero-padded, a linear
convolution), transforms its extended chunk against a bank synthesized at
that length, and keeps its central samples.  Results stay split over time.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.bank import WaveletDef, WaveletMode, make_fft_bank
from ..ops.cwt import cwt_from_bank, power_from_bank
from ..ops.grids import fft_bin_freqs
from . import collectives
from .mesh import TIME_AXIS, axis_size


def halo_samples(wdef: WaveletDef, min_freq: float, sfreq: float,
                 tol: float = 1e-4,
                 probe_seconds: Optional[float] = None) -> int:
    """Time-domain support (in samples) of the slowest analysis wavelet.

    Evaluates the frequency-domain formula at ``min_freq`` in float32 on a
    float32 probe grid (on the CPU), inverse-FFTs it in float64 with numpy,
    and returns the one-sided distance from the envelope peak at which the
    envelope has decayed below ``tol * max``: the halo that makes windowed
    == whole-signal at float32 in the interior.  The JAX package takes the
    same steps in the same precisions, so both give the same integer.

    Only Reverse/Both-mode families have a spectrum to probe; Normal/Twice
    families raise.
    """
    if wdef.mode not in (WaveletMode.Reverse, WaveletMode.Both):
        raise ValueError(
            f"halo_samples needs a Reverse/Both-mode wavelet (got "
            f"{wdef.mode}); Normal/Twice families are not supported for "
            "time-chunked processing")
    if probe_seconds is None:
        # Generous probe: >= 16 cycles of the slowest wavelet, >= 2 s.
        probe_seconds = max(16.0 / min_freq, 2.0)
    n = int(2 ** np.ceil(np.log2(sfreq * probe_seconds)))
    grid = fft_bin_freqs(n, sfreq, dtype=torch.float32, device="cpu")
    spec = wdef.trans_formula(grid, torch.tensor(min_freq,
                                                 dtype=torch.float32))
    w = np.fft.ifft(spec.numpy().astype(np.complex128))
    env = np.abs(w)
    peak = env.max()
    if peak == 0.0:
        return 1
    # The wavelet is centered at sample 0 with tails wrapping at both ends:
    # the circular distance from 0 of the farthest sample above tol.
    above = np.nonzero(env > tol * peak)[0]
    dist = np.minimum(above, n - above)
    return int(dist.max()) + 1


def pow2_halo(window: int, min_halo: int) -> int:
    """Smallest halo >= ``min_halo`` making ``window + 2*halo`` a power of
    two: the fused kernel takes power-of-two lengths only, and cuFFT is
    fastest there."""
    if window % 2:
        raise ValueError("window length must be even")
    ext = 1 << int(np.ceil(np.log2(window + 2 * min_halo)))
    return (ext - window) // 2


def chunk_bank(wdef: WaveletDef, freqs, chunk_len: int, halo: int,
               sfreq: float, interpolate: bool = False,
               device=None) -> torch.Tensor:
    """(F, chunk_len + 2*halo) bank for the extended chunks (float32 for a
    real family, complex64 for a Normal/Twice one)."""
    return make_fft_bank(wdef, torch.as_tensor(np.asarray(freqs, np.float32)),
                         chunk_len + 2 * halo, sfreq, interpolate,
                         device=device)


# -- time split over a mesh ---------------------------------------------------

def _exchange_halos(sig: torch.Tensor, halo: int, group) -> torch.Tensor:
    """Extend the local chunk with ``halo`` samples from each neighbour over
    the ``time`` group (zeros at the global edges): the ``ppermute`` pair,
    one exchange each way."""
    left = collectives.shift(sig[..., -halo:], group, +1)
    right = collectives.shift(sig[..., :halo], group, -1)
    return torch.cat([left, sig, right], dim=-1)


def _chunk_call(mesh, signal_r, bank_r, bank_i, halo, per_chunk):
    """``per_chunk(extended chunk, bank)`` on this rank's time block, the
    halo columns cropped from every output (a tensor or a tuple)."""
    from .sharded import _bank, _out, _sig
    ndim = signal_r.ndim
    sig = _sig(signal_r, mesh, (None,) * (ndim - 1) + (TIME_AXIS,))
    bank = _bank(mesh, bank_r, bank_i, spec=(None, None))
    ext = _exchange_halos(sig, halo, mesh.get_group(TIME_AXIS))
    out = per_chunk(ext, bank)
    spec = (None,) * ndim + (TIME_AXIS,)
    crop = [o[..., halo:o.shape[-1] - halo] for o in
            (out if isinstance(out, tuple) else (out,))]
    outs = tuple(_out(o, mesh, spec) for o in crop)
    return outs if isinstance(out, tuple) else outs[0]


def chunked_power(signal_r, bank_r, bank_i=None, *, mesh, halo: int,
                  interpolate: bool = False):
    """Sequence-parallel ``|cwt|**2``: (..., N) -> (..., F, N) float32 split
    over the mesh's ``time`` axis.  ``bank_r`` (with ``bank_i``, or a
    complex bank) is the extended-chunk bank of ``chunk_bank`` (last dim
    N / n_time + 2 * halo)."""
    return _chunk_call(mesh, signal_r, bank_r, bank_i, halo,
                       lambda ext, bank: power_from_bank(ext, bank,
                                                         interpolate))


def chunked_abs(signal_r, bank_r, bank_i=None, *, mesh, halo: int,
                interpolate: bool = False):
    """Sequence-parallel ``|cwt|``."""
    return _chunk_call(mesh, signal_r, bank_r, bank_i, halo,
                       lambda ext, bank: torch.abs(
                           cwt_from_bank(ext, bank, interpolate)))


def chunked_cwt_ri(signal_r, bank_r, bank_i=None, *, mesh, halo: int,
                   interpolate: bool = False):
    """Sequence-parallel raw coefficients as a (real, imag) pair."""
    def per_chunk(ext, bank):
        c = cwt_from_bank(ext, bank, interpolate)
        return c.real, c.imag

    return _chunk_call(mesh, signal_r, bank_r, bank_i, halo, per_chunk)


def chunked_fused_power(signal_r, bank_r, *, mesh, halo: int,
                        interpolate: bool = True, precision: str = "fast3"):
    """``chunked_power`` with the fused per-signal kernel (K4,
    ``ops.fused.fused_power_from_bank``) on each extended chunk: a real
    bank, and an extended length the kernel takes (a power of two in [256,
    32768]: ``pow2_halo`` sizes it so).  On the CPU the kernel's plain
    version."""
    from ..ops.fused import fused_power_from_bank
    return _chunk_call(mesh, signal_r, bank_r, None, halo,
                       lambda ext, bank: fused_power_from_bank(
                           ext, bank, interpolate, precision))


def chunked_power_auto(signal_r, bank_r, bank_i=None, *, mesh, halo: int,
                       interpolate: bool = False, precision: str = "fast3"):
    """``chunked_power`` with kernel dispatch: ``chunked_fused_power`` where
    ``ops.fused.route()`` launches the kernel on the extended chunk (on the
    card, a real bank, a supported length), ``chunked_power`` otherwise;
    the same result either way."""
    from ..ops.fused import route
    ext_len = signal_r.shape[-1] // axis_size(mesh, TIME_AXIS) + 2 * halo
    bank = bank_r if isinstance(bank_r, torch.Tensor) else \
        torch.as_tensor(np.asarray(bank_r))
    if bank_i is not None:            # a complex bank as a float pair
        bank = bank.to(torch.complex64)
    if route("power_each", (1, 1, ext_len), bank,
             device=mesh.device_type).launch:
        return chunked_fused_power(signal_r, bank_r, mesh=mesh, halo=halo,
                                   interpolate=interpolate,
                                   precision=precision)
    return chunked_power(signal_r, bank_r, bank_i, mesh=mesh, halo=halo,
                         interpolate=interpolate)
