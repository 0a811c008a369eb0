"""Halo geometry of the overlap-discard long-recording paths (port of the
single-device parts of ``ninwavelets_tpu.parallel.chunked``).

A long recording is cut into windows, each extended by ``halo`` samples of
real signal on both sides and convolved against a bank synthesized at the
extended length; the halos are discarded.  The interiors match the
whole-signal transform to float32 for any wavelet whose time support fits in
the halo (``halo_samples``).  The bank grid maps bin i to ``i * sfreq / n``
for any n (``ops.grids.fft_bin_freqs``), so the same transfer function is
sampled at window resolution.

The multi-device chunked transform (time sharded over a mesh, halos
exchanged between neighbours) waits for the multi-GPU slice.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.bank import WaveletDef, WaveletMode, make_fft_bank
from ..ops.grids import fft_bin_freqs


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
