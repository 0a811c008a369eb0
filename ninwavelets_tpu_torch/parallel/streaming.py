"""Single-device streaming CWT for recordings too long for one FFT (port of
``ninwavelets_tpu.parallel.streaming``).

Overlap-discard convolution over fixed-size windows: each window is
extended by ``halo`` samples of real signal on both sides, convolved
against a bank synthesized at the extended length, and the halos are
discarded.  The interiors match the whole-signal transform to float32 for
any wavelet whose time support fits in the halo (``halo_samples``); the
global edges are zero-padded (linear convolution).

A batch of windows, with any channel dims riding along, is one call of
``ops.fused.fused_power_from_bank`` (the "power_each" kernel on the card)
or of the plain ``ops.cwt.power_from_bank``.  ``power_device`` pastes each
batch into a (..., F, N) plane preallocated on the device; ``blocks`` and
``power`` hand host numpy back, as the JAX package does.
``ssq_power_device`` does the same with synchrosqueezed power: one call of
``ops.fused.fused_ssq_power_from_bank`` (the "amax" and synchrosqueezing
kernels) per batch when the stream is fused and the grid has a single
"lin" or "log" row map, of the plain ``ops.sst.ssq_power_from_bank``
otherwise.
"""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..io.stream import ArraySource, iter_ext_batches
from ..ops.bank import WaveletDef, make_fft_bank
from ..ops.cwt import power_from_bank
from ..ops.fused import (fused_power_from_bank, fused_ssq_power_from_bank,
                         supports, supports_ssq)
from ..ops.sst import ssq_power_from_bank, uniform_grid_hint
from .chunked import halo_samples, pow2_halo


def _window_power(ext: torch.Tensor, bank: torch.Tensor, halo: int,
                  interpolate: bool) -> torch.Tensor:
    """|cwt|^2 of extended windows, halos discarded: (..., L+2h) ->
    (..., F, L), the plain path (a view of the full plane)."""
    p = power_from_bank(ext, bank, interpolate)
    return p[..., halo:p.shape[-1] - halo]


def _window_power_fused(ext: torch.Tensor, bank: torch.Tensor, halo: int,
                        interpolate: bool, precision: str) -> torch.Tensor:
    """The same through ``fused_power_from_bank``: the window batch and
    every channel flatten onto the kernel's signal axis."""
    p = fused_power_from_bank(ext, bank, interpolate, precision)
    return p[..., halo:p.shape[-1] - halo]


class StreamingCWT:
    """Overlap-discard streaming power TFR over an arbitrarily long signal.

    Parameters
    ----------
    wdef: the wavelet definition (``WaveletBase._wdef()`` or a raw
        ``WaveletDef``), a Reverse/Both-mode family for the default halo.
    freqs: analysis frequencies (Hz).
    sfreq: sampling frequency (Hz).
    window: window length in samples.
    halo: overlap in samples; by default derived from the wavelet's
        envelope decay at the lowest analysis frequency (``halo_tol``).
        Either way it is then rounded UP so that the extended window
        ``window + 2*halo`` is a power of two (``pow2_halo``).
    interpolate: the reference's analytic / Nyquist-alias trick.
    use_fused: "auto" (the kernel when the device is CUDA, the bank is
        real and ``supports()`` takes the extended window), True (the
        fused wrapper; raises on a geometry or bank the kernel rejects, and
        runs its plain version on the CPU), or False (the plain path).
    batch: windows per device call, as the caller gives it.
    device: where the bank and the planes live (the card by default).
    """

    def __init__(self, wdef: WaveletDef, freqs, sfreq: float,
                 window: int = 65536, halo: Optional[int] = None,
                 interpolate: bool = False, halo_tol: float = 1e-4,
                 use_fused="auto", batch: int = 8,
                 precision: str = "fast3", device=None) -> None:
        self.wdef = wdef
        self.freqs = np.asarray(freqs, dtype=np.float32)
        self.sfreq = float(sfreq)
        self.window = int(window)
        self.device = resolve_device(device)
        if halo is None:
            halo = halo_samples(wdef, float(self.freqs.min()), self.sfreq,
                                tol=halo_tol)
        if halo >= self.window:
            raise ValueError(f"halo {halo} must be smaller than the window "
                             f"{self.window}; raise `window` or `halo_tol`")
        self.halo = pow2_halo(self.window, int(halo))
        self.interpolate = interpolate
        self.batch = max(int(batch), 1)
        self.precision = precision
        ext = self.window + 2 * self.halo
        self._bank = make_fft_bank(wdef, self.freqs, ext, self.sfreq,
                                   interpolate, device=self.device)
        conforms = supports((1, 1, ext), self._bank)
        if use_fused == "auto":
            self._fused = conforms and self.device.type == "cuda"
        elif use_fused:
            if not conforms:
                raise ValueError(
                    f"fused streaming needs a real bank and an extended "
                    f"window (window + 2*halo = {ext}) that is a power of "
                    f"two in [256, 16384]")
            self._fused = True
        else:
            self._fused = False

    def _window_batch(self, ext: torch.Tensor) -> torch.Tensor:
        """(W, ..., ext) on the device -> (W, ..., F, window), fused or
        plain."""
        if self._fused:
            return _window_power_fused(ext, self._bank, self.halo,
                                       self.interpolate, self.precision)
        return _window_power(ext, self._bank, self.halo, self.interpolate)

    def _device_power(self, ext_batch: np.ndarray) -> np.ndarray:
        """(W, ..., ext) host batch -> (W, ..., F, window) host power."""
        ext = torch.from_numpy(ext_batch).to(self.device)
        return self._window_batch(ext).cpu().numpy()

    def blocks(self, signal: np.ndarray) -> Iterator[Tuple[int, np.ndarray]]:
        """Yield ``(start_sample, (..., F, block_len) power)`` blocks in
        order.

        The signal is consumed ``batch`` windows at a time (one device call
        per batch); edges are zero-padded.  The final block may be shorter
        than ``window``.
        """
        signal = np.asarray(signal, dtype=np.float32)
        n = signal.shape[-1]
        for batch_starts, ext in self._ext_batches(signal):
            block = self._device_power(ext)
            for row, start in enumerate(batch_starts):
                stop = min(start + self.window, n)
                yield start, block[row][..., :stop - start]

    def _ext_batches(self, signal: np.ndarray):
        """``(batch_starts, (batch, ..., window + 2*halo) ext)`` groups of
        an in-memory signal, always of the full batch shape (unused rows of
        the last group stay zero)."""
        return self._source_batches(ArraySource(signal))

    def _source_batches(self, source):
        """``(batch_starts, ext)`` groups from any ``io.stream`` source
        (an in-memory array, an mmap'd EDF file)."""
        return iter_ext_batches(source, self.window, self.halo, self.batch)

    def power(self, signal: np.ndarray) -> np.ndarray:
        """Full (..., F, N) power TFR assembled on the host from streamed
        blocks (``signal`` may carry leading channel dims; they ride the
        device batch beside the windows)."""
        signal = np.asarray(signal, dtype=np.float32)
        out = np.empty(signal.shape[:-1]
                       + (self.freqs.shape[0], signal.shape[-1]),
                       dtype=np.float32)
        for start, block in self.blocks(signal):
            out[..., start:start + block.shape[-1]] = block
        return out

    def power_device(self, signal: np.ndarray) -> torch.Tensor:
        """Full (..., F, N) power TFR assembled ON the device: one
        slice assignment per window batch (a batch's windows are
        contiguous in time)."""
        return self.power_device_source(ArraySource(signal))

    def power_device_source(self, source) -> torch.Tensor:
        """``power_device`` over any :mod:`ninwavelets_tpu_torch.io` source,
        e.g. ``io.EDFSource(path)`` streams a recording straight off the
        file mmap, window batch by window batch; the gather of batch ``i+1``
        runs on a worker thread while the device computes batch ``i``."""
        return self._assemble(source, self._window_batch)

    def ssq_power_device(self, signal: np.ndarray,
                         rel_threshold: float = 1e-6) -> torch.Tensor:
        """(..., F, N) synchrosqueezed power of an arbitrarily long
        recording, assembled on the device: frequency reassignment is local
        in time, so the overlap-discard windows apply as for
        ``power_device``.

        The noise-gate floor (``rel_threshold`` x peak power) is evaluated
        per window and channel, not over the whole recording, as in the JAX
        package.  The zero-filled windows of a ragged last batch give zero
        planes (floor 0, omega 0, row 0, power 0).  Real banks only."""
        if self._bank.is_complex():
            raise ValueError(
                "synchrosqueezing needs an analytic (real-bank) family")
        hint = uniform_grid_hint(self.freqs)
        ext = self.window + 2 * self.halo
        fused = self._fused and supports_ssq((1, 1, ext), self._bank, hint,
                                             self.interpolate)

        def window_fn(x):
            if fused:
                p = fused_ssq_power_from_bank(
                    x, self._bank, uniform_grid=hint, sfreq=self.sfreq,
                    rel_threshold=rel_threshold,
                    interpolate=self.interpolate)
            else:
                p = ssq_power_from_bank(x, self._bank, self.freqs,
                                        self.sfreq, self.interpolate,
                                        rel_threshold, hint)
            return p[..., self.halo:ext - self.halo]

        return self._assemble(ArraySource(signal), window_fn)

    def _assemble(self, source, window_fn) -> torch.Tensor:
        """The (..., F, N) plane of ``window_fn`` over the window batches of
        ``source``: ``window_fn`` maps a (W, ..., ext) batch on the device
        to its (W, ..., F, window) cropped block.

        The plane is preallocated as (..., F, n_batches * batch * window)
        and returned as the view of its first N samples: the block of each
        batch lands as one (..., F, W * window) slab, with the crop and the
        transpose in the one copy."""
        n = int(source.n_samples)
        lead = tuple(source.lead)
        span = self.batch * self.window
        n_batches = -(-n // span)
        buf = torch.empty(lead + (self.freqs.shape[0], n_batches * span),
                          dtype=torch.float32, device=self.device)
        for batch_starts, ext in self._source_batches(source):
            block = window_fn(torch.from_numpy(ext).to(self.device))
            start = batch_starts[0]
            buf[..., start:start + span].unflatten(
                -1, (self.batch, self.window)).copy_(block.movedim(0, -2))
        return buf[..., :n]
