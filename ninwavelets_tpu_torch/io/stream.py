"""Window sources and the prefetching batch iterator of the streamed
analysis (port of ``ninwavelets_tpu.io.stream``).

A *source* is something a halo-padded window batch can be cut from: an
in-memory array (:class:`ArraySource`) or an EDF file on disk
(:class:`EDFSource`).  ``iter_ext_batches`` turns a source into the
``(batch_starts, ext)`` groups :class:`parallel.streaming.StreamingCWT`
consumes, double-buffered: while the card computes batch *i*, a worker
thread gathers batch *i+1* (the native gathers release the GIL for the
whole call, so the overlap is real parallelism).

Geometry contract (shared with ``StreamingCWT._ext_batches``): batch
row ``w`` covers samples ``[starts[w]-halo, starts[w]+window+halo)``
zero-padded outside ``[0, n_samples)``; a ragged final group keeps the
full batch shape with all-zero unused rows.  ``OnlineCWT`` relies on it:
a window sits at the same batch row whether it is streamed or pushed.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from ..utils.observability import span
from . import native

__all__ = ["ArraySource", "EDFSource", "iter_ext_batches"]


class ArraySource:
    """Source over an in-memory ``(..., N)`` float array (any leading
    channel dims ride along, matching ``StreamingCWT``'s batching)."""

    def __init__(self, signal: np.ndarray) -> None:
        self.signal = np.ascontiguousarray(signal, np.float32)
        self.lead = self.signal.shape[:-1]
        self.n_samples = int(self.signal.shape[-1])

    def gather(self, starts: Sequence[int], window: int,
               halo: int) -> np.ndarray:
        flat = self.signal.reshape(-1, self.n_samples)
        out = native.f32_gather(flat, starts, window, halo)
        return out.reshape((len(starts),) + self.lead + (out.shape[-1],))


class EDFSource:
    """Source over an EDF file: windows are gathered straight off the
    mmap per batch, so the recording is never materialized in host
    memory."""

    def __init__(self, reader, picks: Optional[Sequence] = None) -> None:
        # reader: EDFReader, EDFPick, or a path
        if isinstance(reader, (str, bytes)) or hasattr(reader, "__fspath__"):
            from .edf import EDFReader
            reader = EDFReader(reader)
        self.reader = reader
        self._picks = picks
        if picks is not None and not hasattr(reader, "pick"):
            raise ValueError(
                f"{type(reader).__name__} cannot re-pick channels; pass "
                "picks to EDFReader.pick()/EDFSource(EDFReader(...)) "
                "instead of wrapping an already-picked view")
        if picks is not None:
            src = reader.pick(picks)
            self.sfreq = float(src.sfreq)
            self.n_samples = int(src.n_samples)
            self.lead = (len(src.ch_names),)
            self._gather = src.gather
        else:
            self.sfreq = float(reader.sfreq)
            self.n_samples = int(reader.n_samples)
            self.lead = (len(reader.ch_names),)
            self._gather = reader.gather

    def gather(self, starts: Sequence[int], window: int,
               halo: int) -> np.ndarray:
        return self._gather(starts, window, halo)


def iter_ext_batches(source, window: int, halo: int, batch: int,
                     prefetch: bool = True,
                     ) -> Iterator[Tuple[list, np.ndarray]]:
    """Yield ``(batch_starts, (batch,) + lead + (window+2*halo,) ext)``
    groups covering ``[0, source.n_samples)`` in ``window`` steps.

    With ``prefetch`` (default), group ``i+1`` is gathered on a worker
    thread while group ``i`` is consumed, so the gather hides behind the
    consumer's device work.  The consumer's wait for a group (its gather,
    without prefetch) is the span ``ninw.stream.wait``, closed before the
    group is yielded.
    """
    n = int(source.n_samples)
    lead = tuple(source.lead)
    ext_len = window + 2 * halo
    starts = list(range(0, n, window))
    groups = [starts[g:g + batch] for g in range(0, len(starts), batch)]

    def make(group: list) -> np.ndarray:
        got = source.gather(group, window, halo)
        if len(group) == batch:
            return np.ascontiguousarray(got, np.float32)
        ext = np.zeros((batch,) + lead + (ext_len,), np.float32)
        ext[:len(group)] = got
        return ext

    if not prefetch or len(groups) <= 1:
        for group in groups:
            with span("ninw.stream.wait"):
                ext = make(group)
            yield group, ext
        return

    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(make, groups[0])
        for i, group in enumerate(groups):
            with span("ninw.stream.wait"):
                ext = fut.result()
            if i + 1 < len(groups):
                fut = pool.submit(make, groups[i + 1])
            yield group, ext
