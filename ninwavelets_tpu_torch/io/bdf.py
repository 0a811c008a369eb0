"""BDF (BioSemi 24-bit) reader and writer (port of
``ninwavelets_tpu.io.bdf``; numpy only, its files and reads byte for byte
the JAX package's).

The BioSemi variant of EDF: identical header layout (version byte
``0xFF`` + "BIOSEMI"), 24-bit little-endian two's-complement samples
instead of 16-bit.  No native kernel: a channel read and a window gather
each decode their 3-byte samples with one vectorized ``uint8`` view
(``b0 + 256 b1 + 65536 b2`` with a sign fold) over every record and
channel they touch at once, then calibrate as ``seg * scale + dc`` on the
int32 decode, the JAX package's per-record arithmetic.

The reader mirrors ``io.edf.EDFReader``'s contract (``ch_names``,
``sfreq``, ``n_samples``, ``get_data``, ``pick``, ``gather``,
``markers``), so the generic streaming sources and
``RawWavelet``/``epochs_from_markers`` work unchanged; BDF ``Status``
trigger channels are exposed as data (BioSemi convention — extract
events from the low 16 bits yourself or via ``status_events``).

MAINTENANCE NOTE: the signal-header parse deliberately duplicates
``EDFReader``'s (same field layout) rather than refactoring the EDF
reader, which feeds the native int16 gather kernel and is left
untouched; a header-parsing fix over there must be mirrored here.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from .edf import _ANNOTATION_LABELS, _ascii, _num

__all__ = ["BDFReader", "BDFRaw", "write_bdf", "status_events"]


def _decode24(raw: np.ndarray) -> np.ndarray:
    """(..., 3k) uint8 -> (..., k) int32 little-endian 24-bit."""
    b = raw.reshape(raw.shape[:-1] + (-1, 3)).astype(np.int32)
    v = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16)
    return v - ((v >> 23) & 1) * (1 << 24)


class BDFReader:
    """Memory-mapped BDF recording (the EDFReader contract at 24-bit
    depth)."""

    def __init__(self, path: str) -> None:
        self.path = os.fspath(path)
        with open(self.path, "rb") as f:
            head = f.read(256)
            if len(head) < 256:
                raise ValueError(f"{path}: truncated BDF header")
            if head[0] != 0xFF or _ascii(head[1:8]) != "BIOSEMI":
                raise ValueError(f"{path}: not a BDF file (version "
                                 f"{head[:8]!r})")
            header_bytes = _num(head[184:192], int)
            self.n_records = _num(head[236:244], int)
            self.record_duration = _num(head[244:252], float)
            ns = _num(head[252:256], int)
            if ns <= 0:
                raise ValueError(f"{path}: no signals in header")
            sig = f.read(256 * ns)
        widths = [16, 80, 8, 8, 8, 8, 8, 80, 8, 32]
        names = ["label", "transducer", "dim", "pmin", "pmax", "dmin",
                 "dmax", "prefilter", "nsamp", "reserved"]
        byte_off = np.cumsum([0] + widths[:-1]) * ns
        fields = {}
        for nm, width, start in zip(names, widths, byte_off):
            start = int(start)
            fields[nm] = [sig[start + i * width: start + (i + 1) * width]
                          for i in range(ns)]
        labels = [_ascii(b) for b in fields["label"]]
        pmin = np.array([_num(b) for b in fields["pmin"]])
        pmax = np.array([_num(b) for b in fields["pmax"]])
        dmin = np.array([_num(b) for b in fields["dmin"]])
        dmax = np.array([_num(b) for b in fields["dmax"]])
        nsamp = np.array([_num(b, int) for b in fields["nsamp"]])
        self._all_labels = labels
        self._nsamp = nsamp
        self._rec_stride = int(nsamp.sum())           # samples / record
        self._ch_off = np.concatenate([[0], np.cumsum(nsamp)[:-1]])
        span = np.where(dmax > dmin, dmax - dmin, 1)
        self._scale = (pmax - pmin) / span
        self._dc = pmin - self._scale * dmin
        self._data_idx = [i for i, lab in enumerate(labels)
                          if lab not in _ANNOTATION_LABELS]
        if not self._data_idx:
            raise ValueError(f"{path}: only annotation signals present")
        self.ch_names = [labels[i] for i in self._data_idx]
        self.units = [_ascii(fields["dim"][i]) for i in self._data_idx]
        size = os.path.getsize(self.path)
        n_avail = (size - header_bytes) // 3 // max(self._rec_stride, 1)
        self.n_records = (int(n_avail) if self.n_records < 0
                          else int(min(self.n_records, n_avail)))
        self._mm = np.memmap(self.path, np.uint8, mode="r",
                             offset=header_bytes,
                             shape=(self.n_records * self._rec_stride
                                    * 3,))
        ns0 = nsamp[self._data_idx[0]]
        self._uniform = bool(np.all(nsamp[self._data_idx] == ns0))
        self._ns0 = int(ns0)
        if self.record_duration <= 0:
            raise ValueError(f"{path}: non-positive record duration")
        self.markers = []                  # contract parity with BV/EDF

    @property
    def sfreq(self) -> float:
        if not self._uniform:
            raise ValueError("mixed sampling rates; use pick()")
        return self._ns0 / self.record_duration

    @property
    def n_samples(self) -> int:
        if not self._uniform:
            raise ValueError("mixed sampling rates; use pick()")
        return self.n_records * self._ns0

    def _indices(self, picks: Optional[Sequence],
                 need_uniform: bool = True):
        if picks is None:
            idx = list(self._data_idx)
        else:
            idx = []
            for ch in picks:
                if isinstance(ch, (int, np.integer)):
                    if not 0 <= int(ch) < len(self.ch_names):
                        raise ValueError(f"channel index {ch} out of "
                                         "range")
                    idx.append(self._data_idx[int(ch)])
                    continue
                if ch not in self.ch_names:
                    raise ValueError(f"channel {ch!r} not in file")
                idx.append(self._data_idx[self.ch_names.index(ch)])
        if need_uniform:
            ns = self._nsamp[idx]
            if not np.all(ns == ns[0]):
                raise ValueError(
                    "selected channels mix samples/record "
                    f"({sorted(set(int(v) for v in ns))}); pick a "
                    "uniform-rate subset")
        return idx

    def _records(self, r0: int, r1: int, idx) -> np.ndarray:
        """(C, (r1 - r0) ns) int32 samples of absolute signals ``idx`` (one
        sample count ns) in records [r0, r1), decoded in one pass."""
        ns = int(self._nsamp[idx[0]])
        rows = np.asarray(self._mm[3 * r0 * self._rec_stride:
                                   3 * r1 * self._rec_stride]).reshape(
            r1 - r0, 3 * self._rec_stride)
        cols = (3 * self._ch_off[np.asarray(idx)][:, None]
                + np.arange(3 * ns)[None, :])             # (C, 3 ns)
        segs = _decode24(rows[:, cols])                    # (R, C, ns)
        return segs.transpose(1, 0, 2).reshape(len(idx), -1)

    def _channel(self, i: int) -> np.ndarray:
        """(N,) float32 calibrated samples of absolute signal i."""
        segs = self._records(0, self.n_records, [i])[0]
        return (segs * self._scale[i] + self._dc[i]).astype(np.float32)

    def get_data(self, picks: Optional[Sequence] = None) -> np.ndarray:
        idx = self._indices(picks)
        return np.stack([self._channel(i) for i in idx])

    def pick(self, picks: Sequence) -> "BDFPick":
        return BDFPick(self, picks)

    def gather(self, starts, window: int, halo: int,
               picks: Optional[Sequence] = None) -> np.ndarray:
        """(W, C, window+2*halo) float32 halo-padded batch (edges
        zero-padded), decoding only the needed records."""
        idx = self._indices(picks)
        ns = int(self._nsamp[idx[0]])
        n = self.n_records * ns
        ext = window + 2 * halo
        out = np.zeros((len(starts), len(idx), ext), np.float32)
        scale = self._scale[idx][:, None]
        dc = self._dc[idx][:, None]
        for w, s in enumerate(starts):
            lo = int(s) - halo
            hi = lo + ext
            clo, chi = max(lo, 0), min(hi, n)
            if chi <= clo:
                continue
            r0, r1 = clo // ns, (chi - 1) // ns + 1
            seg = self._records(r0, r1, idx)[:, clo - r0 * ns:chi - r0 * ns]
            out[w, :, clo - lo:chi - lo] = seg * scale + dc
        return out


class BDFPick:
    """Uniform-rate channel subset of a :class:`BDFReader`."""

    def __init__(self, reader: BDFReader, picks: Sequence) -> None:
        self._r = reader
        self._picks = list(picks)
        reader._indices(self._picks)
        self.ch_names = list(self._picks)

    @property
    def sfreq(self) -> float:
        idx = self._r._indices(self._picks)
        ns = self._r._nsamp[idx]
        if not np.all(ns == ns[0]):
            raise ValueError("picked channels have mixed rates")
        return float(ns[0] / self._r.record_duration)

    @property
    def n_samples(self) -> int:
        idx = self._r._indices(self._picks)
        return int(self._r.n_records * self._r._nsamp[idx[0]])

    def get_data(self) -> np.ndarray:
        return self._r.get_data(self._picks)

    def gather(self, starts, window: int, halo: int) -> np.ndarray:
        return self._r.gather(starts, window, halo, self._picks)


class BDFRaw:
    """``mne.io.Raw``-duck view of a BDF file for :class:`RawWavelet`."""

    def __init__(self, path: str,
                 picks: Optional[Sequence] = None) -> None:
        self.reader = BDFReader(path)
        self._picks = picks
        self.reader._indices(picks)
        self.ch_names = (list(picks) if picks is not None
                         else list(self.reader.ch_names))
        src = self.reader if picks is None else self.reader.pick(picks)
        self.info = {"sfreq": float(src.sfreq)}

    def get_data(self) -> np.ndarray:
        return self.reader.get_data(self._picks)


def status_events(status: np.ndarray, mask: int = 0xFFFF):
    """Event extraction from a BioSemi Status channel: every transition
    TO a nonzero masked trigger word (including one already active at
    sample 0 — recordings often start mid-trigger) ->
    ``[(sample, "Status", str(code)), ...]`` in the shared marker
    convention.  A falling transition between two nonzero codes emits
    the NEW code (the mne ``find_events`` consecutive behavior)."""
    code = np.asarray(np.rint(status), np.int64) & mask
    change = np.flatnonzero(np.diff(code) != 0) + 1
    out = [(0, "Status", str(int(code[0])))] if code[0] != 0 else []
    out += [(int(s), "Status", str(int(code[s])))
            for s in change if code[s] != 0]
    return out


def write_bdf(path: str, data: np.ndarray, sfreq: float,
              ch_names: Optional[Sequence[str]] = None,
              units: str = "uV",
              record_duration: float = 1.0) -> None:
    """Write a (C, N) array as a 24-bit BDF file (quantization error
    ``(max-min)/2^24`` per channel; tail padded to whole records with
    clipped physical zero, like ``write_edf``)."""
    data = np.atleast_2d(np.asarray(data, np.float64))
    n_ch, n = data.shape
    ns = sfreq * record_duration
    if abs(ns - round(ns)) > 1e-9:
        raise ValueError("sfreq*record_duration must be an integer")
    ns = int(round(ns))
    rd8 = "%.8g" % record_duration
    rd8 = rd8 if len(rd8) <= 8 else ("%.7g" % record_duration)[:8]
    if float(rd8) != record_duration:
        raise ValueError(
            f"record_duration={record_duration!r} does not fit the "
            f"8-char header field exactly (nearest: {rd8}) — the "
            "derived sfreq would drift; choose a representable "
            "duration")
    n_records = -(-n // ns)
    ch_names = (list(ch_names) if ch_names is not None
                else [f"ch{i}" for i in range(n_ch)])
    if len(ch_names) != n_ch:
        raise ValueError("ch_names length mismatch")

    def g8(v):
        for digits in range(8, 0, -1):
            s = "%.*g" % (digits, v)
            if len(s) <= 8:
                return s
        return "%.1g" % v

    def bound8(v, direction):
        p = float(g8(v))
        nudge = max(abs(v) * 1e-7, 1e-12)
        while (p - v) * direction < 0:
            p = float(g8(v + direction * nudge))
            nudge *= 10.0
        return p

    pmin = np.array([bound8(v, -1) for v in data.min(1)])
    pmax_raw = np.where(data.max(1) <= pmin, pmin + 1.0, data.max(1))
    pmax = np.array([bound8(v, +1) for v in pmax_raw])
    dmin, dmax = -8388608.0, 8388607.0
    scale = (pmax - pmin) / (dmax - dmin)
    dig = np.rint((data - pmin[:, None]) / scale[:, None] + dmin)
    dig = np.clip(dig, dmin, dmax).astype(np.int32)
    pad = n_records * ns - n
    if pad:
        zero = np.clip(np.rint(-pmin / scale + dmin), dmin,
                       dmax).astype(np.int32)
        dig = np.concatenate(
            [dig, np.repeat(zero[:, None], pad, axis=1)], axis=1)

    header_bytes = 256 + 256 * n_ch

    def f(text, width):
        b = str(text).encode("latin-1", errors="replace")[:width]
        return b + b" " * (width - len(b))

    head = b"\xffBIOSEMI" + b"".join([
        f("X", 80), f("X", 80), f("01.01.00", 8), f("00.00.00", 8),
        f(header_bytes, 8), f("24BIT", 44), f(n_records, 8),
        f(rd8, 8), f(n_ch, 4)])
    sig = b"".join(
        [b"".join(f(nm, 16) for nm in ch_names)]
        + [b"".join(f("", 80) for _ in range(n_ch))]
        + [b"".join(f(units, 8) for _ in range(n_ch))]
        + [b"".join(f(g8(v), 8) for v in pmin)]
        + [b"".join(f(g8(v), 8) for v in pmax)]
        + [b"".join(f(int(dmin), 8) for _ in range(n_ch))]
        + [b"".join(f(int(dmax), 8) for _ in range(n_ch))]
        + [b"".join(f("", 80) for _ in range(n_ch))]
        + [b"".join(f(ns, 8) for _ in range(n_ch))]
        + [b"".join(f("", 32) for _ in range(n_ch))])
    assert len(head) == 256 and len(sig) == 256 * n_ch
    recs = dig.reshape(n_ch, n_records, ns).transpose(1, 0, 2)
    flat = recs.reshape(-1).astype(np.int64)
    flat = np.where(flat < 0, flat + (1 << 24), flat)
    by = np.empty((flat.size, 3), np.uint8)
    by[:, 0] = flat & 0xFF
    by[:, 1] = (flat >> 8) & 0xFF
    by[:, 2] = (flat >> 16) & 0xFF
    with open(path, "wb") as out:
        out.write(head)
        out.write(sig)
        out.write(by.tobytes())
