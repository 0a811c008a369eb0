"""EDF recording reader (mmap + native gather) and a minimal writer (port
of ``ninwavelets_tpu.io.edf``).

European Data Format (EDF, Kemp et al. 1992) is the standard open
container for long EEG recordings: an ASCII header followed by data
records of interleaved 16-bit samples, each signal carrying its own
affine digital->physical calibration.  The reader parses the header in
Python (fixed-width ASCII) and leaves every touch of the sample area to
the native gathers (:mod:`ninwavelets_tpu_torch.io.native`) over a
``numpy.memmap``: whole-file loads and halo-window gathers never copy
through Python loops, and a streamed analysis never materializes the
recording.

``write_edf`` exists so round-trip tests and demos need no external
dependency; it writes the same subset the reader consumes (EDF, 16-bit,
uniform record duration).
"""
from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import numpy as np

from . import native

__all__ = ["EDFReader", "EDFRaw", "write_edf"]

_ANNOTATION_LABELS = {"EDF Annotations", "BDF Annotations"}


def _ascii(field: bytes) -> str:
    return field.decode("ascii", errors="replace").strip()


def _num(field: bytes, cast=float):
    s = _ascii(field)
    return cast(s) if s else cast(0)


class EDFReader:
    """Memory-mapped EDF file with native window gathers.

    Attributes
    ----------
    ch_names: data-signal labels (annotation signals excluded).
    sfreq: sampling rate shared by the data signals (a reader instance
        targets one rate; mixed-rate files raise unless ``picks`` at
        call time select a uniform subset — see ``pick``).
    n_samples: samples per data channel.
    """

    def __init__(self, path: str) -> None:
        self.path = os.fspath(path)
        with open(self.path, "rb") as f:
            head = f.read(256)
            if len(head) < 256:
                raise ValueError(f"{path}: truncated EDF header")
            self.version = _ascii(head[0:8])
            self.patient_id = _ascii(head[8:88])
            self.recording_id = _ascii(head[88:168])
            header_bytes = _num(head[184:192], int)
            self.n_records = _num(head[236:244], int)
            self.record_duration = _num(head[244:252], float)
            ns = _num(head[252:256], int)
            if ns <= 0:
                raise ValueError(f"{path}: no signals in header")
            sig = f.read(256 * ns)
            if len(sig) < 256 * ns:
                raise ValueError(f"{path}: truncated signal headers")

        # Signal-header layout: 16 label, 80 transducer, 8 dim, 8 pmin,
        # 8 pmax, 8 dmin, 8 dmax, 80 prefilter, 8 ns/record, 32 reserved
        # — concatenated PER FIELD (all labels, then all transducers, …),
        # not per signal.
        widths = [16, 80, 8, 8, 8, 8, 8, 80, 8, 32]
        names = ["label", "transducer", "dim", "pmin", "pmax", "dmin",
                 "dmax", "prefilter", "nsamp", "reserved"]
        byte_off = np.cumsum([0] + widths[:-1]) * ns
        raw_fields = {}
        for name, width, start in zip(names, widths, byte_off):
            start = int(start)
            raw_fields[name] = [sig[start + i * width: start + (i + 1) * width]
                                for i in range(ns)]

        labels = [_ascii(b) for b in raw_fields["label"]]
        pmin = np.array([_num(b) for b in raw_fields["pmin"]])
        pmax = np.array([_num(b) for b in raw_fields["pmax"]])
        dmin = np.array([_num(b) for b in raw_fields["dmin"]])
        dmax = np.array([_num(b) for b in raw_fields["dmax"]])
        nsamp = np.array([_num(b, int) for b in raw_fields["nsamp"]])
        units_all = [_ascii(b) for b in raw_fields["dim"]]

        self._all_labels = labels
        self._nsamp = nsamp
        self._rec_stride = int(nsamp.sum())
        self._ch_off_all = np.concatenate([[0], np.cumsum(nsamp)[:-1]])
        span = np.where(dmax > dmin, dmax - dmin, 1)
        self._scale_all = (pmax - pmin) / span
        self._dc_all = pmin - self._scale_all * dmin

        self._data_idx = [i for i, lab in enumerate(labels)
                          if lab not in _ANNOTATION_LABELS]
        if not self._data_idx:
            raise ValueError(f"{path}: only annotation signals present")
        self.ch_names = [labels[i] for i in self._data_idx]
        # aligned with ch_names (annotation signals filtered out too)
        self.units = [units_all[i] for i in self._data_idx]

        size = os.path.getsize(self.path)
        n_avail = (size - header_bytes) // 2 // max(self._rec_stride, 1)
        if self.n_records < 0:          # unknown length: trust the file
            self.n_records = int(n_avail)
        else:
            self.n_records = int(min(self.n_records, n_avail))
        self._mm = np.memmap(self.path, np.int16, mode="r",
                             offset=header_bytes,
                             shape=(self.n_records * self._rec_stride,))

        ns0 = nsamp[self._data_idx[0]]
        self._uniform = bool(
            np.all(nsamp[self._data_idx] == ns0))
        self._ns0 = int(ns0)
        if self.record_duration <= 0:
            raise ValueError(f"{path}: non-positive record duration")

    # ------------------------------------------------------ annotations
    def read_annotations(self):
        """EDF+ annotations as ``[(onset_s, duration_s, text), ...]``:
        the TAL byte streams of every annotation signal, parsed per
        record (``+onset[\x15duration]\x14text\x14...\x00``; the
        record-timekeeping TALs — empty text — are skipped)."""
        ann_idx = [i for i, lab in enumerate(self._all_labels)
                   if lab in _ANNOTATION_LABELS]
        out = []
        for ai in ann_idx:
            off = int(self._ch_off_all[ai])
            ns = int(self._nsamp[ai])
            for r in range(self.n_records):
                lo = r * self._rec_stride + off
                raw = self._mm[lo:lo + ns].tobytes()
                for tal in raw.split(b"\x00"):
                    if not tal or not tal[:1] in (b"+", b"-"):
                        continue
                    head, *texts = tal.split(b"\x14")
                    texts = [t for t in texts if t]
                    if not texts:
                        continue                  # timekeeping TAL
                    if b"\x15" in head:
                        o_b, d_b = head.split(b"\x15", 1)
                    else:
                        o_b, d_b = head, b""
                    try:
                        onset = float(o_b)
                        dur = float(d_b) if d_b else 0.0
                    except ValueError:
                        continue                  # malformed TAL
                    for t in texts:
                        out.append((onset, dur,
                                    t.decode("utf-8", "replace")))
        out.sort(key=lambda a: a[0])
        return out

    @property
    def markers(self):
        """Annotations in the marker convention shared with
        ``io.brainvision`` — ``[(sample, kind, text), ...]`` at this
        reader's (uniform) rate — so ``RawWavelet.epochs_from_markers``
        works identically on EDF+ and BrainVision files."""
        if not hasattr(self, "_markers"):
            sf = self.sfreq
            self._markers = [(int(round(o * sf)), "Annotation", txt)
                             for (o, d, txt) in self.read_annotations()]
        return self._markers

    # ------------------------------------------------------------ info
    @property
    def sfreq(self) -> float:
        if not self._uniform:
            raise ValueError("mixed sampling rates; use pick() to select "
                             "a uniform channel subset")
        return self._ns0 / self.record_duration

    @property
    def n_samples(self) -> int:
        if not self._uniform:
            raise ValueError("mixed sampling rates; use pick()")
        return self.n_records * self._ns0

    @property
    def duration(self) -> float:
        return self.n_records * self.record_duration

    def _indices(self, picks: Optional[Sequence] = None) -> list:
        if picks is None:
            idx = list(self._data_idx)
        else:
            idx = []
            for p in picks:
                if isinstance(p, str):
                    try:
                        k = self.ch_names.index(p)
                    except ValueError:
                        raise KeyError(f"channel {p!r} not in {self.path}")
                    idx.append(self._data_idx[k])
                else:
                    idx.append(self._data_idx[int(p)])
        ns = {int(self._nsamp[i]) for i in idx}
        if len(ns) != 1:
            raise ValueError(f"selected channels mix samples/record {ns}; "
                             "pick a uniform-rate subset")
        return idx

    def pick(self, picks: Sequence) -> "EDFPick":
        """A uniform-rate channel-subset view (for mixed-rate files)."""
        return EDFPick(self, picks)

    # ------------------------------------------------------------ data
    def get_data(self, picks: Optional[Sequence] = None) -> np.ndarray:
        """(C, N) float32 physical-units array (one native pass)."""
        idx = self._indices(picks)
        ns = int(self._nsamp[idx[0]])
        return native.edf_load(self._mm, self._rec_stride,
                               self._ch_off_all[idx], self._scale_all[idx],
                               self._dc_all[idx], ns,
                               self.n_records * ns)

    def gather(self, starts, window: int, halo: int,
               picks: Optional[Sequence] = None) -> np.ndarray:
        """(W, C, window+2*halo) float32 halo-padded window batch,
        gathered straight from the mmap (edges zero-padded)."""
        idx = self._indices(picks)
        ns = int(self._nsamp[idx[0]])
        return native.edf_gather(self._mm, self._rec_stride,
                                 self._ch_off_all[idx],
                                 self._scale_all[idx], self._dc_all[idx],
                                 ns, starts, window, halo,
                                 self.n_records * ns)


class EDFPick:
    """Uniform-rate channel subset of an :class:`EDFReader`."""

    def __init__(self, reader: EDFReader, picks: Sequence) -> None:
        self._r = reader
        self._picks = list(picks)
        idx = reader._indices(self._picks)
        self._ns = int(reader._nsamp[idx[0]])
        self.ch_names = [reader._all_labels[i] for i in idx]

    @property
    def sfreq(self) -> float:
        return self._ns / self._r.record_duration

    @property
    def n_samples(self) -> int:
        return self._r.n_records * self._ns

    def get_data(self) -> np.ndarray:
        return self._r.get_data(self._picks)

    def gather(self, starts, window: int, halo: int) -> np.ndarray:
        return self._r.gather(starts, window, halo, self._picks)


class EDFRaw:
    """``mne.io.Raw``-duck view of an EDF file, for :class:`RawWavelet`
    (``utils/mne_adapter.py``): exposes ``.info['sfreq']``,
    ``.ch_names`` and ``.get_data()`` without importing mne."""

    def __init__(self, path: str,
                 picks: Optional[Sequence] = None) -> None:
        self.reader = EDFReader(path)
        self._picks = picks
        src = self.reader if picks is None else self.reader.pick(picks)
        self.ch_names = list(src.ch_names)
        self.info = {"sfreq": float(src.sfreq)}
        self._src = src

    def get_data(self) -> np.ndarray:
        return (self.reader.get_data(self._picks)
                if self._picks is not None else self.reader.get_data())


def write_edf(path: str, data: np.ndarray, sfreq: float,
              ch_names: Optional[Sequence[str]] = None,
              units: str = "uV", record_duration: float = 1.0,
              patient_id: str = "X", recording_id: str = "X",
              start: Optional[datetime.datetime] = None,
              annotations=None) -> None:
    """Write a (C, N) array as a 16-bit EDF file.

    Per-channel calibration spans the data range, so quantization error
    is ``(max-min)/65535`` per channel.  ``sfreq * record_duration``
    must be an integer; the tail is padded to a whole record (EDF
    stores whole records only) with physical zero CLIPPED to the
    channel's calibrated range — a channel whose data never crosses
    zero pads at its nearest representable value.  Slicing off the pad
    is the caller's bookkeeping; ``n_records`` covers the padded length.

    ``annotations`` (optional): ``[(onset_s, duration_s, text), ...]``
    written as an EDF+ "EDF Annotations" TAL signal (the reserved
    header field then reads EDF+C); ``EDFReader.read_annotations`` /
    ``.markers`` round-trip them.
    """
    data = np.atleast_2d(np.asarray(data, np.float64))
    n_ch, n = data.shape
    ns = sfreq * record_duration
    if abs(ns - round(ns)) > 1e-9:
        raise ValueError(f"sfreq*record_duration={ns} is not an integer "
                         "samples-per-record")
    ns = int(round(ns))
    n_records = -(-n // ns)
    if ch_names is None:
        ch_names = [f"ch{i}" for i in range(n_ch)]
    if len(ch_names) != n_ch:
        raise ValueError("ch_names length mismatch")
    for name in ch_names:
        if name in _ANNOTATION_LABELS:
            raise ValueError(f"{name!r} is a reserved annotation label")

    def g8(v):
        """The most precise ASCII rendering of ``v`` that fits the
        8-byte header field (header rounding otherwise dominates the
        16-bit quantization error)."""
        for digits in range(8, 0, -1):
            s = "%.*g" % (digits, v)
            if len(s) <= 8:
                return s
        return "%.1g" % v

    def bound8(v, direction):
        """8-char-representable value ``<= v`` (direction -1) or
        ``>= v`` (+1) — the calibration must be what the header SAYS,
        and must still cover the data after rounding.  The nudge grows
        geometrically so the loop terminates even when the 8-char
        resolution is far coarser than ``|v| * 1e-6`` (e.g. 1e8-scale
        values render with 3 significant digits)."""
        p = float(g8(v))
        nudge = max(abs(v) * 1e-7, 1e-12)
        while (p - v) * direction < 0:
            p = float(g8(v + direction * nudge))
            nudge *= 10.0
        return p

    rd8 = g8(record_duration)
    if float(rd8) != record_duration:
        # Silent truncation would shift every derived sfreq: timing
        # drift across the recording.  Refuse instead.
        raise ValueError(
            f"record_duration={record_duration!r} does not fit the 8-char "
            f"EDF header field exactly (nearest: {rd8}); choose a "
            "representable duration")

    pmin = data.min(axis=1)
    pmax = data.max(axis=1)
    flat = pmax <= pmin
    pmax = np.where(flat, pmin + 1.0, pmax)
    pmin = np.array([bound8(v, -1) for v in pmin])
    pmax = np.array([bound8(v, +1) for v in pmax])
    dmin, dmax = -32768.0, 32767.0
    scale = (pmax - pmin) / (dmax - dmin)
    dig = np.rint((data - pmin[:, None]) / scale[:, None] + dmin)
    dig = np.clip(dig, dmin, dmax).astype(np.int16)
    pad = n_records * ns - n
    if pad:
        # zero PHYSICAL pad: digital value of physical 0 per channel
        zero_dig = np.clip(np.rint(-pmin / scale + dmin), dmin,
                           dmax).astype(np.int16)
        dig = np.concatenate(
            [dig, np.repeat(zero_dig[:, None], pad, axis=1)], axis=1)

    # ---- EDF+ annotation signal (TAL byte stream per record) -------
    ann_payloads, ann_ns = [], 0
    if annotations:
        def tnum(v):
            # full sub-second precision at ANY onset ("%g" keeps only
            # 6 significant digits — an 8-hour onset would round by
            # tens of ms) and never scientific notation (spec-invalid
            # inside TALs)
            out = ("%.6f" % float(v)).rstrip("0").rstrip(".")
            return (out or "0").encode("ascii")

        anns = sorted((float(o), float(d), str(t))
                      for (o, d, t) in annotations)
        rd = float(record_duration)
        total = n_records * rd
        for (o, d, t) in anns:
            if o < 0 or o > total:
                raise ValueError(
                    f"annotation onset {o} s outside the recording "
                    f"(0..{total} s) — it would be silently lost")
        buckets = [[] for _ in range(n_records)]
        for a in anns:
            buckets[min(int(a[0] // rd), n_records - 1)].append(a)
        for r in range(n_records):
            tal = b"+%s\x14\x14\x00" % tnum(r * rd)
            for (o, d, t) in buckets[r]:
                head_b = b"+%s" % tnum(o)
                if d:
                    head_b += b"\x15%s" % tnum(d)
                tal += head_b + b"\x14" + t.encode("utf-8") + b"\x14\x00"
            ann_payloads.append(tal)
        ann_ns = max((len(b) + 1) // 2 for b in ann_payloads) + 1
        ann_payloads = [b + b"\x00" * (2 * ann_ns - len(b))
                        for b in ann_payloads]
    n_all = n_ch + (1 if annotations else 0)

    start = start or datetime.datetime(2000, 1, 1)
    header_bytes = 256 + 256 * n_all

    def f(text, width):
        b = str(text).encode("ascii", errors="replace")[:width]
        return b + b" " * (width - len(b))

    all_names = list(ch_names) + (["EDF Annotations"]
                                  if annotations else [])
    all_units = [units] * n_ch + ([""] if annotations else [])
    all_pmin = list(pmin) + ([-1.0] if annotations else [])
    all_pmax = list(pmax) + ([1.0] if annotations else [])
    all_ns = [ns] * n_ch + ([ann_ns] if annotations else [])
    head = b"".join([
        f("0", 8), f(patient_id, 80), f(recording_id, 80),
        f(start.strftime("%d.%m.%y"), 8), f(start.strftime("%H.%M.%S"), 8),
        f(header_bytes, 8), f("EDF+C" if annotations else "", 44),
        f(n_records, 8),
        f(rd8, 8), f(n_all, 4)])
    sig = b"".join(
        [b"".join(f(nm, 16) for nm in all_names)]
        + [b"".join(f("", 80) for _ in range(n_all))]
        + [b"".join(f(u, 8) for u in all_units)]
        + [b"".join(f(g8(v), 8) for v in all_pmin)]
        + [b"".join(f(g8(v), 8) for v in all_pmax)]
        + [b"".join(f(int(dmin), 8) for _ in range(n_all))]
        + [b"".join(f(int(dmax), 8) for _ in range(n_all))]
        + [b"".join(f("", 80) for _ in range(n_all))]
        + [b"".join(f(v, 8) for v in all_ns)]
        + [b"".join(f("", 32) for _ in range(n_all))])
    assert len(head) == 256 and len(sig) == 256 * n_all

    # record-interleave: record r = ch0[r*ns:(r+1)*ns] .. chC-1[...]
    recs = dig.reshape(n_ch, n_records, ns).transpose(1, 0, 2)
    with open(path, "wb") as out:
        out.write(head)
        out.write(sig)
        if not annotations:
            out.write(np.ascontiguousarray(recs, dtype="<i2").tobytes())
        else:
            for r in range(n_records):
                out.write(np.ascontiguousarray(
                    recs[r], dtype="<i2").tobytes())
                out.write(ann_payloads[r])
