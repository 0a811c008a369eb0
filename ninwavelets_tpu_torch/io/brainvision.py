"""BrainVision (.vhdr/.eeg/.vmrk) reader and writer (port of
``ninwavelets_tpu.io.brainvision``; numpy only, its files and reads byte
for byte the JAX package's).

The second ubiquitous EEG interchange format next to EDF
(``io/edf.py``): a tiny INI-style text header, a flat binary data file
(float32 or int16, multiplexed or vectorized), and an optional marker
file.  Both binary layouts memory-map directly:

* MULTIPLEXED (sample-major, the common case): a (W,) window gather is
  ONE contiguous mmap slice reshaped (win, C) and transposed — no
  native kernel needed (the EDF record interleaving is what forced the
  C++ gather there);
* VECTORIZED (channel-major): per-channel contiguous slices.

Markers parse to ``(sample, type, description)`` tuples — feed
``RawWavelet.epochs`` for stimulus-locked epoching straight off the
file.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from .stream import EDFSource

__all__ = ["BVReader", "BVPick", "BVRaw", "BVSource",
           "read_markers", "read_marker_spans", "write_brainvision"]

_FORMATS = {"IEEE_FLOAT_32": np.float32, "INT_16": np.int16,
            "INT_32": np.int32}


def _parse_ini(path):
    """Minimal INI parse into {section: {key: value}} — deliberately
    NOT configparser: real vendor .vhdr files ship a [Comment] section
    full of free-form amplifier-setup text (no key=value shape) that
    makes configparser raise, and '%' in values trips its
    interpolation.  Lines without '=' are simply skipped; keys stay
    case-sensitive; ';' lines are comments."""
    out, sec = {}, None
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith(";"):
                continue
            if line.startswith("[") and line.endswith("]"):
                sec = line[1:-1]
                out.setdefault(sec, {})
            elif "=" in line and sec is not None:
                key, val = line.split("=", 1)
                out[sec][key.strip()] = val.strip()
    return out


class BVReader:
    """Memory-mapped BrainVision recording.

    Attributes: ``ch_names``, ``sfreq``, ``n_samples``, ``units``
    (per channel), ``markers`` (list of (sample, type, description) —
    empty when no .vmrk is present or referenced).
    """

    def __init__(self, vhdr_path: str) -> None:
        self.path = os.fspath(vhdr_path)
        cp = _parse_ini(self.path)
        if "Common Infos" not in cp:
            raise ValueError(f"{vhdr_path}: no [Common Infos] section")
        ci = cp["Common Infos"]
        fmt = ci.get("DataFormat", "BINARY").upper()
        if fmt != "BINARY":
            raise ValueError(f"{vhdr_path}: only BINARY DataFormat is "
                             f"supported, got {fmt}")
        self.orientation = ci.get("DataOrientation",
                                  "MULTIPLEXED").upper()
        if self.orientation not in ("MULTIPLEXED", "VECTORIZED"):
            raise ValueError(f"unknown DataOrientation "
                             f"{self.orientation}")
        n_ch = int(ci["NumberOfChannels"])
        # SamplingInterval is in MICROSECONDS
        self.sfreq = 1e6 / float(ci["SamplingInterval"])
        binfmt = cp.get("Binary Infos", {}).get(
            "BinaryFormat", "IEEE_FLOAT_32").upper()
        if binfmt not in _FORMATS:
            raise ValueError(f"unsupported BinaryFormat {binfmt}")
        self._dtype = _FORMATS[binfmt]

        self.ch_names, self.units = [], []
        res = np.ones(n_ch, np.float64)
        chsec = cp.get("Channel Infos", {})
        for i in range(n_ch):
            raw = chsec.get(f"Ch{i + 1}", f"ch{i + 1},,1,uV")
            parts = (raw.split(",") + ["", "1", "uV"])[:4]
            name = parts[0].replace("\\1", ",").strip() or f"ch{i + 1}"
            self.ch_names.append(name)
            res[i] = float(parts[2]) if parts[2].strip() else 1.0
            self.units.append(parts[3].strip() or "uV")
        self._res = res

        base = os.path.dirname(self.path)
        data_file = ci.get("DataFile", "").replace(
            "$b", os.path.splitext(os.path.basename(self.path))[0])
        self.data_path = os.path.join(base, data_file)
        itemsize = np.dtype(self._dtype).itemsize
        total = os.path.getsize(self.data_path) // itemsize
        self.n_samples = total // n_ch
        self._mm = np.memmap(self.data_path, self._dtype, mode="r",
                             shape=(total // n_ch * n_ch,))
        self._n_ch = n_ch

        self.markers = []
        self._marker_spans = []
        marker_file = ci.get("MarkerFile", "")
        if marker_file:
            mpath = os.path.join(base, marker_file.replace(
                "$b", os.path.splitext(os.path.basename(self.path))[0]))
            if os.path.exists(mpath):
                # one parse; markers is the size-less view of spans
                self._marker_spans = read_marker_spans(mpath)
                self.markers = [(p, t, d) for (p, _, t, d)
                                in self._marker_spans]

    def read_annotations(self):
        """[(onset_s, duration_s, text), ...] — the EDF+ annotation
        convention off the .vmrk markers (size field = duration in data
        points), so ``RawWavelet.epochs(reject_annotations="bad")``
        works identically on BrainVision and EDF+ recordings.  Text is
        ``"type: description"`` (or just the type), so the standard
        "Bad Interval" markers match a ``"bad"`` prefix whatever their
        description says."""
        return [(pos / self.sfreq, size / self.sfreq,
                 f"{t}: {d}" if d else t)
                for (pos, size, t, d) in self._marker_spans]

    def _indices(self, picks: Optional[Sequence]):
        if picks is None:
            return np.arange(self._n_ch)
        idx = []
        for ch in picks:
            if ch not in self.ch_names:
                raise ValueError(f"channel {ch!r} not in file")
            idx.append(self.ch_names.index(ch))
        return np.asarray(idx, int)

    def get_data(self, picks: Optional[Sequence] = None) -> np.ndarray:
        """(C, N) float32 calibrated data (resolution applied)."""
        idx = self._indices(picks)
        n, c = self.n_samples, self._n_ch
        if self.orientation == "MULTIPLEXED":
            arr = np.asarray(self._mm[:n * c]).reshape(n, c).T[idx]
        else:
            arr = np.asarray(self._mm[:n * c]).reshape(c, n)[idx]
        return (arr * self._res[idx, None]).astype(np.float32)

    def pick(self, picks: Sequence) -> "BVPick":
        """Channel-subset view (the EDFReader.pick contract)."""
        return BVPick(self, picks)

    def gather(self, starts, window: int, halo: int,
               picks: Optional[Sequence] = None) -> np.ndarray:
        """(W, C, window+2*halo) float32 halo-padded window batch off
        the mmap (edges zero-padded), the streaming-source contract."""
        idx = self._indices(picks)
        n, c = self.n_samples, self._n_ch
        ext = window + 2 * halo
        out = np.zeros((len(starts), len(idx), ext), np.float32)
        for w, s in enumerate(starts):
            lo = int(s) - halo
            hi = lo + ext
            clo, chi = max(lo, 0), min(hi, n)
            if chi <= clo:
                continue
            if self.orientation == "MULTIPLEXED":
                seg = np.asarray(
                    self._mm[clo * c:chi * c]).reshape(-1, c).T[idx]
            else:
                seg = np.stack([
                    np.asarray(self._mm[i * n + clo:i * n + chi])
                    for i in idx])
            out[w, :, clo - lo:chi - lo] = seg * self._res[idx, None]
        return out


class BVPick:
    """Channel-subset view of a :class:`BVReader` (the same contract
    as ``io.edf.EDFPick``, so the generic streaming sources and
    ``RawWavelet._file_source`` treat both formats identically)."""

    def __init__(self, reader: BVReader, picks: Sequence) -> None:
        self._r = reader
        self._picks = list(picks)
        reader._indices(self._picks)           # validate now
        self.ch_names = list(self._picks)

    @property
    def sfreq(self) -> float:
        return float(self._r.sfreq)

    @property
    def n_samples(self) -> int:
        return int(self._r.n_samples)

    def get_data(self) -> np.ndarray:
        return self._r.get_data(self._picks)

    def gather(self, starts, window: int, halo: int) -> np.ndarray:
        return self._r.gather(starts, window, halo, self._picks)


class BVSource(EDFSource):
    """Streaming source over a BrainVision file — the same generic
    reader-wrapping source as ``io.stream.EDFSource`` (BVReader/BVPick
    satisfy the identical pick/gather/sfreq/n_samples contract; this
    subclass only turns a .vhdr path into a reader first)."""

    def __init__(self, reader, picks: Optional[Sequence] = None) -> None:
        if isinstance(reader, (str, bytes)) or hasattr(reader,
                                                       "__fspath__"):
            reader = BVReader(reader)
        super().__init__(reader, picks)


class BVRaw:
    """``mne.io.Raw``-duck view of a BrainVision file for
    :class:`RawWavelet` (mirrors ``io.edf.EDFRaw``)."""

    def __init__(self, vhdr_path: str,
                 picks: Optional[Sequence] = None) -> None:
        self.reader = BVReader(vhdr_path)
        self._picks = picks
        self.ch_names = (list(picks) if picks is not None
                         else list(self.reader.ch_names))
        self.reader._indices(picks)            # validate now
        self.info = {"sfreq": float(self.reader.sfreq)}

    def get_data(self) -> np.ndarray:
        return self.reader.get_data(self._picks)


def read_markers(vmrk_path: str):
    """Parse a .vmrk file to ``[(sample, type, description), ...]``
    (0-based samples; BrainVision positions are 1-based).  Commas
    inside type/description use the format's ``\1`` escape; a marker
    whose position field does not parse is SKIPPED (never silently
    mapped to sample 0).  Thin view over :func:`read_marker_spans`
    (ONE parser — the two surfaces must never drift)."""
    return [(p, t, d) for (p, _, t, d) in read_marker_spans(vmrk_path)]


def read_marker_spans(vmrk_path: str):
    """Like :func:`read_markers` but keeps the SIZE field:
    ``[(sample, size_in_samples, type, description), ...]`` — the
    duration carrier for "Bad Interval" markers (a missing/invalid size
    counts as 1 sample, the format's minimum)."""
    cp = _parse_ini(vmrk_path)
    out = []
    sec = cp.get("Marker Infos", {})
    i = 1
    while f"Mk{i}" in sec:
        parts = sec[f"Mk{i}"].split(",")
        if len(parts) >= 3:
            try:
                pos = int(parts[2]) - 1
            except ValueError:
                i += 1
                continue
            try:
                size = max(int(parts[3]), 1) if len(parts) > 3 else 1
            except ValueError:
                size = 1
            out.append((pos, size,
                        parts[0].replace("\\1", ",").strip(),
                        parts[1].replace("\\1", ",").strip()))
        i += 1
    return out


def write_brainvision(vhdr_path: str, data: np.ndarray, sfreq: float,
                      ch_names: Optional[Sequence[str]] = None,
                      orientation: str = "MULTIPLEXED",
                      binary_format: str = "IEEE_FLOAT_32",
                      resolution: float = 1.0,
                      markers=None) -> None:
    """Write (C, N) data as a BrainVision triplet (.vhdr + .eeg and,
    when ``markers`` is given, .vmrk).  ``resolution`` divides the data
    before storage (and is recorded per channel, so reads calibrate
    back); INT_16 quantizes to ``resolution``-sized steps."""
    data = np.atleast_2d(np.asarray(data, np.float64))
    c, n = data.shape
    ch_names = (list(ch_names) if ch_names is not None
                else [f"ch{i + 1}" for i in range(c)])
    if len(ch_names) != c:
        raise ValueError("ch_names length must match channel count")
    orientation = orientation.upper()
    if orientation not in ("MULTIPLEXED", "VECTORIZED"):
        raise ValueError("orientation must be MULTIPLEXED or VECTORIZED")
    if binary_format.upper() not in _FORMATS:
        raise ValueError(f"binary_format must be one of {_FORMATS}")
    dtype = _FORMATS[binary_format.upper()]
    base = os.path.splitext(os.fspath(vhdr_path))[0]
    eeg_path = base + ".eeg"
    vmrk_path = base + ".vmrk"

    scaled = data / resolution
    if dtype != np.float32:
        info = np.iinfo(dtype)
        scaled = np.clip(np.round(scaled), info.min, info.max)
    arr = scaled.astype(dtype)
    if orientation == "MULTIPLEXED":
        arr = np.ascontiguousarray(arr.T)
    arr.tofile(eeg_path)

    lines = ["BrainVision Data Exchange Header File Version 1.0", "",
             "[Common Infos]",
             f"DataFile={os.path.basename(eeg_path)}"]
    if markers:
        lines.append(f"MarkerFile={os.path.basename(vmrk_path)}")
    lines += ["DataFormat=BINARY",
              f"DataOrientation={orientation}",
              f"NumberOfChannels={c}",
              f"SamplingInterval={1e6 / sfreq:.6f}", "",
              "[Binary Infos]",
              f"BinaryFormat={binary_format.upper()}", "",
              "[Channel Infos]"]
    for i, name in enumerate(ch_names):
        safe = name.replace(",", "\\1")
        lines.append(f"Ch{i + 1}={safe},,{resolution:g},uV")
    with open(vhdr_path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")

    if markers:
        ml = ["BrainVision Data Exchange Marker File, Version 1.0", "",
              "[Common Infos]",
              f"DataFile={os.path.basename(eeg_path)}", "",
              "[Marker Infos]"]
        for i, m in enumerate(markers):
            # (pos, type, desc) or (pos, type, desc, size_in_samples)
            pos, mtype, desc = m[0], m[1], m[2]
            size = int(m[3]) if len(m) > 3 else 1
            mt = str(mtype).replace(",", "\\1")
            dc = str(desc).replace(",", "\\1")
            ml.append(f"Mk{i + 1}={mt},{dc},{int(pos) + 1},{size},0")
        with open(vmrk_path, "w", encoding="utf-8") as f:
            f.write("\n".join(ml) + "\n")
