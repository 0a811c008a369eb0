"""Build/load layer for the native window gathers (``_native/io.cpp``), the
port's own copy of ``ninwavelets_tpu.io.native``.

The shared object is compiled at first use with the host ``g++``
(``-O3 -fPIC -shared``) into this package's ``_native/_build/``, keyed by a
hash of the source and the host platform, so an edited source rebuilds and
a stale or foreign build is never loaded.  ctypes binds it; every entry
point releases the GIL for the whole call, which is what lets a plain
Python thread gather batch i+1 while the card computes batch i
(``io.stream``).

The numpy versions below have identical semantics.  They are the oracle of
the tests (bit for bit: the affine scale is applied in float32 in both), and
they serve a host without a compiler; ``native_available()`` says which
path is live.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import subprocess
import threading
from typing import Optional

import numpy as np

logger = logging.getLogger("ninwavelets_tpu_torch.io")

_SRC = os.path.join(os.path.dirname(__file__), "_native", "io.cpp")
BUILD_DIR = os.path.join(os.path.dirname(__file__), "_native", "_build")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_I16P = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
_F32P = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_F64P = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_L = ctypes.c_long


def _build() -> Optional[str]:
    with open(_SRC, "rb") as f:
        src = f.read()
    host = f"{platform.system()}-{platform.machine()}".encode()
    tag = hashlib.sha256(src + b"\0" + host).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"libninwio-{tag}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = so + f".tmp{os.getpid()}"
    cmd = ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)   # atomic: concurrent builders race safely
    except (OSError, subprocess.SubprocessError) as e:
        detail = getattr(e, "stderr", b"") or b""
        logger.warning("native IO build failed (%s); using the numpy "
                       "gathers %s", e, detail.decode(errors="replace")[:500])
        return None
    return so


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        so = _build()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError as e:
            logger.warning("native IO library %s unloadable (%s); using the "
                           "numpy gathers", so, e)
            return None
        lib.ninw_edf_gather.restype = ctypes.c_int
        lib.ninw_edf_gather.argtypes = [
            _I16P, _L, _L, _I64P, _F64P, _F64P, _L, _L,
            _I64P, _L, _L, _L, _L, _F32P]
        lib.ninw_f32_gather.restype = ctypes.c_int
        lib.ninw_f32_gather.argtypes = [
            _F32P, _L, _L, _I64P, _L, _L, _L, _F32P]
        lib.ninw_edf_load.restype = ctypes.c_int
        lib.ninw_edf_load.argtypes = [
            _I16P, _L, _L, _I64P, _F64P, _F64P, _L, _L, _L, _F32P]
        _lib = lib
    return _lib


def native_available() -> bool:
    """True when the compiled gather library is loadable on this host."""
    return _load() is not None


# ---------------------------------------------------------------- numpy

def _edf_gather_np(data: np.ndarray, rec_stride: int, ch_off: np.ndarray,
                   scale: np.ndarray, dc: np.ndarray, ns: int,
                   starts: np.ndarray, window: int, halo: int,
                   total: int) -> np.ndarray:
    n_rec = data.shape[0] // rec_stride
    recs = data[:n_rec * rec_stride].reshape(n_rec, rec_stride)
    n_ch = len(ch_off)
    ext = window + 2 * halo
    out = np.zeros((len(starts), n_ch, ext), np.float32)
    if len(starts) == 0:
        return out
    # Decode only the batch's span (O(batch), not O(recording)): records
    # covering [span_lo, span_hi), channel-major.
    span_lo = max(int(starts.min()) - halo, 0)
    span_hi = min(int(starts.max()) + window + halo, total)
    if span_hi <= span_lo:
        return out
    rec_lo, rec_hi = span_lo // ns, -(-span_hi // ns)
    dig = np.empty((n_ch, (rec_hi - rec_lo) * ns), np.int16)
    for c, off in enumerate(ch_off):
        dig[c] = recs[rec_lo:rec_hi, off:off + ns].reshape(-1)
    a = scale.astype(np.float32)[:, None]
    b = dc.astype(np.float32)[:, None]
    base = rec_lo * ns
    for w, start in enumerate(starts):
        lo, hi = start - halo, start + window + halo
        src_lo, src_hi = max(lo, 0), min(hi, total)
        if src_hi > src_lo:
            out[w, :, src_lo - lo:src_hi - lo] = (
                a * dig[:, src_lo - base:src_hi - base].astype(np.float32)
                + b)
    return out


def _f32_gather_np(data: np.ndarray, starts: np.ndarray, window: int,
                   halo: int) -> np.ndarray:
    n_ch, n = data.shape
    ext = window + 2 * halo
    out = np.zeros((len(starts), n_ch, ext), np.float32)
    for w, start in enumerate(starts):
        lo, hi = start - halo, start + window + halo
        src_lo, src_hi = max(lo, 0), min(hi, n)
        if src_hi > src_lo:
            out[w, :, src_lo - lo:src_hi - lo] = data[:, src_lo:src_hi]
    return out


def _edf_load_np(data: np.ndarray, rec_stride: int, ch_off: np.ndarray,
                 scale: np.ndarray, dc: np.ndarray, ns: int,
                 total: int) -> np.ndarray:
    n_rec = data.shape[0] // rec_stride
    recs = data[:n_rec * rec_stride].reshape(n_rec, rec_stride)
    out = np.empty((len(ch_off), total), np.float32)
    for c, off in enumerate(ch_off):
        dig = recs[:, off:off + ns].reshape(-1)[:total]
        out[c] = (np.float32(scale[c]) * dig.astype(np.float32)
                  + np.float32(dc[c]))
    return out


# ----------------------------------------------------------- dispatch

def edf_gather(data: np.ndarray, rec_stride: int, ch_off, scale, dc,
               ns: int, starts, window: int, halo: int,
               total: int) -> np.ndarray:
    """(W, C, window+2*halo) float32 extended-window batch from an EDF
    int16 sample area (1-D ``data``, mmap-backed or in memory)."""
    ch_off = np.ascontiguousarray(ch_off, np.int64)
    scale = np.ascontiguousarray(scale, np.float64)
    dc = np.ascontiguousarray(dc, np.float64)
    starts = np.ascontiguousarray(starts, np.int64)
    lib = _load()
    if lib is None:
        return _edf_gather_np(data, rec_stride, ch_off, scale, dc, ns,
                              starts, window, halo, total)
    n_rec = data.shape[0] // rec_stride
    out = np.empty((len(starts), len(ch_off), window + 2 * halo),
                   np.float32)
    rc = lib.ninw_edf_gather(data, n_rec, rec_stride, ch_off, scale, dc,
                             len(ch_off), ns, starts, len(starts), window,
                             halo, total, out)
    if rc != 0:
        raise ValueError("ninw_edf_gather: bad geometry "
                         f"(ns={ns}, stride={rec_stride}, total={total})")
    return out


def f32_gather(data: np.ndarray, starts, window: int,
               halo: int) -> np.ndarray:
    """(W, C, window+2*halo) float32 batch from a contiguous (C, N)
    float32 recording."""
    data = np.ascontiguousarray(data, np.float32)
    starts = np.ascontiguousarray(starts, np.int64)
    lib = _load()
    if lib is None:
        return _f32_gather_np(data, starts, window, halo)
    n_ch, n = data.shape
    out = np.empty((len(starts), n_ch, window + 2 * halo), np.float32)
    rc = lib.ninw_f32_gather(data, n_ch, n, starts, len(starts), window,
                             halo, out)
    if rc != 0:
        raise ValueError("ninw_f32_gather: bad geometry")
    return out


def edf_load(data: np.ndarray, rec_stride: int, ch_off, scale, dc,
             ns: int, total: int) -> np.ndarray:
    """(C, total) float32 physical-units array from an EDF sample area."""
    ch_off = np.ascontiguousarray(ch_off, np.int64)
    scale = np.ascontiguousarray(scale, np.float64)
    dc = np.ascontiguousarray(dc, np.float64)
    lib = _load()
    if lib is None:
        return _edf_load_np(data, rec_stride, ch_off, scale, dc, ns, total)
    n_rec = data.shape[0] // rec_stride
    out = np.empty((len(ch_off), total), np.float32)
    rc = lib.ninw_edf_load(data, n_rec, rec_stride, ch_off, scale, dc,
                           len(ch_off), ns, total, out)
    if rc != 0:
        raise ValueError("ninw_edf_load: bad geometry")
    return out
