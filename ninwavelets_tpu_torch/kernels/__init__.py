"""Loader and launchers for the hand-written CUDA kernels in ``../csrc``.

Every ``.cu`` source there is compiled by its own ``nvcc`` process, all
started together, and the objects are linked into one shared library with a
plain C interface, loaded with ``ctypes``: the fused forward (``fused_cwt.cu``:
the epoch reductions, the per-signal power and the per-row peak "amax"), the
fused power backward (``fused_cwt_bwd.cu``) and the fused synchrosqueezing
kernel (``fused_ssq.cu``).
Nothing is compiled or loaded when this module is imported: the first launch
builds the library (or ``build()`` does it up front), keyed by a hash of every
source under ``csrc/``, the compiler flags and the ``nvcc`` version, and
published with an atomic rename so concurrent builds race safely.  A failed
build raises; there is no fallback.

Each launcher validates its tensors (device, dtype, shape, contiguity),
allocates its outputs with ``torch.empty`` (``torch.zeros`` for the
synchrosqueezing plane, which the kernel adds into), launches on the current
CUDA stream, raises on any non-zero CUDA error, and counts its launches in
``launches``.
"""
from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np
import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: Epilogues of the fused forward kernel, by the code the C launcher takes.
#: The first three reduce over epochs; "power_each" keeps every signal;
#: "amax" gives each (channel, row, epoch) its peak power.
EPILOGUES = {"power": 0, "itc": 1, "power_itc": 2, "power_each": 3, "amax": 4}
#: Signal lengths the fused kernel takes: powers of two in this range (the
#: block's shared memory holds N samples and N/2 twiddles, 12*N bytes).
MIN_N, MAX_N = 256, 16384

#: Kernel launches since the last ``reset_launches()``: one key per epilogue
#: of the forward kernel, "power_bwd" for the power backward and "ssq" for
#: the synchrosqueezing kernel.
launches = dict.fromkeys((*EPILOGUES, "power_bwd", "ssq"), 0)

_lock = threading.Lock()
_lib = None


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    path = (os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME
            else shutil.which("nvcc"))
    if not path or not os.path.exists(path):
        raise RuntimeError("nvcc not found: the fused CWT kernels are built "
                           "at first use and need the CUDA toolkit "
                           "(CUDA_HOME)")
    return path


def build() -> str:
    """Compile every ``csrc/*.cu`` for sm_90a, one ``nvcc`` process a
    source, all at once, and link the objects into one library, unless a
    library built from the same sources (headers included), flags and
    compiler exists; return its path.  The compiler's report (registers,
    shared memory, spills per kernel) is kept beside the library as
    ``<name>.log``."""
    nvcc = _nvcc()
    version = subprocess.run([nvcc, "--version"], check=True,
                             capture_output=True).stdout
    key = hashlib.sha256()
    for path in sorted(glob.glob(os.path.join(CSRC, "*"))):
        with open(path, "rb") as fh:
            key.update(os.path.basename(path).encode() + b"\0" + fh.read())
    key.update(b"\0".join([" ".join(NVCC_FLAGS).encode(), version]))
    lib = os.path.join(BUILD_DIR, "libninw_kernels-%s.so"
                       % key.hexdigest()[:16])
    if os.path.exists(lib):
        return lib
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    tmp = "%s.tmp%d" % (lib, os.getpid())
    os.makedirs(tmp + ".d", exist_ok=True)
    objs = [os.path.join(tmp + ".d", os.path.basename(src) + ".o")
            for src in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for src, obj in zip(sources, objs)]
    report = []
    for src, proc in zip(sources, procs):
        out, err = proc.communicate()
        report.append(out + err)
        if proc.returncode != 0:
            for other in procs:
                other.wait()
            shutil.rmtree(tmp + ".d", ignore_errors=True)
            raise RuntimeError("nvcc failed (exit %d) on %s:\n%s"
                               % (proc.returncode, src, err))
    proc = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                          capture_output=True, text=True)
    shutil.rmtree(tmp + ".d", ignore_errors=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed (exit %d) linking %s:\n%s"
                           % (proc.returncode, " ".join(sources),
                              proc.stderr))
    with open(lib[:-3] + ".log", "w") as fh:
        fh.write("".join(report))
    os.replace(tmp, lib)
    return lib


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            fn = lib.ninw_fused_cwt
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                           + [ctypes.c_int] * 6 + [ctypes.c_void_p])
            fn = lib.ninw_fused_cwt_bwd
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                           + [ctypes.c_void_p])
            fn = lib.ninw_fused_cwt_bwd_rows
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_int]
            fn = lib.ninw_fused_ssq
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                           + [ctypes.c_float] * 3 + [ctypes.c_void_p])
            _lib = lib
        return _lib


@functools.lru_cache(maxsize=None)
def _twiddles(n: int, device: torch.device) -> torch.Tensor:
    """exp(+2 pi i m / n) for m < n/2, computed in float64, stored complex64."""
    m = np.arange(n // 2, dtype=np.float64)
    tw = np.exp(2j * np.pi * m / n).astype(np.complex64)
    return torch.from_numpy(tw).to(device)


def _check(spec: torch.Tensor, bank: torch.Tensor, k_bins: int,
           g: torch.Tensor = None):
    """Validate what a kernel takes: dtypes, ranks, contiguity and shapes
    first, the device last.  Returns (E, C, L, F, N).  The kernels take the
    signal count E*C as a C int and index every buffer with size_t, so
    E*C*F*N may pass 2^31."""
    named = [("spec", spec, torch.complex64, 3),
             ("bank", bank, torch.float32, 2)]
    if g is not None:
        named.append(("g", g, torch.float32, 3))
    for name, t, dtype, ndim in named:
        if t.dtype != dtype or t.ndim != ndim or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {ndim}-D {dtype} "
                             f"tensor, got {tuple(t.shape)} {t.dtype}")
    e, c, row_len = spec.shape
    f, n = bank.shape
    if n < MIN_N or n > MAX_N or n & (n - 1):
        raise ValueError(f"N={n} is not a power of two in [{MIN_N}, {MAX_N}]")
    if k_bins not in (n // 2, n) or row_len < k_bins:
        raise ValueError(f"k_bins={k_bins} needs N/2 or N bins of the "
                         f"spectrum rows (length {row_len}, N={n})")
    if e < 1 or c < 1 or c > 65535 or f < 1 or e * c >= 2 ** 31:
        raise ValueError(f"empty or oversized batch: E={e}, C={c}, F={f}")
    if g is not None and tuple(g.shape) != (c, f, n):
        raise ValueError(f"g must be (C, F, N) = {(c, f, n)}, got "
                         f"{tuple(g.shape)}")
    for name, t, _, _ in named:
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if len({t.device for _, t, _, _ in named}) != 1:
        raise ValueError("the kernel's tensors must be on one device")
    return e, c, row_len, f, n


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def fused_cwt(epilogue: str, spec: torch.Tensor, bank: torch.Tensor,
              k_bins: int, precision: str):
    """Launch the fused forward kernel (``csrc/fused_cwt.cu``).

    Args:
      epilogue: "power" -> [mean power]; "itc" -> [itc];
        "power_itc" -> [mean power, itc], each (C, F, N) float32;
        "power_each" -> [|cwt|^2 of every signal], (E, C, F, N) float32,
        scaled 1/N^2 with no 1/E; "amax" -> [max over N of |cwt|^2 / N^2],
        (C, F, E) float32.
      spec: (E, C, L) complex64 CUDA tensor, contiguous: the signal spectra,
        of which the first ``k_bins`` bins of each row are used (L may exceed
        ``k_bins``, e.g. a whole rFFT row of N/2 + 1 bins).
      bank: (F, N) float32 CUDA tensor, contiguous, real.
      k_bins: N/2 on the analytic path, N otherwise.
      precision: accepted for the API of the fused wrappers; the kernel
        computes in float32 for every precision name.
    """
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    del precision
    e, c, row_len, f, n = _check(spec, bank, k_bins)
    lib = _load()
    shape = {"power_each": (e, c, f, n), "amax": (c, f, e)}.get(epilogue,
                                                                (c, f, n))
    outs = [torch.empty(shape, dtype=torch.float32, device=spec.device)
            for _ in range(2 if epilogue == "power_itc" else 1)]
    with torch.cuda.device(spec.device):
        err = lib.ninw_fused_cwt(
            EPILOGUES[epilogue], spec.data_ptr(), bank.data_ptr(),
            _twiddles(n, spec.device).data_ptr(), outs[0].data_ptr(),
            outs[1].data_ptr() if len(outs) > 1 else None,
            e, c, f, n, k_bins, row_len, _stream(spec.device))
    if err != 0:
        raise RuntimeError(f"fused_cwt[{epilogue}] launch failed: CUDA error "
                           f"{err} (E={e}, C={c}, F={f}, N={n})")
    launches[epilogue] += 1
    return outs


def fused_cwt_bwd(spec: torch.Tensor, bank: torch.Tensor, g: torch.Tensor,
                  k_bins: int):
    """Launch the fused power backward (``csrc/fused_cwt_bwd.cu``).

    Args:
      spec: (E, C, L) complex64 CUDA tensor, contiguous, as for
        ``fused_cwt``: the first ``k_bins`` bins of each row are used.
      bank: (F, N) float32 CUDA tensor, contiguous, real.
      g: (C, F, N) float32 CUDA tensor, contiguous: the cotangent of the
        epoch-mean power plane.
      k_bins: N/2 on the analytic path, N otherwise.

    Returns ``(dbank_part, t_part)``: (C, F, K) float32, the per-channel
    sum over epochs of Re(u conj S), and (groups, E, C, K) complex64, the
    per-row-group sum of bank x u, with u = fft((2/E) g ifft(bank S)) on
    the first K = ``k_bins`` bins.  ``ops.fused`` completes them to the
    gradients.
    """
    e, c, row_len, f, n = _check(spec, bank, k_bins, g)
    lib = _load()
    rows = lib.ninw_fused_cwt_bwd_rows(n)
    dbank_part = torch.empty((c, f, k_bins), dtype=torch.float32,
                             device=spec.device)
    t_part = torch.empty((-(-f // rows), e, c, k_bins), dtype=torch.complex64,
                         device=spec.device)
    with torch.cuda.device(spec.device):
        err = lib.ninw_fused_cwt_bwd(
            spec.data_ptr(), bank.data_ptr(), g.data_ptr(),
            _twiddles(n, spec.device).data_ptr(), dbank_part.data_ptr(),
            t_part.data_ptr(), e, c, f, n, k_bins, row_len,
            _stream(spec.device))
    if err != 0:
        raise RuntimeError(f"fused_cwt_bwd launch failed: CUDA error {err} "
                           f"(E={e}, C={c}, F={f}, N={n})")
    launches["power_bwd"] += 1
    return dbank_part, t_part


def fused_ssq(spec: torch.Tensor, bank: torch.Tensor, floors: torch.Tensor,
              uniform_grid, sfreq: float) -> torch.Tensor:
    """Launch the fused synchrosqueezing kernel (``csrc/fused_ssq.cu``).

    Args:
      spec: (E, C, L) complex64 CUDA tensor, contiguous: rFFT rows of real
        signals, of which the first N/2 bins are used (the analytic path).
      bank: (F, N) float32 CUDA tensor, contiguous, real.
      floors: (C, E) float32 CUDA tensor, contiguous: the noise gate of each
        (epoch, channel), at the 1/N^2 power scale.
      uniform_grid: ``("lin", e0, step)`` or ``("log", log e0, log ratio)``,
        the closed-form row map of ``ops.sst.uniform_grid_hint``.
      sfreq: sampling frequency (Hz).

    Returns the (C, F, N) float32 epoch SUM of the reassigned power at scale
    1/N^2.  Its float atomics make repeated runs differ at the ulp level.
    """
    if uniform_grid[0] not in ("lin", "log"):
        raise ValueError(f"the kernel takes a 'lin' or 'log' row map, got "
                         f"{uniform_grid[0]!r}")
    kind, e0, step = uniform_grid
    if not float(step) > 0:
        raise ValueError(f"row map step {step} must be positive")
    if (spec.ndim == 3 and (floors.dtype != torch.float32
                            or not floors.is_contiguous()
                            or tuple(floors.shape) != spec.shape[1::-1])):
        raise ValueError(f"floors must be a contiguous (C, E) = "
                         f"{tuple(spec.shape[1::-1])} float32 tensor, got "
                         f"{tuple(floors.shape)} {floors.dtype}")
    e, c, row_len, f, n = _check(spec, bank, bank.shape[-1] // 2)
    if floors.device != spec.device:
        raise ValueError("the kernel's tensors must be on one device")
    lib = _load()
    out = torch.zeros((c, f, n), dtype=torch.float32, device=spec.device)
    with torch.cuda.device(spec.device):
        err = lib.ninw_fused_ssq(
            spec.data_ptr(), bank.data_ptr(),
            _twiddles(n, spec.device).data_ptr(), floors.data_ptr(),
            out.data_ptr(), e, c, f, n, row_len, int(kind == "log"),
            2.0 * np.pi * float(sfreq) / n, float(e0), float(step),
            _stream(spec.device))
    if err != 0:
        raise RuntimeError(f"fused_ssq launch failed: CUDA error {err} "
                           f"(E={e}, C={c}, F={f}, N={n})")
    launches["ssq"] += 1
    return out
