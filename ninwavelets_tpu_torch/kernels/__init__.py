"""Loader and launchers for the hand-written CUDA kernels in ``../csrc``.

The kernels are compiled with ``nvcc`` into a shared library with a plain C
interface and loaded with ``ctypes``.  Nothing is compiled or loaded when this
module is imported: the first launch builds the library (or ``build()`` does it
up front), keyed by a hash of the source, the compiler flags and the ``nvcc``
version, and published with an atomic rename so concurrent builders race
safely.  A failed build raises; there is no fallback.

Each launcher validates its tensors (device, dtype, shape, contiguity),
allocates its outputs with ``torch.empty``, launches on the current CUDA
stream, raises on any non-zero CUDA error, and counts its launches in
``launches``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np
import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "fused_cwt.cu")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: Epilogues of the fused forward kernel, by the code the C launcher takes.
EPILOGUES = {"power": 0, "itc": 1, "power_itc": 2}
#: Signal lengths the fused kernel takes: powers of two in this range (the
#: block's shared memory holds N samples and N/2 twiddles, 12*N bytes).
MIN_N, MAX_N = 256, 16384

#: Kernel launches per epilogue since the last ``reset_launches()``.
launches = dict.fromkeys(EPILOGUES, 0)

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
        raise RuntimeError("nvcc not found: the fused CWT kernel is built at "
                           "first use and needs the CUDA toolkit (CUDA_HOME)")
    return path


def build() -> str:
    """Compile ``csrc/fused_cwt.cu`` for sm_90a unless a library built from
    the same source, flags and compiler exists; return its path.  The
    compiler's report (registers, shared memory, spills) is kept beside the
    library as ``<name>.log``."""
    nvcc = _nvcc()
    version = subprocess.run([nvcc, "--version"], check=True,
                             capture_output=True).stdout
    with open(SOURCE, "rb") as fh:
        src = fh.read()
    key = b"\0".join([src, " ".join(NVCC_FLAGS).encode(), version])
    lib = os.path.join(BUILD_DIR, "libninw_fused_cwt-%s.so"
                       % hashlib.sha256(key).hexdigest()[:16])
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.tmp%d" % (lib, os.getpid())
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed (exit %d) on %s:\n%s"
                           % (proc.returncode, SOURCE, proc.stderr))
    with open(lib[:-3] + ".log", "w") as fh:
        fh.write(proc.stdout + proc.stderr)
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
            _lib = lib
        return _lib


@functools.lru_cache(maxsize=None)
def _twiddles(n: int, device: torch.device) -> torch.Tensor:
    """exp(+2 pi i m / n) for m < n/2, computed in float64, stored complex64."""
    m = np.arange(n // 2, dtype=np.float64)
    tw = np.exp(2j * np.pi * m / n).astype(np.complex64)
    return torch.from_numpy(tw).to(device)


def fused_cwt(epilogue: str, spec: torch.Tensor, bank: torch.Tensor,
              k_bins: int, precision: str):
    """Launch the fused forward kernel (``csrc/fused_cwt.cu``).

    Args:
      epilogue: "power" -> [mean power]; "itc" -> [itc];
        "power_itc" -> [mean power, itc].  Each output is (C, F, N) float32.
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
    for name, t, dtype, ndim in (("spec", spec, torch.complex64, 3),
                                 ("bank", bank, torch.float32, 2)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != dtype or t.ndim != ndim or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {ndim}-D {dtype} "
                             f"tensor, got {tuple(t.shape)} {t.dtype}")
    if spec.device != bank.device:
        raise ValueError("spec and bank must be on the same device")
    e, c, row_len = spec.shape
    f, n = bank.shape
    if n < MIN_N or n > MAX_N or n & (n - 1):
        raise ValueError(f"N={n} is not a power of two in [{MIN_N}, {MAX_N}]")
    if k_bins not in (n // 2, n) or row_len < k_bins:
        raise ValueError(f"k_bins={k_bins} needs N/2 or N bins of the "
                         f"spectrum rows (length {row_len}, N={n})")
    if e < 1 or c < 1 or c > 65535 or f < 1:
        raise ValueError(f"empty or oversized batch: E={e}, C={c}, F={f}")
    lib = _load()
    outs = [torch.empty((c, f, n), dtype=torch.float32, device=spec.device)
            for _ in range(2 if epilogue == "power_itc" else 1)]
    with torch.cuda.device(spec.device):
        stream = torch.cuda.current_stream(spec.device).cuda_stream
        err = lib.ninw_fused_cwt(
            EPILOGUES[epilogue], spec.data_ptr(), bank.data_ptr(),
            _twiddles(n, spec.device).data_ptr(), outs[0].data_ptr(),
            outs[1].data_ptr() if len(outs) > 1 else None,
            e, c, f, n, k_bins, row_len, stream)
    if err != 0:
        raise RuntimeError(f"fused_cwt[{epilogue}] launch failed: CUDA error "
                           f"{err} (E={e}, C={c}, F={f}, N={n})")
    launches[epilogue] += 1
    return outs
