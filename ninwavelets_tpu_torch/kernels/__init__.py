"""Loader and launchers for the hand-written CUDA kernels in ``../csrc``.

Every ``.cu`` source there is compiled by its own ``nvcc`` process, all
started together, and the objects are linked into one shared library with a
plain C interface, loaded with ``ctypes``: the fused forward (``fused_cwt.cu``:
the epoch reductions, the per-signal power and the per-row peak "amax"), the
fused power backward (``fused_cwt_bwd.cu``; both of these also take a
complex bank, the forward for its three epoch reductions), the fused
synchrosqueezing kernel (``fused_ssq.cu``) and the cross-pair epoch sums
(``fused_pair.cu``: coherence, phase lag, unit cross-phase).
Nothing is compiled or loaded when this module is imported: the first launch
builds the library (or ``build()`` does it up front), keyed by a hash of every
source under ``csrc/``, the compiler flags and the ``nvcc`` version, and
published with an atomic rename so concurrent builds race safely.  A failed
build raises; there is no fallback.

Every kernel runs on the register-resident FFT core of
``csrc/fft_regs.cuh`` and takes its twiddle table, ``core_twiddles``: the
epoch reductions ("power", "itc", "power_itc", real and complex bank), the
per-signal power ("power_each"), the noise gate's peaks ("amax"), the
backward (real and complex bank), the synchrosqueezing kernel and the
cross-pair sums.  The core's plan, its twiddle table and where each
thread's samples go are described here too
(``core_plan``, ``core_twiddles``, ``core_exchange_positions``,
``core_output_map``, and the backward's row groups, ``bwd_rows``), so the
CPU tests can emulate it; ``built_core_layout`` reads the same facts from
the built library (``csrc/core_plan.cu``, ``ninw_fused_cwt_bwd_rows``),
and ``chip_smoke.py`` holds the two against each other.

Each launcher validates its tensors (device, dtype, shape, contiguity),
allocates its outputs with ``torch.empty`` (``torch.zeros`` for the
synchrosqueezing plane and the "amax" peaks, which the kernels add into),
launches on the current
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

#: Epilogues of ``ninw_fused_cwt``, by the code it takes.  The first three
#: reduce over epochs; "amax" gives each (channel, row, epoch) its peak
#: power.  The per-signal power, "power_each", has its own entry point
#: (``ninw_fused_power_each``, ``fused_power_each``).
EPILOGUES = {"power": 0, "itc": 1, "power_itc": 2, "amax": 3}
#: The epilogues that take a complex64 bank (the reference's complex stage
#: 0): the three epoch reductions.
COMPLEX_EPILOGUES = ("power", "itc", "power_itc")
#: Signal lengths the fused kernels take: powers of two in this range (the
#: core's plans, ``fft_regs::Plan``: at N = 16384 a block has 1024 threads
#: and its exchange buffer 136 KB of shared memory).
MIN_N, MAX_N = 256, 16384

#: Epilogues of the cross-pair kernel, by the code its C launcher takes, and
#: the (C, F, N) planes each returns.
PAIR_EPILOGUES = {"coherence": 0, "phaselag": 1, "plv": 2}
PAIR_PLANES = {"coherence": 4, "phaselag": 4, "plv": 2}

#: Kernel launches since the last ``reset_launches()``: one key per epilogue
#: of the forward kernel, "power_each" for the per-signal power,
#: "power_bwd" for the power backward, "ssq" for the synchrosqueezing
#: kernel, one key per epilogue of the cross-pair kernel, and the
#: complex-bank launches under their own keys ("power_cx", "itc_cx",
#: "power_itc_cx", "power_bwd_cx"), so a run of a real-bank kernel is never
#: read as a run of its complex-bank form.
launches = dict.fromkeys((*EPILOGUES, "power_each", "power_bwd", "ssq",
                          *PAIR_EPILOGUES,
                          *(f"{e}_cx" for e in COMPLEX_EPILOGUES),
                          "power_bwd_cx"), 0)

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


def build(defines: tuple = (), csrc: str = CSRC) -> str:
    """Compile every ``*.cu`` of ``csrc`` for sm_90a, one ``nvcc`` process
    a source, all at once, with ``-D<d>`` for each of ``defines``, and link
    the objects into one library, unless a library built from the same
    sources (headers included), flags and compiler exists; return its path.
    The compiler's report (registers, shared memory, spills per kernel) is
    kept beside the library as ``<name>.log``."""
    nvcc = _nvcc()
    flags = (*NVCC_FLAGS, *(f"-D{d}" for d in defines))
    version = subprocess.run([nvcc, "--version"], check=True,
                             capture_output=True).stdout
    key = hashlib.sha256()
    for path in sorted(glob.glob(os.path.join(csrc, "*"))):
        with open(path, "rb") as fh:
            key.update(os.path.basename(path).encode() + b"\0" + fh.read())
    key.update(b"\0".join([" ".join(flags).encode(), version]))
    lib = os.path.join(BUILD_DIR, "libninw_kernels-%s.so"
                       % key.hexdigest()[:16])
    if os.path.exists(lib):
        return lib
    sources = sorted(glob.glob(os.path.join(csrc, "*.cu")))
    tmp = "%s.tmp%d" % (lib, os.getpid())
    os.makedirs(tmp + ".d", exist_ok=True)
    objs = [os.path.join(tmp + ".d", os.path.basename(src) + ".o")
            for src in sources]
    procs = [subprocess.Popen([nvcc, *flags, "-c", "-o", obj, src],
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


#: The argument types of each C entry point of the library (all return a
#: C int).
SIGNATURES = {
    "ninw_fused_cwt": ([ctypes.c_int] + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p]),
    "ninw_fused_power_each": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                              + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 2
                              + [ctypes.c_void_p]),
    "ninw_fused_cwt_bwd": ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                           + [ctypes.c_void_p]),
    "ninw_fused_cwt_bwd_rows": [ctypes.c_int, ctypes.c_int],
    "ninw_fused_ssq": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_float] * 3 + [ctypes.c_void_p]),
    "ninw_fused_pair": ([ctypes.c_int] + [ctypes.c_void_p] * 5
                        + [ctypes.c_int] * 6 + [ctypes.c_void_p]),
    "ninw_core_plan": [ctypes.c_int, ctypes.c_void_p],
    "ninw_core_exchange": [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                           ctypes.c_void_p],
}


def open_library(path: str, names=tuple(SIGNATURES)) -> ctypes.CDLL:
    """Load a library that ``build`` made, its entry points ``names``
    bound to their ``SIGNATURES``."""
    lib = ctypes.CDLL(path)
    for name in names:
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = SIGNATURES[name]
    return lib


def _load():
    global _lib
    with _lock:
        if _lib is None:
            _lib = open_library(build())
        return _lib


def core_plan(n: int) -> tuple:
    """The radices of the core's passes at signal length ``n``: 16 while
    16 divides what is left, then the remaining 2, 4 or 8
    (``csrc/fft_regs.cuh``, ``Plan::log2_radix``)."""
    log2n = n.bit_length() - 1
    if n < MIN_N or n > MAX_N or n != 1 << log2n:
        raise ValueError(f"N={n} is not a power of two in [{MIN_N}, {MAX_N}]")
    return (16,) * (log2n // 4) + ((1 << log2n % 4,) if log2n % 4 else ())


def core_r(n: int) -> int:
    """The complex samples each thread of the core holds at signal length
    ``n``: 16, and 32 at N = 8192 (``Plan::kR``); a block has N / R
    threads."""
    core_plan(n)
    return 32 if n == 8192 else 16


def core_twiddles(n: int) -> np.ndarray:
    """The core's twiddle table, complex64: for each pass s >= 1 of radix P
    after sub-transforms of Ns = 16^s points, exp(+2 pi i r k / (Ns P)) for
    r in [1, P), k in [0, Ns), at offset Ns - 16 + (r - 1) Ns + k; computed
    in float64."""
    parts, ns = [], 1
    for s, p in enumerate(core_plan(n)):
        if s:
            r = np.arange(1, p, dtype=np.float64)[:, None]
            k = np.arange(ns, dtype=np.float64)[None, :]
            parts.append(np.exp(2j * np.pi * r * k / (ns * p)).ravel())
        ns *= p
    return np.concatenate(parts).astype(np.complex64)


def core_exchange_positions(n: int, s: int) -> np.ndarray:
    """Where pass ``s`` (not the last) of the core puts its outputs:
    (T, R) int array (R = ``core_r(n)``, T = N / R), entry [t, m + Q q] the
    padded exchange-buffer index of output q of thread t's DFT m (Q = R / P
    DFTs of P points a thread).  After the barrier thread t reads its slot i
    from ``core_pad(t + T i)``."""
    plan = core_plan(n)
    if not 0 <= s < len(plan) - 1:
        raise ValueError(f"pass {s} of {len(plan)} has no exchange")
    r = core_r(n)
    p, ns, t_count = plan[s], 16 ** s, n // r
    q_count = r // p
    pos = np.empty((t_count, r), dtype=np.int64)
    t = np.arange(t_count)
    for m in range(q_count):
        j = t + m * t_count
        base = (j // ns) * ns * p + (j % ns)
        for q in range(p):
            pos[:, m + q_count * q] = core_pad(base + q * ns)
    return pos


def core_pad(o):
    """The exchange buffer's padding: position o sits at o + o // 16."""
    return o + (o >> 4)


def core_output_map(n: int) -> np.ndarray:
    """(T, R) int array: the sample n(t, i) = t + T i that thread t holds in
    slot i after the core, in every epoch (R = ``core_r(n)``, T = N / R)."""
    r = core_r(n)
    t_count = n // r
    return np.arange(t_count)[:, None] + t_count * np.arange(r)[None, :]


def bwd_rows(n: int, complex_bank: bool) -> int:
    """The bank rows G a block of the backward kernel takes at signal
    length ``n`` (``csrc/fused_cwt_bwd.cu``, ``BwdPlan::kRows``): 4 to
    N = 4096, 2 at 8192, 1 at 16384; a complex bank halves it.  t_part has
    ceil(F / G) row groups."""
    core_plan(n)
    rows = 4 if n <= 4096 else 2 if n == 8192 else 1
    return max(rows // 2, 1) if complex_bank else rows


def built_core_layout(n: int) -> dict:
    """The core's plan and exchange indices at signal length ``n`` as the
    built library computes them, with the functions its kernels call
    (``csrc/core_plan.cu``): "r", "threads", "plan" (the radices),
    "buf_len", "twiddles" (the table's length), for each pass but the
    last its (T, R) "writes" and "reads", the counterparts of
    ``core_exchange_positions(n, s)`` and ``core_pad(t + T i)``, and
    "bwd_rows", the backward's row groups for a real and a complex bank
    (``ninw_fused_cwt_bwd_rows``), the counterparts of ``bwd_rows``.
    Builds the library (needs ``nvcc``)."""
    lib = _load()
    head = np.zeros(9, dtype=np.int32)
    if lib.ninw_core_plan(n.bit_length() - 1, head.ctypes.data) != 0:
        raise ValueError(f"the core does not take N={n}")
    r, t_count, passes, buf_len, twiddles = (int(v) for v in head[:5])
    layout = {"r": r, "threads": t_count,
              "plan": tuple(int(p) for p in head[5:5 + passes]),
              "buf_len": buf_len, "twiddles": twiddles,
              "bwd_rows": tuple(lib.ninw_fused_cwt_bwd_rows(n, cx)
                                for cx in (0, 1)),
              "writes": [], "reads": []}
    for s in range(passes - 1):
        writes = np.zeros((t_count, r), dtype=np.int32)
        reads = np.zeros((t_count, r), dtype=np.int32)
        if lib.ninw_core_exchange(n.bit_length() - 1, s, writes.ctypes.data,
                                  reads.ctypes.data) != 0:
            raise ValueError(f"pass {s} at N={n} has no exchange")
        layout["writes"].append(writes)
        layout["reads"].append(reads)
    return layout


@functools.lru_cache(maxsize=None)
def _core_twiddles(n: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(core_twiddles(n)).to(device)


def _check(spec: torch.Tensor, bank: torch.Tensor, k_bins: int,
           g: torch.Tensor = None, complex_bank: bool = False):
    """Validate what a kernel takes: dtypes, ranks, contiguity and shapes
    first, the device last.  Returns (E, C, L, F, N).  The bank is float32,
    or complex64 where ``complex_bank``.  The kernels take the signal count
    E*C as a C int and index every buffer with size_t, so E*C*F*N may pass
    2^31."""
    named = [("spec", spec, torch.complex64, 3),
             ("bank", bank,
              torch.complex64 if complex_bank else torch.float32, 2)]
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
        "amax" -> [max over N of |cwt|^2 / N^2], (C, F, E) float32, with
        W and |W|^2 formed bit for bit as ``fused_ssq`` forms them.
      spec: (E, C, L) complex64 CUDA tensor, contiguous: the signal spectra,
        of which the first ``k_bins`` bins of each row are used (L may exceed
        ``k_bins``, e.g. a whole rFFT row of N/2 + 1 bins).
      bank: (F, N) CUDA tensor, contiguous: float32, or complex64 (a
        Normal/Twice-mode bank) for the epilogues in ``COMPLEX_EPILOGUES``,
        counted under ``"<epilogue>_cx"``.
      k_bins: N/2 on the analytic path, N otherwise.
      precision: accepted for the API of the fused wrappers; the kernel
        computes in float32 for every precision name.
    """
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    del precision
    cx = bank.is_complex()
    if cx and epilogue not in COMPLEX_EPILOGUES:
        raise ValueError(f"a complex bank takes only the {COMPLEX_EPILOGUES} "
                         f"epilogues, not {epilogue!r}")
    e, c, row_len, f, n = _check(spec, bank, k_bins, complex_bank=cx)
    lib = _load()
    # "amax" adds each warp's peak into its cell by atomicMax.
    alloc, shape = ((torch.zeros, (c, f, e)) if epilogue == "amax"
                    else (torch.empty, (c, f, n)))
    outs = [alloc(shape, dtype=torch.float32, device=spec.device)
            for _ in range(2 if epilogue == "power_itc" else 1)]
    with torch.cuda.device(spec.device):
        err = lib.ninw_fused_cwt(
            EPILOGUES[epilogue], spec.data_ptr(), bank.data_ptr(),
            _core_twiddles(n, spec.device).data_ptr(), outs[0].data_ptr(),
            outs[1].data_ptr() if len(outs) > 1 else None,
            e, c, f, n, k_bins, row_len, int(cx), _stream(spec.device))
    key = f"{epilogue}_cx" if cx else epilogue
    if err != 0:
        raise RuntimeError(f"fused_cwt[{key}] launch failed: CUDA error "
                           f"{err} (E={e}, C={c}, F={f}, N={n})")
    launches[key] += 1
    return outs


def each_layout(dst: torch.Tensor, n_signals: int, n_freqs: int,
                keep) -> tuple:
    """What ``fused_power_each`` passes the kernel for ``dst``: (group,
    stride_group, stride_signal, stride_row, keep_lo, keep_hi), in floats.
    The kernel writes column n of signal b's row f at
    ``dst.data_ptr() + (b // group) stride_group + (b % group)
    stride_signal + f stride_row + (n - keep_lo)``: element
    [b // group, b % group, f, n - keep_lo] of the (B / group, group, F,
    keep_hi - keep_lo) view ``dst``.  Raises where ``dst`` is not such a
    view or has a last stride other than 1."""
    lo, hi = (int(v) for v in keep)
    if dst.dtype != torch.float32 or dst.ndim != 4:
        raise ValueError(f"dst must be a 4-D float32 view, got "
                         f"{tuple(dst.shape)} {dst.dtype}")
    outer, group, f, width = dst.shape
    n_freqs = int(n_freqs)
    if (outer * group != n_signals or f != n_freqs or width != hi - lo
            or lo < 0 or hi <= lo):
        raise ValueError(f"dst {tuple(dst.shape)} is not (B / group, group, "
                         f"F, keep) for B={n_signals}, F={n_freqs}, "
                         f"keep=[{lo}, {hi})")
    strides = dst.stride()
    if strides[3] != 1:
        raise ValueError(f"dst strides {strides} must end in 1")
    return group, strides[0], strides[1], strides[2], lo, hi


def fused_power_each(spec: torch.Tensor, bank: torch.Tensor, k_bins: int,
                     dst: torch.Tensor, keep) -> torch.Tensor:
    """Launch "power_each" (``csrc/fused_cwt.cu``) writing only the columns
    ``keep = (lo, hi)`` of every signal's rows, in place, into ``dst``.

    Args:
      spec: (E, C, L) complex64 CUDA tensor, contiguous, as for
        ``fused_cwt``: B = E C signals.
      bank: (F, N) float32 CUDA tensor, contiguous, real.
      k_bins: N/2 on the analytic path, N otherwise.
      dst: a float32 CUDA view (B / group, group, F, hi - lo), last stride
        1 (``each_layout``): element [b // group, b % group, f, n - lo]
        receives |cwt|^2 / N^2 of signal b, row f, column n, for
        lo <= n < hi.  Other elements of its storage are left as they are.
      keep: (lo, hi), 0 <= lo < hi <= N.

    Returns ``dst``.  Counted under "power_each"."""
    if bank.is_complex():
        raise ValueError(f"a complex bank takes only the {COMPLEX_EPILOGUES} "
                         f"epilogues, not 'power_each'")
    e, c, row_len, f, n = _check(spec, bank, k_bins)
    layout = each_layout(dst, e * c, f, keep)
    if layout[-1] > n:
        raise ValueError(f"keep {tuple(keep)} passes N={n}")
    if dst.device != spec.device:
        raise ValueError("the kernel's tensors must be on one device")
    lib = _load()
    with torch.cuda.device(spec.device):
        err = lib.ninw_fused_power_each(
            spec.data_ptr(), bank.data_ptr(),
            _core_twiddles(n, spec.device).data_ptr(), dst.data_ptr(),
            e * c, f, n, k_bins, row_len, *layout, _stream(spec.device))
    if err != 0:
        raise RuntimeError(f"fused_power_each launch failed: CUDA error "
                           f"{err} (B={e * c}, F={f}, N={n}, keep={keep})")
    launches["power_each"] += 1
    return dst


def fused_cwt_bwd(spec: torch.Tensor, bank: torch.Tensor, g: torch.Tensor,
                  k_bins: int):
    """Launch the fused power backward (``csrc/fused_cwt_bwd.cu``).

    Args:
      spec: (E, C, L) complex64 CUDA tensor, contiguous, as for
        ``fused_cwt``: the first ``k_bins`` bins of each row are used.
      bank: (F, N) CUDA tensor, contiguous: float32, or complex64 (a
        Normal/Twice-mode bank, counted under "power_bwd_cx").
      g: (C, F, N) float32 CUDA tensor, contiguous: the cotangent of the
        epoch-mean power plane.
      k_bins: N/2 on the analytic path, N otherwise.

    Returns ``(dbank_part, t_part)``: (C, F, K), the per-channel sum over
    epochs of Re(u conj S) (float32), or of u conj S for a complex bank
    (complex64, PyTorch's gradient convention); and (groups, E, C, K)
    complex64, the per-row-group sum of bank x u (conj(bank) x u for a
    complex bank), with u = fft((2/E) g ifft(bank S)) on the first
    K = ``k_bins`` bins.  ``ops.fused`` completes them to the gradients.
    """
    cx = bank.is_complex()
    e, c, row_len, f, n = _check(spec, bank, k_bins, g, complex_bank=cx)
    lib = _load()
    rows = lib.ninw_fused_cwt_bwd_rows(n, int(cx))
    dbank_part = torch.empty((c, f, k_bins), dtype=bank.dtype,
                             device=spec.device)
    t_part = torch.empty((-(-f // rows), e, c, k_bins), dtype=torch.complex64,
                         device=spec.device)
    with torch.cuda.device(spec.device):
        err = lib.ninw_fused_cwt_bwd(
            spec.data_ptr(), bank.data_ptr(), g.data_ptr(),
            _core_twiddles(n, spec.device).data_ptr(), dbank_part.data_ptr(),
            t_part.data_ptr(), e, c, f, n, k_bins, row_len, int(cx),
            _stream(spec.device))
    key = "power_bwd_cx" if cx else "power_bwd"
    if err != 0:
        raise RuntimeError(f"fused_cwt_bwd launch failed ({key}): CUDA error "
                           f"{err} (E={e}, C={c}, F={f}, N={n})")
    launches[key] += 1
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
            _core_twiddles(n, spec.device).data_ptr(), floors.data_ptr(),
            out.data_ptr(), e, c, f, n, row_len, int(kind == "log"),
            2.0 * np.pi * float(sfreq) / n, float(e0), float(step),
            _stream(spec.device))
    if err != 0:
        raise RuntimeError(f"fused_ssq launch failed: CUDA error {err} "
                           f"(E={e}, C={c}, F={f}, N={n})")
    launches["ssq"] += 1
    return out


def fused_cwt_pair(epilogue: str, spec_a: torch.Tensor, spec_b: torch.Tensor,
                   bank: torch.Tensor, k_bins: int):
    """Launch the cross-pair kernel (``csrc/fused_pair.cu``).

    Args:
      epilogue: "coherence" -> [sum Re a conj b, sum Im a conj b,
        sum |a|^2, sum |b|^2]; "phaselag" -> [sum Im, sum |Im|,
        sum sign(Im), sum Im^2] of a conj b, with Im pinned to 0 where its
        two rounded products agree; "plv" -> [sum Re, sum Im] of the unit
        cross-phase.  Each plane is (C, F, N) float32, summed over epochs
        (no 1/E), at the plain path's coefficient scale (ifft's 1/N).
      spec_a, spec_b: (E, C, L) complex64 CUDA tensors, contiguous, of one
        shape and device: the spectra of channels a and b of every pair, of
        which the first ``k_bins`` bins of each row are used.
      bank: (F, N) float32 CUDA tensor, contiguous, real.
      k_bins: N/2 on the analytic path, N otherwise.
    """
    if epilogue not in PAIR_EPILOGUES:
        raise ValueError(f"unknown pair epilogue {epilogue!r}")
    if (spec_b.dtype != spec_a.dtype or spec_b.shape != spec_a.shape
            or not spec_b.is_contiguous()):
        raise ValueError(f"spec_b must be a contiguous tensor like spec_a "
                         f"{tuple(spec_a.shape)} {spec_a.dtype}, got "
                         f"{tuple(spec_b.shape)} {spec_b.dtype}")
    e, c, row_len, f, n = _check(spec_a, bank, k_bins)
    if spec_b.device != spec_a.device:
        raise ValueError("the kernel's tensors must be on one device")
    lib = _load()
    out = torch.empty((PAIR_PLANES[epilogue], c, f, n), dtype=torch.float32,
                      device=spec_a.device)
    with torch.cuda.device(spec_a.device):
        err = lib.ninw_fused_pair(
            PAIR_EPILOGUES[epilogue], spec_a.data_ptr(), spec_b.data_ptr(),
            bank.data_ptr(), _core_twiddles(n, spec_a.device).data_ptr(),
            out.data_ptr(), e, c, f, n, k_bins, row_len,
            _stream(spec_a.device))
    if err != 0:
        raise RuntimeError(f"fused_cwt_pair[{epilogue}] launch failed: CUDA "
                           f"error {err} (E={e}, C={c}, F={f}, N={n})")
    launches[epilogue] += 1
    return list(out.unbind(0))
