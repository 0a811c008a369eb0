"""Observability: structured logging, timers, FLOP/byte estimates, profiling
(port of ``ninwavelets_tpu.utils.observability``).

* a namespaced ``logging`` logger, ``"ninwavelets_tpu_torch"``, with a
  ``NullHandler`` (no prints anywhere in the library),
* ``Timer`` — wall-clock context manager whose ``block`` synchronizes every
  CUDA device its tensors lie on, so timings measure compute rather than
  dispatch,
* ``cwt_cost`` — closed-form FLOP / byte estimates for a CWT workload,
* ``trace`` — a ``torch.profiler`` wrapper writing a trace file (Chrome
  trace JSON, readable by TensorBoard's profiler plugin) under ``logdir``,
* ``span`` — the library's own host spans (``ninw.*``) at its layer
  boundaries, recorded only while a profiler records,
* ``debug_nans`` — NaN checking for numerical debugging.

``debug_nans`` differs from the JAX package's, which flips
``jax_debug_nans``: PyTorch has no such switch, so while the context is on
a ``TorchDispatchMode`` checks the floating (and complex) outputs of every
ATen op that the entering thread dispatches, and the first op whose output
holds a NaN raises ``FloatingPointError`` naming the op.  The hand-written
kernels are launched through ``ctypes`` and are invisible to the
dispatcher, so their launchers (``kernels``) check their own outputs while
the context is on, naming the kernel.  Unlike JAX's, the check runs eagerly
op by op (there is no compiled program to re-run), it makes every checked
op synchronize with the card, and the uninitialized buffers of the
``empty`` family of factories are zero-filled while it is on, so that their
old contents are never read as a NaN.  Off is free: no mode is installed
and the launchers test one flag.

The spans, each opened where its work happens and closed before any
``yield``, so that they nest properly on the calling thread:

* ``ninw.adapter.snapshot`` — an adapter's float32 host copy of
  ``get_data()``, when it is made (not on a cache hit);
* ``ninw.h2d`` — a host-to-device copy of the signals;
* ``ninw.transform.kernel:<key>`` — one transform through a fused kernel,
  ``<key>`` the key its launches count under in ``kernels.launches``;
  ``ninw.transform.plain:<reason>`` — one through the plain ``torch.fft``
  chain, the reason from ``ops.fused.why_not`` ("shape",
  "complex_bank", "channels", "n_not_pow2", "n_range"), or
  "complex_signals", "cpu" (the kernel would take it on a card), "off"
  (a stream built with ``use_fused=False``), and for synchrosqueezing
  ``ops.fused.why_not_ssq``'s "row_map" and "interpolate";
* ``ninw.bank.build`` — a bank built (``WaveletBase._build_bank``; a
  ``StreamingCWT``'s halo and bank);
* ``ninw.stream.wait`` — the calling thread's wait for a window batch's
  gather (the prefetch thread's own gather records nothing).

The count of a name in a trace is the count of that event: there is no
second counter.
"""
from __future__ import annotations

import contextlib
import logging
import math
import time
from dataclasses import dataclass
from typing import Optional

import torch

log = logging.getLogger("ninwavelets_tpu_torch")
log.addHandler(logging.NullHandler())


def _leaves(obj):
    """The tensors in a nest of tuples, lists and dict values."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for item in obj:
            yield from _leaves(item)
    elif isinstance(obj, dict):
        for item in obj.values():
            yield from _leaves(item)


def _block(obj) -> None:
    """Synchronize each CUDA device a tensor of ``obj`` lies on."""
    devices = {t.device for t in _leaves(obj) if t.device.type == "cuda"}
    for device in devices:
        torch.cuda.synchronize(device)


class Timer:
    """Wall-clock timer that blocks until device work is done.

    >>> with Timer("bank") as t:        # doctest: +SKIP
    ...     out = engine.power(sig)
    ...     t.block(out)
    >>> t.elapsed                       # doctest: +SKIP
    0.0123
    """

    def __init__(self, name: str = "", logger: Optional[logging.Logger] = None
                 ) -> None:
        self.name = name
        self.logger = logger or log
        self.elapsed: float = float("nan")

    def __enter__(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def block(self, *tensors) -> None:
        """Synchronize each CUDA device among ``tensors`` (tensors, or
        tuples, lists and dicts of them) so __exit__ captures their compute
        time."""
        _block(tensors)

    def __exit__(self, *exc) -> None:
        self.elapsed = time.perf_counter() - self._t0
        self.logger.debug("timer %s: %.6f s", self.name or "<anon>",
                          self.elapsed)


@dataclass(frozen=True)
class CwtCost:
    """Estimated cost of one batched CWT power call."""
    flops: float          # floating-point operations
    hbm_bytes: float      # bytes moved to/from device memory (fused model)
    coeff_bytes: float    # size of the (B, F, N) complex coefficient tensor

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / max(self.hbm_bytes, 1.0)


def cwt_cost(batch: int, n_freqs: int, n: int,
             analytic: bool = True) -> CwtCost:
    """FLOP / byte model for ``batch`` signals x ``n_freqs`` wavelets x ``n``
    samples.

    FFT flops use the 5 N log2 N convention; the bank multiply and power
    epilogue are elementwise.  ``hbm_bytes`` models the fused kernel (spectra
    in, f32 power out); the plain path moves ~4x the coefficient tensor extra.
    """
    fft = 5.0 * n * math.log2(max(n, 2))
    signal_ffts = batch * fft * (0.5 if analytic else 1.0)
    inverse_ffts = batch * n_freqs * fft
    multiply = batch * n_freqs * n * 6.0
    power = batch * n_freqs * n * 3.0
    coeff = batch * n_freqs * n * 8.0
    spec_bytes = batch * n * 8.0 * (0.5 if analytic else 1.0)
    out_bytes = batch * n_freqs * n * 4.0
    return CwtCost(flops=signal_ffts + inverse_ffts + multiply + power,
                   hbm_bytes=spec_bytes + out_bytes + n_freqs * n * 4.0,
                   coeff_bytes=coeff)


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` trace context (the CPU, and the card where CUDA
    is available): the trace file is written under ``logdir`` when the
    context exits.

    >>> with trace("/tmp/tb"):          # doctest: +SKIP
    ...     engine.power(sig)
    """
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(logdir))):
        yield


#: What ``span`` hands back while no profiler records.
_NO_SPAN = contextlib.nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled


def span(name: str):
    """``torch.profiler.record_function(name)`` while a profiler records,
    else one shared null context: the span shares the trace's clock with
    the device's activity, and costs one flag test when off.

    >>> with span("ninw.h2d"):          # doctest: +SKIP
    ...     x = host.to("cuda")
    """
    if _profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


#: ATen ops whose output is an uninitialized buffer: zero-filled, not
#: checked, while ``debug_nans`` is on.
_UNINITIALIZED = frozenset(("empty", "empty_like", "empty_strided",
                            "new_empty", "new_empty_strided",
                            "empty_permuted"))


def _has_nan(t: torch.Tensor) -> bool:
    return ((t.is_floating_point() or t.is_complex()) and t.numel() > 0
            and t.layout == torch.strided and t.device.type != "meta"
            and bool(torch.isnan(t).any()))


def _nan_mode():
    """A ``TorchDispatchMode`` raising ``FloatingPointError`` at the first
    op with a NaN in its output, while ``kernels.nan_check`` is set."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from .. import kernels

    class NanCheck(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not kernels.nan_check:
                return out
            if func.overloadpacket.__name__ in _UNINITIALIZED:
                for t in _leaves(out):
                    if t.is_floating_point() or t.is_complex():
                        t.zero_()
                return out
            if any(_has_nan(t) for t in _leaves(out)):
                raise FloatingPointError(
                    f"invalid value (nan) encountered in {func}")
            return out

    return NanCheck()


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Temporarily toggle NaN checking (see the module docstring for how it
    differs from the JAX package's): inside ``debug_nans(True)`` the first
    op or kernel launch whose floating output holds a NaN raises
    ``FloatingPointError``; ``debug_nans(False)`` turns the checks off
    inside an enclosing ``debug_nans(True)``."""
    from .. import kernels
    prev = kernels.nan_check
    kernels.nan_check = bool(enable)
    try:
        if enable:
            with _nan_mode():
                yield
        else:
            yield
    finally:
        kernels.nan_check = prev
