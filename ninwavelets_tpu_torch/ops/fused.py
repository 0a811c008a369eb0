"""Fused epoch reductions: bank x spectrum x inverse DFT x |.|^2 / unit phase
x epoch sum in one hand-written CUDA kernel (port of the forward path of
``ninwavelets_tpu.ops.fused``; kernel source ``csrc/fused_cwt.cu``).

Dispatch, with no fallback that hides the device or the kernel:

* the ``fused_*_from_bank`` wrappers run the plain version (``ops.cwt``) for
  a tensor on the CPU, and only then.  For a CUDA tensor they launch the
  kernel, or raise if the kernel does not take the workload or the build or
  launch fails;
* the ``*_auto`` entry points take the fused wrapper when ``supports()``
  accepts the workload and the signals are real, and the plain path
  otherwise (complex signals, a complex bank, a signal length outside the
  kernel's range, a bank built for another length), on whatever device the
  tensors are.

The signal FFT runs outside the kernel, as ``torch.fft.rfft`` on the analytic
path (``interpolate=True``) and ``torch.fft.fft`` otherwise.  Everything from
bank x spectrum to the epoch reduction is inside the kernel, in float32.
"""
from __future__ import annotations

import torch

from .. import kernels
from .cwt import itc_from_bank, mean_power_from_bank

#: Precision names the wrappers take.  The CUDA kernel computes in float32
#: for every name (float32 meets the tightest, "exact", tolerance).
PRECISIONS = ("fast3", "exact", "bf16")
DEFAULT_PRECISION = "fast3"


def supports(signals_shape, bank, epilogue: str = "power") -> bool:
    """True when the fused kernel takes this workload: an (E, C, N) batch
    with E >= 1 and 1 <= C <= 65535, N a power of two in [256, 16384], and a
    real floating (F, N) bank built for the same N.  Any epoch count works
    for every epilogue: the kernel loops over all epochs and never pads one
    in.  A CUDA workload this rejects runs the plain torch path on the card
    through the ``*_auto`` entry points."""
    del epilogue
    if bank is None or len(signals_shape) != 3:
        return False
    e, c, n = signals_shape
    if bank.ndim != 2 or bank.shape[-1] != n or bank.shape[0] < 1:
        return False
    if bank.is_complex() or not bank.is_floating_point():
        return False
    return (e >= 1 and 1 <= c <= 65535 and kernels.MIN_N <= n <= kernels.MAX_N
            and n & (n - 1) == 0)


def _check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}")


def _kernel_takes(signals: torch.Tensor, bank) -> bool:
    """``supports()`` plus real signals: the kernel's spectra are those of a
    real signal (an rFFT on the analytic path)."""
    return not signals.is_complex() and supports(signals.shape, bank)


def _launch(epilogue, signals, bank, interpolate, precision):
    """Spectra outside the kernel, then one kernel launch."""
    if not _kernel_takes(signals, bank):
        raise ValueError(
            f"the fused kernel does not take {signals.dtype} signals "
            f"{tuple(signals.shape)} with bank {tuple(bank.shape)} "
            f"{bank.dtype}; see supports()")
    n = signals.shape[-1]
    signals = signals.to(torch.float32)
    if interpolate:
        spec, k_bins = torch.fft.rfft(signals), n // 2
    else:
        spec, k_bins = torch.fft.fft(signals), n
    return kernels.fused_cwt(epilogue, spec.contiguous(),
                             bank.to(torch.float32).contiguous(), k_bins,
                             precision)


def fused_mean_power_from_bank(signals: torch.Tensor, bank: torch.Tensor,
                               interpolate: bool = True,
                               precision: str = DEFAULT_PRECISION
                               ) -> torch.Tensor:
    """Epoch-mean power TFR: (E, C, N) x (F, N) -> (C, F, N) float32, equal
    to ``ops.cwt.mean_power_from_bank`` at float32 tolerance."""
    _check_precision(precision)
    if signals.device.type == "cpu":
        return mean_power_from_bank(signals, bank, interpolate)
    return _launch("power", signals, bank, interpolate, precision)[0]


def fused_itc_from_bank(signals: torch.Tensor, bank: torch.Tensor,
                        interpolate: bool = True,
                        precision: str = DEFAULT_PRECISION) -> torch.Tensor:
    """Inter-trial coherence ``| mean_E cwt/|cwt| |``: (E, C, N) x (F, N) ->
    (C, F, N) float32.  A zero coefficient gives NaN, as in the reference.

    The unit-phase division amplifies coefficient round-off where |c| is
    near zero, so ITC differs from the plain path most in cells of
    negligible power."""
    _check_precision(precision)
    if signals.device.type == "cpu":
        return itc_from_bank(signals, bank, interpolate)
    return _launch("itc", signals, bank, interpolate, precision)[0]


def fused_power_itc_from_bank(signals: torch.Tensor, bank: torch.Tensor,
                              interpolate: bool = True,
                              precision: str = DEFAULT_PRECISION):
    """Epoch-mean power AND inter-trial coherence off one pass:
    (E, C, N) x (F, N) -> ((C, F, N), (C, F, N))."""
    _check_precision(precision)
    if signals.device.type == "cpu":
        return (mean_power_from_bank(signals, bank, interpolate),
                itc_from_bank(signals, bank, interpolate))
    power, itc = _launch("power_itc", signals, bank, interpolate, precision)
    return power, itc


def mean_power_auto(signals: torch.Tensor, bank: torch.Tensor, *,
                    interpolate: bool = False,
                    precision: str = DEFAULT_PRECISION) -> torch.Tensor:
    """Epoch-mean power with automatic kernel dispatch (see the module
    docstring); the same result either way."""
    if _kernel_takes(signals, bank):
        return fused_mean_power_from_bank(signals, bank, interpolate,
                                          precision)
    return mean_power_from_bank(signals, bank, interpolate)


def itc_auto(signals: torch.Tensor, bank: torch.Tensor, *,
             interpolate: bool = False,
             precision: str = DEFAULT_PRECISION) -> torch.Tensor:
    """Inter-trial coherence with automatic kernel dispatch."""
    if _kernel_takes(signals, bank):
        return fused_itc_from_bank(signals, bank, interpolate, precision)
    return itc_from_bank(signals, bank, interpolate)


def power_itc_auto(signals: torch.Tensor, bank: torch.Tensor, *,
                   interpolate: bool = False,
                   precision: str = DEFAULT_PRECISION):
    """(power, itc) with automatic kernel dispatch: one fused pass where the
    kernel takes the workload, the two plain reductions otherwise."""
    if _kernel_takes(signals, bank):
        return fused_power_itc_from_bank(signals, bank, interpolate,
                                         precision)
    return (mean_power_from_bank(signals, bank, interpolate),
            itc_from_bank(signals, bank, interpolate))
