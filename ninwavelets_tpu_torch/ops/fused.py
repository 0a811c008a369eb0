"""Fused epoch reductions: bank x spectrum x inverse DFT x |.|^2 / unit phase
x epoch sum in one hand-written CUDA kernel, the per-signal power (no
reduction) through the same kernel's "power_each" epilogue, the power's
backward in a second kernel, and synchrosqueezing through the forward
kernel's "amax" epilogue (the noise gate's peaks) and a third kernel (port
of ``ninwavelets_tpu.ops.fused``; kernel sources ``csrc/fused_cwt.cu``,
``csrc/fused_cwt_bwd.cu`` and ``csrc/fused_ssq.cu``).

Dispatch, with no fallback that hides the device or the kernel:

* the ``fused_*_from_bank`` wrappers run the plain version (``ops.cwt``) for
  a tensor on the CPU, and only then.  For a CUDA tensor they launch the
  kernel, or raise if the kernel does not take the workload or the build or
  launch fails;
* the ``*_auto`` entry points take the fused wrapper when ``supports()``
  accepts the workload and the signals are real, and the plain path
  otherwise (complex signals, a complex bank, a signal length outside the
  kernel's range, a bank built for another length), on whatever device the
  tensors are.  ``ops.sst.ssq_mean_power`` and ``ssq_power`` dispatch the
  same way on ``supports_ssq()``, and only for CUDA tensors.

The signal FFT runs outside the kernel, as ``torch.fft.rfft`` on the analytic
path (``interpolate=True``) and ``torch.fft.fft`` otherwise.  Everything from
bank x spectrum to the epoch reduction is inside the kernel, in float32.

Gradients, as in the JAX package's custom VJPs:

* ``fused_mean_power_from_bank`` is an autograd Function on every device.
  Its backward is the analytic adjoint: the fused backward kernel on the
  card, ``mean_power_bwd`` (its plain version) on the CPU.  It saves only
  its inputs, and recomputes the coefficients.
* ``fused_itc_from_bank`` is an autograd Function whose backward
  differentiates the plain ``itc_from_bank`` (the JAX package does the same
  with ``jax.vjp``).
* ``fused_power_itc_from_bank`` and ``fused_power_from_bank`` have no
  derivative (the JAX package gives them none): on the card they raise when
  an input requires grad.  On the CPU they are the plain versions, which
  torch differentiates.
"""
from __future__ import annotations

import torch

from .. import kernels
from .cwt import (analytic_spectrum, itc_from_bank, mean_power_from_bank,
                  power_from_bank)
from .grids import analytic_mask
from .sst import ssq_mean_power_from_bank, ssq_power_from_bank

#: Precision names the wrappers take.  The CUDA kernel computes in float32
#: for every name (float32 meets the tightest, "exact", tolerance).
PRECISIONS = ("fast3", "exact", "bf16")
DEFAULT_PRECISION = "fast3"
#: Signals a per-signal synchrosqueezing launch takes: they ride the
#: kernel's channel axis, a grid axis of at most 65535 blocks.
MAX_SSQ_SIGNALS = 65535


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


def mean_power_bwd(signals: torch.Tensor, bank: torch.Tensor,
                   interpolate: bool, g: torch.Tensor):
    """Analytic adjoint of ``mean_power_from_bank``: the cotangent g of the
    (C, F, N) power plane -> ``(ds, dbank)``, shaped like ``signals`` and
    ``bank`` (port of ``_mean_power_bwd`` and ``_mean_power_bwd_complex``,
    ``ninwavelets_tpu/ops/fused.py:753-831``).  The plain version of the
    fused backward kernel, and what the CPU runs.

    Per epoch, with S = the (masked) spectrum and x = ifft(bank S):
    u = fft((2/E) g x); t = sum_f conj(bank) u; ds = ifft(mask t) (its real
    part for real signals); dbank = sum_{e,c} u conj(S) / N (its real part
    for a real bank).  One epoch at a time, so memory stays O(C F N).

    A complex bank gets PyTorch's gradient convention, sum u conj(S) / N:
    the conjugate of the JAX package's sum conj(u) S / N.  Both describe
    the same derivative; gradient descent steps against PyTorch's.
    """
    e, n = signals.shape[0], signals.shape[-1]
    scale = 2.0 / e
    mask = (analytic_mask(n, torch.float32, signals.device) if interpolate
            else None)
    cbank = bank.conj() if bank.is_complex() else bank
    ds = torch.empty_like(signals)
    dbank = torch.zeros_like(bank)
    for i, sig in enumerate(signals):
        spec = analytic_spectrum(sig, interpolate)[..., None, :]    # (C,1,N)
        u = torch.fft.fft(scale * g * torch.fft.ifft(spec * bank))
        t = (cbank * u).sum(-2)
        if mask is not None:
            t = t * mask
        ds_e = torch.fft.ifft(t)
        ds[i] = ds_e if signals.is_complex() else ds_e.real
        prod = (u * spec.conj()).sum(0) / n
        dbank += prod if bank.is_complex() else prod.real
    return ds, dbank


def _fused_power_bwd(signals: torch.Tensor, bank: torch.Tensor,
                     g: torch.Tensor, interpolate: bool):
    """``mean_power_bwd`` through the fused backward kernel (real signals
    and bank on the card): the spectra, one launch, then the sums and the
    one inverse FFT that complete it, as the JAX package's
    ``_fused_power_bwd`` does in XLA."""
    n = signals.shape[-1]
    signals32 = signals.to(torch.float32)
    if interpolate:
        spec, k_bins = torch.fft.rfft(signals32), n // 2
    else:
        spec, k_bins = torch.fft.fft(signals32), n
    dbank_part, t_part = kernels.fused_cwt_bwd(
        spec.contiguous(), bank.to(torch.float32).contiguous(),
        g.to(torch.float32).contiguous(), k_bins)
    dbank = torch.nn.functional.pad(dbank_part.sum(0) / n, (0, n - k_bins))
    ds = torch.fft.ifft(t_part.sum(0), n=n).real
    return ds.to(signals.dtype), dbank.to(bank.dtype)


class _FusedMeanPower(torch.autograd.Function):
    """Epoch-mean power with the analytic adjoint as its backward (port of
    ``_fused_power_mean_vjp``): the kernels on the card, the plain versions
    on the CPU.  Saves the inputs only."""

    @staticmethod
    def forward(ctx, signals, bank, interpolate, precision):
        ctx.interpolate = interpolate
        ctx.save_for_backward(signals, bank)
        if signals.device.type == "cpu":
            return mean_power_from_bank(signals, bank, interpolate)
        return _launch("power", signals, bank, interpolate, precision)[0]

    @staticmethod
    def backward(ctx, g):
        signals, bank = ctx.saved_tensors
        need_s, need_b = ctx.needs_input_grad[:2]
        if not (need_s or need_b):
            return None, None, None, None
        if signals.device.type == "cpu":
            ds, dbank = mean_power_bwd(signals, bank, ctx.interpolate, g)
        else:
            ds, dbank = _fused_power_bwd(signals, bank, g, ctx.interpolate)
        return (ds if need_s else None), (dbank if need_b else None), \
            None, None


class _FusedItc(torch.autograd.Function):
    """ITC whose backward differentiates the plain ``itc_from_bank`` (port
    of ``_fused_itc_vjp``): the forward is the kernel on the card, the plain
    path on the CPU."""

    @staticmethod
    def forward(ctx, signals, bank, interpolate, precision):
        ctx.interpolate = interpolate
        ctx.save_for_backward(signals, bank)
        if signals.device.type == "cpu":
            return itc_from_bank(signals, bank, interpolate)
        return _launch("itc", signals, bank, interpolate, precision)[0]

    @staticmethod
    def backward(ctx, g):
        signals, bank = ctx.saved_tensors
        need = ctx.needs_input_grad[:2]
        inputs = [x.detach().requires_grad_(n) for x, n in
                  zip((signals, bank), need)]
        wanted = [x for x, n in zip(inputs, need) if n]
        if not wanted:
            return None, None, None, None
        with torch.enable_grad():
            grads = iter(torch.autograd.grad(
                itc_from_bank(*inputs, ctx.interpolate), wanted, g))
        return tuple(next(grads) if n else None for n in need) + (None, None)


def _no_grad_on_card(name, instead, *tensors) -> None:
    """Raise when an input of a function with no derivative requires grad
    (its kernel output would silently carry none)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no derivative on the card; for "
                           f"gradients call {instead}")


def fused_mean_power_from_bank(signals: torch.Tensor, bank: torch.Tensor,
                               interpolate: bool = True,
                               precision: str = DEFAULT_PRECISION
                               ) -> torch.Tensor:
    """Epoch-mean power TFR: (E, C, N) x (F, N) -> (C, F, N) float32, equal
    to ``ops.cwt.mean_power_from_bank`` at float32 tolerance, and
    differentiable in both arguments (see the module docstring)."""
    _check_precision(precision)
    return _FusedMeanPower.apply(signals, bank, interpolate, precision)


def fused_itc_from_bank(signals: torch.Tensor, bank: torch.Tensor,
                        interpolate: bool = True,
                        precision: str = DEFAULT_PRECISION) -> torch.Tensor:
    """Inter-trial coherence ``| mean_E cwt/|cwt| |``: (E, C, N) x (F, N) ->
    (C, F, N) float32, differentiable in both arguments.  A zero coefficient
    gives NaN, as in the reference.

    The unit-phase division amplifies coefficient round-off where |c| is
    near zero, so ITC differs from the plain path most in cells of
    negligible power."""
    _check_precision(precision)
    return _FusedItc.apply(signals, bank, interpolate, precision)


def fused_power_itc_from_bank(signals: torch.Tensor, bank: torch.Tensor,
                              interpolate: bool = True,
                              precision: str = DEFAULT_PRECISION):
    """Epoch-mean power AND inter-trial coherence off one pass:
    (E, C, N) x (F, N) -> ((C, F, N), (C, F, N)).  Not differentiable on the
    card: it raises there when an input requires grad."""
    _check_precision(precision)
    if signals.device.type == "cpu":
        return (mean_power_from_bank(signals, bank, interpolate),
                itc_from_bank(signals, bank, interpolate))
    _no_grad_on_card("fused_power_itc_from_bank",
                     "fused_mean_power_from_bank and fused_itc_from_bank, "
                     "which are differentiable", signals, bank)
    power, itc = _launch("power_itc", signals, bank, interpolate, precision)
    return power, itc


def fused_power_from_bank(signals: torch.Tensor, bank: torch.Tensor,
                          interpolate: bool = True,
                          precision: str = DEFAULT_PRECISION
                          ) -> torch.Tensor:
    """Per-signal ``|cwt|**2``: (..., N) x (F, N) -> (..., F, N) float32
    (port of ``ninwavelets_tpu/ops/fused.py:fused_power_from_bank``).

    The lead dims flatten onto the kernel's epoch axis as (B, 1, N) and the
    "power_each" epilogue writes every signal's plane, scaled 1/N^2 (no
    1/E).  The kernel takes any B in one launch.  On the CPU this is the
    plain ``ops.cwt.power_from_bank``; on the card it launches the kernel
    or raises (also when an input requires grad: there is no derivative).
    """
    _check_precision(precision)
    if signals.device.type == "cpu":
        return power_from_bank(signals, bank, interpolate)
    _no_grad_on_card("fused_power_from_bank", "ops.cwt.power_from_bank",
                     signals, bank)
    lead, n = signals.shape[:-1], signals.shape[-1]
    out = _launch("power_each", signals.reshape(-1, 1, n), bank, interpolate,
                  precision)[0]
    return out.reshape(*lead, bank.shape[0], n)


def power_auto(signals: torch.Tensor, bank: torch.Tensor, *,
               interpolate: bool = False,
               precision: str = DEFAULT_PRECISION) -> torch.Tensor:
    """Per-signal power with automatic kernel dispatch: the kernel where
    ``supports()`` accepts the flattened (B, 1, N) batch and the signals are
    real, the plain ``power_from_bank`` otherwise."""
    if _kernel_takes(signals.reshape(-1, 1, signals.shape[-1]), bank):
        return fused_power_from_bank(signals, bank, interpolate, precision)
    return power_from_bank(signals, bank, interpolate)


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


# -- synchrosqueezing ---------------------------------------------------------

def supports_ssq(signals_shape, bank, uniform_grid, interpolate: bool) -> bool:
    """True when the synchrosqueezing kernels take this workload: what
    ``supports()`` takes (an (E, C, N) batch, 1 <= C <= 65535, N a power of
    two in [256, 16384], a real (F, N) bank built for that N), the analytic
    path (``interpolate=True``), and a single "lin" or "log" row map (a
    piecewise or irregular grid runs the plain path)."""
    if uniform_grid is None or uniform_grid[0] not in ("lin", "log"):
        return False
    return bool(interpolate) and supports(signals_shape, bank)


def ssq_kernel_takes(signals: torch.Tensor, bank, uniform_grid,
                     interpolate: bool) -> bool:
    """``supports_ssq()`` for real signals on a CUDA device: the dispatchers'
    test."""
    return (signals.device.type == "cuda" and not signals.is_complex()
            and supports_ssq(signals.shape, bank, uniform_grid, interpolate))


def signal_batch(signals: torch.Tensor) -> torch.Tensor:
    """The (1, B, N) view of (..., N) per-signal work, cut to the signals
    of one launch (``MAX_SSQ_SIGNALS``): what ``supports_ssq()`` checks for
    ``fused_ssq_power_from_bank``."""
    return signals.reshape(1, -1, signals.shape[-1])[:, :MAX_SSQ_SIGNALS]


def _spectra(signals: torch.Tensor, bank: torch.Tensor):
    """The kernels' inputs on the analytic path: contiguous rFFT rows and a
    contiguous float32 bank."""
    return (torch.fft.rfft(signals.to(torch.float32)).contiguous(),
            bank.to(torch.float32).contiguous())


def _peaks(spec: torch.Tensor, bank: torch.Tensor) -> torch.Tensor:
    """(C, E) peak power of each (epoch, channel): one "amax" launch for the
    (C, F, E) row peaks, the max over rows in torch."""
    return kernels.fused_cwt("amax", spec, bank, bank.shape[-1] // 2,
                             DEFAULT_PRECISION)[0].amax(1)


def ssq_peaks(signals: torch.Tensor, bank: torch.Tensor) -> torch.Tensor:
    """(E, C, N) real signals x (F, N) real bank -> (C, E): the peak of
    each (epoch, channel)'s |cwt|^2 plane on the analytic path, which scales
    the synchrosqueezing noise gate.  The "amax" epilogue on the card (it
    launches or raises); on the CPU the plain max of ``power_from_bank``."""
    if signals.device.type == "cpu":
        return power_from_bank(signals, bank, True).amax(dim=(-2, -1)).T
    return _peaks(*_spectra(signals, bank))


def _fused_ssq_sum(signals: torch.Tensor, bank: torch.Tensor, uniform_grid,
                   sfreq: float, rel_threshold: float) -> torch.Tensor:
    """(E, C, N) real signals -> (C, F, N) epoch SUM of the reassigned
    power: the rFFT, the (C, E) floors from one "amax" launch, one
    synchrosqueezing launch."""
    spec, bank = _spectra(signals, bank)
    floors = (rel_threshold * _peaks(spec, bank)).contiguous()
    return kernels.fused_ssq(spec, bank, floors, uniform_grid, sfreq)


def _check_ssq(signals: torch.Tensor, bank: torch.Tensor, uniform_grid,
               interpolate: bool) -> None:
    if signals.is_complex() or not supports_ssq(signals.shape, bank,
                                                uniform_grid, interpolate):
        raise ValueError(
            f"the synchrosqueezing kernels do not take {signals.dtype} "
            f"signals {tuple(signals.shape)} with bank {tuple(bank.shape)} "
            f"{bank.dtype}, row map {uniform_grid!r}, interpolate="
            f"{interpolate}; see supports_ssq()")
    _no_grad_on_card("the synchrosqueezing kernels",
                     "ops.sst.ssq_mean_power_from_bank", signals, bank)


def fused_ssq_mean_power(signals: torch.Tensor, bank: torch.Tensor, *,
                         uniform_grid, sfreq: float,
                         rel_threshold: float = 1e-6,
                         interpolate: bool = True) -> torch.Tensor:
    """Epoch-mean synchrosqueezed power through the kernels: (E, C, N) real
    signals x (F, N) real bank -> (C, F, N) float32 (port of
    ``ninwavelets_tpu/ops/fused.py:fused_ssq_mean_power``).

    The same gate (per (epoch, channel)) and closed-form row map as
    ``ops.sst.ssq_mean_power_from_bank``, which is what runs for a CPU
    tensor.  On the card: one "amax" launch and one synchrosqueezing launch
    for any E (the kernels loop over all epochs; none is padded in), or a
    ValueError for a workload ``supports_ssq()`` rejects.  Cells whose
    instantaneous frequency sits on a row edge may land in the neighbouring
    row (float32 rounding differs between the two paths); each time column's
    energy is the same.  Not differentiable.
    """
    if signals.device.type == "cpu":
        return ssq_mean_power_from_bank(signals, bank, None, sfreq,
                                        interpolate, rel_threshold,
                                        uniform_grid)
    _check_ssq(signals, bank, uniform_grid, interpolate)
    return _fused_ssq_sum(signals, bank, uniform_grid, sfreq,
                          rel_threshold) / signals.shape[0]


def _fused_ssq_each(signals: torch.Tensor, bank: torch.Tensor, uniform_grid,
                    sfreq: float, rel_threshold: float) -> torch.Tensor:
    """Per-signal synchrosqueezed power through the kernels: (..., N) ->
    (..., F, N).  The signals flatten onto the channel axis as (1, B, N), in
    launches of at most ``MAX_SSQ_SIGNALS``; with one epoch the
    (epoch, channel) floor is each signal's own."""
    lead, n = signals.shape[:-1], signals.shape[-1]
    flat = signals.reshape(1, -1, n)
    out = torch.cat([
        _fused_ssq_sum(flat[:, lo:lo + MAX_SSQ_SIGNALS], bank, uniform_grid,
                       sfreq, rel_threshold)
        for lo in range(0, flat.shape[1], MAX_SSQ_SIGNALS)])
    return out.reshape(*lead, bank.shape[0], n)


def fused_ssq_power_from_bank(signals: torch.Tensor, bank: torch.Tensor, *,
                              uniform_grid, sfreq: float,
                              rel_threshold: float = 1e-6,
                              interpolate: bool = True) -> torch.Tensor:
    """Per-signal synchrosqueezed power: (..., N) real x (F, N) real bank ->
    (..., F, N) float32, each signal gated against its own peak, as
    ``ops.sst.ssq_power_from_bank`` (what runs for a CPU tensor).  On the
    card it launches the kernels or raises."""
    if signals.device.type == "cpu":
        return ssq_power_from_bank(signals, bank, None, sfreq, interpolate,
                                   rel_threshold, uniform_grid)
    _check_ssq(signal_batch(signals), bank, uniform_grid, interpolate)
    return _fused_ssq_each(signals, bank, uniform_grid, sfreq, rel_threshold)
