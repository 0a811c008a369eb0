"""Fused epoch reductions: bank x spectrum x inverse DFT x |.|^2 / unit phase
x epoch sum in one hand-written CUDA kernel, the per-signal power (no
reduction) through the same kernel's "power_each" epilogue, the power's
backward in a second kernel, synchrosqueezing through the forward kernel's
"amax" epilogue (the noise gate's peaks) and a third kernel, and the
cross-pair epoch sums of connectivity in a fourth (port of
``ninwavelets_tpu.ops.fused``; kernel sources ``csrc/fused_cwt.cu``,
``csrc/fused_cwt_bwd.cu``, ``csrc/fused_ssq.cu`` and
``csrc/fused_pair.cu``).

Dispatch, with no fallback that hides the device or the kernel:

* the ``fused_*_from_bank`` wrappers run the plain version (``ops.cwt``) for
  a tensor on the CPU, and only then.  For a CUDA tensor they launch the
  kernel, or raise if the kernel does not take the workload or the build or
  launch fails;
* every kernel dispatcher of the port asks ``route()`` and nothing else:
  the ``*_auto`` entry points here and in ``ops.connectivity`` and
  ``ops.extensions``, ``ops.sst.ssq_power`` and ``ssq_mean_power``,
  ``ops.scattering.scattering``, ``parallel.chunked_power_auto``, the
  ``parallel.distributed_*`` reductions and ``StreamingCWT``.  A new kernel
  route is added in ``route()`` and nowhere else;
* the ``*_auto`` entry points take the fused wrapper where ``route()``
  says the kernel takes the workload (real signals, and what ``supports()``
  accepts), on whatever device the tensors are, and the plain path
  otherwise (complex signals, a signal length outside the kernel's range, a
  bank built for another length).  ``ops.sst.ssq_mean_power`` and
  ``ssq_power`` take the synchrosqueezing kernels the same way, and only
  for CUDA tensors;
* a complex (Normal/Twice-mode: MexicanHat, Haar) bank reaches the kernels
  through the three epoch reductions only, as in the JAX package:
  ``route()`` asks ``why_not()`` about its real part for them, and
  ``fused_mean_power_from_bank`` (its backward too), ``fused_itc_from_bank``
  and ``fused_power_itc_from_bank`` launch the complex-bank kernels for it.
  ``supports()`` itself rejects a complex bank, so every other dispatcher
  (``power_auto``, streaming, scattering, synchrosqueezing, the pair
  ``*_auto``) runs the plain path for it;
* the same three reductions take a second kernel, the chirp-z one
  (``csrc/fused_czt.cu``), for real CUDA signals and a real CUDA bank whose
  N ``why_not()`` refuses only as "n_not_pow2", with 256 < N <= 2048 (M =
  1024, 2048 or 4096 points), such as MNE's 2001.  It computes the same
  N-point transform as a Bluestein convolution over M-point transforms of
  the core; ``czt_from_bank`` / ``czt_reduction`` are its plain version.
  Its backward differentiates the plain route.  On the CPU, for a complex
  bank, and for other N, the routes are as above.

``why_not()`` holds the shape rule once and says which part of it a
workload fails; ``supports()`` is ``why_not() is None``.  ``route()`` adds
the signals, the device and the family's own rules to it, and names the
span each dispatcher opens around its transform (``transform_span``):
``ninw.transform.kernel:<launch key>`` (the complex-bank keys are
``<epilogue>_cx``, the chirp-z ones ``<epilogue>_czt``, and "power_each"
at N = 32768, two 16384-point transforms of the core, is
``power_each_split``), or ``ninw.transform.plain:<reason>``.

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
* ``fused_power_itc_from_bank``, ``fused_power_from_bank`` and the pair
  wrappers (``fused_coherence_sums``, ``fused_phase_lag_sums``,
  ``fused_plv_sums`` and the statistics built on them) have no derivative
  (the JAX package gives them none): on the card they raise when an input
  requires grad.  On the CPU they are the plain versions, which torch
  differentiates.

The pair wrappers take two (E, C, N) batches, channel a and channel b of C
pairs, and run both spectra and one cross-pair launch for any E: the kernel
loops over every epoch of both inside a block, so the JAX package's pair
chunks (half its epoch cap, zero-padded or with a remainder call) have no
counterpart here.  The pair dispatchers (``*_auto`` in ``ops.extensions``
and ``ops.connectivity``) take them where ``route()`` accepts the
channel-a batch: a single pair given as (E, N), as the adapter's pair
methods give it, runs the plain sums, as in the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import kernels
from ..utils.observability import span
from .connectivity import (phase_lag_from_sums, phase_lag_sums,
                           plv_sums)
from .cwt import (_epoch_sum, analytic_spectrum, itc_from_bank,
                  mean_power_from_bank, power_from_bank, power_itc_from_bank,
                  power_term, unit_phase)
from .extensions import coherence_from_sums, coherence_sums, imcoh_from_sums
from .grids import analytic_mask
from .sst import ssq_mean_power_from_bank, ssq_power_from_bank

#: Precision names the wrappers take.  The CUDA kernel computes in float32
#: for every name (float32 meets the tightest, "exact", tolerance).
PRECISIONS = ("fast3", "exact", "bf16")
DEFAULT_PRECISION = "fast3"
#: Signals a per-signal synchrosqueezing launch takes: they ride the
#: kernel's channel axis, a grid axis of at most 65535 blocks.
MAX_SSQ_SIGNALS = 65535


def why_not(signals_shape, bank, family: str = "power"):
    """Why the fused kernel of ``family`` does not take this workload, or
    None when it does: "shape" (not an (E, C, N) batch with E >= 1, or not
    an (F, N) bank built for the same N), "complex_bank" (a complex or
    integer bank), "channels" (C outside 1..65535), "n_not_pow2" (N not a
    power of two) or "n_range" (N outside [256, 16384]; [256, 32768] for
    "power_each"), the first that applies.  ``route()`` adds the reasons
    that are not the shape's."""
    if bank is None or len(signals_shape) != 3:
        return "shape"
    e, c, n = signals_shape
    if bank.ndim != 2 or bank.shape[-1] != n or bank.shape[0] < 1 or e < 1:
        return "shape"
    if bank.is_complex() or not bank.is_floating_point():
        return "complex_bank"
    if not 1 <= c <= 65535:
        return "channels"
    if n & (n - 1) != 0:
        return "n_not_pow2"
    top = kernels.EACH_MAX_N if family == "power_each" else kernels.MAX_N
    if not kernels.MIN_N <= n <= top:
        return "n_range"
    return None


def supports(signals_shape, bank, epilogue: str = "power") -> bool:
    """True when the fused kernel of ``epilogue`` takes this workload
    (``why_not()`` finds nothing): an (E, C, N) batch with E >= 1 and
    1 <= C <= 65535, N a power of two in [256, 16384] ([256, 32768] for
    "power_each"), and a real floating (F, N) bank built for the same N.
    Any epoch count works for every epilogue: the kernel loops over
    all epochs and never pads one in.  A CUDA workload this rejects runs the
    plain torch path on the card through the ``*_auto`` entry points; for
    the three epoch reductions ``route()`` asks it about a complex bank's
    real part, as the JAX package does, and so takes the complex-bank
    kernels."""
    return why_not(signals_shape, bank, epilogue) is None


def transform_span(kernel: str, why) -> str:
    """The name of the span around one transform: ``ninw.transform.kernel:
    <kernel>`` (the key the launches count under) where the kernel runs,
    ``ninw.transform.plain:<why>`` where the plain chain does."""
    if why is None:
        return "ninw.transform.kernel:" + kernel
    return "ninw.transform.plain:" + why


class Route(NamedTuple):
    """``route()``'s answer.

    ``takes``: the dispatcher calls the family's fused entry, which
    launches the kernel on the card and runs its plain version on the CPU.
    ``key``: where it takes, the key the kernel's launches count under in
    ``kernels.launches``; None otherwise.  ``why``: None where the kernel
    launches, else the reason the plain chain runs the transform."""
    takes: bool
    key: Optional[str]
    why: Optional[str]

    @property
    def launch(self) -> bool:
        """The kernel launches: it takes the workload, on a CUDA device."""
        return self.why is None

    @property
    def span(self) -> str:
        """The name of the span around the transform (``transform_span``)."""
        return transform_span(self.key, self.why)


def route(family: str, signals, bank, *, device=None, czt: bool = False,
          grid=None, interpolate: bool = True, eps: float = 0.0,
          use_fused: bool = True) -> Route:
    """Whether the kernel of ``family`` takes this workload here, under
    which launch key, and if not, why: the one rule every kernel
    dispatcher of the port asks.

    Args:
      family: an epoch reduction ("power", "itc", "power_itc"), which also
        takes a complex bank, asked about by its real part, under the key
        "<family>_cx"; "power_each", under the key "power_each_split" at
        N above ``kernels.MAX_N``; a cross-pair epilogue ("coherence",
        "phaselag", "plv"), asked about the channel-a batch; or "ssq".
      signals: the (E, C, N) tensor the kernel would be handed, or the
        shape of real signals on ``device``.
      bank: the (F, N) bank.
      device: where the signals are, when ``signals`` is a shape.
      czt: an epoch reduction's chirp-z route: real signals and a real bank
        on the card whose N ``why_not()`` refuses only as "n_not_pow2",
        with MIN_N < N and 2N - 1 <= CZT_MAX_M, launch it under
        "<family>_czt".  It has no CPU branch.
      grid, interpolate: the row map and path, for "ssq".
      eps: the statistic's floor, for "plv": the kernel has none.
      use_fused: False where the caller turned the kernels off.

    The reasons, the first that applies: ``why_not()``'s ("shape",
    "complex_bank", "channels", "n_not_pow2", "n_range"), or for "ssq"
    ``why_not_ssq()``'s ("row_map", "interpolate", then ``why_not()``'s);
    "complex_signals"; "eps" (a nonzero floor for "plv"); "cpu" (the kernel
    would take the workload on a card; the fused entry takes it unless
    ``use_fused`` is False); "off" (on a card, ``use_fused`` False)."""
    if isinstance(signals, tuple):
        shape, cx_signals = signals, False
    else:
        shape, cx_signals = signals.shape, signals.is_complex()
        device = signals.device if device is None else device
    on_card = torch.device(device).type == "cuda"
    key = family
    if family == "ssq":
        why = why_not_ssq(shape, bank, grid, interpolate)
    elif (family in kernels.COMPLEX_EPILOGUES and bank is not None
          and bank.is_complex()):
        why, key = why_not(shape, bank.real), family + "_cx"
    else:
        why = why_not(shape, bank, family)
        if family == "power_each" and shape[-1] > kernels.MAX_N:
            key = "power_each_split"
        if (czt and why == "n_not_pow2" and kernels.MIN_N < shape[-1]
                and 2 * shape[-1] - 1 <= kernels.CZT_MAX_M
                and not cx_signals and on_card
                and bank.device.type == "cuda"):
            return Route(True, family + "_czt", None)
    if why is None and cx_signals:
        why = "complex_signals"
    if why is None and family == "plv" and eps != 0.0:
        why = "eps"
    takes = why is None and use_fused
    if why is None and not on_card:
        why = "cpu"
    elif why is None and not use_fused:
        why = "off"
    return Route(takes, key if takes else None, why)


def _check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}")


def _kernel_bank(bank: torch.Tensor) -> torch.Tensor:
    """The bank as the kernels read it: contiguous float32, or complex64."""
    return bank.to(torch.complex64 if bank.is_complex()
                   else torch.float32).contiguous()


def _launch(epilogue, signals, bank, interpolate, precision):
    """Spectra outside the kernel, then one kernel launch."""
    spec, k_bins = _kernel_spectrum(epilogue, signals, bank, interpolate)
    return kernels.fused_cwt(epilogue, spec, _kernel_bank(bank), k_bins,
                             precision)


def _kernel_spectrum(epilogue, signals, bank, interpolate):
    """``_spectrum`` of (E, C, N) signals the ``epilogue`` kernel takes, or
    ValueError.  A complex bank is taken for the epilogues of
    ``kernels.COMPLEX_EPILOGUES``."""
    if not route(epilogue, signals, bank).takes:
        raise ValueError(
            f"the fused kernel ({epilogue!r}) does not take {signals.dtype} "
            f"signals {tuple(signals.shape)} with bank {tuple(bank.shape)} "
            f"{bank.dtype}; see supports()")
    return _spectrum(signals, interpolate)


def _spectrum(signals: torch.Tensor, interpolate: bool):
    """(spectra, K) as the kernels read them: the contiguous rFFT rows and
    K = N/2 on the analytic path, the FFT rows and K = N otherwise."""
    n = signals.shape[-1]
    signals = signals.to(torch.float32)
    if interpolate:
        return torch.fft.rfft(signals).contiguous(), n // 2
    return torch.fft.fft(signals).contiguous(), n


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
    """``mean_power_bwd`` through the fused backward kernel (real signals,
    a real or complex bank, on the card): the spectra, one launch, then the
    sums and the one inverse FFT that complete it, as the JAX package's
    ``_fused_power_bwd`` does in XLA.  A complex bank's dbank is PyTorch's
    convention, as ``mean_power_bwd`` gives it."""
    n = signals.shape[-1]
    spec, k_bins = _spectrum(signals, interpolate)
    dbank_part, t_part = kernels.fused_cwt_bwd(
        spec, _kernel_bank(bank), g.to(torch.float32).contiguous(), k_bins)
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


def _plain_grads(plain, signals, bank, need, grads):
    """(d signals, d bank), each None where ``need`` does not ask for it:
    the vector-Jacobian product of ``plain(signals, bank)`` with its
    outputs' cotangents ``grads``, by autograd over a plain recomputation."""
    inputs = [x.detach().requires_grad_(n) for x, n in
              zip((signals, bank), need)]
    wanted = [x for x, n in zip(inputs, need) if n]
    if not wanted:
        return None, None
    with torch.enable_grad():
        got = iter(torch.autograd.grad(plain(*inputs), wanted, grads))
    return tuple(next(got) if n else None for n in need)


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
        return _plain_grads(
            lambda s, b: itc_from_bank(s, b, ctx.interpolate), signals, bank,
            ctx.needs_input_grad[:2], g) + (None, None)


class _FusedCzt(torch.autograd.Function):
    """The chirp-z kernel's epoch reductions (real CUDA signals and bank
    that ``route()`` gives the "<epilogue>_czt" key): the rFFT rows, one
    launch (the kernel reads the bins above N/2 as the conjugates of those
    below), giving one plane or the (power, itc) pair, as the epilogue's
    ``*_auto`` does.  Its backward differentiates ``plain``, the plain
    N-point route, as ``_FusedItc``'s does."""

    @staticmethod
    def forward(ctx, epilogue, plain, signals, bank, interpolate):
        ctx.plain, ctx.interpolate = plain, interpolate
        ctx.save_for_backward(signals, bank)
        n = signals.shape[-1]
        spec = torch.fft.rfft(signals.to(torch.float32)).contiguous()
        outs = kernels.fused_czt(epilogue, spec, _kernel_bank(bank),
                                 n // 2 if interpolate else n)
        return tuple(outs) if len(outs) > 1 else outs[0]

    @staticmethod
    def backward(ctx, *grads):
        signals, bank = ctx.saved_tensors
        return (None, None) + _plain_grads(
            lambda s, b: ctx.plain(s, b, ctx.interpolate), signals, bank,
            ctx.needs_input_grad[2:4], grads) + (None,)


def czt_from_bank(signal: torch.Tensor, bank: torch.Tensor,
                  interpolate: bool = False) -> torch.Tensor:
    """The chirp-z kernel's coefficients in plain PyTorch (its plain
    version; ``csrc/fused_czt.cu``): a real (..., N) signal x (F, N) bank
    -> (..., F, N), N a length ``kernels.czt_size`` takes.  With a = bank x
    spectrum x w on the first K bins (K = N // 2 on the analytic path,
    else N; the spectrum is the rFFT, bins above N / 2 its mirrored
    conjugates), zero-padded to M, and the tables of ``kernels.czt_tables``:
    two unnormalised inverse DFTs of M points, the second of conj(F+(a) H),
    the first N samples, over N.  That is ``cwt_from_bank``'s c[n] as
    conj(c[n]) w[n], the output chirp left out: the same |c|, and the same
    |sum_e c_e / |c_e||.  complex128 for float64 signals, else complex64."""
    n = signal.shape[-1]
    m = kernels.czt_size(n)
    ctype = (torch.complex128 if signal.dtype == torch.float64
             else torch.complex64)
    w, filt = (torch.from_numpy(t).to(device=signal.device, dtype=ctype)
               for t in kernels.czt_tables(n))
    k_bins = n // 2 if interpolate else n
    spec = torch.fft.rfft(signal)
    if not interpolate:
        spec = torch.cat([spec, spec[..., 1:(n + 1) // 2].flip(-1).conj()],
                         -1)
    a = torch.nn.functional.pad(
        spec[..., None, :k_bins] * (bank[:, :k_bins] * w[:k_bins]),
        (0, m - k_bins))
    y = torch.fft.ifft(a, norm="forward") * filt
    return torch.fft.ifft(y.conj(), norm="forward")[..., :n] / n


def czt_reduction(epilogue: str, signals: torch.Tensor, bank: torch.Tensor,
                  interpolate: bool = False) -> list:
    """Plain version of ``kernels.fused_czt``: the epoch reductions of
    ``czt_from_bank``'s coefficients, [mean power], [itc] or [mean power,
    itc], each (C, F, N)."""
    terms = {"power": (power_term,), "itc": (unit_phase,),
             "power_itc": (power_term, unit_phase)}[epilogue]
    sums = _epoch_sum(signals, bank, interpolate, *terms,
                      transform=czt_from_bank)
    e = signals.shape[0]
    return [total / e if term is power_term else torch.abs(total) / e
            for total, term in zip(sums, terms)]


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
        return power_itc_from_bank(signals, bank, interpolate)
    _no_grad_on_card("fused_power_itc_from_bank",
                     "fused_mean_power_from_bank and fused_itc_from_bank, "
                     "which are differentiable", signals, bank)
    power, itc = _launch("power_itc", signals, bank, interpolate, precision)
    return power, itc


def _phase_sums(signals, bank, interpolate, precision, epilogue):
    """The epoch SUMS behind ``epilogue`` ("itc": Re and Im of
    sum_e cwt/|cwt|; "power_itc": sum_e |cwt|^2 first), plain on the CPU,
    one ``kernels.fused_cwt_sums`` launch on the card."""
    _check_precision(precision)
    if signals.device.type == "cpu":
        per_epoch = ((unit_phase,) if epilogue == "itc"
                     else (power_term, unit_phase))
        *power, phase = _epoch_sum(signals, bank, interpolate, *per_epoch)
        return (*power, phase.real, phase.imag)
    _no_grad_on_card(f"the fused epoch sums ({epilogue!r})",
                     "ops.cwt.itc_from_bank", signals, bank)
    spec, k_bins = _kernel_spectrum(epilogue, signals, bank, interpolate)
    return tuple(kernels.fused_cwt_sums(epilogue, spec, _kernel_bank(bank),
                                        k_bins))


def _itc_sums(signals: torch.Tensor, bank: torch.Tensor,
              interpolate: bool = True, precision: str = DEFAULT_PRECISION):
    """Epoch-SUMMED unit-phase planes ``(sum_r, sum_i)`` of (E, C, N)
    signals, (C, F, N) float32 each (port of ``_itc_sums``): the "itc"
    epilogue's sums before the magnitude, for the sharded ITC, which adds
    them across devices first.  ``|sum| / E`` is ``fused_itc_from_bank``.
    On the CPU the plain sums (the same running sum as ``itc_from_bank``);
    on the card one launch, or a raise.  Not differentiable."""
    return _phase_sums(signals, bank, interpolate, precision, "itc")


def _power_itc_sums(signals: torch.Tensor, bank: torch.Tensor,
                    interpolate: bool = True,
                    precision: str = DEFAULT_PRECISION):
    """Epoch-SUMMED ``(sum |cwt|^2, sum_r, sum_i)`` planes off one pass (port
    of ``_power_itc_sums``): the "power_itc" epilogue's sums, for the
    sharded power and ITC.  Divided by E, the first is
    ``mean_power_from_bank``; as ``_itc_sums`` otherwise."""
    return _phase_sums(signals, bank, interpolate, precision, "power_itc")


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
    flat = signals.reshape(-1, 1, n)
    out = torch.empty((flat.shape[0], 1, bank.shape[0], n),
                      dtype=torch.float32, device=signals.device)
    _fused_power_each_into(flat, bank, interpolate, out, (0, n))
    return out.reshape(*lead, bank.shape[0], n)


def _power_each_into(signals: torch.Tensor, bank: torch.Tensor,
                     interpolate: bool, dst: torch.Tensor, keep) -> None:
    """Columns ``keep = (lo, hi)`` of the per-signal power of (W, ..., N)
    signals written into ``dst``, a (W, S, F, hi - lo) view (S the
    signals' middle dims flattened; ``kernels.each_layout``), for
    ``StreamingCWT``: on the card one "power_each" launch that writes only
    those columns, straight into place; on the CPU the plain
    ``power_from_bank``, cropped and copied."""
    if signals.device.type == "cpu":
        lo, hi = keep
        dst.copy_(power_from_bank(signals, bank, interpolate)[..., lo:hi]
                  .reshape(dst.shape))
        return
    _fused_power_each_into(signals, bank, interpolate, dst, keep)


def _fused_power_each_into(signals, bank, interpolate, dst, keep) -> None:
    """``_power_each_into`` through the kernel: the spectra, one launch."""
    spec, k_bins = _kernel_spectrum(
        "power_each", signals.reshape(-1, 1, signals.shape[-1]), bank,
        interpolate)
    kernels.fused_power_each(spec, _kernel_bank(bank), k_bins, dst, keep)


def _reduction_auto(epilogue, fused, plain, signals, bank, interpolate,
                    precision):
    """One epoch reduction's ``*_auto`` inside the span ``route()`` names:
    the chirp-z kernel for its "<epilogue>_czt" key, the fused wrapper
    ``fused`` where the N-point kernel takes the workload, the plain
    N-point route ``plain`` otherwise."""
    r = route(epilogue, signals, bank, czt=True)
    with span(r.span):
        if not r.takes:
            return plain(signals, bank, interpolate)
        if r.key.endswith("_czt"):
            return _FusedCzt.apply(epilogue, plain, signals, bank,
                                   interpolate)
        return fused(signals, bank, interpolate, precision)


def power_auto(signals: torch.Tensor, bank: torch.Tensor, *,
               interpolate: bool = False,
               precision: str = DEFAULT_PRECISION) -> torch.Tensor:
    """Per-signal power with automatic kernel dispatch: the kernel where
    ``route()`` takes the flattened (B, 1, N) batch, the plain
    ``power_from_bank`` otherwise."""
    r = route("power_each", signals.reshape(-1, 1, signals.shape[-1]), bank)
    with span(r.span):
        if r.takes:
            return fused_power_from_bank(signals, bank, interpolate,
                                         precision)
        return power_from_bank(signals, bank, interpolate)


def mean_power_auto(signals: torch.Tensor, bank: torch.Tensor, *,
                    interpolate: bool = False,
                    precision: str = DEFAULT_PRECISION) -> torch.Tensor:
    """Epoch-mean power with automatic kernel dispatch (see the module
    docstring; a complex bank takes the kernel too); the same result either
    way."""
    return _reduction_auto("power", fused_mean_power_from_bank,
                           mean_power_from_bank, signals, bank, interpolate,
                           precision)


def itc_auto(signals: torch.Tensor, bank: torch.Tensor, *,
             interpolate: bool = False,
             precision: str = DEFAULT_PRECISION) -> torch.Tensor:
    """Inter-trial coherence with automatic kernel dispatch (a complex bank
    takes the kernel too)."""
    return _reduction_auto("itc", fused_itc_from_bank, itc_from_bank,
                           signals, bank, interpolate, precision)


def power_itc_auto(signals: torch.Tensor, bank: torch.Tensor, *,
                   interpolate: bool = False,
                   precision: str = DEFAULT_PRECISION):
    """(power, itc) with automatic kernel dispatch: one fused pass where the
    kernel takes the workload (a complex bank included), one plain pass
    otherwise (each epoch's CWT once, feeding both sums)."""
    return _reduction_auto("power_itc", fused_power_itc_from_bank,
                           power_itc_from_bank, signals, bank, interpolate,
                           precision)


# -- synchrosqueezing ---------------------------------------------------------

def why_not_ssq(signals_shape, bank, uniform_grid, interpolate: bool):
    """Why the synchrosqueezing kernels do not take this workload, or None:
    "row_map" (no single "lin" or "log" row map), "interpolate" (not the
    analytic path), or what ``why_not()`` finds."""
    if uniform_grid is None or uniform_grid[0] not in ("lin", "log"):
        return "row_map"
    if not interpolate:
        return "interpolate"
    return why_not(signals_shape, bank)


def supports_ssq(signals_shape, bank, uniform_grid, interpolate: bool) -> bool:
    """True when the synchrosqueezing kernels take this workload: what
    ``supports()`` takes (an (E, C, N) batch, 1 <= C <= 65535, N a power of
    two in [256, 16384], a real (F, N) bank built for that N), the analytic
    path (``interpolate=True``), and a single "lin" or "log" row map (a
    piecewise or irregular grid runs the plain path)."""
    return why_not_ssq(signals_shape, bank, uniform_grid, interpolate) is None


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
    if not route("ssq", signals, bank, grid=uniform_grid,
                 interpolate=interpolate).takes:
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


# -- cross-pair connectivity --------------------------------------------------

def _pair_launch(epilogue: str, sigs_a: torch.Tensor, sigs_b: torch.Tensor,
                 bank: torch.Tensor, interpolate: bool):
    """Both channels' spectra outside the kernel, then one cross-pair
    launch: the epilogue's (C, F, N) epoch-sum planes."""
    if (sigs_b.shape != sigs_a.shape or sigs_b.is_complex()
            or not route(epilogue, sigs_a, bank).takes):
        raise ValueError(
            f"the cross-pair kernel does not take {sigs_a.dtype} / "
            f"{sigs_b.dtype} pairs {tuple(sigs_a.shape)} / "
            f"{tuple(sigs_b.shape)} with bank {tuple(bank.shape)} "
            f"{bank.dtype}; see supports()")
    n = sigs_a.shape[-1]
    fft = torch.fft.rfft if interpolate else torch.fft.fft
    k_bins = n // 2 if interpolate else n
    spec_a = fft(sigs_a.to(torch.float32)).contiguous()
    spec_b = fft(sigs_b.to(torch.float32)).contiguous()
    return kernels.fused_cwt_pair(epilogue, spec_a, spec_b,
                                  bank.to(torch.float32).contiguous(), k_bins)


def _pair_epoch_sums(epilogue, plain, sigs_a, sigs_b, bank, interpolate,
                     precision):
    _check_precision(precision)
    if sigs_a.device.type == "cpu":
        return plain(sigs_a, sigs_b, bank, interpolate)
    _no_grad_on_card(f"the cross-pair kernel ({epilogue!r})",
                     "the plain functions of ops.extensions and "
                     "ops.connectivity", sigs_a, sigs_b, bank)
    return tuple(_pair_launch(epilogue, sigs_a, sigs_b, bank, interpolate))


def fused_coherence_sums(sigs_a: torch.Tensor, sigs_b: torch.Tensor,
                         bank: torch.Tensor, interpolate: bool = True,
                         precision: str = DEFAULT_PRECISION):
    """Epoch-SUMMED coherence accumulators ``(sum cross_r, sum cross_i,
    sum |Wa|^2, sum |Wb|^2)`` of (E, C, N) pair batches: one "coherence"
    launch on the card (it launches or raises), the plain
    ``ops.extensions.coherence_sums`` on the CPU."""
    return _pair_epoch_sums("coherence", coherence_sums, sigs_a, sigs_b,
                            bank, interpolate, precision)


def fused_phase_lag_sums(sigs_a: torch.Tensor, sigs_b: torch.Tensor,
                         bank: torch.Tensor, interpolate: bool = True,
                         precision: str = DEFAULT_PRECISION):
    """Epoch-SUMMED phase-lag accumulators ``(sum Im, sum |Im|,
    sum sign(Im), sum Im^2)``: one "phaselag" launch on the card, the plain
    ``ops.connectivity.phase_lag_sums`` on the CPU.  Both pin Im to 0 where
    its two rounded products agree, so a self-pair reads 0/0 -> NaN in
    wPLI / dwPLI on either path.  PLI counts the sign of Im: a cell whose Im
    sits within round-off of 0 may flip between the two paths (wPLI and
    dwPLI weigh such epochs by |Im|)."""
    return _pair_epoch_sums("phaselag", phase_lag_sums, sigs_a, sigs_b, bank,
                            interpolate, precision)


def fused_plv_sums(sigs_a: torch.Tensor, sigs_b: torch.Tensor,
                   bank: torch.Tensor, interpolate: bool = True,
                   precision: str = DEFAULT_PRECISION):
    """Epoch-SUMMED unit cross-phase planes ``(sum_r, sum_i)``
    (``ops.connectivity.plv_sums`` at eps = 0: a zero cross-spectrum gives
    NaN): one "plv" launch on the card, the plain sums on the CPU."""
    return _pair_epoch_sums("plv", plv_sums, sigs_a, sigs_b, bank,
                            interpolate, precision)


def _plv_from_sums(sigs_a, sigs_b, bank, interpolate, precision):
    sr, si = fused_plv_sums(sigs_a, sigs_b, bank, interpolate, precision)
    return torch.sqrt(sr * sr + si * si) / sigs_a.shape[0]


def fused_plv(sigs_a, sigs_b, bank, *, interpolate: bool = True,
              precision: str = DEFAULT_PRECISION) -> torch.Tensor:
    """Phase-locking value off the "plv" epilogue
    (``ops.connectivity.plv_from_bank`` at eps = 0)."""
    return _plv_from_sums(sigs_a, sigs_b, bank, interpolate, precision)


def fused_ppc(sigs_a, sigs_b, bank, *, interpolate: bool = True,
              precision: str = DEFAULT_PRECISION) -> torch.Tensor:
    """Pairwise phase consistency off the "plv" epilogue's sums
    (``ops.connectivity.ppc_from_bank`` at eps = 0)."""
    sr, si = fused_plv_sums(sigs_a, sigs_b, bank, interpolate, precision)
    e = sigs_a.shape[0]
    return (sr * sr + si * si - e) / (e * (e - 1.0))


def fused_epoch_coherence(sigs_a, sigs_b, bank, interpolate: bool = True,
                          precision: str = DEFAULT_PRECISION,
                          eps: float = 1e-12) -> torch.Tensor:
    """Epoch-wise magnitude-squared wavelet coherence off the "coherence"
    epilogue (``ops.extensions.epoch_coherence_from_bank``)."""
    xr, xi, pa, pb = fused_coherence_sums(sigs_a, sigs_b, bank, interpolate,
                                          precision)
    return coherence_from_sums(xr, xi, pa, pb, sigs_a.shape[0], eps)


def fused_coherence(sigs_a, sigs_b, bank, *, interpolate: bool = True,
                    precision: str = DEFAULT_PRECISION,
                    eps: float = 1e-12) -> torch.Tensor:
    """``fused_epoch_coherence`` with keyword options (real banks; a
    complex bank goes through ``ops.extensions.epoch_coherence``)."""
    return fused_epoch_coherence(sigs_a, sigs_b, bank, interpolate,
                                 precision, eps)


def fused_imcoh(sigs_a, sigs_b, bank, *, interpolate: bool = True,
                precision: str = DEFAULT_PRECISION,
                eps: float = 1e-12) -> torch.Tensor:
    """Imaginary coherency off the "coherence" epilogue's sums
    (``ops.extensions.imcoh_from_bank``)."""
    xr, xi, pa, pb = fused_coherence_sums(sigs_a, sigs_b, bank, interpolate,
                                          precision)
    return imcoh_from_sums(xr, xi, pa, pb, eps)


def fused_phase_lag(sigs_a, sigs_b, bank, *, method: str = "wpli",
                    interpolate: bool = True,
                    precision: str = DEFAULT_PRECISION,
                    eps: float = 0.0) -> torch.Tensor:
    """PLI / wPLI / debiased wPLI^2 off the "phaselag" epilogue
    (``ops.connectivity.phase_lag_from_bank``; see
    ``fused_phase_lag_sums`` on PLI's sign counts)."""
    sums = fused_phase_lag_sums(sigs_a, sigs_b, bank, interpolate, precision)
    return phase_lag_from_sums(sums, sigs_a.shape[0], method, eps)
