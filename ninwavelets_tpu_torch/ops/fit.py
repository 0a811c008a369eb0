"""Gradient-based fitting of wavelet analyses (port of
``ninwavelets_tpu.ops.fit``).

* ``fit_frequencies`` moves a frequency grid to maximise the power it
  captures from data, through the bank synthesis and the plain power.
* ``learn_bank`` learns a free-form (F, N) frequency-domain filterbank
  against a loss on the epoch-mean power TFR.  With ``use_fused=True`` every
  step runs the fused forward kernel and the fused backward kernel on the
  card (``ops.fused.fused_mean_power_from_bank``).

Both run ``torch.optim.Adam`` in a Python loop of steps.  ``torch.optim.Adam``
and the reference's ``optax.adam`` share their defaults (b1 0.9, b2 0.999,
eps 1e-8, added outside the square root of the second moment) and their
bias-corrected update, so the same gradients give the same steps.

Placement: the device of the first tensor argument; with none (numpy or
lists only), the card (``device.resolve_device``).  Pass CPU tensors to
train on the CPU.
"""
from __future__ import annotations

import torch

from ..device import as_float32, resolve_device
from .bank import WaveletDef, make_fft_bank
from .cwt import mean_power_from_bank
from .fused import DEFAULT_PRECISION, mean_power_auto

__all__ = ["fit_frequencies", "learn_bank"]


def _placement(*args) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return resolve_device()



def fit_frequencies(signals, wdef: WaveletDef, freqs0, sfreq: float,
                    interpolate: bool = True, steps: int = 100,
                    lr: float = 0.02):
    """Gradient-ascend a frequency grid onto the data's spectral mass.

    Maximises the mean epoch-mean power captured by a bank synthesised at
    the (strictly positive) frequencies, optimised in LOG space so rows move
    multiplicatively and can never cross zero.  Returns
    ``(fitted_freqs (F,), losses (steps,))``.

    Args:
      signals: (E, C, N) or (B, N) float32 epochs / signals.
      wdef: the wavelet definition (``WaveletBase._wdef()``).
      freqs0: (F,) initial frequencies (Hz), e.g. a coarse uniform grid.
    """
    device = _placement(signals, freqs0)
    signals = as_float32(signals, device)
    n = int(signals.shape[-1])
    log_f = torch.log(as_float32(freqs0, device)).detach().requires_grad_(True)
    opt = torch.optim.Adam([log_f], lr=lr)
    losses = []
    for _ in range(int(steps)):
        bank = make_fft_bank(wdef, torch.exp(log_f), n, float(sfreq),
                             interpolate)
        loss = -mean_power_from_bank(signals, bank, interpolate).mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    return torch.exp(log_f).detach(), torch.stack(losses)


def learn_bank(signals, bank0, target=None, loss: str = "mse",
               interpolate: bool = True, steps: int = 200,
               lr: float = 1e-3, use_fused: bool = False,
               precision: str = DEFAULT_PRECISION, bank0_i=None):
    """Learn a free-form (F, N) frequency-domain filterbank by gradient
    descent on a loss over the epoch-mean power TFR.

    ``loss="mse"`` matches a ``target`` (C, F, N) power plane;
    ``loss="power"`` maximises captured power.  ``use_fused=True`` runs
    every step's forward and backward through the fused kernels where they
    take the workload (``ops.fused.mean_power_auto``: real signals and a
    real or complex bank; a complex bank runs the complex-bank forward and
    backward kernels, "power_cx" and "power_bwd_cx").  A wavelet bank
    (``make_fft_bank``) is the natural ``bank0``.

    A complex (Normal/Twice-mode) start comes as the float pair
    (``bank0``, ``bank0_i``): two real leaf tensors, joined by
    ``torch.complex`` inside the loss, and the learned bank returns as the
    same pair.

    Returns ``(bank (F, N), losses (steps,))`` for a real bank,
    ``((bank_r, bank_i), losses)`` when ``bank0_i`` is given.
    """
    if loss == "mse":
        if target is None:
            raise ValueError('loss="mse" needs a target power plane')
    elif loss != "power":
        raise ValueError('loss must be "mse" or "power"')
    device = _placement(signals, bank0)
    signals = as_float32(signals, device)
    if target is not None:
        target = as_float32(target, device)
    params = [as_float32(b, device).detach().clone().requires_grad_(True)
              for b in (bank0, bank0_i) if b is not None]
    opt = torch.optim.Adam(params, lr=lr)

    def power_of(bank):
        if use_fused:
            return mean_power_auto(signals, bank, interpolate=interpolate,
                                   precision=precision)
        return mean_power_from_bank(signals, bank, interpolate)

    losses = []
    for _ in range(int(steps)):
        bank = params[0] if len(params) == 1 else torch.complex(*params)
        p = power_of(bank)
        val = (torch.mean(torch.square(p - target)) if loss == "mse"
               else -torch.mean(p))
        opt.zero_grad()
        val.backward()
        opt.step()
        losses.append(val.detach())
    out = [p.detach() for p in params]
    return (out[0] if len(out) == 1 else tuple(out)), torch.stack(losses)
