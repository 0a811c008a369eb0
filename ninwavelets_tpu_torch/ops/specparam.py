"""Spectral parametrization ("FOOOF" / specparam; Donoghue et al., Nat.
Neurosci. 2020), port of ``ninwavelets_tpu.ops.specparam``: separate a
power spectrum into an aperiodic 1/f component and a few Gaussian peaks,

    log10 P(f) = offset - log10(knee + f^exponent)
                 + sum_k a_k exp(-(f - c_k)^2 / (2 w_k^2)).

The peak seeding is the JAX package's host numpy code, copied (float64,
one spectrum at a time).  The refinement is a fixed-count Adam loop over
all parameters jointly, batched over every spectrum: the six parameter
groups sit in one (B, 3 + 3K) tensor, and each step takes the closed-form
gradient of the model (``_grad``; ``tests/test_torch_specparam.py`` holds
it against ``torch.autograd``).  The loss is the mean squared residual
over the whole batch, as in the JAX package.  Parameters live in
transformed space (log-knee, log-widths, softplus amplitudes), so the
optimizer cannot leave the valid region.  Each step is a few dozen small
launches on the card.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["specparam", "SpectralFit", "aperiodic_model", "peaks_model"]


def aperiodic_model(freqs, offset, knee, exponent):
    """``offset - log10(knee + f^exponent)`` (knee=0 gives the fixed
    1/f^exponent line in log-log)."""
    return offset - torch.log10(knee + freqs ** exponent)


def peaks_model(freqs, amps, centers, widths):
    """Sum of Gaussians in log-power space: (..., K) params -> (..., F)."""
    z = (freqs[..., None, :] - centers[..., :, None]) \
        / widths[..., :, None]
    return (amps[..., :, None] * torch.exp(-0.5 * z * z)).sum(-2)


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def _split(p, k):
    """The six parameter groups of the (B, 3 + 3K) leaf: offset, log-knee,
    exponent (B,) and raw amplitudes, centers, log-widths (B, K)."""
    return (p[:, 0], p[:, 1], p[:, 2], p[:, 3:3 + k], p[:, 3 + k:3 + 2 * k],
            p[:, 3 + 2 * k:])


def _model(freqs, params):
    off, log_knee, expo, raw_a, c, log_w = params
    return (aperiodic_model(freqs, off[..., None], torch.exp(log_knee)[
        ..., None], expo[..., None])
            + peaks_model(freqs, _softplus(raw_a), c, torch.exp(log_w)))


def _grad(p, freqs, log_p, k, fit_knee):
    """The gradient of the mean squared residual over the batch with
    respect to the (B, 3 + 3K) parameters, in closed form: the model is
    ``offset - log10(knee + f^e) + sum_k softplus(a_k) g_k(f)`` with
    ``g_k = exp(-z^2 / 2)``, ``z = (f - c_k) / w_k``."""
    off, log_knee, expo, raw_a, c, log_w = _split(p, k)
    knee = torch.exp(log_knee if fit_knee else torch.full_like(log_knee,
                                                               -20.0))
    fe = freqs ** expo[:, None]                         # (B, F)
    den = knee[:, None] + fe
    w = torch.exp(log_w)
    z = (freqs - c[..., None]) / w[..., None]           # (B, K, F)
    g = torch.exp(-0.5 * z * z)
    amps = _softplus(raw_a)
    model = off[:, None] - torch.log10(den) + (amps[..., None] * g).sum(-2)
    s = (model - log_p) * (2.0 / log_p.numel())         # dL / dmodel
    sl = s / (den * math.log(10.0))
    sg = s[:, None, :] * g                              # (B, K, F)
    gz = (sg * z).sum(-1)
    return torch.cat([
        s.sum(-1, keepdim=True),
        -(sl * knee[:, None]).sum(-1, keepdim=True) if fit_knee
        else torch.zeros_like(off)[:, None],
        -(sl * fe * torch.log(freqs)).sum(-1, keepdim=True),
        torch.sigmoid(raw_a) * sg.sum(-1),
        amps * gz / w,
        amps * (sg * z * z).sum(-1)], -1)


def _refine(log_p, freqs, params0, *, n_steps, lr, fit_knee):
    """Adam on the mean squared residual from ``params0`` ((B, 3 + 3K)):
    returns (params, model, r2)."""
    k = (params0.shape[-1] - 3) // 3
    p = params0.clone()
    m = torch.zeros_like(p)
    v = torch.zeros_like(p)
    for step in range(1, int(n_steps) + 1):
        g = _grad(p, freqs, log_p, k, fit_knee)
        t = np.float32(step)
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        mh = m / float(np.float32(1.0) - np.float32(0.9) ** t)
        vh = v / float(np.float32(1.0) - np.float32(0.999) ** t)
        p = p - lr * mh / (torch.sqrt(vh) + 1e-8)
    params = _split(p, k)
    if not fit_knee:
        params = (params[0], torch.full_like(params[1], -20.0),
                  *params[2:])
    final = _model(freqs, params)
    ss_res = ((final - log_p) ** 2).sum(-1)
    ss_tot = ((log_p - log_p.mean(-1, keepdim=True)) ** 2).sum(-1)
    r2 = 1.0 - ss_res / ss_tot.clamp(min=1e-20)
    return params, final, r2


class SpectralFit(NamedTuple):
    """specparam result: aperiodic ``offset``/``knee``/``exponent``
    (each (...,)), peak ``centers``/``amplitudes``/``widths`` (each
    (..., K), amplitude ~0 for unused slots), the fitted ``model`` in
    log10 power, and ``r_squared``; host numpy, as in the JAX package."""
    offset: np.ndarray
    knee: np.ndarray
    exponent: np.ndarray
    centers: np.ndarray
    amplitudes: np.ndarray
    widths: np.ndarray
    model: np.ndarray
    r_squared: np.ndarray

    def peaks(self, min_amplitude: float = 0.05) -> list:
        """Host-side pruned peak list (dicts sorted by amplitude) for a
        single-spectrum fit."""
        out = [{"center": float(c), "amplitude": float(a),
                "width": float(w)}
               for c, a, w in zip(np.atleast_1d(self.centers),
                                  np.atleast_1d(self.amplitudes),
                                  np.atleast_1d(self.widths))
               if a >= min_amplitude]
        return sorted(out, key=lambda d: -d["amplitude"])


def _seed(flat, freqs_h, max_peaks, peak_width):
    """The FOOOF seeding on the host (float64, the JAX package's code):
    a robust aperiodic line through the low-percentile envelope, then the
    largest residual taken as a peak, ``max_peaks`` times."""
    lf = np.log10(freqs_h)
    offs, expos = [], []
    seeds = np.zeros((flat.shape[0], max_peaks, 3))
    for i, row in enumerate(flat):
        # robust line: least squares, then refit on the points at or
        # below the first fit (peaks only push the spectrum UP)
        a = np.stack([np.ones_like(lf), -lf], -1)
        coef, *_ = np.linalg.lstsq(a, row, rcond=None)
        resid = row - (coef[0] - coef[1] * lf)
        keep = resid <= np.percentile(resid, 40)
        coef, *_ = np.linalg.lstsq(a[keep], row[keep], rcond=None)
        offs.append(coef[0])
        expos.append(max(coef[1], 0.0))
        resid = row - (coef[0] - coef[1] * lf)
        for k in range(max_peaks):
            j = int(np.argmax(resid))
            amp = float(resid[j])
            if amp < 0.05:
                seeds[i, k] = (freqs_h[j], 0.0, peak_width)
                continue
            seeds[i, k] = (freqs_h[j], amp, peak_width)
            resid = resid - amp * np.exp(
                -0.5 * ((freqs_h - freqs_h[j]) / peak_width) ** 2)
    return np.asarray(offs), np.asarray(expos), seeds


def specparam(power, freqs, max_peaks: int = 4, fit_knee: bool = False,
              n_steps: int = 2000, lr: float = 0.02,
              peak_width: float = 2.0, device=None) -> SpectralFit:
    """Fit the specparam model to (..., F) power spectra at (F,)
    frequencies (Hz, > 0).

    Seeding is the FOOOF recipe on the host; a fixed-count Adam loop then
    refines every parameter jointly, on the tensor's device (``device``,
    the card when None, for a numpy input).  ``fit_knee`` enables the knee
    parameter (broadband spectra spanning the bend)."""
    if device is None:
        device = (power.device if isinstance(power, torch.Tensor)
                  else resolve_device())
    if isinstance(power, torch.Tensor):
        power = power.detach().cpu().numpy()
    power = np.asarray(power, np.float64)
    freqs_h = np.asarray(freqs, np.float64).ravel()
    if np.any(freqs_h <= 0):
        raise ValueError("frequencies must be positive")
    if power.shape[-1] != freqs_h.size:
        raise ValueError("power.shape[-1] must match len(freqs)")
    log_p = np.log10(np.maximum(power, 1e-30))
    batch = log_p.shape[:-1]
    flat = log_p.reshape(-1, freqs_h.size)
    offs, expos, seeds = _seed(flat, freqs_h, max_peaks, peak_width)

    a0 = seeds[:, :, 1]
    # softplus inverse for the amplitude seeds (0 -> large negative)
    raw_a0 = np.where(a0 > 1e-3, np.log(np.expm1(np.maximum(a0, 1e-3))),
                      -6.0)
    params0 = np.concatenate([
        offs[:, None], np.full((flat.shape[0], 1), 0.0 if fit_knee
                               else -20.0), expos[:, None], raw_a0,
        seeds[:, :, 0], np.log(seeds[:, :, 2])], -1).astype(np.float32)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            device)

    params, model, r2 = _refine(
        dev(flat), dev(freqs_h), dev(params0), n_steps=int(n_steps),
        lr=float(lr), fit_knee=bool(fit_knee))
    off, log_knee, expo, raw_a, c, log_w = params

    def host(t, tail=()):
        return t.detach().cpu().numpy().reshape(batch + tail)

    kk = (int(max_peaks),)
    return SpectralFit(
        host(off), host(torch.exp(log_knee)), host(expo), host(c, kk),
        host(_softplus(raw_a), kk), host(torch.exp(log_w), kk),
        host(model, (freqs_h.size,)), host(r2))
