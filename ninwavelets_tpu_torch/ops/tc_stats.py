"""Scalogram statistics after Torrence & Compo (1998): cone of influence,
global wavelet spectrum, and AR(1) red-noise significance levels (port of
``ninwavelets_tpu.ops.tc_stats``).

Formulated for this engine's frequency-parameterized banks (T&C work in
scales; here everything is a function of the analysis frequency).  The
chi-square 95% point for 2 DOF is closed-form (``-2 ln(1-p)``), so no scipy
dependency; the cone of influence probes each wavelet's envelope from its
frequency-domain formula on the host, in float64, as ``parallel.chunked``'s
``halo_samples`` does.  The (F,) thresholds and the planes they gate are
torch tensors on the caller's device; the AR(1) fit, the e-folding times and
the COI mask are host numpy.
"""
from __future__ import annotations

import math
from statistics import NormalDist
from typing import Optional

import numpy as np
import torch

from .grids import fft_bin_freqs

__all__ = [
    "ar1_coefficient", "red_noise_spectrum", "background_power",
    "significance_level", "significant_mask", "global_spectrum",
    "efolding_times", "coi_mask", "itc_pvalue", "itc_threshold",
]


def ar1_coefficient(x: np.ndarray) -> float:
    """Lag-1 autoregressive coefficient of a (host) 1-D series: T&C's
    ``alpha = (r1 + sqrt(r2)) / 2`` from the lag-1 and lag-2
    autocorrelations, clipped to [0, 1)."""
    x = np.asarray(x, np.float64)
    x = x - x.mean()
    denom = float(np.dot(x, x))
    if denom == 0.0:
        return 0.0
    r1 = float(np.dot(x[:-1], x[1:])) / denom
    r2 = float(np.dot(x[:-2], x[2:])) / denom
    alpha = (r1 + math.sqrt(max(r2, 0.0))) / 2.0
    return min(max(alpha, 0.0), 0.999999)


def red_noise_spectrum(freqs, sfreq: float, alpha: float,
                       device=None) -> torch.Tensor:
    """Normalized AR(1) power spectrum at the analysis frequencies (T&C eq.
    16): ``P(f) = (1 - a^2) / (1 + a^2 - 2 a cos(2 pi f / sfreq))``, float32;
    ``alpha = 0`` gives flat white noise."""
    f = torch.as_tensor(freqs, dtype=torch.float32, device=device)
    a = torch.tensor(alpha, dtype=torch.float32, device=f.device)
    return (1.0 - a * a) / (1.0 + a * a
                            - 2.0 * a * torch.cos(2.0 * math.pi * f / sfreq))


def _chi2_ppf(p: float, dof: int) -> float:
    """Inverse chi-square CDF: exact for 2 DOF (``-2 ln(1-p)``); the
    Wilson-Hilferty cube approximation otherwise (relative error ~1e-3 for
    dof >= 4 at the quantiles used here)."""
    if dof == 2:
        return -2.0 * math.log(1.0 - p)
    z = NormalDist().inv_cdf(p)
    a = 2.0 / (9.0 * dof)
    return dof * (1.0 - a + z * math.sqrt(a)) ** 3


def background_power(bank: torch.Tensor, sfreq: float, alpha: float,
                     variance: float) -> torch.Tensor:
    """Expected scalogram power (F,) of AR(1) noise through this bank:
    ``E|W_f[n]|^2 = (variance / N) * sum_k |B_f[k]|^2 * P_alpha(nu_k)``
    (the bank rows are peak-normalized, not unit-energy)."""
    n = bank.shape[-1]
    p_bins = red_noise_spectrum(fft_bin_freqs(n, sfreq, device=bank.device),
                                sfreq, alpha)
    return (float(variance) / n) * torch.sum(
        torch.square(torch.abs(bank)) * p_bins, dim=-1)


def significance_level(bank: torch.Tensor, sfreq: float, alpha: float,
                       variance: float, p: float = 0.95,
                       n_epochs: int = 1) -> torch.Tensor:
    """Pointwise significance threshold (F,) against an AR(1) background:
    the epoch-mean power over E trials is chi-square with 2E DOF scaled by
    1/(2E), so ``threshold = E|W|^2 * chi2_ppf(p, 2E) / (2E)``."""
    dof = 2 * int(n_epochs)
    return background_power(bank, sfreq, alpha, variance) \
        * (_chi2_ppf(p, dof) / dof)


def significant_mask(power: torch.Tensor, bank: torch.Tensor, sfreq: float,
                     alpha: float, variance: float, p: float = 0.95,
                     n_epochs: int = 1) -> torch.Tensor:
    """Boolean (..., F, N) mask of the power plane's points significant at
    ``p`` (``power`` computed with the same bank; ``n_epochs`` for an epoch
    mean)."""
    thr = significance_level(bank, sfreq, alpha, variance, p, n_epochs)
    return power > thr[..., :, None]


def global_spectrum(power: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Time-averaged wavelet spectrum (T&C eq. 22): the mean power of each
    row, over the unmasked samples only when ``mask`` is given (rows fully
    outside it return 0)."""
    if mask is None:
        return power.mean(dim=-1)
    m = torch.as_tensor(mask, device=power.device).to(power.dtype)
    count = torch.clamp(m.sum(dim=-1), min=1.0)
    return (power * m).sum(dim=-1) / count


def efolding_times(wdef, freqs, sfreq: float) -> np.ndarray:
    """Envelope e-folding time (seconds) of each analysis wavelet, the COI
    half-width: the frequency-domain formula on a float32 probe grid, the
    inverse FFT in float64 numpy, the first crossing of ``peak / e`` of the
    one-sided envelope."""
    freqs = np.asarray(freqs, np.float64)
    out = np.empty(freqs.shape, np.float64)
    for i, f in enumerate(freqs):
        probe_seconds = max(16.0 / f, 2.0)
        n = int(2 ** np.ceil(np.log2(sfreq * probe_seconds)))
        grid = fft_bin_freqs(n, sfreq, dtype=torch.float32, device="cpu")
        spec = wdef.trans_formula(grid, torch.tensor(f, dtype=torch.float32))
        env = np.abs(np.fft.ifft(spec.numpy().astype(np.complex128)))
        # Centered at sample 0 with wrap-around tails: fold the two sides.
        half = n // 2
        one_sided = np.maximum(env[:half], env[::-1][:half])
        below = np.nonzero(one_sided <= one_sided.max() / math.e)[0]
        out[i] = (below[0] if below.size else half) / sfreq
    return out


def coi_mask(n: int, sfreq: float, efold_s: np.ndarray) -> np.ndarray:
    """(F, N) boolean host mask: True inside the cone of influence, at least
    ``efold_s[f]`` seconds from both record edges."""
    t = np.arange(n) / sfreq
    dist = np.minimum(t, t[::-1])
    return dist[None, :] >= np.asarray(efold_s, np.float64)[:, None]


def itc_pvalue(itc: torch.Tensor, n_epochs: int) -> torch.Tensor:
    """Rayleigh-test p-value plane for inter-trial coherence under uniform
    phases: ``p = exp(-E * ITC^2)``."""
    itc = itc.to(torch.float32)
    return torch.exp(-float(n_epochs) * itc * itc)


def itc_threshold(alpha: float, n_epochs: int) -> float:
    """ITC value above which the Rayleigh p falls below ``alpha``:
    ``sqrt(-ln(alpha) / E)``."""
    return float(np.sqrt(-np.log(alpha) / float(n_epochs)))
