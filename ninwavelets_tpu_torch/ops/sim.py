"""Neural-signal simulation, port of ``ninwavelets_tpu.ops.sim``: 1/f noise,
AR(1) noise, (asymmetric, bursty) oscillations, mixing at a target SNR and
IAAFT surrogates, the generators for validating the analyses on signals
with known ground truth (neurodsp's ``sim``).

Every random generator takes ``seed``, an int or a ``torch.Generator``,
and draws its white or uniform noise from it (other draws than the JAX
package's ``jax.random`` keys); each has a ``_*_from_noise`` entry that
takes the draws, which the CPU tests feed the JAX package's.

* spectral shaping is one rfft / irfft pair on the next power of two,
  cropped and renormalized;
* AR(1) runs ``extensions.ar1_filter`` (blocked products, depth log N)
  rather than a loop over samples;
* the burst gate is a two-state Markov chain over cycles, run as a
  doubling scan of the per-cycle state maps (exact: each map is a pair
  of 0/1 values);
* IAAFT alternates the amplitude step (rfft, unit phases times the
  original amplitudes, irfft) and the rank step (the sorted original
  values placed by rank); every sort is stable, as ``jnp.argsort`` is.

Outputs are float32 and unit variance except where noted.  A numpy input
goes to ``device`` (the card when None); a tensor stays on its device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..device import as_float32, resolve_device
from .extensions import ar1_filter

__all__ = [
    "powerlaw_noise", "ar1_noise", "oscillation", "asym_oscillation",
    "bursty_oscillation", "combine", "iaaft_surrogates",
]


def _generator(seed, device) -> torch.Generator:
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator(device=device).manual_seed(int(seed))


def _gen_device(seed, device) -> torch.device:
    if isinstance(seed, torch.Generator) and device is None:
        return seed.device
    return resolve_device(device)


def _shape(shape) -> tuple:
    return tuple(int(s) for s in np.atleast_1d(shape)) \
        if not isinstance(shape, tuple) else shape


def _powerlaw_from_noise(white, exponent: float, n_out: int):
    """``powerlaw_noise`` from given (..., Npad) white noise, Npad the
    shaping grid."""
    n = white.shape[-1]
    spec = torch.fft.rfft(white)
    f = torch.arange(n // 2 + 1, dtype=torch.float32, device=white.device)
    # amplitude ~ f^(exponent/2); DC stays 0, so the output is mean-free
    gain = torch.where(f > 0, torch.pow(torch.clamp(f, min=1.0),
                                        float(exponent) / 2.0),
                       torch.zeros_like(f))
    x = torch.fft.irfft(spec * gain, n=n)[..., :n_out]
    x = x - torch.mean(x, dim=-1, keepdim=True)
    sd = torch.std(x, dim=-1, keepdim=True, correction=0)
    return x / torch.clamp(sd, min=1e-20)


def powerlaw_noise(seed, shape, exponent: float = -2.0,
                   device=None) -> torch.Tensor:
    """Unit-variance noise with power spectrum ``P(f) ~ f**exponent``
    (-2 brown, -1 pink, 0 white); ``shape`` is (..., N).  The shaping runs
    on the next power of two and is cropped, then renormalized to mean 0
    and variance 1."""
    shape = _shape(shape)
    n = int(shape[-1])
    npad = 1 << max(int(np.ceil(np.log2(max(n, 2)))), 1)
    device = _gen_device(seed, device)
    white = torch.randn(shape[:-1] + (npad,), generator=_generator(
        seed, device), device=device)
    return _powerlaw_from_noise(white, float(exponent), n)


def _ar1_from_noise(e, r: float):
    """``ar1_noise`` from given (..., N) white noise."""
    return ar1_filter(float(r), e) * np.sqrt(1.0 - r * r)


def ar1_noise(seed, shape, r: float = 0.7, device=None) -> torch.Tensor:
    """Unit-variance AR(1) (red) noise with lag-1 autocorrelation ``r``
    (the Torrence-Compo null model, ``ops.tc_stats``)."""
    if not -1.0 < r < 1.0:
        raise ValueError("need |r| < 1")
    shape = _shape(shape)
    device = _gen_device(seed, device)
    e = torch.randn(shape, generator=_generator(seed, device), device=device)
    return _ar1_from_noise(e, float(r))


def oscillation(n: int, sfreq: float, freq: float, phase: float = 0.0,
                device=None) -> torch.Tensor:
    """Unit-variance sinusoid ``sqrt(2) * sin(2 pi f t + phase)``."""
    t = torch.arange(n, dtype=torch.float32,
                     device=resolve_device(device)) / sfreq
    return float(np.float32(np.sqrt(2.0))) * torch.sin(
        2.0 * math.pi * freq * t + phase)


def asym_oscillation(n: int, sfreq: float, freq: float, rdsym: float = 0.5,
                     device=None) -> torch.Tensor:
    """Nonsinusoidal oscillation with rise-decay asymmetry ``rdsym`` (the
    fraction of each period spent rising trough -> peak; 0.5 is a
    sinusoid): a sawtooth-warped phase through a sine, unit variance."""
    if not 0.0 < rdsym < 1.0:
        raise ValueError("rdsym must be in (0, 1)")
    t = torch.arange(n, dtype=torch.float32,
                     device=resolve_device(device)) / sfreq
    p = torch.remainder(t * freq, 1.0)     # cycle position, trough at 0
    warped = torch.where(p < rdsym, 0.5 * p / rdsym,
                         0.5 + 0.5 * (p - rdsym) / (1.0 - rdsym))
    x = torch.sin(2.0 * math.pi * warped - 0.5 * math.pi)
    return x / torch.clamp(torch.std(x, correction=0), min=1e-20)


def _n_cycles(n, sfreq, freq) -> int:
    return int(np.ceil(n * freq / sfreq)) + 1


def _markov_gate(u, enter_prob: float, leave_prob: float):
    """States of the cycle chain from state 0: silent -> burst when
    ``u < enter_prob``, burst -> burst when ``u > leave_prob``.  Each
    cycle is the map (f(0), f(1)); an inclusive doubling scan composes
    them, and the state after cycle k is the prefix map at 0."""
    f0 = (u < enter_prob).to(torch.int64)
    f1 = (u > leave_prob).to(torch.int64)
    d = 1
    while d < u.shape[0]:
        g0 = torch.where(f0[:-d] == 0, f0[d:], f1[d:])
        g1 = torch.where(f1[:-d] == 0, f0[d:], f1[d:])
        f0 = torch.cat([f0[:d], g0])
        f1 = torch.cat([f1[:d], g1])
        d *= 2
    return f0.to(torch.float32)


def _bursty_from_noise(u, n: int, sfreq: float, freq: float,
                       enter_prob: float, leave_prob: float):
    """``bursty_oscillation`` from given (n_cycles,) uniform draws."""
    gate = _markov_gate(u, float(enter_prob), float(leave_prob))
    t = torch.arange(n, dtype=torch.float32, device=u.device) / sfreq
    cyc = torch.clamp((t * freq).to(torch.int32), max=u.shape[0] - 1)
    g = gate[cyc.long()]
    return torch.sin(2.0 * math.pi * freq * t) * g, g


def bursty_oscillation(seed, n: int, sfreq: float, freq: float,
                       enter_prob: float = 0.2, leave_prob: float = 0.2,
                       device=None):
    """Oscillation gated by a CYCLE-level two-state Markov chain
    (``enter_prob`` of starting a burst each silent cycle, ``leave_prob``
    of ending it each bursting cycle).  Returns ``(signal, is_burst)``,
    the per-sample burst mask; not variance-normalized."""
    if not (0.0 <= enter_prob <= 1.0 and 0.0 <= leave_prob <= 1.0):
        raise ValueError("probabilities must be in [0, 1]")
    device = _gen_device(seed, device)
    u = torch.rand((_n_cycles(n, sfreq, freq),),
                   generator=_generator(seed, device), device=device)
    return _bursty_from_noise(u, int(n), float(sfreq), float(freq),
                              enter_prob, leave_prob)


def combine(signal, noise, snr_db: float = 0.0,
            device=None) -> torch.Tensor:
    """Mix a (unit-variance) signal and noise at ``snr_db`` decibels of
    variance ratio, renormalized to unit variance."""
    a = float(np.float32(10.0 ** (snr_db / 20.0)))
    s = as_float32(signal, device)
    x = a * s + as_float32(noise, s.device)
    return x / torch.clamp(torch.std(x, dim=-1, keepdim=True,
                                     correction=0), min=1e-20)


def _ranks(y):
    """The rank of each element along the last axis (stable order)."""
    order = torch.argsort(y, dim=-1, stable=True)
    ranks = torch.empty_like(order)
    return ranks.scatter_(-1, order, torch.arange(
        y.shape[-1], device=y.device).expand_as(order))


def _iaaft_from_noise(x, noise, n_iter: int):
    """``iaaft_surrogates`` from given (S, ..., N) normal draws, whose
    stable order is each surrogate's initial shuffle."""
    target = torch.sort(x, dim=-1, stable=True).values
    amp = torch.abs(torch.fft.rfft(x))
    n = x.shape[-1]
    ts = target.expand_as(noise)
    s = torch.gather(ts, -1, torch.argsort(noise, dim=-1, stable=True))
    for _ in range(int(n_iter)):
        spec = torch.fft.rfft(s)
        mag = torch.clamp(torch.abs(spec), min=1e-30)
        y = torch.fft.irfft(spec / mag * amp, n=n)   # amplitude step
        s = torch.gather(ts, -1, _ranks(y))          # rank step
    return s


def iaaft_surrogates(seed, x, n_surrogates: int = 19, n_iter: int = 100,
                     device=None) -> torch.Tensor:
    """IAAFT surrogates (Schreiber & Schmitz 1996): (..., N) -> (S, ...,
    N) series with exactly the original amplitude distribution (every
    iteration ends on a rank remap onto the sorted original values) and
    approximately its power spectrum: the null for nonlinearity tests.
    N must be a power of two, as in the JAX package.  For strictly
    periodic signals the iteration can re-lock the phases to a shift of
    the original; the null is meant for aperiodic processes."""
    x = as_float32(x, device)
    n = x.shape[-1]
    if n & (n - 1):
        raise ValueError(f"N = {n} must be a power of two (the JAX "
                         "package's FFT rule); pad or crop first")
    if n_surrogates < 1 or n_iter < 1:
        raise ValueError("n_surrogates and n_iter must be >= 1")
    noise = torch.randn((int(n_surrogates),) + tuple(x.shape),
                        generator=_generator(seed, x.device),
                        device=x.device)
    return _iaaft_from_noise(x, noise, int(n_iter))
