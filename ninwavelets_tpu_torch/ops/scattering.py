"""Time-scattering transform (Mallat): translation-invariant spectral
features from cascaded CWT + modulus + lowpass averaging (port of
``ninwavelets_tpu.ops.scattering``).

    U1[f1]      = |CWT(x,  bank1)[f1]|
    S1[f1]      = (phi * U1[f1]) downsampled            (order 1)
    U2[f2, f1]  = |CWT(U1[f1], bank2)[f2]|
    S2[f2, f1]  = (phi * U2[f2, f1]) downsampled        (order 2)

with ``phi`` a Gaussian lowpass at ~sfreq/(2*stride).  Both modulus layers
can run through ``ops.fused.fused_power_from_bank`` (the "power_each"
kernel on the card): the second layer's batch is F1 times the signals, at
``interpolate=False`` (U1 is not zero-mean; its spectrum is two-sided).
"""
from __future__ import annotations

import contextlib
import functools
import math

import numpy as np
import torch

from .cwt import abs_from_bank
from .fused import fused_power_from_bank, route

__all__ = ["scattering", "scattering_from_banks", "lowpass_spectrum"]


def lowpass_spectrum(n: int, sfreq: float, cutoff: float,
                     dtype=torch.float32, device=None) -> torch.Tensor:
    """(N,) Gaussian lowpass transfer function with |H(cutoff)| = 1/2,
    symmetric over positive/negative FFT bins."""
    k = torch.arange(n, device=device)
    nu = torch.where(k < (n + 1) // 2, k, k - n).to(dtype) * (sfreq / n)
    c = cutoff / math.sqrt(2.0 * math.log(2.0))
    return torch.exp(-0.5 * torch.square(nu / c)).to(dtype)


def _smooth_decimate(u: torch.Tensor, phi: torch.Tensor,
                     stride: int) -> torch.Tensor:
    """Lowpass (FFT-domain multiply by ``phi``) then stride-decimate the
    trailing axis.  ``u`` is real nonnegative (a modulus plane)."""
    spec = torch.fft.rfft(u)
    smoothed = torch.fft.irfft(spec * phi[:spec.shape[-1]], n=u.shape[-1])
    return smoothed[..., ::stride]


@functools.lru_cache(maxsize=8)
def _smooth_decimate_operator(n: int, stride: int, sfreq: float,
                              cutoff: float) -> np.ndarray:
    """(N, N//stride) matrix G of the whole smooth+decimate stage:
    lowpass-then-decimate is an LTI projection, so ``s = u @ G`` with
    ``G[j, m] = g[(m*stride - j) mod N]`` and ``g = ifft(phi)`` (real,
    symmetric); built on the host in float64, kept as float32 numpy."""
    k = np.arange(n)
    nu = np.where(k < (n + 1) // 2, k, k - n) * (sfreq / n)
    c = cutoff / np.sqrt(2.0 * np.log(2.0))
    phi = np.exp(-0.5 * np.square(nu / c))
    g = np.fft.ifft(phi).real
    idx = (np.arange(n // stride)[None, :] * stride
           - np.arange(n)[:, None]) % n
    return np.ascontiguousarray(g[idx], np.float32)


@contextlib.contextmanager
def fp32_matmul(precision: str):
    """True float32 matmuls (no TF32) inside, the JAX package's
    ``Precision.HIGHEST``; the process's setting is restored on exit.
    "bf16" keeps the process's setting, as JAX keeps DEFAULT."""
    if precision == "bf16":
        yield
        return
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def sym_eigh(a: torch.Tensor):
    """``jnp.linalg.eigh``: eigenvalues ascending and eigenvectors of the
    input symmetrized as (a + a^T) / 2 (``torch.linalg.eigh`` reads one
    triangle only, so a product that rounds off symmetric would differ),
    solved in float64 and rounded back to the input's dtype: cuSOLVER's
    float32 solver keeps only about 1e-5 of an eigenvalue at C = 64 (and
    stops early on a nearly diagonal input), where LAPACK's float32 keeps
    about 1e-7."""
    d, v = torch.linalg.eigh((0.5 * (a + a.transpose(-1, -2))).double())
    return d.to(a.dtype), v.to(a.dtype)


def scattering_from_banks(signal: torch.Tensor, bank1: torch.Tensor,
                          bank2: torch.Tensor, sfreq: float,
                          stride: int = 32, interpolate: bool = True,
                          use_fused: bool = False,
                          precision: str = "fast3",
                          lowpass: str = "auto"):
    """Order-2 time scattering: (..., N) -> (S1, S2).

    Args:
      signal: (..., N) real.
      bank1: (F1, N) first-layer bank.
      bank2: (F2, N) second-layer bank: its frequencies are MODULATION
        rates (typically lower, e.g. 1-64 Hz), built at interpolate=False.
      stride: output downsampling; the lowpass cutoff is sfreq/(2*stride).
      use_fused: both modulus layers through ``fused_power_from_bank``
        (then sqrt) instead of the plain ``abs_from_bank``.
      lowpass: "matmul" (one (N, N/stride) float32 matmul, needs
        stride | N), "fft", or "auto" (matmul when stride | N).

    Returns:
      S1: (..., F1, N//stride) float32
      S2: (..., F2, F1, N//stride) float32
    """
    n = signal.shape[-1]
    cutoff = sfreq / (2.0 * stride)
    if lowpass == "auto":
        lowpass = "matmul" if n % stride == 0 else "fft"
    if lowpass == "matmul":
        if n % stride:
            raise ValueError(
                f"lowpass='matmul' needs stride | N (got N={n}, "
                f"stride={stride}); use lowpass='fft' or 'auto'")
        gmat = torch.from_numpy(_smooth_decimate_operator(
            n, int(stride), float(sfreq), float(cutoff))).to(signal.device)

        def smooth(u):
            with fp32_matmul(precision):
                return torch.matmul(u, gmat)
    else:
        phi = lowpass_spectrum(n, sfreq, cutoff, device=signal.device)

        def smooth(u):
            return _smooth_decimate(u, phi, stride)
    if use_fused:
        def modulus(x, bank, analytic):
            return torch.sqrt(fused_power_from_bank(x, bank, analytic,
                                                    precision))
    else:
        def modulus(x, bank, analytic):
            return abs_from_bank(x, bank, analytic)
    u1 = modulus(signal, bank1, interpolate)              # (..., F1, N)
    s1 = smooth(u1)
    u2 = modulus(u1, bank2, False)                        # (..., F1, F2, N)
    u2 = torch.movedim(u2, -2, -3)                        # (..., F2, F1, N)
    s2 = smooth(u2)
    return s1, s2


def scattering(signal: torch.Tensor, bank1: torch.Tensor,
               bank2: torch.Tensor, sfreq: float, stride: int = 32,
               interpolate: bool = True, use_fused="auto",
               precision: str = "fast3", lowpass: str = "auto"):
    """``scattering_from_banks`` on real banks; ``use_fused="auto"`` takes
    the kernel for both modulus layers where ``ops.fused.route()`` launches
    it at N for both banks (the signal on CUDA, real banks)."""
    signal = signal.to(torch.float32)
    if use_fused == "auto":
        shape = (1, 1, signal.shape[-1])
        use_fused = all(route("power_each", shape, b,
                              device=signal.device).launch
                        for b in (bank1, bank2))
    return scattering_from_banks(signal, bank1, bank2, float(sfreq),
                                 int(stride), interpolate, bool(use_fused),
                                 str(precision), str(lowpass))
