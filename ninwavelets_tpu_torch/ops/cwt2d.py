"""2-D continuous wavelet transform: directional Morlet over images (port of
``ninwavelets_tpu.ops.cwt2d``; Antoine & Murenzi 1996).

In the frequency domain the analyzing wavelet is

    psi_hat(k; s, theta) = exp(-sigma^2 |s k - k0 e_theta|^2 / 2),

a Gaussian blob at wavenumber ``omega0 / s`` along direction ``theta``:
each (scale, orientation) row responds to oriented oscillation at one
spatial frequency.  Frequencies are in CYCLES PER PIXEL (Nyquist 0.5);
``s = omega0 / (2 pi f)``.

The blob factors per (scale, theta), ``|s k - k0 e_theta|^2 = (s kx -
k0x)^2 + (s ky - k0y)^2``, so every bank row is a rank-1 product ``by(ky)
bx(kx)`` of real 1-D Gaussians (built on the host in float64).  The
default path multiplies the image's ``fft2`` by the two factors and
inverse-transforms, at any H and W (the JAX package forms the same
product as a sandwich of DFT matrices, its choice for the TPU, whose
fft2 was slow).  ``use_fft=True`` is the full-bank oracle: the (F, T, H,
W) bank itself times ``fft2``, power-of-two sizes only, as in the JAX
package.  No matrix product is left, so TF32 does not reach this module.

A numpy input goes to ``device`` (the card when None); a tensor stays on
its device.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import as_float32, resolve_device
from .dwt import _reflect_index

__all__ = ["morlet2d_bank", "cwt2", "power2d", "pow2_pad2"]

OMEGA0 = 5.5


@functools.lru_cache(maxsize=32)
def _bank_np(freqs_key: tuple, thetas_key: tuple, h: int, w: int,
             sigma: float, omega0: float) -> np.ndarray:
    """(F, T, H, W) float32 frequency-domain bank, peak value 1 at each
    row's center wavenumber."""
    ky = 2.0 * np.pi * np.fft.fftfreq(h)[:, None]     # radians / pixel
    kx = 2.0 * np.pi * np.fft.fftfreq(w)[None, :]
    rows = np.empty((len(freqs_key), len(thetas_key), h, w), np.float32)
    for i, f in enumerate(freqs_key):
        s = omega0 / (2.0 * np.pi * f)
        for j, th in enumerate(thetas_key):
            k0y, k0x = omega0 * np.sin(th), omega0 * np.cos(th)
            d2 = (s * kx - k0x) ** 2 + (s * ky - k0y) ** 2
            rows[i, j] = np.exp(-0.5 * sigma ** 2 * d2)
    return rows


@functools.lru_cache(maxsize=32)
def _bank_sep_np(freqs_key: tuple, thetas_key: tuple, h: int, w: int,
                 sigma: float, omega0: float):
    """Separable factors of :func:`_bank_np`: real (F, T, H) and
    (F, T, W) Gaussians whose outer product is the 2-D bank."""
    ky = 2.0 * np.pi * np.fft.fftfreq(h)
    kx = 2.0 * np.pi * np.fft.fftfreq(w)
    f = np.asarray(freqs_key, np.float64)[:, None, None]
    th = np.asarray(thetas_key, np.float64)[None, :, None]
    s = omega0 / (2.0 * np.pi * f)
    by = np.exp(-0.5 * sigma ** 2
                * (s * ky - omega0 * np.sin(th)) ** 2)
    bx = np.exp(-0.5 * sigma ** 2
                * (s * kx - omega0 * np.cos(th)) ** 2)
    return by.astype(np.float32), bx.astype(np.float32)


def _keys(freqs, thetas):
    fk = tuple(float(f) for f in np.atleast_1d(freqs))
    tk = tuple(float(t) for t in np.atleast_1d(thetas))
    if any(f <= 0 or f > 0.5 for f in fk):
        raise ValueError("freqs are cycles/pixel in (0, 0.5]")
    return fk, tk


def morlet2d_bank(freqs, thetas, h: int, w: int, sigma: float = 1.0,
                  omega0: float = OMEGA0, device=None) -> torch.Tensor:
    """(F, T, H, W) real directional-Morlet bank for fft2-domain use, on
    ``device`` (the card when None)."""
    fk, tk = _keys(freqs, thetas)
    return torch.from_numpy(_bank_np(fk, tk, int(h), int(w), float(sigma),
                                     float(omega0))).to(
        resolve_device(device))


def pow2_pad2(img, device=None):
    """Reflect-pad the trailing two axes up to the next powers of two (at
    least 2); returns ``(padded, (h, w))`` with the original sizes for
    cropping."""
    img = as_float32(img, device)
    h, w = img.shape[-2:]
    hp = 1 << max(int(np.ceil(np.log2(max(h, 2)))), 1)
    wp = 1 << max(int(np.ceil(np.log2(max(w, 2)))), 1)
    if hp != h:
        img = img.index_select(-2, _reflect_index(h, hp, img.device))
    if wp != w:
        img = img.index_select(-1, _reflect_index(w, wp, img.device))
    return img, (h, w)


def _check_pow2(h: int, w: int):
    if h & (h - 1) or w & (w - 1):
        raise ValueError(
            f"use_fft=True needs power-of-two H and W, got H={h}, W={w}; "
            "use pow2_pad2, or the default path, which takes any size")


def _cwt2(img, freqs, thetas, sigma, omega0, use_fft) -> torch.Tensor:
    """(..., F, T, H, W) complex64 coefficients of (..., H, W) ``img``."""
    h, w = img.shape[-2:]
    if thetas is None:
        thetas = np.arange(6) * np.pi / 6.0
    fk, tk = _keys(freqs, thetas)
    spec = torch.fft.fft2(img)[..., None, None, :, :]
    if use_fft:
        _check_pow2(h, w)
        bank = torch.from_numpy(_bank_np(fk, tk, h, w, float(sigma),
                                         float(omega0))).to(img.device)
        return torch.fft.ifft2(spec * bank)
    by, bx = (torch.from_numpy(b).to(img.device) for b in _bank_sep_np(
        fk, tk, h, w, float(sigma), float(omega0)))
    return torch.fft.ifft2(spec * (by[..., :, None] * bx[..., None, :]))


def cwt2(img, freqs, thetas=None, sigma: float = 1.0,
         omega0: float = OMEGA0, use_fft: bool = False,
         device=None) -> torch.Tensor:
    """Directional 2-D CWT of a real (..., H, W) image: complex64
    coefficient planes (..., F, T, H, W).  ``thetas`` defaults to 6
    orientations over [0, pi) (the transform of a real image at theta +
    pi is the conjugate).  The default path applies the separable bank
    factors between ``fft2`` and ``ifft2`` at any size; ``use_fft=True``
    the full (F, T, H, W) bank (power-of-two sizes only)."""
    return _cwt2(as_float32(img, device), freqs, thetas, sigma, omega0,
                 use_fft)


def power2d(img, freqs, thetas=None, sigma: float = 1.0,
            omega0: float = OMEGA0, use_fft: bool = False,
            device=None) -> torch.Tensor:
    """(..., F, T, H, W) scalogram ``|W|^2`` of :func:`cwt2`."""
    wv = _cwt2(as_float32(img, device), freqs, thetas, sigma, omega0,
               use_fft)
    return torch.square(wv.real) + torch.square(wv.imag)
