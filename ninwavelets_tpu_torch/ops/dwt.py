"""Discrete wavelet transforms: the maximal-overlap DWT (MODWT), its inverse
and multiresolution analysis, the decimated DWT, wavelet variance,
covariance and correlation by scale, and MODWT shrinkage (port of
``ninwavelets_tpu.ops.dwt``; Percival & Walden, "Wavelet Methods for Time
Series Analysis").

The filters and the level transfer functions are built on the host in
float64, as in the JAX package, and cast to float32:

    Htil_j(k) = Htil(2^{j-1} k mod N) * prod_{m<j-1} Gtil(2^m k mod N)

a (J+1, N) frequency-domain bank (J detail rows and the level-J scaling
row), so the transform is the real part of ``ifft(bank * fft(x))`` and the
inverse the conjugate bank (a tight frame: ``sum_j |Htil_j|^2 + |Gtil_J|^2
== 1``).  Circular boundaries throughout.  The bank rows go through the
inverse FFT one at a time and the synthesis sums them one at a time, so no
(..., J+1, N) complex tensor exists at once: a 64-channel recording padded
to 2^20 samples holds its (64, 18, 2^20) float32 coefficients and a few
(64, 2^20) complex rows, not 10 GB complex intermediates.  Daubechies
filters of any order 1..20 come from spectral factorization
(``wavelet_filter``).

A numpy input goes to ``device`` (the card when None); a tensor stays on
its device.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..device import as_float32
from .denoise import _median

__all__ = ["wavelet_filter", "modwt_bank", "modwt", "imodwt", "modwt_mra",
           "modwt_var", "modwt_denoise", "max_level",
           "wavedec", "waverec", "pow2_pad", "modwt_cov", "modwt_corr",
           "modwt_var_ci"]


# ----------------------------------------------------------------------------
# Filters (host numpy, float64)
# ----------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def wavelet_filter(name: str = "db4"):
    """Orthonormal scaling/wavelet filter pair ``(g, h)`` (float64 numpy).

    ``"haar"`` / ``"db1"`` .. ``"db20"``: Daubechies extremal-phase
    filters with ``p`` vanishing moments (length ``2p``), built by
    spectral factorization: the half-band autocorrelation
    ``|G(f)|^2 = 2 cos^2p(pi f) sum_k C(p-1+k, k) sin^2k(pi f)`` is
    factored by selecting the roots of the sum polynomial inside the unit
    circle (minimum phase), then normalized to ``sum g = sqrt(2)``.
    The wavelet filter follows by quadrature mirror:
    ``h[l] = (-1)^l g[L-1-l]``.
    """
    key = name.lower()
    if key == "haar":
        key = "db1"
    if not key.startswith("db"):
        raise ValueError(f"unknown wavelet {name!r} (haar, db1..db20)")
    p = int(key[2:])
    if not 1 <= p <= 20:
        raise ValueError(f"db order must be 1..20, got {p}")
    if p == 1:
        g = np.array([1.0, 1.0]) / np.sqrt(2.0)
    else:
        # P(y) = sum_k C(p-1+k, k) y^k with y = sin^2(pi f); in z (with
        # y = (2 - z - 1/z)/4) the valid factorization keeps the roots of
        # P inside the unit disc.
        coeffs = [math.comb(p - 1 + k, k) for k in range(p)]  # ascending
        yroots = np.roots(list(reversed(coeffs)))            # p-1 roots
        zroots = []
        for y in yroots:
            # y = (2 - z - 1/z) / 4  =>  z^2 - (2 - 4y) z + 1 = 0
            b = 2.0 - 4.0 * y
            disc = np.sqrt(b * b - 4.0 + 0j)
            z1, z2 = (b + disc) / 2.0, (b - disc) / 2.0
            zroots.append(z1 if abs(z1) < 1.0 else z2)
        # g(z) ~ (1 + z)^p * prod (z - z_r), real coefficients.
        poly = np.array([1.0 + 0j])
        for _ in range(p):
            poly = np.convolve(poly, [1.0, 1.0])
        for zr in zroots:
            poly = np.convolve(poly, [1.0, -zr])
        g = np.real(poly)
        g *= np.sqrt(2.0) / g.sum()
    h = (g[::-1] * (-1.0) ** np.arange(g.size))
    return g, h


def max_level(n: int, name: str = "db4") -> int:
    """Largest level J with a non-wrapping filter: the level-J MODWT
    filter spans ``(2^J - 1)(L - 1) + 1`` samples; J is capped so that
    span fits in ``n`` (and by ``log2(n)``)."""
    L = wavelet_filter(name)[0].size
    j = 0
    while (2 ** (j + 1) - 1) * (L - 1) + 1 <= n and 2 ** (j + 1) <= n:
        j += 1
    return max(j, 1)


@functools.lru_cache(maxsize=64)
def modwt_bank(name: str, level: int, n: int):
    """(level+1, n) frequency-domain MODWT bank as a float32 numpy
    ``(real, imag)`` pair: rows 0..level-1 are the detail transfer
    functions ``Htil_j``, row ``level`` is the scaling transfer
    ``Gtil_J``."""
    if level < 1:
        raise ValueError("level must be >= 1")
    if 2 ** level > n:
        raise ValueError(f"level {level} needs 2^J <= N, got N={n}")
    g, h = wavelet_filter(name)
    gt, ht = g / np.sqrt(2.0), h / np.sqrt(2.0)    # MODWT scaling
    k = np.arange(n)
    tw = np.exp(-2j * np.pi * np.outer(k, np.arange(g.size)) / n)
    G, H = tw @ gt, tw @ ht                        # base transfers at f_k
    rows = []
    gprod = np.ones(n, np.complex128)
    for j in range(1, level + 1):
        rows.append(H[(2 ** (j - 1) * k) % n] * gprod)
        gprod = gprod * G[(2 ** (j - 1) * k) % n]
    rows.append(gprod)                             # Gtil_J
    bank = np.stack(rows)
    return (np.ascontiguousarray(bank.real, np.float32),
            np.ascontiguousarray(bank.imag, np.float32))


def _complex(re: np.ndarray, im: np.ndarray, device) -> torch.Tensor:
    """A complex64 tensor on ``device`` from a float32 numpy pair."""
    return torch.complex(torch.from_numpy(re), torch.from_numpy(im)).to(
        device)


def _bank(name: str, level: int, n: int, device) -> torch.Tensor:
    """``modwt_bank`` as a (level+1, n) complex64 tensor on ``device``."""
    return _complex(*modwt_bank(name, int(level), int(n)), device)


# ----------------------------------------------------------------------------
# Transform / inverse / MRA
# ----------------------------------------------------------------------------

def _analysis(x: torch.Tensor, bank: torch.Tensor) -> torch.Tensor:
    """(..., N) -> (..., R, N) float32: row r is the real part of
    ``ifft(bank[r] * fft(x))``, one bank row at a time."""
    spec = torch.fft.fft(x)
    out = torch.empty(x.shape[:-1] + bank.shape, dtype=torch.float32,
                      device=x.device)
    for r in range(bank.shape[0]):
        out[..., r, :] = torch.fft.ifft(spec * bank[r]).real
    return out


def _synthesis(w: torch.Tensor, bank: torch.Tensor) -> torch.Tensor:
    """(..., R, N) -> (..., N) float32: the real part of ``ifft(sum_r
    conj(bank[r]) * fft(w[..., r, :]))``, the rows added one at a time."""
    acc = None
    for r in range(bank.shape[0]):
        term = torch.fft.fft(w[..., r, :]) * torch.conj(bank[r])
        acc = term if acc is None else acc.add_(term)
    return torch.fft.ifft(acc).real.contiguous()


def _mra(w: torch.Tensor, bank: torch.Tensor) -> torch.Tensor:
    """Per-row synthesis without the cross-row sum: the additive
    components ``D_j = ifft(conj(Htil_j) fft(W_j))`` (and the smooth from
    the last row)."""
    out = torch.empty_like(w)
    for r in range(bank.shape[0]):
        out[..., r, :] = torch.fft.ifft(
            torch.fft.fft(w[..., r, :]) * torch.conj(bank[r])).real
    return out


def modwt(x, wavelet: str = "db4", level: int | None = None,
          device=None) -> torch.Tensor:
    """Maximal-overlap DWT of ``x``: (..., N) -> (..., J+1, N) float32.

    Rows 0..J-1 are the detail coefficients ``W_1 .. W_J`` (band
    ``[1/2^{j+1}, 1/2^j]`` cycles/sample), row J the level-J scaling
    coefficients ``V_J``.  Shift-invariant, energy-preserving
    (``sum_rows ||row||^2 == ||x||^2``), circular boundary.  ``level``
    defaults to ``max_level(N, wavelet)``.
    """
    x = as_float32(x, device)
    n = x.shape[-1]
    if level is None:
        level = max_level(n, wavelet)
    return _analysis(x, _bank(wavelet, level, n, x.device))


def imodwt(w, wavelet: str = "db4", device=None) -> torch.Tensor:
    """Exact inverse MODWT: (..., J+1, N) -> (..., N) float32 (the
    conjugate bank of the tight frame; the error is float round-off)."""
    w = as_float32(w, device)
    level = w.shape[-2] - 1
    return _synthesis(w, _bank(wavelet, level, w.shape[-1], w.device))


def modwt_mra(x, wavelet: str = "db4", level: int | None = None,
              device=None) -> torch.Tensor:
    """Multiresolution analysis: (..., N) -> (..., J+1, N) additive
    components ``D_1 .. D_J, S_J`` with ``sum(rows) == x`` (to round-off),
    each the zero-phase part of ``x`` in its octave, aligned with ``x`` in
    time."""
    x = as_float32(x, device)
    n = x.shape[-1]
    if level is None:
        level = max_level(n, wavelet)
    bank = _bank(wavelet, level, n, x.device)
    return _mra(_analysis(x, bank), bank)


# ----------------------------------------------------------------------------
# Decimated DWT (periodization mode)
# ----------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _dwt_transfers(name: str, n: int):
    """Base filter DFTs at length ``n`` as float32 numpy (Gr, Gi, Hr, Hi)."""
    g, h = wavelet_filter(name)
    k = np.arange(n)
    tw = np.exp(-2j * np.pi * np.outer(k, np.arange(g.size)) / n)
    G, H = tw @ g, tw @ h
    return tuple(np.ascontiguousarray(a, np.float32)
                 for a in (G.real, G.imag, H.real, H.imag))


def _trans(name: str, n: int, device):
    """``_dwt_transfers`` as two complex64 tensors (G, H) on ``device``."""
    gr, gi, hr, hi = _dwt_transfers(name, int(n))
    return _complex(gr, gi, device), _complex(hr, hi, device)


def _dwt_level(v: torch.Tensor, trans):
    """One analysis level: circular filter, then the odd samples
    (``W[t] = sum_l h_l v[(2t+1-l) mod n]``, Percival & Walden eq. 96)."""
    g, h = trans
    spec = torch.fft.fft(v)
    a = torch.fft.ifft(spec * g).real
    w = torch.fft.ifft(spec * h).real
    return a[..., 1::2].contiguous(), w[..., 1::2].contiguous()


def _idwt_level(a: torch.Tensor, w: torch.Tensor, trans) -> torch.Tensor:
    """One synthesis level: upsample by 2 onto the odd slots, then the
    CONJUGATE transfers (synthesis is correlation): the exact inverse of
    ``_dwt_level`` for orthonormal filters."""
    g, h = trans
    n = 2 * a.shape[-1]
    ua = torch.zeros(a.shape[:-1] + (n,), dtype=torch.float32,
                     device=a.device)
    uw = torch.zeros(w.shape[:-1] + (n,), dtype=torch.float32,
                     device=w.device)
    ua[..., 1::2] = a
    uw[..., 1::2] = w
    out = (torch.fft.fft(ua) * torch.conj(g)
           + torch.fft.fft(uw) * torch.conj(h))
    return torch.fft.ifft(out).real.contiguous()


def wavedec(x, wavelet: str = "db4", level: int | None = None,
            device=None):
    """Decimated orthogonal DWT, periodization mode: (..., N) ->
    ``(cA_J, cD_J, ..., cD_1)`` (pywt's ``wavedec`` order; level-j arrays
    have ``N / 2^j`` samples).  Requires ``2^J | N``.  The two transforms
    satisfy ``cD_j[t] = 2^{j/2} W^M_j[(2^j (t+1) - 1) mod N]`` exactly.
    Orthonormal: the coefficient energies sum to ``||x||^2``.
    """
    x = as_float32(x, device)
    n = x.shape[-1]
    if level is None:
        level = min(max_level(n, wavelet),
                    (n & -n).bit_length() - 1)     # largest 2^J | N
    if level < 1 or n % (1 << level):
        raise ValueError(f"level {level} needs 2^level | N (N={n})")
    v, out = x, []
    for j in range(int(level)):
        v, w = _dwt_level(v, _trans(wavelet, n >> j, x.device))
        out.append(w)
    return tuple([v] + out[::-1])


def waverec(coeffs, wavelet: str = "db4", device=None) -> torch.Tensor:
    """Inverse of ``wavedec``: ``(cA_J, cD_J, ..., cD_1)`` -> (..., N)
    float32, exact to round-off."""
    level = len(coeffs) - 1
    n = coeffs[-1].shape[-1] * 2
    for i, c in enumerate(coeffs):
        want = n >> (level if i == 0 else level - i + 1)
        if c.shape[-1] != want:
            raise ValueError(
                f"coeff {i} has {c.shape[-1]} samples, expected {want}")
    v = as_float32(coeffs[0], device)
    for j in range(level - 1, -1, -1):
        v = _idwt_level(v, as_float32(coeffs[level - j], v.device),
                        _trans(wavelet, n >> j, v.device))
    return v


# ----------------------------------------------------------------------------
# Wavelet variance and shrinkage
# ----------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _interior_masks(name: str, level: int, n: int):
    """(level, n) float32 numpy mask of BOUNDARY-FREE coefficients per
    detail level, plus the (level,) interior counts: the level-j MODWT
    filter spans ``L_j = (2^j - 1)(L - 1) + 1`` samples, so coefficients
    ``t < L_j - 1`` mix in circularly wrapped samples (Percival & Walden
    eq. 306).  Levels with no interior coefficients get an all-zero row
    (count 0 -> the unbiased estimators return NaN there)."""
    L = wavelet_filter(name)[0].size
    mask = np.zeros((level, n), np.float32)
    counts = np.zeros((level,), np.float32)
    for j in range(1, level + 1):
        lj = (2 ** j - 1) * (L - 1) + 1
        m = n - lj + 1
        if m > 0:
            mask[j - 1, lj - 1:] = 1.0
            counts[j - 1] = m
    return mask, counts


def _level_mean(d: torch.Tensor, wavelet: str, unbiased: bool):
    """Per-level mean over time, biased (all N) or boundary-free (0/0 ->
    NaN where a level has no interior coefficient)."""
    if not unbiased:
        return torch.mean(d, dim=-1)
    mask, counts = _interior_masks(wavelet, d.shape[-2], d.shape[-1])
    return (torch.sum(d * torch.from_numpy(mask).to(d.device), dim=-1)
            / torch.from_numpy(counts).to(d.device))


def modwt_var(x, wavelet: str = "db4", level: int | None = None,
              unbiased: bool = False, device=None) -> torch.Tensor:
    """Wavelet variance by scale: (..., N) -> (..., J), the level-j entry
    ``||W_j||^2 / N`` (the biased MODWT estimator: the rows plus the
    smooth's variance partition ``mean(x^2)``).  ``unbiased=True`` takes
    only boundary-free coefficients (Percival & Walden); levels whose
    filter span exceeds N are NaN."""
    w = modwt(x, wavelet, level, device)
    return _level_mean(torch.square(w[..., :-1, :]), wavelet, unbiased)


def _shrink_(w: torch.Tensor, lam: torch.Tensor, mode: str) -> torch.Tensor:
    """Threshold the detail rows of ``w`` in place (the smooth row kept):
    soft ``sign(d) max(|d| - t, 0)`` or hard ``d if |d| > t else 0``."""
    t = lam[..., :, None]
    d = w[..., :-1, :]
    if mode == "soft":
        mag = torch.clamp(d.abs() - t, min=0.0)
        d.sign_().mul_(mag)
    else:
        d.masked_fill_(~(d.abs() > t), 0.0)
    return w


def pow2_pad(x, device=None):
    """Reflect-pad the last axis up to the next power of two, returning
    ``(padded, original_n)``.  The reflection keeps the circular
    boundary's artifacts of the padded transform away from the retained
    samples (numpy's "reflect", as ``jnp.pad``'s)."""
    if not isinstance(x, torch.Tensor):
        x = as_float32(x, device)
    n = x.shape[-1]
    n2 = 1 << (n - 1).bit_length()
    if n2 == n:
        return x, n
    return x.index_select(-1, _reflect_index(n, n2, x.device)), n


def _reflect_index(n: int, n2: int, device) -> torch.Tensor:
    """Gather indices of a numpy-"reflect" pad of an axis from ``n`` samples
    to ``n2``: a length-1 axis repeats its sample, as ``jnp.pad`` does
    (``torch.nn.functional.pad(mode="reflect")`` raises there)."""
    return torch.from_numpy(np.pad(np.arange(n), (0, n2 - n),
                                   mode="reflect")).to(device)


def modwt_denoise(x, wavelet: str = "db4", level: int | None = None,
                  mode: str = "soft", sigma: float | None = None,
                  pad_pow2: bool = False, device=None) -> torch.Tensor:
    """Wavelet shrinkage on the MODWT: threshold the detail rows, keep
    the smooth, invert.  (..., N) -> (..., N) float32.

    ``pad_pow2=True`` reflect-pads to the next power of two before the
    transform and crops after: the padding changes the result within one
    filter span of the far edge, so it is part of the answer.

    The threshold is level-dependent universal: the level-j MODWT detail
    filter has squared norm ``1/2^j``, so white noise of std ``sigma``
    lands at std ``sigma / 2^{j/2}`` in level j and
    ``lambda_j = sigma sqrt(2 ln N) / 2^{j/2}``.  ``sigma`` defaults to
    the level-1 MAD estimate ``median(|W_1|) / 0.6745 * sqrt(2)``
    (Donoho-Johnstone, corrected for the level-1 filter norm; the median
    of an even count is the mean of its two middle values).

    ``mode``: "soft" (shrink toward zero) or "hard" (keep-or-kill).
    """
    if mode not in ("soft", "hard"):
        raise ValueError(f"mode must be 'soft' or 'hard', got {mode!r}")
    x = as_float32(x, device)
    if pad_pow2:
        padded, n0 = pow2_pad(x)
        if n0 != padded.shape[-1]:
            return modwt_denoise(padded, wavelet, level, mode,
                                 sigma)[..., :n0].contiguous()
    n = x.shape[-1]
    if level is None:
        level = max_level(n, wavelet)
    bank = _bank(wavelet, level, n, x.device)
    w = _analysis(x, bank)
    if sigma is None:
        sig = _median(w[..., 0, :].abs()) / 0.6745 * math.sqrt(2.0)
    else:
        sig = torch.full(x.shape[:-1], float(sigma), dtype=torch.float32,
                         device=x.device)
    j = torch.arange(1, int(level) + 1, dtype=torch.float32,
                     device=x.device)
    lam = (sig[..., None] * math.sqrt(2.0 * math.log(n))
           / torch.exp2(j / 2.0))
    return _synthesis(_shrink_(w, lam, str(mode)), bank)


def modwt_cov(x, y, wavelet: str = "db4", level: int | None = None,
              unbiased: bool = False, device=None) -> torch.Tensor:
    """Wavelet covariance by scale (Percival & Walden ch. 9): (..., N) x2
    -> (..., J), the level-j entry ``mean_t(Wx_j Wy_j)`` (biased; the
    levels plus the smooths' covariance partition the sample covariance).
    ``unbiased=True`` excludes the boundary coefficients."""
    wx = modwt(x, wavelet, level, device)
    wy = modwt(y, wavelet, level, wx.device)
    return _level_mean(wx[..., :-1, :] * wy[..., :-1, :], wavelet,
                       unbiased)


def modwt_corr(x, y, wavelet: str = "db4", level: int | None = None,
               eps: float = 0.0, unbiased: bool = False,
               device=None) -> torch.Tensor:
    """Wavelet correlation by scale: ``modwt_cov`` over the two wavelet
    standard deviations per level, in [-1, 1].  ``eps`` floors the
    denominator (0 keeps 0/0 -> NaN for a scale with no energy)."""
    wx = modwt(x, wavelet, level, device)
    wy = modwt(y, wavelet, level, wx.device)
    dx, dy = wx[..., :-1, :], wy[..., :-1, :]
    cov = _level_mean(dx * dy, wavelet, unbiased)
    den = torch.sqrt(_level_mean(dx * dx, wavelet, unbiased)
                     * _level_mean(dy * dy, wavelet, unbiased))
    if eps:
        den = torch.clamp(den, min=eps)
    return cov / den


def modwt_var_ci(x, wavelet: str = "db4", level: int | None = None,
                 p: float = 0.95, device=None):
    """Unbiased wavelet variance with chi-square confidence intervals:
    (..., N) -> ``(var, lo, hi)`` each (..., J).

    Percival & Walden's EDOF-1 recipe (eq. 313): the level-j estimator
    behaves as ``var * chi2_eta / eta`` with ``eta_j = max(M_j / 2^j, 1)``
    (M_j boundary-free coefficients), so
    ``CI = (eta v / chi2_{(1+p)/2}, eta v / chi2_{(1-p)/2})``.  The
    quantiles are ``ops.tc_stats``'s Wilson-Hilferty cube (DOF rounded to
    the nearest integer, at least 1).  Levels with no boundary-free
    coefficient are NaN throughout."""
    from .tc_stats import _chi2_ppf
    x = as_float32(x, device)
    v = modwt_var(x, wavelet, level, unbiased=True)
    j_total = v.shape[-1]
    _, counts = _interior_masks(wavelet, j_total, x.shape[-1])
    lo = np.empty(j_total, np.float32)
    hi = np.empty(j_total, np.float32)
    for j in range(1, j_total + 1):
        eta = max(int(round(counts[j - 1] / 2.0 ** j)), 1)
        lo[j - 1] = eta / _chi2_ppf((1.0 + p) / 2.0, eta)
        hi[j - 1] = eta / _chi2_ppf((1.0 - p) / 2.0, eta)
    return (v, v * torch.from_numpy(lo).to(v.device),
            v * torch.from_numpy(hi).to(v.device))
