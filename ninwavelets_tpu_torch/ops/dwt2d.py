"""2-D decimated wavelet transform, separable, periodization mode (port of
``ninwavelets_tpu.ops.dwt2d``).

Built from the 1-D level primitives of ``ops.dwt`` (circular FFT filtering
and strided decimation), applied along W (the last axis) and then along H
(through a transpose):

* ``dwt2``:     (..., H, W) -> (LL, (LH, HL, HH)), one level
* ``wavedec2``: pywt-style multilevel list [LL_J, (LH_J, HL_J, HH_J),
                ..., (LH_1, HL_1, HH_1)]
* ``waverec2``: exact inverse (orthonormal filters, periodization)

LH = lowpass x / highpass y (horizontal edges), HL = highpass x / lowpass y
(vertical edges), HH = diagonal.  H and W must be divisible by 2^level.
"""
from __future__ import annotations

from ..device import as_float32
from .dwt import _dwt_level, _idwt_level, _trans, max_level

__all__ = ["dwt2", "idwt2", "wavedec2", "waverec2", "max_level2"]


def max_level2(h: int, w: int, name: str = "db4") -> int:
    """Largest usable level: the filter-length bound on the SHORTER side,
    capped by divisibility (2^J must divide both H and W)."""
    by_len = max_level(min(h, w), name)
    by_div = min((h & -h).bit_length(), (w & -w).bit_length()) - 1
    return max(1, min(by_len, by_div))


def _level_y(img, trans):
    a, d = _dwt_level(img.transpose(-1, -2), trans)
    return a.transpose(-1, -2), d.transpose(-1, -2)


def _dwt2_level(img, trans_x, trans_y):
    ax, dx = _dwt_level(img, trans_x)     # along W (last axis)
    ll, lh = _level_y(ax, trans_y)        # lowpass x -> split y
    hl, hh = _level_y(dx, trans_y)        # highpass x -> split y
    return ll, lh, hl, hh


def _idwt2_level(ll, lh, hl, hh, trans_x, trans_y):
    ax = _idwt_level(ll.transpose(-1, -2), lh.transpose(-1, -2),
                     trans_y).transpose(-1, -2)
    dx = _idwt_level(hl.transpose(-1, -2), hh.transpose(-1, -2),
                     trans_y).transpose(-1, -2)
    return _idwt_level(ax, dx, trans_x)


def _check(h: int, w: int, level: int):
    if level < 1 or h % (1 << level) or w % (1 << level):
        raise ValueError(
            f"level {level} needs 2^level to divide H={h} and W={w}")


def wavedec2(img, wavelet: str = "db4", level: int | None = None,
             device=None) -> list:
    """Multilevel 2-D DWT of a real (..., H, W) image (leading axes are
    batch): ``[LL_J, (LH_J, HL_J, HH_J), ..., (LH_1, HL_1, HH_1)]``, the
    level-j subbands (..., H/2^j, W/2^j) float32 tensors.  Orthonormal in
    periodization mode: the subband energies sum to ``||img||^2``."""
    img = as_float32(img, device)
    h, w = img.shape[-2:]
    if level is None:
        level = max_level2(h, w, wavelet)
    _check(h, w, level)
    out = []
    ll = img
    for j in range(int(level)):
        ll, lh, hl, hh = _dwt2_level(ll, _trans(wavelet, w >> j, img.device),
                                     _trans(wavelet, h >> j, img.device))
        out.append((lh, hl, hh))
    return [ll.contiguous()] + [tuple(c.contiguous() for c in d)
                                for d in out[::-1]]


def waverec2(coeffs, wavelet: str = "db4", device=None):
    """Inverse of :func:`wavedec2`, exact to round-off."""
    level = len(coeffs) - 1
    ll, details = coeffs[0], coeffs[1:]
    h, w = ll.shape[-2] << level, ll.shape[-1] << level
    for i, (lh, hl, hh) in enumerate(details):
        want = (h >> (level - i), w >> (level - i))
        for c in (lh, hl, hh):
            if tuple(c.shape[-2:]) != want:
                raise ValueError(
                    f"detail level {level - i} has shape "
                    f"{tuple(c.shape[-2:])}, expected {want}")
    cur = as_float32(ll, device)
    for i, (lh, hl, hh) in enumerate(details):
        j = level - 1 - i
        cur = _idwt2_level(cur, *(as_float32(c, cur.device)
                                  for c in (lh, hl, hh)),
                           _trans(wavelet, w >> j, cur.device),
                           _trans(wavelet, h >> j, cur.device))
    return cur


def dwt2(img, wavelet: str = "db4", device=None):
    """One-level 2-D DWT: (..., H, W) -> ``(LL, (LH, HL, HH))``."""
    out = wavedec2(img, wavelet, level=1, device=device)
    return out[0], out[1]


def idwt2(ll, details, wavelet: str = "db4", device=None):
    """Inverse of :func:`dwt2`."""
    return waverec2([ll, details], wavelet, device)
