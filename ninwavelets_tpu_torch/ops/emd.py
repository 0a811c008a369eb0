"""Empirical Mode Decomposition (Huang et al., Proc. R. Soc. A 1998) and
its ensemble variant EEMD (Wu & Huang, AADA 2009), port of
``ninwavelets_tpu.ops.emd``: sift a signal into intrinsic mode functions
by repeatedly subtracting the mean of its upper and lower extrema
envelopes.

The design is the JAX package's, batched and static in shape:

* the natural cubic spline envelope is computed on the sample grid: the
  neighbouring knot positions and values come from forward and backward
  fills (a running ``cummax`` / ``cummin`` of the knot indices and one
  gather), and the Thomas solve of the second derivatives runs as
  log-depth associative scans: the normalized Moebius 2x2 products of the
  forward elimination, then two affine recurrences.  ``_assoc_scan``
  combines the elements on the odd / even tree of
  ``jax.lax.associative_scan``, so the products are formed in the same
  order as in the JAX package;
* ``spline="akima"`` keeps the sort compaction of the knots and Akima's
  local slope rule, as the JAX package has it;
* the sifting depth and the IMF count are fixed; rows whose residual has
  fewer than 3 interior extrema emit zero IMFs, so ``sum(imfs) + residual
  == signal`` holds in float32;
* EEMD's noise realizations ride a leading batch axis; the noise comes
  from a ``torch.Generator`` (``_eemd_from_noise`` takes given noise).

Boundary rule: the first and last samples are knots of both envelopes.

A numpy input goes to ``device`` (the card when None); a tensor stays on
its device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import as_float32

__all__ = ["emd", "eemd", "n_imfs_default"]


def n_imfs_default(n: int) -> int:
    """The usual dyadic-bank heuristic: log2(N) minus a safety margin."""
    return max(1, int(np.log2(n)) - 3)


def _assoc_scan(fn, elems):
    """Inclusive scan of the associative ``fn(earlier, later)`` over a tuple
    of tensors along the last axis, in log depth, combining on the odd /
    even tree of ``jax.lax.associative_scan``: pairs are reduced, the half
    scanned recursively, and the even positions finished from it."""
    n = elems[0].shape[-1]
    if n < 2:
        return elems
    odd = _assoc_scan(fn, fn(tuple(e[..., 0:-1:2] for e in elems),
                             tuple(e[..., 1::2] for e in elems)))
    head = tuple(o[..., :-1] for o in odd) if n % 2 == 0 else odd
    even = fn(head, tuple(e[..., 2::2] for e in elems))
    out = []
    for e, ev, od in zip(elems, even, odd):
        r = torch.empty_like(e)
        r[..., :1] = e[..., :1]
        r[..., 2::2] = ev
        r[..., 1::2] = od
        out.append(r)
    return tuple(out)


# ---------------------------------------------------------------- knots

def _interior_extrema(x, kind: str):
    """(B, N) bool mask of strict interior maxima ('max') / minima
    ('min'); endpoints are never marked."""
    left = x[:, 1:-1] - x[:, :-2]
    right = x[:, 1:-1] - x[:, 2:]
    if kind == "max":
        hit = (left > 0) & (right > 0)
    else:
        hit = (left < 0) & (right < 0)
    return torch.nn.functional.pad(hit, (1, 1))


def _with_ends(mask):
    mask = mask.clone()
    mask[:, 0] = True
    mask[:, -1] = True
    return mask


def _knots(x, mask):
    """Compact (B, N) knot masks into sorted padded knot arrays: positions
    (B, K) float32 ascending (valid knots first, then out-of-range padding
    at 2N+i), values (B, K) with the padding clamped to the last sample,
    valid counts (B,), and the mask with both ends set.  K = N//2 + 2."""
    n = x.shape[-1]
    kmax = n // 2 + 2
    mask = _with_ends(mask)
    idx = torch.arange(n, device=x.device)
    pos = torch.where(mask, idx, 2 * n + idx)
    pos = torch.sort(pos, dim=-1).values[:, :kmax]
    y = torch.gather(x, -1, pos.clamp(0, n - 1))
    k = mask.sum(-1)
    return pos.to(torch.float32), y, k, mask


# --------------------------------------------------------------- spline

def _akima_coeffs(t, y, k):
    """Akima-slope cubic Hermite coefficients through the padded knots;
    the ghost slopes of the dynamic right boundary are patched in at
    columns k+1 and k+2."""
    kk = t.shape[-1]
    h = torch.diff(t, dim=-1)
    h = torch.cat([h, torch.ones_like(h[:, :1])], -1)
    m = (torch.roll(y, -1, -1) - y) / h            # slope of segment j

    last = (k - 2).clamp(0, kk - 1)                # last valid segment
    m_last = torch.gather(m, -1, last[:, None])[:, 0]
    m_prev = torch.gather(m, -1, (last - 1).clamp(0, kk - 1)[:, None])[:, 0]
    g1 = 2.0 * m_last - m_prev                     # slope at segment k-1
    g2 = 2.0 * g1 - m_last                         # slope at segment k
    gl1 = 2.0 * m[:, :1] - m[:, 1:2]               # slope at segment -1
    gl2 = 2.0 * gl1 - m[:, :1]                     # slope at segment -2
    mext = torch.cat([gl2, gl1, m, torch.zeros_like(m[:, :2])], -1)
    col = torch.arange(kk + 4, device=t.device)[None, :]
    mext = torch.where(col == (k + 1)[:, None], g1[:, None], mext)
    mext = torch.where(col == (k + 2)[:, None], g2[:, None], mext)

    # the Akima weights of the slope AT knot j use segments j-2 .. j+1
    w1 = (mext[:, 3:kk + 3] - mext[:, 2:kk + 2]).abs()
    w2 = (mext[:, 1:kk + 1] - mext[:, 0:kk]).abs()
    den = w1 + w2
    flat = den < 1e-9 * (mext[:, 2:kk + 2].abs()
                         + mext[:, 1:kk + 1].abs() + 1e-30)
    s = torch.where(
        flat, 0.5 * (mext[:, 1:kk + 1] + mext[:, 2:kk + 2]),
        (w1 * mext[:, 1:kk + 1] + w2 * mext[:, 2:kk + 2])
        / torch.where(den == 0, torch.ones_like(den), den))

    s_next = torch.roll(s, -1, -1)
    c2 = (3.0 * m - 2.0 * s - s_next) / h
    c3 = (s + s_next - 2.0 * m) / (h * h)
    return y, s, c2, c3


def _envelope(x, mask, spline: str):
    """(B, N) spline envelope through the knots marked by ``mask``."""
    if spline == "natural":
        return _envelope_grid(x, mask)
    n = x.shape[-1]
    t, y, k, mask = _knots(x, mask)
    y0, c1, c2, c3 = _akima_coeffs(t, y, k)
    # segment of sample tau = (# knots at or before tau) - 1, clipped to
    # the last valid segment k-2
    seg = torch.cumsum(mask.to(torch.int64), -1) - 1
    seg = torch.minimum(seg, (k - 2)[:, None])
    dt = torch.arange(n, dtype=torch.float32, device=x.device)[None, :] \
        - torch.gather(t, -1, seg)

    def g(arr):
        return torch.gather(arr, -1, seg)

    return g(y0) + dt * (g(c1) + dt * (g(c2) + dt * g(c3)))


# ------------------------------------------------- grid-domain natural

def _mob(p, q):
    """Product of the homogeneous 2x2 Moebius maps (q after p), scaled by
    its largest entry: the cp ratio is scale-invariant, and the scaling
    keeps ~1000-deep products of h-scaled entries finite in float32."""
    p00, p01, p10, p11 = p
    q00, q01, q10, q11 = q
    r00 = q00 * p00 + q01 * p10
    r01 = q00 * p01 + q01 * p11
    r10 = q10 * p00 + q11 * p10
    r11 = q10 * p01 + q11 * p11
    s = torch.maximum(torch.maximum(r00.abs(), r01.abs()),
                      torch.maximum(r10.abs(), r11.abs()))
    s = torch.where(s > 0, s, torch.ones_like(s))
    return r00 / s, r01 / s, r10 / s, r11 / s


def _aff(p, q):
    """Composition of the affine maps x -> A x + B (p earlier than q)."""
    ap, bp = p
    aq, bq = q
    return ap * aq, bq + aq * bp


def _shift_left(a, last):
    """a[:, 1:] followed by ``last`` (a (B, 1) column)."""
    return torch.cat([a[:, 1:], last], -1)


def _envelope_grid(x, mask):
    """Natural cubic spline envelope computed on the sample grid (the JAX
    package's ``_envelope_grid``): every knot lies on the integer grid,
    so the neighbouring knots come from fills, the Thomas solve runs over
    the N axis with pass-through steps at non-knot samples, and the
    evaluation coefficients are fills of the knot-resident solution."""
    b, n = x.shape
    mask = _with_ends(mask)
    ar = torch.arange(n, device=x.device)
    # index of the last knot <= i and of the first knot >= i
    prev = torch.cummax(torch.where(mask, ar, -1), -1).values
    nxt = torch.cummin(torch.where(mask, ar, n).flip(-1), -1).values.flip(-1)
    iB = ar.to(torch.float32).expand(b, n)
    tprev = prev.to(torch.float32)     # knot position t_j of segment j
    tnext = nxt.to(torch.float32)
    yprev = torch.gather(x, -1, prev)
    ynext = torch.gather(x, -1, nxt)
    # strictly-previous / strictly-next knot (for the knot rows)
    tm1 = torch.cat([tprev[:, :1], tprev[:, :-1]], -1)
    ym1 = torch.cat([x[:, :1], yprev[:, :-1]], -1)
    tp1 = _shift_left(tnext, tnext[:, -1:])
    yp1 = _shift_left(ynext, x[:, -1:])

    # Thomas rows at knots (natural BC: endpoint rows stay identity so
    # M = 0 there); non-knot samples carry the recurrence through.
    one = torch.ones_like(x)
    zero = torch.zeros_like(x)
    hprev = iB - tm1
    hnext = tp1 - iB
    interior = mask & (iB > 0) & (iB < n - 1)
    sl_prev = (x - ym1) / torch.where(hprev > 0, hprev, one)
    sl_next = (yp1 - x) / torch.where(hnext > 0, hnext, one)
    a = torch.where(interior, hprev, zero)
    bb = torch.where(interior, 2.0 * (hprev + hnext), one)
    cc = torch.where(interior, hnext, zero)
    dd = torch.where(interior, 6.0 * (sl_next - sl_prev), zero)

    # forward elimination: cp_j = c_j / (b_j - a_j cp_{j-1}) is a Moebius
    # map; non-knot samples compose the identity
    _, m01, _, m11 = _assoc_scan(_mob, (
        torch.where(mask, zero, one), torch.where(mask, cc, zero),
        torch.where(mask, -a, zero), torch.where(mask, bb, one)))
    cp = m01 / torch.where(m11 != 0, m11, one)      # prefix @ (0, 1)
    cp_prev = torch.cat([torch.zeros_like(cp[:, :1]), cp[:, :-1]], -1)
    den = bb - a * cp_prev
    _, dp = _assoc_scan(_aff, (torch.where(mask, -a / den, one),
                               torch.where(mask, dd / den, zero)))
    _, mrev = _assoc_scan(_aff, (torch.where(mask, -cp, one).flip(-1),
                                 torch.where(mask, dp, zero).flip(-1)))
    mgrid = torch.where(mask, mrev.flip(-1), zero)  # second derivatives

    mj = torch.gather(mgrid, -1, prev)              # M_j for segment j
    mj1 = _shift_left(torch.gather(mgrid, -1, nxt),
                      mgrid[:, -1:])                # M_{j+1}
    yj1 = _shift_left(ynext, x[:, -1:])             # y_{j+1}
    tj1 = _shift_left(tnext, tnext[:, -1:])
    h = tj1 - tprev
    hs = torch.where(h > 0, h, one)     # dt = 0 wherever h would be 0
    dt = iB - tprev
    slope = (yj1 - yprev) / hs
    c1 = slope - hs * (2.0 * mj + mj1) / 6.0
    c2 = mj / 2.0
    c3 = (mj1 - mj) / (6.0 * hs)
    return yprev + dt * (c1 + dt * (c2 + dt * c3))


# -------------------------------------------------------------- sifting

def _mean_envelope(x, spline: str):
    if spline == "natural":
        # upper and lower envelopes ride one batch of 2B rows
        b = x.shape[0]
        mm = torch.cat([_interior_extrema(x, "max"),
                        _interior_extrema(x, "min")], 0)
        env = _envelope_grid(torch.cat([x, x], 0), mm)
        return 0.5 * (env[:b] + env[b:])
    upper = _envelope(x, _interior_extrema(x, "max"), spline)
    lower = _envelope(x, _interior_extrema(x, "min"), spline)
    return 0.5 * (upper + lower)


def _n_extrema(x):
    return (_interior_extrema(x, "max").sum(-1)
            + _interior_extrema(x, "min").sum(-1))


def _emd(x, *, n_imfs, n_siftings, spline):
    """(B, N) -> ((B, M, N) IMFs, (B, N) residual)."""
    r = x
    imfs = []
    for _ in range(int(n_imfs)):
        active = _n_extrema(r) >= 3
        h = r
        for _ in range(int(n_siftings)):
            h = h - _mean_envelope(h, spline)
        imf = torch.where(active[:, None], h, torch.zeros_like(h))
        r = r - imf
        imfs.append(imf)
    return torch.stack(imfs, 1), r


def _prepare(signal_r, n_imfs, spline, device):
    if spline not in ("natural", "akima"):
        raise ValueError("spline must be 'natural' or 'akima'")
    x = as_float32(signal_r, device)
    n = x.shape[-1]
    if n < 8:
        raise ValueError("signal too short for EMD (N >= 8)")
    return x, n, int(n_imfs_default(n) if n_imfs is None else n_imfs)


def emd(signal_r, n_imfs: int | None = None, n_siftings: int = 10,
        spline: str = "natural", device=None):
    """``(imfs, residual)`` of a real (..., N) signal: intrinsic mode
    functions (..., M, N) from fast to slow, plus the residual (..., N);
    ``sum(imfs, -2) + residual == signal``.

    ``n_imfs`` defaults to ``log2(N) - 3``; ``n_siftings`` is the fixed
    sifting depth per IMF; ``spline`` is ``"natural"`` (cubic-spline
    envelopes) or ``"akima"`` (local slopes).  Rows whose residual drops
    below 3 interior extrema emit zero IMFs."""
    x, n, n_imfs = _prepare(signal_r, n_imfs, spline, device)
    lead = x.shape[:-1]
    imfs, res = _emd(x.reshape(-1, n), n_imfs=n_imfs,
                     n_siftings=n_siftings, spline=spline)
    return imfs.reshape(*lead, n_imfs, n), res.reshape(*lead, n)


def _eemd_from_noise(x, noise, *, n_imfs, n_siftings, spline,
                     noise_strength):
    """EEMD of (B, N) signals over the given (E, B, N) unit white noise:
    ``noise_strength`` x each signal's sd scales it."""
    e, b, n = noise.shape
    sd = x.std(-1, correction=0, keepdim=True)      # (B, 1)
    ens = x[None] + noise_strength * sd[None] * noise
    imfs, _ = _emd(ens.reshape(-1, n), n_imfs=n_imfs,
                   n_siftings=n_siftings, spline=spline)
    imfs = imfs.reshape(e, b, n_imfs, n).mean(0)
    return imfs, x - imfs.sum(-2)


def eemd(signal_r, n_imfs: int | None = None, n_ensembles: int = 100,
         noise_strength: float = 0.2, n_siftings: int = 10,
         spline: str = "natural", seed: int = 0, device=None):
    """Ensemble EMD (Wu & Huang 2009): ``emd`` over ``n_ensembles``
    white-noise-perturbed copies (noise sd = ``noise_strength`` x signal
    sd), IMFs averaged across the ensemble.  The noise comes from a
    ``torch.Generator`` seeded with ``seed`` on the signal's device (other
    draws than the JAX package's for one seed).  Returns ``(imfs,
    residual)`` with ``residual = signal - sum(imfs)``."""
    x, n, n_imfs = _prepare(signal_r, n_imfs, spline, device)
    lead = x.shape[:-1]
    flat = x.reshape(-1, n)
    gen = torch.Generator(device=flat.device).manual_seed(int(seed))
    noise = torch.randn((int(n_ensembles),) + tuple(flat.shape),
                        generator=gen, device=flat.device)
    imfs, res = _eemd_from_noise(flat, noise, n_imfs=n_imfs,
                                 n_siftings=n_siftings, spline=spline,
                                 noise_strength=float(noise_strength))
    return imfs.reshape(*lead, n_imfs, n), res.reshape(*lead, n)
