"""Sleep-EEG event detection, port of ``ninwavelets_tpu.ops.sleep``:
spindles and slow oscillations (the YASA / Massimini workflows).

* **spindles**: sigma-band (11-16 Hz) moving-RMS envelope above a robust
  (median-based) threshold; segments are the cumsum of the mask's rising
  edges, their bounds, envelope peak and zero-crossing count are segment
  reductions, and the duration criteria are validity flags of a padded
  (K,) table;
* **slow oscillations**: delta-band negative half-waves (Massimini 2004:
  negative-phase duration, trough and trough-to-peak amplitude), with
  thresholds that adapt to the row's robust sigma unless absolute ones are
  given.

Rows are batched: every input (..., N) runs as (B, N).  The segment
reductions are ``scatter_reduce`` with ``include_self=False`` into tables
prefilled with ``jax.ops.segment_*``'s fills for empty segments (the
int32 maximum for a min, the minimum or -inf for a max, 0 for a sum).
The medians average the two middle values of an even count, as
``jnp.median`` does (``torch.median`` takes the lower one).

A numpy input goes to ``device`` (the card when None); a tensor stays on
its device.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..device import as_float32
from .cycles import _bandpass
from .denoise import _median
from .signal_utils import row_cumsum

__all__ = ["EventTable", "detect_spindles", "detect_slow_oscillations"]

_IMAX = torch.iinfo(torch.int32).max
_IMIN = torch.iinfo(torch.int32).min


class EventTable(NamedTuple):
    """Padded per-row detection table (leading dims mirror the input's
    batch dims; K is the static event capacity).  ``start`` / ``stop`` are
    sample indices (stop inclusive, int32), ``duration`` seconds,
    ``peak_amp`` signal units (envelope peak for spindles, trough for slow
    oscillations), ``freq`` Hz, ``valid`` marks real events (padded rows
    are zero).  ``overflow`` (per row) is True when the row produced more
    threshold crossings than ``kmax``: the detectors raise on it."""
    start: torch.Tensor
    stop: torch.Tensor
    duration: torch.Tensor
    peak_amp: torch.Tensor
    freq: torch.Tensor
    valid: torch.Tensor
    overflow: torch.Tensor


def _moving_rms(x, w: int):
    """Centered moving RMS over ``w`` samples via one cumsum (edges use
    the partial window).  The running sum is float64: in float32 (the JAX
    package) a window's energy is the difference of two sums of the whole
    prefix, and an hour at 256 Hz loses 3e-3 of the envelope's max."""
    c = row_cumsum((x * x).double())
    n = x.shape[-1]
    idx = torch.arange(n, device=x.device)
    hi = torch.clamp(idx + w // 2, max=n - 1)
    lo = torch.clamp(idx - (w - w // 2), min=-1)
    tot = c[..., hi] - torch.where(lo >= 0, c[..., torch.clamp(lo, min=0)],
                                   torch.zeros((), device=x.device))
    return torch.sqrt(torch.clamp(tot, min=0.0) / (hi - lo)).to(torch.float32)


def _segments_from_mask(mask, kmax: int):
    """(seg_ids (B, N) int64, overflow (B,)): 1-based in-mask segment ids
    (0 = background), ids beyond ``kmax`` clipped into bin ``kmax``;
    ``overflow`` True when clipping merged segments."""
    m = mask.to(torch.int64)
    rising = torch.cat([m[:, :1], torch.clamp(m[:, 1:] - m[:, :-1], min=0)],
                       dim=1)
    raw = torch.cumsum(rising, dim=1) * m
    return torch.clamp(raw, max=kmax), raw.amax(dim=1) > kmax


def _segment(src, seg, kmax: int, reduce: str, fill):
    """Per-row ``jax.ops.segment_*`` of (B, N) ``src`` over ids ``seg`` in
    [0, kmax] into (B, kmax + 1); an empty segment holds ``fill``."""
    out = torch.full((src.shape[0], kmax + 1), fill, dtype=src.dtype,
                     device=src.device)
    return out.scatter_reduce(1, seg, src, reduce, include_self=False)


def _seg_bounds(seg, kmax: int):
    n = seg.shape[-1]
    idx = torch.arange(n, dtype=torch.int32, device=seg.device).expand(
        seg.shape)
    inside = seg > 0
    start = _segment(torch.where(inside, idx, n), seg, kmax, "amin", _IMAX)
    stop = _segment(torch.where(inside, idx, -1), seg, kmax, "amax", _IMIN)
    found = stop >= start
    zero = torch.zeros_like(start)
    return (torch.where(found, start, zero)[:, 1:],
            torch.where(found, stop, zero)[:, 1:], found[:, 1:])


def _neg_inf_where(mask, x):
    return torch.where(mask, x, torch.full_like(x, -torch.inf))


def _spindles_rows(x, *, sfreq, f_lo, f_hi, rms_win, kmax, thresh,
                   dur_lo, dur_hi):
    xf = _bandpass(x, sfreq, f_lo, f_hi)
    env = _moving_rms(xf, rms_win)
    thr = thresh * _median(env)
    seg, overflow = _segments_from_mask(env > thr[:, None], kmax)
    start, stop, found = _seg_bounds(seg, kmax)
    dur = (stop - start + 1).to(torch.float32) / sfreq
    ok = found & (dur >= dur_lo) & (dur <= dur_hi)
    z = torch.zeros_like(dur)
    peak = _segment(_neg_inf_where(seg > 0, env), seg, kmax, "amax",
                    -torch.inf)[:, 1:]
    peak = torch.where(ok, peak, z)
    # oscillation frequency: zero crossings of the filtered trace
    zx = (torch.signbit(xf[:, :-1]) != torch.signbit(xf[:, 1:])).to(
        torch.float32)
    s0 = seg[:, :-1]
    zc = _segment(zx * (s0 > 0), s0, kmax, "sum", 0.0)[:, 1:]
    freq = torch.where(ok & (dur > 0),
                       zc / (2.0 * torch.clamp(dur, min=1e-9)), z)
    return EventTable(
        start=torch.where(ok, start, 0).to(torch.int32),
        stop=torch.where(ok, stop, 0).to(torch.int32),
        duration=torch.where(ok, dur, z), peak_amp=peak, freq=freq,
        valid=ok, overflow=overflow)


def _unflatten(tab: EventTable, shape) -> EventTable:
    return EventTable(*(v.reshape(tuple(shape) + tuple(v.shape[1:]))
                        for v in tab))


def detect_spindles(x, sfreq: float, freq_range=(11.0, 16.0),
                    thresh: float = 3.0, duration=(0.5, 2.0),
                    rms_win_s: float = 0.2, kmax: int = 4096,
                    device=None) -> EventTable:
    """Sleep-spindle detection on (..., N) recordings (YASA-style
    moving-RMS rule): sigma-band envelope above ``thresh`` x its median
    for a duration inside ``duration`` seconds.  ``kmax`` caps the per-row
    table; more threshold crossings than ``kmax`` in a row raise.  The
    spindle frequency comes from the in-segment zero crossings."""
    x = as_float32(x, device)
    if x.shape[-1] < int(sfreq):
        raise ValueError("need at least one second of data")
    f_lo, f_hi = float(freq_range[0]), float(freq_range[1])
    if not 0 < f_lo < f_hi < sfreq / 2:
        raise ValueError("freq_range must be inside (0, sfreq/2)")
    tab = _spindles_rows(
        x.reshape(-1, x.shape[-1]), sfreq=float(sfreq), f_lo=f_lo,
        f_hi=f_hi, rms_win=max(2, int(round(rms_win_s * sfreq))),
        kmax=int(kmax), thresh=float(thresh), dur_lo=float(duration[0]),
        dur_hi=float(duration[1]))
    if bool(tab.overflow.any()):
        raise ValueError(
            f"more than kmax={kmax} threshold crossings in at least "
            "one row — raise kmax (tables are cheap) or the threshold")
    return _unflatten(tab, x.shape[:-1])


def _so_rows(x, amp_neg, amp_ptp, *, sfreq, f_lo, f_hi, kmax, dur_lo,
             dur_hi, neg_mult, ptp_mult):
    xf = _bandpass(x, sfreq, f_lo, f_hi)
    if amp_neg is None:
        sigma = 1.4826 * _median(torch.abs(xf))          # robust std
        amp_neg = (neg_mult * sigma)[:, None]
        amp_ptp = (ptp_mult * sigma)[:, None]
    neg = xf < 0
    seg, oneg = _segments_from_mask(neg, kmax)           # negative phases
    start, stop, found = _seg_bounds(seg, kmax)
    dur_neg = (stop - start + 1).to(torch.float32) / sfreq
    neg_peak = -_segment(_neg_inf_where(seg > 0, -xf), seg, kmax, "amax",
                         -torch.inf)[:, 1:]
    pos_seg, opos = _segments_from_mask(~neg, kmax)
    pstart, pstop, pfound = _seg_bounds(pos_seg, kmax)
    pos_peak_all = _segment(_neg_inf_where(pos_seg > 0, xf), pos_seg, kmax,
                            "amax", -torch.inf)[:, 1:]
    # the positive phase following negative phase k: positive segments are
    # numbered in order too, one ahead when the row starts positive
    j = torch.arange(kmax, device=x.device)
    follower = torch.clamp(torch.where(pstart[:, :1] == 0, j + 1, j),
                           max=kmax - 1)
    pos_peak = torch.gather(pos_peak_all, 1, follower)
    pos_ok = torch.gather(pfound, 1, follower) & (pos_peak > -torch.inf)
    z = torch.zeros_like(dur_neg)
    ptp = torch.where(pos_ok, pos_peak - neg_peak, z)
    ok = (found & (dur_neg >= dur_lo) & (dur_neg <= dur_hi)
          & (neg_peak <= -amp_neg) & pos_ok & (ptp >= amp_ptp))
    stop_full = torch.where(pos_ok, torch.gather(pstop, 1, follower), stop)
    dur_full = (stop_full - start + 1).to(torch.float32) / sfreq
    return EventTable(
        start=torch.where(ok, start, 0).to(torch.int32),
        stop=torch.where(ok, stop_full, 0).to(torch.int32),
        duration=torch.where(ok, dur_full, z),
        peak_amp=torch.where(ok, neg_peak, z),
        freq=torch.where(ok & (dur_full > 0),
                         1.0 / torch.clamp(dur_full, min=1e-9), z),
        valid=ok, overflow=oneg | opos)


def detect_slow_oscillations(x, sfreq: float, freq_range=(0.3, 1.5),
                             duration_neg=(0.3, 1.5),
                             amp_neg: Optional[float] = None,
                             amp_ptp: Optional[float] = None,
                             neg_mult: float = 4.0,
                             ptp_mult: float = 6.0,
                             kmax: int = 32768,
                             device=None) -> EventTable:
    """Slow-oscillation detection on (..., N) recordings (Massimini 2004):
    delta-band negative half-waves of ``duration_neg`` seconds whose
    trough is below ``-amp_neg`` and whose trough-to-following-peak
    amplitude exceeds ``amp_ptp``.  With both amplitudes None the
    thresholds are ``neg_mult`` / ``ptp_mult`` times each row's robust
    sigma (1.4826 x MAD of the filtered trace).  ``peak_amp`` is the
    (negative) trough; ``freq`` the full cycle's frequency."""
    x = as_float32(x, device)
    if x.shape[-1] < 4 * sfreq / float(freq_range[0]):
        raise ValueError("recording too short for the delta band")
    if (amp_neg is None) != (amp_ptp is None):
        raise ValueError("give both amp_neg and amp_ptp, or neither")
    amps = (None, None) if amp_neg is None else tuple(
        torch.tensor(float(a), dtype=torch.float32, device=x.device)
        for a in (amp_neg, amp_ptp))
    tab = _so_rows(
        x.reshape(-1, x.shape[-1]), *amps, sfreq=float(sfreq),
        f_lo=float(freq_range[0]), f_hi=float(freq_range[1]),
        kmax=int(kmax), dur_lo=float(duration_neg[0]),
        dur_hi=float(duration_neg[1]), neg_mult=float(neg_mult),
        ptp_mult=float(ptp_mult))
    if bool(tab.overflow.any()):
        raise ValueError(
            f"more than kmax={kmax} delta half-waves in at least one "
            "row — raise kmax (tables are cheap)")
    return _unflatten(tab, x.shape[:-1])
