"""Cycle-by-cycle waveform analysis (Cole & Voytek, J. Neurophysiol. 2019,
the "bycycle" method), port of ``ninwavelets_tpu.ops.cycles``: segment an
oscillation into cycles, measure each one's shape (period, rise-decay and
peak-trough asymmetry, amplitude, monotonicity) and flag the cycles that
belong to bursts.

As in the JAX package everything is static in shape and batched over
rows: the narrowband localizer is a raised-cosine bandpass on the rfft
grid of the row reflect-padded to a power of two (``ops.dwt.pow2_pad``);
rising / falling zero crossings of the filtered trace become segment ids
by a cumsum; the per-segment extrema of the RAW signal are two segment
reductions (``scatter_reduce`` "amax" for the value, then "amin" over the
indices that reach it); every per-cycle table is padded to a static width
``ceil(1.5 N f_hi / sfreq) + 4`` with a count of valid cycles per row.
Segment ids past the table go to one extra column that is dropped, as
``jax.ops.segment_*`` drops them.

A numpy input goes to ``device`` (the card when None); a tensor stays on
its device.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..device import as_float32
from .dwt import pow2_pad

__all__ = ["cycle_features", "CycleTable"]


class CycleTable(NamedTuple):
    """Padded per-cycle features, each (..., K); entries at index >=
    ``n_cycles`` are zero / False padding.  Cycles run trough-to-trough
    with one peak inside; times are in seconds from the signal start."""
    n_cycles: torch.Tensor       # (...,) int32 valid cycles per row
    time_trough: torch.Tensor    # (..., K) left trough time [s]
    time_peak: torch.Tensor      # (..., K) peak time [s]
    period_s: torch.Tensor       # (..., K) trough-to-trough period [s]
    freq_hz: torch.Tensor        # (..., K) 1 / period
    volt_amp: torch.Tensor       # (..., K) mean of rise and decay swing
    rdsym: torch.Tensor          # (..., K) rise fraction of the period
    ptsym: torch.Tensor          # (..., K) peak fraction of peak+trough
    monotonicity: torch.Tensor   # (..., K) monotone fraction of flanks
    is_burst: torch.Tensor       # (..., K) bool, bycycle burst criteria


def _bandpass(x, sfreq, f_lo, f_hi, trans_frac=0.25):
    """Raised-cosine bandpass on the rfft grid of the pow2-padded rows."""
    n = x.shape[-1]
    x, _ = pow2_pad(x)
    n2 = x.shape[-1]
    f = torch.arange(n2 // 2 + 1, dtype=torch.float32,
                     device=x.device) * (sfreq / n2)
    tl = f_lo * trans_frac
    th = f_hi * trans_frac

    def edge(d, w):                       # 0 below, 1 above, cosine ramp
        return 0.5 * (1.0 + torch.sin(math.pi * (d / w).clamp(-0.5, 0.5)))

    gain = edge(f - f_lo, 2.0 * tl) * edge(f_hi - f, 2.0 * th)
    y = torch.fft.irfft(torch.fft.rfft(x) * gain, n=n2, dim=-1)
    return y[..., :n]


def _segment(src, seg, num, reduce, fill):
    """Per-row segment reduction of (B, N) ``src`` over ids ``seg`` in
    [0, num] into (B, num): id ``num`` is a dropped column; an empty
    segment holds ``fill``."""
    out = torch.full((src.shape[0], num + 1), fill, dtype=src.dtype,
                     device=src.device)
    return out.scatter_reduce(1, seg, src, reduce)[:, :num]


def _seg_argext(values, seg, valid, kmax, mode):
    """Per-segment argmax ('max') / argmin ('min') of ``values`` over
    samples where ``valid``: (idx (B, S), found (B, S)), by two scatter
    reductions."""
    n = values.shape[-1]
    seg = seg.clamp(max=kmax)
    v = torch.where(valid, values if mode == "max" else -values,
                    torch.full_like(values, -math.inf))
    best = _segment(v, seg, kmax, "amax", -math.inf)
    # ids past the table read the last column, as a clamped JAX gather
    hit = valid & (v >= torch.gather(best, 1, seg.clamp(max=kmax - 1)))
    ar = torch.arange(n, device=values.device).expand_as(seg)
    idx = _segment(torch.where(hit, ar, n), seg, kmax, "amin", n)
    found = best > -math.inf
    return torch.where(found, idx, 0), found


def _take(a, i, hi):
    """``a`` gathered along the last axis at ``i`` clipped to [0, hi]."""
    return torch.gather(a, -1, i.clamp(0, hi))


def _row_features(x, xf, sfreq, kmax):
    """Every feature of (B, N) rows; returns the tuple of CycleTable's
    fields, each (B, K) but the (B,) count."""
    b, n = x.shape
    dev = x.device
    t_idx = torch.arange(n, device=dev).expand(b, n)
    kk = torch.arange(kmax, device=dev).expand(b, kmax)
    false = torch.zeros(b, 1, dtype=torch.bool, device=dev)
    # rising zero-crossings of the filtered trace start half-cycles
    rise = torch.cat([false, (xf[:, :-1] < 0) & (xf[:, 1:] >= 0)], -1)
    fall = torch.cat([false, (xf[:, :-1] >= 0) & (xf[:, 1:] < 0)], -1)
    # peak segment p: [rise_p, next fall); trough q: [fall_q, next rise)
    pseg = torch.cumsum(rise.to(torch.int64), -1) - 1   # -1 before first
    qseg = torch.cumsum(fall.to(torch.int64), -1) - 1
    in_peak = (pseg >= 0) & (xf >= 0)
    in_trough = (qseg >= 0) & (xf < 0)
    pk_idx, pk_ok = _seg_argext(x, pseg.clamp(min=0), in_peak, kmax, "max")
    tr_idx, tr_ok = _seg_argext(x, qseg.clamp(min=0), in_trough, kmax,
                                "min")

    n_rise = rise.sum(-1, keepdim=True)
    n_fall = fall.sum(-1, keepdim=True)
    # drop UNCLOSED trailing half-cycles: if the last crossing is a rise,
    # the final peak segment runs to the end with no closing fall
    minus = torch.full_like(t_idx, -1)
    last_rise = torch.where(rise, t_idx, minus).amax(-1, keepdim=True)
    last_fall = torch.where(fall, t_idx, minus).amax(-1, keepdim=True)
    pk_ok = pk_ok & ~((kk == n_rise - 1) & (last_rise > last_fall))
    tr_ok = tr_ok & ~((kk == n_fall - 1) & (last_fall > last_rise))
    # pair troughs with the peak that follows them: if the first
    # extremum is a peak, peak j sits AFTER trough j-1
    first_rise = rise.to(torch.int8).argmax(-1, keepdim=True)
    first_fall = fall.to(torch.int8).argmax(-1, keepdim=True)
    peak_leads = (first_rise < first_fall) & (n_rise > 0) & (n_fall > 0)
    pk_of = torch.where(peak_leads, kk + 1, kk)          # peak of trough j
    hi = kmax - 1
    pk_t = _take(pk_idx, pk_of, hi)
    pk_valid = _take(pk_ok, pk_of, hi) & (pk_of < kmax)

    # cycle j: trough j -> peak(j) -> trough j+1
    tr_next = _take(tr_idx, kk + 1, hi)
    tr_next_ok = _take(tr_ok, kk + 1, hi) & (kk + 1 < kmax)
    valid = tr_ok & tr_next_ok & pk_valid & (pk_t > tr_idx) \
        & (tr_next > pk_t)
    n_cycles = valid.sum(-1, keepdim=True)
    # compact valid cycles to the front (stable order preserved)
    order = torch.argsort(torch.where(valid, kk, kmax), dim=-1,
                          stable=True)
    pad = kk < n_cycles

    def take(a):
        return torch.where(pad, torch.gather(a, -1, order), 0)

    tr0 = take(tr_idx)
    tr1 = take(tr_next)
    pk = take(pk_t)
    period = (tr1 - tr0).to(torch.float32).clamp(min=1.0)
    rdsym = (pk - tr0).to(torch.float32) / period

    def xv(i):
        return _take(x, i, n - 1)

    amp = 0.5 * ((xv(pk) - xv(tr0)) + (xv(pk) - xv(tr1)))

    # monotonicity: the monotone fraction of the raw-signal flanks; sample
    # i lies on cycle j's rise if tr0_j <= i < pk_j, on its decay if
    # pk_j <= i < tr1_j
    dx = torch.cat([torch.zeros_like(x[:, :1]), torch.diff(x, dim=-1)], -1)
    starts = torch.zeros_like(t_idx).scatter_add_(1, tr0, pad.to(
        torch.int64))
    cyc = torch.cumsum(starts, -1) - 1
    in_cyc = cyc >= 0
    pk_s = _take(pk, cyc, hi)
    on_rise = in_cyc & (t_idx >= _take(tr0, cyc, hi)) & (t_idx < pk_s)
    on_decay = in_cyc & (t_idx >= pk_s) & (t_idx < _take(tr1, cyc, hi))
    seg_ids = torch.where(in_cyc, cyc, kmax)
    fzero = torch.zeros_like(x)
    mono_hits = torch.where(on_rise, (dx > 0).to(x.dtype), fzero) \
        + torch.where(on_decay, (dx < 0).to(x.dtype), fzero)
    flank = (on_rise | on_decay).to(x.dtype)
    hits = _segment(mono_hits, seg_ids, kmax, "sum", 0.0)
    tot = _segment(flank, seg_ids, kmax, "sum", 0.0)
    mono = hits / tot.clamp(min=1.0)

    # peak / trough durations from raw-waveform flank-midpoint crossings
    # (the bycycle rule): the first rise-flank sample at or above the
    # trough-peak midpoint, the first decay-flank sample at or below it
    mid_r = _take(0.5 * (xv(tr0) + xv(pk)), cyc, hi)
    mid_d = _take(0.5 * (xv(pk) + xv(tr1)), cyc, hi)
    big = torch.full_like(t_idx, n)
    rise_zx = _segment(torch.where(on_rise & (x >= mid_r), t_idx, big),
                       seg_ids, kmax, "amin", n)
    decay_zx = _segment(torch.where(on_decay & (x <= mid_d), t_idx, big),
                        seg_ids, kmax, "amin", n)
    rise_zx = torch.where(rise_zx >= n, pk, rise_zx)     # fallback: peak
    decay_zx = torch.where(decay_zx >= n, tr1, decay_zx)  # fallback
    peak_dur = (decay_zx - rise_zx).to(torch.float32).clamp(min=1.0)
    # the compacted neighbour is usable only when nothing was dropped in
    # between (its left trough is our right trough)
    adjacent = ((kk + 1) < n_cycles) & (_take(tr0, kk + 1, hi) == tr1)
    trough_dur = torch.where(
        adjacent, (_take(rise_zx, kk + 1, hi) - decay_zx).to(torch.float32),
        period - peak_dur).clamp(min=1.0)
    ptsym = peak_dur / (peak_dur + trough_dur)

    dt = 1.0 / sfreq

    def z(a):
        return torch.where(pad, a, torch.zeros_like(a))

    freq = torch.where(pad, torch.full_like(period, sfreq) / period,
                       torch.zeros_like(period))
    return (n_cycles[:, 0].to(torch.int32), z(tr0 * dt), z(pk * dt),
            z(period * dt), freq, z(amp), z(rdsym), z(ptsym), z(mono))


def _burst_flags(n_cycles, amp, period, mono, kmax, amp_fraction,
                 amp_consistency, period_consistency,
                 monotonicity_threshold, min_n_cycles):
    kk = torch.arange(kmax, device=amp.device)[None, :]
    pad = kk < n_cycles[:, None]
    # amplitude fraction: rank of each cycle's amp among the row's cycles
    rank = ((amp[:, None, :] < amp[:, :, None]) & pad[:, None, :]).sum(-1)
    frac = rank.to(torch.float32) / (n_cycles - 1)[:, None].to(
        torch.float32).clamp(min=1.0)
    c_amp = frac >= amp_fraction

    def consistency(v):
        # edge cycles get a one-sided rule on both ends
        shifted = torch.cat([v[:, 1:], v[:, -1:]], -1)
        nxt = torch.where(kk >= (n_cycles - 1)[:, None], v, shifted)
        prv = torch.cat([v[:, :1], v[:, :-1]], -1)
        r_n = torch.minimum(v, nxt) / torch.maximum(v, nxt).clamp(min=1e-12)
        r_p = torch.minimum(v, prv) / torch.maximum(v, prv).clamp(min=1e-12)
        return torch.minimum(r_n, r_p)

    ok = c_amp & (consistency(amp) >= amp_consistency) \
        & (consistency(period) >= period_consistency) \
        & (mono >= monotonicity_threshold) & pad
    # a cycle bursts iff it sits in a run of >= min_n_cycles passing
    # cycles: the run sums of min_n_cycles consecutive flags
    w = kmax - min_n_cycles + 1
    runs = ok.to(torch.float32).unfold(-1, min_n_cycles, 1).sum(-1)
    full = runs >= min_n_cycles - 0.5            # run starting at j
    member = torch.zeros_like(ok)
    for s in range(min_n_cycles):
        member[:, s:s + w] |= full
    return member & ok


def cycle_features(signal_r, sfreq: float, f_range,
                   amp_fraction: float = 0.0,
                   amp_consistency: float = 0.5,
                   period_consistency: float = 0.5,
                   monotonicity_threshold: float = 0.8,
                   min_n_cycles: int = 3, device=None) -> CycleTable:
    """Cycle-by-cycle shape features of a real (..., N) signal in the
    ``f_range = (f_lo, f_hi)`` band: a ``CycleTable`` of padded (..., K)
    per-cycle features plus bycycle-style burst flags.  Cycles are cut at
    the zero crossings of a raised-cosine bandpass of the signal; peaks
    and troughs (and every feature) are localized on the RAW signal
    inside each half-cycle.  Cycles count as bursting only inside a run
    of ``min_n_cycles`` consecutive passing cycles."""
    f_lo, f_hi = (float(f_range[0]), float(f_range[1]))
    if not (0.0 < f_lo < f_hi):
        raise ValueError("f_range must satisfy 0 < f_lo < f_hi")
    if f_hi >= sfreq / 2.0:
        raise ValueError("f_hi must be below Nyquist")
    x = as_float32(signal_r, device)
    n = x.shape[-1]
    if n < 16:
        raise ValueError("signal too short")
    sfreq = float(sfreq)
    # the crossing rate is bounded by the top of the TRANSITION band
    # (1.25 f_hi), with margin; overflowing cycles would be dropped
    kmax = int(np.ceil(1.5 * n * f_hi / sfreq)) + 4
    lead = x.shape[:-1]
    flat = x.reshape(-1, n)
    feats = _row_features(flat, _bandpass(flat, sfreq, f_lo, f_hi), sfreq,
                          kmax)
    n_cycles, t_tr, t_pk, period, freq, amp, rdsym, ptsym, mono = feats
    burst = _burst_flags(n_cycles, amp, period / (1.0 / sfreq), mono, kmax,
                         float(amp_fraction), float(amp_consistency),
                         float(period_consistency),
                         float(monotonicity_threshold), int(min_n_cycles))
    out = (n_cycles, t_tr, t_pk, period, freq, amp, rdsym, ptsym, mono,
           burst)
    return CycleTable(out[0].reshape(lead),
                      *[f.reshape(*lead, kmax) for f in out[1:]])
