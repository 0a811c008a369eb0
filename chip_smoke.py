#!/usr/bin/env python3
"""Drive the PyTorch port (``ninwavelets_tpu_torch``) once on one CUDA card.

    python3 chip_smoke.py          # from the root of the repository

What it does, failing (non-zero exit, no result line) if any check fails:

1. Requires CUDA and prints the card's name and power limit (nvidia-smi).
2. Builds the kernels (``csrc/fused_cwt.cu``, the forward,
   ``csrc/fused_cwt_bwd.cu``, the power backward, and ``csrc/fused_ssq.cu``,
   synchrosqueezing) for sm_90a, one nvcc process a source, all started
   together, into one library, and prints each kernel's registers and
   spills.

Slice 1, serving:

3. Drives the main path through the public entry points at the headline
   workload, 64 channels x 200 epochs x 2048 samples at 1 kHz, 100 Morse
   frequencies (1-100 Hz): ``EpochsWavelet.power_all`` with a (0, 0.2) s
   z-score baseline, ``itc_all`` and ``power_itc_all`` on
   ``Morse(interpolate=True)``; ``power_all`` on the default Morse
   (``interpolate=False``); ``itc_all`` on a ragged 19 epochs.  The launch
   counters are zeroed just before and read just after; every forward
   epilogue must have launched.
4. Holds every kernel result against the plain ``torch.fft`` path on the
   same tensors: power max|d| / max|ref| <= 1e-5; the baselined (z-scored)
   power within that power tolerance carried through (p - mean) / std, cell
   by cell (a z-score amplifies any float32 difference by max_row(p) /
   std_row, which is unbounded on a row with a flat baseline window: the
   1 Hz row holds a single FFT bin at N = 2048, so its power is constant in
   time and its window std is round-off, in both paths alike);
   ITC max|d| <= 2e-3 overall and <= 1e-4 where the power is at least 1e-6
   of its channel's plane maximum (the unit phase of a near-zero
   coefficient is round-off); NaN masks equal.
5. Checks a small known answer through the kernel: phase-locked 60 Hz
   epochs peak at the 60 Hz row with ITC ~ 1 there.
6. Times each epilogue and its plain version at the headline shape: median
   of 5 repetitions after warm-up, fresh input values each repetition,
   ``torch.cuda.synchronize()`` before each stop of the clock.

Slice 2, training (at the JAX package's grad workload, ``bench.py:306-309``:
64 epochs x 64 channels x 2048 samples, 100 Morse rows, interpolate=True):

7. Drives ``learn_bank(..., use_fused=True)`` for 3 steps from 1.2 x the
   Morse bank against the plain power of the Morse bank, the counters
   zeroed just before: the loss must fall, and the forward "power" and the
   "power_bwd" kernels must each have launched once a step.
8. Holds the fused backward (the autograd Function's ds and dbank under a
   seeded random cotangent) against ``mean_power_bwd`` on the same tensors,
   max|d| / max|ref| <= 1e-4 each: at the full shape, at
   ``interpolate=False`` with E = 8, and with F = 13 (a ragged row group);
   then at every N the kernel takes (256 ... 16384, both ``interpolate``
   settings) on a small batch.
9. Known answers: the bank gradient of -mean(power) of phase-locked 60 Hz
   epochs, summed over rows, peaks within a bin of 60 x 2048 / 1000; the
   ITC Function's gradients equal plain autograd of ``itc_from_bank``
   (rtol 1e-4, atol 1e-5 max); 5 steps of ``learn_bank`` at E = 8 follow
   the plain path's losses (rtol 1e-3); ``fit_frequencies`` finds a 60 Hz
   tone from [40, 75] Hz to within 1 Hz.
10. Times the fused backward (rFFT + kernel + sums + iFFT) against
   ``mean_power_bwd``, and one loss-and-gradient step on both paths; then
   breaks both down by CUDA events.

Slice 3, long recordings (the JAX package's streaming bench geometry,
``bench.py:58-77``: 10 min at 1 kHz, 100 Morse rows over 2-100 Hz,
``interpolate=True``, window 11524 -> halo 2430 -> extended window 16384,
window batch 8; here with 64 channels riding the batch):

11. Drives ``RawWavelet(raw, Morse(interpolate=True), window=11524,
   batch=8).power`` on a duck-typed 64 x 600,000 raw (seeded noise, a
   60 Hz tone on channel 0), the counters zeroed just before: "power_each"
   (K4) must launch once per window batch (7), and the (64, 100, 600000)
   plane must be finite.
12. Holds K4 against its plain version (``ops.cwt.power_from_bank``) on
   the same tensors, max|d| / max|ref| <= 1e-5: the first and the ragged
   last window batch at all 64 channels; the whole plane of 4 channels
   against ``StreamingCWT(use_fused=False)``; a small batch at every N
   from 256 to 16384 at both ``interpolate`` settings.  Known answers:
   channel 0's interior matches one whole-signal 600,000-point transform
   to 1e-3 of the max (the JAX package's gate); its strongest row is the
   one nearest 60 Hz.
13. ``OnlineCWT`` fed channel 0 in seeded random chunks must be
   bit-identical to ``StreamingCWT(batch=1).power``.
14. ``Morse(interpolate=True).scattering`` on 16 x 4096 samples (freqs1 =
   geomspace(8, 400, 24), freqs2 = geomspace(1, 64, 12), stride 32;
   ``benchmarks/extensions_bench.py:88-103``) runs both modulus layers
   through K4 and matches ``use_fused=False``, S1 and S2 rel <= 1e-5.
15. Times (median of 5 after warm-up, fresh values each run): one
   64-channel window batch through K4 and through the plain path; the
   single-channel ``StreamingCWT.power_device`` at the bench geometry,
   fused and plain, in signal-seconds/s; the 64-channel ``RawWavelet.power``;
   and a CUDA-event breakdown of one 64-channel batch.

Slice 4, synchrosqueezing (the serving data; the JAX package's
``BENCH_MODE=ssq``, ``bench.py:107-160``, at 200 epochs):

16. Drives ``EpochsWavelet.ssq_power_all`` at 200 x 64 x 2048 with
   ``Morse(interpolate=True)`` on ``arange(1, 101)`` Hz (a "lin" row map),
   then on 48 log-spaced rows (``4 * 2^(k/8)``) at a ragged 19 epochs, the
   counters zeroed just before each: "amax" (K5a) and "ssq" (K5b) must
   each launch exactly once per call.
17. Holds K5a's (C, E) peaks against the plain max of ``power_from_bank``
   (max|d| / max|ref| <= 1e-5) and the kernel path against the plain
   ``ssq_mean_power_from_bank`` on the same tensors: each time column's
   energy rel <= 1e-5, SNR >= 40 dB (the JAX package's on-chip gate: cells
   whose instantaneous frequency sits on a row edge may land in the
   neighbouring row), no NaN, printing the SNR and the count of cells that
   differ by more than 1e-3 of the max; at full width on both grids, then
   at every N from 256 to 16384 on both grids with an all-zero channel,
   whose plane must be zero.  Known answer: a 60 Hz tone plus 0.1 noise
   (8 x 2 x 2048) puts >= 0.95 of its interior energy in rows 59-61 Hz.
18. Drives ``RawWavelet.ssq_power`` over the slice-3 recording on
   ``arange(2, 102)`` Hz (a "lin" map; slice 3's float32 ``linspace`` grid
   is piecewise and runs the plain path): both kernels launch once per
   window batch (7), and 4 channels match ``StreamingCWT(use_fused=False)``
   at the gates of 17.
19. Times (median of 5 after warm-up, fresh values each run) the kernel
   path of the 200-epoch call against the plain path, K5a and K5b alone by
   CUDA events, and the 64-channel ``RawWavelet.ssq_power``; then breaks
   one 64-channel recording batch down by CUDA events.

The line before the last is the kernels' JSON record, with each kernel's
bound: the larger of its compulsory bytes over 3.35 TB/s and its FFT flops
(5 N log2 N per complex FFT, half that per real one) over 67 TFLOP/s, the
H100 SXM's published fp32 peaks.  The last line is
``{"ok": true, "device": {...}}``.
"""
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

SFREQ = 1000.0
E, C, N, F = 200, 64, 2048, 100
E_RAGGED = 19
BASELINE = (0.0, 0.2)
REPS = 5
POWER_RTOL = 1e-5
ITC_ATOL, ITC_ATOL_STRONG, STRONG_POWER = 2e-3, 1e-4, 1e-6
KERNEL_SOURCE = "ninwavelets_tpu_torch/csrc/fused_cwt.cu"
REPLACES = "ninwavelets_tpu/ops/fused.py:205"
BWD_SOURCE = "ninwavelets_tpu_torch/csrc/fused_cwt_bwd.cu"
BWD_REPLACES = "ninwavelets_tpu/ops/fused.py:880"
E_GRAD, E_SMALL, F_RAGGED, STEPS = 64, 8, 13, 3
GRAD_RTOL = 1e-4
REC_C, REC_N, REC_F = 64, 600_000, 100     # 64 channels x 10 min at 1 kHz
REC_WINDOW, REC_BATCH, REC_HALO, REC_EXT = 11524, 8, 2430, 16384
EACH_REPLACES = "ninwavelets_tpu/ops/fused.py:299"
AMAX_REPLACES = "ninwavelets_tpu/ops/fused.py:358"
SSQ_SOURCE = "ninwavelets_tpu_torch/csrc/fused_ssq.cu"
SSQ_REPLACES = "ninwavelets_tpu/ops/fused.py:530"
SSQ_SNR_DB, SSQ_COLSUM_RTOL = 40.0, 1e-5
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12     # H100 SXM: fp32 non-tensor, HBM3


class SmokeFailure(Exception):
    pass


FAILURES = []


def check(cond, msg):
    """Record a failed check; ``main`` fails after every check has run."""
    if not cond:
        print(f"FAILED: {msg}")
        FAILURES.append(msg)


def rel_err(name, got, ref, gate=POWER_RTOL):
    """max|d|, failing when max|d| / max|ref| > ``gate``."""
    check(got.shape == ref.shape, f"{name}: shape {tuple(got.shape)} != "
          f"{tuple(ref.shape)}")
    check(bool(got.isfinite().all()), f"{name}: non-finite values")
    err = (got - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    print(f"check {name}: max|d| {err} rel {rel} (gate {gate})")
    check(rel <= gate, f"{name}: rel err {rel} > {gate}")
    return err


def baselined_err(name, got, ref_power):
    """The z-scored power against the plain path's z-scores of the same
    data.  z = (p - mean) / std over the baseline window, so a power error
    of at most POWER_RTOL x the row's max P moves z by at most
    2 POWER_RTOL P (1 + |z|) / std: the gate is that bound, cell by cell.
    max|d| / max|ref| is printed beside it."""
    import torch
    from ninwavelets_tpu_torch.ops.baseline import baseline_tf
    ref = baseline_tf(ref_power, SFREQ, *BASELINE)
    window = ref_power[..., int(BASELINE[0] * SFREQ):int(BASELINE[1] * SFREQ)]
    std = window.std(-1, unbiased=False, keepdim=True)
    std = torch.where(std > 0, std, torch.ones_like(std))   # "unit" rule
    d = (got - ref).abs()
    bound = 2 * ref_power.amax(-1, keepdim=True) * (1 + ref.abs()) / std
    ratio = (d / bound).max().item()
    err = d.max().item()
    check(bool(got.isfinite().all()), f"{name}: non-finite values")
    print(f"check {name}: max|d| {err} rel {err / ref.abs().max().item()} "
          f"(not gated); max|d| / (2 P (1 + |z|) / std) {ratio} "
          f"(gate {POWER_RTOL})")
    check(ratio <= POWER_RTOL, f"{name}: {ratio} > {POWER_RTOL}")
    return err


def itc_err(name, got, ref, ref_power):
    """max|d| over non-NaN cells, failing outside the ITC gates."""
    import torch
    check(got.shape == ref.shape, f"{name}: shape {tuple(got.shape)} != "
          f"{tuple(ref.shape)}")
    check(torch.equal(got.isnan(), ref.isnan()), f"{name}: NaN masks differ")
    d = torch.where(ref.isnan(), torch.zeros_like(ref), (got - ref).abs())
    strong = ref_power >= STRONG_POWER * ref_power.amax(dim=(-2, -1),
                                                        keepdim=True)
    err = d.max().item()
    err_strong = d[strong].max().item()
    print(f"check {name}: max|d| {err} (gate {ITC_ATOL}), on cells with "
          f"power >= {STRONG_POWER} of the plane max {err_strong} "
          f"(gate {ITC_ATOL_STRONG}), NaN cells {int(ref.isnan().sum())}")
    check(err <= ITC_ATOL, f"{name}: ITC err {err} > {ITC_ATOL}")
    check(err_strong <= ITC_ATOL_STRONG,
          f"{name}: ITC err {err_strong} > {ITC_ATOL_STRONG} on strong cells")
    return err


def fft_flops(n):
    """5 N log2 N flops for a complex FFT of N points."""
    return 5 * n * math.log2(n)


def bound(flops, nbytes):
    """(ms, "operations" | "bytes"): the least time for the work on the
    card, the larger of flops / PEAK_FLOPS and bytes / PEAK_BYTES."""
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def print_ptxas(lib):
    """Registers, shared memory and spills per kernel from ``ptxas -v``."""
    name = "?"
    with open(lib[:-3] + ".log") as fh:
        for line in fh:
            m = re.search(r"entry function '(\S+)'", line)
            if m:
                k = re.search(r"(fused_(?:cwt|cwt_bwd|cwt_each|ssq)_kernel)I"
                              r"(.*?)EEv", m.group(1))
                name = (f"{k.group(1)}<"
                        + ",".join(re.findall(r"L[ib](\d+)E",
                                              k.group(2) + "E"))
                        + ">") if k else m.group(1)
            elif "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")


def event_ms(fn):
    """Mean device ms of ``fn`` over REPS back-to-back calls, by CUDA
    events, after one warm-up call."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(REPS):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / REPS


def median_ms(x, fns):
    """Median ms of each fn over REPS repetitions, fresh values in ``x``
    before every run, the fns taking turns (their order flips each rep)."""
    import torch
    for fn in fns:
        for _ in range(2):
            fn()
    times = [[] for _ in fns]
    for rep in range(REPS):
        order = range(len(fns)) if rep % 2 == 0 else reversed(range(len(fns)))
        for i in order:
            x.normal_()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns[i]()
            torch.cuda.synchronize()
            times[i].append((time.perf_counter() - t0) * 1e3)
    return [sorted(t)[REPS // 2] for t in times]


def host_ms(fn, fresh):
    """Median ms of fn(fresh()) over REPS runs after one warm-up; the fresh
    input is made before the clock starts."""
    import torch
    fn(fresh())
    times = []
    for _ in range(REPS):
        arg = fresh()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(arg)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[REPS // 2]


def morse_bank(freqs, n, interpolate):
    import ninwavelets_tpu_torch as nt
    return nt.Morse(SFREQ, interpolate=interpolate,
                    device="cuda").make_fft_wavelets(freqs, n / SFREQ)


def tone_epochs(e, c, n, phase_locked=True, seed=1):
    """60 Hz epochs plus 0.1 (phase-locked) or 0.2 (random phase) noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SFREQ
    phase = (np.zeros((e, c, 1)) if phase_locked
             else rng.uniform(0, 2 * np.pi, (e, c, 1)))
    noise = 0.1 if phase_locked else 0.2
    return (np.sin(2 * np.pi * 60.0 * t + phase)
            + noise * rng.standard_normal((e, c, n))).astype(np.float32)


def fused_grads(fn, x, bank, w, interpolate):
    """(d/dx, d/dbank) of sum(w * fn(x, bank)) through autograd."""
    import torch
    xs = x.detach().requires_grad_(True)
    bs = bank.detach().requires_grad_(True)
    loss = (w * fn(xs, bs, interpolate)).sum()
    return torch.autograd.grad(loss, (xs, bs))


def training_phase():
    """Slice 2: the training path at full width, its checks and times;
    returns the fused backward's kernel record."""
    import torch
    import ninwavelets_tpu_torch as nt
    from ninwavelets_tpu_torch import kernels
    from ninwavelets_tpu_torch.ops import cwt, fused

    freqs = np.arange(1.0, F + 1.0)
    gen = np.random.default_rng(2)
    x = torch.from_numpy(gen.standard_normal((E_GRAD, C, N),
                                             dtype=np.float32)).cuda()
    bank = morse_bank(freqs, N, True)
    target = cwt.mean_power_from_bank(x, bank, True)
    torch.cuda.synchronize()

    # -- the main path: learn_bank through both kernels ---------------------
    kernels.reset_launches()
    t0 = time.perf_counter()
    learned, losses = nt.learn_bank(x, 1.2 * bank, target, loss="mse",
                                    steps=STEPS, lr=1e-3, use_fused=True)
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    losses = losses.tolist()
    print(f"training main path {time.perf_counter() - t0} s (E={E_GRAD} "
          f"C={C} N={N} F={F}, {STEPS} steps, first calls included); "
          f"losses {losses}; launches {counts}")
    check(losses[-1] < losses[0], f"learn_bank loss did not fall: {losses}")
    check(bool(learned.isfinite().all()), "learned bank not finite")
    for key in ("power", "power_bwd"):
        check(counts[key] == STEPS, f"{key!r} launched {counts[key]} times "
              f"in {STEPS} training steps")

    # -- the fused backward against mean_power_bwd, same tensors ------------
    w = torch.from_numpy(gen.standard_normal((C, F, N),
                                             dtype=np.float32)).cuda()
    err_bwd = 0.0
    runs = [("full shape", x, bank, w, True),
            (f"interpolate=False E={E_SMALL}", x[:E_SMALL],
             morse_bank(freqs, N, False), w, False),
            (f"F={F_RAGGED}", x, bank[:F_RAGGED].contiguous(),
             w[:, :F_RAGGED].contiguous(), True)]
    for name, xs, bs, ws, interp in runs:
        ds, dbank = fused_grads(fused.fused_mean_power_from_bank, xs, bs, ws,
                                interp)
        ds_ref, dbank_ref = fused.mean_power_bwd(xs, bs, interp, ws)
        err = max(rel_err(f"fused backward ds, {name}", ds, ds_ref,
                          GRAD_RTOL),
                  rel_err(f"fused backward dbank, {name}", dbank, dbank_ref,
                          GRAD_RTOL))
        if name == "full shape":
            err_bwd = err
        del ds, dbank, ds_ref, dbank_ref
    for log2n in range(8, 15):
        n = 1 << log2n
        for interp in (True, False):
            xs = torch.from_numpy(gen.standard_normal(
                (3, 2, n), dtype=np.float32)).cuda()
            ws = torch.from_numpy(gen.standard_normal(
                (2, F_RAGGED, n), dtype=np.float32)).cuda()
            bs = morse_bank(freqs[:F_RAGGED], n, interp)
            got = fused._fused_power_bwd(xs, bs, ws, interp)
            ref = fused.mean_power_bwd(xs, bs, interp, ws)
            for part, g_, r_ in zip(("ds", "dbank"), got, ref):
                rel_err(f"fused backward {part}, N={n} interpolate={interp}"
                        f" E=3 C=2 F={F_RAGGED}", g_, r_, GRAD_RTOL)

    # -- known answers --------------------------------------------------------
    tone = torch.from_numpy(tone_epochs(8, 2, N)).cuda()
    bank_g = bank.detach().requires_grad_(True)
    (dbank,) = torch.autograd.grad(
        -fused.fused_mean_power_from_bank(tone, bank_g, True).mean(), bank_g)
    peak = int(dbank.sum(0).abs().argmax())
    want = 60.0 * N / SFREQ
    print(f"check 60 Hz bank gradient: peak at bin {peak} (want {want} +- 1)")
    check(abs(peak - want) <= 1.0, f"bank gradient peaks at bin {peak}")

    xi, bi = x[:4, :2], bank[:16]
    wi = torch.from_numpy(gen.standard_normal((2, 16, N),
                                              dtype=np.float32)).cuda()
    got = fused_grads(fused.fused_itc_from_bank, xi, bi, wi, True)
    ref = fused_grads(cwt.itc_from_bank, xi, bi, wi, True)
    for part, g_, r_ in zip(("ds", "dbank"), got, ref):
        d = (g_ - r_).abs()
        tol = 1e-4 * r_.abs() + 1e-5 * r_.abs().max()
        print(f"check ITC gradient {part}: max|d| {d.max().item()} "
              f"(gate rtol 1e-4, atol 1e-5 max)")
        check(bool((d <= tol).all()), f"ITC gradient {part} outside gate")

    _, l_fused = nt.learn_bank(x[:E_SMALL], 1.2 * bank, target, steps=5,
                               lr=1e-3, use_fused=True)
    _, l_plain = nt.learn_bank(x[:E_SMALL], 1.2 * bank, target, steps=5,
                               lr=1e-3, use_fused=False)
    d = ((l_fused - l_plain).abs() / l_plain.abs()).max().item()
    print(f"check learn_bank trajectory E={E_SMALL}: fused {l_fused.tolist()}"
          f" plain {l_plain.tolist()} max rel {d} (gate 1e-3)")
    check(d <= 1e-3, f"learn_bank trajectory rel {d} > 1e-3")

    fitted, _ = nt.fit_frequencies(
        torch.from_numpy(tone_epochs(6, 1, 1024, phase_locked=False)).cuda(),
        nt.Morse(SFREQ, device="cuda")._wdef(), [40.0, 75.0], SFREQ,
        steps=150, lr=0.02)
    fitted = fitted.tolist()
    print(f"check fit_frequencies: {fitted} Hz (want 60 +- 1)")
    check(all(abs(f - 60.0) <= 1.0 for f in fitted),
          f"fit_frequencies gave {fitted}")

    # -- timing -------------------------------------------------------------
    g = torch.empty_like(w)
    ms, plain_ms = median_ms(x, [
        lambda: fused._fused_power_bwd(x, bank, g.normal_(), True),
        lambda: fused.mean_power_bwd(x, bank, True, g.normal_())])
    print(f"time power backward (E={E_GRAD} C={C} N={N} F={F}, "
          f"interpolate=True): kernel path {ms} ms, plain mean_power_bwd "
          f"{plain_ms} ms")
    param = bank.detach().clone().requires_grad_(True)

    def step(power):
        p = power(x, param, True)
        return torch.autograd.grad(torch.mean(torch.square(p - target)),
                                   param)

    step_ms, step_plain_ms = median_ms(x, [
        lambda: step(fused.fused_mean_power_from_bank),
        lambda: step(cwt.mean_power_from_bank)])
    print(f"time training step (loss and bank gradient, E={E_GRAD} C={C} "
          f"N={N} F={F}): fused {step_ms} ms, plain {step_plain_ms} ms")

    # -- breakdown by CUDA events ---------------------------------------------
    spec = torch.fft.rfft(x)
    k_bins = N // 2
    dbank_part, t_part = kernels.fused_cwt_bwd(spec, bank, g, k_bins)
    parts = {
        "forward, fused_mean_power_from_bank": lambda:
            fused.fused_mean_power_from_bank(x, bank, True),
        "backward: rfft of the signals": lambda: torch.fft.rfft(x),
        "backward: kernel alone": lambda:
            kernels.fused_cwt_bwd(spec, bank, g, k_bins),
        "backward: dbank sum over channels, pad": lambda:
            torch.nn.functional.pad(dbank_part.sum(0) / N, (0, N - k_bins)),
        "backward: t sum over row groups": lambda: t_part.sum(0),
        "backward: ifft of t": lambda:
            torch.fft.ifft(t_part[0], n=N).real,
        "backward, whole fused path": lambda:
            fused._fused_power_bwd(x, bank, g, True),
    }
    for name, fn in parts.items():
        print(f"breakdown {name}: {event_ms(fn)} ms (CUDA events, mean of "
              f"{REPS})")
    print(f"t partials: {tuple(t_part.shape)} complex64, "
          f"{t_part.numel() * 8 / 1e6} MB")
    del spec, dbank_part, t_part

    fft = fft_flops(N)
    bound_ms, bound_by = bound(
        E_GRAD * C * (fft / 2 + 2 * F * fft + fft),
        4 * (2 * E_GRAD * C * N + 2 * F * N + C * F * N))
    return {"name": "fused_cwt_bwd[power]", "route": "cuda",
            "source": BWD_SOURCE, "replaces": BWD_REPLACES,
            "launches": counts["power_bwd"], "max_abs_err": err_bwd,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


class ArrayRaw:
    """The duck-typed ``mne.io.Raw`` surface ``RawWavelet`` needs."""

    def __init__(self, data):
        self._data = data
        self.info = {"sfreq": SFREQ}
        self.ch_names = [f"EEG{i:03d}" for i in range(data.shape[0])]

    def get_data(self):
        return self._data


def recording(seed):
    """64 x 600,000 seeded noise with a 60 Hz tone on channel 0."""
    data = np.random.default_rng(seed).standard_normal((REC_C, REC_N),
                                                       dtype=np.float32)
    data[0] += np.sin(2 * np.pi * 60.0 * np.arange(REC_N) / SFREQ).astype(
        np.float32)
    return data


def long_recording_phase():
    """Slice 3: the long-recording path at full width, its checks and
    times; returns K4's kernel record."""
    import torch
    import ninwavelets_tpu_torch as nt
    from ninwavelets_tpu_torch import io, kernels
    from ninwavelets_tpu_torch.ops import cwt, fused
    from ninwavelets_tpu_torch.ops.scattering import scattering
    from ninwavelets_tpu_torch.parallel import OnlineCWT, StreamingCWT

    freqs = np.linspace(2.0, 100.0, REC_F)
    data = recording(3)
    print(f"native gather: {io.native_available()} (False: the numpy "
          "gathers ran)")

    # -- the main path: RawWavelet.power through K4 --------------------------
    morse = nt.Morse(SFREQ, interpolate=True, device="cuda")
    rw = nt.RawWavelet(ArrayRaw(data), morse, window=REC_WINDOW,
                       batch=REC_BATCH)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    plane = rw.power(freqs)
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    stream = rw._stream_for(freqs)
    n_batches = -(-REC_N // (REC_WINDOW * REC_BATCH))
    print(f"long-recording main path {time.perf_counter() - t0} s (C={REC_C}"
          f" N={REC_N} F={REC_F}, window {stream.window}, halo "
          f"{stream.halo}, {n_batches} window batches of {REC_BATCH}; "
          f"first call: bank, halo and host snapshot included); launches "
          f"{counts}")
    check((stream.halo, stream.window + 2 * stream.halo)
          == (REC_HALO, REC_EXT), f"geometry {stream.halo}, {stream.window}")
    check(counts["power_each"] == n_batches, f"'power_each' launched "
          f"{counts['power_each']} times for {n_batches} window batches")
    check(tuple(plane.shape) == (REC_C, REC_F, REC_N),
          f"plane shape {tuple(plane.shape)}")
    check(bool(plane.isfinite().all()), "plane not finite")

    # -- known answers on channel 0 -------------------------------------------
    x0 = torch.from_numpy(data[0]).cuda()
    whole = cwt.power_from_bank(x0, nt.Morse(
        SFREQ, interpolate=True, device="cuda").make_fft_wavelets(
            freqs, REC_N / SFREQ), True)
    h = stream.halo
    err = (plane[0, :, h:-h] - whole[:, h:-h]).abs().max().item()
    rel = err / whole.abs().max().item()
    print(f"check channel 0 interior vs one {REC_N}-point transform: max|d|"
          f" {err} rel {rel} (gate 1e-3)")
    check(rel <= 1e-3, f"streamed interior rel {rel} > 1e-3")
    peak = float(freqs[int(plane[0].mean(-1).argmax())])
    print(f"check channel 0 strongest row: {peak} Hz (want the row nearest "
          "60 Hz)")
    check(abs(peak - 60.0) <= 0.5 * (freqs[1] - freqs[0]),
          f"channel 0 peaks at {peak} Hz")
    plane4 = plane[:4].clone()
    del plane, whole, x0
    torch.cuda.empty_cache()

    # -- K4 against its plain version, same tensors ---------------------------
    bank = stream._bank
    groups = list(stream._ext_batches(data))
    err_each = 0.0
    for name, ext in (("first", groups[0][1]), ("ragged last", groups[-1][1])):
        xs = torch.from_numpy(ext).cuda()
        err_each = max(err_each, rel_err(
            f"K4 {name} window batch {tuple(xs.shape)}",
            fused.fused_power_from_bank(xs, bank, True),
            cwt.power_from_bank(xs, bank, True)))
        del xs
        torch.cuda.empty_cache()
    plain_stream = StreamingCWT(morse._wdef(), freqs, SFREQ,
                                window=REC_WINDOW, interpolate=True,
                                use_fused=False, batch=REC_BATCH,
                                device="cuda")
    rel_err("RawWavelet plane, 4 channels, vs StreamingCWT(use_fused=False)",
            plane4, plain_stream.power_device(data[:4]))
    del plane4
    gen = np.random.default_rng(4)
    for log2n in range(8, 15):
        n = 1 << log2n
        for interp in (True, False):
            xs = torch.from_numpy(gen.standard_normal(
                (3, 2, n), dtype=np.float32)).cuda()
            bs = morse_bank(freqs[:F_RAGGED], n, interp)
            rel_err(f"K4 N={n} interpolate={interp} (3, 2) x {F_RAGGED}",
                    fused.fused_power_from_bank(xs, bs, interp),
                    cwt.power_from_bank(xs, bs, interp))

    # -- OnlineCWT, bit-identical to StreamingCWT(batch=1) --------------------
    kw = dict(window=REC_WINDOW, interpolate=True, device="cuda")
    want = StreamingCWT(morse._wdef(), freqs, SFREQ, batch=1,
                        **kw).power(data[0])
    oc = OnlineCWT(morse._wdef(), freqs, SFREQ, **kw)
    got = np.zeros_like(want)
    pos, pushes = 0, 0
    chunk_rng = np.random.default_rng(5)
    blocks = []
    while pos < REC_N:
        size = int(chunk_rng.integers(1, 40_000))
        blocks += oc.push(data[0, pos:pos + size])
        pos += size
        pushes += 1
    blocks += oc.flush()
    for start, blk in blocks:
        got[:, start:start + blk.shape[-1]] = blk
    same = np.array_equal(got, want)
    print(f"check OnlineCWT ({pushes} pushes, {len(blocks)} blocks) "
          f"bit-identical to StreamingCWT(batch=1).power: {same}, max|d| "
          f"{np.abs(got - want).max()}")
    check(same, "OnlineCWT differs from StreamingCWT(batch=1)")
    del got, want

    # -- scattering: both modulus layers through K4 ---------------------------
    sc = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (16, 4096), dtype=np.float32)).cuda()
    f1, f2 = np.geomspace(8.0, 400.0, 24), np.geomspace(1.0, 64.0, 12)
    kernels.reset_launches()
    s1, s2 = morse.scattering(sc, f1, f2, stride=32)
    torch.cuda.synchronize()
    print(f"scattering launches {dict(kernels.launches)}")
    check(kernels.launches["power_each"] == 2, "scattering did not run both "
          "layers through K4")
    b1 = nt.Morse(SFREQ, interpolate=True, device="cuda").make_fft_wavelets(
        f1, 4096 / SFREQ)
    b2 = nt.Morse(SFREQ, device="cuda").make_fft_wavelets(f2, 4096 / SFREQ)
    p1, p2 = scattering(sc, b1, b2, SFREQ, stride=32, use_fused=False)
    rel_err("scattering S1 vs use_fused=False", s1, p1)
    rel_err("scattering S2 vs use_fused=False", s2, p2)

    # -- times ----------------------------------------------------------------
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    x = torch.from_numpy(groups[0][1]).cuda()
    ms, plain_ms = median_ms(x, [
        lambda: fused.fused_power_from_bank(x, bank, True),
        lambda: cwt.power_from_bank(x, bank, True)])
    print(f"time one window batch {tuple(x.shape)} x {REC_F} rows: K4 path "
          f"(rFFT + kernel) {ms} ms, plain torch.fft {plain_ms} ms")
    torch.cuda.empty_cache()

    def one_channel():
        return gen.standard_normal(REC_N, dtype=np.float32)

    for name, use in (("K4", True), ("plain", False)):
        s = StreamingCWT(morse._wdef(), freqs, SFREQ, window=REC_WINDOW,
                         interpolate=True, use_fused=use, batch=REC_BATCH,
                         device="cuda")
        t = host_ms(s.power_device, one_channel)
        print(f"time StreamingCWT.power_device, 1 channel x {REC_N} "
              f"samples, {name}: {t} ms, {REC_N / SFREQ / (t / 1e3)} "
              "signal-s/s")
    rw_ms = host_ms(lambda d: nt.RawWavelet(
        ArrayRaw(d), morse, window=REC_WINDOW,
        batch=REC_BATCH).power(freqs), lambda: recording(
            int(gen.integers(1 << 30))))
    print(f"time RawWavelet.power, {REC_C} channels x {REC_N} samples "
          f"(bank, halo and host snapshot included): {rw_ms} ms, "
          f"{REC_C * REC_N / SFREQ / (rw_ms / 1e3)} channel-signal-s/s")
    torch.cuda.empty_cache()

    # -- breakdown of one 64-channel batch by CUDA events ---------------------
    host = groups[0][1]
    spec = torch.fft.rfft(x.reshape(-1, 1, REC_EXT)).contiguous()
    each = kernels.fused_cwt("power_each", spec, bank, REC_EXT // 2,
                             "fast3")[0].reshape(REC_BATCH, REC_C, REC_F,
                                                 REC_EXT)
    span = REC_BATCH * REC_WINDOW
    buf = torch.empty((REC_C, REC_F, span), device="cuda")
    parts = {
        "host-to-device copy of the batch (pageable)": lambda:
            torch.from_numpy(host).cuda(),
        "rFFT of the batch": lambda: torch.fft.rfft(
            x.reshape(-1, 1, REC_EXT)),
        "K4 alone": lambda: kernels.fused_cwt(
            "power_each", spec, bank, REC_EXT // 2, "fast3"),
        "crop + paste into the plane": lambda: buf.unflatten(
            -1, (REC_BATCH, REC_WINDOW)).copy_(
                each[..., h:REC_EXT - h].movedim(0, -2)),
    }
    for name, fn in parts.items():
        print(f"breakdown {name}: {event_ms(fn)} ms (CUDA events, mean of "
              f"{REPS})")
    del spec, each, buf, x
    torch.cuda.empty_cache()

    b = REC_BATCH * REC_C
    bound_ms, bound_by = bound(
        b * (fft_flops(REC_EXT) / 2 + REC_F * fft_flops(REC_EXT)),
        4 * (b * REC_EXT + REC_F * REC_EXT + b * REC_F * REC_EXT))
    return {"name": "fused_cwt[power_each]", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": EACH_REPLACES,
            "launches": counts["power_each"], "max_abs_err": err_each,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def ssq_err(name, got, ref):
    """The synchrosqueezing gates: each time column's energy rel <=
    SSQ_COLSUM_RTOL, SNR >= SSQ_SNR_DB, no NaN; prints the SNR and the
    cells that differ by more than 1e-3 of the max.  Returns max|d|."""
    check(got.shape == ref.shape, f"{name}: shape {tuple(got.shape)} != "
          f"{tuple(ref.shape)}")
    check(not bool(got.isnan().any()), f"{name}: NaN")
    g, r = got.double(), ref.double()
    colsum = ((g.sum(-2) - r.sum(-2)).abs().max()
              / r.sum(-2).abs().max()).item()
    d = (g - r).abs()
    err2 = (d * d).sum().item()
    snr = 10 * math.log10((r * r).sum().item() / err2) if err2 else math.inf
    moved = int((d > 1e-3 * r.abs().max()).sum())
    print(f"check {name}: column energy rel {colsum} (gate "
          f"{SSQ_COLSUM_RTOL}), SNR {snr} dB (gate {SSQ_SNR_DB}), cells "
          f"differing by > 1e-3 of the max {moved} of {r.numel()}, max|d| "
          f"{d.max().item()}")
    check(colsum <= SSQ_COLSUM_RTOL, f"{name}: column energy rel {colsum}")
    check(snr >= SSQ_SNR_DB, f"{name}: SNR {snr} dB < {SSQ_SNR_DB}")
    return d.max().item()


def plain_peaks(x, bank, chunk=20):
    """(C, E) peak power of each (epoch, channel), the plain way, a few
    epochs at a time."""
    import torch
    from ninwavelets_tpu_torch.ops import cwt
    return torch.cat([cwt.power_from_bank(x[i:i + chunk], bank, True)
                      .amax(dim=(-2, -1)) for i in range(0, len(x), chunk)]).T


def ssq_phase(data):
    """Slice 4: the synchrosqueezing path at full width, its checks and
    times; returns the K5a and K5b kernel records."""
    import torch
    import ninwavelets_tpu_torch as nt
    from ninwavelets_tpu_torch import kernels
    from ninwavelets_tpu_torch.ops import fused, sst
    from ninwavelets_tpu_torch.parallel import StreamingCWT

    freqs = np.arange(1.0, F + 1.0)
    freqs_log = 4.0 * 2.0 ** (np.arange(48) / 8.0)
    hint = sst.uniform_grid_hint(np.float32(freqs))
    hint_log = sst.uniform_grid_hint(np.float32(freqs_log))
    check((hint[0], hint_log[0]) == ("lin", "log"), f"hints {hint} {hint_log}")

    # -- the main path: EpochsWavelet.ssq_power_all through K5a and K5b -------
    morse = nt.Morse(SFREQ, interpolate=True, device="cuda")
    ew = nt.EpochsWavelet(nt.ArrayEpochs(data, SFREQ), morse)
    ew_log = nt.EpochsWavelet(nt.ArrayEpochs(data[:E_RAGGED], SFREQ),
                              nt.Morse(SFREQ, interpolate=True,
                                       device="cuda"))
    runs = {}
    for name, adapter, grid in (("lin", ew, freqs), ("log", ew_log,
                                                     freqs_log)):
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        plane = adapter.ssq_power_all(grid)
        torch.cuda.synchronize()
        counts = dict(kernels.launches)
        print(f"ssq main path, {name} grid: {time.perf_counter() - t0} s "
              f"(E={len(adapter._all_data())} C={C} N={N} F={len(grid)}; "
              f"first call: bank build and host-to-device copy included); "
              f"launches {counts}")
        for key in ("amax", "ssq"):
            check(counts[key] == 1, f"{key!r} launched {counts[key]} times "
                  f"in one ssq_power_all call ({name} grid)")
        runs[name] = plane
        if name == "lin":
            main_counts = counts

    # -- K5a and K5b against their plain versions, same tensors ---------------
    x, bank = ew._all_data(), morse.fft_wavelets
    peaks = fused.ssq_peaks(x, bank)
    err_amax = rel_err("K5a peaks (C, E), full width", peaks,
                       plain_peaks(x, bank))
    err_ssq = ssq_err("ssq_power_all, lin grid, vs plain",
                      runs["lin"], sst.ssq_mean_power_from_bank(
                          x, bank, None, SFREQ, True, 1e-6, hint))
    xl, bank_l = ew_log._all_data(), ew_log.wavelet.fft_wavelets
    rel_err(f"K5a peaks (C, E), E={E_RAGGED} log rows", fused.ssq_peaks(
        xl, bank_l), plain_peaks(xl, bank_l))
    ssq_err(f"ssq_power_all, log grid, E={E_RAGGED}, vs plain",
            runs["log"], sst.ssq_mean_power_from_bank(
                xl, bank_l, None, SFREQ, True, 1e-6, hint_log))
    del runs, xl
    gen = np.random.default_rng(7)
    for log2n in range(8, 15):
        n = 1 << log2n
        xs = torch.from_numpy(tone_epochs(3, 2, n, seed=log2n)).cuda()
        xs[:, 1] = 0.0
        for name, grid in (("lin", freqs[:50]), ("log", freqs_log)):
            h = sst.uniform_grid_hint(np.float32(grid))
            bs = morse_bank(grid, n, True)
            rel_err(f"K5a N={n} {name} (3, 2) x {len(grid)}",
                    fused.ssq_peaks(xs, bs), plain_peaks(xs, bs))
            got = fused.fused_ssq_mean_power(xs, bs, uniform_grid=h,
                                             sfreq=SFREQ)
            ssq_err(f"K5b N={n} {name} (3, 2) x {len(grid)}", got,
                    sst.ssq_mean_power_from_bank(xs, bs, None, SFREQ, True,
                                                 1e-6, h))
            check(bool((got[1] == 0).all()), f"K5b N={n} {name}: the "
                  "all-zero channel's plane is not zero")

    # -- known answer: a 60 Hz tone lands in rows 59-61 Hz --------------------
    tone = nt.EpochsWavelet(nt.ArrayEpochs(tone_epochs(8, 2, N), SFREQ),
                            nt.Morse(SFREQ, interpolate=True, device="cuda"))
    p_tone = tone.ssq_power_all(freqs)[..., N // 4:3 * N // 4]
    share = (p_tone[:, 58:61].sum() / p_tone.sum()).item()
    print(f"check 60 Hz tone: {share} of the interior energy in rows 59-61 "
          "Hz (gate 0.95)")
    check(share >= 0.95, f"60 Hz tone share {share} < 0.95")

    # -- long recordings: RawWavelet.ssq_power through both kernels -----------
    rec_freqs = np.arange(2.0, 2.0 + REC_F)
    rec = recording(3)
    rw = nt.RawWavelet(ArrayRaw(rec), morse, window=REC_WINDOW,
                       batch=REC_BATCH)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    rec_plane = rw.ssq_power(rec_freqs)
    torch.cuda.synchronize()
    rec_counts = dict(kernels.launches)
    stream = rw._stream_for(rec_freqs)
    n_batches = -(-REC_N // (REC_WINDOW * REC_BATCH))
    print(f"ssq long-recording path {time.perf_counter() - t0} s (C={REC_C} "
          f"N={REC_N} F={REC_F}, window {stream.window}, halo {stream.halo};"
          f" first call: bank, halo and host snapshot included); launches "
          f"{rec_counts}")
    check((stream.halo, stream.window + 2 * stream.halo)
          == (REC_HALO, REC_EXT), f"geometry {stream.halo}, {stream.window}")
    for key in ("amax", "ssq"):
        check(rec_counts[key] == n_batches, f"{key!r} launched "
              f"{rec_counts[key]} times for {n_batches} window batches")
    check(tuple(rec_plane.shape) == (REC_C, REC_F, REC_N),
          f"plane shape {tuple(rec_plane.shape)}")
    check(bool(rec_plane.isfinite().all()), "ssq recording plane not finite")
    plane4 = rec_plane[:4].clone()
    del rec_plane
    torch.cuda.empty_cache()
    plain_stream = StreamingCWT(morse._wdef(), rec_freqs, SFREQ,
                                window=REC_WINDOW, interpolate=True,
                                use_fused=False, batch=REC_BATCH,
                                device="cuda")
    ssq_err("RawWavelet.ssq_power, 4 channels, vs StreamingCWT("
            "use_fused=False)", plane4, plain_stream.ssq_power_device(rec[:4]))
    del plane4
    torch.cuda.empty_cache()

    # -- times ----------------------------------------------------------------
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    x = x.clone()
    path_ms, plain_ms = median_ms(x, [
        lambda: fused.fused_ssq_mean_power(x, bank, uniform_grid=hint,
                                           sfreq=SFREQ),
        lambda: sst.ssq_mean_power_from_bank(x, bank, None, SFREQ, True,
                                             1e-6, hint)])
    print(f"time ssq_mean_power (E={E} C={C} N={N} F={F}, lin): kernel path "
          f"(rFFT + K5a + K5b) {path_ms} ms, plain torch.fft {plain_ms} ms")
    amax_ms, amax_plain_ms = median_ms(x, [lambda: fused.ssq_peaks(x, bank),
                                           lambda: plain_peaks(x, bank)])
    print(f"time peaks (C, E): K5a path (rFFT + kernel + max over rows) "
          f"{amax_ms} ms, plain {amax_plain_ms} ms")
    spec = torch.fft.rfft(x).contiguous()
    floors = (1e-6 * peaks).contiguous()
    ssq_ms = median_ms(x, [lambda: kernels.fused_ssq(
        torch.fft.rfft(x).contiguous(), bank, floors, hint, SFREQ)])[0]
    print(f"time K5b path (rFFT + zero-fill + kernel) {ssq_ms} ms")
    for name, fn in (("K5a alone", lambda: kernels.fused_cwt(
                          "amax", spec, bank, N // 2, "fast3")),
                     ("K5b alone (zero-fill included)", lambda:
                      kernels.fused_ssq(spec, bank, floors, hint, SFREQ)),
                     ("K1 'power' alone, for scale", lambda:
                      kernels.fused_cwt("power", spec, bank, N // 2,
                                        "fast3"))):
        print(f"breakdown {name}: {event_ms(fn)} ms (CUDA events, mean of "
              f"{REPS})")
    del spec, x
    torch.cuda.empty_cache()
    rw_ms = host_ms(lambda d: nt.RawWavelet(
        ArrayRaw(d), morse, window=REC_WINDOW,
        batch=REC_BATCH).ssq_power(rec_freqs), lambda: recording(
            int(gen.integers(1 << 30))))
    print(f"time RawWavelet.ssq_power, {REC_C} channels x {REC_N} samples "
          f"(bank, halo and host snapshot included): {rw_ms} ms, "
          f"{REC_C * REC_N / SFREQ / (rw_ms / 1e3)} channel-signal-s/s")
    torch.cuda.empty_cache()

    # -- breakdown of one 64-channel recording batch by CUDA events ------------
    xb = torch.from_numpy(next(iter(stream._ext_batches(rec)))[1]).cuda()
    spec_b = torch.fft.rfft(xb.reshape(1, -1, REC_EXT)).contiguous()
    floors_b = (1e-6 * kernels.fused_cwt("amax", spec_b, stream._bank,
                                         REC_EXT // 2, "fast3")[0].amax(1)
                ).contiguous()
    rec_hint = sst.uniform_grid_hint(np.float32(rec_freqs))
    parts = {
        "rFFT of the batch": lambda: torch.fft.rfft(
            xb.reshape(1, -1, REC_EXT)),
        "K5a alone": lambda: kernels.fused_cwt(
            "amax", spec_b, stream._bank, REC_EXT // 2, "fast3"),
        "K5b alone (zero-fill included)": lambda: kernels.fused_ssq(
            spec_b, stream._bank, floors_b, rec_hint, SFREQ),
        "zero-fill of the (512, 100, 16384) plane": lambda: torch.zeros(
            (REC_BATCH * REC_C, REC_F, REC_EXT), device="cuda"),
    }
    for name, fn in parts.items():
        print(f"breakdown ssq batch {tuple(xb.shape)}, {name}: {event_ms(fn)}"
              f" ms (CUDA events, mean of {REPS})")
    del xb, spec_b, floors_b
    torch.cuda.empty_cache()

    fft = fft_flops(N)
    amax_bound = bound(E * C * (fft / 2 + F * fft),
                       4 * (E * C * N + F * N + C * F * E))
    ssq_bound = bound(E * C * (fft / 2 + 2 * F * fft),
                      4 * (E * C * N + F * N + C * E + C * F * N))
    return [{"name": "fused_cwt[amax]", "route": "cuda",
             "source": KERNEL_SOURCE, "replaces": AMAX_REPLACES,
             "launches": main_counts["amax"], "max_abs_err": err_amax,
             "ms": amax_ms, "plain_ms": amax_plain_ms,
             "bound_ms": amax_bound[0], "bound_by": amax_bound[1],
             "library_ms": None},
            {"name": "fused_ssq", "route": "cuda", "source": SSQ_SOURCE,
             "replaces": SSQ_REPLACES, "launches": main_counts["ssq"],
             "max_abs_err": err_ssq, "ms": ssq_ms, "plain_ms": plain_ms,
             "bound_ms": ssq_bound[0], "bound_by": ssq_bound[1],
             "library_ms": None}]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a CUDA "
              "card and runs nothing on the CPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import ninwavelets_tpu_torch as nt
    from ninwavelets_tpu_torch import kernels
    from ninwavelets_tpu_torch.ops import cwt, fused

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    lib = kernels.build()
    print(f"kernel build {time.perf_counter() - t0} s: {lib}")
    print_ptxas(lib)

    data = np.random.default_rng(0).standard_normal((E, C, N),
                                                    dtype=np.float32)
    freqs = np.arange(1.0, F + 1.0)

    # -- the main path, through the public entry points ---------------------
    kernels.reset_launches()
    t0 = time.perf_counter()
    morse = nt.Morse(SFREQ, interpolate=True, device="cuda")
    ew = nt.EpochsWavelet(nt.ArrayEpochs(data, SFREQ), morse)
    power_bl = ew.power_all(freqs, baseline=BASELINE)
    itc = ew.itc_all(freqs)
    pi_power, pi_itc = ew.power_itc_all(freqs)
    morse_full = nt.Morse(SFREQ, device="cuda")
    ew_full = nt.EpochsWavelet(nt.ArrayEpochs(data, SFREQ), morse_full)
    power_full = ew_full.power_all(freqs)
    ew_ragged = nt.EpochsWavelet(nt.ArrayEpochs(data[:E_RAGGED], SFREQ),
                                 nt.Morse(SFREQ, interpolate=True,
                                          device="cuda"))
    itc_ragged = ew_ragged.itc_all(freqs)
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    print(f"main path {time.perf_counter() - t0} s (first calls: bank "
          f"builds and host-to-device copies included); launches {counts}")
    for epilogue in ("power", "itc", "power_itc"):
        check(counts[epilogue] > 0, f"epilogue {epilogue!r} never launched "
              "on the main path")

    # -- kernel vs plain path, same tensors ---------------------------------
    x, bank = ew._all_data(), morse.fft_wavelets
    ref_power = cwt.mean_power_from_bank(x, bank, True)
    ref_itc = cwt.itc_from_bank(x, bank, True)
    err = {"power": rel_err(
        "power kernel alone", fused.fused_mean_power_from_bank(x, bank, True),
        ref_power)}
    baselined_err("power_all baselined", power_bl, ref_power)
    err["itc"] = itc_err("itc_all", itc, ref_itc, ref_power)
    err["power_itc"] = max(
        rel_err("power_itc_all power", pi_power, ref_power),
        itc_err("power_itc_all itc", pi_itc, ref_itc, ref_power))
    del ref_itc
    xf, bank_f = ew_full._all_data(), morse_full.fft_wavelets
    err["power"] = max(err["power"], rel_err(
        "power_all interpolate=False", power_full,
        cwt.mean_power_from_bank(xf, bank_f, False)))
    xr, bank_r = ew_ragged._all_data(), ew_ragged.wavelet.fft_wavelets
    err["itc"] = max(err["itc"], itc_err(
        f"itc_all E={E_RAGGED}", itc_ragged, cwt.itc_from_bank(xr, bank_r, True),
        cwt.mean_power_from_bank(xr, bank_r, True)))
    del xf, xr

    # -- a known answer through the kernel ----------------------------------
    t = np.arange(N) / SFREQ
    rng = np.random.default_rng(1)
    tone = (np.sin(2 * np.pi * 60.0 * t)[None, None, :]
            + 0.1 * rng.standard_normal((8, 2, N))).astype(np.float32)
    ew_tone = nt.EpochsWavelet(nt.ArrayEpochs(tone, SFREQ),
                               nt.Morse(SFREQ, interpolate=True,
                                        device="cuda"))
    p_tone, itc_tone = ew_tone.power_itc_all(freqs)
    peak = int(p_tone.mean(-1).argmax(-1)[0]) + 1
    itc60 = float(itc_tone[:, 59, N // 4:3 * N // 4].min())
    print(f"check 60 Hz tone: power peak at {peak} Hz, min ITC at 60 Hz {itc60}")
    check(peak == 60, f"60 Hz tone peaks at {peak} Hz")
    check(itc60 > 0.99, f"60 Hz tone ITC {itc60} <= 0.99")

    # -- timing: kernel vs plain at the headline shape ----------------------
    x = x.clone()
    pairs = {
        "power": (lambda: fused.fused_mean_power_from_bank(x, bank, True),
                  lambda: cwt.mean_power_from_bank(x, bank, True)),
        "itc": (lambda: fused.fused_itc_from_bank(x, bank, True),
                lambda: cwt.itc_from_bank(x, bank, True)),
        "power_itc": (lambda: fused.fused_power_itc_from_bank(x, bank, True),
                      lambda: (cwt.mean_power_from_bank(x, bank, True),
                               cwt.itc_from_bank(x, bank, True))),
    }
    records = []
    for epilogue, (kern, plain) in pairs.items():
        ms, plain_ms = median_ms(x, [kern, plain])
        print(f"time {epilogue} (E={E} C={C} N={N} F={F}, interpolate=True): "
              f"kernel {ms} ms, plain torch.fft {plain_ms} ms")
        n_out = 2 if epilogue == "power_itc" else 1
        bound_ms, bound_by = bound(
            E * C * (fft_flops(N) / 2 + F * fft_flops(N)),
            4 * (E * C * N + F * N + n_out * C * F * N))
        records.append({"name": f"fused_cwt[{epilogue}]", "route": "cuda",
                        "source": KERNEL_SOURCE, "replaces": REPLACES,
                        "launches": counts[epilogue],
                        "max_abs_err": err[epilogue], "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": None})
    del x, pairs, power_bl, itc, pi_power, pi_itc, ref_power
    torch.cuda.empty_cache()

    # -- slice 2: training ----------------------------------------------------
    records.append(training_phase())
    torch.cuda.empty_cache()

    # -- slice 3: long recordings ---------------------------------------------
    records.append(long_recording_phase())
    torch.cuda.empty_cache()

    # -- slice 4: synchrosqueezing --------------------------------------------
    records += ssq_phase(data)
    if FAILURES:
        raise SmokeFailure(f"{len(FAILURES)} checks failed: "
                           + "; ".join(FAILURES))
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        sys.exit(1)
