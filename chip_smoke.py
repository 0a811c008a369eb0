#!/usr/bin/env python3
"""Drive the PyTorch port (``ninwavelets_tpu_torch``) once on one CUDA card.

    python3 chip_smoke.py          # from the root of the repository

What it does, failing (non-zero exit, no result line) if any check fails:

1. Requires CUDA and prints the card's name and power limit (nvidia-smi).
2. Builds the kernels (``csrc/fused_cwt.cu``, the forward,
   ``csrc/fused_cwt_bwd.cu``, the power backward, both also for complex
   banks, ``csrc/fused_ssq.cu``,
   synchrosqueezing, and ``csrc/fused_pair.cu``, the cross-pair sums) for
   sm_90a, one nvcc process a source, all started together, into one
   library, and prints each kernel's registers and spills (``ptxas -v``):
   every kernel runs on the register-resident FFT core of
   ``csrc/fft_regs.cuh``, one instantiation per N: the epoch reductions
   (``fused_cwt_kernel<EPI, LOG2N, CX>``), the backward
   (``fused_cwt_bwd_kernel<LOG2N, CX>``), the per-signal power
   (``fused_each_kernel<LOG2N>``), the noise gate's peaks
   (``fused_amax_kernel<LOG2N>``), synchrosqueezing
   (``fused_ssq_kernel<LOG2N, LOG>``) and the cross-pair sums
   (``fused_pair_kernel<EPI, LOG2N>``); none of them may spill at
   N <= 8192, nor "power_each" and "amax" at N = 16384 (synchrosqueezing's
   spill there is printed).  At every N the core's plan, exchange
   indices and the backward's row groups as the library computes them
   (``csrc/core_plan.cu``, ``ninw_fused_cwt_bwd_rows``) must equal the
   host's model that the CPU tests emulate (``kernels.core_plan``,
   ``core_r``, ``core_twiddles``, ``core_exchange_positions``,
   ``core_pad``, ``bwd_rows``).

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
   coefficient is round-off); NaN masks equal.  The full-width ITC planes
   are also held, as slice 6's complex banks are, against a float64
   witness of the plain path's math (``itc_witness``): the kernel within
   the coefficient tolerance carried through the unit phases of the plain
   path, and each float32 path within it of the float64 ITC, printing
   which is nearer.
5. Checks a small known answer through the kernel: phase-locked 60 Hz
   epochs peak at the 60 Hz row with ITC ~ 1 there.  Then holds every
   reduction against the plain path at every N from 256 to 16384 (the
   core's plan changes with N) on both ``interpolate`` settings, at E = 1
   and E = 19 (3 channels x 13 rows), at the gates of 4.
6. Times each epilogue and its plain version at the headline shape: median
   of 5 repetitions after warm-up, fresh input values each repetition,
   ``torch.cuda.synchronize()`` before each stop of the clock; prints
   each redesigned row's time on a text line beside the radix-2 core's
   recorded time (``RADIX2_MS``, from PERF.md, not measured here).

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
   breaks both down by CUDA events; prints the backward's time beside the
   radix-2 kernel's recorded one (``RADIX2_MS``).

Slice 3, long recordings (the JAX package's streaming bench geometry,
``bench.py:58-77``: 10 min at 1 kHz, 100 Morse rows over 2-100 Hz,
``interpolate=True``, window 11524 -> halo 2430 -> extended window 16384,
window batch 8; here with 64 channels riding the batch):

11. Drives ``RawWavelet(raw, Morse(interpolate=True), window=11524,
   batch=8).power`` on a duck-typed 64 x 600,000 raw (seeded noise, a
   60 Hz tone on channel 0), the counters zeroed just before: "power_each"
   (K4) must launch once per window batch (7), each launch writing its
   windows' interiors straight into the plane, and the (64, 100, 600000)
   plane must be finite.
12. Holds K4 against its plain version (``ops.cwt.power_from_bank``) on
   the same tensors, max|d| / max|ref| <= 1e-5: the first and the ragged
   last window batch at all 64 channels, as whole windows and as the
   interiors written into a NaN-filled plane (every cell must be written);
   the whole plane of 4 channels against
   ``StreamingCWT(use_fused=False)``; a small batch at every N from 256
   to 16384 at both ``interpolate`` settings.  Known answers:
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
   64-channel window batch into the plane through K4 (interiors in
   place), through the plain path (crop + paste) and through K4 writing
   whole windows, beside the radix-2 kernel's recorded time; the
   single-channel ``StreamingCWT.power_device`` at the bench geometry,
   fused and plain, in signal-seconds/s; the 64-channel ``RawWavelet.power``;
   and a CUDA-event breakdown of one 64-channel batch.

Slice 4, synchrosqueezing (the serving data; the JAX package's
``BENCH_MODE=ssq``, ``bench.py:107-160``, at 200 epochs):

16. Drives ``EpochsWavelet.ssq_power_all`` at 200 x 64 x 2048 with
   ``Morse(interpolate=True)`` on ``arange(1, 101)`` Hz (a "lin" row map),
   then on 48 log-spaced rows (``4 * 2^(k/8)``) at a ragged 19 epochs, the
   counters zeroed just before each: "amax" (K5a,
   ``fused_amax_kernel``) and "ssq" (K5b, ``fused_ssq_kernel``), both on
   the register-resident core and forming W and its power through the
   same code (``csrc/ssq_row.cuh``), must each launch exactly once per
   call.
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
   CUDA events (K5b also with every cell gated to its own row, floors
   = inf, so that its adds coalesce: the scattered adds' share), and the
   64-channel ``RawWavelet.ssq_power``; prints K5a's and K5b's times
   beside the radix-2 kernels' recorded ones (``RADIX2_MS``); then breaks
   one 64-channel recording batch down by CUDA events.

Slice 5, pair connectivity (the serving data as 64 channel pairs: channel
b of each pair is 0.6 x its channel a lagged 5 samples plus 0.8 x the
neighbouring channel; the layout in which the JAX package's ``*_auto``
functions reach its kernel, ``benchmarks/extensions_bench.py:105-143``):

20. Drives ``epoch_coherence_auto``, ``imcoh_auto``, ``plv_auto``,
   ``ppc_auto`` and ``phase_lag_auto`` ("pli", "wpli", "dwpli") on the
   (200, 64, 2048) pair batches, 100 Morse rows, the counters zeroed just
   before: "coherence" (K6) must launch exactly twice, "plv" twice and
   "phaselag" three times; then the same seven calls at a ragged 19
   epochs.
21. Holds each epilogue's raw sums against the plain sums on the same
   tensors: coherence's four planes and phaselag's sum Im, sum |Im| and
   sum Im^2 max|d| / max|ref| <= 1e-5; phaselag's sum sign(Im) by a count
   rule (at most 1e-4 of the cells differ, each by at most 2 per epoch
   whose |Im| lies within 1e-5 of |a| max|b| + |b| max|a| of 0, the maxima
   over the epoch's row); plv's two planes max|d| <= 2e-3 E overall and
   <= 1e-4 E on sound cells (every epoch's |a| and |b| at least 1e-2 of
   their row's max, the rule of ``tests/test_torch_cwt.py``; where only
   sum |a||b| >= 1e-6 of its max the error is printed, not gated: one weak
   epoch's unit phase is round-off), NaN masks equal.  Then the finished
   statistics: coherence and imcoh <= 1e-4 where their denominator >= 1e-6
   of its max; plv and ppc at the ITC gates of slice 1 on sound cells
   (ppc's scaled by 2E / (E - 1), the most its derivative in PLV reaches);
   wpli and dwpli <= 1e-4 where sum |Im| >= 1e-6 of its max; NaN masks
   equal.  At full width and at E = 19.
22. Every N from 256 to 16384 at both ``interpolate`` settings on 5 epochs
   x 3 pairs x 13 rows: a lagged pair, a self-pair (a = b) and an all-zero
   channel a; the gates of 21, the NaN masks of wpli, dwpli and plv equal
   to the plain path's, and the self-pair's PLI exactly 0.
23. Known answers, 64 epochs x 2 pairs x 2048, a 60 Hz tone with a random
   phase per epoch plus 0.1 noise: against the same tone lagged a quarter
   period (own noise) PLV, wPLI and |imcoh| >= 0.99 over the interior of
   the 60 Hz row; against a zero-lag copy PLV >= 0.99, mean wPLI <= 0.2,
   mean |imcoh| <= 0.05.
24. The adapter: ``EpochsWavelet.plv``, ``coherence``, ``wpli``, ``ppc``,
   ``imcoh`` and ``psi`` on one channel pair of the serving data run the
   plain path (no K6 launch: the JAX package's dispatch) and equal the ops
   functions on that pair; ``plv_matrix``, ``coherence_matrix``,
   ``ppc_matrix`` and ``wpli_matrix`` at 16 x 64 x 2048 x 100
   (``benchmarks/extensions_bench.py:167-173``), timed, with PLV and PPC
   diagonals 1 within 1e-5 and wPLI's diagonal NaN; TF32 matmuls off.
   Then ``plv_matrix`` (the row stream) against ``fused_plv`` over all
   2016 channel pairs followed by the time mean, timed and compared.
25. Times (median of 5 after warm-up, fresh values each run) each epilogue's
   entry point (``epoch_coherence_auto``, ``plv_auto``,
   ``phase_lag_auto(method="wpli")``) against its plain path, and each
   epilogue alone by CUDA events.

Slice 6, complex banks (MexicanHat, Haar: Normal-mode families, complex64
banks) and the rest of the zoo, on the serving data:

26. Drives ``EpochsWavelet.power_all`` (with the baseline), ``itc_all`` and
   ``power_itc_all`` on ``MexicanHat`` (``interpolate=False``, the family's
   default), ``power_itc_all`` on ``MexicanHat(interpolate=True)`` and
   ``itc_all`` on ``Haar`` at a ragged 19 epochs, the counters zeroed just
   before: "power_cx", "itc_cx" and "power_itc_cx" (K1/K2 cx) must each
   launch, and no real-bank kernel.  Then the MexicanHat bank on every
   other path (``power_auto``, the five pair ``*_auto``, ``StreamingCWT``)
   must launch nothing, ``supports_ssq`` and scattering must refuse it,
   and ``fused_power_from_bank`` must raise.
27. Holds K1/K2 cx against the plain path on the same tensors at slice 1's
   power gates (1e-5 relative; z-scores by the carried tolerance) and ITC
   max|d| <= 1e-4 on sound cells (every epoch's |c| at least 1e-2 of its
   row max); on the analytic path also slice 1's ITC gates (2e-3 overall,
   1e-4 where the power is at least 1e-6 of its plane max).  Without the
   analytic mask a Normal-mode family's coefficients pass through zero in
   time, so at a cell of strong mean power one epoch's unit phase can be
   round-off: there those two are printed, not gated.  In their place
   every ITC cell must lie within the tolerance carried through the unit
   phases (each coefficient moved by 1e-5 of its row max), both between
   the kernel and the plain path and from each of them to a float64
   witness (the plain path's math in float64).  NaN masks equal.
   Then 5 epochs x 3 channels x 13 rows at every N from 256 to 16384 on both
   ``interpolate`` settings.  Times every epilogue at both settings.
28. Drives ``learn_bank`` from 1.2 x a complex MexicanHat bank (as the float
   pair ``bank0``, ``bank0_i``) for 3 steps at 64 x 64 x 2048 x 100
   (``interpolate=True``): "power_cx" and "power_bwd_cx" (K3 cx) launch
   once a step and the loss falls.  K3 cx against ``mean_power_bwd`` (ds,
   dbank.real, dbank.imag each <= 1e-4 relative) at the full shape, at
   ``interpolate=False`` with E = 8, with F = 13, and at every N from 256
   to 16384 on both settings; 5 steps at E = 8 follow the plain path's
   losses (rtol 1e-3).  Times K3 cx (its path and alone) and one training
   step against the plain path.
29. The rest of the zoo: ``Paul``, ``DOG`` and ``Bump`` ``power_all`` (one
   "power" launch each) against the plain path, a 60 Hz tone peaking at
   the 60 Hz row for each; ``multitaper_mean_power`` (one "power" launch
   over 300 rows) and ``EpochsWavelet.superlet_power`` on one channel, 200
   epochs, orders 1-8 (eight "power_each" launches) against the plain path
   (1e-5; superlets 1e-4), the plain versions built from the public
   pieces (the plain epoch mean over the flat taper banks; the weighted
   geometric mean of each order's plain power); ``induced_power`` and
   ``evoked_power`` ("power"), and ``single_trial_power_all`` at 19
   epochs ("power_each") against the plain path;
   ``multitaper_coherence_matrix`` at 16 x 64 x 2048 x 100 with its
   diagonal 1.  Times the multitaper and superlet
   epoch means against the plain path, and the matrix.

The line before the last is the kernels' JSON record, with each kernel's
bound: the larger of its compulsory bytes over 3.35 TB/s and its FFT flops
(5 N log2 N per complex FFT, half that per real one) over 67 TFLOP/s, the
H100 SXM's published fp32 peaks; every other number in it is measured in
this run.  The last line is ``{"ok": true, "device": {...}}``.
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
CX_REPLACES = "ninwavelets_tpu/ops/fused.py:246"
BWD_CX_REPLACES = "ninwavelets_tpu/ops/fused.py:955"
PAIR_SOURCE = "ninwavelets_tpu_torch/csrc/fused_pair.cu"
PAIR_REPLACES = {"coherence": "ninwavelets_tpu/ops/fused.py:311",
                 "phaselag": "ninwavelets_tpu/ops/fused.py:326",
                 "plv": "ninwavelets_tpu/ops/fused.py:344"}
E_MATRIX = 16
SIGN_ROUNDOFF, SIGN_CELLS = 1e-5, 1e-4
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12     # H100 SXM: fp32 non-tensor, HBM3
#: The radix-2 kernels' times of the rows now on the register-resident core
#: (PERF.md section 6, from this script's runs on an NVIDIA H100 80GB HBM3
#: at 700 W: the real and K6 rows before slice 6, the cx rows in it; cx at
#: interpolate=False; K3, K4, K5a and K5b with their wrappers' FFTs, K4
#: writing the whole window).  Recorded, not measured here: printed on a
#: text line beside this run's time, never in the kernels' JSON record.
RADIX2_MS = {"fused_cwt[power]": 56.0220340000015,
             "fused_cwt[itc]": 56.072407000002045,
             "fused_cwt[power_itc]": 56.29238400000247,
             "fused_cwt_cx[power]": 57.067306000021745,
             "fused_cwt_cx[itc]": 57.414926999996396,
             "fused_cwt_cx[power_itc]": 57.43015999999557,
             "fused_pair[coherence]": 116.39304599999889,
             "fused_pair[phaselag]": 115.99573400000907,
             "fused_pair[plv]": 113.98615299999904,
             "fused_cwt_bwd[power]": 36.94156099999901,
             "fused_cwt_bwd_cx[power]": 35.81185200002324,
             "fused_cwt[power_each]": 25.219659000001116,
             "fused_cwt[amax]": 56.899150999996095,
             "fused_ssq": 115.54801000001191}


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
    """Registers, shared memory and spills per kernel from ``ptxas -v``;
    returns the instantiations that spill where none may: the reductions
    and the cross-pair sums (``fused_cwt_kernel<EPI,LOG2N,CX>``,
    ``fused_pair_kernel<EPI,LOG2N>``), the backward
    (``fused_cwt_bwd_kernel<LOG2N,CX>``) and synchrosqueezing
    (``fused_ssq_kernel<LOG2N,LOG>``) at N <= 8192, "power_each" and
    "amax" (``fused_each_kernel<LOG2N>``, ``fused_amax_kernel<LOG2N>``) at
    every N."""
    name, args, spilling = "?", [], []
    with open(lib[:-3] + ".log") as fh:
        for line in fh:
            m = re.search(r"entry function '(\S+)'", line)
            if m:
                k = re.search(r"(fused_(?:cwt|cwt_bwd|each|amax|ssq|"
                              r"pair)_kernel)I(.*?)EEv", m.group(1))
                args = (re.findall(r"L[ib](\d+)E", k.group(2) + "E")
                        if k else [])
                name = (f"{k.group(1)}<" + ",".join(args) + ">" if k
                        else m.group(1))
            elif "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
                stores = re.search(r"(\d+) bytes spill stores", line)
                if stores and int(stores.group(1)) and no_spill(name, args):
                    spilling.append(name)
    return spilling


def no_spill(name, args):
    """True for the instantiations that must not spill (``print_ptxas``)."""
    if name.startswith(("fused_cwt_kernel<", "fused_pair_kernel<")):
        return int(args[1]) <= 13
    if name.startswith(("fused_cwt_bwd_kernel<", "fused_ssq_kernel<")):
        return int(args[0]) <= 13
    return name.startswith(("fused_each_kernel<", "fused_amax_kernel<"))


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


def core_sweep():
    """Real-bank K1/K2 against the plain path at every N from 256 to 16384
    (the register-resident core's plan changes with N), both
    ``interpolate`` settings, E = 1 and E = E_RAGGED, 3 channels x
    F_RAGGED rows: power max|d| / max|ref| <= 1e-5, ITC at slice 1's
    gates."""
    import torch
    from ninwavelets_tpu_torch.ops import cwt, fused
    freqs = np.arange(1.0, F_RAGGED + 1.0)
    gen = np.random.default_rng(12)
    for log2n in range(8, 15):
        n = 1 << log2n
        for interp in (True, False):
            bank = morse_bank(freqs, n, interp)
            for e in (1, E_RAGGED):
                xs = torch.from_numpy(gen.standard_normal(
                    (e, 3, n), dtype=np.float32)).cuda()
                tag = f"N={n} interpolate={interp} ({e}, 3) x {F_RAGGED}"
                rp = cwt.mean_power_from_bank(xs, bank, interp)
                ri = cwt.itc_from_bank(xs, bank, interp)
                rel_err(f"K1 power {tag}",
                        fused.fused_mean_power_from_bank(xs, bank, interp), rp)
                itc_err(f"K2 itc {tag}",
                        fused.fused_itc_from_bank(xs, bank, interp), ri, rp)
                gp, gi = fused.fused_power_itc_from_bank(xs, bank, interp)
                rel_err(f"K2 power_itc power {tag}", gp, rp)
                itc_err(f"K2 power_itc itc {tag}", gi, ri, rp)


def print_radix2_ms(record):
    """Print the time this run measured for ``record``'s row beside the
    radix-2 kernel's recorded time of the same row (``RADIX2_MS``)."""
    before = RADIX2_MS[record["name"]]
    print(f"time {record['name']}: {record['ms']} ms on the register-resident"
          f" core (this run); {before} ms on the radix-2 core (recorded, "
          f"PERF.md section 6, not measured here); ratio "
          f"{record['ms'] / before}")


def core_layout_check():
    """The host's model of the register-resident core (``kernels.core_*``
    and ``kernels.bwd_rows``, which ``tests/test_torch_fft_plan.py``
    emulates) against the plan, exchange indices and backward row groups
    the built library computes with the kernels' own functions
    (``kernels.built_core_layout``), at every N."""
    from ninwavelets_tpu_torch import kernels
    for log2n in range(8, 15):
        n = 1 << log2n
        got = kernels.built_core_layout(n)
        r = kernels.core_r(n)
        t_count = n // r
        plan = kernels.core_plan(n)
        same = (got["r"] == r and got["threads"] == t_count
                and got["plan"] == plan
                and got["bwd_rows"] == (kernels.bwd_rows(n, False),
                                        kernels.bwd_rows(n, True))
                and got["twiddles"] == len(kernels.core_twiddles(n))
                and got["buf_len"] > kernels.core_pad(n - 1))
        reads = kernels.core_pad(kernels.core_output_map(n))
        for s in range(len(plan) - 1):
            same = (same and np.array_equal(
                got["writes"][s], kernels.core_exchange_positions(n, s))
                and np.array_equal(got["reads"][s], reads))
        print(f"check core layout N={n}: library R={got['r']} T="
              f"{got['threads']} plan {got['plan']} buffer {got['buf_len']} "
              f"table {got['twiddles']} backward rows {got['bwd_rows']}; "
              f"equals the host's model: {same}")
        check(same, f"the core's layout at N={n} differs from kernels.core_*")


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
    record = {"name": "fused_cwt_bwd[power]", "route": "cuda",
              "source": BWD_SOURCE, "replaces": BWD_REPLACES,
              "launches": counts["power_bwd"], "max_abs_err": err_bwd,
              "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
              "bound_by": bound_by, "library_ms": None}
    print_radix2_ms(record)
    return record


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
    keep = (h, h + REC_WINDOW)
    err_each = 0.0
    for name, ext in (("first", groups[0][1]), ("ragged last", groups[-1][1])):
        xs = torch.from_numpy(ext).cuda()
        ref = cwt.power_from_bank(xs, bank, True)
        err_each = max(err_each, rel_err(
            f"K4 {name} window batch {tuple(xs.shape)}",
            fused.fused_power_from_bank(xs, bank, True), ref))
        kept = torch.full((REC_C, REC_F, REC_BATCH, REC_WINDOW), math.nan,
                          device="cuda")
        fused._power_each_into(xs, bank, True, kept.permute(2, 0, 1, 3),
                               keep)
        err_each = max(err_each, rel_err(
            f"K4 {name} window batch, interiors written into a (C, F, "
            f"batch x window) plane", kept.permute(2, 0, 1, 3),
            ref[..., keep[0]:keep[1]]))
        del xs, ref, kept
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
    span = REC_BATCH * REC_WINDOW
    buf = torch.empty((REC_C, REC_F, span), device="cuda")
    dst = buf.unflatten(-1, (REC_BATCH, REC_WINDOW)).permute(2, 0, 1, 3)

    def plain_into():
        dst.copy_(cwt.power_from_bank(x, bank, True)[..., keep[0]:keep[1]])

    ms, plain_ms, whole_ms = median_ms(x, [
        lambda: fused._power_each_into(x, bank, True, dst, keep),
        plain_into, lambda: fused.fused_power_from_bank(x, bank, True)])
    print(f"time one window batch {tuple(x.shape)} x {REC_F} rows into the "
          f"plane: K4 path (rFFT + kernel writing the interiors in place) "
          f"{ms} ms, plain (torch.fft, crop + paste) {plain_ms} ms; K4 "
          f"writing whole windows (fused_power_from_bank) {whole_ms} ms "
          f"(this run), the radix-2 kernel's {RADIX2_MS['fused_cwt[power_each]']}"
          f" ms (recorded, PERF.md section 6, not measured here)")
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
    whole = torch.empty((spec.shape[0], 1, REC_F, REC_EXT), device="cuda")
    parts = {
        "host-to-device copy of the batch (pageable)": lambda:
            torch.from_numpy(host).cuda(),
        "rFFT of the batch": lambda: torch.fft.rfft(
            x.reshape(-1, 1, REC_EXT)),
        "K4 writing each window's interior into the plane (the fused "
        "path's launch; no crop + paste follows)": lambda:
            kernels.fused_power_each(spec, bank, REC_EXT // 2, dst, keep),
        "K4 writing whole windows (for comparison)": lambda:
            kernels.fused_power_each(spec, bank, REC_EXT // 2, whole,
                                     (0, REC_EXT)),
    }
    for name, fn in parts.items():
        print(f"breakdown {name}: {event_ms(fn)} ms (CUDA events, mean of "
              f"{REPS})")
    del spec, whole, buf, dst, x
    torch.cuda.empty_cache()

    # The bound of the kept-range launch: the signals and the bank read
    # once, the interiors written once.
    b = REC_BATCH * REC_C
    bound_ms, bound_by = bound(
        b * (fft_flops(REC_EXT) / 2 + REC_F * fft_flops(REC_EXT)),
        4 * (b * REC_EXT + REC_F * REC_EXT + b * REC_F * REC_WINDOW))
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
    print(f"time peaks (C, E): K5a path (rFFT + zero-fill + kernel + max "
          f"over rows) {amax_ms} ms, plain {amax_plain_ms} ms")
    spec = torch.fft.rfft(x).contiguous()
    floors = (1e-6 * peaks).contiguous()
    ssq_ms = median_ms(x, [lambda: kernels.fused_ssq(
        torch.fft.rfft(x).contiguous(), bank, floors, hint, SFREQ)])[0]
    print(f"time K5b path (rFFT + zero-fill + kernel) {ssq_ms} ms")
    no_gate = torch.full_like(floors, math.inf)
    for name, fn in (("K5a alone (zero-fill included)", lambda:
                      kernels.fused_cwt("amax", spec, bank, N // 2, "fast3")),
                     ("K5b alone (zero-fill included)", lambda:
                      kernels.fused_ssq(spec, bank, floors, hint, SFREQ)),
                     ("K5b alone, every cell gated to its own row (floors "
                      "= inf: coalesced adds)", lambda: kernels.fused_ssq(
                          spec, bank, no_gate, hint, SFREQ)),
                     ("K1 'power' alone, for scale", lambda:
                      kernels.fused_cwt("power", spec, bank, N // 2,
                                        "fast3"))):
        print(f"breakdown {name}: {event_ms(fn)} ms (CUDA events, mean of "
              f"{REPS})")
    del spec, x, no_gate
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
        "K5a alone (zero-fill included)": lambda: kernels.fused_cwt(
            "amax", spec_b, stream._bank, REC_EXT // 2, "fast3"),
        "K5b alone (zero-fill included)": lambda: kernels.fused_ssq(
            spec_b, stream._bank, floors_b, rec_hint, SFREQ),
        "K5b alone, every cell gated to its own row (floors = inf)":
            lambda: kernels.fused_ssq(spec_b, stream._bank,
                                      torch.full_like(floors_b, math.inf),
                                      rec_hint, SFREQ),
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
    records = [{"name": "fused_cwt[amax]", "route": "cuda",
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
    for record in records:
        print_radix2_ms(record)
    return records


def pair_b(a):
    """Channel b of each pair: 0.6 x channel a lagged 5 samples plus 0.8 x
    the neighbouring channel, so that every statistic is non-trivial."""
    import torch
    return (0.6 * torch.roll(a, 5, -1) + 0.8 * torch.roll(a, 1, 1)
            ).contiguous()


def cross_mag(a, b, bank, interpolate):
    """sum_e |a| |b| per cell, the plain way."""
    from ninwavelets_tpu_torch.ops.extensions import epoch_sums
    return epoch_sums(a, b, bank, interpolate,
                      lambda wa, wb: (wa.abs() * wb.abs(),))[0]


def sound_cells(a, b, bank, interpolate):
    """Cells where every epoch's |a| and |b| are at least 1e-2 of their
    row's maximum over epochs and time, the plain way: elsewhere the unit
    phase of a weak coefficient is round-off (the rule of
    ``tests/test_torch_cwt.py``)."""
    import torch
    from ninwavelets_tpu_torch.ops.cwt import cwt_from_bank
    lows, highs = [None, None], [None, None]
    for pair in zip(a, b):
        for i, sig in enumerate(pair):
            m = cwt_from_bank(sig, bank, interpolate).abs()
            top = m.amax(-1, keepdim=True)
            lows[i] = m if lows[i] is None else torch.minimum(lows[i], m)
            highs[i] = top if highs[i] is None else torch.maximum(highs[i],
                                                                  top)
    return (lows[0] >= 1e-2 * highs[0]) & (lows[1] >= 1e-2 * highs[1])


def above(weight):
    """Cells whose ``weight`` is at least STRONG_POWER of its plane's max."""
    return weight >= STRONG_POWER * weight.amax(dim=(-2, -1), keepdim=True)


def strong_err(name, got, ref, strong, gate, overall=None,
               where=f"the weight >= {STRONG_POWER} of its plane max"):
    """NaN masks equal; max|d| <= ``gate`` on the ``strong`` cells (and <=
    ``overall`` everywhere, if given).  Returns max|d|."""
    import torch
    check(got.shape == ref.shape, f"{name}: shape {tuple(got.shape)} != "
          f"{tuple(ref.shape)}")
    check(torch.equal(got.isnan(), ref.isnan()), f"{name}: NaN masks differ "
          f"({int(got.isnan().sum())} against {int(ref.isnan().sum())})")
    d = torch.where(ref.isnan() | got.isnan(), torch.zeros_like(ref),
                    (got - ref).abs())
    err = d.max().item()
    err_strong = torch.where(strong, d, torch.zeros_like(d)).max().item()
    print(f"check {name}: max|d| {err}"
          + (f" (gate {overall})" if overall is not None else "")
          + f", where {where} {err_strong} (gate {gate}; "
          f"{int(strong.sum())} of {strong.numel()} cells), NaN cells "
          f"{int(ref.isnan().sum())}")
    if overall is not None:
        check(err <= overall, f"{name}: err {err} > {overall}")
    check(err_strong <= gate, f"{name}: err {err_strong} > {gate} on strong "
          "cells")
    return err


def sign_err(name, got, ref, a, b, bank, interpolate):
    """The rule for sum sign(Im): at most SIGN_CELLS of the cells differ,
    each by at most 2 per epoch whose plain |Im| lies within SIGN_ROUNDOFF
    (|a| max|b| + |b| max|a|) of 0, the maxima over that epoch's row (a
    sign flip moves the sum by 2, a flip to a pinned 0 by 1)."""
    import torch
    from ninwavelets_tpu_torch.ops.cwt import cwt_from_bank
    d = (got - ref).abs()
    bad = d > 0
    count = int(bad.sum())
    worst = d.max().item()
    print(f"check {name}: {count} of {d.numel()} cells differ (gate "
          f"{SIGN_CELLS} of them), largest difference {worst}")
    check(count <= SIGN_CELLS * d.numel(), f"{name}: {count} cells differ")
    if not count:
        return worst
    idx = bad.nonzero()
    allowed = torch.zeros(count, device=d.device)
    for c in idx[:, 0].unique().tolist():
        sel = idx[:, 0] == c
        f_, n_ = idx[sel, 1], idx[sel, 2]
        wa = cwt_from_bank(a[:, c], bank, interpolate)        # (E, F, N)
        wb = cwt_from_bank(b[:, c], bank, interpolate)
        xa, xb = wa[:, f_, n_], wb[:, f_, n_]
        ma, mb = wa.abs().amax(-1)[:, f_], wb.abs().amax(-1)[:, f_]
        im = (xa * xb.conj()).imag
        near = im.abs() <= SIGN_ROUNDOFF * (xa.abs() * mb + xb.abs() * ma)
        allowed[sel] = 2.0 * near.sum(0)
        del wa, wb
    over = int((d[bad] > allowed).sum())
    print(f"check {name}: cells beyond 2 x their near-zero epochs {over}")
    check(over == 0, f"{name}: {over} cells differ beyond the rule")
    return worst


def pair_sums_err(tag, a, b, bank, interpolate):
    """Each epilogue's raw sums against the plain sums on the same tensors
    (step 21), then the finished statistics; returns ({epilogue: max|d|},
    the kernel's raw sums)."""
    from ninwavelets_tpu_torch.ops import connectivity as conn
    from ninwavelets_tpu_torch.ops import extensions as ext
    from ninwavelets_tpu_torch.ops import fused
    e = a.shape[0]
    errs = {}
    k_coh = fused.fused_coherence_sums(a, b, bank, interpolate)
    p_coh = ext.coherence_sums(a, b, bank, interpolate)
    errs["coherence"] = max(
        rel_err(f"K6 coherence {part}, {tag}", g, r)
        for part, g, r in zip(("sum Re", "sum Im", "sum |a|^2", "sum |b|^2"),
                              k_coh, p_coh))
    xr, xi, pa, pb = p_coh
    strong_err(f"coherence, {tag}",
               ext.coherence_from_sums(*k_coh, e),
               ext.coherence_from_sums(*p_coh, e), above(pa * pb), 1e-4)
    strong_err(f"imcoh, {tag}", ext.imcoh_from_sums(*k_coh),
               ext.imcoh_from_sums(*p_coh), above((pa * pb).sqrt()), 1e-4)
    del k_coh, p_coh, xr, xi, pa, pb

    k_pl = fused.fused_phase_lag_sums(a, b, bank, interpolate)
    p_pl = conn.phase_lag_sums(a, b, bank, interpolate)
    errs["phaselag"] = max(
        rel_err(f"K6 phaselag {part}, {tag}", k_pl[i], p_pl[i])
        for i, part in ((0, "sum Im"), (1, "sum |Im|"), (3, "sum Im^2")))
    sign_err(f"K6 phaselag sum sign(Im), {tag}", k_pl[2], p_pl[2], a, b,
             bank, interpolate)
    for method in ("wpli", "dwpli"):
        strong_err(f"{method}, {tag}",
                   conn.phase_lag_from_sums(k_pl, e, method),
                   conn.phase_lag_from_sums(p_pl, e, method), above(p_pl[1]),
                   1e-4)
    pli_k = conn.phase_lag_from_sums(k_pl, e, "pli")
    pli_p = conn.phase_lag_from_sums(p_pl, e, "pli")
    check(bool(pli_k.isfinite().all()), f"pli, {tag}: non-finite")
    print(f"check pli, {tag}: max|d| {(pli_k - pli_p).abs().max().item()} "
          "(the sign rule above bounds it)")

    k_plv = fused.fused_plv_sums(a, b, bank, interpolate)
    p_plv = conn.plv_sums(a, b, bank, interpolate)
    sound = sound_cells(a, b, bank, interpolate)
    weak = above(cross_mag(a, b, bank, interpolate))
    sound_where = "every epoch's |a|, |b| >= 1e-2 of the row max"
    ppc_scale = 2 * e / (e - 1.0)
    errs["plv"] = 0.0
    for part, g, r in zip(("sum Re", "sum Im"), k_plv, p_plv):
        errs["plv"] = max(errs["plv"], strong_err(
            f"K6 plv {part}, {tag}", g, r, sound, ITC_ATOL_STRONG * e,
            ITC_ATOL * e, sound_where))
        strong_err(f"K6 plv {part}, {tag}, by sum |a||b| (not gated)", g, r,
                   weak, math.inf,
                   where=f"sum |a||b| >= {STRONG_POWER} of its plane max")
    for name, fin, scale in (
            ("plv", lambda s_: (s_[0] ** 2 + s_[1] ** 2).sqrt() / e, 1.0),
            ("ppc", lambda s_: (s_[0] ** 2 + s_[1] ** 2 - e)
             / (e * (e - 1.0)), ppc_scale)):
        strong_err(f"{name}, {tag}", fin(k_plv), fin(p_plv), sound,
                   scale * ITC_ATOL_STRONG, scale * ITC_ATOL, sound_where)
    return errs, (k_pl, k_plv)


def pair_phase(data):
    """Slice 5: the pair-connectivity path at full width, its checks and
    times; returns the three K6 records."""
    import torch
    import ninwavelets_tpu_torch as nt
    from ninwavelets_tpu_torch import kernels
    from ninwavelets_tpu_torch.ops import connectivity as conn
    from ninwavelets_tpu_torch.ops import extensions as ext
    from ninwavelets_tpu_torch.ops import fused

    freqs = np.arange(1.0, F + 1.0)
    bank = morse_bank(freqs, N, True)
    a = torch.from_numpy(data).cuda()
    b = pair_b(a)

    # -- the main path: the *_auto entry points on 64-pair batches ----------
    def drive(sa, sb):
        return {"coherence": ext.epoch_coherence_auto(sa, sb, bank,
                                                      interpolate=True),
                "imcoh": ext.imcoh_auto(sa, sb, bank, interpolate=True),
                "plv": conn.plv_auto(sa, sb, bank, interpolate=True),
                "ppc": conn.ppc_auto(sa, sb, bank, interpolate=True),
                **{m: conn.phase_lag_auto(sa, sb, bank, method=m,
                                          interpolate=True)
                   for m in conn.PHASE_LAG_METHODS}}

    want = {"coherence": 2, "plv": 2, "phaselag": 3}
    for tag, sa, sb in (("full width", a, b),
                        (f"E={E_RAGGED}", a[:E_RAGGED], b[:E_RAGGED])):
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        stats = drive(sa, sb)
        torch.cuda.synchronize()
        counts = dict(kernels.launches)
        print(f"pair main path, {tag}: {time.perf_counter() - t0} s "
              f"(E={sa.shape[0]} pairs={C} N={N} F={F}, 7 calls, first calls "
              f"included); launches {counts}")
        for key, n_calls in want.items():
            check(counts[key] == n_calls, f"{key!r} launched {counts[key]} "
                  f"times for {n_calls} calls, {tag}")
        for name, plane in stats.items():
            check(tuple(plane.shape) == (C, F, N), f"{name} shape "
                  f"{tuple(plane.shape)}, {tag}")
        if tag == "full width":
            main_counts = counts
        del stats

    # -- K6 against the plain sums, same tensors -----------------------------
    errs, _ = pair_sums_err("full width", a, b, bank, True)
    pair_sums_err(f"E={E_RAGGED}", a[:E_RAGGED].contiguous(),
                  b[:E_RAGGED].contiguous(), bank, True)
    torch.cuda.empty_cache()
    gen = np.random.default_rng(8)
    freqs_small = freqs[::8]
    for log2n in range(8, 15):
        n = 1 << log2n
        xa = torch.from_numpy(gen.standard_normal((5, 3, n),
                                                  dtype=np.float32)).cuda()
        xb = (0.6 * torch.roll(xa, 5, -1) + 0.8 * torch.from_numpy(
            gen.standard_normal((5, 3, n), dtype=np.float32)).cuda())
        xb[:, 1] = xa[:, 1]                       # a self-pair
        xa[:, 2] = 0.0                            # an all-zero channel a
        for interp in (True, False):
            bs = morse_bank(freqs_small, n, interp)
            tag = f"N={n} interpolate={interp} (5, 3) x {len(freqs_small)}"
            _, (k_pl, k_plv) = pair_sums_err(tag, xa, xb.contiguous(), bs,
                                             interp)
            pli = conn.phase_lag_from_sums(k_pl, 5, "pli")
            check(bool((pli[1] == 0).all()), f"{tag}: self-pair PLI is not "
                  "exactly 0")
            wpli = conn.phase_lag_from_sums(k_pl, 5, "wpli")
            check(bool(wpli[1:].isnan().all()), f"{tag}: the self-pair's and "
                  "the zero channel's wPLI are not all NaN")
            check(bool(k_plv[0][2].isnan().all()), f"{tag}: the zero "
                  "channel's PLV sums are not all NaN")

    # -- known answers ----------------------------------------------------
    rng = np.random.default_rng(9)
    t = np.arange(N) / SFREQ
    phi = rng.uniform(0, 2 * np.pi, (64, 1, 1))
    tone_a = np.sin(2 * np.pi * 60.0 * t + phi) + 0.1 * rng.standard_normal(
        (64, 2, N))
    tone_b = np.concatenate([
        np.sin(2 * np.pi * 60.0 * t + phi - np.pi / 2),   # a quarter period
        np.sin(2 * np.pi * 60.0 * t + phi)], 1) + 0.1 * rng.standard_normal(
            (64, 2, N))
    ta = torch.from_numpy(tone_a.astype(np.float32)).cuda()
    tb = torch.from_numpy(tone_b.astype(np.float32)).cuda()
    mid = slice(N // 4, 3 * N // 4)
    kernels.reset_launches()
    v = conn.plv_auto(ta, tb, bank, interpolate=True)[:, 59, mid]
    w = conn.phase_lag_auto(ta, tb, bank, interpolate=True)[:, 59, mid]
    ic = ext.imcoh_auto(ta, tb, bank, interpolate=True)[:, 59, mid].abs()
    check(all(kernels.launches[k] == 1 for k in want),
          f"known answers did not run K6: {dict(kernels.launches)}")
    print(f"check lagged 60 Hz pair: min PLV {v[0].min().item()}, min wPLI "
          f"{w[0].min().item()}, min |imcoh| {ic[0].min().item()} (gates "
          f">= 0.99); zero-lag pair: min PLV {v[1].min().item()} (>= 0.99), "
          f"mean wPLI {w[1].mean().item()} (<= 0.2), mean |imcoh| "
          f"{ic[1].mean().item()} (<= 0.05)")
    check(min(v[0].min().item(), w[0].min().item(), ic[0].min().item())
          >= 0.99, "lagged 60 Hz pair below 0.99")
    check(v[1].min().item() >= 0.99, "zero-lag PLV below 0.99")
    check(w[1].mean().item() <= 0.2, "zero-lag wPLI above 0.2")
    check(ic[1].mean().item() <= 0.05, "zero-lag |imcoh| above 0.05")

    # -- the adapter: single pairs run the plain path; the matrices ----------
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")
    ew = nt.EpochsWavelet(nt.ArrayEpochs(data, SFREQ),
                          nt.Morse(SFREQ, interpolate=True, device="cuda"))
    bank_c = ew._conn_bank(N, freqs)
    sa, sb = a[:, 0].contiguous(), a[:, 1].contiguous()
    kernels.reset_launches()
    pair_calls = {
        "plv": (ew.plv("ch0", "ch1", freqs), conn.plv(sa, sb, bank_c, True)),
        "coherence": (ew.coherence("ch0", "ch1", freqs),
                      ext.epoch_coherence(sa, sb, bank_c, True)),
        "wpli": (ew.wpli("ch0", "ch1", freqs),
                 conn.phase_lag(sa, sb, bank_c, "wpli", True)),
        "ppc": (ew.ppc("ch0", "ch1", freqs), conn.ppc(sa, sb, bank_c, True)),
        "imcoh": (ew.imcoh("ch0", "ch1", freqs),
                  ext.imcoh(sa, sb, bank_c, True)),
        "psi": (ew.psi("ch0", "ch1", freqs),
                ext.psi(sa, sb, bank_c, interpolate=True))}
    torch.cuda.synchronize()
    print(f"adapter pair methods: launches {dict(kernels.launches)}")
    check(sum(kernels.launches[k] for k in want) == 0, "an adapter pair "
          "method reached K6; the JAX package's (E, N) pairs run XLA")
    for name, (got, ref) in pair_calls.items():
        same = torch.equal(got.isnan(), ref.isnan()) and torch.equal(
            got.nan_to_num(), ref.nan_to_num())
        print(f"check EpochsWavelet.{name} equals the ops function: {same}")
        check(same, f"EpochsWavelet.{name} differs from the ops function")
    del pair_calls

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    ew16 = nt.EpochsWavelet(nt.ArrayEpochs(data[:E_MATRIX], SFREQ),
                            nt.Morse(SFREQ, interpolate=True, device="cuda"))
    mats = {name: getattr(ew16, f"{name}_matrix")(freqs)
            for name in ("plv", "coherence", "ppc", "wpli")}
    for name in ("plv", "ppc"):
        dev = (mats[name].diagonal(dim1=1, dim2=2) - 1).abs().max().item()
        print(f"check {name}_matrix diagonal: max|d - 1| {dev} (gate 1e-5)")
        check(dev <= 1e-5, f"{name}_matrix diagonal off 1 by {dev}")
    check(bool(mats["wpli"].diagonal(dim1=1, dim2=2).isnan().all()),
          "wpli_matrix diagonal is not NaN")
    for name, m in mats.items():
        off = ~torch.eye(C, dtype=torch.bool, device=m.device)
        check(tuple(m.shape) == (F, C, C) and bool(m[:, off].isfinite().all()),
              f"{name}_matrix shape {tuple(m.shape)} or non-finite values")
    x16 = ew16._all_data().clone()
    fns = {"plv": conn.plv_matrix, "coherence": conn.coherence_matrix,
           "ppc": conn.ppc_matrix, "wpli": conn.wpli_matrix}
    for name, fn in fns.items():
        ms = host_ms(lambda x: fn(x, bank, interpolate=True),
                     lambda: x16.normal_())
        print(f"time {name}_matrix ({E_MATRIX} x {C} x {N} x {F}): {ms} ms")
    iu = torch.triu_indices(C, C, 1, device="cuda")

    def plv_by_pairs(x):
        v_ = fused.fused_plv(x[:, iu[0]].contiguous(),
                             x[:, iu[1]].contiguous(), bank).mean(-1)
        m = torch.ones((F, C, C), device="cuda")
        m[:, iu[0], iu[1]] = v_.T
        m[:, iu[1], iu[0]] = v_.T
        return m

    got = plv_by_pairs(x16)
    ref = conn.plv_matrix(x16, bank, True)
    d = (got - ref).abs().max().item()
    print(f"check plv_matrix by fused_plv over {iu.shape[1]} pairs against "
          f"the row stream: max|d| {d} (gate 1e-4)")
    check(d <= 1e-4, f"plv by pairs differs from plv_matrix by {d}")
    del got, ref, mats
    torch.cuda.empty_cache()
    row_ms, pairs_ms = median_ms(x16, [lambda: conn.plv_matrix(x16, bank,
                                                                True),
                                       lambda: plv_by_pairs(x16)])
    print(f"time plv_matrix {E_MATRIX} x {C} x {N} x {F}: row stream "
          f"{row_ms} ms, fused_plv over {iu.shape[1]} pairs + time mean "
          f"{pairs_ms} ms")
    del x16
    torch.cuda.empty_cache()

    # -- times ----------------------------------------------------------------
    x = a.clone()
    calls = {
        "coherence": (lambda: ext.epoch_coherence_auto(x, b, bank,
                                                       interpolate=True),
                      lambda: ext.epoch_coherence(x, b, bank, True)),
        "plv": (lambda: conn.plv_auto(x, b, bank, interpolate=True),
                lambda: conn.plv(x, b, bank, True)),
        "phaselag": (lambda: conn.phase_lag_auto(x, b, bank, method="wpli",
                                                 interpolate=True),
                     lambda: conn.phase_lag(x, b, bank, "wpli", True)),
    }
    spec_a = torch.fft.rfft(x).contiguous()
    spec_b = torch.fft.rfft(b).contiguous()
    fft = fft_flops(N)
    records = []
    for epilogue, (kern, plain) in calls.items():
        ms, plain_ms = median_ms(x, [kern, plain])
        alone = event_ms(lambda: kernels.fused_cwt_pair(
            epilogue, spec_a, spec_b, bank, N // 2))
        print(f"time {epilogue} (E={E} pairs={C} N={N} F={F}): kernel path "
              f"(2 rFFTs + K6 + finisher) {ms} ms, plain torch.fft {plain_ms}"
              f" ms; K6 alone {alone} ms (CUDA events, mean of {REPS})")
        bound_ms, bound_by = bound(
            E * C * (fft + 2 * F * fft),
            4 * (2 * E * C * N + F * N
                 + kernels.PAIR_PLANES[epilogue] * C * F * N))
        records.append({
            "name": f"fused_pair[{epilogue}]", "route": "cuda",
            "source": PAIR_SOURCE, "replaces": PAIR_REPLACES[epilogue],
            "launches": main_counts[epilogue],
            "max_abs_err": errs[epilogue], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
        print_radix2_ms(records[-1])
    del spec_a, spec_b, x, a, b
    torch.cuda.empty_cache()
    return records


# -- slice 6: complex banks and the rest of the zoo ---------------------------

def itc_witness(x, bank, interpolate):
    """The plain path's math in float64, one epoch at a time, for (E, C, N)
    signals: (the float64 ITC, the sound cells, the carried tolerance).  The
    sound cells have every epoch's |c| at least 1e-2 of its row max (the
    rule of ``tests/test_torch_cwt.py``).  The carried tolerance is, per
    cell, the most the ITC can move when every coefficient moves by at most
    POWER_RTOL of its row max M: (1/E) sum_e min(2, 2 POWER_RTOL M / |c_e|),
    since a unit phase c / |c| moves by at most 2 |dc| / |c|."""
    import torch
    from ninwavelets_tpu_torch.ops.grids import analytic_mask
    bank = bank.to(torch.complex128)

    def coefs(sig):
        spec = torch.fft.fft(sig.to(torch.float64))
        if interpolate:
            spec = spec * analytic_mask(spec.shape[-1], torch.float64,
                                        spec.device)
        return torch.fft.ifft(spec[..., None, :] * bank)

    top = None
    for sig in x:
        m = coefs(sig).abs().amax(-1, keepdim=True)
        top = m if top is None else torch.maximum(top, m)
    low, total, phase = None, 0.0, 0.0
    for sig in x:
        c = coefs(sig)
        m = c.abs()
        low = m if low is None else torch.minimum(low, m)
        total = total + torch.nan_to_num(2 * POWER_RTOL * top / m,
                                         nan=2.0).clamp(max=2.0)
        phase = phase + c / m
    e = x.shape[0]
    return (phase / e).abs(), low >= 1e-2 * top, total / e


def cx_itc_err(name, got, ref, witness, interpolate, ref_power):
    """ITC of a complex-bank (Normal-mode) family against the plain path,
    with ``witness = itc_witness(...)`` of the same signals and bank: NaN
    masks equal; max|d| <= ITC_ATOL_STRONG on sound cells; on every cell
    |d| within the carried tolerance, and the kernel and the plain float32
    path each within the carried tolerance of the float64 ITC; on the
    analytic path also slice 1's gates (ITC_ATOL overall, ITC_ATOL_STRONG
    where the power is at least STRONG_POWER of its plane max).  Without
    the analytic mask a Normal-mode family's coefficients pass through zero
    in time, so at a cell of strong mean power one epoch's unit phase can be
    round-off, in either float32 path: there slice 1's gates cannot hold,
    and are printed, not gated; the float64 witness shows which path is
    off and by how much."""
    if interpolate:
        itc_err(name, got, ref, ref_power)
    else:
        strong_err(f"{name} (printed, not gated: power rule)", got, ref,
                   above(ref_power), float("inf"))
    witness_err(name, got, ref, witness, ref_power)
    return strong_err(name, got, ref, witness[1], ITC_ATOL_STRONG,
                      where="every epoch's |c| >= 1e-2 of its row max")


def witness_err(name, got, ref, witness, ref_power):
    """An ITC plane against the plain path and both against the float64
    ITC, with ``witness = itc_witness(...)`` of the same signals and bank:
    on every cell the kernel within the tolerance carried through the unit
    phases of the plain path, and the kernel and the plain float32 path
    each within it of the float64 ITC.  Prints each path's max|d| from the
    float64 ITC overall and where the power is at least STRONG_POWER of its
    plane max: which float32 path is nearer the true value."""
    import torch
    itc64, _, carried = witness
    d = torch.where(ref.isnan() | got.isnan(), torch.zeros_like(ref),
                    (got - ref).abs())
    ratio = torch.where(d > 0, d / carried, torch.zeros_like(carried))
    at = int(ratio.argmax())
    ratio = ratio.flatten()[at].item()
    print(f"check {name}: max|d| / carried tolerance {ratio} (gate 1); at "
          f"that cell kernel {got.flatten()[at].item()}, plain "
          f"{ref.flatten()[at].item()}, float64 {itc64.flatten()[at].item()}")
    check(ratio <= 1.0, f"{name}: ITC outside the carried tolerance "
          f"({ratio})")
    for path, v in (("kernel", got), ("plain float32", ref)):
        bad = v.isnan() | itc64.isnan()
        d64 = torch.where(bad, torch.zeros_like(itc64),
                          (v.double() - itc64).abs())
        r64 = torch.where(d64 > 0, d64 / carried,
                          torch.zeros_like(carried)).max().item()
        strong = above(ref_power)
        print(f"check {name}, {path} vs float64: max|d| {d64.max().item()}"
              f", where the power >= {STRONG_POWER} of its plane max "
              f"{d64[strong].max().item()} (not gated); max|d| / carried "
              f"tolerance {r64} (gate 1); NaN cells {int(bad.sum())}")
        check(r64 <= 1.0, f"{name}: {path} ITC outside the carried "
              f"tolerance of the float64 ITC ({r64})")


def cx_bank(family, freqs, n, interpolate):
    import ninwavelets_tpu_torch as nt
    return getattr(nt, family)(SFREQ, interpolate=interpolate,
                               device="cuda").make_fft_wavelets(freqs,
                                                                n / SFREQ)


def complex_bank_elsewhere(data, bank):
    """A complex bank on every path but the three epoch reductions (K4, K5,
    K6, streaming, scattering) takes the plain path and launches nothing;
    the per-signal wrapper raises rather than launch."""
    import torch
    import ninwavelets_tpu_torch as nt
    from ninwavelets_tpu_torch import kernels
    from ninwavelets_tpu_torch.ops import connectivity as conn
    from ninwavelets_tpu_torch.ops import extensions as ext
    from ninwavelets_tpu_torch.ops import fused
    from ninwavelets_tpu_torch.ops.scattering import _fused_ok
    from ninwavelets_tpu_torch.parallel import StreamingCWT

    a = torch.from_numpy(data[:5, :8]).cuda()
    b = torch.roll(a, 1, 1).contiguous()
    kernels.reset_launches()
    fused.power_auto(a, bank)
    for fn in (ext.epoch_coherence_auto, ext.imcoh_auto, conn.plv_auto,
               conn.ppc_auto, conn.phase_lag_auto):
        fn(a, b, bank)
    stream = StreamingCWT(nt.MexicanHat(SFREQ, device="cuda")._wdef(),
                          np.arange(5.0, 101.0), SFREQ, window=1024, halo=256,
                          device="cuda")
    stream.power_device(data[0, :4])
    torch.cuda.synchronize()
    counts = {k: v for k, v in kernels.launches.items() if v}
    takes_ssq = fused.supports_ssq(a.shape, bank, ("lin", 1.0, 1.0), True)
    print(f"check complex bank elsewhere (power_auto, the five pair autos, "
          f"StreamingCWT): launches {counts}; streaming fused "
          f"{stream._fused}, supports_ssq {takes_ssq}, scattering fused "
          f"{_fused_ok(N, bank)}")
    check(not counts and not stream._fused and not takes_ssq
          and not _fused_ok(N, bank), "a complex bank reached K4/K5/K6")
    try:
        fused.fused_power_from_bank(a, bank, False)
        check(False, "fused_power_from_bank took a complex bank")
    except ValueError as exc:
        print(f"check fused_power_from_bank raises for a complex bank: {exc}")
    check(not any(kernels.launches.values()), "a complex bank launched")


def complex_bank_phase(data):
    """Slice 6, complex banks: MexicanHat / Haar serving and training through
    the complex-bank kernels (K1/K2 cx, K3 cx) at full width, their checks
    and times; returns their kernel records."""
    import torch
    import ninwavelets_tpu_torch as nt
    from ninwavelets_tpu_torch import kernels
    from ninwavelets_tpu_torch.ops import cwt, fused

    freqs = np.arange(1.0, F + 1.0)
    cx_keys = ("power_cx", "itc_cx", "power_itc_cx")

    # -- the main path: MexicanHat / Haar serving through K1/K2 cx ------------
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    mh = nt.MexicanHat(SFREQ, device="cuda")           # interpolate=False
    ew = nt.EpochsWavelet(nt.ArrayEpochs(data, SFREQ), mh)
    power_bl = ew.power_all(freqs, baseline=BASELINE)
    itc = ew.itc_all(freqs)
    pi_power, pi_itc = ew.power_itc_all(freqs)
    mh_a = nt.MexicanHat(SFREQ, interpolate=True, device="cuda")
    ew_a = nt.EpochsWavelet(nt.ArrayEpochs(data, SFREQ), mh_a)
    pa_power, pa_itc = ew_a.power_itc_all(freqs)
    ew_h = nt.EpochsWavelet(nt.ArrayEpochs(data[:E_RAGGED], SFREQ),
                            nt.Haar(SFREQ, device="cuda"))
    itc_h = ew_h.itc_all(freqs)
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    print(f"complex-bank main path {time.perf_counter() - t0} s (MexicanHat "
          f"power_all with baseline, itc_all, power_itc_all; MexicanHat("
          f"interpolate=True) power_itc_all; Haar itc_all at E={E_RAGGED}; "
          f"first calls included); launches {counts}")
    for key in cx_keys:
        check(counts[key] > 0, f"{key!r} never launched on the complex-bank "
              "main path")
    others = {k: v for k, v in counts.items() if k not in cx_keys and v}
    check(not others, f"real-bank kernels launched on the complex-bank main "
          f"path: {others}")

    # -- a complex bank anywhere else runs the plain path ---------------------
    complex_bank_elsewhere(data, mh.fft_wavelets)

    # -- K1/K2 cx against the plain path, same tensors ------------------------
    err = {}
    x, bank = ew._all_data(), mh.fft_wavelets
    check(bank.dtype == torch.complex64, f"MexicanHat bank is {bank.dtype}")
    ref_power = cwt.mean_power_from_bank(x, bank, False)
    ref_itc = cwt.itc_from_bank(x, bank, False)
    err["power"] = rel_err("MexicanHat power kernel alone",
                           fused.fused_mean_power_from_bank(x, bank, False),
                           ref_power)
    baselined_err("MexicanHat power_all baselined", power_bl, ref_power)
    wit = itc_witness(x, bank, False)
    err["itc"] = cx_itc_err("MexicanHat itc_all", itc, ref_itc, wit, False,
                            ref_power)
    err["power_itc"] = max(
        rel_err("MexicanHat power_itc_all power", pi_power, ref_power),
        cx_itc_err("MexicanHat power_itc_all itc", pi_itc, ref_itc, wit,
                   False, ref_power))
    del ref_itc, power_bl, itc, pi_power, pi_itc, wit
    bank_a = mh_a.fft_wavelets
    ref_a = cwt.mean_power_from_bank(x, bank_a, True)
    err["power_itc"] = max(
        err["power_itc"],
        rel_err("MexicanHat(interpolate=True) power_itc_all power", pa_power,
                ref_a),
        cx_itc_err("MexicanHat(interpolate=True) power_itc_all itc", pa_itc,
                   cwt.itc_from_bank(x, bank_a, True),
                   itc_witness(x, bank_a, True), True, ref_a))
    del ref_a, pa_power, pa_itc
    xh, bank_h = ew_h._all_data(), ew_h.wavelet.fft_wavelets
    err["itc"] = max(err["itc"], cx_itc_err(
        f"Haar itc_all E={E_RAGGED}", itc_h, cwt.itc_from_bank(xh, bank_h,
                                                               False),
        itc_witness(xh, bank_h, False), False,
        cwt.mean_power_from_bank(xh, bank_h, False)))
    del xh, itc_h
    torch.cuda.empty_cache()

    gen = np.random.default_rng(11)
    for log2n in range(8, 15):
        n = 1 << log2n
        for interp in (True, False):
            xs = torch.from_numpy(gen.standard_normal(
                (5, 3, n), dtype=np.float32)).cuda()
            bs = cx_bank("MexicanHat", freqs[:F_RAGGED], n, interp)
            tag = f"N={n} interpolate={interp} (5, 3) x {F_RAGGED}"
            rp = cwt.mean_power_from_bank(xs, bs, interp)
            ri = cwt.itc_from_bank(xs, bs, interp)
            wit = itc_witness(xs, bs, interp)
            rel_err(f"K1 cx power {tag}",
                    fused.fused_mean_power_from_bank(xs, bs, interp), rp)
            cx_itc_err(f"K2 cx itc {tag}",
                       fused.fused_itc_from_bank(xs, bs, interp), ri, wit,
                       interp, rp)
            gp, gi = fused.fused_power_itc_from_bank(xs, bs, interp)
            rel_err(f"K2 cx power_itc power {tag}", gp, rp)
            cx_itc_err(f"K2 cx power_itc itc {tag}", gi, ri, wit, interp, rp)

    # -- times: K1/K2 cx against the plain path, both settings ----------------
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    x = x.clone()
    fft = fft_flops(N)
    times = {}
    for interp, bk in ((False, bank), (True, bank_a)):
        pairs = {
            "power": (lambda: fused.fused_mean_power_from_bank(x, bk, interp),
                      lambda: cwt.mean_power_from_bank(x, bk, interp)),
            "itc": (lambda: fused.fused_itc_from_bank(x, bk, interp),
                    lambda: cwt.itc_from_bank(x, bk, interp)),
            "power_itc": (
                lambda: fused.fused_power_itc_from_bank(x, bk, interp),
                lambda: (cwt.mean_power_from_bank(x, bk, interp),
                         cwt.itc_from_bank(x, bk, interp))),
        }
        k_bins = N // 2 if interp else N
        for epilogue, (kern, plain) in pairs.items():
            ms, plain_ms = median_ms(x, [kern, plain])
            n_out = 2 if epilogue == "power_itc" else 1
            times[epilogue, interp] = (ms, plain_ms, *bound(
                E * C * (fft / 2 + F * fft),
                4 * (E * C * N + 2 * F * k_bins + n_out * C * F * N)))
            print(f"time {epilogue} complex bank (MexicanHat, E={E} C={C} "
                  f"N={N} F={F}, interpolate={interp}): kernel {ms} ms, plain "
                  f"torch.fft {plain_ms} ms; bound "
                  f"{times[epilogue, interp][2]} ms "
                  f"({times[epilogue, interp][3]})")
    records = []
    for epilogue in ("power", "itc", "power_itc"):
        ms, plain_ms, bound_ms, bound_by = times[epilogue, False]
        ms_a, plain_a, bound_a, _ = times[epilogue, True]
        records.append({
            "name": f"fused_cwt_cx[{epilogue}]", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": CX_REPLACES,
            "launches": counts[f"{epilogue}_cx"],
            "max_abs_err": err[epilogue], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "interpolate": False, "ms_analytic": ms_a,
            "plain_ms_analytic": plain_a, "bound_ms_analytic": bound_a})
        print_radix2_ms(records[-1])
    del x, bank, bank_a
    torch.cuda.empty_cache()
    records.append(complex_training())
    return records


def complex_training():
    """Slice 6, training: ``learn_bank`` from a complex MexicanHat start
    through K1 cx and K3 cx, K3 cx against ``mean_power_bwd``, times;
    returns K3 cx's record."""
    import torch
    import ninwavelets_tpu_torch as nt
    from ninwavelets_tpu_torch import kernels
    from ninwavelets_tpu_torch.ops import cwt, fused

    freqs = np.arange(1.0, F + 1.0)
    gen = np.random.default_rng(12)
    x = torch.from_numpy(gen.standard_normal((E_GRAD, C, N),
                                             dtype=np.float32)).cuda()
    bank = cx_bank("MexicanHat", freqs, N, True)
    target = cwt.mean_power_from_bank(x, bank, True)
    torch.cuda.synchronize()

    kernels.reset_launches()
    t0 = time.perf_counter()
    (_, _), losses = nt.learn_bank(x, 1.2 * bank.real, target,
                                   bank0_i=1.2 * bank.imag, loss="mse",
                                   steps=STEPS, lr=1e-3, use_fused=True)
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    losses = losses.tolist()
    print(f"complex-bank training main path {time.perf_counter() - t0} s "
          f"(E={E_GRAD} C={C} N={N} F={F} MexicanHat rows, {STEPS} steps); "
          f"losses {losses}; launches {counts}")
    check(losses[-1] < losses[0], f"complex learn_bank loss did not fall: "
          f"{losses}")
    for key in ("power_cx", "power_bwd_cx"):
        check(counts[key] == STEPS, f"{key!r} launched {counts[key]} times "
              f"in {STEPS} training steps")
    others = {k: v for k, v in counts.items()
              if k not in ("power_cx", "power_bwd_cx") and v}
    check(not others, f"other kernels launched in complex training: {others}")

    def bwd_err(tag, ds, dbank, ds_ref, dbank_ref):
        return max(rel_err(f"K3 cx ds, {tag}", ds, ds_ref, GRAD_RTOL),
                   rel_err(f"K3 cx dbank.real, {tag}", dbank.real,
                           dbank_ref.real, GRAD_RTOL),
                   rel_err(f"K3 cx dbank.imag, {tag}", dbank.imag,
                           dbank_ref.imag, GRAD_RTOL))

    w = torch.from_numpy(gen.standard_normal((C, F, N),
                                             dtype=np.float32)).cuda()
    err_bwd = 0.0
    runs = [("full shape", x, bank, w, True),
            (f"interpolate=False E={E_SMALL}", x[:E_SMALL],
             cx_bank("MexicanHat", freqs, N, False), w, False),
            (f"F={F_RAGGED}", x, bank[:F_RAGGED].contiguous(),
             w[:, :F_RAGGED].contiguous(), True)]
    for name, xs, bs, ws, interp in runs:
        ds, dbank = fused_grads(fused.fused_mean_power_from_bank, xs, bs, ws,
                                interp)
        check(dbank.dtype == torch.complex64, f"dbank is {dbank.dtype}")
        e_ = bwd_err(name, ds, dbank, *fused.mean_power_bwd(xs, bs, interp,
                                                            ws))
        err_bwd = e_ if name == "full shape" else err_bwd
        del ds, dbank
    for log2n in range(8, 15):
        n = 1 << log2n
        for interp in (True, False):
            xs = torch.from_numpy(gen.standard_normal(
                (3, 2, n), dtype=np.float32)).cuda()
            ws = torch.from_numpy(gen.standard_normal(
                (2, F_RAGGED, n), dtype=np.float32)).cuda()
            bs = cx_bank("MexicanHat", freqs[:F_RAGGED], n, interp)
            bwd_err(f"N={n} interpolate={interp} E=3 C=2 F={F_RAGGED}",
                    *fused._fused_power_bwd(xs, bs, ws, interp),
                    *fused.mean_power_bwd(xs, bs, interp, ws))

    kw = dict(bank0_i=1.2 * bank.imag, steps=5, lr=1e-3)
    _, l_fused = nt.learn_bank(x[:E_SMALL], 1.2 * bank.real, target,
                               use_fused=True, **kw)
    _, l_plain = nt.learn_bank(x[:E_SMALL], 1.2 * bank.real, target,
                               use_fused=False, **kw)
    d = ((l_fused - l_plain).abs() / l_plain.abs()).max().item()
    print(f"check complex learn_bank trajectory E={E_SMALL}: fused "
          f"{l_fused.tolist()} plain {l_plain.tolist()} max rel {d} "
          "(gate 1e-3)")
    check(d <= 1e-3, f"complex learn_bank trajectory rel {d} > 1e-3")

    g = torch.empty_like(w)
    ms, plain_ms = median_ms(x, [
        lambda: fused._fused_power_bwd(x, bank, g.normal_(), True),
        lambda: fused.mean_power_bwd(x, bank, True, g.normal_())])
    spec = torch.fft.rfft(x).contiguous()
    alone = event_ms(lambda: kernels.fused_cwt_bwd(spec, bank, g, N // 2))
    print(f"time power backward complex bank (E={E_GRAD} C={C} N={N} F={F}, "
          f"interpolate=True): kernel path {ms} ms, plain mean_power_bwd "
          f"{plain_ms} ms; K3 cx alone {alone} ms (CUDA events, mean of "
          f"{REPS})")
    del spec
    pr = bank.real.detach().clone().requires_grad_(True)
    pi = bank.imag.detach().clone().requires_grad_(True)

    def step(power):
        p = power(x, torch.complex(pr, pi), True)
        return torch.autograd.grad(torch.mean(torch.square(p - target)),
                                   (pr, pi))

    step_ms, step_plain_ms = median_ms(x, [
        lambda: step(fused.fused_mean_power_from_bank),
        lambda: step(cwt.mean_power_from_bank)])
    print(f"time training step complex bank (loss and bank gradient, "
          f"E={E_GRAD} C={C} N={N} F={F}): fused {step_ms} ms, plain "
          f"{step_plain_ms} ms")
    fft = fft_flops(N)
    bound_ms, bound_by = bound(
        E_GRAD * C * (fft / 2 + 2 * F * fft + fft),
        4 * (2 * E_GRAD * C * N + 2 * 2 * F * N + C * F * N))
    record = {"name": "fused_cwt_bwd_cx[power]", "route": "cuda",
              "source": BWD_SOURCE, "replaces": BWD_CX_REPLACES,
              "launches": counts["power_bwd_cx"], "max_abs_err": err_bwd,
              "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
              "bound_by": bound_by, "library_ms": None}
    print_radix2_ms(record)
    return record


def plain_multitaper(x, freqs, n_tapers=3):
    """The multitaper epoch-mean power the plain way, from the public
    pieces: the plain epoch mean over the flat (F*K, N) taper banks, then
    the mean over each frequency's K tapers."""
    from ninwavelets_tpu_torch.ops import cwt
    from ninwavelets_tpu_torch.ops.multitaper import multitaper_banks
    n = x.shape[-1]
    banks = multitaper_banks(freqs, n, SFREQ, n_tapers=n_tapers,
                             device=x.device)
    p = cwt.mean_power_from_bank(x, banks.reshape(-1, n), False)
    return p.reshape(*p.shape[:-2], len(freqs), n_tapers, n).mean(-2)


def plain_superlet(x, freqs):
    """The superlet epoch-mean power the plain way, from the public pieces:
    each epoch's weighted geometric mean of the plain member powers, then
    the mean over epochs."""
    import torch
    from ninwavelets_tpu_torch.ops import cwt
    from ninwavelets_tpu_torch.ops.superlets import (superlet_banks,
                                                     superlet_weights)
    banks = superlet_banks(freqs, x.shape[-1], SFREQ, device=x.device)
    w = torch.from_numpy(superlet_weights(freqs)).to(x.device)[:, :, None]
    logs = sum(w_k * torch.log(torch.clamp(cwt.power_from_bank(x, b, False),
                                           min=1e-30))
               for b, w_k in zip(banks, w))
    return torch.exp(logs / w.sum(0)).mean(0)


def zoo_phase(data):
    """Slice 6, the rest of the zoo at full width: Paul / DOG / Bump serving
    through K1, the multitaper epoch mean through one "power" launch over
    3 F rows, superlets through K4 (one launch an order), the adapter's
    induced / evoked / single-trial power and the multitaper coherence
    matrix, each against the plain path, with known answers and times."""
    import torch
    import ninwavelets_tpu_torch as nt
    from ninwavelets_tpu_torch import kernels
    from ninwavelets_tpu_torch.ops import cwt
    from ninwavelets_tpu_torch.ops.multitaper import (
        multitaper_coherence_matrix, multitaper_mean_power)
    from ninwavelets_tpu_torch.ops.superlets import superlet_mean_power

    freqs = np.arange(1.0, F + 1.0)
    tone = tone_epochs(8, 2, N)
    for family in ("Paul", "DOG", "Bump"):
        w = getattr(nt, family)(SFREQ, device="cuda")
        ew = nt.EpochsWavelet(nt.ArrayEpochs(data, SFREQ), w)
        kernels.reset_launches()
        got = ew.power_all(freqs)
        torch.cuda.synchronize()
        check(kernels.launches["power"] == 1, f"{family} power_all launched "
              f"{dict(kernels.launches)}")
        rel_err(f"{family} power_all (K1) vs plain", got,
                cwt.mean_power_from_bank(ew._all_data(), w.fft_wavelets,
                                         False))
        p = nt.EpochsWavelet(nt.ArrayEpochs(tone, SFREQ), getattr(nt, family)(
            SFREQ, device="cuda")).power_all(freqs)
        peak = int(p.mean(-1).argmax(-1)[0]) + 1
        print(f"check {family} 60 Hz tone: power peak at {peak} Hz")
        check(peak == 60, f"{family}: 60 Hz tone peaks at {peak} Hz")
        del got, ew

    x = torch.from_numpy(data).cuda()
    kernels.reset_launches()
    mt = multitaper_mean_power(x, freqs, SFREQ)
    torch.cuda.synchronize()
    mt_counts = dict(kernels.launches)
    print(f"multitaper_mean_power (E={E} C={C} N={N}, {F} x 3 = {3 * F} "
          f"rows) launches {mt_counts}")
    check(mt_counts["power"] == 1 and sum(mt_counts.values()) == 1,
          f"multitaper launches {mt_counts}")
    rel_err("multitaper_mean_power (K1, 300 rows) vs plain", mt,
            plain_multitaper(x, freqs))
    del mt

    ew = nt.EpochsWavelet(nt.ArrayEpochs(data, SFREQ),
                          nt.Morse(SFREQ, device="cuda"))
    x0 = ew._channel_data("ch0")[:, None, :]
    kernels.reset_launches()
    sl = ew.superlet_power("ch0", freqs)
    torch.cuda.synchronize()
    sl_counts = dict(kernels.launches)
    print(f"superlet_power (one channel, E={E}, orders 1-8) launches "
          f"{sl_counts}")
    check(sl_counts["power_each"] == 8 and sum(sl_counts.values()) == 8,
          f"superlet launches {sl_counts}")
    rel_err("superlet_power (K4) vs plain", sl,
            plain_superlet(x0, freqs)[0], 1e-4)

    waves = x0[:, 0]
    kernels.reset_launches()
    induced = ew.induced_power("ch0", freqs)
    evoked = ew.evoked_power("ch0", freqs)
    torch.cuda.synchronize()
    bank = ew.wavelet.fft_wavelets
    check(kernels.launches["power"] == 2, f"induced / evoked launches "
          f"{dict(kernels.launches)}")
    rel_err("induced_power (K1) vs plain", induced, cwt.mean_power_from_bank(
        (waves - waves.mean(0, keepdim=True))[:, None], bank, False)[0])
    rel_err("evoked_power (K1) vs plain", evoked, cwt.mean_power_from_bank(
        waves.mean(0)[None, None], bank, False)[0])

    ew19 = nt.EpochsWavelet(nt.ArrayEpochs(data[:E_RAGGED], SFREQ),
                            nt.Morse(SFREQ, device="cuda"))
    kernels.reset_launches()
    st = ew19.single_trial_power_all(freqs)
    torch.cuda.synchronize()
    check(kernels.launches["power_each"] == 1, f"single_trial_power_all "
          f"launches {dict(kernels.launches)}")
    rel_err(f"single_trial_power_all E={E_RAGGED} (K4) vs plain", st,
            cwt.power_from_bank(ew19._all_data(), ew19.wavelet.fft_wavelets,
                                False))
    del st
    torch.cuda.empty_cache()

    xm = x[:E_MATRIX].contiguous()
    coh = multitaper_coherence_matrix(xm, freqs, SFREQ)
    diag = torch.diagonal(coh, dim1=1, dim2=2)
    derr = (diag - 1).abs().max().item()
    print(f"check multitaper_coherence_matrix ({E_MATRIX} x {C} x {N} x {F})"
          f": shape {tuple(coh.shape)}, max|diag - 1| {derr} (gate 1e-5)")
    check(tuple(coh.shape) == (F, C, C) and derr <= 1e-5
          and bool(coh.isfinite().all()), "multitaper coherence matrix")

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    ms, plain_ms = median_ms(x, [
        lambda: multitaper_mean_power(x, freqs, SFREQ),
        lambda: plain_multitaper(x, freqs)])
    print(f"time multitaper_mean_power (E={E} C={C} N={N}, {3 * F} rows): "
          f"kernel path {ms} ms, plain {plain_ms} ms")
    ms, plain_ms = median_ms(x0, [
        lambda: superlet_mean_power(x0, freqs, SFREQ),
        lambda: plain_superlet(x0, freqs)])
    print(f"time superlet_mean_power (one channel, E={E} N={N} F={F}, "
          f"orders 1-8): kernel path (8 K4 launches) {ms} ms, plain "
          f"{plain_ms} ms")
    ms = host_ms(lambda xs: multitaper_coherence_matrix(xs, freqs, SFREQ),
                 lambda: xm.normal_())
    print(f"time multitaper_coherence_matrix ({E_MATRIX} x {C} x {N} x {F}, "
          f"3 tapers): {ms} ms")


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
    spilling = print_ptxas(lib)
    check(not spilling, f"core kernels spill where they may not: {spilling}")
    core_layout_check()

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
    wit = itc_witness(x, bank, True)
    witness_err("itc_all", itc, ref_itc, wit, ref_power)
    witness_err("power_itc_all itc", pi_itc, ref_itc, wit, ref_power)
    del ref_itc, wit
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
    core_sweep()

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
        records.append({
            "name": f"fused_cwt[{epilogue}]", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": REPLACES,
            "launches": counts[epilogue], "max_abs_err": err[epilogue],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None})
        print_radix2_ms(records[-1])
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
    torch.cuda.empty_cache()

    # -- slice 5: pair connectivity -------------------------------------------
    records += pair_phase(data)
    torch.cuda.empty_cache()

    # -- slice 6: complex banks and the rest of the zoo -----------------------
    records += complex_bank_phase(data)
    torch.cuda.empty_cache()
    zoo_phase(data)
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
