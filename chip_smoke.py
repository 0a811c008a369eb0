#!/usr/bin/env python3
"""Drive the PyTorch port (``ninwavelets_tpu_torch``) once on one CUDA card.

    python3 chip_smoke.py          # from the root of the repository

What it does, failing (non-zero exit, no result line) if any check fails:

1. Requires CUDA and prints the card's name and power limit (nvidia-smi).
2. Builds the kernels (``csrc/fused_cwt.cu``, the forward,
   ``csrc/fused_cwt_bwd.cu``, the power backward, both also for complex
   banks, ``csrc/fused_ssq.cu``,
   synchrosqueezing, ``csrc/fused_pair.cu``, the cross-pair sums, and
   ``csrc/fused_czt.cu``, the chirp-z epoch reductions) for
   sm_90a, one nvcc process a source, all started together, into one
   library, and prints each kernel's registers and spills (``ptxas -v``):
   every kernel runs on the register-resident FFT core of
   ``csrc/fft_regs.cuh``, one instantiation per N: the epoch reductions
   (``fused_cwt_kernel<EPI, LOG2N, CX>``), the backward
   (``fused_cwt_bwd_kernel<LOG2N, CX>``), the per-signal power
   (``fused_each_kernel<LOG2N>``), the noise gate's peaks
   (``fused_amax_kernel<LOG2N>``), synchrosqueezing
   (``fused_ssq_kernel<LOG2N, LOG>``), the cross-pair sums
   (``fused_pair_kernel<EPI, LOG2N>``) and the chirp-z reductions
   (``fused_czt_kernel<EPI, LOG2M>``, M <= 4096); none of them may spill
   at N <= 8192, nor "power_each" (its split at 32768 too), "amax" and
   the chirp-z reductions at any size (synchrosqueezing's spill there is printed).  At every N the
   core's plan, exchange indices and the backward's row groups as the
   library computes them
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

Slice 7, the rest of connectivity (plain torch with every matrix product in
full float32; nothing here joins the kernels' record), at the JAX
package's shapes (``benchmarks/extensions_bench.py``):

30. The matrices at 16 x 64 x 2048 x 100 Morse rows (``interpolate=True``)
   through ``EpochsWavelet``: ``psi_matrix``, ``partial_coherence``,
   ``multitaper_partial_coherence`` (3 tapers), ``kuramoto_order`` and
   ``env_corr`` (orthogonalized and plain); PSI's diagonal exactly 0, the
   partial coherences' diagonals 1 within 1e-4, the orthogonalized
   envelope correlation's diagonal 0.
31. Coupling on the serving data: ``nm_plv`` 2:1 over 64 rows (4-35.5 Hz)
   on the 64 channel pairs of slice 5; ``plv_significance`` and
   ``phase_lag_significance`` ("wpli") on one pair, 100 rows, 199
   surrogates; ``pac`` ("mvl", "tort"; phase 4-11 Hz, amplitude 40-150
   Hz) on all 64 channels and ``pac_significance`` (199) on one;
   ``erpac`` 8 x 8 rows; ``bicoherence`` 16 x 16; ``cfd``; and
   ``EpochsWavelet.wavelet_entropy``, the counters zeroed just before:
   K1 "power" must launch once, and its entropy must lie within the
   power's 1e-5 carried through the entropy of the plain power.  Each
   adapter method equals its ops function on the same channel exactly.
   Then rhythmicity: ``lagged_coherence_morse`` on 16 x 65,536 samples at
   2-59 Hz; and the single-trial coherence: ``wavelet_coherence`` on 64
   pairs x 2048 x 100 rows, ``wtc_significance`` (100 surrogates, N =
   2048) and ``RawWavelet.coherence`` over one pair of slice 3's
   recording, without significance (the reason is printed).
32. Every path of 30 and 31 runs under the float32 matmul precision "high"
   (TF32 allowed) and "highest": the results must agree within 1e-6 of
   their max (``fp32_matmul`` guards every product) and each call must
   leave the caller's setting as it found it.  Each path's time: median
   of 5 after a warm-up, fresh input values each run, on a text line with
   the card's name and power limit; ``EpochsWavelet.wavelet_entropy`` and
   ``RawWavelet.coherence`` are timed as the whole user call (the
   channels' copies to the card, and the recording's bank, included).
33. The JAX tests' known answers on the card: the mediated chain's partial
   coherence below 0.1; the delayed pair's PSI sign (|z| > 2),
   antisymmetry and zero diagonal; the Kuramoto order of locked channels
   above 0.95; the harmonic 2:1 lock (only at its ratio); a planted PAC's
   p at the floor 1/200; a coupled pair's median PLV p <= 0.02; lagged
   coherence of a sustained rhythm above 0.9 and of noise below 0.3;
   bicoherence peaking at the planted (10, 25) Hz; a shared 20 Hz tone
   above its AR(1) level in > 90 % of its row.

Slice 8, directed and network connectivity and the event-locked path
(plain torch with every product in full float32, but for the event-locked
reductions, which run K1 / K2; nothing here joins the kernels' record):

34. Spectral Granger causality: ``EpochsWavelet.granger``,
   ``wavelet_dtf_pdc`` and ``wavelet_granger_significance`` (19
   surrogates; its GC must equal ``wavelet_granger``'s, p in [1/20, 1],
   diagonal 1) at the JAX bench's shape (``bench.py:253``: 16 epochs x 4
   channels x 2048 at 1 kHz, 65 bins, ``time_decim`` 32);
   ``EpochsWavelet.granger(conditional=True)`` on 8 channels of the
   serving data (diagonal 0); the pairwise call at full width (the serving
   data, 64 channels, ``time_decim`` 64), with its peak memory
   (``torch.cuda.max_memory_allocated``) and its time split between the
   decimated CWT with the cross spectra and the Wilson loop.
35. ``EpochsWavelet.network`` ("wpli", "plv"; 20 nulls) at 16 x 64 x 2048
   x 100 rows: modularity and, on rows whose matrix is finite off the
   diagonal, efficiency and path length finite (and, for "plv", every
   measure; the wPLI matrix's NaN diagonal reaches strength, clustering and
   the small-world index, as in the JAX package); the 20 Hz row's shortest
   paths against a float64 Floyd-Warshall (rel 1e-5); a lagged pair's
   strengths at 20 Hz (``tests/test_graph.py``'s inputs).
36. The event-locked path: ``RawWavelet`` over the slice 3 recording, 200
   mne-style events of two codes and one past the edge, -0.5 to 1.547 s
   (2048 samples): ``epochs``, ``epoch_power`` with the baseline, ``itc``,
   ``split()`` and each group's ``power_all``, the counters zeroed just
   before: "power" must launch 3 times and "itc" once, and nothing else.
   The windows equal numpy slices of the recording exactly, the edge event
   drops with its code, and the kernel results hold against the plain path
   on the same tensors at slice 1's gates.
37. ``convert.wavelet_from_jax`` on duck-typed ``Superlet``,
   ``MorseMultitaper`` and ``MorseMNE`` objects: the port's class on the
   card with the same parameters, its power equal to the class built
   directly.
38. Every path of 34-36 runs under TF32 allowed and not: the results must
   be identical (gate 0) and the caller's setting must come back.  Each
   path's time: median of 5 after a warm-up, fresh values each run (new
   data, or the events moved by a new offset), with the card's name and
   power limit; the full-width call's two TF32 runs are its warm-up.
   Then ``tests/test_granger.py``'s known answers on the card, at its
   sizes and tolerances: a VAR(2)'s Wilson factors and GC against the
   analytic factors, the direction on simulated epochs, and the mediated
   chain under pairwise and conditional GC and DTF / PDC.

Slice 9, statistics (``statistics_phase``; plain torch but for K4, which
makes the single-trial planes; nothing here joins the kernels' record), on
the serving data with a 40 Hz burst of amplitude 2 planted at 0.8-1.2 s in
channel 0 of the even epochs (a seeded phase per epoch):

39. Drives, the counters zeroed just before and read just after (K4,
   "power_each", must launch, and nothing else): ``EpochsWavelet.cluster_test``
   one-sample with the baseline (999 permutations) and independent between
   the two ``split()`` halves (999), ``cluster_regression`` on a seeded
   covariate, ``cluster_f`` over three ``split()`` groups,
   ``cluster_test_all`` over all 64 channels with a ring adjacency, decim 4
   and 256 permutations (``bench.py``'s ``BENCH_PERMS``), then on channel 0's
   baselined planes ``tfce_test_one_sample`` and ``max_stat_test_one_sample``
   (199), ``bootstrap_ci`` (1000) of its raw planes, and
   ``EpochsWavelet.bursts`` (factor 20, min_area 10) as a summary and as a
   table.
40. Each call runs under TF32 allowed and not, and the two results must be
   identical (gate 0: the contractions are full float32 and the masses exact
   sums); those runs give its peak memory
   (``torch.cuda.max_memory_allocated``), then its median host time over 5
   runs (3 for a call over 1 s), the data negated in place before each run.
41. Known answers: the planted burst is the first cluster of the one-sample,
   independent and all-channel tests, positive, p < 0.05, and holds every
   pixel of the planted box (40 Hz x 0.8-1.2 s; channel 0 at decim 4); the
   TFCE p is below 0.05 over the box and the max-stat p at (40 Hz, 1 s);
   ``bootstrap_ci`` equals float64 host quantiles of the same counts at 4096
   pixels within 1e-5 of the plane max, and the trial mean lies inside its
   bounds at 99% of the pixels; ``bursts`` finds the planted burst (from at
   most 0.85 s to at least 1.15 s, 40 Hz inside its rows) in every burst
   epoch.  The decimated planes of ``single_trial_power_all`` must not keep
   the full plane alive (at most 4 MiB above their own bytes).
42. The labels of one null chunk of the one-channel test (64 maps of 100 x
   2048) on the card equal the port's CPU labeler's and the host's
   connected components (``scipy.sparse.csgraph``) exactly; so do two null
   maps of the ring-adjacency test against the host's.
43. The one-channel ``cluster_test`` split by CUDA events into the power, the
   contractions, the labeling, the masses and ``_finish``; its null must equal
   ``cluster_test``'s exactly.
44. Calibration (``benchmarks/stats_calibration.py``'s first block):
   cluster, TFCE (stop 15) and max-stat one-sample tests on 500 null sims of
   20 x 8 x 32 (the script's own count), 99 permutations each; each
   family-wise error rate must lie in the exact binomial 99% envelope of
   alpha = 0.05 for the sim count.
45. ``cluster_permutations_per_s`` at ``bench.py:163``'s configuration (40 x
   100 x 1024, 256 permutations, threshold 2.0, 5 iterations on new input
   values, ``torch.cuda.synchronize()`` before the clock stops).

Slice 10, the other transforms (``transforms_phase``; plain torch but for
the kernels under three adapter paths; nothing here joins the kernels'
record), at the JAX package's bench shapes (``benchmarks/
extensions_bench.py``):

46. Each call runs under TF32 allowed and not (identical results, gate 0:
   no matrix product is left in the slice), then its median host time over
   5 runs with the input negated before each run, with its peak memory,
   the counters zeroed before the first and read after the last (no kernel
   may launch): ``modwt``, ``modwt_denoise`` and ``wavedec`` (db8, J = 8)
   and ``modwpt`` (db8, L = 5) on 64 x 65,536 (``:149-163``);
   ``best_basis`` (db4, 4 levels) on 8 x 65,536; ``bandpass`` 1-40 Hz and
   ``resample`` to 250 Hz (the power-of-two route) and 300 Hz (the
   any-ratio route) on slice 3's 64 x 600,000 recording (``:427-437``);
   ``modwt_denoise`` of its copy on the card and
   ``RawWavelet.modwt_denoise`` of it (2^20 samples, J = 17: the peak
   memory at full width; the difference is the two host copies);
   ``stockwell`` on 16 epochs x 64 channels x 2048, 100 rows 1-100 Hz;
   ``power2d`` on 8 and 160 images of 256 x 256, 4
   freqs x 6 orientations, on the default path and ``use_fft=True``
   (``:523-545``); ``wavedec2`` / ``waverec2`` (db4, level 4) on the 160.
47. Each result against the port's own CPU run on 4 rows (2 images) of
   the same input at the CPU tests' gate (max|d| <= 1e-5 x max|ref|; the
   CPU run is tied to JAX by ``tests/test_torch_*.py``); a denoised signal
   within 1e-5 of its INPUT's max (the coefficients' round-off scales with
   the signal they came from, and the shrinkage of white noise leaves an
   output of 3% of it: 3.0e-5 of the output's max at 2^20 samples, 8.6e-7
   of the input's, in the first run).  Known answers:
   the MODWT's energy partition (1e-5 relative) and the ``imodwt``,
   ``waverec``, ``imodwpt``, ``best_basis_reconstruct`` and ``waverec2``
   round trips (1e-5 of the signal's max); best-basis node costs against
   the CPU's (rtol 1e-5), its nodes equal where every decision's margin
   exceeds 1e-4, and their bands tiling [0, 1/2); ``mean_t S x N`` equal to
   the FFT at the bins and ``istockwell(stockwell(x))`` exact (1e-5) on a
   bin-aligned signal; the bandpass gain of a 10 Hz tone in [0.95, 1.05]
   and of a 100 Hz tone below 0.05; the default 2-D path against
   ``use_fft=True`` (1e-5).  The any-ratio resample's float32 positions
   are printed, not gated: a 100 Hz tone's error from the exact sine at
   20,000 and 600,000 samples (the JAX package's fault, reproduced).
48. The kernel paths, the counters zeroed just before and read just
   after: ``EpochsWavelet.tfr_power2d`` on the serving data (K1 "power"
   once), ``EpochsWavelet.modwt_denoise()`` and its ``power_all`` /
   ``itc_all`` (K1 "power" and K2 "itc" once each), and
   ``RawWavelet.filter(1, 40, notch_hz=50)`` of the recording wrapped back
   into a ``RawWavelet`` (window 11524) and its ``power`` (K4, 7
   launches); nothing else may launch.  K1's plane against the plain path
   at slice 1's power gate, and ``tfr_power2d`` against the plain plane's
   within that error carried through log1p and the 2-D CWT (|dW| <= max|d
   plane| x ||psi||_1 a row, plus 1e-5 of the max for the two transforms'
   own round-off); the denoised trials against the CPU run (as in 47) and
   K1 at slice 1's power gate; K2 at its 1e-4 gate on sound cells (every
   epoch's |c| at least 1e-2 of its row max, as in 21 and 27), with no
   NaN there: shrinkage removes a band from some trials and not others,
   so one epoch's coefficient can sit at the round-off floor under strong
   mean power, and an exactly-zero one gave 464 NaN cells in the plain
   path and 663 in K2 in the first runs, some where the power was above
   1e-6 of the plane max (printed, not gated); the filtered
   recording against the CPU run, its 60 Hz
   tone gone (gain below 0.01), and 4 channels of K4's plane against
   ``StreamingCWT(use_fused=False)`` (1e-5).  Then each user call of these
   paths timed as in 46.

Slice 11, the decompositions (``decomposition_phase``; plain torch, no
kernel of its own), at the JAX bench's shapes
(``benchmarks/extensions_bench.py``):

49. Each call timed: the median host time of 5 runs after a warm-up, the
   input renewed before each run, with its peak memory: ``matching_pursuit``
   on 8 x 4 x 1024, 20 atoms (``:358``); ``irasa`` on 16 x 60,000
   (``:368``; 1/f^2 noise plus a 10 Hz tone); ``emd`` on 64 x 2048, 6 IMFs,
   and ``eemd`` with 64 ensembles of 2048 samples (``:377-390``);
   ``cp_decompose`` rank 3 on 64 x 100 x 512, 100 sweeps (``:392``);
   ``cycle_features`` on 64 x 4096 (``:400``); ``hmm_fit`` on 8 x 6000 x
   12, K = 4, 50 iterations (``:411``; frames sampled from a 4-state HMM);
   ``specparam`` of 64 spectra, 500 steps (``:749``); ``vmd`` and ``ewt``
   on 4096 samples, 3 modes (``:784-795``).  Each call runs under TF32
   allowed and not, with identical results (gate 0: the products of
   ``cp_decompose``, ``hmm_fit`` and ``mp_tfr`` run in
   ``fp32_matmul("exact")``; the rest has none).  No kernel may launch
   during these calls.
50. Each result against the port's own CPU run of the same input (the CPU
   run is tied to JAX by ``tests/test_torch_*.py``), with the draws made on
   the card handed to the CPU (``_eemd_from_noise``, ``_cp_from_factors``,
   ``_hmm_from_perms``): the spectra, modes, features and the CP fit at
   1e-5 of the max; the CP model (``cp_reconstruct``) at 1e-4 and its
   weights and factors at 1e-3 (a rank-3 model of |noise| is ill-posed:
   ALS drifts along flat directions of the fit by round-off, 1.9e-4 of a
   factor's max in the first run, while the fit agreed to 2.4e-7);
   ``emd`` on 8 rows and the 64 realizations of ``eemd`` sifted on both,
   each row within 1e-4 of its max|x| for all but one row in eight (an
   extremum that compares two samples within round-off can flip and
   change every later sifting of its row: 1 of 64 realizations did in the
   first runs), the averaged EEMD IMFs printed; the atoms of
   ``matching_pursuit`` equal in scale and frequency, at most one sample
   apart in time (a wide atom's correlation peak is flat), the rest within
   1e-4; the HMM on 2 sequences at JAX's sharded gates (gamma 1e-4, means
   1e-3 absolute, log-likelihood rtol 1e-5, the paths equal);
   ``specparam`` (500 Adam steps) at the CPU tests' default-steps gates.
   Known answers: EMD and EEMD completeness (atol 2e-5), the energies of
   the atoms plus the residual's summing to the signal's (1e-4), the IRASA
   exponent of the 1/f^2 rows (within 0.35) and their 10 Hz peak, its
   parts summing to the PSD (1e-6), the CP fit of an exact rank-3 tensor
   above 0.999, the median cycle frequency of a 10 Hz rhythm within 0.5
   Hz, an HMM log-likelihood trace that never decreases (beyond 1e-5
   relative), specparam's exponent within 0.15 of the planted 1.2 and its
   largest peak within 1 Hz of 10 Hz, the VMD centers near 5 and 25 Hz and
   the EWT modes summing to the signal.
51. The adapter paths at full width, the counters zeroed before and read
   after each one's first call: ``EpochsWavelet.cp_power`` "cfn" (K1
   "power" once) and "efn" (K4 "power_each" once), ``specparam`` (K1
   "power" once) and ``matching_pursuit`` (no kernel) on the serving data;
   ``RawWavelet.states`` (its delta band starts at 1 Hz, whose halo needs
   a window of 16384 minus twice it to reach K4: "power_each" once per
   window batch) and ``specparam`` (window 11524, 7 launches) and
   ``irasa`` / ``psd`` (no kernel) on the 64 x 600,000 recording; nothing
   else may launch; each TF32 on and off identical and timed as in 49 with
   its peak memory; sanity of each
   result (finite; fits in [0, 1]; the HMM trace non-decreasing; IRASA's
   parts summing to the PSD within 1e-6 of its max).

Slice 12, sensor-space preprocessing and decoding (``sensor_space_phase``;
plain torch, every product in ``fp32_matmul("exact")``, no kernel of its
own), at the JAX bench's shapes (``benchmarks/extensions_bench.py``):

52. Each call timed as in 49, TF32 allowed and not identical, no kernel
   launched: ``fastica`` on 64 x 250,000 Laplace samples, 100 iterations
   (``:419-424``; its ms a step printed: one K x K ``eigh`` and its host
   sync a step); ``ssd`` and ``csp_decode`` (9-13 Hz, 5 folds) on 64 + 64
   x 64 x 2048 at 1 kHz with an 11 Hz rhythm on channel 0 of one class and
   63 of the other (``:473-495``); ``find_bad_channels`` and
   ``ledoit_wolf`` on 64 x 120,000 (``:599-613``; a flat channel 7 and a
   noisy 30); ``asr_process`` on 64 x 150,000 at 250 Hz, calibrated on the
   first 30,000 samples (``:632-639``; eight rank-one bursts), and its
   batched ``eigh`` of 2421 64 x 64 matrices alone by CUDA events;
   ``tangent_decode`` and ``mdm_decode`` on 80 x 32 x 512 (``:641-656``);
   ``autoreject_global`` on 128 x 64 x 1024 with a transient in every 16th
   trial (``:680-687``); ``trf_fit`` on 64 x 250,000, 64 lags, a kernel
   planted in 4 channels (``:714-721``); ``ssvep_cca`` on 200 x 8 x 1000
   at 250 Hz with planted stimulus frequencies (``:731-737``); ``csd`` on
   64 x 120,000 (``:898-907``); ``tf_decode`` on 24 + 24 x 8 x 30 x 256
   (``:935-942``); ``xdawn`` on 32 x 100,000, 200 events with a planted
   response (``:945-958``).
53. Each result against the port's own CPU run of the same input (tied to
   JAX by ``tests/test_torch_*.py``): FastICA on 6 x 25,000 mixed sources
   well apart in non-Gaussianity from the card's draw
   (``_fastica_from_w0``), converged below 5e-6 on both, at 1e-4; values at 1e-5 of the max (the ASR output of max|x|, on
   the samples only agreeing windows cover, at least 95% of the windows
   agreeing); filters and patterns at the eigenvector gate (1e-5 + 1e-6 x
   max|lam| / gap, xDAWN up to sign); the autoreject grid within 2 ulps
   and its decisions equal; the AUCs by the near-tie rule of
   ``tests/test_torch_riemann_decoding.py``; SSVEP labels equal where the
   winner leads by 1e-5.  Known answers: the planted bad channels, SSD's
   top pattern on channel 0, CSP AUC above 0.95, the covariance decoders
   above 0.95, the planted trials dropped, the TRF kernel recovered (r >
   0.99), SSVEP accuracy above 0.9, CSD blind to a reference shift,
   xDAWN's top ratio 3x the next, ASR shrinking the bursts 4x.
54. The adapter chain over a 64-EEG + EOG recording, 250,000 samples at
   250 Hz (``sensor_recording``: a flat and a noisy electrode, blinks
   mixed into frontal channels, eight bursts, a stimulus driving central
   channels, events every 2.1 s whose code 2 adds an 11 Hz burst 0.2-0.6
   s after onset on posterior channels): ``find_bad_channels``,
   ``interpolate_bads``, ``ica(n_components=20)``, ``ica_find_bads(ref=
   "EOG")``, ``ica_clean``, ``asr_clean``, ``trf``, ``epochs`` (512
   samples), ``regress_out(["EOG"]).drop_bad()``, ``split``, ``decode``
   (100 rows, decim 1) and ``decode_generalization`` (K4 "power_each"
   twice each), ``csp_decode``, ``riemann_decode`` (tangent and MDM, on
   the 64 channels and on 4 GED components), ``ged``, ``ssd``,
   ``spatial_epochs(ged).power_all`` (K1 "power" once); nothing else may
   launch; each timed as in 52.  Known answers: the two planted bad
   channels and no other EEG channel, the blink's |r| with the EOG on the
   frontal channels falling below 0.3 of its value, the bursts halved,
   TRF r above 0.3 on the driven channels and below 0.15 elsewhere, the
   AUC peak in 9-13 Hz and 0.2-0.6 s, the diagonal of the generalization
   matrix peaking there, CSP above 0.8, the GED components' Riemannian
   decoders above 0.6, SSD's top pattern on the posterior channels.  Then
   the serving data split 100 / 100 through ``decode`` (5.2 GB of planes a
   class; K4 twice; its peak printed; noise AUC mean 0.5 +- 0.02).

Slice 13, the last seven modules (``slice13_phase``; plain torch, every
product in ``fp32_matmul("exact")``, no kernel of its own), at the JAX
bench's shapes (``benchmarks/extensions_bench.py``):

55. Each call timed as in 52, TF32 allowed and not identical (NaN equal to
   NaN), no kernel launched: ``microstate_fit`` on 64 x 120,000, K 4, 8
   restarts, 40 steps (``:588-596``), and its per-step batched ``eigh`` of
   32 64 x 64 scatters alone by CUDA events; ``sphere_leadfield`` of 64
   electrodes over the 6 mm grid, 200 terms (``:615-629``);
   ``sample_entropy`` and ``permutation_entropy`` on 16 x 8 x 2048
   (``:657-668``); ``detect_spindles`` on 8 x 921,600 at 256 Hz, kmax 1024
   (``:690-696``; a 13 Hz spindle planted every 60 s); ``jackknife_onsets``
   on 64 x 64 x 1024 over (100, 900) (``:697-703``); ``dfa`` on 64 x
   65,536 (``:705-711``); ``lcmv`` with 5000 sources and 64 channels
   (``:723-729``); ``fit_dipole`` and ``fit_dipole_meg`` on 64 sensors
   (``:800-823``; the median of 1 after the warm-ups);
   ``detect_slow_oscillations`` on 8 x 30 min at 128 Hz (``:825-836``; a
   0.8 Hz wave planted every 20 s); ``microstate_syntax_test`` with 500
   shuffles (``:837-847``, host numpy); ``iaaft_surrogates`` with 19
   surrogates, 100 iterations, N = 4096 (``:911-917``; a random walk); a
   free-orientation ``lcmv`` over the 6 mm grid and ``dics`` at 10 Hz on a
   ``wavelet_csd`` of 16 x 64 x 2048 with a planted 10 Hz dipole.
56. Each result against the port's own CPU run (tied to JAX by
   ``tests/test_torch_*.py``) at those tests' gates: values at 1e-5 of the
   max; microstates on a planted 64 x 12,000 recording from the card's
   draws (``_fit_from_idx``), labels equal, maps up to sign; event tables
   and jackknife onsets equal except at decisions within 1e-5 of their
   threshold; dipole fits on the same grid point, 1 um and 1e-4 of the
   moment apart (the moment follows the position); free orientations up
   to sign (1e-4); the beamformers' solves at 1e-5 or their float32
   bound, 2 x the loaded matrix's condition x 2^-24, where larger; IAAFT's first
   iteration from the card's shuffles equal except at rank near-ties, its
   100-iteration spectra within 1.1 x the CPU's error.  Known answers: the
   planted dipole within 1 mm at GOF above 0.99 (EEG and MEG), the NAI
   peaks of LCMV and DICS on the planted source, every planted spindle and
   slow wave found (and nothing else), none in pure noise, the four
   planted microstate maps at |r| above 0.95, IAAFT's sorted values
   exact, DFA alpha 0.5 +- 0.1 for white noise and 1.5 +- 0.15 for its
   cumsum, white-noise SampEn about 2.2 and PE about 1.
57. The adapter chain: the serving data with an evoked response (a dipole
   at (0.03, 0.02, 0.05) on a 64-electrode cap, a Gaussian wave 0.3 s
   after the event) through ``EpochsWavelet.evoked``, ``erp_peak``,
   ``erp_onset``, the three entropies and ``fit_dipole``; a 64-channel 20
   min sleep recording at 256 Hz (planted microstates, spindles on
   channels 0-7, slow waves on 8-15) through ``RawWavelet.dfa`` (window
   12,000, whose extended window of 16,384 reaches K4: "power_each" once
   per window batch, the envelope against the plain stream at 1e-5),
   ``spindles``, ``slow_oscillations`` and ``microstates``; nothing else
   may launch; each timed as in 52.  Known answers: the evoked peak
   within 5 ms of 0.3 s, the jackknife onset within 10 ms of the wave's
   half-peak, the fitted dipole within 5 mm at GOF above 0.9, every
   planted event found.

Slice 14, the file formats, the pipeline config and the utilities
(``slice14_phase``; no kernel of its own):

58. Writes the slice-3 recording (64 x 600,000 at 1 kHz) with the port's
   ``io.write_bdf`` beside a BioSemi ``Status`` channel carrying 200
   planted triggers, and drives ``RawWavelet.from_bdf(path, picks=<the
   64>, window=11524, batch=8).power`` on 100 rows (2-100 Hz): "power_each"
   (K4) must launch once per window batch (7) and nothing else, the plane
   must equal the in-memory ``RawWavelet`` over ``BDFReader.get_data()``
   within 1e-5 of the max, ``status_events`` must return the planted
   triggers exactly, and the 24-bit round trip must stay within 2^-23 of
   the max.  Then the same recording through ``io.write_brainvision``
   with 200 "S  1" / "S  2" markers every 2.5 s and
   ``RawWavelet.from_brainvision(...).power``, under the same checks.  Each
   call is timed (median of 5) beside its window gathers alone.
59. ``epochs_from_markers(-0.5, 1.547, description="S  1")``: 100 epochs
   of 2048 samples, whose ``power_all`` / ``itc_all`` on 100 Morse rows
   must launch K1 and K2 once each; the windows must equal
   ``RawWavelet.epochs`` over the in-memory array at the same events, and
   the planes its planes and the plain path's under the gates of 4;
   ``split()`` must partition by marker description.
60. ``config.run_pipeline`` at the serving width (200 x 64 x 2048, 1-100
   Hz, ``Morse(interpolate=True)``) with every stage: the (0, 0.2) s
   baseline, significance at 0.95, the global spectrum, the ridge,
   synchrosqueezing, superlets (orders 1-4), PLV and coherence matrices
   over 0.5-1.5 s and specparam; K2 "power_itc", K5a and K5b must launch
   once each and K4 (the superlet orders) at least once, and neither
   separate reduction.  The cluster stage (one-sample, 256 permutations,
   a ring adjacency) runs in a second call on 32 channels: its planes,
   z-scores and null maps at 64 channels exceed the card's 80 GB.  Each
   output against the port's own pieces: power and ITC against the plain
   path at the gates of 4; the significance mask against the plain
   power's except at cells within the power gate of the threshold;
   synchrosqueezing against the plain path at the gates of 17; superlets
   on 4 channels against the plain superlet (1e-4); the matrices and the
   ridge (4 channels, of the K2 power) identical to the functions called
   directly; the global spectrum against the plain power's (1e-5);
   specparam's model within 1e-6 of a direct fit; the cluster result
   identical to ``cluster_test_one_sample`` of the K4 planes, which match
   the plain planes (1e-5).  Prints the launches by key, the total and
   each stage's time (logged by ``run_pipeline`` through
   ``utils.observability.Timer``, the card synchronized at each stage's
   end) and the peak memory.

Slice 15, the multi-device layer (``multigpu_phase``; no kernel of its own,
each rank runs the kernels on its block; ``parallel.collectives`` is the one
module that knows the backend):

61. The fused kernel's epoch-sums entry (``ninw_fused_cwt_sums``, behind
   ``ops.fused._itc_sums`` / ``_power_itc_sums``, which the sharded ITC
   adds across ranks before it takes |.|) against the plain sums at every
   N from 256 to 16384, both ``interpolate`` settings and a complex
   (MexicanHat) bank, E = 19: the power sums at 1e-5 of the max, the
   unit-phase sums at 1e-4 E on the cells where every epoch's |c| is at
   least 1e-2 of its row max, the ITC they finish to under the complex
   banks' witness rules of slice 6; the "itc" epilogue's sums alike.
62. NCCL, one rank, in this process: a (1, 1, 1) mesh, and every
   ``sharded_*``, ``distributed_*`` and ``chunked_*`` function and
   ``EpochsWavelet.cluster_test(mesh=)`` at a small size (8 x 4 x 1024,
   16 rows; planes 32 x 20 x 256, 256 permutations) against its
   single-device twin: values at 1e-5 of the max (1e-4 for the pair
   statistics and the gradient, 1e-3 for Granger, the HMM and FastICA),
   the cluster results bit for bit.  K1, K2 (complex bank), K4 and K6 must
   launch.  The group is destroyed after.
63. Gloo, four ranks that share the card (``run_on_mesh``, spawned, every
   collective timed out after 300 s): the serving workload at full width
   (200 x 64 x 2048, 100 Morse rows) on the (4, 1, 1) and (2, 2, 1)
   meshes through ``sharded_fused_mean_power`` / ``_itc`` /
   ``_power_itc`` (real bank, ``interpolate=True``, and the MexicanHat
   complex bank), ``distributed_mean_power`` / ``_itc`` and
   ``sharded_fused_coherence`` / ``_phase_lag`` on slice 5's 64 pairs,
   then ``chunked_power_auto`` of the 64-channel recording's first
   4 x 11524 samples on (1, 1, 4), each window extended by the halo to
   16384 (K4).  The counters are zeroed before and read after that main
   path on every rank; every rank must have launched K1, K2 (real and
   complex), K6 and K4.  Each rank's blocks against the single-device
   port on the same rows (the kernels, under the gates of 4 and 21; K4's
   block against the plain transform of its extended window at 1e-5);
   then the statistics and decoders of 62 on (4, 1, 1) (TF decoding also
   on (2, 2, 1)), rank 0 holding them against one device.  Prints each
   rank's launches and ``collectives.staged`` (the halo exchange's
   point-to-point sends pass through host memory under gloo), each call's
   wall time between barriers (its second call) beside the card's name
   and power limit.  A rank that fails or hangs fails the run.

The epoch reductions at N not a power of two (``czt_phase``; the chirp-z
kernel, ``csrc/fused_czt.cu``, and the benchmark cell
``eeg64_mne_epochs.mne_2001``):

64. Drives ``EpochsWavelet.power_all``, ``itc_all`` and ``power_itc_all``
   at the cell's shape, 200 x 64 x 2001 samples (MNE's -0.5..1.5 s at
   1 kHz, both ends kept; the headline data's first 2001 samples), 100
   Morse rows, the default ``interpolate=False``; the counters are zeroed
   just before and read just after: "power_czt", "itc_czt" and
   "power_itc_czt" once each, no other kernel.  Holds the results against
   the plain N-point route on the same tensors (``mean_power_from_bank``,
   ``itc_from_bank``, ``power_itc_from_bank``) at the cell's limits: the
   power within 1e-4 of each row's peak, the coherence within 0.006, NaN
   masks equal.  Phase-locked 60 Hz epochs of 2001 samples peak at the
   60 Hz row with ITC > 0.99 there.
65. The wrapper ``kernels.fused_czt`` alone, its three epilogues, against
   the same plain route at N = 421, 1000, 1001, 2000 and 2047 (M = 1024,
   2048, 2048, 4096, 4096; bin N/2 of an even N read once), both
   ``interpolate`` settings, E = 19, 3 channels x 13 rows, at the limits
   of 64.
66. Times each epilogue's ``*_auto`` (its rFFT included) and the plain
   route at the cell's shape as 6 does, beside two bounds: two M-point
   transforms a row (M = 4096), and the cell's N-point count; the
   ``fused_czt[<epilogue>]`` records carry both.

"power_each" at N = 32768 (``each_split_phase``; the split kernel,
``fused_each_split_kernel`` in ``csrc/fused_cwt.cu``, and the benchmark
cell ``eeg64_recording.default_window``):

67. One window batch of the recording cell, 8 windows x 64 channels of
   32768 samples against 100 Morse rows (1-100 Hz, ``interpolate=False``),
   written through ``ops.fused._power_each_into`` into a NaN-filled
   (64, 100, 8 x 16384) plane at the kept columns [8192, 24576): one
   "power_each_split" launch and no other, every cell written, within
   1e-5 of the plain route's peak; then whole windows of (3, 2) x 13 rows
   at both ``interpolate`` settings, and the kept range moved one column
   down (an odd first column: the columns stored one by one), at that
   gate.
68. Times that batch into the plane (its FFT included) against the plain
   route (crop + paste) as 15 does, and the kernel alone by CUDA events,
   beside the bound: the ``fused_cwt[power_each_split]`` record.

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
#: The recording cell's extended window (RawWavelet's default 16384 and its
#: halos of 8192) and the columns it keeps: "power_each_split".
SPLIT_N, SPLIT_KEEP = 32768, (8192, 24576)
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
TF32_GATE = 1e-6
EVENT_N, EVENT_TMIN, EVENT_TMAX = 200, -0.5, 1.547   # 2048-sample windows
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12     # H100 SXM: fp32 non-tensor, HBM3
CZT_SOURCE = "ninwavelets_tpu_torch/csrc/fused_czt.cu"
#: MNE's epoch length for -0.5..1.5 s at 1 kHz (both ends kept), the lengths
#: the chirp-z sweep takes (M = 1024, 2048, 4096; even and odd N), and the
#: limits of the benchmark cell eeg64_mne_epochs.mne_2001: the power within
#: 1e-4 of each row's peak, the coherence within 0.006.
N_MNE = 2001
CZT_SWEEP = (421, 1000, 1001, 2000, 2047)
CZT_P_TOL, CZT_ITC_TOL = 1e-4, 0.006
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
    every N, "power_each" at 32768 (``fused_each_split_kernel``), and the
    chirp-z reductions (``fused_czt_kernel<EPI,LOG2M>``) at every M."""
    name, args, spilling = "?", [], []
    with open(lib[:-3] + ".log") as fh:
        for line in fh:
            m = re.search(r"entry function '(\S+)'", line)
            if m:
                k = re.search(r"(fused_(?:cwt|cwt_bwd|each|each_split|amax|"
                              r"ssq|pair|czt)_kernel)(?:I(.*?)EEv)?",
                              m.group(1))
                args = (re.findall(r"L[ib](\d+)E", k.group(2) + "E")
                        if k and k.group(2) else [])
                name = (m.group(1) if not k else k.group(1) if not args
                        else f"{k.group(1)}<" + ",".join(args) + ">")
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
    return (name == "fused_each_split_kernel"
            or name.startswith(("fused_each_kernel<", "fused_amax_kernel<",
                                "fused_czt_kernel<")))


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


def each_split_phase():
    """"power_each" at N = 32768 on the split kernel (steps 67-68): one
    window batch of the recording cell against the plain route, small
    batches at both ``interpolate`` settings and a kept range that starts
    at an odd column, then times; returns the ``fused_cwt[power_each_split]``
    kernel record."""
    import torch
    from ninwavelets_tpu_torch import kernels
    from ninwavelets_tpu_torch.ops import cwt, fused

    n, (lo, hi) = SPLIT_N, SPLIT_KEEP
    width = hi - lo
    freqs = np.linspace(1.0, 100.0, REC_F)
    gen = np.random.default_rng(67)
    x = torch.from_numpy(gen.standard_normal((REC_BATCH, REC_C, n),
                                             dtype=np.float32)).cuda()
    bank = morse_bank(freqs, n, False)
    plane = torch.full((REC_C, REC_F, REC_BATCH * width), math.nan,
                       device="cuda")
    dst = plane.unflatten(-1, (REC_BATCH, width)).permute(2, 0, 1, 3)

    # -- one window batch of the recording cell into a NaN-filled plane ------
    torch.cuda.synchronize()
    kernels.reset_launches()
    fused._power_each_into(x, bank, False, dst, SPLIT_KEEP)
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    print(f"split main path: one ({REC_BATCH}, {REC_C}, {n}) window batch x "
          f"{REC_F} rows, keep {SPLIT_KEEP}; launches {counts}")
    check(counts["power_each_split"] == 1 and sum(counts.values()) == 1,
          f"the split batch launched {counts}, not one 'power_each_split'")
    err = rel_err("K4 split window batch, interiors written into a (C, F, "
                  "batch x window) plane", dst, cwt.power_from_bank(
                      x, bank, False)[..., lo:hi])
    torch.cuda.empty_cache()
    for interp in (False, True):
        xs = torch.from_numpy(gen.standard_normal(
            (3, 2, n), dtype=np.float32)).cuda()
        bs = morse_bank(freqs[:F_RAGGED], n, interp)
        ref = cwt.power_from_bank(xs, bs, interp)
        err = max(err, rel_err(
            f"K4 split N={n} interpolate={interp} (3, 2) x {F_RAGGED}, "
            "whole windows", fused.fused_power_from_bank(xs, bs, interp),
            ref))
        odd = torch.full((3, 2, F_RAGGED, width), math.nan, device="cuda")
        fused._power_each_into(xs, bs, interp, odd, (lo - 1, hi - 1))
        err = max(err, rel_err(
            f"K4 split N={n} interpolate={interp}, keep ({lo - 1}, "
            f"{hi - 1}) (columns stored one by one)", odd,
            ref[..., lo - 1:hi - 1]))
    del ref, odd, xs
    torch.cuda.empty_cache()

    # -- times ----------------------------------------------------------------
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())

    def plain_into():
        dst.copy_(cwt.power_from_bank(x, bank, False)[..., lo:hi])

    ms, plain_ms = median_ms(x, [
        lambda: fused._power_each_into(x, bank, False, dst, SPLIT_KEEP),
        plain_into])
    spec = torch.fft.fft(x.reshape(-1, 1, n)).contiguous()
    kernel_ms = event_ms(lambda: kernels.fused_power_each(
        spec, bank, n, dst, SPLIT_KEEP))
    print(f"time one window batch {tuple(x.shape)} x {REC_F} rows into the "
          f"plane, keep {SPLIT_KEEP}: split path (FFT + kernel) {ms} ms, "
          f"plain (torch.fft, crop + paste) {plain_ms} ms; the kernel alone "
          f"{kernel_ms} ms (CUDA events, mean of {REPS})")
    del spec, plane, dst, x
    torch.cuda.empty_cache()
    b = REC_BATCH * REC_C
    bound_ms, bound_by = bound(
        b * (fft_flops(n) / 2 + REC_F * fft_flops(n)),
        4 * (b * n + REC_F * n + b * REC_F * width))
    return {"name": "fused_cwt[power_each_split]", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": EACH_REPLACES,
            "launches": counts["power_each_split"], "max_abs_err": err,
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


def row_err(name, got, ref, gate=CZT_P_TOL):
    """max over rows of max|d| / max|ref| along the row, failing above
    ``gate``, as the benchmark's comparison (``gpubench/compare.py``) reads
    it: a row whose reference is all zero (its power below float32's
    range) must be zero too; returns max|d|."""
    import torch
    check(got.shape == ref.shape, f"{name}: shape {tuple(got.shape)} != "
          f"{tuple(ref.shape)}")
    check(bool(got.isfinite().all()), f"{name}: non-finite values")
    d = (got.double() - ref.double()).abs().amax(-1)
    peak = ref.double().abs().amax(-1)
    rel = torch.where(peak > 0, d / peak.clamp_min(1e-300),
                      torch.where(d > 0, math.inf, 0.0)).max().item()
    d = d.max()
    print(f"check {name}: max|d| {d.max().item()}, max over rows of max|d| "
          f"/ the row's peak {rel} (gate {gate})")
    check(rel <= gate, f"{name}: row err {rel} > {gate}")
    return d.max().item()


def abs_err(name, got, ref, gate=CZT_ITC_TOL):
    """max|d| of a coherence plane, NaN masks equal, failing above
    ``gate``."""
    import torch
    check(got.shape == ref.shape, f"{name}: shape {tuple(got.shape)} != "
          f"{tuple(ref.shape)}")
    check(torch.equal(got.isnan(), ref.isnan()), f"{name}: NaN masks differ")
    err = (got - ref).nan_to_num().abs().max().item()
    print(f"check {name}: max|d| {err} (gate {gate})")
    check(err <= gate, f"{name}: ITC err {err} > {gate}")
    return err


def czt_phase(data):
    """The three epoch reductions at N not a power of two, on the chirp-z
    kernel (steps 64-66): the main path at the benchmark cell's shape, the
    kernel against the plain N-point route there and at one N per M, and
    times; returns the three ``fused_czt`` kernel records."""
    import torch
    import ninwavelets_tpu_torch as nt
    from ninwavelets_tpu_torch import kernels
    from ninwavelets_tpu_torch.ops import cwt, fused

    freqs = np.arange(1.0, F + 1.0)
    czt_keys = tuple(f"{e}_czt" for e in kernels.CZT_EPILOGUES)
    epochs = np.ascontiguousarray(data[..., :N_MNE])

    # -- the main path: the cell's shape through the public entry points -----
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    ew = nt.EpochsWavelet(nt.ArrayEpochs(epochs, SFREQ),
                          nt.Morse(SFREQ, device="cuda"))   # interpolate=False
    power = ew.power_all(freqs)
    itc = ew.itc_all(freqs)
    pi_power, pi_itc = ew.power_itc_all(freqs)
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    print(f"chirp-z main path {time.perf_counter() - t0} s (E={E} C={C} "
          f"N={N_MNE} F={F}, Morse interpolate=False: power_all, itc_all, "
          f"power_itc_all; first calls included); launches {counts}")
    for key in czt_keys:
        check(counts[key] == 1, f"{key!r} launched {counts[key]} times on "
              "the chirp-z main path, not once")
    others = {k: v for k, v in counts.items() if k not in czt_keys and v}
    check(not others, f"other kernels launched on the chirp-z main path: "
          f"{others}")

    # -- the kernel against the plain N-point route, same tensors -------------
    x = ew._all_data()
    bank = ew._bank_for(x, freqs)
    ref_power = cwt.mean_power_from_bank(x, bank, False)
    ref_itc = cwt.itc_from_bank(x, bank, False)
    err = {"power": row_err(f"czt power_all N={N_MNE}", power, ref_power),
           "itc": abs_err(f"czt itc_all N={N_MNE}", itc, ref_itc)}
    one_power, one_itc = cwt.power_itc_from_bank(x, bank, False)
    err["power_itc"] = max(
        row_err(f"czt power_itc_all power N={N_MNE}", pi_power, one_power),
        abs_err(f"czt power_itc_all itc N={N_MNE}", pi_itc, one_itc))
    del power, itc, pi_power, pi_itc, ref_power, ref_itc, one_power, one_itc

    # -- a known answer: phase-locked 60 Hz epochs ----------------------------
    ew_tone = nt.EpochsWavelet(
        nt.ArrayEpochs(tone_epochs(8, 2, N_MNE), SFREQ),
        nt.Morse(SFREQ, device="cuda"))
    p_tone, itc_tone = ew_tone.power_itc_all(freqs)
    peak = int(p_tone.mean(-1).argmax(-1)[0]) + 1
    itc60 = float(itc_tone[:, 59, N_MNE // 4:3 * N_MNE // 4].min())
    print(f"check chirp-z 60 Hz tone N={N_MNE}: power peak at {peak} Hz, "
          f"min ITC at 60 Hz {itc60}")
    check(peak == 60, f"chirp-z 60 Hz tone peaks at {peak} Hz")
    check(itc60 > 0.99, f"chirp-z 60 Hz tone ITC {itc60} <= 0.99")

    # -- the wrapper alone at one N per M, both settings ----------------------
    gen = np.random.default_rng(13)
    for n in CZT_SWEEP:
        for interp in (True, False):
            xs = torch.from_numpy(gen.standard_normal(
                (E_RAGGED, 3, n), dtype=np.float32)).cuda()
            bs = morse_bank(freqs[:F_RAGGED], n, interp)
            spec = torch.fft.rfft(xs).contiguous()
            k_bins = n // 2 if interp else n
            tag = (f"N={n} M={kernels.czt_size(n)} interpolate={interp} "
                   f"({E_RAGGED}, 3) x {F_RAGGED}")
            rp = cwt.mean_power_from_bank(xs, bs, interp)
            ri = cwt.itc_from_bank(xs, bs, interp)
            row_err(f"czt power {tag}",
                    kernels.fused_czt("power", spec, bs, k_bins)[0], rp)
            abs_err(f"czt itc {tag}",
                    kernels.fused_czt("itc", spec, bs, k_bins)[0], ri)
            gp, gi = kernels.fused_czt("power_itc", spec, bs, k_bins)
            op, oi = cwt.power_itc_from_bank(xs, bs, interp)
            row_err(f"czt power_itc power {tag}", gp, op)
            abs_err(f"czt power_itc itc {tag}", gi, oi)

    # -- times at the cell's shape --------------------------------------------
    print(card_line())
    x = x.clone()
    pairs = {
        "power": (lambda: fused.mean_power_auto(x, bank),
                  lambda: cwt.mean_power_from_bank(x, bank, False)),
        "itc": (lambda: fused.itc_auto(x, bank),
                lambda: cwt.itc_from_bank(x, bank, False)),
        "power_itc": (lambda: fused.power_itc_auto(x, bank),
                      lambda: cwt.power_itc_from_bank(x, bank, False)),
    }
    m = kernels.czt_size(N_MNE)
    rfft = E * C * fft_flops(N_MNE) / 2
    records = []
    for epilogue, (kern, plain) in pairs.items():
        ms, plain_ms = median_ms(x, [kern, plain])
        n_out = 2 if epilogue == "power_itc" else 1
        nbytes = (4 * (E * C * N_MNE + F * N_MNE + n_out * C * F * N_MNE)
                  + 8 * (N_MNE + m))
        bound_ms, bound_by = bound(rfft + E * C * F * 2 * fft_flops(m),
                                   nbytes)
        bound_n, _ = bound(rfft + E * C * F * fft_flops(N_MNE), nbytes)
        print(f"time {epilogue} chirp-z (E={E} C={C} N={N_MNE} M={m} F={F}, "
              f"interpolate=False; the auto with its rFFT): kernel {ms} ms, "
              f"plain torch.fft {plain_ms} ms; bound {bound_ms} ms "
              f"({bound_by}; two M-point transforms a row), {bound_n} ms by "
              f"the N-point count")
        records.append({
            "name": f"fused_czt[{epilogue}]", "route": "cuda",
            "source": CZT_SOURCE, "replaces": None,
            "launches": counts[f"{epilogue}_czt"],
            "max_abs_err": err[epilogue], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_ms_n_point": bound_n, "library_ms": None,
            "interpolate": False, "n": N_MNE, "m": m})
    del x, bank, pairs
    torch.cuda.empty_cache()
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
    # What scattering's "auto" asks of each bank.
    scat_fused = fused.route("power_each", (1, 1, N), bank,
                             device=a.device).launch
    print(f"check complex bank elsewhere (power_auto, the five pair autos, "
          f"StreamingCWT): launches {counts}; streaming fused "
          f"{stream._fused}, supports_ssq {takes_ssq}, scattering fused "
          f"{scat_fused}")
    check(not counts and not stream._fused and not takes_ssq
          and not scat_fused, "a complex bank reached K4/K5/K6")
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


def plain_superlet(x, freqs, order_max=8, interpolate=False):
    """The superlet epoch-mean power the plain way, from the public pieces:
    each epoch's weighted geometric mean of the plain member powers (orders
    1 to ``order_max``), then the mean over epochs."""
    import torch
    from ninwavelets_tpu_torch.ops import cwt
    from ninwavelets_tpu_torch.ops.superlets import (superlet_banks,
                                                     superlet_weights)
    banks = superlet_banks(freqs, x.shape[-1], SFREQ, order_max=order_max,
                           interpolate=interpolate, device=x.device)
    w = torch.from_numpy(superlet_weights(
        freqs, order_max=order_max)).to(x.device)[:, :, None]
    logs = sum(w_k * torch.log(torch.clamp(
        cwt.power_from_bank(x, b, interpolate), min=1e-30))
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


# -- slice 7: the rest of connectivity ----------------------------------------

def tf32_same(name, fn, gate=TF32_GATE):
    """``fn()`` under the float32 matmul precision "high" (TF32 allowed) and
    "highest": every tensor of the two results equal within ``gate`` x its
    max (NaN masks equal; ``gate`` 0 asks for identical values), since
    ``fp32_matmul`` guards every product of the slice; and each call leaves
    the setting it found.  Returns the "highest" result."""
    import torch
    prev = torch.get_float32_matmul_precision()
    outs = []
    for setting in ("high", "highest"):
        torch.set_float32_matmul_precision(setting)
        try:
            out = fn()
            torch.cuda.synchronize()
            after = torch.get_float32_matmul_precision()
        finally:
            torch.set_float32_matmul_precision(prev)
        check(after == setting, f"{name}: the matmul precision {setting!r} "
              f"came back as {after!r}")
        outs.append(out if isinstance(out, tuple) else (out,))
    worst = 0.0
    for a, b in zip(*outs):
        check(torch.equal(a.isnan(), b.isnan()),
              f"{name}: NaN masks differ with TF32 on and off")
        d = (a - b).abs().nan_to_num().max().item()
        scale = b.abs().nan_to_num().max().item()
        worst = max(worst, d / scale if scale else d)
    print(f"check {name} TF32 on / off: max|d| / max {worst} "
          f"(gate {gate})")
    check(worst <= gate, f"{name}: TF32 on / off differ by {worst}")
    return outs[1] if len(outs[1]) > 1 else outs[1][0]


def rest_path(name, fn, x, card, shape=None, gate=TF32_GATE):
    """One slice 7 or 8 path: the TF32 check (at ``gate``), finiteness (and
    ``shape``) of every output, and its time (median of REPS after a
    warm-up, fresh values in ``x`` before each run), printed with the card.
    Returns the output."""
    out = tf32_same(name, fn, gate)
    for o in out if isinstance(out, tuple) else (out,):
        check(bool(o.isfinite().all()), f"{name}: non-finite values")
    if shape is not None:
        got = tuple((out[0] if isinstance(out, tuple) else out).shape)
        check(got == shape, f"{name}: shape {got} != {shape}")
    ms = host_ms(lambda _: fn(), lambda: x.normal_())
    print(f"time {name}: {ms} ms on {card}")
    return out


def chain_epochs(e, n, seed=0):
    """x1 = z, x2 = z + e2, x3 = x2 + e3: the JAX tests' mediated chain."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((e, n))
    e2 = 0.5 * rng.standard_normal((e, n))
    e3 = 0.5 * rng.standard_normal((e, n))
    return np.stack([z, z + e2, z + e2 + e3], axis=1).astype(np.float32)


def delayed_epochs(e, n, delay=8, seed=0):
    """ch0 leads ch1 by ``delay`` samples; ch2 independent; 0.2 noise."""
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((e, n + delay))
    x = np.stack([s[:, delay:], s[:, :n], rng.standard_normal((e, n))],
                 axis=1)
    x += 0.2 * rng.standard_normal(x.shape)
    return x.astype(np.float32)


def harmonic_epochs(locked, e=20, n=2048, seed=0):
    """10 Hz on a, 20 Hz on b at twice a's phase (locked) or not."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SFREQ
    a = np.empty((e, n), np.float32)
    b = np.empty((e, n), np.float32)
    for i in range(e):
        pa = rng.uniform(0, 2 * np.pi)
        pb = 2 * pa + 0.7 if locked else rng.uniform(0, 2 * np.pi)
        a[i] = np.sin(2 * np.pi * 10 * t + pa) + 0.2 * rng.standard_normal(n)
        b[i] = np.sin(2 * np.pi * 20 * t + pb) + 0.2 * rng.standard_normal(n)
    return a, b


def rest_known_answers():
    """The JAX tests' known answers, on the card at their own sizes."""
    import torch
    import ninwavelets_tpu_torch as nt
    from ninwavelets_tpu_torch.ops import connectivity as conn
    from ninwavelets_tpu_torch.ops import extensions as ext

    def bank(freqs, n, interpolate=True, sfreq=SFREQ):
        return nt.ops.make_fft_bank(nt.Morse(sfreq, device="cuda")._wdef(),
                                    np.asarray(freqs, np.float32), n, sfreq,
                                    interpolate, device="cuda")

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).cuda()

    x = dev(chain_epochs(24, 2048))
    b = bank(np.arange(16.0, 64.0, 6.0), 2048, False)
    pc = conn.partial_coherence(x, b).mean(0)
    coh = conn.coherence_matrix(x, b).mean(0)
    print(f"check mediated chain: coherence(1, 3) {coh[0, 2].item()}, "
          f"partial coherence(1, 3) {pc[0, 2].item()} (gate < 0.1), "
          f"(1, 2) {pc[0, 1].item()}, (2, 3) {pc[1, 2].item()}")
    check(coh[0, 2].item() > 0.5 and pc[0, 2].item() < 0.1
          and pc[0, 1].item() > 20 * pc[0, 2].item()
          and pc[1, 2].item() > 20 * pc[0, 2].item(), "mediated chain")

    z = conn.psi_matrix(dev(delayed_epochs(16, 2048)),
                        bank(np.arange(16.0, 80.0, 4.0), 2048, False))
    anti = (z + z.T).abs().max().item()
    print(f"check delayed pair PSI: z[0, 1] {z[0, 1].item()} (> 2), z[1, 0] "
          f"{z[1, 0].item()} (< -2), max|z + z^T| {anti} (gate 1e-5 max|z| "
          f"+ 1e-4), diagonal {z.diagonal().tolist()} (exactly 0)")
    check(z[0, 1].item() > 2 and z[1, 0].item() < -2
          and abs(z[0, 2].item()) < 4 and abs(z[1, 2].item()) < 4,
          "delayed pair PSI direction")
    check(anti <= 1e-5 * z.abs().max().item() + 1e-4
          and bool((z.diagonal() == 0).all()), "PSI antisymmetry / diagonal")

    rng = np.random.default_rng(5)
    t = np.arange(1024) / SFREQ
    locked = (np.sin(2 * np.pi * 40 * t + rng.uniform(0, 2 * np.pi,
                                                      (6, 1, 1)))
              + 0.1 * rng.standard_normal((6, 5, 1024))).astype(np.float32)
    r = conn.kuramoto_order(dev(locked), bank([40.0], 1024))[0, 200:-200]
    print(f"check Kuramoto order of 5 locked channels: min {r.min().item()} "
          "(gate > 0.95)")
    check(r.min().item() > 0.95, "Kuramoto order of locked channels")

    fa = np.array([8.0, 10.0, 12.0])
    ba, bb = bank(fa, 2048), bank(2 * fa, 2048)
    a, b_ = (dev(v) for v in harmonic_epochs(True))
    a0, b0 = (dev(v) for v in harmonic_epochs(False, seed=3))
    v21 = conn.nm_plv(a, b_, ba, bb, 2, 1, True)[1, 400:-400].mean().item()
    v11 = conn.nm_plv(a, b_, ba, ba, 1, 1, True)[1, 400:-400].mean().item()
    v0 = conn.nm_plv(a0, b0, ba, bb, 2, 1, True)[1, 400:-400].mean().item()
    print(f"check harmonic lock: 2:1 {v21} (> 0.85), 1:1 {v11} (< 0.4), "
          f"unlocked 2:1 {v0} (< 0.45)")
    check(v21 > 0.85 and v11 < 0.4 and v0 < 0.45, "n:m harmonic lock")

    sf = 250.0
    t = np.arange(1024) / sf
    planted = (np.sin(2 * np.pi * 8.0 * t)
               + (1 + 0.8 * np.sin(2 * np.pi * 8.0 * t)) * 0.5
               * np.sin(2 * np.pi * 50.0 * t)
               + 0.1 * np.random.default_rng(0).standard_normal((12, 1024))
               ).astype(np.float32)
    _, p = conn.pac_significance(dev(planted), bank([8.0], 1024, sfreq=sf),
                                 bank([50.0], 1024, sfreq=sf),
                                 interpolate=True, n_surrogates=199)
    print(f"check planted PAC: p {p.min().item()} (floor 1/200 = 0.005)")
    check(abs(p.min().item() - 1 / 200) < 1e-7, "planted PAC p off the floor")

    rng = np.random.default_rng(7)
    t = np.arange(1024) / SFREQ
    pa = rng.uniform(0, 2 * np.pi, 16)
    ca = (np.sin(2 * np.pi * 40 * t + pa[:, None])
          + 0.4 * rng.standard_normal((16, 1024))).astype(np.float32)
    cb = (np.sin(2 * np.pi * 40 * t + pa[:, None] + 1.0)
          + 0.4 * rng.standard_normal((16, 1024))).astype(np.float32)
    _, p = conn.plv_significance(dev(ca[:, None]), dev(cb[:, None]),
                                 bank(np.arange(30.0, 55.0, 8.0), 1024),
                                 interpolate=True, n_surrogates=99, seed=1)
    med = p[0, 1, 300:-300].median().item()
    print(f"check coupled pair: median p at 40 Hz {med} (gate <= 0.02)")
    check(med <= 0.02 + 1e-9, "coupled pair median p")

    rng = np.random.default_rng(0)
    t = np.arange(4096) / SFREQ
    rhythm = dev((np.sin(2 * np.pi * 20 * t)
                  + 0.3 * rng.standard_normal((4, 4096))).astype(np.float32))
    noise = dev(rng.standard_normal((4, 4096)).astype(np.float32))
    lr = conn.lagged_coherence_morse(rhythm, [20.0], SFREQ, pooled=True)
    ln = conn.lagged_coherence_morse(noise, [20.0], SFREQ, pooled=True)
    print(f"check lagged coherence at 20 Hz: rhythm {lr.item()}, noise "
          f"{ln.item()} (gates > 0.9, < 0.3)")
    check(lr.item() > 0.9 and ln.item() < 0.3, "lagged coherence")

    rng = np.random.default_rng(0)
    t = np.arange(1024) / SFREQ
    p1 = rng.uniform(0, 2 * np.pi, (8, 1, 1))
    p2 = rng.uniform(0, 2 * np.pi, (8, 1, 1))
    quad = dev((np.sin(2 * np.pi * 10 * t + p1)
                + np.sin(2 * np.pi * 25 * t + p2)
                + 0.5 * np.sin(2 * np.pi * 35 * t + p1 + p2)
                + 0.3 * rng.standard_normal((8, 1, 1024))).astype(np.float32))
    f1, f2 = np.array([6.0, 10.0, 14.0]), np.array([15.0, 25.0, 35.0])
    bic = ext.bicoherence(quad, bank(f1, 1024), bank(f2, 1024),
                          bank((f1[:, None] + f2[None]).ravel(), 1024),
                          True)[0]
    peak = divmod(int(bic.argmax()), 3)
    print(f"check bicoherence peak at rows {peak} (planted (10, 25) Hz: "
          f"(1, 1)), value {bic.max().item()}")
    check(peak == (1, 1), "bicoherence peak")

    rng = np.random.default_rng(1)
    shared = np.sin(2 * np.pi * 20 * np.arange(1024) / SFREQ)
    sa = dev((shared + 0.5 * rng.standard_normal(1024)).astype(np.float32))
    sb = dev((shared + 0.5 * rng.standard_normal(1024)).astype(np.float32))
    fw = np.arange(10.0, 40.0, 5.0)
    bw = bank(fw, 1024)
    wtc = ext.wavelet_coherence(sa, sb, bw, fw, SFREQ, True)
    thr = ext.wtc_significance(sa, sb, bw, fw, SFREQ, n_surrogates=50,
                               interpolate=True)
    above = (wtc[2] > thr[2]).float().mean().item()
    below = (wtc[5] > thr[5]).float().mean().item()
    print(f"check shared 20 Hz tone: share above its AR(1) level {above} "
          f"(gate > 0.9), uncoupled 35 Hz row {below} (gate < 0.35)")
    check(above > 0.9 and below < 0.35, "shared tone against the AR(1) level")


def connectivity_rest_phase(data):
    """Slice 7, the rest of connectivity at the JAX package's shapes: the
    matrices on 16 x 64 x 2048 through ``EpochsWavelet``, the coupling
    statistics on the serving data, rhythmicity on 16 x 65,536, the
    single-trial coherence on 64 pairs and on one pair of the slice 3
    recording; each path's TF32 check and time, the known answers, and
    K1's launch under ``wavelet_entropy``.  Plain torch only: nothing
    joins the kernels' record."""
    import torch
    import ninwavelets_tpu_torch as nt
    from ninwavelets_tpu_torch import kernels
    from ninwavelets_tpu_torch.ops import connectivity as conn
    from ninwavelets_tpu_torch.ops import envelope as env
    from ninwavelets_tpu_torch.ops import extensions as ext
    from ninwavelets_tpu_torch.ops import multitaper as mt

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    print(card)
    freqs = np.arange(1.0, F + 1.0)
    morse = nt.Morse(SFREQ, interpolate=True, device="cuda")

    def bank(fr, n=N):
        return nt.ops.make_fft_bank(morse._wdef(), np.asarray(fr, np.float32),
                                    n, SFREQ, True, device="cuda")

    # -- matrices: 16 x 64 x 2048, 100 rows, through EpochsWavelet ----------
    ew16 = nt.EpochsWavelet(nt.ArrayEpochs(data[:E_MATRIX], SFREQ), morse)
    x16 = ew16._all_data()
    mats = {
        "psi_matrix": (lambda: ew16.psi_matrix(freqs), (C, C)),
        "partial_coherence": (lambda: ew16.partial_coherence(freqs),
                              (F, C, C)),
        "multitaper_partial_coherence (3 tapers)": (
            lambda: ew16.multitaper_partial_coherence(freqs), (F, C, C)),
        "kuramoto_order": (lambda: ew16.kuramoto_order(freqs), (F, N)),
        "env_corr (orthogonalize)": (lambda: ew16.env_corr(freqs),
                                     (F, C, C)),
        "env_corr (plain)": (lambda: ew16.env_corr(
            freqs, orthogonalize=False), (F, C, C)),
    }
    out = {}
    for name, (fn, shape) in mats.items():
        out[name] = rest_path(f"{name} ({E_MATRIX} x {C} x {N} x {F})", fn,
                              x16, card, shape)
    x16.copy_(torch.from_numpy(data[:E_MATRIX]))
    z = ew16.psi_matrix(freqs)
    check(bool((z.diagonal() == 0).all()), "psi_matrix diagonal not 0")
    bank100 = bank(freqs)
    ref = conn.psi_matrix(x16, bank100, True)
    d = (z - ref).abs().max().item()
    print(f"check EpochsWavelet.psi_matrix = ops psi_matrix: max|d| {d} "
          "(gate 0: the same call)")
    check(d == 0, "adapter psi_matrix differs from ops")
    for name in ("partial_coherence", "multitaper_partial_coherence "
                 "(3 tapers)"):
        m = out[name]
        dev_ = (m.diagonal(dim1=1, dim2=2) - 1).abs().max().item()
        print(f"check {name} diagonal: max|d - 1| {dev_} (gate 1e-4)")
        check(dev_ <= 1e-4, f"{name} diagonal")
    check(bool((out["env_corr (orthogonalize)"].diagonal(dim1=1, dim2=2)
                == 0).all()), "orthogonalized env_corr diagonal not 0")
    del out, mats, ref
    torch.cuda.empty_cache()

    # -- coupling on the serving data ---------------------------------------
    # ``x0`` / ``a0`` keep the data for the adapter comparisons; ``x`` and
    # ``a1`` are the timing buffers that each timed run refills.
    x0 = torch.from_numpy(data).cuda()
    x, xb = x0.clone(), pair_b(x0)
    nm_f = np.arange(4.0, 36.0, 0.5)                       # 64 rows
    nm_a, nm_b = bank(nm_f), bank(2.0 * nm_f)
    rest_path(f"nm_plv 2:1 (E={E}, {C} pairs, {nm_f.size} rows, N={N})",
              lambda: conn.nm_plv(x, xb, nm_a, nm_b, 2, 1, True), x, card,
              (C, nm_f.size, N))
    ew = nt.EpochsWavelet(nt.ArrayEpochs(data, SFREQ), morse)
    a0, c1 = x0[:, 0].contiguous(), x0[:, 1].contiguous()
    got = ew.nm_plv("ch0", "ch1", nm_f[:8], n=2, m=1)
    ref = conn.nm_plv(a0, c1, bank(nm_f[:8]), bank(2 * nm_f[:8]), 2, 1, True)
    d = (got - ref).abs().max().item()
    print(f"check EpochsWavelet.nm_plv = ops nm_plv: max|d| {d} (gate 0)")
    check(d == 0, "adapter nm_plv differs from ops")

    a1 = a0.clone()
    b1 = (0.6 * torch.roll(a0, 5, -1) + 0.8 * c1).contiguous()
    s = 199
    obs, p = rest_path(f"plv_significance (one pair, E={E}, {F} rows, "
                       f"{s} surrogates)",
                       lambda: conn.plv_significance(a1, b1, bank100, True,
                                                     n_surrogates=s),
                       a1, card, (F, N))
    check(bool(((p >= 1 / (s + 1) - 1e-7) & (p <= 1)).all()),
          "plv_significance p outside [1/(S+1), 1]")
    rest_path(f"phase_lag_significance wpli (one pair, E={E}, {F} rows, "
              f"{s} surrogates)",
              lambda: conn.phase_lag_significance(a1, b1, bank100, "wpli",
                                                  True, n_surrogates=s),
              a1, card, (F, N))
    got = ew.plv_significance("ch0", "ch1", freqs[:10], n_surrogates=19)
    ref = conn.plv_significance(a0, c1, bank(freqs[:10]), True,
                                n_surrogates=19)
    check(all(torch.equal(u, v) for u, v in zip(got, ref)),
          "adapter plv_significance differs from ops")

    fp, fa = np.arange(4.0, 12.0), np.arange(40.0, 151.0, 5.0)
    bp, ba = bank(fp), bank(fa)
    for method in ("mvl", "tort"):
        rest_path(f"pac {method} (E={E}, C={C}, {fp.size} x {fa.size} rows)",
                  lambda: conn.pac(x, bp, ba, True, method,
                                   mean_epochs=True),
                  x, card, (C, fp.size, fa.size))
        got = ew.pac("ch0", fp, fa, method=method)
        ref = conn.pac(a0, bp, ba, True, method, mean_epochs=True)
        d = (got - ref).abs().max().item()
        print(f"check EpochsWavelet.pac {method} = ops pac: max|d| {d} "
              "(gate 0)")
        check(d == 0, f"adapter pac {method} differs from ops")
    rest_path(f"pac significance=199 mvl (one channel, E={E}, {fp.size} x "
              f"{fa.size} rows)",
              lambda: conn.pac_significance(a1, bp, ba, True,
                                            n_surrogates=199),
              a1, card, (fp.size, fa.size))
    got = ew.pac("ch0", fp[:2], fa[:2], significance=19)
    ref = conn.pac_significance(a0, bp[:2], ba[:2], True, n_surrogates=19)
    check(all(torch.equal(u, v) for u, v in zip(got, ref)),
          "adapter pac significance differs from ops")

    fe_p, fe_a = np.arange(4.0, 12.0), np.arange(40.0, 80.0, 5.0)
    be_p, be_a = bank(fe_p), bank(fe_a)
    rest_path(f"erpac (E={E}, 8 x 8 rows, N={N})",
              lambda: conn.erpac(a1, be_p, be_a, True), a1, card, (8, 8, N))
    d = (ew.erpac("ch0", fe_p, fe_a)
         - conn.erpac(a0, be_p, be_a, True)).abs().max().item()
    check(d == 0, f"adapter erpac differs from ops by {d}")

    f1, f2 = np.arange(4.0, 36.0, 2.0), np.arange(20.0, 84.0, 4.0)
    b1_, b2_ = bank(f1), bank(f2)
    b12 = bank((f1[:, None] + f2[None]).ravel())
    rest_path(f"bicoherence (E={E}, 16 x 16 rows, N={N})",
              lambda: ext.bicoherence(a1[:, None], b1_, b2_, b12, True)[0],
              a1, card, (16, 16))
    d = (ew.bicoherence("ch0", f1, f2) - ext.bicoherence(
        a0[:, None], b1_, b2_, b12, True)[0]).abs().max().item()
    check(d == 0, f"adapter bicoherence differs from ops by {d}")

    rest_path(f"cfd (E={E}, {fp.size} slow x {fa.size} fast rows)",
              lambda: ext.cfd(a1, bp, ba, interpolate=True), a1, card, (N,))
    d = (ew.cfd("ch0", fp, fa) - ext.cfd(a0, bp, ba, interpolate=True)
         ).abs().max().item()
    check(d == 0, f"adapter cfd differs from ops by {d}")

    kernels.reset_launches()
    h = ew.wavelet_entropy("ch0", freqs)
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    print(f"wavelet_entropy launches {counts}")
    check(counts["power"] == 1 and sum(counts.values()) == 1,
          f"wavelet_entropy launched {counts}")
    # The power's 1e-5 (of its column max) carried through
    # -sum_f p ln p / ln F: |dH| <= sum_f |dp_f| (1 + |ln p_f|) / ln F with
    # |dp_f| <= 2e-5 max_f P / sum_f P.
    pw = nt.ops.mean_power_from_bank(a0[:, None], ew.wavelet.fft_wavelets,
                                     True)[0]
    ref = ext.wavelet_entropy(pw)
    pn = pw / pw.sum(0)
    carried = (2 * POWER_RTOL * pw.amax(0) / pw.sum(0)
               * (1 + pn.clamp(min=1e-30).log().abs()).sum(0) / math.log(F))
    ratio = ((h - ref).abs() / carried).max().item()
    print(f"check wavelet_entropy through K1 against the plain power: "
          f"max|d| {(h - ref).abs().max().item()}, max|d| / carried power "
          f"tolerance {ratio} (gate 1)")
    check(ratio <= 1 and bool(((h >= 0) & (h <= 1 + 1e-5)).all()),
          "wavelet_entropy")
    # The user's call, checked and timed whole: the channel leaves the
    # adapter's host snapshot, which each run refills (before the clock
    # starts).
    name = f"EpochsWavelet.wavelet_entropy (one channel, E={E}, {F} rows, K1)"
    tf32_same(name, lambda: ew.wavelet_entropy("ch0", freqs))
    host = ew._host_data()
    refill = np.random.default_rng(5)
    ms = host_ms(lambda _: ew.wavelet_entropy("ch0", freqs),
                 lambda: host[:, 0].__setitem__(
                     slice(None), refill.standard_normal((E, N),
                                                         dtype=np.float32)))
    print(f"time {name}: {ms} ms on {card}")
    del x, x0, xb
    torch.cuda.empty_cache()

    # -- rhythmicity ----------------------------------------------------------
    lc_f = np.arange(2.0, 60.0, 1.0)
    xl = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (16, 65536), dtype=np.float32)).cuda()
    rest_path(f"lagged_coherence_morse (16 x 65536, {lc_f.size} rows)",
              lambda: conn.lagged_coherence_morse(xl, lc_f, SFREQ), xl, card,
              (16, lc_f.size))
    del xl
    torch.cuda.empty_cache()

    # -- single-trial coherence -----------------------------------------------
    wa = torch.from_numpy(data[0]).cuda()                   # 64 x 2048
    wb = (0.6 * wa + 0.8 * torch.roll(wa, 1, 0)).contiguous()
    rest_path(f"wavelet_coherence ({C} pairs x {N} x {F} rows)",
              lambda: ext.wavelet_coherence(wa, wb, bank100, freqs, SFREQ,
                                            True, return_phase=True),
              wa, card, (C, F, N))
    rest_path(f"wtc_significance (100 surrogates, N={N}, {F} rows)",
              lambda: ext.wtc_significance(wa[0], wb[0], bank100, freqs,
                                           SFREQ, interpolate=True),
              wa, card, (F,))
    print("RawWavelet.coherence runs without significance: the (S, F, N) "
          "surrogate stack of a 600,000-sample run is S x 240 MB in float32 "
          "(about 24 GB at S = 100), and wtc_significance says to size S "
          "for it")
    rec = recording(3)
    rf = np.linspace(2.0, 100.0, REC_F)
    rw = nt.RawWavelet(ArrayRaw(rec), nt.Morse(SFREQ, interpolate=True,
                                               device="cuda"))
    coh = tf32_same(f"RawWavelet.coherence (one pair, {REC_N} samples, "
                    f"{REC_F} rows)", lambda: rw.coherence(
                        "EEG000", "EEG001", rf))
    check(tuple(coh.shape) == (REC_F, REC_N)
          and bool(coh.isfinite().all()), "RawWavelet.coherence output")
    # The user's call, timed whole: its bank, the two channels' copies to
    # the card and the coherence; each run refills the two channels of the
    # adapter's host copy (before the clock starts).
    host = rw._host_data()
    ms = host_ms(lambda _: rw.coherence("EEG000", "EEG001", rf),
                 lambda: host[:2].__setitem__(
                     slice(None), refill.standard_normal((2, REC_N),
                                                         dtype=np.float32)))
    print(f"time RawWavelet.coherence (one pair, {REC_N} samples, {REC_F} "
          f"rows): {ms} ms on {card}")
    del coh, host, rec
    torch.cuda.empty_cache()

    rest_known_answers()


# -- slice 8: directed and network connectivity, the event-locked path --------

GC_FS = 200.0      # the sampling rate of the JAX tests' VAR systems


def var_epochs(coeffs, sig, e, n, seed):
    """(E, C, N) float32 epochs of x_t = sum_l A_l x_(t-l) + eps_t, eps ~
    N(0, sig), after 200 burn-in samples (``tests/test_granger.py``'s
    simulator)."""
    rng = np.random.default_rng(seed)
    burn, c = 200, sig.shape[0]
    out = np.zeros((e, c, n), np.float32)
    chol = np.linalg.cholesky(sig)
    for ep in range(e):
        x = np.zeros((n + burn, c))
        eps = rng.standard_normal((n + burn, c)) @ chol.T
        for t in range(len(coeffs), n + burn):
            acc = eps[t].copy()
            for lag, ak in enumerate(coeffs, start=1):
                acc += ak @ x[t - lag]
            x[t] = acc
        out[ep] = x[burn:].T
    return out


def var2_system():
    """VAR(2): y drives x near 48 Hz at 200 Hz (poles |z| ~ 0.9); x never
    drives y."""
    return ([np.array([[0.55, 0.25], [0.0, 0.55]]),
             np.array([[-0.8, 0.0], [0.0, -0.8]])], np.diag([1.0, 0.7]))


def chain_system():
    """x <- z <- y, order [x, y, z]: no direct y -> x."""
    a = np.diag([0.5, 0.5, 0.5])
    a[0, 2] = 0.5
    a[2, 1] = 0.5
    return [a], np.diag([1.0, 0.8, 0.9])


def var_spectrum(coeffs, sig, k):
    """The VAR's true (K, C, C) spectrum S, transfer H and inverse transfer
    A on the uniform grid of K bins from DC to Nyquist."""
    c = sig.shape[0]
    s = np.zeros((k, c, c), np.complex128)
    h = np.zeros_like(s)
    a_fn = np.zeros_like(s)
    for idx, f in enumerate(np.linspace(0.0, GC_FS / 2, k)):
        a = np.eye(c, dtype=np.complex128)
        for lag, ak in enumerate(coeffs, start=1):
            a -= ak * np.exp(-2j * np.pi * f * lag / GC_FS)
        a_fn[idx] = a
        h[idx] = np.linalg.inv(a)
        s[idx] = h[idx] @ sig @ h[idx].conj().T
    return s, h, a_fn


def granger_known_answers():
    """``tests/test_granger.py``'s known answers on the card, at its sizes
    and tolerances: the Wilson factors of a VAR(2), its GC against the
    analytic factors, the direction of the simulated VAR, the mediated
    chain under pairwise and conditional GC and under DTF / PDC."""
    import torch
    from ninwavelets_tpu_torch.ops import granger as gr

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).cuda()

    coeffs, sig = var2_system()
    s, h_true, _ = var_spectrum(coeffs, sig, 129)
    s64 = dev(s.astype(np.complex64))
    h, sg = gr.wilson_factorize(s64, n_iter=100)
    h = h.cpu().numpy().astype(np.complex128)
    sg = sg.cpu().numpy().astype(np.float64)
    recon = h @ sg[None] @ np.conj(np.swapaxes(h, -1, -2))
    rel = np.abs(recon - s).max() / np.abs(s).max()
    d_sig = np.abs(sg - sig).max()
    d_h = np.abs(h - h_true).max() / np.abs(h_true).max()
    print(f"check Wilson factors of the VAR(2) (129 bins, 100 steps): S "
          f"rebuilt rel {rel} (gate 1e-4), Sigma max|d| {d_sig} (gate "
          f"5e-3), H max|d| / max {d_h} (gate 5e-3)")
    check(rel < 1e-4 and d_sig <= 5e-3 and d_h <= 5e-3, "Wilson factors")
    gc = gr.spectral_granger_pairwise(s64, n_iter=100).cpu().numpy()
    analytic = gr.granger_from_factors(
        dev(h_true.astype(np.complex64)), dev(sig.astype(np.float32)),
        s64).cpu().numpy()
    d = max(np.abs(gc[:, 0, 1] - analytic[:, 0]).max(),
            np.abs(gc[:, 1, 0] - analytic[:, 1]).max())
    print(f"check VAR(2) GC against the analytic factors: max|d| {d} (gate "
          f"2e-3); y -> x max {gc[:, 0, 1].max()} (> 0.05), x -> y max "
          f"{gc[:, 1, 0].max()} (< 1e-3)")
    check(d <= 2e-3 and gc[:, 0, 1].max() > 0.05
          and gc[:, 1, 0].max() < 1e-3
          and bool((gc[:, range(2), range(2)] == 0).all()), "VAR(2) GC")

    data = dev(var_epochs(coeffs, sig, 24, 2048, 0))
    m = gr.wavelet_granger(data, GC_FS, n_bins=33, time_decim=32,
                           n_iter=60).mean(0).cpu().numpy()
    peak = gr.uniform_freqs(33, GC_FS)[m[:, 0, 1].argmax()]
    print(f"check simulated VAR(2), 24 x 2 x 2048: time-mean y -> x max "
          f"{m[:, 0, 1].max()}, x -> y max {m[:, 1, 0].max()} (gate 5x), "
          f"peak at {peak} Hz (gate > 25)")
    check(m[:, 0, 1].max() > 5 * max(m[:, 1, 0].max(), 1e-6)
          and peak > 25.0, "simulated VAR(2) direction")

    coeffs, sig = chain_system()
    s, h_true, a_true = var_spectrum(coeffs, sig, 65)
    s64 = dev(s.astype(np.complex64))
    pw = gr.spectral_granger_pairwise(s64, n_iter=100).cpu().numpy()
    cg = gr.conditional_granger(s64, n_iter=100).cpu().numpy()
    print(f"check chain x <- z <- y: pairwise y -> x {pw[:, 0, 1].max()} "
          f"(> 0.2), conditional y -> x {cg[:, 0, 1].max()} (< 1e-3), "
          f"z -> x {cg[:, 0, 2].max()}, y -> z {cg[:, 2, 1].max()} (> 0.3), "
          f"x -> y {cg[:, 1, 0].max()}, z -> y {cg[:, 1, 2].max()} (< 1e-3)")
    check(pw[:, 0, 1].max() > 0.2 and cg[:, 0, 1].max() < 1e-3
          and cg[:, 0, 2].max() > 0.3 and cg[:, 2, 1].max() > 0.3
          and cg[:, 1, 0].max() < 1e-3 and cg[:, 1, 2].max() < 1e-3
          and bool((cg[:, range(3), range(3)] == 0).all()),
          "chain: conditional GC")
    dtf, pdc = (x.cpu().numpy() for x in gr.dtf_pdc(s64, n_iter=100))
    dtf_true = np.abs(h_true) / np.sqrt(
        (np.abs(h_true) ** 2).sum(-1, keepdims=True))
    pdc_true = np.abs(a_true) / np.sqrt(
        (np.abs(a_true) ** 2).sum(-2, keepdims=True))
    d_dtf, d_pdc = (np.abs(dtf - dtf_true).max(),
                    np.abs(pdc - pdc_true).max())
    print(f"check chain DTF / PDC: PDC y -> x {pdc[:, 0, 1].max()} (< "
          f"0.02), DTF y -> x {dtf[:, 0, 1].max()} (> 0.1); against the "
          f"closed form max|d| {d_dtf} / {d_pdc} (gate 5e-3)")
    check(pdc[:, 0, 1].max() < 0.02 and pdc[:, 0, 2].max() > 0.3
          and pdc[:, 2, 1].max() > 0.3 and dtf[:, 0, 1].max() > 0.1
          and d_dtf <= 5e-3 and d_pdc <= 5e-3, "chain DTF / PDC")
    data = dev(var_epochs(coeffs, sig, 24, 2048, 6))
    m_c = gr.wavelet_conditional_granger(data, GC_FS, n_bins=33,
                                         time_decim=64).mean(0).cpu().numpy()
    m_p = gr.wavelet_granger(data, GC_FS, n_bins=33,
                             time_decim=64).mean(0).cpu().numpy()
    print(f"check simulated chain, 24 x 3 x 2048: y -> x conditional "
          f"{m_c[:, 0, 1].max()} < 0.4 x pairwise {m_p[:, 0, 1].max()}; "
          f"z -> x conditional {m_c[:, 0, 2].max()} > 0.5 x pairwise "
          f"{m_p[:, 0, 2].max()}")
    check(m_c[:, 0, 1].max() < 0.4 * m_p[:, 0, 1].max()
          and m_c[:, 0, 2].max() > 0.5 * m_p[:, 0, 2].max(),
          "simulated chain: conditional GC")


def floyd(w):
    """Float64 Floyd-Warshall shortest paths of a weight matrix, length
    1 / weight (``tests/test_graph.py``'s oracle)."""
    c = w.shape[-1]
    d = np.where(w > 1e-12, 1.0 / np.maximum(w, 1e-12), np.inf)
    np.fill_diagonal(d, 0.0)
    for k in range(c):
        d = np.minimum(d, d[:, k:k + 1] + d[k:k + 1, :])
    return d


def network_tuple(net):
    """The tensors of an ``EpochsWavelet.network`` dict, in a fixed order
    (its numpy communities and modularity as tensors)."""
    import torch
    keys = ("matrix", "strength", "clustering", "efficiency", "path_length",
            "small_world")
    return tuple(net[k] for k in keys) + tuple(
        torch.from_numpy(np.asarray(net[k], np.float32))
        for k in ("communities", "modularity"))


def directed_network_phase(data):
    """Slice 8: spectral Granger causality (pairwise, conditional, DTF /
    PDC, trial-shuffle significance) at the JAX bench's shape, at full width
    and on 8 channels; ``EpochsWavelet.network``; the event-locked path of
    a recording, whose reductions must run K1 / K2; the conversion of the
    families of banks; every new path's TF32 check (identical values) and
    time; the JAX tests' known answers.  Plain torch but for K1 / K2:
    nothing joins the kernels' record."""
    import torch
    import ninwavelets_tpu_torch as nt
    from ninwavelets_tpu_torch import convert, kernels
    from ninwavelets_tpu_torch.ops import cwt
    from ninwavelets_tpu_torch.ops import granger as gr
    from ninwavelets_tpu_torch.ops import graph
    from ninwavelets_tpu_torch.ops.scattering import fp32_matmul

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    print(card)
    morse = nt.Morse(SFREQ, interpolate=True, device="cuda")
    kernels.reset_launches()

    # -- Granger at bench.py:253's shape: 16 x 4 x 2048, 65 bins, decim 32 --
    g16 = np.random.default_rng(11).standard_normal((16, 4, N),
                                                     dtype=np.float32)
    ewg = nt.EpochsWavelet(nt.ArrayEpochs(g16, SFREQ), morse)
    xg = ewg._all_data()
    kw = dict(n_bins=65, time_decim=32)
    shape = (N // 32, 65, 4, 4)
    rest_path("EpochsWavelet.granger (16 x 4 x 2048, 65 bins, decim 32)",
              lambda: ewg.granger(**kw), xg, card, shape, gate=0)
    dtf, pdc = rest_path("wavelet_dtf_pdc (16 x 4 x 2048, 65 bins, decim "
                         "32)", lambda: gr.wavelet_dtf_pdc(xg, SFREQ, **kw),
                         xg, card, shape, gate=0)
    check(dtf.max().item() <= 1 + 1e-5 and pdc.max().item() <= 1 + 1e-5,
          "DTF / PDC above 1")
    xg.copy_(torch.from_numpy(g16))
    gc, p = rest_path("wavelet_granger_significance (16 x 4 x 2048, 65 "
                      "bins, decim 32, 19 surrogates)",
                      lambda: gr.wavelet_granger_significance(
                          xg, SFREQ, n_surrogates=19, **kw),
                      xg, card, shape, gate=0)
    xg.copy_(torch.from_numpy(g16))       # the timing refilled it
    plain = gr.wavelet_granger(xg, SFREQ, **kw)
    d = (gc - plain).abs().max().item()
    eye = torch.eye(4, dtype=torch.bool, device="cuda")
    print(f"check significance: its GC against wavelet_granger max|d| {d} "
          "(gate 0: the same cross spectra and factorization); p in "
          "[1/20, 1], diagonal 1")
    check(d == 0 and bool(((p >= 1 / 20 - 1e-7) & (p <= 1)).all())
          and bool((p[..., eye] == 1).all()), "wavelet_granger_significance")

    # -- conditional Granger: 8 channels x 200 epochs, decim 16 -------------
    ew8 = nt.EpochsWavelet(nt.ArrayEpochs(np.ascontiguousarray(
        data[:, :8]), SFREQ), morse)
    cg = rest_path(f"EpochsWavelet.granger conditional=True ({E} x 8 x {N}, "
                   "65 bins, decim 16)", lambda: ew8.granger(
                       conditional=True), ew8._all_data(), card,
                   (N // 16, 65, 8, 8), gate=0)
    check(bool((cg[..., torch.eye(8, dtype=torch.bool, device="cuda")]
                == 0).all()), "conditional GC diagonal not 0")
    del cg, ew8
    torch.cuda.empty_cache()

    # -- Granger at full width: 200 x 64 x 2048, 65 bins, decim 64 ----------
    # Each call takes seconds, so the two runs of the TF32 check are the
    # warm-up and give the peak memory, and the REPS timed runs are split
    # between the two parts of the call's body, ``wavelet_granger``: the
    # bank and the decimated CWT with its cross spectra, then the pairwise
    # Wilson loop and GC.
    ewf = nt.EpochsWavelet(nt.ArrayEpochs(data, SFREQ), morse)
    xf = ewf._all_data()
    name = f"EpochsWavelet.granger ({E} x {C} x {N}, 65 bins, decim 64)"
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    full = tf32_same(name, lambda: ewf.granger(time_decim=64), gate=0)
    peak = torch.cuda.max_memory_allocated()
    print(f"memory {name}: peak {peak} bytes allocated, {held} held before "
          f"the calls, {peak - held} for a call, on {card}")
    check(tuple(full.shape) == (N // 64, 65, C, C)
          and bool(full.isfinite().all()), f"{name}: output")
    del full
    parts = []
    for _ in range(REPS):
        xf.normal_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sigs, bank_g = gr._granger_inputs(xf, SFREQ, 65, True)
        cross = gr._cross_spectra(sigs, bank_g, 64, True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        gr._pairwise_assemble(cross, 60)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        parts.append(((t2 - t0) * 1e3, (t1 - t0) * 1e3, (t2 - t1) * 1e3))
    ms, ms_cwt, ms_wilson = (sorted(p)[REPS // 2] for p in zip(*parts))
    print(f"time {name}: {ms} ms (its body, wavelet_granger), of which the "
          f"bank, decimated CWT and cross spectra {ms_cwt} ms, the pairwise "
          f"Wilson loop and GC {ms_wilson} ms (medians of {REPS}), on {card}")
    # One Wilson step's pieces on the first chunk of (time, pair) systems,
    # by CUDA events; the 2 x 2 product also as a batched GEMM (matmul),
    # which ``_mm`` replaces for matrices up to 4 x 4.
    i, j = torch.triu_indices(C, C, 1, device="cuda")
    pair_s = torch.stack([cross[..., i, i], cross[..., i, j], cross[..., j, i],
                          cross[..., j, j]], -1).movedim(-2, -3)
    part = gr._two_sided(pair_s.reshape(-1, 65, 2, 2)[:gr._PAIR_CHUNK])
    psi = part * 1.1
    with fp32_matmul("exact"):
        pieces = {"solve (2 a step)": lambda: gr._solve_complex(psi, part),
                  "product psi gamma (_mm)": lambda: gr._mm(psi, part),
                  "the same product by matmul": lambda: psi @ part,
                  "plus operator (2 FFTs)": lambda: gr._plus_operator(
                      part, 64)}
        times = {k: event_ms(fn) for k, fn in pieces.items()}
    print(f"breakdown of one Wilson step on {part.shape[0]} of the "
          f"{pair_s.shape[0] * pair_s.shape[1]} (time, pair) systems "
          f"(128 frequencies): " + ", ".join(f"{k} {v} ms" for k, v in
                                              times.items())
          + f", on {card}")
    del ewf, xf, sigs, bank_g, cross, pair_s, part, psi
    torch.cuda.empty_cache()

    # -- EpochsWavelet.network at 16 x 64 x 2048 x 100 rows ------------------
    freqs = np.arange(1.0, F + 1.0)
    ew16 = nt.EpochsWavelet(nt.ArrayEpochs(data[:E_MATRIX], SFREQ), morse)
    x16 = ew16._all_data()
    for method in ("wpli", "plv"):
        name = (f"EpochsWavelet.network {method} n_nulls=20 ({E_MATRIX} x "
                f"{C} x {N} x {F})")
        net = tf32_same(name, lambda: network_tuple(ew16.network(
            freqs, method=method, n_nulls=20)), gate=0)
        m, st, cl, eff, pl, sw, comm, q = net
        off = ~torch.eye(C, dtype=torch.bool, device="cuda")
        ok = m[:, off].isfinite().all(-1)       # rows with a finite matrix
        rows = [eff, pl] + ([st, cl, sw] if method == "plv" else [])
        check(bool(q.isfinite().all()) and bool(comm.isfinite().all())
              and all(bool(t[ok].isfinite().all()) for t in rows),
              f"network {method}: non-finite measures on finite rows")
        print(f"network {method}: {int((~ok).sum())} of {F} rows with NaN "
              f"off the matrix diagonal; NaN cells in strength "
              f"{int(st.isnan().sum())}, clustering {int(cl.isnan().sum())}, "
              f"small_world {int(sw.isnan().sum())} (the wPLI matrix's NaN "
              "diagonal reaches them, as in the JAX package)")
        if method == "plv":
            i20 = int(np.argmin(np.abs(freqs - 20.0)))
            row = m[i20].double().cpu().numpy()
            ref = floyd(np.maximum(0.5 * (row + row.T), 0) * (1 - np.eye(C)))
            got = graph.shortest_paths(m[i20]).double().cpu().numpy()
            d = (np.abs(got - ref) / ref.clip(min=1e-30)).max()
            print(f"check network plv: shortest paths of the 20 Hz row "
                  f"against a float64 Floyd-Warshall rel {d} (gate 1e-5)")
            check(d <= 1e-5, "network plv shortest paths")
        ms = host_ms(lambda _: ew16.network(freqs, method=method,
                                            n_nulls=20),
                     lambda: x16.normal_())
        print(f"time {name}: {ms} ms on {card}")
    del net, m, st, cl, eff, pl, sw, comm, q
    rng = np.random.default_rng(7)
    t = np.arange(256) / 250.0
    shared = np.sin(2 * np.pi * 20 * t + 0.7)
    small = 0.5 * rng.standard_normal((10, 3, 256)).astype(np.float32)
    small[:, 0] += shared.astype(np.float32)
    small[:, 1] += np.roll(shared, 7).astype(np.float32)
    net = nt.EpochsWavelet(nt.ArrayEpochs(small, 250.0), nt.Morse(
        250.0, device="cuda")).network([15.0, 20.0, 25.0], method="plv",
                                       n_nulls=5)
    s20 = net["strength"][1].tolist()
    print(f"check network of a lagged pair at 20 Hz: strengths {s20} (the "
          "third channel weakest)")
    check(s20[2] < s20[0] and s20[2] < s20[1], "network known answer")
    torch.cuda.empty_cache()

    # -- the event-locked path of a recording --------------------------------
    rec = recording(4)
    rng = np.random.default_rng(8)
    onsets = np.sort(rng.choice(np.arange(1000, REC_N - 2000), EVENT_N,
                                replace=False))
    events = np.stack([np.append(onsets, REC_N - 100),
                       np.zeros(EVENT_N + 1, np.int64),
                       np.append(np.tile([1, 2], EVENT_N // 2), 3)], 1)
    start = int(round(EVENT_TMIN * SFREQ))
    morse_ev = nt.Morse(SFREQ, interpolate=True, device="cuda")
    rw = nt.RawWavelet(ArrayRaw(rec), morse_ev)
    kernels.reset_launches()
    ew = rw.epochs(events, EVENT_TMIN, EVENT_TMAX)
    pw = rw.epoch_power(freqs, events, EVENT_TMIN, EVENT_TMAX,
                        baseline=BASELINE)
    itc = rw.itc(freqs, events, EVENT_TMIN, EVENT_TMAX)
    groups = ew.split()
    gpow = {lab: g.power_all(freqs) for lab, g in groups.items()}
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    print(f"event-locked path launches {counts}")
    check(counts["power"] == 3 and counts["itc"] == 1
          and sum(counts.values()) == 4,
          f"event-locked path launched {counts}: K1 must launch 3 times "
          "(epoch_power, two split groups), K2 once (itc)")
    host = ew._host_data()
    want = np.stack([rec[:, e + start:e + start + N] for e in onsets])
    check(host.shape == (EVENT_N, REC_C, N) and np.array_equal(host, want),
          "event windows differ from numpy slices of the recording")
    check(np.array_equal(ew.event_codes, np.tile([1, 2], EVENT_N // 2))
          and sorted(groups) == [1, 2], "event codes")
    print(f"check event windows: {host.shape} equal to numpy slices of the "
          "recording (the edge event dropped with its code)")
    x = ew._all_data()
    bank_ev = morse_ev.fft_wavelets
    ref_power = cwt.mean_power_from_bank(x, bank_ev, True)
    baselined_err("RawWavelet.epoch_power baselined", pw, ref_power)
    itc_err("RawWavelet.itc", itc, cwt.itc_from_bank(x, bank_ev, True),
            ref_power)
    for lab, gp in gpow.items():
        sel = torch.from_numpy(ew.event_codes == lab).cuda()
        rel_err(f"split()[{lab}].power_all", gp,
                cwt.mean_power_from_bank(x[sel], bank_ev, True))
    del x, ref_power, pw, itc, gpow
    shift = iter(range(1, 100))

    def fresh_events():
        """The events moved by a new sample offset: fresh windows."""
        ev = events.copy()
        ev[:-1, 0] += next(shift)
        return ev

    paths = {
        "RawWavelet.epochs and the copy to the card": lambda ev: rw.epochs(
            ev, EVENT_TMIN, EVENT_TMAX)._all_data(),
        "RawWavelet.epoch_power (baseline)": lambda ev: rw.epoch_power(
            freqs, ev, EVENT_TMIN, EVENT_TMAX, baseline=BASELINE),
        "RawWavelet.itc": lambda ev: rw.itc(freqs, ev, EVENT_TMIN,
                                            EVENT_TMAX),
        "split() and each group's power_all": lambda ev: [
            g.power_all(freqs) for g in rw.epochs(
                ev, EVENT_TMIN, EVENT_TMAX).split().values()],
    }
    for label, fn in paths.items():
        if not label.startswith("RawWavelet.epochs"):
            tf32_same(f"{label} (event-locked)", lambda: tuple(
                torch.stack(out) if isinstance(out, list) else out
                for out in [fn(events)]), gate=0)
        ms = host_ms(fn, fresh_events)
        print(f"time {label} ({EVENT_N} events x {REC_C} channels x {N} "
              f"samples of a {REC_N}-sample recording, {F} rows): {ms} ms "
              f"on {card}")
    del rw, ew, groups, rec
    torch.cuda.empty_cache()

    # -- convert: the families of banks and MorseMNE, duck-typed -------------
    ducks = {"Superlet": dict(sfreq=SFREQ, sigma=2.5, order_min=2,
                              order_max=5, adaptive=False, interpolate=True),
             "MorseMultitaper": dict(sfreq=SFREQ, b=9.0, r=2.5, n_tapers=4,
                                     interpolate=True),
             "MorseMNE": dict(sfreq=SFREQ, b=12.0, r=3.5,
                              real_wave_length=1.0, interpolate=True,
                              mode=nt.WaveletMode.Reverse)}
    sig = torch.from_numpy(data[0, :2]).cuda()
    fr = np.arange(8.0, 72.0, 8.0)
    for cls_name, attrs in ducks.items():
        duck = type(cls_name, (), dict(attrs))()
        w = convert.wavelet_from_jax(duck)
        params = {k: v for k, v in attrs.items() if k != "mode"}
        same = all(getattr(w, k) == v for k, v in params.items())
        direct = getattr(nt, cls_name)(device="cuda", **{
            k: v for k, v in params.items() if k != "real_wave_length"})
        d = (w.power(sig, fr) - direct.power(sig, fr)).abs().max().item()
        print(f"check convert.wavelet_from_jax({cls_name}): {type(w).__name__}"
              f" on {w.device}, parameters carried {same}, power against "
              f"the class built directly max|d| {d} (gate 0)")
        check(type(w).__name__ == cls_name and same and d == 0
              and w.device.type == "cuda", f"convert {cls_name}")

    granger_known_answers()

# -- slice 9: statistics ------------------------------------------------------

STAT_CH = "ch0"
BURST_HZ, BURST_T0, BURST_T1, BURST_AMP = 40.0, 0.8, 1.2, 2.0
CAL_SHAPE, CAL_PERMS, CAL_SIMS, CAL_ALPHA = (20, 8, 32), 99, 500, 0.05
BENCH_SHAPE, BENCH_PERMS, BENCH_THR, BENCH_ITERS = (40, 100, 1024), 256, 2.0, 5


def planted(data):
    """The serving data with a 40 Hz burst, 0.8-1.2 s, of amplitude 2 and a
    seeded phase added to channel 0 of the even epochs."""
    t = np.arange(N) / SFREQ
    win = (t >= BURST_T0) & (t < BURST_T1)
    phase = np.random.default_rng(9).uniform(0, 2 * np.pi, (E // 2, 1))
    out = data.copy()
    out[::2, 0] += (BURST_AMP * np.sin(2 * np.pi * BURST_HZ * t + phase)
                    * win).astype(np.float32)
    return out


def same_result(a, b):
    """Bit-for-bit equality of two results (tensors, arrays, tuples, lists,
    dicts, numbers, ``EpochsWavelet`` adapters by their data); NaN equals
    NaN in the same place."""
    import torch
    if isinstance(a, torch.Tensor):
        if a.is_floating_point() and a.shape == b.shape:
            return bool(((a == b) | (a.isnan() & b.isnan())).all())
        return torch.equal(a, b)
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b, equal_nan=True)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(map(same_result, a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_result(a[k], b[k])
                                            for k in a)
    if hasattr(a, "_host_data") and hasattr(a, "epochs"):
        # two EpochsWavelet adapters: their trials and channels
        return (same_result(a._host_data(), b._host_data())
                and list(a.epochs.ch_names) == list(b.epochs.ch_names))
    return a == b


def stat_call(name, fn, fresh, card):
    """One statistics call: run under the float32 matmul precision "high"
    (TF32 allowed) and "highest", whose results must be identical and which
    must leave the caller's setting as they found it; these two runs are
    the warm-up and give the peak memory.  Then the median host time of 5
    runs (3 for a call over 1 s), ``fresh()`` giving new input values
    before each, called an even number of times.  Returns the result."""
    return timed_call(name, fn, fresh, card, slow_reps=3)[0]


def launched_since(before):
    """The kernel launches since the ``kernels.launches`` snapshot
    ``before``, by key, the keys that moved only."""
    from ninwavelets_tpu_torch import kernels
    return {k: v - before.get(k, 0) for k, v in kernels.launches.items()
            if v != before.get(k, 0)}


def timed_call(name, fn, fresh, card, slow_reps=None):
    """``stat_call``'s measurement: two warm-up runs under the float32
    matmul precision "high" (TF32 allowed) and "highest", whose results
    must be identical and which must leave the caller's setting as they
    found it, the launches of the first run and the peak memory of both;
    then the median host time of REPS runs (``slow_reps`` when a warm-up
    run took over 1 s), ``fresh()`` giving new input values before each
    and called an even number of times.  Returns (result, launches,
    median ms)."""
    import torch
    from ninwavelets_tpu_torch import kernels
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = dict(kernels.launches)
    prev = torch.get_float32_matmul_precision()
    outs, first, counts = [], [], None
    for setting in ("high", "highest"):
        torch.set_float32_matmul_precision(setting)
        try:
            t0 = time.perf_counter()
            outs.append(fn())
            torch.cuda.synchronize()
            first.append(time.perf_counter() - t0)
            after = torch.get_float32_matmul_precision()
        finally:
            torch.set_float32_matmul_precision(prev)
        check(after == setting, f"{name}: the matmul precision {setting!r} "
              f"came back as {after!r}")
        if counts is None:
            counts = launched_since(before)
    peak = torch.cuda.max_memory_allocated()
    ok = same_result(*outs)
    print(f"check {name} TF32 on / off: identical {ok} (gate: identical)")
    check(ok, f"{name}: TF32 on and off differ")
    reps = slow_reps if slow_reps and min(first) > 1.0 else REPS
    times = []
    for _ in range(reps):
        fresh()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    if reps % 2:
        fresh()      # an even count: a negating fresh() leaves the input
    ms = sorted(times)[reps // 2]
    print(f"time {name}: {ms} ms (median of {reps}); peak {peak} bytes "
          f"allocated, {peak - held} above the {held} held before the "
          f"call, on {card}")
    return outs[1], counts, ms


def negate(*adapters):
    """``fresh`` for adapter calls: each adapter's data negated in place
    (its host snapshot, and its card copy where it has one): new input
    values, the same work and, power being even, the same results."""
    def fresh():
        for a in adapters:
            host = a._host_data()
            np.negative(host, out=host)
            if hasattr(a, "_data"):
                a._data.neg_()
    return fresh


def host_labels(mask, edges=()):
    """Minimum-flat-index labels of a batch of (F, N) or (C, F, N) masks
    from the host's connected components (``scipy.sparse.csgraph`` over
    the 4-neighbour links and the same-pixel links of ``edges``)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    out = np.empty(mask.shape, np.int64)
    for b, m in enumerate(mask):
        fn = m.size
        idx = np.arange(fn).reshape(m.shape)
        links = [(idx[..., :, :-1], idx[..., :, 1:],
                  m[..., :, :-1] & m[..., :, 1:]),
                 (idx[..., :-1, :], idx[..., 1:, :],
                  m[..., :-1, :] & m[..., 1:, :])]
        links += [(idx[u], idx[v], m[u] & m[v]) for u, v in edges]
        i = np.concatenate([a[k] for a, _, k in links])
        j = np.concatenate([c[k] for _, c, k in links])
        n_comp, comp = connected_components(coo_matrix(
            (np.ones(i.size), (i, j)), shape=(fn, fn)), directed=False)
        pix = np.flatnonzero(m)
        low = np.full(n_comp, fn)
        np.minimum.at(low, comp[pix], pix)
        lab = np.full(fn, fn)
        lab[pix] = low[comp[pix]]
        out[b] = lab.reshape(m.shape)
    return out


def statistics_phase(data):
    """Slice 9: the statistics family through its public entry points on
    the serving data with a planted burst; K4 under it; the known answers,
    labels on the card against the CPU labeler and the host, TF32 on and
    off identical, the calibration of the three one-sample tests, the
    cluster null's throughput and the split of one call.  Plain torch but
    for K4: nothing joins the kernels' record."""
    import torch
    from scipy.stats import binom
    import ninwavelets_tpu_torch as nt
    from ninwavelets_tpu_torch import kernels
    from ninwavelets_tpu_torch.ops import bootstrap as bs
    from ninwavelets_tpu_torch.ops import cluster as cl

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    print(card)
    t_phase = time.perf_counter()
    freqs = np.arange(1.0, F + 1.0)
    row = int(BURST_HZ) - 1
    cols = slice(int(BURST_T0 * SFREQ), int(BURST_T1 * SFREQ))
    ew = nt.EpochsWavelet(nt.ArrayEpochs(planted(data), SFREQ),
                          nt.Morse(SFREQ, device="cuda"))
    halves = ew.split(np.arange(E) % 2)      # 0: the burst epochs
    thirds = ew.split(np.arange(E) % 3)
    covariate = np.random.default_rng(10).standard_normal(E).astype(
        np.float32)
    ring = np.stack([np.arange(C), (np.arange(C) + 1) % C], 1)
    kernels.reset_launches()

    def first_covers(name, res, box):
        """The first cluster is positive, p < 0.05, and holds every pixel
        of the planted box."""
        c0 = res.clusters[0]
        inside = bool(np.all(res.mass_map[box] == c0["mass"]))
        print(f"check {name}: {len(res.clusters)} clusters, the first "
              f"sign {c0['sign']} size {c0['size']} mass {c0['mass']} p "
              f"{c0['p']}, covering the planted box {inside}")
        check(c0["sign"] == 1 and c0["p"] < 0.05 and inside,
              f"{name}: the planted burst is not the first cluster")

    # -- the adapter's tests on the serving data ------------------------------
    name = f"EpochsWavelet.cluster_test one-sample ({E} x {F} x {N}, n_perm 999)"
    one = stat_call(name, lambda: ew.cluster_test(
        STAT_CH, freqs, baseline=BASELINE, n_perm=999), negate(ew), card)
    first_covers(name, one, (row, cols))
    check(one.null_max.shape == (999,)
          and one.p_map[np.abs(one.t_obs) <= one.threshold].min() == 1.0,
          f"{name}: null or p map")
    name = (f"EpochsWavelet.cluster_test independent (split() halves "
            f"{E // 2} + {E // 2} x {F} x {N}, n_perm 999)")
    ind = stat_call(name, lambda: halves[0].cluster_test(
        STAT_CH, freqs, other=halves[1], n_perm=999),
        negate(halves[0], halves[1]), card)
    first_covers(name, ind, (row, cols))
    name = f"EpochsWavelet.cluster_regression ({E} x {F} x {N}, n_perm 999)"
    reg = stat_call(name, lambda: ew.cluster_regression(
        STAT_CH, freqs, covariate, baseline=BASELINE, n_perm=999),
        negate(ew), card)
    name = f"EpochsWavelet.cluster_f (split() thirds of {E} x {F} x {N})"
    fres = stat_call(name, lambda: thirds[0].cluster_f(
        STAT_CH, freqs, [thirds[1], thirds[2]], n_perm=999),
        negate(*thirds.values()), card)
    for label, res in (("cluster_regression", reg), ("cluster_f", fres)):
        ps = [c["p"] for c in res.clusters]
        print(f"check {label}: {len(ps)} clusters, smallest p "
              f"{min(ps, default=1.0)}")
        check(np.isfinite(res.t_obs).all() and all(0 < p <= 1 for p in ps),
              f"{label}: result")
    check(all(c["sign"] == 1 for c in fres.clusters), "cluster_f signs")

    ew._all_data()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    planes = ew.single_trial_power_all(freqs, BASELINE, decim=4)
    torch.cuda.synchronize()
    kept = torch.cuda.memory_allocated() - before
    print(f"check single_trial_power_all decim=4: {kept} bytes kept for a "
          f"{planes.numel() * 4}-byte plane (the full plane freed)")
    check(kept <= planes.numel() * 4 + (1 << 22),
          "the decimated planes keep the full plane alive")
    del planes
    name = (f"EpochsWavelet.cluster_test_all ({E} x {C} x {F} x {N // 4}, "
            f"{C}-channel ring, decim 4, n_perm 256)")
    allc = stat_call(name, lambda: ew.cluster_test_all(
        freqs, adjacency=ring, baseline=BASELINE, decim=4, n_perm=256),
        negate(ew), card)
    first_covers(name, allc, (0, row, slice(cols.start // 4,
                                             cols.stop // 4)))

    x1 = ew.single_trial_power(STAT_CH, freqs, BASELINE)
    name = f"tfce_test_one_sample ({E} x {F} x {N}, n_perm 199)"
    tf = stat_call(name, lambda: cl.tfce_test_one_sample(x1, n_perm=199),
                   x1.neg_, card)
    name = f"max_stat_test_one_sample ({E} x {F} x {N}, n_perm 199)"
    mt, mp = stat_call(name, lambda: cl.max_stat_test_one_sample(
        x1, n_perm=199), x1.neg_, card)
    print(f"check tfce / max-stat: box p max {tf.p_map[row, cols].max()} / "
          f"p at ({BURST_HZ} Hz, 1 s) {mp[row, 1000]}")
    check(tf.p_map[row, cols].max() < 0.05 and mp[row, 1000] < 0.05,
          "tfce / max-stat miss the planted burst")
    raw = ew.single_trial_power(STAT_CH, freqs)
    name = f"bootstrap_ci ({E} x {F} x {N}, n_boot 1000)"
    lo, hi = stat_call(name, lambda: bs.bootstrap_ci(raw, n_boot=1000),
                       raw.neg_, card)
    # the same bounds from the same counts in float64 on the host, at 4096
    # pixels (its linear quantile: numpy's default)
    counts = bs._boot_counts(0, 1000, E, bs._CHUNK, raw.device)
    w = counts.reshape(-1, E)[:1000].double().cpu().numpy() / E
    pick = np.random.default_rng(11).choice(F * N, 4096, replace=False)
    sub = raw.reshape(E, -1)[:, pick].double().cpu().numpy()
    ref = np.quantile(w @ sub, [0.025, 0.975], axis=0)
    got = np.stack([lo.reshape(-1)[pick].cpu().numpy(),
                    hi.reshape(-1)[pick].cpu().numpy()])
    d = np.abs(got - ref).max() / raw.abs().max().item()
    mean = raw.mean(0)
    inside = ((lo <= mean) & (mean <= hi)).float().mean().item()
    print(f"check bootstrap_ci: against float64 host quantiles of the same "
          f"counts max|d| / max {d} (gate 1e-5); the mean inside its bounds "
          f"at {inside} of the pixels (gate 0.99)")
    check(d <= 1e-5 and inside >= 0.99, "bootstrap_ci")
    del raw, lo, hi, mean

    name = "EpochsWavelet.bursts summary (factor 20, min_area 10)"
    summ = stat_call(name, lambda: ew.bursts(STAT_CH, freqs, factor=20.0,
                                             min_area=10), negate(ew), card)
    name = "EpochsWavelet.bursts table=True (factor 20, min_area 10)"
    table = stat_call(name, lambda: ew.bursts(
        STAT_CH, freqs, factor=20.0, min_area=10, table=True),
        negate(ew), card)
    found = {b["epoch"] for b in table
             if b["t_start"] <= BURST_T0 + 0.05 and b["t_stop"] >= BURST_T1
             - 0.05 and b["f_lo"] <= BURST_HZ <= b["f_hi"]}
    count = summ.count.cpu().numpy()
    quiet = sum(b["epoch"] % 2 for b in table)
    print(f"check bursts: the planted burst found in {len(found & set(range(0, E, 2)))} "
          f"of {E // 2} burst epochs; {quiet} bursts in the quiet epochs; "
          f"summary counts >= 1 in the burst epochs {bool((count[::2] >= 1).all())}")
    check(found >= set(range(0, E, 2)) and (count[::2] >= 1).all(),
          "bursts miss the planted burst")
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    print(f"statistics path launches {counts}")
    check(counts.get("power_each", 0) > 0
          and sum(counts.values()) == counts["power_each"],
          f"statistics path launched {counts}: K4 ('power_each') only")

    # -- labels on the card against the CPU labeler and the host -------------
    thr = cl.t_threshold(0.05, E - 1)
    _, plane, xf, s2 = cl._sign_moments(x1)
    mask = cl._sign_t(cl.sign_draws(0, 999, E, cl._CHUNK, "cuda")[0], xf,
                      s2, E, plane) > thr
    card_l = cl.label_components(mask).cpu()
    cpu_l = cl.label_components(mask.cpu())
    host_l = host_labels(mask.cpu().numpy())
    print(f"check labels of one null chunk ({tuple(mask.shape)}, "
          f"{int(mask.sum())} pixels above {thr}): card == CPU labeler "
          f"{torch.equal(card_l, cpu_l)}, card == host components "
          f"{np.array_equal(card_l.numpy(), host_l)}")
    check(torch.equal(card_l, cpu_l) and np.array_equal(card_l.numpy(),
                                                        host_l),
          "card labels differ")
    planes = ew.single_trial_power_all(freqs, BASELINE, decim=4)
    _, plane4, xf4, s24 = cl._sign_moments(planes)
    mask = cl._sign_t(cl.sign_draws(0, 256, E, cl._CHUNK, "cuda")[0][:2],
                      xf4, s24, E, plane4) > thr
    card_l = cl.label_components(mask, ring).cpu().numpy()
    host_l = host_labels(mask.cpu().numpy(), ring)
    print(f"check ring-adjacency labels of two null maps "
          f"({tuple(mask.shape)}): card == host components "
          f"{np.array_equal(card_l, host_l)}")
    check(np.array_equal(card_l, host_l), "card ring labels differ")
    del planes, xf4, s24, mask, card_l, cpu_l, host_l
    torch.cuda.empty_cache()

    # -- the split of the one-channel cluster_test by CUDA events -------------
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    ev[0].record()
    xs = ew.single_trial_power(STAT_CH, freqs, BASELINE)
    ev[1].record()
    _, plane, xf, s2 = cl._sign_moments(xs)
    maps = [cl._sign_t(s, xf, s2, E, plane)
            for s in cl.sign_draws(0, 999, E, cl._CHUNK, "cuda")]
    ev[2].record()
    labels = [[(sg > thr, cl.label_components(sg > thr)) for sg in (m, -m)]
              for m in maps]
    ev[3].record()
    fn = F * N
    null = torch.cat([torch.maximum(*[
        cl._mass_bins(torch.where(mk, sg, 0.0), lab, fn)[..., :fn].amax(-1)
        for sg, (mk, lab) in zip((m, -m), pair)])
        for m, pair in zip(maps, labels)])[:999]
    ev[4].record()
    res = cl._finish(cl.t_one_sample(xs), null, thr)
    ev[5].record()
    torch.cuda.synchronize()
    parts = [ev[i].elapsed_time(ev[i + 1]) for i in range(5)]
    print(f"breakdown of the one-channel cluster_test ({E} x {F} x {N}, 999 "
          f"permutations, by CUDA events): power (K4 and the baseline) "
          f"{parts[0]} ms, contractions {parts[1]} ms, labeling "
          f"{parts[2]} ms, masses {parts[3]} ms, _finish {parts[4]} ms, "
          f"on {card}")
    check(np.array_equal(res.null_max, one.null_max),
          "the split's null differs from cluster_test's")
    del xs, xf, maps, labels, null, x1
    torch.cuda.empty_cache()

    # -- calibration: benchmarks/stats_calibration.py's first block ----------
    rng = np.random.default_rng(0)
    hits = {"cluster": 0, "tfce": 0, "maxstat": 0}
    t0 = time.perf_counter()
    for s in range(CAL_SIMS):
        x = torch.from_numpy(rng.standard_normal(CAL_SHAPE).astype(
            np.float32)).cuda()
        res = cl.cluster_test_one_sample(x, n_perm=CAL_PERMS, seed=s)
        hits["cluster"] += any(c["p"] <= CAL_ALPHA for c in res.clusters)
        res = cl.tfce_test_one_sample(x, n_perm=CAL_PERMS, seed=s, stop=15.0)
        hits["tfce"] += bool(res.p_map.min() <= CAL_ALPHA)
        _, p = cl.max_stat_test_one_sample(x, n_perm=CAL_PERMS, seed=s)
        hits["maxstat"] += bool(p.min() <= CAL_ALPHA)
    elapsed = time.perf_counter() - t0
    lo_r = binom.ppf(0.005, CAL_SIMS, CAL_ALPHA) / CAL_SIMS
    hi_r = binom.ppf(0.995, CAL_SIMS, CAL_ALPHA) / CAL_SIMS
    rates = {k: v / CAL_SIMS for k, v in hits.items()}
    print(f"check calibration ({CAL_SIMS} null sims of {CAL_SHAPE}, n_perm "
          f"{CAL_PERMS}, {elapsed} s): FWER {rates}, the exact binomial "
          f"99% envelope of {CAL_ALPHA}: [{lo_r}, {hi_r}]")
    check(all(lo_r <= r <= hi_r for r in rates.values()),
          f"calibration outside the envelope: {rates}")

    # -- throughput at bench.py:163's configuration --------------------------
    xb = torch.randn(BENCH_SHAPE, device="cuda",
                     generator=torch.Generator("cuda").manual_seed(0))

    def step(d):
        return cl._sign_flip_null(d, 0, n_perm=BENCH_PERMS,
                                  threshold=BENCH_THR)

    step(xb)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(BENCH_ITERS):
        out = step(xb * (1.0 + 1e-7 * k))
    torch.cuda.synchronize()
    value = BENCH_PERMS * BENCH_ITERS / (time.perf_counter() - t0)
    check(bool(out.isfinite().all()), "throughput null not finite")
    print(f"metric cluster_permutations_per_s {value} (bench.py:163's "
          f"configuration: {BENCH_SHAPE}, {BENCH_PERMS} permutations, "
          f"threshold {BENCH_THR}, {BENCH_ITERS} iterations, new input "
          f"values each) on {card}")
    print(f"statistics phase {time.perf_counter() - t_phase} s")


TR_ROWS, TR_N, TR_LEVEL, TR_PACKETS = 64, 65536, 8, 5
BB_ROWS, BB_LEVELS = 8, 4
ST_E, ST_C, ST_N, ST_F = 16, 64, 2048, 100
IMG_FEW, IMG_MANY, IMG_HW, IMG_LEVEL = 8, 160, 256, 4
IMG_FREQS = (0.03, 0.06, 0.12, 0.24)
CPU_ROWS, CPU_IMGS = 4, 2
FAULT_HZ, FAULT_NS = 100.0, (20_000, 600_000)


def on_cpu(name, got, fn, gate=POWER_RTOL):
    """The card's result against the port's own CPU run of ``fn`` (the
    CPU tests' gate; the CPU run is tied to JAX by tier-1)."""
    return rel_err(f"{name}: card vs CPU", got.cpu(), fn())


def denoised_err(name, got, ref, x):
    """A denoised signal against its reference within 1e-5 of the max of
    the INPUT ``x``: the coefficients' round-off is relative to the signal
    they came from, and the shrinkage leaves an output far smaller than
    it (white noise at J = 17: the output's max is 3% of the input's)."""
    err = (got - ref).abs().max().item()
    scale = x.abs().max().item()
    print(f"check {name}: max|d| {err}, / max|x| {err / scale} (gate "
          f"{POWER_RTOL}), / max|ref| {err / ref.abs().max().item()}")
    check(bool(got.isfinite().all()), f"{name}: non-finite values")
    check(err <= POWER_RTOL * scale, f"{name}: {err / scale} > "
          f"{POWER_RTOL} of max|x|")


def sound_itc_err(name, got, ref, sound):
    """ITC at slice 1's 1e-4 gate on ``sound`` cells only (every epoch's
    |c| at least 1e-2 of its row max: ``sound_cells``, the rule of slices
    5 and 6 and of ``tests/test_torch_cwt.py``), with no NaN there in
    either path.  Shrinkage removes a band from some trials and not
    others, so at a cell of strong mean power one epoch's coefficient can
    sit at the round-off floor, and an exactly-zero one gives NaN in one
    path and not the other: off the sound cells the ITC is printed, not
    gated."""
    import torch
    d = (got - ref).abs()
    err = d[sound].max().item()
    nan = bool(got[sound].isnan().any() or ref[sound].isnan().any())
    weak = torch.where(sound, torch.zeros_like(d), d).nan_to_num()
    print(f"check {name}: on the {int(sound.sum())} sound cells max|d| "
          f"{err} (gate {ITC_ATOL_STRONG}), NaN there {nan}; on the other "
          f"{int((~sound).sum())} cells max|d| {weak.max().item()}, NaN "
          f"cells {int(got.isnan().sum())} / {int(ref.isnan().sum())} (not "
          "gated)")
    check(err <= ITC_ATOL_STRONG and not nan,
          f"{name}: ITC err {err} on sound cells")


def round_trip(name, rec, x):
    """A reconstruction within 1e-5 of the signal's max."""
    err = (rec - x).abs().max().item() / x.abs().max().item()
    print(f"check {name} round trip: max|d| / max|x| {err} (gate 1e-5)")
    check(err <= 1e-5, f"{name} round trip {err}")


def prune_margin(costs, levels):
    """The smallest relative margin |c - child| / max(|c|, |child|) over
    the decisions of the bottom-up best-basis prune."""
    best, low = {}, math.inf
    for j in range(levels, -1, -1):
        for b in range(2 ** j):
            c = costs[(j, b)]
            if j == levels:
                best[(j, b)] = c
                continue
            child = best[(j + 1, 2 * b)] + best[(j + 1, 2 * b + 1)]
            scale = max(abs(c), abs(child))
            if scale:
                low = min(low, abs(c - child) / scale)
            best[(j, b)] = min(c, child)
    return low


def tone_gain(y, f, n, sfreq=SFREQ):
    """|<y, sin> / <sin, sin>| of a tone at ``f`` Hz over the interior
    80% of ``n`` samples."""
    s = np.sin(2 * np.pi * f * np.arange(n) / sfreq)
    mid = slice(n // 10, n - n // 10)
    return abs(float(np.dot(y[mid], s[mid]) / np.dot(s[mid], s[mid])))


def transforms_phase(data):
    """Slice 10: the other transforms (MODWT / DWT and shrinkage, packets
    and best bases, filters and resampling, the S-transform, the 2-D DWT
    and CWT) at the JAX package's bench shapes, each against the port's
    own CPU run and the known answers, TF32 on and off identical, timed
    with its peak memory; then the three paths that end in the kernels
    (K1 under ``tfr_power2d``, K1/K2 under the denoised adapter, K4 under
    the filtered recording's power), held against the plain path.  Plain
    torch but for those kernels: nothing joins the kernels' record."""
    import torch
    import ninwavelets_tpu_torch as nt
    from ninwavelets_tpu_torch import kernels
    from ninwavelets_tpu_torch.ops import cwt, cwt2d, dwt, dwt2d, wpt
    from ninwavelets_tpu_torch.ops import filtering as flt
    from ninwavelets_tpu_torch.ops.stockwell import istockwell, stockwell
    from ninwavelets_tpu_torch.parallel import StreamingCWT

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    print(card)
    t_phase = time.perf_counter()
    gen = np.random.default_rng(20)
    torch.cuda.synchronize()
    kernels.reset_launches()

    # -- the discrete transforms at extensions_bench.py:149-163 ---------------
    xh = gen.standard_normal((TR_ROWS, TR_N), dtype=np.float32)
    x = torch.from_numpy(xh).cuda()
    x4 = torch.from_numpy(xh[:CPU_ROWS])
    shape = f"{TR_ROWS} x {TR_N}"
    w = stat_call(f"modwt db8 J={TR_LEVEL} ({shape})",
                  lambda: dwt.modwt(x, "db8", TR_LEVEL), x.neg_, card)
    on_cpu("modwt", w[:CPU_ROWS], lambda: dwt.modwt(x4, "db8", TR_LEVEL))
    energy = w.double().square().sum((-2, -1))
    want = x.double().square().sum(-1)
    e_rel = ((energy - want).abs() / want).max().item()
    print(f"check modwt energy partition: max rel {e_rel} (gate 1e-5)")
    check(e_rel <= 1e-5, f"modwt energy partition {e_rel}")
    round_trip("imodwt", dwt.imodwt(w, "db8"), x)
    del w
    den = stat_call(f"modwt_denoise db8 J={TR_LEVEL} ({shape})",
                    lambda: dwt.modwt_denoise(x, "db8", TR_LEVEL), x.neg_,
                    card)
    denoised_err("modwt_denoise: card vs CPU", den[:CPU_ROWS].cpu(),
                 dwt.modwt_denoise(x4, "db8", TR_LEVEL), x4)
    c = stat_call(f"wavedec db8 J={TR_LEVEL} ({shape})",
                  lambda: dwt.wavedec(x, "db8", TR_LEVEL), x.neg_, card)
    for i, (a, b) in enumerate(zip(c, dwt.wavedec(x4, "db8", TR_LEVEL))):
        rel_err(f"wavedec coefficient array {i}: card vs CPU",
                a[:CPU_ROWS].cpu(), b)
    round_trip("waverec", dwt.waverec(c, "db8"), x)
    del den, c
    p = stat_call(f"modwpt db8 L={TR_PACKETS} ({shape})",
                  lambda: wpt.modwpt(x, "db8", TR_PACKETS), x.neg_, card)
    on_cpu("modwpt", p[:CPU_ROWS], lambda: wpt.modwpt(x4, "db8", TR_PACKETS))
    round_trip("imodwpt", wpt.imodwpt(p, "db8"), x)
    del p
    xb = x[:BB_ROWS]
    nodes, coeffs = stat_call(
        f"best_basis db4, {BB_LEVELS} levels ({BB_ROWS} x {TR_N})",
        lambda: wpt.best_basis(xb, "db4", BB_LEVELS), xb.neg_, card)

    def costs(t):
        tables = {j: wpt.modwpt(t, "db4", j).cpu().numpy()
                  for j in range(1, BB_LEVELS + 1)}
        tables[0] = t.cpu().numpy()[..., None, :]
        return wpt._node_costs(tables, BB_LEVELS, "shannon")

    got, ref = costs(xb), costs(xb.cpu())
    c_rel = max(abs(got[k] - ref[k]) / abs(ref[k]) for k in ref)
    margin = prune_margin(ref, BB_LEVELS)
    nodes_cpu, _ = wpt.best_basis(xb.cpu(), "db4", BB_LEVELS)
    bands = [wpt.node_band(*nd) for nd in nodes]
    tiles = (bands[0][0] == 0.0 and bands[-1][1] == 0.5
             and all(b1 == a2 for (_, b1), (a2, _) in zip(bands, bands[1:])))
    print(f"check best_basis: {len(nodes)} nodes {nodes}; node costs card vs "
          f"CPU max rel {c_rel} (gate 1e-5); smallest decision margin "
          f"{margin} (nodes compared when > 1e-4): card == CPU "
          f"{nodes == nodes_cpu}; the bands tile [0, 1/2) {tiles}")
    check(c_rel <= 1e-5 and tiles, "best_basis costs or tiling")
    check(margin <= 1e-4 or nodes == nodes_cpu, "best_basis nodes differ")
    round_trip("best_basis_reconstruct",
               wpt.best_basis_reconstruct(nodes, coeffs, "db4"), xb)
    del nodes, coeffs, xb, x
    torch.cuda.empty_cache()

    # -- filters and resampling at extensions_bench.py:427-437 ----------------
    rec = recording(3)
    xr = torch.from_numpy(rec).cuda()
    r4 = torch.from_numpy(rec[:CPU_ROWS])
    shape = f"{REC_C} x {REC_N} at {SFREQ:g} Hz"
    bp = stat_call(f"bandpass 1-40 Hz ({shape})",
                   lambda: flt.bandpass(xr, SFREQ, 1.0, 40.0), xr.neg_, card)
    on_cpu("bandpass", bp[:CPU_ROWS], lambda: flt.bandpass(r4, SFREQ, 1.0,
                                                           40.0))
    del bp
    for new in (250.0, 300.0):
        route = ("power-of-two" if new == 250.0 else "any-ratio")
        y = stat_call(f"resample {SFREQ:g} -> {new:g} Hz, the {route} route "
                      f"({shape})",
                      lambda: flt.resample(xr, SFREQ, new)[0], xr.neg_, card)
        on_cpu(f"resample -> {new:g} Hz", y[:CPU_ROWS],
               lambda: flt.resample(r4, SFREQ, new)[0])
        del y
    tone = torch.from_numpy(np.stack([
        np.sin(2 * np.pi * f * np.arange(REC_N) / SFREQ)
        for f in (10.0, 100.0)]).astype(np.float32)).cuda()
    gains = [tone_gain(flt.bandpass(tone[i], SFREQ, 1.0, 40.0).cpu().numpy(),
                       f, REC_N) for i, f in enumerate((10.0, 100.0))]
    print(f"check bandpass 1-40 Hz gain: 10 Hz {gains[0]} (gate [0.95, "
          f"1.05]), 100 Hz {gains[1]} (gate < 0.05)")
    check(0.95 <= gains[0] <= 1.05 and gains[1] < 0.05, "bandpass gains")
    fault = torch.from_numpy(np.sin(
        2 * np.pi * FAULT_HZ * np.arange(max(FAULT_NS)) / SFREQ).astype(
            np.float32)).cuda()
    for n in FAULT_NS:
        t1 = fault[:n]
        y = flt.resample(t1, SFREQ, 300.0)[0]
        rel_err(f"resample {n} samples -> 300 Hz: card vs CPU", y.cpu(),
                flt.resample(t1.cpu(), SFREQ, 300.0)[0])
        y = y.cpu().numpy()
        m = y.shape[-1]
        exact = np.sin(2 * np.pi * FAULT_HZ * np.arange(m) / 300.0)
        mid = slice(m // 10, m - m // 10)
        print(f"fault: resample of a {FAULT_HZ:g} Hz tone, {n} samples, "
              f"{SFREQ:g} -> 300 Hz: max error from the exact sine over the "
              f"interior 80% {np.abs(y[mid] - exact[mid]).max()} (float32 "
              f"output positions, as in the JAX package; not gated), on "
              f"{card}")
    del tone, fault
    rw = nt.RawWavelet(ArrayRaw(rec), nt.Morse(SFREQ, interpolate=True,
                                               device="cuda"),
                       window=REC_WINDOW, batch=REC_BATCH)
    n2 = 1 << (REC_N - 1).bit_length()
    xr = torch.from_numpy(rec).cuda()
    stat_call(f"modwt_denoise of the card's copy ({shape}, padded to {n2}, "
              f"db4 J={dwt.max_level(n2)}; the bank's upload included)",
              lambda: dwt.modwt_denoise(xr, pad_pow2=True), xr.neg_, card)
    del xr
    out = stat_call(f"RawWavelet.modwt_denoise ({shape}, padded to {n2}, "
                    f"db4 J={dwt.max_level(n2)}; host copies included)",
                    lambda: rw.modwt_denoise(), negate(rw), card)
    denoised_err("RawWavelet.modwt_denoise, 4 channels: card vs CPU",
                 torch.from_numpy(out[:CPU_ROWS]),
                 dwt.modwt_denoise(r4, pad_pow2=True), r4)
    del out

    # -- the S-transform ------------------------------------------------------
    freqs_st = np.arange(1.0, ST_F + 1.0)
    xs = torch.from_numpy(gen.standard_normal((ST_E, ST_C, ST_N),
                                              dtype=np.float32)).cuda()
    s = stat_call(f"stockwell ({ST_C} channels x {ST_E} epochs x {ST_N}, "
                  f"{ST_F} rows 1-{ST_F} Hz)",
                  lambda: stockwell(xs, freqs_st, SFREQ), xs.neg_, card)
    on_cpu("stockwell", s[0, :CPU_ROWS],
           lambda: stockwell(xs[0, :CPU_ROWS].cpu(), freqs_st, SFREQ))
    bins = np.rint(freqs_st * ST_N / SFREQ).astype(np.int64)
    mean_rel = rel_err("stockwell time mean x N vs the FFT at the bins",
                       s.mean(-1) * ST_N, torch.fft.fft(xs)[..., bins])
    del s
    phase = gen.uniform(0, 2 * np.pi, (8, 3, 1))
    picked = bins[[9, 39, 79]]                       # 10, 40 and 80 Hz rows
    aligned = torch.from_numpy(np.cos(
        2 * np.pi * picked[:, None] * np.arange(ST_N) / ST_N + phase).sum(
            1).astype(np.float32)).cuda()
    round_trip("istockwell(stockwell(x)) of a bin-aligned signal",
               istockwell(stockwell(aligned, freqs_st, SFREQ), freqs_st,
                          SFREQ, ST_N), aligned)
    del xs, mean_rel

    # -- the 2-D transforms at extensions_bench.py:523-570 ---------------------
    for count in (IMG_FEW, IMG_MANY):
        imgs = torch.from_numpy(gen.standard_normal(
            (count, IMG_HW, IMG_HW), dtype=np.float32)).cuda()
        i2 = imgs[:CPU_IMGS].cpu()
        out = {}
        for use_fft in (False, True):
            out[use_fft] = stat_call(
                f"power2d {len(IMG_FREQS)} freqs x 6 orientations "
                f"({count} x {IMG_HW} x {IMG_HW}, "
                f"{'use_fft=True' if use_fft else 'default path'})",
                lambda: cwt2d.power2d(imgs, IMG_FREQS, use_fft=use_fft),
                imgs.neg_, card)
            on_cpu(f"power2d use_fft={use_fft}", out[use_fft][:CPU_IMGS],
                   lambda: cwt2d.power2d(i2, IMG_FREQS, use_fft=use_fft))
        rel_err("power2d default path vs use_fft=True", out[False],
                out[True])
        del out
        if count == IMG_MANY:
            c2 = stat_call(f"wavedec2 db4 level {IMG_LEVEL} ({count} x "
                           f"{IMG_HW} x {IMG_HW})",
                           lambda: dwt2d.wavedec2(imgs, "db4", IMG_LEVEL),
                           imgs.neg_, card)
            ref = dwt2d.wavedec2(i2, "db4", IMG_LEVEL)
            rel_err("wavedec2 LL: card vs CPU", c2[0][:CPU_IMGS].cpu(),
                    ref[0])
            for lev, (dg, dr) in enumerate(zip(c2[1:], ref[1:])):
                for band, a, b in zip(("LH", "HL", "HH"), dg, dr):
                    rel_err(f"wavedec2 {band} {IMG_LEVEL - lev}: card vs "
                            "CPU", a[:CPU_IMGS].cpu(), b)
            flat = [c2[0]] + [t for d in c2[1:] for t in d]
            back = stat_call(f"waverec2 db4 level {IMG_LEVEL} ({count} x "
                             f"{IMG_HW} x {IMG_HW})",
                             lambda: dwt2d.waverec2(c2, "db4"),
                             lambda: [t.neg_() for t in flat], card)
            round_trip("waverec2", back, imgs)
            del c2, flat, back
        del imgs
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    print(f"the plain transforms launched {counts} (none)")
    check(not any(counts.values()), f"the plain transforms launched {counts}")
    torch.cuda.empty_cache()

    # -- the paths that end in the kernels -------------------------------------
    freqs = np.arange(1.0, F + 1.0)
    rec_freqs = np.linspace(2.0, 100.0, REC_F)
    ew = nt.EpochsWavelet(nt.ArrayEpochs(data, SFREQ),
                          nt.Morse(SFREQ, interpolate=True, device="cuda"))
    n_batches = -(-REC_N // (REC_WINDOW * REC_BATCH))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    tfr, crop = ew.tfr_power2d("ch0", freqs)
    dew = ew.modwt_denoise()
    den_power = dew.power_all(freqs)
    den_itc = dew.itc_all(freqs)
    filtered = rw.filter(1.0, 40.0, notch_hz=50.0)
    rw_f = nt.RawWavelet(ArrayRaw(filtered), nt.Morse(
        SFREQ, interpolate=True, device="cuda"), window=REC_WINDOW,
        batch=REC_BATCH)
    plane = rw_f.power(rec_freqs)
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    print(f"transforms kernel paths {time.perf_counter() - t0} s (first "
          f"calls: banks and host copies included; peak "
          f"{torch.cuda.max_memory_allocated()} bytes allocated); launches "
          f"{counts}, on {card}")
    want = {"power": 2, "itc": 1, "power_each": n_batches}
    check({k: v for k, v in counts.items() if v} == want,
          f"transforms kernel paths launched {counts}, want {want}")
    check(tuple(tfr.shape) == (4, 6, 128, N) and crop == (F, N)
          and bool(tfr.isfinite().all()), "tfr_power2d result")

    # tfr_power2d: K1's plane, then the 2-D CWT of its log1p, against the
    # plain plane; the plane's error carried through log1p (1-Lipschitz)
    # and the 2-D CWT (|dW| <= max|d img| x ||psi||_1 a row) into the power
    x0 = ew._channel_data("ch0")
    plain = cwt.mean_power_from_bank(x0[:, None, :],
                                     ew._bank_for(x0, freqs), True)[0]
    d_img = rel_err("tfr_power2d plane (K1 'power') vs plain",
                    ew.power("ch0", freqs), plain)
    padded, _ = cwt2d.pow2_pad2(torch.log1p(plain))
    ref_w = cwt2d.cwt2(padded, (0.02, 0.05, 0.1, 0.2))
    ref_p = ref_w.real.square() + ref_w.imag.square()
    psi = torch.fft.ifft2(cwt2d.morlet2d_bank(
        (0.02, 0.05, 0.1, 0.2), np.arange(6) * np.pi / 6.0, *padded.shape,
        device="cuda")).abs().sum((-2, -1))[..., None, None]
    e = d_img * psi
    bound = (2 * ref_w.abs() * e + e * e
             + POWER_RTOL * ref_p.abs().max())
    ratio = ((tfr - ref_p).abs() / bound).max().item()
    print(f"check tfr_power2d vs the plain plane's: max|d| "
          f"{(tfr - ref_p).abs().max().item()}, max|d| / (2 |W| e + e^2 + "
          f"{POWER_RTOL} max P) {ratio} (gate 1), e = max|d plane| x "
          f"||psi||_1")
    check(ratio <= 1.0, f"tfr_power2d {ratio}")
    del x0, plain, padded, ref_w, ref_p, psi, e, bound, tfr

    # modwt_denoise(): the cleaned trials, then K1/K2 at slice 1's gates
    rows = torch.from_numpy(data.reshape(-1, N)[:CPU_ROWS])
    denoised_err("EpochsWavelet.modwt_denoise data, 4 rows: card vs CPU",
                 torch.from_numpy(dew._host_data().reshape(-1, N)[
                     :CPU_ROWS]), dwt.modwt_denoise(rows, pad_pow2=True),
                 rows)
    xd = dew._all_data()
    bank = dew._bank_for(xd, freqs)
    ref_power = cwt.mean_power_from_bank(xd, bank, True)
    rel_err("modwt_denoise().power_all (K1) vs plain", den_power, ref_power)
    sound_itc_err("modwt_denoise().itc_all (K2) vs plain", den_itc,
                  cwt.itc_from_bank(xd, bank, True),
                  sound_cells(xd, xd, bank, True))
    del xd, ref_power, den_power, den_itc
    torch.cuda.empty_cache()

    # the filtered recording: the CPU run, the line gone, K4 against plain
    rel_err("RawWavelet.filter(1, 40, notch 50), 4 channels: card vs CPU",
            torch.from_numpy(filtered[:CPU_ROWS]),
            flt.notch(flt.bandpass(r4, SFREQ, 1.0, 40.0), SFREQ, 50.0))
    g60 = tone_gain(filtered[0], 60.0, REC_N)
    print(f"check the filtered recording: channel 0's 60 Hz tone gain "
          f"{g60} (gate < 0.01)")
    check(g60 < 0.01, f"60 Hz gain {g60}")
    check(tuple(plane.shape) == (REC_C, REC_F, REC_N)
          and bool(plane.isfinite().all()), "filtered plane")
    plane4 = plane[:CPU_ROWS].clone()
    del plane
    torch.cuda.empty_cache()
    plain_stream = StreamingCWT(rw_f.wavelet._wdef(), rec_freqs, SFREQ,
                                window=REC_WINDOW, interpolate=True,
                                use_fused=False, batch=REC_BATCH,
                                device="cuda")
    rel_err("filtered RawWavelet.power (K4), 4 channels, vs "
            "StreamingCWT(use_fused=False)", plane4,
            plain_stream.power_device(filtered[:CPU_ROWS]))
    del plane4, plain_stream

    # times of the user calls on these paths
    stat_call(f"EpochsWavelet.tfr_power2d ({E} x {F} x {N} plane of one "
              "channel, 4 x 6 2-D rows)",
              lambda: ew.tfr_power2d("ch0", freqs), negate(ew), card)
    stat_call(f"EpochsWavelet.modwt_denoise ({E} x {C} x {N}, db4, host "
              "copies included)", lambda: ew.modwt_denoise()._host_data(),
              negate(ew), card)
    stat_call(f"modwt_denoise().power_all ({E} x {C} x {N} x {F})",
              lambda: dew.power_all(freqs), negate(dew), card)
    stat_call(f"RawWavelet.filter(1, 40, notch_hz=50) ({shape}, host copies "
              "included)", lambda: rw.filter(1.0, 40.0, notch_hz=50.0),
              negate(rw), card)
    names = rw_f.raw.ch_names[:CPU_ROWS]
    stat_call(f"RawWavelet.power of the filtered recording, {CPU_ROWS} "
              "channels", lambda: rw_f.power(rec_freqs, picks=names),
              negate(rw_f), card)
    print(f"transforms phase {time.perf_counter() - t_phase} s")


# -- slice 11: the decompositions -------------------------------------------

DEC_CPU_ROWS = 4
EMD_CPU_ROWS = 8
HMM_K, HMM_D = 4, 12


def close(name, got, ref, gate=POWER_RTOL, scale=None):
    """max|d| <= gate x ``scale`` (default max|ref|), on the host."""
    import torch
    got = torch.as_tensor(got).detach().cpu().double()
    ref = torch.as_tensor(ref).detach().cpu().double()
    check(got.shape == ref.shape, f"{name}: shape {tuple(got.shape)} != "
          f"{tuple(ref.shape)}")
    check(bool(got.isfinite().all()), f"{name}: non-finite values")
    scale = ref.abs().max().item() if scale is None else scale
    err = (got - ref).abs().max().item()
    print(f"check {name}: max|d| {err}, / scale {err / scale} (gate "
          f"{gate})")
    check(err <= gate * scale, f"{name}: {err / scale} > {gate}")


def rows_agree(name, got, ref, x):
    """Rows of IMFs (R, M, N) on the card against the CPU's: a row agrees
    when it is within 1e-4 of its signal's max|x|; all rows but one in
    eight must.  An extremum that compares two samples within round-off
    can flip between the two and change every later sifting of its
    row."""
    import torch
    got = got.detach().cpu().double()
    ref = ref.double()
    d = (got - ref).abs().flatten(1).amax(-1)
    scale = torch.from_numpy(np.abs(x)).double().flatten(1).amax(-1)
    ok = d <= 1e-4 * scale
    need = len(ok) - len(ok) // 8
    print(f"check {name}: card vs CPU, {int(ok.sum())} of {len(ok)} rows "
          f"within 1e-4 of max|x| (gate >= {need}); max|d| / max|x| "
          f"{(d / scale).max().item()}")
    check(int(ok.sum()) >= need and bool(got.isfinite().all()),
          f"{name}: {int(ok.sum())} rows agree")


def fractal_rows(rows, n, seed):
    """1/f^2 rows (a detrended random walk) plus a 10 Hz tone at 500 Hz:
    ``tests/test_irasa.py``'s signal."""
    rng = np.random.default_rng(seed)
    w = np.cumsum(rng.standard_normal((rows, n)), -1)
    w -= w[:, :1] + (w[:, -1:] - w[:, :1]) * np.linspace(0.0, 1.0, n)
    t = np.arange(n) / 500.0
    return (5.0 * w / np.abs(w).max(-1, keepdims=True)
            + 0.8 * np.sin(2 * np.pi * 10.0 * t)).astype(np.float32)


def hmm_frames(b, t, seed):
    """(b, t, HMM_D) frames sampled from a sticky HMM_K-state chain."""
    rng = np.random.default_rng(seed)
    means = 1.5 * rng.standard_normal((HMM_K, HMM_D))
    a = np.full((HMM_K, HMM_K), 0.02 / (HMM_K - 1))
    np.fill_diagonal(a, 0.98)
    s = np.zeros((b, t), np.int64)
    s[:, 0] = rng.integers(0, HMM_K, b)
    u = rng.random((b, t))
    cum = np.cumsum(a, 1)
    for i in range(1, t):
        s[:, i] = (u[:, i, None] > cum[s[:, i - 1]]).sum(-1).clip(
            max=HMM_K - 1)
    return (means[s] + 0.8 * rng.standard_normal((b, t, HMM_D))).astype(
        np.float32)


def decomposition_phase(data):
    """Slice 11: the decompositions (Welch / IRASA, specparam, EWT, VMD,
    EMD / EEMD, matching pursuit, CP / PARAFAC, cycle features, HMM
    states) at the JAX package's bench shapes, each against the port's own
    CPU run and the known answers, timed with its peak memory, no kernel
    launched; then the adapter paths at full width, whose power rides K1
    and K4 (launches printed and required).  Plain torch but for those
    kernels: nothing joins the kernels' record."""
    import torch
    import ninwavelets_tpu_torch as nt
    from ninwavelets_tpu_torch.ops.cpd import (_cp_from_factors,
                                               cp_decompose, cp_reconstruct)
    from ninwavelets_tpu_torch.ops.cycles import cycle_features
    from ninwavelets_tpu_torch.ops.emd import _eemd_from_noise, eemd, emd
    from ninwavelets_tpu_torch.ops.ewt import ewt
    from ninwavelets_tpu_torch.ops.hmm import _hmm_from_perms, hmm_fit
    from ninwavelets_tpu_torch.ops.irasa import aperiodic_fit, irasa
    from ninwavelets_tpu_torch.ops.mp import matching_pursuit
    from ninwavelets_tpu_torch.ops.specparam import specparam
    from ninwavelets_tpu_torch.ops.vmd import vmd
    from ninwavelets_tpu_torch.parallel.chunked import halo_samples

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    print(card)
    t_phase = time.perf_counter()
    gen = np.random.default_rng(11)
    launched = {}

    def none_launched(name, counts):
        launched.update(counts)
        check(not counts, f"{name} launched {counts}")

    # -- matching pursuit (extensions_bench.py:358) ---------------------------
    xh = gen.standard_normal((8, 4, 1024), dtype=np.float32)
    x = torch.from_numpy(xh).cuda()
    res, counts, _ = timed_call(
        "matching_pursuit 8 x 4 x 1024, 20 atoms, 250 Hz",
        lambda: matching_pursuit(x, 20, 250.0), x.normal_, card)
    none_launched("matching_pursuit", counts)
    ref = matching_pursuit(torch.from_numpy(xh[0]), 20, 250.0, device="cpu")
    for f in ("scale_s", "freq_hz"):
        same = torch.equal(getattr(res, f)[0].cpu(), getattr(ref, f))
        print(f"check matching_pursuit {f}: card == CPU {same}")
        check(same, f"matching_pursuit {f} differs from the CPU run")
    # a wide atom's correlation peak is flat: its neighbouring translations
    # are within round-off of each other
    shift = ((res.time_s[0].cpu() - ref.time_s).abs().max() * 250.0).item()
    print(f"check matching_pursuit time_s: card vs CPU at most {shift} "
          "samples apart (gate 1)")
    check(shift <= 1.0 + 1e-3, f"matching_pursuit time_s {shift} samples")
    for f in ("amplitude", "energy", "residual"):
        close(f"matching_pursuit {f}: card vs CPU", getattr(res, f)[0],
              getattr(ref, f), 1e-4)
    x0 = torch.from_numpy(xh).cuda().double()
    removed = res.energy.double().sum(-1) + res.residual.double().square(
        ).sum(-1)
    e_rel = ((removed - x0.square().sum(-1)).abs()
             / x0.square().sum(-1)).max().item()
    print(f"check matching_pursuit energies + residual energy = signal "
          f"energy: max rel {e_rel} (gate 1e-4)")
    check(e_rel <= 1e-4, f"matching_pursuit energy {e_rel}")
    del x, x0, res

    # -- IRASA (:368) ---------------------------------------------------------
    xh = fractal_rows(16, 60_000, 3)
    x = torch.from_numpy(xh).cuda()
    res, counts, _ = timed_call("irasa 16 x 60,000, 500 Hz",
                                 lambda: irasa(x, 500.0), x.neg_, card)
    none_launched("irasa", counts)
    ref = irasa(torch.from_numpy(xh[:2]), 500.0, device="cpu")
    for f in ("psd", "fractal", "oscillatory"):
        close(f"irasa {f}: card vs CPU", getattr(res, f)[:2],
              getattr(ref, f), scale=ref.psd.abs().max().item())
    close("irasa fractal + oscillatory vs psd", res.fractal
          + res.oscillatory, res.psd, 1e-6)
    _, chi = aperiodic_fit(res.freqs, res.fractal)
    peak = res.freqs[res.oscillatory.argmax(-1)]
    print(f"check irasa exponent of the 1/f^2 rows: {chi.min().item()} .. "
          f"{chi.max().item()} (gate 2 +- 0.35); oscillatory peak "
          f"{peak.min().item()} .. {peak.max().item()} Hz (gate 10 +- 0.5)")
    check(bool(((chi - 2.0).abs() < 0.35).all()), "irasa exponent")
    check(bool(((peak - 10.0).abs() < 0.5).all()), "irasa peak")
    del x, res

    # -- EMD / EEMD (:377-390) ------------------------------------------------
    xh = gen.standard_normal((64, 2048), dtype=np.float32)
    x = torch.from_numpy(xh).cuda()
    (imfs, resid), counts, _ = timed_call(
        "emd 64 x 2048, 6 IMFs", lambda: emd(x, n_imfs=6), x.normal_, card)
    none_launched("emd", counts)
    x0 = torch.from_numpy(xh).cuda()
    done = (imfs.sum(-2) + resid - x0).abs().max().item()
    print(f"check emd completeness: max|sum(imfs) + residual - x| {done} "
          "(gate 2e-5)")
    check(done <= 2e-5, f"emd completeness {done}")
    ri, _ = emd(torch.from_numpy(xh[:EMD_CPU_ROWS]), n_imfs=6,
                device="cpu")
    rows_agree("emd imfs", imfs[:EMD_CPU_ROWS], ri, xh[:EMD_CPU_ROWS])
    e1 = torch.from_numpy(xh[0]).cuda()
    (ei, er), counts, _ = timed_call(
        "eemd 2048 samples, 6 IMFs, 64 ensembles",
        lambda: eemd(e1, n_imfs=6, n_ensembles=64), e1.normal_, card)
    none_launched("eemd", counts)
    noise = torch.randn((64, 1, 2048), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(0))
    e0 = torch.from_numpy(xh[:1]).cuda()
    ci, cr = _eemd_from_noise(e0, noise, n_imfs=6, n_siftings=10,
                              spline="natural", noise_strength=0.2)
    done = (ci.sum(-2) + cr - e0).abs().max().item()
    print(f"check eemd completeness: {done} (gate 2e-5)")
    check(done <= 2e-5, f"eemd completeness {done}")
    # the ensemble's realizations, sifted on the card and on the CPU
    ens = (e0 + 0.2 * e0.std(-1, correction=0, keepdim=True) * noise)[:, 0]
    ei, _ = emd(ens, n_imfs=6)
    hi, _ = emd(ens.cpu(), n_imfs=6, device="cpu")
    rows_agree("eemd realizations", ei, hi, ens.cpu().numpy())
    hi, _ = _eemd_from_noise(e0.cpu(), noise.cpu(), n_imfs=6, n_siftings=10,
                             spline="natural", noise_strength=0.2)
    d = (ci.cpu() - hi).abs().max().item() / float(np.abs(xh[0]).max())
    print(f"eemd imfs (the card's noise): card vs CPU max|d| / max|x| {d} "
          "(not gated: the mean over the realizations above)")
    del x, x0, imfs, resid, e1, ei, er, ci, cr, noise

    # -- CP / PARAFAC (:392) --------------------------------------------------
    xh = np.abs(gen.standard_normal((64, 100, 512), dtype=np.float32))
    x = torch.from_numpy(xh).cuda()
    (w, facs, fit), counts, _ = timed_call(
        "cp_decompose rank 3, 64 x 100 x 512, 100 sweeps",
        lambda: cp_decompose(x, 3, n_iter=100),
        lambda: x.normal_().abs_(), card)
    none_launched("cp_decompose", counts)
    x.copy_(torch.from_numpy(xh))
    f0 = [torch.randn((s, 3), device="cuda", generator=torch.Generator(
        "cuda").manual_seed(m)) for m, s in enumerate(xh.shape)]
    w, facs, fit = _cp_from_factors(x, f0, n_iter=100, nonneg=False,
                                    ridge=1e-6)
    wr, fr, fitr = _cp_from_factors(torch.from_numpy(xh),
                                    [f.cpu() for f in f0], n_iter=100,
                                    nonneg=False, ridge=1e-6)
    close("cp fit: card vs CPU", fit, fitr, scale=1.0)
    close("cp model (cp_reconstruct): card vs CPU", cp_reconstruct(w, facs),
          cp_reconstruct(wr, fr), 1e-4)
    # a rank-3 model of |noise| is ill-posed: its components drift along
    # flat directions of the fit, where ALS accumulates round-off
    close("cp weights: card vs CPU", w, wr, 1e-3)
    for m in range(3):
        close(f"cp factor {m}: card vs CPU", facs[m], fr[m], 1e-3)
    planted = [torch.from_numpy(np.abs(gen.standard_normal(
        (s, 3))).astype(np.float32) + 0.1).cuda() for s in xh.shape]
    exact = cp_reconstruct(torch.tensor([3.0, 2.0, 1.0], device="cuda"),
                           planted)
    fit3 = float(cp_decompose(exact, 3, n_iter=100)[2])
    print(f"check cp fit of an exact rank-3 tensor: {fit3} (gate > 0.999)")
    check(fit3 > 0.999, f"cp exact fit {fit3}")
    del x, w, facs, exact, planted, f0

    # -- cycle features (:400) ------------------------------------------------
    t = np.arange(4096) / SFREQ
    xh = (np.sin(2 * np.pi * 10.0 * t)
          + 0.1 * gen.standard_normal((64, 4096))).astype(np.float32)
    x = torch.from_numpy(xh).cuda()
    tab, counts, _ = timed_call(
        "cycle_features 64 x 4096, 6-15 Hz",
        lambda: cycle_features(x, SFREQ, (6.0, 15.0)), x.neg_, card)
    none_launched("cycle_features", counts)
    ref = cycle_features(torch.from_numpy(xh[:DEC_CPU_ROWS]), SFREQ,
                         (6.0, 15.0), device="cpu")
    for f, a, b in zip(tab._fields, tab, ref):
        if a.dtype in (torch.bool, torch.int32):
            same = torch.equal(a[:DEC_CPU_ROWS].cpu(), b)
            print(f"check cycle_features {f}: card == CPU {same}")
            check(same, f"cycle_features {f} differs from the CPU run")
        else:
            close(f"cycle_features {f}: card vs CPU", a[:DEC_CPU_ROWS], b)
    valid = torch.arange(tab.freq_hz.shape[-1], device="cuda") \
        < tab.n_cycles[:, None]
    fmed = tab.freq_hz[valid].median().item()
    print(f"check cycle_features median cycle frequency {fmed} Hz (gate "
          "10 +- 0.5)")
    check(abs(fmed - 10.0) < 0.5, f"cycle frequency {fmed}")
    del x, tab, valid

    # -- HMM states (:411) ----------------------------------------------------
    xh = hmm_frames(8, 6000, 4)
    x = torch.from_numpy(xh).cuda()
    res, counts, hmm_ms = timed_call(
        f"hmm_fit 8 x 6000 x {HMM_D}, K = {HMM_K}, 50 iterations",
        lambda: hmm_fit(x, HMM_K, n_iter=50), x.neg_, card)
    none_launched("hmm_fit", counts)
    ll = res.loglik.double()
    drop = (ll[:-1] - ll[1:]).clamp(min=0) / ll[1:].abs()
    print(f"check hmm loglik trace: {ll[0].item()} -> {ll[-1].item()}, "
          f"largest relative drop {drop.max().item()} (gate 1e-5)")
    check(drop.max().item() <= 1e-5 and ll[-1] > ll[0], "hmm loglik trace")
    perms = torch.randperm(2 * 6000, device="cuda",
                           generator=torch.Generator("cuda").manual_seed(0))
    two = torch.from_numpy(xh[:2])
    rc = _hmm_from_perms(two.cuda(), perms[None], n_states=HMM_K, n_iter=50,
                         stickiness=0.9)
    rh = _hmm_from_perms(two, perms[None].cpu(), n_states=HMM_K, n_iter=50,
                         stickiness=0.9)
    close("hmm gamma (2 sequences): card vs CPU", rc.gamma, rh.gamma, 1e-4,
          1.0)
    close("hmm means: card vs CPU", rc.means, rh.means, 1e-3, 1.0)
    close("hmm loglik: card vs CPU", rc.loglik, rh.loglik, 1e-5,
          rh.loglik.abs().max().item())
    same = torch.equal(rc.states.cpu(), rh.states)
    print(f"check hmm Viterbi paths: card == CPU {same}")
    check(same, "hmm Viterbi paths differ from the CPU run")
    del x, res, rc, rh

    # -- specparam (:749) -----------------------------------------------------
    sp_f = np.linspace(2.0, 60.0, 117)
    xh = (10.0 / sp_f[None, :] ** 1.2
          + 2.0 * np.exp(-0.5 * ((sp_f[None, :] - 10.0) / 1.5) ** 2)
          + 0.05 * gen.random((64, sp_f.size))).astype(np.float32)
    x = torch.from_numpy(xh).cuda()
    fit, counts, sp_ms = timed_call(
        "specparam 64 spectra x 117 freqs, 500 steps",
        lambda: specparam(x, sp_f, n_steps=500), lambda: x.mul_(1.001),
        card)
    none_launched("specparam", counts)
    ref = specparam(torch.from_numpy(xh), sp_f, n_steps=500, device="cpu")
    close("specparam model: card vs CPU", fit.model, ref.model, 5e-3)
    close("specparam exponent: card vs CPU", fit.exponent, ref.exponent,
          2e-3)
    close("specparam r2: card vs CPU", fit.r_squared, ref.r_squared, 1e-4,
          1.0)
    top = np.take_along_axis(fit.centers, fit.amplitudes.argmax(-1)[:, None],
                             -1)[:, 0]
    print(f"check specparam exponent {fit.exponent.min()} .. "
          f"{fit.exponent.max()} (gate 1.2 +- 0.15), largest peak "
          f"{top.min()} .. {top.max()} Hz (gate 10 +- 1)")
    check(bool((np.abs(fit.exponent - 1.2) < 0.15).all()),
          "specparam exponent")
    check(bool((np.abs(top - 10.0) < 1.0).all()), "specparam peak")
    del x

    # -- VMD and EWT (:784-795) -----------------------------------------------
    t = np.arange(4096) / 250.0
    xh = (np.sin(2 * np.pi * 5 * t) + np.sin(2 * np.pi * 25 * t)
          + 0.1 * gen.standard_normal(4096)).astype(np.float32)
    x = torch.from_numpy(xh).cuda()
    (modes, centers), counts, _ = timed_call(
        "vmd 4096 samples, 3 modes, 200 iterations",
        lambda: vmd(x, 250.0, n_modes=3), x.neg_, card)
    none_launched("vmd", counts)
    rm, rc = vmd(torch.from_numpy(xh), 250.0, n_modes=3, device="cpu")
    close("vmd modes: card vs CPU", modes, rm)
    close("vmd centers: card vs CPU", centers, rc)
    cen = sorted(centers.tolist())
    print(f"check vmd centers {cen} (two within 1 Hz of 5 and 25 Hz)")
    check(min(abs(c - 5.0) for c in cen) < 1.0
          and min(abs(c - 25.0) for c in cen) < 1.0, f"vmd centers {cen}")
    (modes, bounds), counts, _ = timed_call(
        "ewt 4096 samples, 3 modes", lambda: ewt(x, 250.0, n_modes=3),
        x.neg_, card)
    none_launched("ewt", counts)
    rm, rb = ewt(torch.from_numpy(xh), 250.0, n_modes=3, device="cpu")
    check(np.array_equal(bounds, rb), f"ewt boundaries {bounds} != {rb}")
    close("ewt modes: card vs CPU", modes, rm)
    close("ewt modes sum to the signal", modes.sum(-2), x)
    del x, modes

    # -- the adapter paths at full width --------------------------------------
    freqs = np.arange(1.0, F + 1.0)
    ew = nt.EpochsWavelet(nt.ArrayEpochs(data, SFREQ),
                          nt.Morse(SFREQ, interpolate=True, device="cuda"))
    rec = recording(2)
    rw = nt.RawWavelet(ArrayRaw(rec), nt.Morse(
        SFREQ, interpolate=True, device="cuda"), window=REC_WINDOW,
        batch=REC_BATCH)
    n_batches = -(-REC_N // (REC_WINDOW * REC_BATCH))
    # states' delta band starts at 1 Hz, whose halo is about twice 2 Hz's:
    # the window that extends to 16384 (K4) is shorter
    morse_s = nt.Morse(SFREQ, interpolate=True, device="cuda")
    st_window = (REC_EXT - 2 * halo_samples(morse_s._wdef(), 1.0, SFREQ)) \
        // 2 * 2
    rw_s = nt.RawWavelet(ArrayRaw(rec), morse_s, window=st_window,
                         batch=REC_BATCH)
    st_batches = -(-REC_N // (st_window * REC_BATCH))
    shape = f"{E} x {C} x {N} x {F}"
    adapter = {}

    def path(name, fn, fresh, want):
        out, counts, ms = timed_call(name, fn, fresh, card)
        adapter[name] = counts
        check(counts == want, f"{name} launched {counts}, want {want}")
        return out, ms

    (w, facs, fit), _ = path(
        f"EpochsWavelet.cp_power cfn rank 3 ({shape})",
        lambda: ew.cp_power(freqs, 3), negate(ew), {"power": 1})
    print(f"check cp_power cfn: fit {float(fit)}, factor shapes "
          f"{[tuple(f.shape) for f in facs]}")
    check(0.0 < float(fit) <= 1.0, f"cp_power cfn fit {float(fit)}")
    (w, facs, fit), _ = path(
        f"EpochsWavelet.cp_power efn rank 3, ch0 ({shape})",
        lambda: ew.cp_power(freqs, 3, tensor="efn", ch_name="ch0"),
        negate(ew), {"power_each": 1})
    check(0.0 < float(fit) <= 1.0, f"cp_power efn fit {float(fit)}")
    fit, ep_sp_ms = path(f"EpochsWavelet.specparam ch0 ({shape}), 2000 "
                         "steps", lambda: ew.specparam("ch0", freqs),
                         negate(ew), {"power": 1})
    print(f"check EpochsWavelet.specparam: exponent {fit.exponent}, r2 "
          f"{fit.r_squared}")
    check(bool(np.isfinite(fit.model).all()), "specparam model")
    res, _ = path(f"EpochsWavelet.matching_pursuit ch0 ({E} x {N}), 20 "
                  "atoms", lambda: ew.matching_pursuit("ch0"), negate(ew),
                  {})
    check(bool(res.residual.isfinite().all()), "matching_pursuit residual")
    del ew, res
    torch.cuda.empty_cache()

    rshape = f"{REC_C} x {REC_N}"
    res, states_ms = path(
        f"RawWavelet.states K = 4 ({rshape}, 16 rows, window {st_window}, "
        "50 iterations)", lambda: rw_s.states(), negate(rw_s),
        {"power_each": st_batches})
    ll = res.loglik.double()
    drop = ((ll[:-1] - ll[1:]).clamp(min=0) / ll[1:].abs()).max().item()
    print(f"check RawWavelet.states: {tuple(res.gamma.shape)} gamma, "
          f"{tuple(res.means.shape)} means, loglik {ll[0].item()} -> "
          f"{ll[-1].item()}, largest relative drop {drop} (gate 1e-5)")
    check(drop <= 1e-5 and bool(res.gamma.isfinite().all()),
          "RawWavelet.states")
    rec_freqs = np.linspace(2.0, 100.0, REC_F)
    fit, raw_sp_ms = path(
        f"RawWavelet.specparam ({rshape} x {REC_F}), 2000 steps",
        lambda: rw.specparam(rec_freqs), negate(rw),
        {"power_each": n_batches})
    check(fit.exponent.shape == (REC_C,) and bool(np.isfinite(
        fit.r_squared).all()), "RawWavelet.specparam")
    res, _ = path(f"RawWavelet.irasa ({rshape})", lambda: rw.irasa(),
                  negate(rw), {})
    close("RawWavelet.irasa fractal + oscillatory vs psd", res.fractal
          + res.oscillatory, res.psd, 1e-6)
    (pf, pp), _ = path(f"RawWavelet.psd ({rshape})", lambda: rw.psd(),
                       negate(rw), {})
    check(pp.shape == (REC_C, 513) and bool(np.isfinite(pp).all()),
          "RawWavelet.psd")
    print(f"decomposition adapter launches {adapter}, on {card}")
    print(f"decomposition phase {time.perf_counter() - t_phase} s; "
          f"hmm_fit {hmm_ms} ms, RawWavelet.states {states_ms} ms, "
          f"specparam (500 steps, 64 spectra) {sp_ms} ms, "
          f"EpochsWavelet.specparam {ep_sp_ms} ms, RawWavelet.specparam "
          f"{raw_sp_ms} ms")


# -- slice 12: sensor-space preprocessing and decoding ------------------------

SENSOR_SF = 250.0
CHAIN_C, CHAIN_N = 64, 250_000
CHAIN_TMIN, CHAIN_TMAX = -0.5, 1.544          # 512-sample epochs at 250 Hz
CHAIN_STEP = 2.1                              # s between events
CHAIN_FLAT, CHAIN_NOISY = 5, 20
TIE_MARGIN = 1e-5


def near_tie_slack(sa, sb, tr_a, tr_b):
    """Per output cell, the most a fold-mean AUC can move by held-out pairs
    whose two scores are within TIE_MARGIN of the fold's largest |score|
    (each worth 1 / (na nb)): ``tests/test_torch_riemann_decoding.py``'s
    rule."""
    import torch
    out = 0.0
    for f in range(tr_a.shape[0]):
        a = sa[f][tr_a[f] == 0]
        b = sb[f][tr_b[f] == 0]
        scale = torch.cat([a.abs().flatten(), b.abs().flatten()]).max()
        step = max(1, (1 << 28) // max(b.numel() * 4, 1))
        close = sum(((a[i:i + step, None] - b[None]).abs()
                     <= TIE_MARGIN * scale).sum((0, 1)).double()
                    for i in range(0, a.shape[0], step))
        out = out + close / (a.shape[0] * b.shape[0])
    return (out / tr_a.shape[0]).cpu().numpy()


def auc_agree(name, got, ref, slack):
    """AUCs on the card against the CPU run's: equal (1e-6) where no pair
    is near a tie, else within the near-tie pairs' worth; at least 90% of
    the cells sound."""
    import torch
    got = torch.as_tensor(got).detach().cpu().double().numpy()
    ref = torch.as_tensor(ref).detach().cpu().double().numpy()
    slack = np.broadcast_to(slack, ref.shape)
    d = np.abs(got - ref)
    sound = float((slack == 0).mean())
    print(f"check {name}: card vs CPU max|d| {d.max()} (gate 1e-6 + near-tie "
          f"slack, max slack {slack.max()}), sound cells {sound} (gate 0.9)")
    check(sound >= 0.9 and bool((d <= 1e-6 + slack).all()),
          f"{name}: AUCs differ beyond the near-tie rule")


def lda_slack(xa, xb, scores, n_folds=5, lam=1e-3):
    from ninwavelets_tpu_torch.ops import decoding as dec
    tr_a = dec._fold_masks(xa.shape[0], n_folds, xa.device)
    tr_b = dec._fold_masks(xb.shape[0], n_folds, xb.device)
    sa, sb = [], []
    for f in range(n_folds):
        w = dec._lda_weights(xa, xb, tr_a[f], tr_b[f], lam)
        sa.append(scores(xa, w))
        sb.append(scores(xb, w))
    return near_tie_slack(sa, sb, tr_a, tr_b)


def eig_gaps(spectrum):
    v = np.asarray(spectrum, np.float64)
    return (np.abs(v[:, None] - v[None, :])
            + np.diag(np.full(v.size, np.inf))).min(1)


def cols_agree(name, got, ref, spectrum, pick):
    """Columns at the eigenvector gate of their eigenvalue: 1e-5 + 1e-6 x
    max|lam| / gap_k of the column's max (``tests/test_torch_spatial.py``);
    the gaps asserted above 1e-3 of the spectrum's range."""
    import torch
    spectrum = np.asarray(torch.as_tensor(spectrum).cpu(), np.float64)
    gaps = eig_gaps(spectrum)[pick]
    gate = 1e-5 + 1e-6 * np.abs(spectrum).max() / gaps
    got = torch.as_tensor(got).detach().cpu().double().numpy()
    ref = torch.as_tensor(ref).detach().cpu().double().numpy()
    d = np.abs(got - ref).max(0) / np.abs(ref).max(0)
    print(f"check {name}: card vs CPU per column max|d| / max {d} (gates "
          f"{gate}; gaps / range {gaps / np.ptp(spectrum)})")
    check(bool((gaps > 1e-3 * np.ptp(spectrum)).all() and (d <= gate).all()),
          f"{name}: columns differ beyond the eigenvector gate")


def signed_rows(got, ref):
    import torch
    got = torch.as_tensor(got).detach().cpu()
    ref = torch.as_tensor(ref).detach().cpu()
    return got * torch.sign((got * ref).sum(1, keepdim=True))


def asr_split_gaps(x, keep, win):
    """(W,) each ASR window's nearest distance between a kept and a
    rejected eigenvalue of its covariance, relative to its largest (inf
    where nothing or everything is rejected), from the card's frames as
    ``ops.asr._process_jit`` forms them."""
    import torch
    hop = win // 2
    xc = x - x.mean(-1, keepdim=True)
    fr = torch.nn.functional.pad(xc, (hop, win)).unfold(-1, win, hop)
    hann = 0.5 - 0.5 * torch.cos(2.0 * torch.pi * (torch.arange(
        win, device=x.device, dtype=torch.float32) + 0.5) / win)
    frw = fr.transpose(0, 1) * hann
    cov = frw @ frw.transpose(1, 2)
    d = torch.linalg.eigvalsh(0.5 * (cov + cov.transpose(1, 2))).double()
    pair = (d[:, :, None] - d[:, None, :]).abs()
    mask = keep[:, :, None] & ~keep[:, None, :]
    pair = torch.where(mask, pair, torch.full_like(pair, float("inf")))
    return (pair.amin((1, 2)) / d.abs().amax(-1)).cpu().numpy()


def sensor_positions(c):
    """(c, 3) unit vectors over the upper hemisphere, a golden-angle spiral
    from the vertex to the rim (y is front-to-back)."""
    k = np.arange(c) + 0.5
    z = 1.0 - k / c
    r = np.sqrt(1.0 - z * z)
    phi = k * np.pi * (3.0 - np.sqrt(5.0))
    return np.stack([r * np.cos(phi), r * np.sin(phi), z], 1)


def sensor_recording(seed=0, n=CHAIN_N):
    """64 EEG + EOG at 250 Hz with planted ground truth: a volume-conducted
    background (shared 6 Hz, slow drift and broadband sources with
    positive gains), a flat electrode and a noisy one, blinks on the EOG
    channel mixed into the frontal channels, eight high-amplitude bursts,
    a stimulus whose response (a 0-0.25 s kernel) drives eight central
    channels, and events every 2.1 s alternating codes 1 and 2, code 2
    adding an 11 Hz burst 0.2-0.6 s after the event on the posterior
    channels.  Returns (data (65, n) float32, names, positions (65, 3),
    truth dict)."""
    rng = np.random.default_rng(seed)
    sf, c = SENSOR_SF, CHAIN_C
    t = np.arange(n) / sf
    pos = sensor_positions(c)
    front = np.argsort(-pos[:, 1])[:6]
    post = np.argsort(pos[:, 1])[:12]
    central = np.argsort(np.abs(pos[:, 1]) + np.abs(pos[:, 0]))[:8]
    x = 10.0 * rng.standard_normal((c + 1, n))
    sources = np.stack([np.sin(2 * np.pi * 6.0 * t),
                        np.sin(2 * np.pi * 0.7 * t + 1.0),
                        rng.standard_normal(n)])
    x[:c] += (rng.uniform(0.5, 1.0, (c, 3)) * [8.0, 5.0, 8.0]) @ sources
    onsets = np.arange(int(2 * sf), n - int(3 * sf), int(CHAIN_STEP * sf))
    codes = np.where(np.arange(onsets.size) % 2, 2, 1)
    burst = np.zeros(n)
    for o in onsets[codes == 2]:
        burst[o + int(0.2 * sf):o + int(0.6 * sf)] = 1.0
    x[post] += 10.0 * burst * np.sin(2 * np.pi * 11.0 * t)
    blink = np.zeros(n)
    for c0 in rng.integers(int(sf), n - int(sf), int(n / sf // 4)):
        blink[c0:c0 + 50] += np.hanning(50)
    x[c] = 150.0 * blink + 5.0 * rng.standard_normal(n)
    x[front] += np.linspace(0.6, 0.2, front.size)[:, None] * 80.0 * blink
    stim = np.convolve(rng.standard_normal(n), np.hanning(9), "same")
    stim = (stim / stim.std()).astype(np.float32)
    tk = np.arange(int(0.25 * sf)) / sf
    kern = np.sin(2 * np.pi * tk / 0.25) * np.exp(-tk / 0.08)
    x[central] += 2.0 * np.convolve(stim, kern)[:n]
    art = rng.choice(np.arange(10 * int(sf), n - 10 * int(sf), int(sf)), 8,
                     replace=False)
    for s in art:
        d = rng.standard_normal(c)
        x[:c, s:s + 125] += 400.0 * (d / np.linalg.norm(d))[:, None] \
            * np.hanning(125)
    x[CHAIN_FLAT] = 1e-4 * rng.standard_normal(n)
    x[CHAIN_NOISY] *= 60.0
    names = [f"EEG{i:03d}" for i in range(c)] + ["EOG"]
    eog_pos = np.array([[0.0, 0.95, 0.3]]) / np.linalg.norm([0.0, 0.95, 0.3])
    truth = dict(onsets=onsets, codes=codes, front=front, post=post,
                 central=central, stim=stim, artifacts=art)
    return (x.astype(np.float32), names, np.concatenate([pos, eog_pos]),
            truth)


class NamedRaw:
    """A duck-typed ``mne.io.Raw`` with its own rate and channel names."""

    def __init__(self, data, sfreq, names):
        self._data = data
        self.info = {"sfreq": sfreq}
        self.ch_names = list(names)

    def get_data(self):
        return self._data


def sensor_chain(rec, names, pos, truth, device, freqs, call):
    """The full-width adapter chain: channel QC, spline repair, ICA against
    the EOG, ASR, TRF, event-locked epochs split by condition, EOG
    regression and autoreject, TF decoding and temporal generalization
    (K4), CSP / Riemannian decoding, GED, SSD and the components' power
    (K1).  ``call(name, fn, fresh, want)`` runs one step (``want``: the
    kernel launches it must make on the card) and returns its result.
    Returns the results to check."""
    import torch
    import ninwavelets_tpu_torch as nt
    sf = SENSOR_SF
    out = {}

    def raw(data):
        return nt.RawWavelet(NamedRaw(data, sf, names),
                             nt.Morse(sf, device=device))

    rw = raw(rec)
    qc = call("RawWavelet.find_bad_channels", rw.find_bad_channels,
              negate(rw), {})
    out["qc"] = qc
    eeg_bads = [b for b in qc["bads"] if b != "EOG"]
    repaired = call("RawWavelet.interpolate_bads",
                    lambda: rw.interpolate_bads(pos, eeg_bads), negate(rw),
                    {})
    rw2 = raw(repaired)
    ica = call("RawWavelet.ica(n_components=20)",
               lambda: rw2.ica(n_components=20), negate(rw2), {})
    bads, scores = call("RawWavelet.ica_find_bads(ref='EOG')",
                        lambda: rw2.ica_find_bads(ica, ref="EOG"),
                        negate(rw2), {})
    out["ica_bads"], out["ica_scores"] = bads, scores
    cleaned = call("RawWavelet.ica_clean",
                   lambda: rw2.ica_clean(ica, bads), negate(rw2), {})
    eog = repaired[-1]
    front = truth["front"]
    out["blink_corr"] = [
        float(np.abs([np.corrcoef(d[i], eog)[0, 1] for i in front]).max())
        for d in (repaired, cleaned)]
    rw3 = raw(cleaned)
    # cutoff 20 (clean_rawdata's burst criterion): the planted 11 Hz burst
    # is brain signal, the eight bursts are artifacts
    asr = call("RawWavelet.asr_clean(cutoff=20)",
               lambda: rw3.asr_clean(cutoff=20.0), negate(rw3), {})
    out["asr"] = (cleaned, asr)
    rw4 = raw(asr)
    stim = truth["stim"]
    trf = call("RawWavelet.trf (0-0.25 s)", lambda: rw4.trf(stim),
               negate(rw4), {})
    out["trf"] = trf
    ew = call("RawWavelet.epochs", lambda: rw4.epochs(
        truth["onsets"], CHAIN_TMIN, CHAIN_TMAX, codes=truth["codes"]),
        lambda: None, {})
    ew2 = call("EpochsWavelet.regress_out(['EOG']).drop_bad()",
               lambda: ew.regress_out(["EOG"]).drop_bad(), negate(ew), {})
    out["kept"] = (ew._host_data().shape[0], ew2._host_data().shape[0])
    parts = ew2.split()
    a, b = parts[2], parts[1]
    out["decode"] = call(
        f"EpochsWavelet.decode ({a._host_data().shape[0]} + "
        f"{b._host_data().shape[0]} x {CHAIN_C} x {len(freqs)} x 512)",
        lambda: a.decode(b, freqs), negate(a, b), {"power_each": 2})
    out["decode_generalization"] = call(
        "EpochsWavelet.decode_generalization (decim 4)",
        lambda: a.decode_generalization(b, freqs), negate(a, b),
        {"power_each": 2})
    labels = ew2.event_codes
    out["csp_decode"] = float(call(
        f"EpochsWavelet.csp_decode (9-13 Hz), {CHAIN_C} channels",
        lambda: ew2.csp_decode(labels, f_lo=9.0, f_hi=13.0), negate(ew2),
        {}))
    # the recording is rank-deficient after the spline repair and the ICA
    # cleaning (the 64-channel CSP's bottom eigenvalues are its null
    # directions): decode on 8 narrowband-vs-broadband GED components of
    # all trials (no labels used), which the components' power rides K1
    out["ged"] = call("EpochsWavelet.ged (9-13 Hz, 8 components)",
                      lambda: ew2.ged(9.0, 13.0, n_components=8),
                      negate(ew2), {})
    comps = ew2.spatial_epochs(out["ged"])
    out["csp_decode_ged"] = float(call(
        "EpochsWavelet.csp_decode (9-13 Hz), 8 GED components",
        lambda: comps.csp_decode(labels, f_lo=9.0, f_hi=13.0),
        negate(comps), {}))
    ca, cb = comps.split()[2], comps.split()[1]
    for method in ("tangent", "mdm"):
        out[f"{method}_ged"] = call(
            f"EpochsWavelet.riemann_decode {method}, 8 GED components",
            lambda: ca.riemann_decode(cb, method=method), negate(ca, cb), {})
    out["ssd"] = call("EpochsWavelet.ssd (9-13 Hz)",
                      lambda: a.ssd(9.0, 13.0, n_components=4), negate(a),
                      {})
    out["comp_power"] = call(
        "EpochsWavelet.spatial_epochs(ged).power_all",
        lambda: comps.power_all(freqs), negate(comps), {"power": 1})
    out["post_idx"] = truth["post"]
    return out


def sensor_space_phase(data):
    """Slice 12: sensor-space preprocessing and decoding (channel QC and
    spline repair, ICA, ASR, regression and trial rejection, spatial
    filters, TF / CSP / Riemannian decoding, SSVEP, TRF) at the JAX
    package's bench shapes, each against the port's own CPU run and known
    answers, timed with its peak memory, no kernel launched; then the
    adapter chain over a 64-channel recording at full width, whose
    ``decode`` / ``decode_generalization`` ride K4 and whose components'
    ``power_all`` rides K1, and the serving data through ``decode``.
    Plain torch but for those kernels: nothing joins the kernels'
    record."""
    import torch
    import ninwavelets_tpu_torch as nt
    from ninwavelets_tpu_torch.ops import asr as asr_mod
    from ninwavelets_tpu_torch.ops import csd as csd_mod
    from ninwavelets_tpu_torch.ops import decoding as dec
    from ninwavelets_tpu_torch.ops import ica as ica_mod
    from ninwavelets_tpu_torch.ops import reject as rej
    from ninwavelets_tpu_torch.ops import riemann as riem
    from ninwavelets_tpu_torch.ops import spatial as sp
    from ninwavelets_tpu_torch.ops.scattering import sym_eigh
    from ninwavelets_tpu_torch.ops import trf as trf_mod

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    print(card)
    t_phase = time.perf_counter()
    gen = np.random.default_rng(12)
    times = {}

    def bench(name, fn, fresh, slow_reps=None):
        out, counts, ms = timed_call(name, fn, fresh, card, slow_reps)
        check(not counts, f"{name} launched {counts}")
        times[name] = ms
        return out

    def cpu(x):
        return torch.as_tensor(x).detach().cpu()

    # -- FastICA 64 x 250,000, 100 iterations (extensions_bench.py:419-424)
    xh = gen.laplace(size=(64, 250_000)).astype(np.float32)
    x = torch.from_numpy(xh).cuda()
    res = bench("fastica 64 x 250,000, 100 iterations",
                lambda: ica_mod.fastica(x, n_iter=100), x.neg_)
    print(f"fastica convergence after 100 iterations "
          f"{res.convergence[-1].item()}; "
          f"{times['fastica 64 x 250,000, 100 iterations'] / 100} ms a step")
    check(bool(res.sources.isfinite().all()), "fastica sources")
    # card vs CPU: six sources well apart in non-Gaussianity (square,
    # sawtooth, sine, Laplace, sparse spikes, exponential), the card's draw
    # handed over, both converged to the metric's float32 floor
    # (tests/test_torch_ica_asr.py's gate): short of it, 1 - cos(step) =
    # 1e-5 is still a 4.5e-3 rad step
    n_ica = 25_000
    t_ica = np.arange(n_ica) / SENSOR_SF
    src = np.stack([np.sign(np.sin(2 * np.pi * 1.3 * t_ica)),
                    2.0 * ((2.1 * t_ica) % 1.0) - 1.0,
                    np.sin(2 * np.pi * 0.9 * t_ica),
                    gen.laplace(size=n_ica),
                    (gen.random(n_ica) < 0.02) * 5.0
                    * gen.standard_normal(n_ica),
                    gen.exponential(size=n_ica) - 1.0])
    xm = (gen.standard_normal((6, 6)) @ src).astype(np.float32)
    w0 = torch.randn((6, 6), device="cuda",
                     generator=torch.Generator("cuda").manual_seed(1))
    rc = ica_mod._fastica_from_w0(torch.from_numpy(xm).cuda(), w0,
                                  n_iter=300)
    rh = ica_mod._fastica_from_w0(torch.from_numpy(xm), w0.cpu(), n_iter=300)
    print(f"fastica 6 x 25,000 convergence: card {rc.convergence[-1].item()}"
          f", CPU {rh.convergence[-1].item()} (gate 5e-6)")
    check(max(rc.convergence[-1].item(), rh.convergence[-1].item()) < 5e-6,
          "fastica did not converge")
    for f in ("unmixing", "mixing", "sources"):
        close(f"fastica {f}: card vs CPU", getattr(rc, f), getattr(rh, f),
              1e-4)
    del x, res, rc

    # -- SSD and CSP decoding, 128 x 64 x 2048 at 1 kHz (:473-495) ----------
    e_sp, c_sp, n_sp = 64, 64, 2048
    t_sp = np.arange(n_sp) / SFREQ
    osc = np.sin(2 * np.pi * 11.0 * t_sp[None, :]
                 + gen.uniform(0, 2 * np.pi, (e_sp, 1)))
    xa_h = (2.0 * np.eye(c_sp)[0][None, :, None] * osc[:, None, :]
            + gen.standard_normal((e_sp, c_sp, n_sp))).astype(np.float32)
    xb_h = (2.0 * np.eye(c_sp)[c_sp - 1][None, :, None] * osc[:, None, :]
            + gen.standard_normal((e_sp, c_sp, n_sp))).astype(np.float32)
    xa, xb = torch.from_numpy(xa_h).cuda(), torch.from_numpy(xb_h).cuda()
    res = bench(f"ssd {e_sp} x {c_sp} x {n_sp}, 9-13 Hz, 8 components",
                lambda: sp.ssd(xa, SFREQ, 9.0, 13.0, n_components=8), xa.neg_)
    # card vs CPU in two steps: the band-filtered covariances (cuFFT
    # against the CPU's FFT), then the GED of the card's covariances (the
    # whitening amplifies the FFTs' round-off by the noise covariance's
    # conditioning)
    covs = []
    for xx in (xa, torch.from_numpy(xa_h)):
        xs = nt.ops.bandpass(xx, SFREQ, 9.0, 13.0)
        xn = nt.ops.notch(nt.ops.bandpass(xx, SFREQ, 7.0, 15.0), SFREQ,
                          11.0, 6.0)
        covs.append((sp.covariance(xs), sp.covariance(xn)))
    for k, nm in enumerate(("signal", "noise")):
        close(f"ssd {nm} covariance: card vs CPU", covs[0][k], covs[1][k])
    d, f, p = sp._ged_jit(*covs[0], n_components=64, shrink=0.01)
    dh, fh, ph = sp._ged_jit(*(c.cpu() for c in covs[0]), n_components=64,
                             shrink=0.01)
    close("ssd: the card's result is the GED of its covariances",
          res.eigvals, d[:8], 0.0, 1.0)
    close("ssd eigenvalues (same covariances): card vs CPU", d, dh)
    cols_agree("ssd top pattern (same covariances)", p[:, :1], ph[:, :1],
               dh, [0])
    top = int(res.patterns[:, 0].abs().argmax())
    print(f"check ssd top pattern peaks at channel {top} (planted 0)")
    check(top == 0, f"ssd top pattern at channel {top}")
    auc = bench(f"csp_decode {2 * e_sp} x {c_sp} x {n_sp}, 5 folds, 9-13 Hz",
                lambda: dec.csp_decode(xa, xb, f_lo=9.0, f_hi=13.0,
                                       sfreq=SFREQ), xa.neg_)
    ha, hb = torch.from_numpy(xa_h), torch.from_numpy(xb_h)
    ref = dec.csp_decode(ha, hb, f_lo=9.0, f_hi=13.0, sfreq=SFREQ)
    fa = nt.ops.bandpass(xa, SFREQ, 9.0, 13.0)
    fb = nt.ops.bandpass(xb, SFREQ, 9.0, 13.0)
    filt = dec._fold_ged_jit(dec._fold_covs_jit(fa, n_folds=5),
                             dec._fold_covs_jit(fb, n_folds=5),
                             n_components=4, shrink=0.01)
    auc_agree("csp_decode AUC", auc, ref, near_tie_slack(
        *dec._csp_fold_scores(fa, fb, filt, n_folds=5, lam=1e-3)))
    print(f"check csp_decode AUC {float(auc)} (gate > 0.95)")
    check(float(auc) > 0.95, f"csp_decode AUC {float(auc)}")
    del xa, xb, fa, fb, ha, hb

    # -- channel QC and Ledoit-Wolf, 64 x 120,000 (:599-613) ----------------
    xh = gen.standard_normal((64, 120_000)).astype(np.float32)
    xh += 0.8 * gen.standard_normal(120_000).astype(np.float32)
    xh[7] = 1e-14
    xh[30] *= 40.0
    x = torch.from_numpy(xh).cuda()
    qc = bench("find_bad_channels 64 x 120,000",
               lambda: rej.find_bad_channels(x, SFREQ), x.neg_)
    qh = rej.find_bad_channels(torch.from_numpy(xh), SFREQ)
    print(f"check find_bad_channels: card {qc['bads']}, CPU {qh['bads']} "
          "(planted flat 7, noisy 30)")
    check(qc == qh and qc["bads"] == [7, 30], f"find_bad_channels {qc}")
    (cov, alpha) = bench("ledoit_wolf 64 x 120,000",
                         lambda: sp.ledoit_wolf(x), x.neg_)
    covh, alphah = sp.ledoit_wolf(torch.from_numpy(xh))
    close("ledoit_wolf cov: card vs CPU", cov, covh)
    print(f"check ledoit_wolf shrinkage: card {alpha}, CPU {alphah}")
    check(abs(alpha - alphah) <= 1e-5 * abs(alphah), "ledoit_wolf weight")
    del x, cov

    # -- ASR, 64 x 150,000 at 250 Hz (:632-639) ------------------------------
    xh = gen.standard_normal((64, 150_000)).astype(np.float32)
    art = np.arange(40_000, 140_000, 12_500)
    for s in art:
        d = gen.standard_normal(64)
        xh[:, s:s + 125] += (30.0 * d[:, None] * np.hanning(125)).astype(
            np.float32)
    x = torch.from_numpy(xh).cuda()
    model = asr_mod.asr_calibrate(x[:, :30_000], SENSOR_SF)
    (out, keep) = bench("asr_process 64 x 150,000 at 250 Hz",
                        lambda: asr_mod.asr_process(x, SENSOR_SF, model),
                        x.neg_, slow_reps=3)
    hmodel = asr_mod.ASRModel(*(cpu(v) for v in model))
    outh, keeph = asr_mod.asr_process(torch.from_numpy(xh), SENSOR_SF, hmodel)
    same = (keep.cpu() == keeph).all(-1).numpy()
    print(f"check asr keep flags: card == CPU on {same.mean()} of "
          f"{same.size} windows (gate 0.95: a window with an eigenvalue "
          "within round-off of its limit may decide either way)")
    check(same.mean() >= 0.95, "asr keep flags differ")
    # a window's reconstruction turns with its eigenvectors, by about
    # eps x max(d) / gap where gap is the nearest distance between a kept
    # and a rejected eigenvalue: each sample is held to 1e-5 x max|x| x
    # (1 + max(d) / gap) of the two windows covering it (windows that
    # disagree left out)
    gaps = asr_split_gaps(x, keep, 124)
    gate = 1e-5 * (1.0 + 1.0 / gaps)
    gate[~same] = np.inf
    n_s = xh.shape[1]
    sample_gate = np.zeros(n_s)
    for w in range(gate.size):      # window w covers [62 w - 62, 62 w + 62)
        lo, hi = max(0, 62 * w - 62), min(n_s, max(0, 62 * w + 62))
        sample_gate[lo:hi] = np.maximum(sample_gate[lo:hi], gate[w])
    mx = float(np.abs(xh).max())
    err = (out.cpu() - outh).abs().amax(0).numpy() / mx
    print(f"check asr output: card vs CPU max|d| / max|x| {err.max()}, "
          f"worst against its window gate {(err / sample_gate).max()} (gate "
          f"1; the median kept / rejected gap {np.median(gaps)})")
    check(bool((err <= sample_gate).all()), "asr output beyond the gate")
    seg = np.zeros(xh.shape[1], bool)
    for s in art:
        seg[s:s + 125] = True
    before = float(np.abs(xh[:, seg]).mean())
    after = out.cpu()[:, seg].abs().mean().item()
    print(f"check asr: mean |x| on the artifacts {before} -> {after} (gate "
          "< 0.25 x)")
    check(after < 0.25 * before, "asr left the artifacts")
    frw = torch.randn((2421, 64, 124), device="cuda")
    covs = frw @ frw.transpose(1, 2)
    sym_eigh(covs)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    sym_eigh(covs)
    stop.record()
    torch.cuda.synchronize()
    eig_ms = start.elapsed_time(stop)
    print(f"time asr's batched eigh alone (2421 x 64 x 64, solved in "
          f"float64 by ops.scattering.sym_eigh): {eig_ms} ms on {card}")
    times["asr batched eigh"] = eig_ms
    del x, out, frw, covs

    # -- Riemannian decoding, 80 x 32 x 512 (:641-656) -----------------------
    ra = gen.standard_normal((40, 32, 512)).astype(np.float32)
    rb = gen.standard_normal((40, 32, 512)).astype(np.float32)
    ra[:, 0] *= 2.5
    rb[:, 1] *= 2.5
    xa, xb = torch.from_numpy(ra).cuda(), torch.from_numpy(rb).cuda()
    for name, fn in (("tangent_decode", riem.tangent_decode),
                     ("mdm_decode", riem.mdm_decode)):
        got = bench(f"{name} 80 x 32 x 512, 5 folds",
                    lambda fn=fn: fn(xa, xb), xa.neg_)
        want = fn(torch.from_numpy(ra), torch.from_numpy(rb))
        print(f"check {name}: card {got}, CPU {want} (gate: equal within "
              "1e-6 and > 0.95)")
        check(abs(got - want) <= 1e-6 and got > 0.95, f"{name} {got}")
    del xa, xb

    # -- autoreject, 128 x 64 x 1024 (:680-687) -------------------------------
    xh = gen.standard_normal((128, 64, 1024)).astype(np.float32)
    xh[::16, 3, 100:160] += 40.0      # the bench plants 12: kept by the CV
    x = torch.from_numpy(xh).cuda()
    res = bench("autoreject_global 128 x 64 x 1024, 30 candidates, 5 folds",
                lambda: rej.autoreject_global(x), x.neg_)
    ref = rej.autoreject_global(torch.from_numpy(xh))
    fin = ref.cv_error.isfinite()
    close("autoreject thresholds: card vs CPU", res.thresholds,
          ref.thresholds, 2.5e-7)
    close("autoreject cv_error: card vs CPU", res.cv_error.cpu()[fin],
          ref.cv_error[fin])
    planted = np.zeros(128, bool)
    planted[::16] = True
    print(f"check autoreject: threshold card {res.threshold}, CPU "
          f"{ref.threshold}; drops {int(res.drop_mask.sum())}, all planted "
          f"{bool(res.drop_mask.cpu().numpy()[planted].all())}")
    check(torch.equal(res.drop_mask.cpu(), ref.drop_mask)
          and bool(res.drop_mask.cpu().numpy()[planted].all()),
          "autoreject drop mask")
    del x, res

    # -- TRF, 64 x 250,000, 64 lags (:714-721) --------------------------------
    stim_h = gen.standard_normal(250_000).astype(np.float32)
    kern = (np.sin(2 * np.pi * np.arange(32) / 32)
            * np.exp(-np.arange(32) / 12.0)).astype(np.float32)
    resp_h = gen.standard_normal((64, 250_000)).astype(np.float32)
    resp_h[:4] += np.convolve(stim_h, kern)[:250_000]
    stim, resp = torch.from_numpy(stim_h).cuda(), torch.from_numpy(
        resp_h).cuda()
    res = bench("trf_fit 64 x 250,000, 64 lags",
                lambda: trf_mod.trf_fit(stim, resp, range(0, 64)), resp.neg_)
    ref = trf_mod.trf_fit(torch.from_numpy(stim_h), torch.from_numpy(resp_h),
                          range(0, 64))
    close("trf weights: card vs CPU", res.weights, ref.weights)
    r = float(np.corrcoef(res.weights[0, 0, :32].cpu().numpy(), kern)[0, 1])
    print(f"check trf kernel recovery: r {r} (gate > 0.99)")
    check(r > 0.99, f"trf kernel r {r}")
    del stim, resp, res

    # -- SSVEP CCA, 200 x 8 x 1000 at 250 Hz (:731-737) ----------------------
    stim_f = [8.0, 10.0, 12.0, 15.0]
    lab = np.arange(200) % 4
    t_sv = np.arange(1000) / SENSOR_SF
    mix = gen.standard_normal(8)
    xh = np.stack([0.4 * mix[:, None] * np.sin(2 * np.pi * stim_f[k] * t_sv)
                   + gen.standard_normal((8, 1000)) for k in lab]).astype(
        np.float32)
    x = torch.from_numpy(xh).cuda()
    labels, rho = bench("ssvep_cca 200 x 8 x 1000, 4 frequencies",
                        lambda: dec.ssvep_cca(x, stim_f, SENSOR_SF), x.neg_)
    lh, rhoh = dec.ssvep_cca(torch.from_numpy(xh), stim_f, SENSOR_SF)
    close("ssvep rho: card vs CPU", rho, rhoh)
    top2 = rhoh.sort(-1).values[:, -2:]
    sound = (top2[:, 1] - top2[:, 0]) > 1e-5
    acc = float((labels.cpu().numpy() == lab).mean())
    print(f"check ssvep: labels card == CPU on {int(sound.sum())} trials "
          f"with a margin; accuracy {acc} (gate > 0.9)")
    check(torch.equal(labels.cpu()[sound], lh[sound]) and acc > 0.9,
          "ssvep labels")
    del x

    # -- CSD, 64 x 120,000 (:898-907) -----------------------------------------
    th = np.linspace(0, 2 * np.pi, 64, endpoint=False)
    pos_ring = np.stack([np.cos(th) * 0.9, np.sin(th) * 0.9,
                         np.full(64, 0.436)], 1)
    xh = gen.standard_normal((64, 120_000)).astype(np.float32)
    x = torch.from_numpy(xh).cuda()
    out = bench("csd 64 x 120,000", lambda: csd_mod.csd(x, pos_ring), x.neg_)
    close("csd: card vs CPU", out, csd_mod.csd(torch.from_numpy(xh),
                                               pos_ring))
    shifted = csd_mod.csd(x + 5.0, pos_ring)
    close("csd of a re-referenced recording (+5 everywhere)", shifted, out,
          1e-5, scale=out.abs().max().item())
    del x, out, shifted

    # -- tf_decode 48 x 8 x 30 x 256 (:935-942) -------------------------------
    da = gen.standard_normal((24, 8, 30, 256)).astype(np.float32)
    db = gen.standard_normal((24, 8, 30, 256)).astype(np.float32) + 0.3
    xa, xb = torch.from_numpy(da).cuda(), torch.from_numpy(db).cuda()
    auc = bench("tf_decode 24 + 24 x 8 x 30 x 256, 5 folds",
                lambda: dec.tf_decode(xa, xb), xa.neg_)
    ref = dec.tf_decode(torch.from_numpy(da), torch.from_numpy(db))
    auc_agree("tf_decode map", auc, ref, lda_slack(xa, xb, dec._scores))
    print(f"check tf_decode mean AUC {auc.mean().item()} (class b shifted "
          "by 0.3 in all 8 channels, d' 0.85: about 0.73 with every trial "
          "to train on; gate > 0.6)")
    check(auc.mean().item() > 0.6, "tf_decode AUC")
    del xa, xb

    # -- xDAWN, 32 x 100,000, 200 events (:945-958) ---------------------------
    xh = gen.standard_normal((32, 100_000)).astype(np.float32)
    ev = np.sort(gen.choice(np.arange(200, 99_000), 200, replace=False))
    wave = np.exp(-0.5 * ((np.arange(128) / SENSOR_SF - 0.3) / 0.06) ** 2)
    topo = gen.standard_normal(32)
    for s in ev:
        xh[:, s:s + 128] += (topo[:, None] * wave).astype(np.float32)
    x = torch.from_numpy(xh).cuda()
    w, evoked, ratios = bench("xdawn 32 x 100,000, 200 events, window 128",
                              lambda: sp.xdawn(x, ev, 128), x.neg_)
    wh, evh, rh_ = sp.xdawn(torch.from_numpy(xh), ev, 128, n_components=32)
    close("xdawn ratios: card vs CPU", ratios, rh_[:4])
    cols_agree("xdawn top filter (up to sign)",
               signed_rows(w[:1], wh[:1]).T, wh[:1].T, rh_, [0])
    print(f"check xdawn top ratio {ratios[0].item()} > next "
          f"{ratios[1].item()} x 3")
    check(ratios[0].item() > 3 * ratios[1].item(), "xdawn ratios")
    del x
    torch.cuda.empty_cache()

    # -- the adapter chain at full width --------------------------------------
    rec, names, pos, truth = sensor_recording(3)
    chain_freqs = np.linspace(2.0, 60.0, F)
    launched = {}

    def call(name, fn, fresh, want):
        out, counts, ms = timed_call(name, fn, fresh, card, slow_reps=3)
        launched[name] = counts
        check(counts == want, f"{name} launched {counts}, want {want}")
        times[name] = ms
        return out

    out = sensor_chain(rec, names, pos, truth, "cuda", chain_freqs, call)
    qc = out["qc"]
    want_bads = {names[CHAIN_FLAT], names[CHAIN_NOISY]}
    print(f"check chain QC: bads {qc['bads']} (planted {sorted(want_bads)})")
    check(want_bads <= set(qc["bads"]) and len(
        [b for b in qc["bads"] if b != "EOG"]) == 2, "chain QC bads")
    print(f"check chain ICA: components {out['ica_bads']} flagged against "
          f"the EOG; blink |r| with the EOG on the frontal channels "
          f"{out['blink_corr'][0]} -> {out['blink_corr'][1]} (gate < 0.3 x)")
    check(bool(out["ica_bads"])
          and out["blink_corr"][1] < 0.3 * out["blink_corr"][0],
          "chain ICA blink")
    before, after = out["asr"]
    seg = np.zeros(before.shape[1], bool)
    for s in truth["artifacts"]:
        seg[s:s + 125] = True
    ab, aa = np.abs(before[:64, seg]).mean(), np.abs(after[:64, seg]).mean()
    print(f"check chain ASR: mean |x| on the bursts {ab} -> {aa} (gate < "
          "0.5 x)")
    check(aa < 0.5 * ab, "chain ASR bursts")
    res, r, lam = out["trf"]
    central = truth["central"]
    rest = np.setdiff1d(np.arange(64), central)
    print(f"check chain TRF: r on the driven channels {r[central].min()}.."
          f"{r[central].max()}, others at most {np.abs(r[rest]).max()}, "
          f"lam {lam}")
    check(r[central].min() > 0.3 and np.abs(r[rest]).max() < 0.15,
          "chain TRF r")
    print(f"check chain autoreject: kept {out['kept'][1]} of {out['kept'][0]}"
          " epochs")
    check(out["kept"][1] > 0.8 * out["kept"][0], "chain drop_bad")
    auc = out["decode"].cpu().numpy()
    tt = CHAIN_TMIN + np.arange(auc.shape[1]) / SENSOR_SF
    pk = divmod(int(auc.argmax()), auc.shape[1])
    box = (((chain_freqs >= 9.0) & (chain_freqs <= 13.0))[:, None]
           & ((tt >= 0.25) & (tt <= 0.55))[None])
    high = float(np.median(auc[chain_freqs > 30.0]))
    print(f"check chain decode: AUC peak {auc.max()} at "
          f"{chain_freqs[pk[0]]} Hz, {tt[pk[1]]} s (planted 11 Hz, 0.2-0.6 "
          f"s; gates 9-13 Hz, 0.2-0.6 s); mean in 9-13 Hz x 0.25-0.55 s "
          f"{auc[box].mean()} (gate > 0.8); median above 30 Hz {high} "
          "(gate 0.5 +- 0.05)")
    check(9.0 <= chain_freqs[pk[0]] <= 13.0 and 0.2 <= tt[pk[1]] <= 0.6
          and auc[box].mean() > 0.8 and abs(high - 0.5) < 0.05,
          "chain decode map")
    tg = out["decode_generalization"].cpu().numpy()
    diag = np.diag(tg)
    t4 = CHAIN_TMIN + 4 * np.arange(diag.size) / SENSOR_SF
    print(f"check chain decode_generalization {tg.shape}: diagonal peak "
          f"{diag.max()} at {t4[diag.argmax()]} s (gates > 0.6, 0.2-0.6 s)")
    check(tg.shape == (128, 128) and diag.max() > 0.6
          and 0.2 <= t4[diag.argmax()] <= 0.6, "chain tgen")
    print(f"check chain csp_decode on 64 channels {out['csp_decode']} (in "
          f"[0, 1]); on the 8 GED components csp_decode "
          f"{out['csp_decode_ged']}, tangent {out['tangent_ged']}, mdm "
          f"{out['mdm_ged']} (gate > 0.8 each)")
    check(0.0 <= out["csp_decode"] <= 1.0
          and min(out["csp_decode_ged"], out["tangent_ged"],
                  out["mdm_ged"]) > 0.8, "chain covariance decoders")
    top = set(np.argsort(-out["ssd"].patterns[:, 0].abs().cpu().numpy())[:6])
    print(f"check chain ssd top pattern's largest channels {sorted(top)} "
          f"(posterior {sorted(truth['post'][:12])})")
    check(len(top & set(truth["post"])) >= 4, "chain ssd pattern")
    check(bool(out["comp_power"].isfinite().all()), "chain comp power")
    del out
    torch.cuda.empty_cache()

    # -- the serving data through decode (100 + 100 x 64 x 2048 x 100) -------
    ew = nt.EpochsWavelet(nt.ArrayEpochs(data, SFREQ),
                          nt.Morse(SFREQ, interpolate=True, device="cuda"))
    a, b = ew.subset(np.arange(E // 2)), ew.subset(np.arange(E // 2, E))
    freqs = np.arange(1.0, F + 1.0)
    auc = call(f"EpochsWavelet.decode serving {E // 2} + {E // 2} x {C} x "
               f"{N} x {F}", lambda: a.decode(b, freqs), negate(a, b),
               {"power_each": 2})
    print(f"check serving decode: noise AUC mean {auc.mean().item()} (gate "
          "0.5 +- 0.02)")
    check(abs(auc.mean().item() - 0.5) < 0.02, "serving decode mean")
    del ew, a, b, auc
    torch.cuda.empty_cache()
    print(f"sensor-space adapter launches {launched}, on {card}")
    print(f"sensor-space phase {time.perf_counter() - t_phase} s; times "
          f"(ms) {json.dumps(times)}")


DEV = "cuda"                                 # the slice-13 phase's device
SLEEP_SF, SO_SF = 256.0, 128.0
SPINDLE_N, SO_N = 921_600, 230_400          # 1 h at 256 Hz, 30 min at 128 Hz
MS_T, MS_CPU_T = 120_000, 12_000             # microstate samples: card, CPU
ENT_SHAPE, JK_SHAPE = (16, 8, 2048), (64, 64, 1024)
DFA_SHAPE, LCMV_S, IAAFT_N = (64, 65_536), 5000, 4096
CSD_SHAPE, GRID_STEP, SLEEP_REC_MIN = (16, 64, 2048), 0.006, 20
SPINDLE_EVERY, SO_EVERY = 60.0, 20.0         # s between planted events
ERP_T0, ERP_WIDTH = 0.3, 0.03                # s after the event, s
DIPOLE = np.array([0.03, 0.02, 0.05])        # extensions_bench.py:806
HEAD_R = 0.09


def onset_margin(seg, crit):
    """Smallest |seg_t - crit x peak| over the samples that decide a
    fractional-peak onset (from the last one below the criterion to the
    peak), and the peak's own gap to the runner-up, per row (float64):
    ``tests/test_torch_erp_complexity.py``'s margin."""
    pk = seg.argmax(-1)
    thr = crit * np.take_along_axis(seg, pk[..., None], -1)
    t = np.arange(seg.shape[-1])
    below = (seg < thr) & (t <= pk[..., None])
    last = np.where(below.any(-1), seg.shape[-1] - 1
                    - np.argmax(below[..., ::-1], -1), 0)
    rel = (t >= last[..., None]) & (t <= pk[..., None])
    m = np.where(rel, np.abs(seg - thr), np.inf).min(-1)
    s = np.sort(seg, axis=-1)
    return np.minimum(m, s[..., -1] - s[..., -2])


def equal_but_ties(name, got, ref, margin, tol):
    """Equal, except where a decision's margin is below ``tol``."""
    import torch
    got = torch.as_tensor(got).cpu().numpy()
    ref = torch.as_tensor(ref).cpu().numpy()
    diff = got != ref
    worst = float(np.max(margin[diff], initial=0.0))
    print(f"check {name}: card vs CPU {int(diff.sum())} of {diff.size} "
          f"differ, at margins up to {worst} (gate: only below {tol})")
    check(got.shape == ref.shape and (not diff.any() or worst < tol),
          f"{name}: differs beyond near-ties")


def events_agree(name, got, ref, margin, tol=1e-5):
    """Two event tables: the same valid events, start and stop, except an
    event with a boundary within 2 samples of a sample whose decision
    margin (relative, from ``margin`` (B, N)) is below ``tol``; the valid
    events' values at 1e-5 of the max."""
    import torch
    n_bad = 0
    for b in range(ref.valid.shape[0]):
        sets = []
        for tab in (got, ref):
            v = tab.valid[b].cpu().numpy()
            sets.append(set(zip(tab.start[b].cpu().numpy()[v].tolist(),
                                tab.stop[b].cpu().numpy()[v].tolist())))
        for s, e in sets[0] ^ sets[1]:
            near = [margin[b, max(i - 2, 0):i + 3].min() for i in (s, e)]
            ok = min(near) < tol
            n_bad += not ok
            print(f"  {name} row {b}: event {s}..{e} in one table only, "
                  f"boundary margin {min(near)} (gate < {tol})")
    same = all(torch.equal(getattr(got, f).cpu(), getattr(ref, f).cpu())
               for f in ("start", "stop", "valid"))
    n_valid = int(ref.valid.sum())
    print(f"check {name}: card vs CPU {n_valid} CPU events, tables equal "
          f"{same}; unexplained differences {n_bad} (gate 0)")
    check(n_bad == 0, f"{name}: event tables differ beyond near-ties")
    if same:
        for f in ("duration", "peak_amp", "freq"):
            close(f"{name} {f}", getattr(got, f), getattr(ref, f))


def planted_spindles(rows, n, sf, seed, planted=True):
    """(rows, n) white noise with a 13 Hz spindle (Hann-shaped, amplitude
    4, 1 s) every SPINDLE_EVERY s from 30 s; returns (x, starts in s)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, n)).astype(np.float32)
    t = np.arange(n) / sf
    starts = np.arange(30.0, n / sf - 2.0, SPINDLE_EVERY)
    if planted:
        for t0 in starts:
            m = (t >= t0) & (t < t0 + 1.0)
            x[:, m] += (4.0 * np.sin(np.pi * (t[m] - t0)) ** 2
                        * np.sin(2 * np.pi * 13.0 * (t[m] - t0))).astype(
                            np.float32)
    return x, starts


def planted_slow_waves(rows, n, sf, seed, planted=True):
    """(rows, n) background of 0.15 x white noise with a 0.8 Hz single
    cycle (trough first, amplitude 3) every SO_EVERY s from 10 s
    (``tests/test_sleep.py``'s shape); returns (x, starts in s)."""
    rng = np.random.default_rng(seed)
    x = 0.15 * rng.standard_normal((rows, n))
    t = np.arange(n) / sf
    starts = np.arange(10.0, n / sf - 3.0, SO_EVERY)
    if planted:
        for t0 in starts:
            m = (t >= t0) & (t < t0 + 1.25)
            x[:, m] += -3.0 * np.sin(2 * np.pi * (t[m] - t0) / 1.25)
    return x.astype(np.float32), starts


def planted_found(name, tab, starts, sf, atol):
    """Every row finds each planted start within ``atol`` s, nothing else."""
    import torch
    worst, counts = 0.0, []
    for b in range(tab.valid.shape[0]):
        v = tab.valid[b].cpu().numpy()
        got = tab.start[b].cpu().numpy()[v] / sf
        counts.append(int(v.sum()))
        if got.size == starts.size:
            worst = max(worst, float(np.abs(got - starts).max()))
        else:
            worst = np.inf
    print(f"check {name}: events per row {counts} (planted {starts.size}), "
          f"worst start error {worst} s (gate {atol})")
    check(worst <= atol, f"{name}: planted events not found")


def microstate_recording(c, t, seed, dwell=50):
    """(C, T) recording of 4 orthonormal average-referenced maps with
    geometric dwell times, modulated amplitude, random polarity, 5% white
    noise (``tests/test_microstates.py``'s ``_planted``)."""
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((4, c))
    m -= m.mean(axis=1, keepdims=True)
    q, _ = np.linalg.qr(m.T)
    maps = q.T[:4]
    labels = np.zeros(t, np.int64)
    pos, state = 0, int(rng.integers(4))
    while pos < t:
        seg = max(3, int(rng.geometric(1.0 / dwell)))
        labels[pos:pos + seg] = state
        pos += seg
        state = int((state + 1 + rng.integers(3)) % 4)
    amp = 1.0 + 0.5 * np.sin(2 * np.pi * np.arange(t) / 97.0)
    x = maps[labels].T * (amp * rng.choice([-1.0, 1.0], t))[None, :]
    x = x + 0.05 * rng.standard_normal((c, t))
    return x.astype(np.float32), maps


def maps_recovered(name, got, maps):
    """Each planted map's best |r| with a fitted map (greedy match)."""
    import torch
    got = torch.as_tensor(got).cpu().numpy().astype(np.float64)
    r = np.abs(got @ maps.T)
    score = min(r[:, j].max() for j in range(maps.shape[0]))
    print(f"check {name}: every planted map found at |r| >= {score} "
          "(gate > 0.95)")
    check(score > 0.95, f"{name}: planted maps not recovered")


def slice13_phase(data):
    """Slice 13: ERP measures, entropy and DFA, sleep events, microstates,
    simulation and IAAFT, dipole fits and beamformers at the JAX
    package's bench shapes, each against the port's own CPU run and known
    answers, timed with its peak memory, no kernel launched; then the
    adapter chain on the serving data with a planted evoked response and
    on a 64-channel sleep recording, whose ``dfa`` rides K4.  Plain torch
    but for that kernel: nothing joins the kernels' record."""
    import torch
    import ninwavelets_tpu_torch as nt
    from ninwavelets_tpu_torch.ops import beamformer as bf
    from ninwavelets_tpu_torch.ops import complexity as cx
    from ninwavelets_tpu_torch.ops import erp
    from ninwavelets_tpu_torch.ops import leadfield as lf
    from ninwavelets_tpu_torch.ops import microstates as ms
    from ninwavelets_tpu_torch.ops import sim
    from ninwavelets_tpu_torch.ops import sleep
    from ninwavelets_tpu_torch.ops.cycles import _bandpass
    from ninwavelets_tpu_torch.ops.denoise import _median
    from ninwavelets_tpu_torch.ops.scattering import sym_eigh
    from ninwavelets_tpu_torch.parallel.streaming import StreamingCWT

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    print(card)
    t_phase = time.perf_counter()
    gen = np.random.default_rng(13)
    times = {}

    def bench(name, fn, fresh, slow_reps=None):
        out, counts, ms_ = timed_call(name, fn, fresh, card, slow_reps)
        check(not counts, f"{name} launched {counts}")
        times[name] = ms_
        return out

    def cuda(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(DEV)

    def flip(a):
        return lambda: np.negative(a, out=a)

    # -- microstates 64 x 120,000, K 4, 8 restarts, 40 steps (:588-596) -------
    xh = gen.standard_normal((64, MS_T)).astype(np.float32)
    x = cuda(xh)
    res = bench(f"microstate_fit 64 x {MS_T}, K 4, 8 restarts, 40 steps",
                lambda: ms.microstate_fit(x, 4, n_init=8, n_iter=40), x.neg_)
    check(0.0 <= float(res.gev) <= 1.0 and bool(res.maps.isfinite().all()),
          "microstate_fit on noise")
    s = torch.randn((32, 64, 200), device=DEV)
    s = s @ s.transpose(1, 2)
    sym_eigh(s)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    sym_eigh(s)
    stop.record()
    torch.cuda.synchronize()
    eig_ms = start.elapsed_time(stop)
    print(f"time microstate_fit's batched eigh alone (8 restarts x 4 states,"
          f" 64 x 64, float64 sym_eigh): {eig_ms} ms a step, "
          f"{40 * eig_ms} ms for 40 steps, on {card}")
    times["microstate eigh a step"] = eig_ms
    del x, res, s
    # card vs CPU: a planted 64-channel recording, the card's draws handed
    # over, 12,000 samples (the CPU's products at 120,000 take minutes)
    xm, maps = microstate_recording(64, MS_CPU_T, 1)
    xmc = cuda(xm)
    g = ms.gfp(ms._avg_ref(xmc))
    idx = torch.multinomial(ms._peak_mask(g).expand(8, -1), 4,
                            generator=torch.Generator(DEV).manual_seed(3))
    rc = ms._fit_from_idx(xmc, idx, n_states=4, n_iter=40)
    rh = ms._fit_from_idx(xm, idx.cpu(), n_states=4, n_iter=40,
                          device="cpu")
    same = torch.equal(rc.labels.cpu(), rh.labels)
    print(f"check microstate labels (64 x {MS_CPU_T}, the card's draws): "
          f"card vs CPU equal {same}")
    check(same, "microstate labels differ")
    close("microstate maps up to sign: card vs CPU",
          signed_rows(rc.maps, rh.maps), rh.maps)
    close("microstate gev: card vs CPU", rc.gev, rh.gev)
    maps_recovered("microstate_fit of the planted recording", rc.maps, maps)
    del xmc

    # -- sphere leadfield, 64 electrodes, 6 mm grid, 200 terms (:615-629) ----
    elec = lf.fibonacci_electrodes(64, HEAD_R)
    grid = lf.source_grid(HEAD_R, spacing=GRID_STEP, max_eccentricity=0.8)
    out = bench(f"sphere_leadfield 64 x {grid.shape[0]}, 200 terms",
                lambda: lf.sphere_leadfield(elec, grid, HEAD_R, n_terms=200,
                                            device=DEV), flip(elec))
    close("sphere_leadfield: card vs CPU", out, lf.sphere_leadfield(
        elec, grid, HEAD_R, n_terms=200, device="cpu"))
    del out

    # -- sample / permutation entropy 16 x 8 x 2048 (:657-668) ---------------
    xh = gen.standard_normal(ENT_SHAPE).astype(np.float32)
    x = cuda(xh)
    se = bench(f"sample_entropy {ENT_SHAPE}, m 2", lambda:
               cx.sample_entropy(x), x.neg_)
    close("sample_entropy (2 x 8 rows): card vs CPU", se[:2],
          cx.sample_entropy(xh[:2], device="cpu"))
    pe = bench(f"permutation_entropy {ENT_SHAPE}, m 3", lambda:
               cx.permutation_entropy(x), x.neg_)
    close("permutation_entropy: card vs CPU", pe,
          cx.permutation_entropy(xh, device="cpu"))
    print(f"check white-noise entropies: SampEn mean {se.mean().item()} "
          f"(about 2.2), PE mean {pe.mean().item()} (about 1)")
    check(abs(se.mean().item() - 2.2) < 0.2 and pe.min().item() > 0.99,
          "white-noise entropies")
    del x

    # -- spindles, 8 x 921,600 at 256 Hz, kmax 1024 (:690-696) --------------
    xh, starts = planted_spindles(8, SPINDLE_N, SLEEP_SF, 2)
    x = cuda(xh)
    tab = bench(f"detect_spindles 8 x {SPINDLE_N} at 256 Hz, kmax 1024",
                lambda: sleep.detect_spindles(x, SLEEP_SF, kmax=1024),
                x.neg_)
    ref = sleep.detect_spindles(xh, SLEEP_SF, kmax=1024, device="cpu")
    xf = _bandpass(torch.from_numpy(xh), SLEEP_SF, 11.0, 16.0)
    env = sleep._moving_rms(xf, 51)
    thr = 3.0 * _median(env)
    events_agree("detect_spindles", tab, ref,
                 (torch.abs(env - thr[:, None]) / thr[:, None]).numpy())
    planted_found("detect_spindles, planted 13 Hz spindles", tab, starts,
                  SLEEP_SF, 0.35)
    quiet, _ = planted_spindles(8, SPINDLE_N // 6, SLEEP_SF, 3,
                                planted=False)
    nq = int(sleep.detect_spindles(cuda(quiet), SLEEP_SF,
                                   kmax=1024).valid.sum())
    print(f"check detect_spindles on 8 x 10 min of white noise: {nq} events "
          "(gate 0)")
    check(nq == 0, "spindles found in pure noise")
    del x, tab, xf, env

    # -- jackknife onsets, 64 x 64 x 1024 over (100, 900) (:697-703) ---------
    xh = gen.standard_normal(JK_SHAPE).astype(np.float32)
    x = cuda(xh)
    ons = bench(f"jackknife_onsets {JK_SHAPE}, window (100, 900)", lambda:
                erp.jackknife_onsets(x, (100, 900)), x.neg_)
    refo = erp.jackknife_onsets(xh, (100, 900), device="cpu")
    x64 = xh.astype(np.float64)
    loo = (x64.sum(0, keepdims=True) - x64) / (x64.shape[0] - 1.0)
    seg = loo[..., 100:900]
    equal_but_ties("jackknife onsets", ons[0], refo[0],
                   onset_margin(seg, 0.5), 1e-5 * np.abs(seg).max())
    del x, loo, seg

    # -- DFA, 64 x 65,536 (:705-711) ------------------------------------------
    xh = gen.standard_normal(DFA_SHAPE).astype(np.float32)
    x = cuda(xh)
    alpha, fl = bench(f"dfa {DFA_SHAPE}, 12 scales", lambda: cx.dfa(x),
                      x.neg_)
    ah, fh = cx.dfa(xh, device="cpu")
    close("dfa alpha: card vs CPU", alpha, ah)
    close("dfa fluctuations: card vs CPU", fl, fh)
    brown = cx.dfa(torch.cumsum(x, -1))[0]
    print(f"check dfa: white noise alpha {alpha.min().item()}.."
          f"{alpha.max().item()} (gate 0.5 +- 0.1), its cumsum "
          f"{brown.min().item()}..{brown.max().item()} (gate 1.5 +- 0.15)")
    check(bool((alpha - 0.5).abs().max() < 0.1)
          and bool((brown - 1.5).abs().max() < 0.15), "dfa exponents")
    del x

    # -- LCMV, 5000 sources x 64 channels (:723-729) --------------------------
    lead = cuda(gen.standard_normal((LCMV_S, 64)).astype(np.float32))
    cov = cuda((np.eye(64) + 0.1).astype(np.float32))
    res = bench(f"lcmv {LCMV_S} sources x 64 channels",
                lambda: bf.lcmv(cov, lead), lead.neg_)
    refl = bf.lcmv(cov.cpu(), lead.cpu())
    for f in ("filters", "power", "nai"):
        close(f"lcmv {f}: card vs CPU", getattr(res, f), getattr(refl, f))
    del lead, res

    # -- dipole fits, 64 sensors (:800-823) -----------------------------------
    elec = lf.fibonacci_electrodes(64)
    lead1 = lf.sphere_leadfield(elec, DIPOLE[None], device="cpu").numpy()
    v_eeg = lead1.reshape(64, 3) @ np.array([1.0, 0.5, 0.2])
    fit = bench("fit_dipole 64 electrodes (200 Adam steps, 120 terms)",
                lambda: lf.fit_dipole(v_eeg, elec, device=DEV),
                flip(v_eeg), slow_reps=1)
    fit_cpu = lf.fit_dipole(v_eeg, elec, device="cpu")
    dipoles_agree("fit_dipole", fit, fit_cpu, DIPOLE)
    sens = lf.fibonacci_electrodes(64) * 1.2
    sori = sens / np.linalg.norm(sens, axis=1, keepdims=True)
    lead1 = lf.sphere_leadfield_meg(sens, sori, DIPOLE[None],
                                    device="cpu").numpy()
    v_meg = lead1.reshape(64, 3) @ np.array([1.0, 0.5, 0.0])
    fit = bench("fit_dipole_meg 64 sensors (300 Adam steps)",
                lambda: lf.fit_dipole_meg(v_meg, sens, sori, device=DEV),
                flip(v_meg), slow_reps=1)
    dipoles_agree("fit_dipole_meg", fit,
                  lf.fit_dipole_meg(v_meg, sens, sori, device="cpu"), DIPOLE)

    # -- slow oscillations, 8 x 30 min at 128 Hz (:825-836) -----------------
    xh, starts = planted_slow_waves(8, SO_N, SO_SF, 4)
    x = cuda(xh)
    tab = bench(f"detect_slow_oscillations 8 x {SO_N} at 128 Hz", lambda:
                sleep.detect_slow_oscillations(x, SO_SF), x.neg_)
    ref = sleep.detect_slow_oscillations(xh, SO_SF, device="cpu")
    xf = _bandpass(torch.from_numpy(xh), SO_SF, 0.3, 1.5)
    events_agree("detect_slow_oscillations", tab, ref,
                 (xf.abs() / xf.abs().amax(-1, keepdim=True)).numpy())
    planted_found("detect_slow_oscillations, planted 0.8 Hz waves", tab,
                  starts, SO_SF, 0.1)
    quiet, _ = planted_slow_waves(8, int(120 * SO_SF), SO_SF, 5,
                                  planted=False)
    nq = int(sleep.detect_slow_oscillations(cuda(quiet),
                                            SO_SF).valid.sum())
    print(f"check detect_slow_oscillations on 8 x 2 min of 0.15 x white "
          f"noise: {nq} events (gate 0)")
    check(nq == 0, "slow oscillations found in pure noise")
    del x, tab, xf

    # -- microstate syntax test, 500 shuffles (:837-847; host numpy) ---------
    lab = np.repeat(gen.integers(0, 4, 3000),
                    gen.integers(10, 40, 3000))[:60_000].astype(np.int32)
    asym, p = bench("microstate_syntax_test 60,000 labels, 500 shuffles",
                    lambda: ms.microstate_syntax_test(lab, 4, 500),
                    lambda: np.remainder(lab + 1, 4, out=lab))
    print(f"check microstate_syntax_test of i.i.d. segments: asym {asym}, "
          f"p {p} (gate p > 0.01)")
    check(p > 0.01, "syntax test on i.i.d. segments")

    # -- IAAFT, 19 surrogates, 100 iterations, N = 4096 (:911-917) -----------
    xh = np.cumsum(gen.standard_normal(IAAFT_N)).astype(np.float32)
    x = cuda(xh)
    surr = bench(f"iaaft_surrogates 19 x {IAAFT_N}, 100 iterations", lambda:
                 sim.iaaft_surrogates(0, x), x.neg_)
    target = torch.sort(x).values
    keeps = torch.equal(torch.sort(surr, -1).values, target.expand(19, -1))
    print(f"check iaaft keeps the sorted values exactly: {keeps}")
    check(keeps, "iaaft changed the values")
    noise = torch.randn((19, IAAFT_N), device=DEV,
                        generator=torch.Generator(DEV).manual_seed(4))
    one_c = sim._iaaft_from_noise(x, noise, 1)
    one_h = sim._iaaft_from_noise(x.cpu(), noise.cpu(), 1)
    spec = torch.fft.rfft(torch.gather(target.expand(19, -1).cpu(), -1,
                                       torch.argsort(noise.cpu(), dim=-1,
                                                     stable=True)))
    y = torch.fft.irfft(spec / spec.abs().clamp(min=1e-30)
                        * torch.fft.rfft(x.cpu()).abs(), n=IAAFT_N).numpy()
    ys = np.sort(y, -1)
    gaps = np.minimum(np.abs(np.diff(ys, prepend=-np.inf)),
                      np.abs(np.diff(ys, append=np.inf)))
    near = gaps[np.arange(19)[:, None], np.argsort(np.argsort(y, -1), -1)]
    equal_but_ties("iaaft one iteration, the card's shuffles",
                   one_c, one_h, near, 1e-5 * np.abs(y).max())
    many_c = sim._iaaft_from_noise(x, noise, 100)
    many_h = sim._iaaft_from_noise(x.cpu(), noise.cpu(), 100)
    amp = torch.fft.rfft(x.cpu()).abs()

    def spec_err(s):
        return ((torch.fft.rfft(s.cpu()).abs() - amp).norm(dim=-1)
                / amp.norm()).max().item()

    ec, eh = spec_err(many_c), spec_err(many_h)
    same = int((many_c.cpu() == many_h).all(-1).sum())
    print(f"check iaaft 100 iterations: {same} of 19 surrogates equal to "
          f"the CPU's; spectral error card {ec}, CPU {eh} (gate card <= "
          "1.1 x CPU + 1e-4)")
    check(ec <= 1.1 * eh + 1e-4, "iaaft spectra")
    del x, surr

    # -- free-orientation LCMV and DICS on a wavelet CSD, 16 x 64 x 2048 -----
    elec = lf.fibonacci_electrodes(64, HEAD_R)
    grid = lf.source_grid(HEAD_R, spacing=GRID_STEP, max_eccentricity=0.8)
    lead3 = lf.sphere_leadfield(elec, grid, HEAD_R, device=DEV).permute(
        1, 2, 0).contiguous()                              # (S, 3, C)
    src = int(np.argmin(np.linalg.norm(grid - DIPOLE, axis=1)))
    ori = np.array([0.3, 0.9, 0.3]) / np.linalg.norm([0.3, 0.9, 0.3])
    topo = (torch.from_numpy(ori.astype(np.float32)).to(DEV)
            @ lead3[src]).cpu().numpy()
    e_c, c_c, n_c = CSD_SHAPE
    t = np.arange(n_c) / SFREQ
    wave = np.sin(2 * np.pi * 10.0 * t[None, :]
                  + gen.uniform(0, 2 * np.pi, (e_c, 1)))
    sig_h = (topo[None, :, None] / np.abs(topo).max() * 3.0 * wave[:, None]
             + gen.standard_normal(CSD_SHAPE)).astype(np.float32)
    sig = cuda(sig_h)
    flat = sig_h.transpose(1, 0, 2).reshape(c_c, -1)
    covh = (flat @ flat.T / flat.shape[1]).astype(np.float32)
    cov = cuda(covh)
    res = bench(f"lcmv free orientation, {grid.shape[0]} sources x 64",
                lambda: bf.lcmv(cov, lead3), lead3.neg_)
    refl = bf.lcmv(covh, lead3.cpu(), device="cpu")
    ori_c, ori_h = res.orientations.cpu(), refl.orientations
    close("lcmv free orientations up to sign: card vs CPU",
          ori_c * torch.sign((ori_c * ori_h).sum(-1, keepdim=True)), ori_h,
          1e-4)
    for f in ("power", "nai"):
        close(f"lcmv free {f}: card vs CPU", getattr(res, f),
              getattr(refl, f))
    found = int(res.nai.argmax())
    dist = float(np.linalg.norm(grid[found] - grid[src]))
    print(f"check lcmv free NAI peak {dist} m from the planted source "
          "(gate <= 6 mm, one grid step)")
    check(dist <= 0.0061, "lcmv free NAI peak")
    bank = nt.Morse(SFREQ, interpolate=True, device=DEV).make_fft_wavelets(
        np.array([8.0, 10.0, 12.0]), n_c / SFREQ)
    csd = bench(f"wavelet_csd {CSD_SHAPE}, 3 rows", lambda:
                bf.wavelet_csd(sig, bank, True), sig.neg_)
    csd_h = bf.wavelet_csd(sig_h, bank.cpu(), True, device="cpu")
    close("wavelet_csd real: card vs CPU", csd.real, csd_h.real)
    close("wavelet_csd imag: card vs CPU", csd.imag, csd_h.imag)
    lead_fixed = torch.einsum("so,soc->sc", res.orientations, lead3)
    dres = bench(f"dics at 10 Hz, {grid.shape[0]} sources x 64", lambda:
                 bf.dics(csd[1], lead_fixed), lead_fixed.neg_)
    dref = bf.dics(csd[1].cpu(), lead_fixed.cpu())
    gate = solve_gate(csd[1].real, 0.05)
    for f in ("filters", "power", "nai"):
        close(f"dics {f}: card vs CPU (the card's CSD)", getattr(dres, f),
              getattr(dref, f), gate)
    found = int(dres.nai.argmax())
    dist = float(np.linalg.norm(grid[found] - grid[src]))
    print(f"check dics NAI peak {dist} m from the planted 10 Hz source "
          "(gate <= 6 mm)")
    check(dist <= 0.0061, "dics NAI peak")
    coh = bf.source_coherence(dres, csd[1])
    check(bool(coh.isfinite().all()), "source_coherence finite")
    del lead3, sig, res, dres, coh, csd
    torch.cuda.empty_cache()

    # -- the adapter chain ----------------------------------------------------
    launched = {}

    def call(name, fn, fresh, want, slow_reps=3):
        out_, counts, ms_ = timed_call(name, fn, fresh, card, slow_reps)
        launched[name] = counts
        check(counts == want, f"{name} launched {counts}, want {want}")
        times[name] = ms_
        return out_

    # the serving data with an evoked response: a dipole at DIPOLE on a
    # 64-electrode cap, a Gaussian wave ERP_T0 after the event (t = 0 at
    # sample 500)
    e_s, c_s, n_s = data.shape
    elec = lf.fibonacci_electrodes(c_s, HEAD_R)
    gain = lf.sphere_leadfield(elec, DIPOLE[None], HEAD_R,
                               device="cpu").numpy()[:, 0, :]
    topo = gain @ np.array([1.0, 0.5, 0.2])
    tt = np.arange(n_s) / SFREQ - 0.5
    wave = np.exp(-0.5 * ((tt - ERP_T0) / ERP_WIDTH) ** 2)
    erp_data = (data + (2.0 * topo / np.abs(topo).max())[None, :, None]
                * wave[None, None, :]).astype(np.float32)
    ew = nt.EpochsWavelet(nt.ArrayEpochs(erp_data, SFREQ, times=tt),
                          nt.Morse(SFREQ, interpolate=True, device=DEV))
    ev = call("EpochsWavelet.evoked", ew.evoked, negate(ew), {})
    close("evoked: the epoch mean", ev, torch.from_numpy(erp_data).mean(0))
    top = int(np.abs(topo).argmax())
    pol = 1 if topo[top] > 0 else -1
    pk = call("EpochsWavelet.erp_peak (0.2, 0.4) s", lambda:
              ew.erp_peak((0.2, 0.4), polarity=pol), negate(ew), {})
    lat = tt[int(pk.latency[top])]
    print(f"check erp_peak: channel {top} peaks at {lat} s (planted "
          f"{ERP_T0}; gate +- 5 ms)")
    check(abs(lat - ERP_T0) <= 0.005, "erp_peak latency")
    ons = call("EpochsWavelet.erp_onset (0.1, 0.5) s", lambda:
               ew.erp_onset((0.1, 0.5), polarity=pol), negate(ew), {})
    onset = tt[int(round(ons[1][top].item()))]
    want_on = ERP_T0 - ERP_WIDTH * np.sqrt(2 * np.log(2))
    print(f"check erp_onset: channel {top} mean onset {onset} s (half-peak "
          f"of the planted wave {want_on} s; gate +- 10 ms), se "
          f"{ons[2][top].item()} samples")
    check(abs(onset - want_on) <= 0.01, "erp_onset")
    se = call("EpochsWavelet.sample_entropy", ew.sample_entropy, negate(ew),
              {}, slow_reps=1)
    pe = call("EpochsWavelet.permutation_entropy", ew.permutation_entropy,
              negate(ew), {})
    mse = call("EpochsWavelet.multiscale_entropy", ew.multiscale_entropy,
               negate(ew), {}, slow_reps=1)
    check(se.shape == (e_s, c_s) and pe.shape == (e_s, c_s)
          and mse.shape == (e_s, c_s, 10)
          and bool(se.isfinite().all()) and bool(mse[..., 0].isfinite().all()),
          "entropy shapes")
    close("sample_entropy (2 epochs): card vs CPU", se[:2],
          cx.sample_entropy(erp_data[:2], device="cpu"))
    fit = call("EpochsWavelet.fit_dipole", lambda: ew.fit_dipole(elec),
               negate(ew), {}, slow_reps=1)
    err = float(np.linalg.norm(fit["pos"] - DIPOLE))
    print(f"check EpochsWavelet.fit_dipole: {err * 1e3} mm from the planted "
          f"dipole (gate 5 mm), gof {fit['gof']} (gate > 0.9) at sample "
          f"{fit['peak_sample']}")
    check(err < 0.005 and fit["gof"] > 0.9, "adapter fit_dipole")
    del ew, ev, se, pe, mse
    torch.cuda.empty_cache()

    # a 64-channel sleep recording: planted microstates everywhere, spindles
    # on channels 0-7, slow waves on 8-15, 20 min at 256 Hz
    n_rec = int(SLEEP_REC_MIN * 60 * SLEEP_SF)
    rec, _ = microstate_recording(64, n_rec, 6)
    spin, sp_starts = planted_spindles(8, n_rec, SLEEP_SF, 7)
    rec[:8] += 0.5 * spin
    slow, so_starts = planted_slow_waves(8, n_rec, SLEEP_SF, 8)
    rec[8:16] += slow
    names = [f"EEG{i:03d}" for i in range(64)]
    rw = nt.RawWavelet(NamedRaw(rec, SLEEP_SF, names),
                       nt.Morse(SLEEP_SF, device=DEV), window=12_000)
    stream = rw._stream_for([10.0])
    ext = stream.window + 2 * stream.halo
    n_batches = -(-n_rec // (stream.window * stream.batch))
    print(f"RawWavelet.dfa stream: window {stream.window}, halo "
          f"{stream.halo}, extended {ext} ('power_each' to 16384), "
          f"{n_batches} window batches")
    check(ext <= 16384, "RawWavelet.dfa's windows cannot reach K4")
    alpha, _ = call("RawWavelet.dfa at 10 Hz", lambda:
                    rw.dfa("EEG000", 10.0), negate(rw),
                    {"power_each": n_batches})
    check(bool(alpha.isfinite()), "RawWavelet.dfa alpha")
    env = torch.sqrt(rw.power_channel("EEG000", [10.0])[0].clamp(min=0))
    plain = StreamingCWT(
        rw.wavelet._wdef(), np.array([10.0], np.float32), SLEEP_SF,
        window=stream.window, halo=stream.halo,
        interpolate=rw.wavelet.interpolate, use_fused=False,
        device=DEV).power_device(rec[0])[0]
    close("RawWavelet.dfa envelope: K4 vs the plain stream", env ** 2,
          plain)
    tab = call("RawWavelet.spindles (channels 0-7)", lambda:
               rw.spindles(picks=names[:8]), negate(rw), {})
    planted_found("RawWavelet.spindles", tab, sp_starts, SLEEP_SF, 0.35)
    tab = call("RawWavelet.slow_oscillations (channels 8-15)", lambda:
               rw.slow_oscillations(picks=names[8:16]), negate(rw), {})
    planted_found("RawWavelet.slow_oscillations", tab, so_starts, SLEEP_SF,
                  0.1)
    res, stats = call("RawWavelet.microstates", rw.microstates, negate(rw),
                      {}, slow_reps=1)
    print(f"check RawWavelet.microstates: gev {float(res.gev)}, coverage "
          f"{stats['coverage']}, mean durations {stats['duration']} s")
    check(0.0 < float(res.gev) <= 1.0 and res.labels.shape == (n_rec,)
          and abs(stats["coverage"].sum() - 1.0) < 1e-5,
          "RawWavelet.microstates")
    del rw, rec
    torch.cuda.empty_cache()
    print(f"slice-13 adapter launches {launched}, on {card}")
    print(f"slice-13 phase {time.perf_counter() - t_phase} s; times (ms) "
          f"{json.dumps(times)}")


def solve_gate(cov, reg):
    """1e-5, or the float32 bound of a solve with the loaded ``cov`` where
    that is larger: 2 x its condition number x 2^-24 (cuSOLVER and LAPACK
    round the same ill-conditioned solve differently)."""
    import torch
    a = torch.as_tensor(cov).detach().cpu().double()
    a = a + reg * torch.trace(a) / a.shape[0] * torch.eye(a.shape[0],
                                                          dtype=a.dtype)
    cond = torch.linalg.cond(a).item()
    gate = max(1e-5, 2.0 * cond * 2.0 ** -24)
    print(f"solve gate: condition {cond} of the loaded matrix -> {gate}")
    return gate


def dipoles_agree(name, fit, ref, truth):
    """A dipole fit on the card against the CPU's: the same grid point,
    the position within 1 um and the GOF within 1e-6
    (``tests/test_torch_leadfield_beamformer.py``), the moment at 1e-4 of
    its max (it follows the position: about 1e-4 a um at 1 cm from the
    sensors, where the tests' fits agree to nm and hold it at 1e-5); and
    the planted dipole within 1 mm at GOF above 0.99."""
    same_grid = bool(np.array_equal(fit["grid_pos"], ref["grid_pos"]))
    dpos = float(np.abs(fit["pos"] - ref["pos"]).max())
    dq = float(np.abs(fit["moment"] - ref["moment"]).max()
               / np.abs(ref["moment"]).max())
    err = float(np.linalg.norm(fit["pos"] - truth))
    print(f"check {name}: card vs CPU grid point equal {same_grid}, "
          f"position max|d| {dpos} m (gate 1e-6), moment {dq} (gate 1e-4), "
          f"gof {fit['gof']} vs {ref['gof']} (gate 1e-6); {err * 1e3} mm "
          "from the planted dipole (gate 1 mm, gof > 0.99)")
    check(same_grid and dpos <= 1e-6 and dq <= 1e-4
          and abs(fit["gof"] - ref["gof"]) <= 1e-6, f"{name}: card vs CPU")
    check(err < 1e-3 and fit["gof"] > 0.99, f"{name}: planted dipole")


# -- slice 14: file formats, the pipeline config, the utilities ------------

MARKER_EVERY, MARKER_FIRST, MARKER_N = 2500, 1000, 200   # samples, events
TRIGGER_LEN = 50                                         # Status samples
PIPE_PERMS = 256                                         # bench.py's perms
PIPE_CONN_WINDOW = (0.5, 1.5)                            # s
#: Channels of the cluster stage's own run_pipeline call: its single-trial
#: planes, their z-scores and the null's per-chunk maps at all 64 channels
#: (200 x 64 x 100 x 2048) pass the card's 80 GB (72 GB allocated when it
#: ran out).
PIPE_CLUSTER_C = 32


class _StageLog:
    """Collects ``run_pipeline``'s per-stage times, which it logs through
    ``utils.observability.Timer`` at DEBUG level (each stage synchronized
    before its clock stops)."""

    def __init__(self):
        import logging
        self.times = {}
        self._log = logging.getLogger("ninwavelets_tpu_torch")
        self._handler = logging.Handler(logging.DEBUG)
        self._handler.emit = self._emit

    def _emit(self, record):
        name, seconds = record.args
        self.times[name.replace("run_pipeline ", "")] = seconds * 1e3

    def __enter__(self):
        import logging
        self._level = self._log.level
        self._log.setLevel(logging.DEBUG)
        self._log.addHandler(self._handler)
        return self

    def __exit__(self, *exc):
        self._log.removeHandler(self._handler)
        self._log.setLevel(self._level)


def file_recording_check(name, rw, freqs, ref_data, names, card):
    """One file-backed ``RawWavelet.power`` through K4: the launches (one
    per window batch, nothing else), the plane against the in-memory
    ``RawWavelet`` over the reader's own ``get_data()`` (1e-5 of the max),
    the call's median time and the window gathers' share of it."""
    import torch
    import ninwavelets_tpu_torch as nt
    from ninwavelets_tpu_torch import kernels
    stream = rw._stream_for(freqs)
    n_batches = -(-REC_N // (stream.window * REC_BATCH))
    check(stream.window + 2 * stream.halo == REC_EXT,
          f"{name}: extended window {stream.window + 2 * stream.halo}")
    torch.cuda.synchronize()
    before = dict(kernels.launches)
    t0 = time.perf_counter()
    plane = rw.power(freqs)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    counts = launched_since(before)
    print(f"{name}.power: first call {first} s ({REC_C} x {REC_N}, {REC_F} "
          f"rows, window {stream.window}, halo {stream.halo}, "
          f"{n_batches} batches of {REC_BATCH}); launches {counts}")
    check(counts == {"power_each": n_batches}, f"{name}.power launched "
          f"{counts}, want K4 once per window batch ({n_batches})")
    mem = nt.RawWavelet(NamedRaw(ref_data, SFREQ, names),
                        nt.Morse(SFREQ, interpolate=True, device="cuda"),
                        window=REC_WINDOW, batch=REC_BATCH)
    rel_err(f"{name}.power vs the in-memory RawWavelet of get_data()",
            plane, mem.power(freqs))
    del plane, mem
    torch.cuda.empty_cache()
    source = rw._file_source()
    starts = np.arange(0, REC_N, stream.window)
    t0 = time.perf_counter()
    for i in range(0, len(starts), REC_BATCH):
        source.gather(starts[i:i + REC_BATCH], stream.window, stream.halo)
    gather_ms = (time.perf_counter() - t0) * 1e3
    ms = host_ms(lambda _: rw.power(freqs), lambda: None)
    print(f"time {name}.power: {ms} ms (median of {REPS}); its {n_batches} "
          f"window gathers alone {gather_ms} ms ({gather_ms / ms} of the "
          f"call; the stream overlaps each gather with the card's work on "
          f"the batch before), on {card}")
    torch.cuda.empty_cache()
    return ms, gather_ms


def pipeline_call(label, cfg, data, card, times):
    """One timed ``config.run_pipeline`` on the card: its total and
    per-stage times, peak memory and launches, printed with the card's
    name and power limit; returns (output, launches)."""
    import torch
    import ninwavelets_tpu_torch as nt
    from ninwavelets_tpu_torch import config, kernels
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = dict(kernels.launches)
    with _StageLog() as stages:
        t0 = time.perf_counter()
        out = config.run_pipeline(cfg, nt.ArrayEpochs(data, SFREQ))
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    counts = launched_since(before)
    e, c, n = data.shape
    print(f"run_pipeline, {label} ({e} x {c} x {n}, {F} rows): {total} ms "
          f"(first call: bank builds and the copy to the card included); "
          f"stages (ms) {json.dumps(stages.times)}; peak {peak} bytes "
          f"allocated, {peak - held} above the {held} held before; launches "
          f"{counts}; on {card}")
    times[f"run_pipeline, {label}"] = total
    times.update({f"run_pipeline {k} ({c} channels)": v
                  for k, v in stages.times.items()})
    return out, counts


def slice14_phase(data):
    """Slice 14: a 64 x 600,000 recording written as BDF (with a Status
    channel) and as BrainVision (with markers) and streamed off each file
    through K4; epochs cut at the file's markers through K1/K2; then
    ``config.run_pipeline`` with every stage at the serving width, each
    output against the port's own pieces.  Nothing here joins the kernels'
    record."""
    import shutil
    import tempfile
    import torch
    import ninwavelets_tpu_torch as nt
    from ninwavelets_tpu_torch import config, io, kernels
    from ninwavelets_tpu_torch.ops import cluster as cl
    from ninwavelets_tpu_torch.ops import cwt, fused, sst, tc_stats
    from ninwavelets_tpu_torch.ops.baseline import baseline_tf
    from ninwavelets_tpu_torch.ops.connectivity import (coherence_matrix,
                                                        plv_matrix)
    from ninwavelets_tpu_torch.ops.ridge import ridge_frequencies
    from ninwavelets_tpu_torch.ops.specparam import specparam

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    print(card)
    t_phase = time.perf_counter()
    times = {}
    tmp = tempfile.mkdtemp(prefix="ninw_slice14_")
    try:
        rec = recording(14)
        names = [f"EEG{i:03d}" for i in range(REC_C)]
        freqs = np.linspace(2.0, 100.0, REC_F)
        onsets = MARKER_FIRST + MARKER_EVERY * np.arange(MARKER_N)
        codes = np.tile([1, 2], MARKER_N // 2)

        # -- BDF: 64 channels + Status, streamed through K4 --------------------
        status = np.zeros(REC_N)
        for s, code in zip(onsets, codes):
            status[s:s + TRIGGER_LEN] = code
        bdf = os.path.join(tmp, "rec.bdf")
        t0 = time.perf_counter()
        io.write_bdf(bdf, np.vstack([rec, status[None]]), SFREQ,
                     ch_names=names + ["Status"])
        times["write_bdf"] = (time.perf_counter() - t0) * 1e3
        rw = nt.RawWavelet.from_bdf(
            bdf, nt.Morse(SFREQ, interpolate=True, device="cuda"),
            picks=names, window=REC_WINDOW, batch=REC_BATCH)
        reader = rw.raw.reader
        t0 = time.perf_counter()
        ref = reader.get_data(names)
        times["BDFReader.get_data"] = (time.perf_counter() - t0) * 1e3
        quant = np.abs(ref - rec).max() / np.abs(rec).max()
        print(f"check BDF round trip: max|d| / max {quant} (24-bit "
              f"quantization, gate 2^-23)")
        check(quant <= 2.0 ** -23, f"BDF round trip {quant}")
        events = io.status_events(reader.get_data(["Status"])[0])
        want = [(int(s), "Status", str(int(c))) for s, c in zip(onsets,
                                                                codes)]
        print(f"check status_events: {len(events)} events, equal to the "
              f"{len(want)} planted {events == want}")
        check(events == want, "status_events differ from the planted "
              "triggers")
        times["from_bdf.power"], times["BDF gathers"] = file_recording_check(
            "from_bdf", rw, freqs, ref, names, card)
        del rw, reader, ref, status
        os.remove(bdf)

        # -- BrainVision: the same recording with 200 markers -------------------
        vhdr = os.path.join(tmp, "rec.vhdr")
        marks = [(int(s), "Stimulus", f"S  {c}") for s, c in zip(onsets,
                                                                 codes)]
        t0 = time.perf_counter()
        io.write_brainvision(vhdr, rec, SFREQ, ch_names=names, markers=marks)
        times["write_brainvision"] = (time.perf_counter() - t0) * 1e3
        rwb = nt.RawWavelet.from_brainvision(
            vhdr, nt.Morse(SFREQ, interpolate=True, device="cuda"),
            window=REC_WINDOW, batch=REC_BATCH)
        check(rwb.raw.reader.markers == marks, "BrainVision markers differ")
        ref = rwb.raw.reader.get_data()
        check(np.array_equal(ref, rec), "BrainVision float32 round trip")
        times["from_brainvision.power"], times["BV gathers"] = \
            file_recording_check("from_brainvision", rwb, freqs, ref, names,
                                 card)
        del ref

        # -- epochs at the file's markers through K1/K2 -------------------------
        ev_freqs = np.arange(1.0, F + 1.0)
        torch.cuda.synchronize()
        before = dict(kernels.launches)
        t0 = time.perf_counter()
        ew = rwb.epochs_from_markers(EVENT_TMIN, EVENT_TMAX,
                                     description="S  1")
        p_ev = ew.power_all(ev_freqs)
        i_ev = ew.itc_all(ev_freqs)
        torch.cuda.synchronize()
        times["epochs_from_markers + power_all + itc_all (first call)"] = (
            time.perf_counter() - t0) * 1e3
        counts = launched_since(before)
        x_ev = ew._all_data()
        print(f"epochs_from_markers: {tuple(x_ev.shape)} epochs, launches "
              f"{counts}")
        check(tuple(x_ev.shape) == (MARKER_N // 2, REC_C, N),
              f"marker epochs {tuple(x_ev.shape)}")
        check(counts == {"power": 1, "itc": 1}, f"marker epochs launched "
              f"{counts}, want K1 and K2 once each")
        check(list(np.unique(ew.event_codes)) == ["S  1"],
              "marker epochs' codes")
        mem = nt.RawWavelet(NamedRaw(rec, SFREQ, names),
                            nt.Morse(SFREQ, interpolate=True, device="cuda"))
        ew_ref = mem.epochs(onsets[codes == 1], EVENT_TMIN, EVENT_TMAX)
        check(np.array_equal(ew._host_data(), ew_ref._host_data()),
              "marker epochs differ from RawWavelet.epochs at the same "
              "events")
        bank_ev = ew.wavelet.fft_wavelets
        ref_power = cwt.mean_power_from_bank(x_ev, bank_ev, True)
        rel_err("epochs_from_markers power_all vs the in-memory epochs",
                p_ev, ew_ref.power_all(ev_freqs))
        rel_err("epochs_from_markers power_all vs plain", p_ev, ref_power)
        itc_err("epochs_from_markers itc_all vs the in-memory epochs", i_ev,
                ew_ref.itc_all(ev_freqs), ref_power)
        itc_err("epochs_from_markers itc_all vs plain", i_ev,
                cwt.itc_from_bank(x_ev, bank_ev, True), ref_power)
        groups = rwb.epochs_from_markers(EVENT_TMIN, EVENT_TMAX).split()
        check(sorted(groups) == ["S  1", "S  2"] and all(
            len(g._host_data()) == MARKER_N // 2 for g in groups.values()),
            "split() by marker description")
        del rwb, ew, ew_ref, mem, groups, x_ev, p_ev, i_ev, ref_power
        os.remove(vhdr)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del rec
    torch.cuda.empty_cache()

    # -- run_pipeline, every stage, at the serving width ------------------------
    # The cluster stage runs in a second call on PIPE_CLUSTER_C channels.
    cfg = config.PipelineConfig(
        wavelet=config.MorseConfig(sfreq=SFREQ, interpolate=True),
        freqs=(1.0, F + 1.0, 1.0), baseline=BASELINE, significance=0.95,
        global_spectrum=True, ridge=True, ssq=True, superlet=(1, 4),
        connectivity="both", connectivity_window=PIPE_CONN_WINDOW,
        specparam=True)
    out, counts = pipeline_call("every stage but the cluster test", cfg,
                                data, card, times)
    for key in ("power_itc", "amax", "ssq", "power_each"):
        check(counts.get(key, 0) >= 1, f"run_pipeline never launched "
              f"{key!r}: a plain path ran where the kernel should")
    check(counts.get("power_itc") == 1 and counts.get("amax") == 1
          and counts.get("ssq") == 1, f"run_pipeline launched {counts}: "
          "K2 'power_itc', K5a and K5b once each")
    check(not {"power", "itc"} & set(counts),
          f"run_pipeline launched separate reductions {counts}")
    for key in ("power", "itc", "significant", "ssq_power",
                "superlet_power", "plv_matrix", "coherence_matrix",
                "global_spectrum"):
        check(out[key].device.type == "cuda", f"{key} not on the card")
    for key in ("freqs", "coi", "ridge_hz"):
        check(isinstance(out[key], np.ndarray), f"{key} not numpy")

    # -- each output against the port's own pieces ---------------------------
    w = out["wavelet"]
    x = torch.from_numpy(data).cuda()
    bank = w.fft_wavelets
    fr = out["freqs"]
    plain_p = cwt.mean_power_from_bank(x, bank, True)
    baselined_err("run_pipeline power (baselined) vs plain", out["power"],
                  plain_p)
    itc_err("run_pipeline itc vs plain", out["itc"],
            cwt.itc_from_bank(x, bank, True), plain_p)
    host = data
    alpha = [float(np.mean([tc_stats.ar1_coefficient(r)
                            for r in host[:, ch]])) for ch in range(C)]
    var = [float(np.mean(np.var(host[:, ch], axis=-1))) for ch in range(C)]
    thr = torch.stack([tc_stats.significance_level(
        bank, SFREQ, alpha[ch], var[ch], 0.95, E) for ch in range(C)])
    plain_sig = plain_p > thr[..., None]
    near = ((plain_p - thr[..., None]).abs()
            <= POWER_RTOL * plain_p.amax(dim=(-2, -1), keepdim=True))
    differ = out["significant"] != plain_sig
    print(f"check run_pipeline significant vs the plain power's mask: "
          f"{int(differ.sum())} cells differ, {int((differ & ~near).sum())} "
          f"of them farther than the power gate from the threshold (gate "
          f"0); {int(plain_sig.sum())} of {plain_sig.numel()} significant")
    check(not bool((differ & ~near).any()), "run_pipeline significant")
    hint = sst.uniform_grid_hint(np.float32(fr))
    ssq_err("run_pipeline ssq_power vs plain", out["ssq_power"],
            sst.ssq_mean_power_from_bank(x, bank, None, SFREQ, True, 1e-6,
                                         hint))
    sub = 4                                   # channels of the plain superlet
    rel_err(f"run_pipeline superlet_power vs plain (channels 0-{sub - 1})",
            out["superlet_power"][:sub],
            plain_superlet(x[:, :sub], fr, order_max=4, interpolate=True),
            1e-4)
    trange = tuple(int(round(s * SFREQ)) for s in PIPE_CONN_WINDOW)
    for key, fn in (("plv_matrix", plv_matrix),
                    ("coherence_matrix", coherence_matrix)):
        direct = fn(x, bank, interpolate=True, time_range=trange)
        same = torch.equal(out[key], direct)
        print(f"check run_pipeline {key} vs {fn.__name__} called directly: "
              f"identical {same}")
        check(same, f"run_pipeline {key}")
    coi = out["coi"]
    rel_err("run_pipeline global_spectrum vs plain",
            out["global_spectrum"], tc_stats.global_spectrum(plain_p, coi))
    p_k, _ = fused.power_itc_auto(x, bank, interpolate=True)
    ridge = np.stack([ridge_frequencies(p_k[ch], fr) for ch in range(sub)])
    same = np.array_equal(ridge, out["ridge_hz"][:sub])
    print(f"check run_pipeline ridge_hz vs ridge_frequencies of the K2 "
          f"power (channels 0-{sub - 1}): identical {same}")
    check(same, "run_pipeline ridge_hz")
    fit = specparam(out["global_spectrum"], fr, max_peaks=4)
    close("run_pipeline specparam model vs specparam called directly",
          out["specparam"].model, fit.model, 1e-6)
    del p_k, fit, out, plain_p
    torch.cuda.empty_cache()

    # -- the cluster stage, on PIPE_CLUSTER_C channels ---------------------------
    cc = PIPE_CLUSTER_C
    ring = tuple((i, (i + 1) % cc) for i in range(cc))
    cfg = config.PipelineConfig(
        wavelet=config.MorseConfig(sfreq=SFREQ, interpolate=True),
        freqs=(1.0, F + 1.0, 1.0), baseline=BASELINE, cluster_test=True,
        cluster_adjacency=ring, cluster_n_perm=PIPE_PERMS)
    sub_data = np.ascontiguousarray(data[:, :cc])
    out, counts = pipeline_call(
        f"the cluster test ({cc} channels, a {cc}-channel ring, "
        f"{PIPE_PERMS} permutations)", cfg, sub_data, card, times)
    check(counts.get("power_itc") == 1 and counts.get("power_each", 0) >= 1
          and not {"power", "itc"} & set(counts),
          f"run_pipeline (cluster) launched {counts}: K2 'power_itc' once "
          "and K4 for the single-trial planes")
    res = out["cluster"]
    bank = out["wavelet"].fft_wavelets
    x = x[:, :cc].contiguous()
    planes = baseline_tf(fused.power_auto(x, bank, interpolate=True), SFREQ,
                         *BASELINE)
    direct = cl.cluster_test_one_sample(
        planes, n_perm=PIPE_PERMS,
        adjacency=np.asarray(ring, np.int32))
    same = (np.array_equal(res.t_obs, direct.t_obs)
            and np.array_equal(res.null_max, direct.null_max)
            and np.array_equal(res.p_map, direct.p_map))
    print(f"check run_pipeline cluster vs cluster_test_one_sample of the K4 "
          f"planes: identical {same}; {len(res.clusters)} clusters, smallest "
          f"p {res.clusters[0]['p'] if res.clusters else None}")
    check(same, "run_pipeline cluster")
    del planes, direct
    torch.cuda.empty_cache()
    rel_err("K4 planes (epochs 0-7) vs plain", fused.power_auto(
        x[:8], bank, interpolate=True), cwt.power_from_bank(x[:8], bank,
                                                             True))
    del out, res, x
    torch.cuda.empty_cache()
    print(f"slice-14 phase {time.perf_counter() - t_phase} s; times (ms) "
          f"{json.dumps(times)}; on {card}")


#: Slice 15, the multi-device layer.  The four gloo ranks that share the card
#: and their collectives' time limit; the kernels every rank must launch on
#: the phase's main path; the small cases' shape (E, C, N, F), permutations
#: and the planes of the adapter's cluster test.
MESH_WORLD, MESH_TIMEOUT_S = 4, 300.0
MESH_KERNELS = ("power", "itc", "power_itc", "power_cx", "itc_cx",
                "power_itc_cx", "coherence", "phaselag", "power_each")
MESH_E, MESH_C, MESH_N, MESH_F = 8, 4, 1024, 16
MESH_PERMS = 256
MESH_SF = 250.0


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()


def mesh_full(x):
    """Sharded results (DTensors, in tuples, lists and NamedTuples) gathered
    whole; every rank of the mesh calls this, in the same order."""
    from ninwavelets_tpu_torch.parallel import full_tensor
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(mesh_full(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(mesh_full(v) for v in x)
    return full_tensor(x)


def mesh_err(name, got, ref, gate):
    """Gathered sharded result(s) against the single-device one(s): float
    tensors at ``gate`` (max|d| / max|ref|), the rest (and ``gate`` "same")
    bit for bit."""
    import torch
    if isinstance(ref, (tuple, list)) and not isinstance(ref[0], dict):
        return max(mesh_err(f"{name}[{i}]", g, r, gate)
                   for i, (g, r) in enumerate(zip(got, ref)))
    if (isinstance(ref, torch.Tensor) and not ref.is_floating_point()
            and gate != "same"):
        moved = (got != ref).float().mean().item()
        print(f"check {name}: share of entries that differ {moved} (gate "
              f"{gate})")
        check(moved <= gate, f"{name}: {moved} of the entries differ")
        return moved
    if gate == "same" or not isinstance(ref, torch.Tensor):
        same = same_result(got, ref)
        print(f"check {name}: bit for bit {same}")
        check(same, f"{name}: differs from the single-device result")
        return 0.0
    return rel_err(name, got, ref, gate)


def mesh_small_cases(mesh, part):
    """(name, sharded call, single-device call, gate) for the sharded
    functions at a small size on ``mesh``'s card: ``part`` "all" (every
    sharded, distributed and chunked function and the adapter's
    ``cluster_test(mesh=)``) or "stats" (the statistics and decoders)."""
    import torch
    import ninwavelets_tpu_torch as nt
    from ninwavelets_tpu_torch import parallel as par
    from ninwavelets_tpu_torch.ops import cluster, cwt, decoding, dwt
    from ninwavelets_tpu_torch.ops import connectivity as conn
    from ninwavelets_tpu_torch.ops import envelope, fused, granger, hmm, ica
    from ninwavelets_tpu_torch.ops import extensions as ext
    from ninwavelets_tpu_torch.ops import multitaper, reassign, spatial, sst
    from ninwavelets_tpu_torch.ops import superlets
    from ninwavelets_tpu_torch.ops.stockwell import stockwell as s_transform
    from ninwavelets_tpu_torch.parallel import pow2_halo

    gen = np.random.default_rng(15)

    def card(a):
        return torch.from_numpy(np.asarray(a, np.float32)).cuda()

    e, c, n, f = MESH_E, MESH_C, MESH_N, MESH_F
    t = np.arange(n) / SFREQ
    x = card(gen.standard_normal((e, c, n)) + np.sin(2 * np.pi * 40 * t))
    y = pair_b(x)
    freqs = np.linspace(10.0, 80.0, f)
    bank, bank_t = morse_bank(freqs, n, False), morse_bank(freqs, n, True)
    cxb = cx_bank("MexicanHat", freqs, n, False)
    planes = card(gen.standard_normal((32, 20, 256)))
    planes[:, 5:9, 100:160] += 0.9
    planes_b = card(gen.standard_normal((16, 20, 256)))
    x_h = card(hmm_frames(8, 400, 3))
    src = np.stack([np.sign(np.sin(np.arange(40000) / 37.0)),
                    gen.laplace(size=40000)] + [gen.uniform(-1.7, 1.7, 40000)
                                                for _ in range(14)])
    x_i = card(gen.standard_normal((16, 16)) @ src)
    cov_a = card(gen.standard_normal((32, 16, 512)))
    cov_b = card(gen.standard_normal((32, 16, 512)) * np.linspace(
        0.5, 2.0, 16)[None, :, None])
    tf_a = card(gen.standard_normal((24, 8, 20, 256)))
    tf_a[:, :, 4:8] += 0.5
    tf_b = card(gen.standard_normal((24, 8, 20, 256)))
    stats = [
        ("sharded_cluster_test_one_sample",
         lambda: par.sharded_cluster_test_one_sample(
             planes, mesh=mesh, n_perm=MESH_PERMS, seed=1),
         lambda: cluster.cluster_test_one_sample(planes, n_perm=MESH_PERMS,
                                                 seed=1), "same"),
        ("sharded_cluster_test_independent",
         lambda: par.sharded_cluster_test_independent(
             planes[:16], planes_b, mesh=mesh, n_perm=MESH_PERMS, seed=2),
         lambda: cluster.cluster_test_independent(
             planes[:16], planes_b, n_perm=MESH_PERMS, seed=2), "same"),
        ("sharded_cluster_test_f",
         lambda: par.sharded_cluster_test_f(
             [planes[:12], planes[12:24], planes_b[:12]], mesh=mesh,
             n_perm=MESH_PERMS, seed=3),
         lambda: cluster.cluster_test_f(
             [planes[:12], planes[12:24], planes_b[:12]],
             n_perm=MESH_PERMS, seed=3), "same"),
        ("sharded_cluster_null",
         lambda: par.sharded_cluster_null(planes, 4, mesh=mesh,
                                          n_perm=MESH_PERMS, threshold=2.0),
         lambda: cluster._sign_flip_null(planes, 4, n_perm=MESH_PERMS,
                                         threshold=2.0), "same"),
        ("sharded_tf_decode",
         lambda: par.sharded_tf_decode(tf_a, tf_b, mesh=mesh),
         lambda: decoding.tf_decode(tf_a, tf_b), 1e-5),
        ("sharded_hmm_fit",
         lambda: par.sharded_hmm_fit(x_h, mesh=mesh, n_states=HMM_K,
                                     n_iter=20, seed=0),
         lambda: hmm.hmm_fit(x_h, HMM_K, n_iter=20, seed=0), 1e-3),
        ("sharded_fastica",
         lambda: par.sharded_fastica(x_i, mesh=mesh, n_iter=50, seed=0),
         lambda: ica.fastica(x_i, n_iter=50, seed=0), 1e-3),
        ("sharded_covariance",
         lambda: par.sharded_covariance(cov_a, mesh=mesh),
         lambda: spatial.covariance(cov_a), 1e-5),
        ("sharded_csp",
         lambda: par.sharded_csp(cov_a, cov_b, mesh=mesh),
         lambda: spatial.csp(cov_a, cov_b), 1e-4),
    ]
    if part == "stats":
        return stats
    hint = sst.uniform_grid_hint(freqs.astype(np.float32))
    sl_banks = superlets.superlet_banks(freqs, n, SFREQ, order_max=3,
                                        device="cuda")
    sl_w = superlets.superlet_weights(freqs, 1, 3)
    mt_banks = multitaper.multitaper_banks(freqs, n, SFREQ, n_tapers=2,
                                           device="cuda")
    mt_flat = mt_banks.reshape(-1, n)
    g = card(gen.standard_normal((c, f, n)))
    fp = np.array([6.0, 8.0, 10.0, 12.0])
    bp, ba = morse_bank(fp, n, False), morse_bank(freqs[8:], n, False)
    _, gc_bank = granger._granger_inputs(x, SFREQ, 9, True, device="cuda")
    morse_t = nt.Morse(SFREQ, interpolate=True, device="cuda")
    n_time = mesh.size(mesh.mesh_dim_names.index("time"))
    lp = n // n_time                  # each time rank's block
    halo = pow2_halo(lp, lp // 2)
    rec = card(gen.standard_normal((c, n)))
    ch_bank = morse_bank(freqs, lp + 2 * halo, True)
    st_freqs = np.array([20.0, 40.0, 60.0, 80.0])
    ep = gen.standard_normal((20, 2, 256)).astype(np.float32)
    ep[::2, :, 128:] += np.sin(2 * np.pi * 30 * np.arange(128) / MESH_SF)
    ew = nt.EpochsWavelet(nt.ArrayEpochs(ep, MESH_SF, ["c0", "c1"]),
                          nt.Morse(MESH_SF, device="cuda"))
    ad_freqs = np.array([20.0, 30.0, 40.0])

    def chunk_ref(fn):
        """The time-split result's plain twin: the zero-padded recording cut
        into the extended chunks, each transformed whole."""
        pad = torch.nn.functional.pad(rec, (halo, halo))
        return torch.cat([fn(pad[..., i * lp:i * lp + lp + 2 * halo])
                          [..., halo:halo + lp] for i in range(n_time)], -1)

    def mt_ref():
        p = fused.mean_power_auto(x, mt_flat, interpolate=False)
        return p.reshape(c, f, 2, n).mean(-2)

    def sl_ref():
        return sum(superlets.superlet_power_from_banks(s, sl_banks, sl_w)
                   for s in x) / e

    def gc_ref():
        return granger._pairwise_assemble(
            granger._cross_spectra(x, gc_bank, 16, True), 8)

    ch = dict(mesh=mesh, halo=halo, interpolate=True)
    return stats + [
        ("sharded_mean_power", lambda: par.sharded_mean_power(
            x, bank, mesh=mesh), lambda: cwt.mean_power_from_bank(x, bank),
         POWER_RTOL),
        ("sharded_itc", lambda: par.sharded_itc(x, bank, mesh=mesh),
         lambda: cwt.itc_from_bank(x, bank), POWER_RTOL),
        ("sharded_cwt_ri", lambda: par.sharded_cwt_ri(x, bank, mesh=mesh),
         lambda: (lambda w: (w.real, w.imag))(cwt.cwt_from_bank(x, bank)),
         POWER_RTOL),
        ("sharded_power", lambda: par.sharded_power(x, cxb, mesh=mesh),
         lambda: cwt.power_from_bank(x, cxb), POWER_RTOL),
        ("sharded_fused_mean_power", lambda: par.sharded_fused_mean_power(
            x, bank_t, mesh=mesh),
         lambda: fused.fused_mean_power_from_bank(x, bank_t), POWER_RTOL),
        ("sharded_fused_itc", lambda: par.sharded_fused_itc(
            x, cxb, mesh=mesh, interpolate=False),
         lambda: fused.fused_itc_from_bank(x, cxb, False), POWER_RTOL),
        ("sharded_fused_power_itc", lambda: par.sharded_fused_power_itc(
            x, bank_t, mesh=mesh),
         lambda: fused.fused_power_itc_from_bank(x, bank_t), POWER_RTOL),
        ("sharded_mean_power_grad", lambda: par.sharded_mean_power_grad(
            x, bank, g, mesh=mesh),
         lambda: (cwt.mean_power_from_bank(x, bank),
                  *fused.mean_power_bwd(x, bank, False, g)), GRAD_RTOL),
        ("sharded_superlet_mean_power",
         lambda: par.sharded_superlet_mean_power(x, sl_banks, sl_w,
                                                 mesh=mesh), sl_ref,
         POWER_RTOL),
        ("sharded_multitaper_mean_power",
         lambda: par.sharded_multitaper_mean_power(x, mt_banks, mesh=mesh),
         mt_ref, POWER_RTOL),
        ("sharded_ssq_mean_power", lambda: par.sharded_ssq_mean_power(
            x, bank_t, freqs, mesh=mesh, sfreq=SFREQ, uniform_grid=hint),
         lambda: sst.ssq_mean_power_from_bank(x, bank_t, freqs, SFREQ, True,
                                              1e-6, hint), POWER_RTOL),
        ("sharded_reassigned_mean_power",
         lambda: par.sharded_reassigned_mean_power(
             x[:, :2], bank_t, freqs, mesh=mesh, sfreq=SFREQ),
         lambda: reassign.reassigned_mean_power(
             x[:, :2], bank_t, freqs, SFREQ, interpolate=True), POWER_RTOL),
        ("sharded_cross_power", lambda: par.sharded_cross_power(
            x, y, bank, mesh=mesh),
         lambda: ext.cross_power_from_bank(x, y, bank), POWER_RTOL),
        ("sharded_coherence", lambda: par.sharded_coherence(
            x, y, cxb, mesh=mesh),
         lambda: ext.epoch_coherence_from_bank(x, y, cxb), 1e-4),
        ("sharded_imcoh", lambda: par.sharded_imcoh(x, y, bank, mesh=mesh),
         lambda: ext.imcoh_from_bank(x, y, bank), 1e-4),
        ("sharded_fused_coherence", lambda: par.sharded_fused_coherence(
            x, y, bank_t, mesh=mesh),
         lambda: fused.fused_coherence(x, y, bank_t), 1e-4),
        ("sharded_phase_lag", lambda: par.sharded_phase_lag(
            x, y, bank, mesh=mesh, method="dwpli"),
         lambda: conn.phase_lag(x, y, bank, "dwpli"), 1e-4),
        ("sharded_fused_phase_lag", lambda: par.sharded_fused_phase_lag(
            x, y, bank_t, mesh=mesh),
         lambda: fused.fused_phase_lag(x, y, bank_t), 1e-4),
        ("sharded_ppc", lambda: par.sharded_ppc(x, y, bank, mesh=mesh),
         lambda: conn.ppc_from_bank(x, y, bank), 1e-4),
        ("sharded_plv", lambda: par.sharded_plv(x, y, bank, mesh=mesh),
         lambda: conn.plv_from_bank(x, y, bank), 1e-4),
        ("sharded_nm_plv", lambda: par.sharded_nm_plv(
            x, y, bank, bank, mesh=mesh, n=1, m=2),
         lambda: conn.nm_plv_from_bank(x, y, bank, bank, 1, 2), 1e-4),
        ("sharded_plv_matrix", lambda: par.sharded_plv_matrix(
            x, bank, mesh=mesh), lambda: conn.plv_matrix_from_bank(x, bank),
         1e-4),
        ("sharded_coherence_matrix", lambda: par.sharded_coherence_matrix(
            x, bank, mesh=mesh),
         lambda: conn.coherence_matrix_from_bank(x, bank), 1e-4),
        ("sharded_partial_coherence", lambda: par.sharded_partial_coherence(
            x, bank, mesh=mesh),
         lambda: conn.partial_coherence_from_bank(x, bank), 1e-4),
        ("sharded_psi_matrix", lambda: par.sharded_psi_matrix(
            x, bank_t, mesh=mesh, interpolate=True),
         lambda: conn.psi_matrix_from_bank(x, bank_t, True), 1e-4),
        ("sharded_pac", lambda: par.sharded_pac(x, bp, ba, mesh=mesh),
         lambda: conn.pac_mean_from_banks(x, bp, ba, False, "mvl", 18),
         1e-4),
        ("sharded_env_corr", lambda: par.sharded_env_corr(
            x, bank, mesh=mesh),
         lambda: envelope.env_corr_matrix_from_bank(x, bank), 1e-4),
        ("sharded_wavelet_granger", lambda: par.sharded_wavelet_granger(
            x, gc_bank, mesh=mesh, n_iter=8), gc_ref, 1e-3),
        ("sharded_modwt", lambda: par.sharded_modwt(x, mesh=mesh, level=4),
         lambda: dwt.modwt(x, level=4), POWER_RTOL),
        ("sharded_modwt denoise", lambda: par.sharded_modwt(
            x, mesh=mesh, denoise=True),
         lambda: dwt.modwt_denoise(x), POWER_RTOL),
        ("sharded_stockwell", lambda: par.sharded_stockwell(
            x, st_freqs, mesh=mesh, sfreq=SFREQ),
         lambda: (lambda s: (s.real, s.imag))(s_transform(
             x, st_freqs, SFREQ)), POWER_RTOL),
        ("distributed_mean_power", lambda: par.distributed_mean_power(
            x[:e - 1], morse_t, freqs, SFREQ, mesh=mesh),
         lambda: fused.mean_power_auto(x[:e - 1], bank_t, interpolate=True),
         POWER_RTOL),
        ("distributed_itc", lambda: par.distributed_itc(
            x, morse_t, freqs, SFREQ, mesh=mesh),
         lambda: fused.itc_auto(x, bank_t, interpolate=True), POWER_RTOL),
        ("chunked_power", lambda: par.chunked_power(rec, ch_bank, **ch),
         lambda: chunk_ref(lambda s: cwt.power_from_bank(s, ch_bank, True)),
         POWER_RTOL),
        ("chunked_abs", lambda: par.chunked_abs(rec, ch_bank, **ch),
         lambda: chunk_ref(lambda s: cwt.abs_from_bank(s, ch_bank, True)),
         POWER_RTOL),
        ("chunked_cwt_ri", lambda: par.chunked_cwt_ri(rec, ch_bank, **ch),
         lambda: (lambda w: (w.real, w.imag))(chunk_ref(
             lambda s: cwt.cwt_from_bank(s, ch_bank, True))), POWER_RTOL),
        ("chunked_fused_power", lambda: par.chunked_fused_power(
            rec, ch_bank, **ch),
         lambda: chunk_ref(lambda s: cwt.power_from_bank(s, ch_bank, True)),
         POWER_RTOL),
        ("chunked_power_auto", lambda: par.chunked_power_auto(
            rec, ch_bank, **ch),
         lambda: chunk_ref(lambda s: cwt.power_from_bank(s, ch_bank, True)),
         POWER_RTOL),
        ("EpochsWavelet.cluster_test(mesh=)", lambda: ew.cluster_test(
            "c0", ad_freqs, baseline=(0.0, 0.4), n_perm=MESH_PERMS, seed=5,
            mesh=mesh),
         lambda: ew.cluster_test("c0", ad_freqs, baseline=(0.0, 0.4),
                                 n_perm=MESH_PERMS, seed=5), "same"),
    ]


def run_mesh_cases(mesh, cases, compare):
    """Every rank calls each sharded function and gathers its result; where
    ``compare``, the single-device call and the check follow."""
    import torch
    for name, sharded, single, gate in cases:
        got = mesh_full(sharded())
        if compare:
            mesh_err(f"{name} on the {mesh_label(mesh)} mesh", got, single(),
                     gate)
        del got
        torch.cuda.empty_cache()


def mesh_label(mesh):
    return "x".join(str(s) for s in mesh.mesh.shape)


def sums_sweep():
    """The fused kernel's epoch-sums entry (``ninw_fused_cwt_sums``, behind
    ``ops.fused._itc_sums`` / ``_power_itc_sums``) against the plain sums at
    every N it takes, both ``interpolate`` settings, a real and a complex
    bank, E = 19, 3 channels, 13 rows: the power sums at 1e-5 of the max;
    the unit-phase sums at ITC's sound-cell gate times E where every
    epoch's |c| is at least 1e-2 of its row max (elsewhere the unit phase
    of a near-zero coefficient is round-off, in either path), the ITC they
    finish to under ``cx_itc_err``'s rules (the float64 witness); the
    "itc" epilogue's unit-phase sums at the same gates."""
    import torch
    from ninwavelets_tpu_torch.ops import fused
    gen = np.random.default_rng(18)
    freqs = np.linspace(5.0, 120.0, F_RAGGED)
    for log2n in range(8, 15):
        n = 1 << log2n
        x = torch.from_numpy(gen.standard_normal((E_RAGGED, 3, n),
                                                 dtype=np.float32)).cuda()
        for interp, bk in ((True, morse_bank(freqs, n, True)),
                           (False, morse_bank(freqs, n, False)),
                           (False, cx_bank("MexicanHat", freqs, n, False))):
            tag = (f"N={n} interpolate={interp} "
                   f"{'complex' if bk.is_complex() else 'real'} bank")
            ps, sr, si = fused._power_itc_sums(x, bk, interp)
            rp, rr, ri = (t.cuda() for t in fused._power_itc_sums(
                x.cpu(), bk.cpu(), interp))
            rel_err(f"K2 sums sum |W|^2, {tag}", ps, rp)
            wit = itc_witness(x, bk, interp)
            sound = "every epoch's |c| >= 1e-2 of its row max"
            for part, g, r in (("Re", sr, rr), ("Im", si, ri)):
                strong_err(f"K2 sums unit-phase {part}, {tag}", g, r, wit[1],
                           ITC_ATOL_STRONG * E_RAGGED, where=sound)
            cx_itc_err(f"K2 sums finished to ITC, {tag}",
                       torch.sqrt(sr * sr + si * si) / E_RAGGED,
                       torch.sqrt(rr * rr + ri * ri) / E_RAGGED, wit, interp,
                       rp / E_RAGGED)
            for part, g, r in zip(("Re", "Im"), fused._itc_sums(x, bk, interp),
                                  (rr, ri)):
                strong_err(f"K2 'itc' sums unit-phase {part}, {tag}", g, r,
                           wit[1], ITC_ATOL_STRONG * E_RAGGED, where=sound)


def nccl_world_one():
    """Part 1: an NCCL group of one rank in this process and a (1, 1, 1)
    mesh; every sharded, distributed and chunked function and the adapter's
    ``cluster_test(mesh=)`` at a small size against its single-device twin.
    Returns the launches of the run."""
    import datetime
    import torch.distributed as dist
    from ninwavelets_tpu_torch import kernels, parallel as par
    from ninwavelets_tpu_torch.parallel import collectives, mesh as pmesh
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{pmesh._free_port()}",
        rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        check(collectives.backend() == "nccl", "the world-1 group is not "
              "NCCL")
        mesh = par.make_mesh(1, 1, 1)
        kernels.reset_launches()
        run_mesh_cases(mesh, mesh_small_cases(mesh, "all"), True)
        counts = dict(kernels.launches)
    finally:
        dist.destroy_process_group()
    return counts


def mesh_serving_calls(x, a, b, bank, cxb, freqs, mesh):
    """The serving workload's sharded calls on ``mesh``, by name."""
    import ninwavelets_tpu_torch as nt
    from ninwavelets_tpu_torch import parallel as par
    morse = nt.Morse(SFREQ, interpolate=True, device="cuda")
    return {
        "sharded_fused_mean_power": lambda: par.sharded_fused_mean_power(
            x, bank, mesh=mesh),
        "sharded_fused_itc": lambda: par.sharded_fused_itc(
            x, bank, mesh=mesh),
        "sharded_fused_power_itc": lambda: par.sharded_fused_power_itc(
            x, bank, mesh=mesh),
        "sharded_fused_mean_power cx": lambda: par.sharded_fused_mean_power(
            x, cxb, mesh=mesh, interpolate=False),
        "sharded_fused_itc cx": lambda: par.sharded_fused_itc(
            x, cxb, mesh=mesh, interpolate=False),
        "sharded_fused_power_itc cx": lambda: par.sharded_fused_power_itc(
            x, cxb, mesh=mesh, interpolate=False),
        "distributed_mean_power": lambda: par.distributed_mean_power(
            x, morse, freqs, SFREQ, mesh=mesh),
        "distributed_itc": lambda: par.distributed_itc(
            x, morse, freqs, SFREQ, mesh=mesh),
        "sharded_fused_coherence": lambda: par.sharded_fused_coherence(
            a, b, bank, mesh=mesh),
        "sharded_fused_phase_lag": lambda: par.sharded_fused_phase_lag(
            a, b, bank, mesh=mesh),
    }


def mesh_serving_check(name, tag, out, x, a, b, bank, cxb, rows):
    """One rank's block of the serving call ``name`` against the
    single-device port (the kernels, on the same rows) at the smoke's
    gates."""
    import torch
    from ninwavelets_tpu_torch.ops import connectivity as conn
    from ninwavelets_tpu_torch.ops import extensions as ext
    from ninwavelets_tpu_torch.ops import fused
    cx = name.endswith(" cx")
    bk = (cxb if cx else bank)[rows]
    interp = not cx
    if "coherence" in name or "phase_lag" in name:
        if "coherence" in name:
            sums = fused.fused_coherence_sums(a, b, bk, True)
            strong_err(tag, out, ext.coherence_from_sums(*sums, E),
                       above(sums[2] * sums[3]), 1e-4)
        else:
            sums = fused.fused_phase_lag_sums(a, b, bk, True)
            strong_err(tag, out, conn.phase_lag_from_sums(sums, E, "wpli"),
                       above(sums[1]), 1e-4)
        return
    power, itc = fused.fused_power_itc_from_bank(x, bk, interp)
    if "power_itc" in name:
        rel_err(f"{tag} power", out[0], power)
        itc_err(f"{tag} itc", out[1], itc, power)
    elif "itc" in name:
        itc_err(tag, out, itc, power)
    else:
        rel_err(tag, out, power)
    del power, itc
    torch.cuda.empty_cache()


def multigpu_rank(mesh):
    """Part 2, one of four gloo ranks that share the card (``run_on_mesh``):
    the serving workload at full width on the (4, 1, 1) and (2, 2, 1)
    meshes and the long recording split over time on (1, 1, 4) (the main
    path, with its launches), then each rank's blocks against the
    single-device port, and the statistics and decoders at a small size.
    Returns, on rank 0, every rank's main-path launches and failures, the
    wall times, and the host-staged collective calls."""
    import torch
    import torch.distributed as dist
    from ninwavelets_tpu_torch import kernels, parallel as par
    from ninwavelets_tpu_torch.ops import cwt
    from ninwavelets_tpu_torch.parallel import collectives
    rank = dist.get_rank()
    data = np.random.default_rng(0).standard_normal((E, C, N),
                                                    dtype=np.float32)
    x = torch.from_numpy(data).cuda()
    a, b = x, pair_b(x)
    freqs = np.arange(1.0, F + 1.0)
    bank = morse_bank(freqs, N, True)
    cxb = cx_bank("MexicanHat", freqs, N, False)
    meshes = {"4x1x1": mesh, "2x2x1": par.make_mesh(2, 2, 1)}
    m_time = par.make_mesh(1, 1, 4)
    rec_freqs = np.linspace(2.0, 100.0, REC_F)
    rec = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (REC_C, 4 * REC_WINDOW), dtype=np.float32)).cuda()
    rec[0] += torch.sin(2 * math.pi * 60.0 * torch.arange(
        4 * REC_WINDOW, device="cuda") / SFREQ)
    rec_bank = morse_bank(rec_freqs, REC_EXT, True)

    # -- the main path: every rank's launches counted ---------------------------
    times, outs = {}, {}
    dist.barrier()
    kernels.reset_launches()
    for label, m in meshes.items():
        for name, fn in mesh_serving_calls(x, a, b, bank, cxb, freqs,
                                           m).items():
            for rep in range(2):      # the second call timed
                dist.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                dist.barrier()
                if rep:
                    times[f"{name} {label}"] = (time.perf_counter()
                                                - t0) * 1e3
            outs[(label, name)] = out
    for rep in range(2):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec_out = par.chunked_power_auto(rec, rec_bank, mesh=m_time,
                                         halo=REC_HALO, interpolate=True)
        torch.cuda.synchronize()
        dist.barrier()
    times["chunked_power_auto 1x1x4"] = (time.perf_counter() - t0) * 1e3
    counts = dict(kernels.launches)

    # -- each rank's blocks against the single-device port ----------------------
    for (label, name), out in outs.items():
        m = meshes[label]
        if m.get_local_rank("data"):
            continue        # the freq blocks are replicated over data
        f_loc = F // m.size(m.mesh_dim_names.index("freq"))
        lo = m.get_local_rank("freq") * f_loc
        local = (tuple(o.to_local() for o in out) if isinstance(out, tuple)
                 else out.to_local())
        mesh_serving_check(name, f"{name} on {label}, rows {lo}-"
                           f"{lo + f_loc - 1}", local, x, a, b, bank, cxb,
                           slice(lo, lo + f_loc))
    del outs
    torch.cuda.empty_cache()
    t_rank = m_time.get_local_rank("time")
    ext = torch.nn.functional.pad(rec, (REC_HALO, REC_HALO))[
        ..., t_rank * REC_WINDOW:t_rank * REC_WINDOW + REC_EXT]
    rel_err(f"chunked_power_auto on 1x1x4, time block {t_rank}",
            rec_out.to_local(), cwt.power_from_bank(ext, rec_bank, True)
            [..., REC_HALO:REC_HALO + REC_WINDOW])
    del ext, rec_out
    torch.cuda.empty_cache()

    # -- the statistics and decoders at a small size ------------------------------
    t0 = time.perf_counter()
    run_mesh_cases(mesh, mesh_small_cases(mesh, "stats"), rank == 0)
    run_mesh_cases(meshes["2x2x1"], [
        c for c in mesh_small_cases(meshes["2x2x1"], "stats")
        if c[0] == "sharded_tf_decode"], rank == 0)
    times["statistics and decoders, small"] = (time.perf_counter() - t0) * 1e3

    gathered = [None] * MESH_WORLD
    dist.all_gather_object(gathered, {"counts": counts,
                                      "failures": list(FAILURES),
                                      "staged": collectives.staged})
    return {"ranks": gathered, "times": times}


def multigpu_phase():
    """Slice 15: the multi-device layer (module docstring, 56-59)."""
    import torch
    from ninwavelets_tpu_torch import kernels, parallel as par
    t_phase = time.perf_counter()
    sums_sweep()
    counts = nccl_world_one()
    print(f"NCCL world 1: launches {counts}")
    for key in ("power", "itc_cx", "power_itc", "coherence", "phaselag",
                "power_each"):
        check(counts.get(key, 0) > 0, f"NCCL world 1: {key!r} never "
              "launched by the sharded functions")
    t_nccl = time.perf_counter() - t_phase
    torch.cuda.empty_cache()

    kernels.build()          # built already: the ranks only load the library
    t0 = time.perf_counter()
    run = par.run_on_mesh(multigpu_rank, (MESH_WORLD, 1, 1),
                          backend="gloo", device="cuda",
                          timeout=MESH_TIMEOUT_S)
    t_gloo = time.perf_counter() - t0
    for r, info in enumerate(run.result["ranks"]):
        print(f"gloo rank {r}: main-path launches {info['counts']}, "
              f"host-staged collective calls (collectives.staged) "
              f"{info['staged']}")
        for key in MESH_KERNELS:
            check(info["counts"].get(key, 0) > 0, f"gloo rank {r}: {key!r} "
                  "never launched on the main path")
        for msg in info["failures"]:
            check(False, f"gloo rank {r}: {msg}")
    print(f"multi-device phase {time.perf_counter() - t_phase} s (NCCL "
          f"world 1 {t_nccl} s, four gloo ranks {t_gloo} s, their spawn "
          f"included); wall times (ms, the second call, every rank between "
          f"two barriers) {json.dumps(run.result['times'])}; on "
          f"{card_line()}")


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
    torch.cuda.empty_cache()

    # -- slice 7: the rest of connectivity ------------------------------------
    connectivity_rest_phase(data)
    torch.cuda.empty_cache()

    # -- slice 8: directed and network connectivity, event-locked epochs -----
    directed_network_phase(data)
    torch.cuda.empty_cache()

    # -- slice 9: statistics ---------------------------------------------------
    statistics_phase(data)
    torch.cuda.empty_cache()

    # -- slice 10: the other transforms ----------------------------------------
    transforms_phase(data)
    torch.cuda.empty_cache()

    # -- slice 11: the decompositions -----------------------------------------
    decomposition_phase(data)
    torch.cuda.empty_cache()

    # -- slice 12: sensor-space preprocessing and decoding --------------------
    sensor_space_phase(data)
    torch.cuda.empty_cache()

    # -- slice 13: ERP, complexity, sleep, microstates, sim, sources ----------
    slice13_phase(data)
    torch.cuda.empty_cache()

    # -- slice 14: file formats, the pipeline config, the utilities ----------
    slice14_phase(data)
    torch.cuda.empty_cache()

    # -- slice 15: the multi-device layer ---------------------------------------
    multigpu_phase()
    torch.cuda.empty_cache()

    # -- the epoch reductions at N not a power of two ---------------------------
    records += czt_phase(data)
    torch.cuda.empty_cache()

    # -- "power_each" at N = 32768, the split kernel -----------------------------
    records.append(each_split_phase())
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
