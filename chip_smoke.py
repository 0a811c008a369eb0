#!/usr/bin/env python3
"""Drive the PyTorch port (``ninwavelets_tpu_torch``) once on one CUDA card.

    python3 chip_smoke.py          # from the root of the repository

What it does, failing (non-zero exit, no result line) if any check fails:

1. Requires CUDA and prints the card's name and power limit (nvidia-smi).
2. Builds the fused CWT kernel (``csrc/fused_cwt.cu``) with nvcc for sm_90a.
3. Drives the main path through the public entry points at the headline
   workload, 64 channels x 200 epochs x 2048 samples at 1 kHz, 100 Morse
   frequencies (1-100 Hz): ``EpochsWavelet.power_all`` with a (0, 0.2) s
   z-score baseline, ``itc_all`` and ``power_itc_all`` on
   ``Morse(interpolate=True)``; ``power_all`` on the default Morse
   (``interpolate=False``); ``itc_all`` on a ragged 19 epochs.  The launch
   counters are zeroed just before and read just after; every epilogue must
   have launched.
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

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""
import json
import os
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


class SmokeFailure(Exception):
    pass


FAILURES = []


def check(cond, msg):
    """Record a failed check; ``main`` fails after every check has run."""
    if not cond:
        print(f"FAILED: {msg}")
        FAILURES.append(msg)


def power_err(name, got, ref):
    """max|d|, failing when max|d| / max|ref| > POWER_RTOL."""
    check(got.shape == ref.shape, f"{name}: shape {tuple(got.shape)} != "
          f"{tuple(ref.shape)}")
    check(bool(got.isfinite().all()), f"{name}: non-finite values")
    err = (got - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    print(f"check {name}: max|d| {err} rel {rel} (gate {POWER_RTOL})")
    check(rel <= POWER_RTOL, f"{name}: rel err {rel} > {POWER_RTOL}")
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
    with open(lib[:-3] + ".log") as fh:
        for line in fh:
            if "registers" in line or "spill" in line:
                print("ptxas", line.strip())

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
    for epilogue, count in counts.items():
        check(count > 0, f"epilogue {epilogue!r} never launched on the "
              "main path")

    # -- kernel vs plain path, same tensors ---------------------------------
    x, bank = ew._all_data(), morse.fft_wavelets
    ref_power = cwt.mean_power_from_bank(x, bank, True)
    ref_itc = cwt.itc_from_bank(x, bank, True)
    err = {"power": power_err(
        "power kernel alone", fused.fused_mean_power_from_bank(x, bank, True),
        ref_power)}
    baselined_err("power_all baselined", power_bl, ref_power)
    err["itc"] = itc_err("itc_all", itc, ref_itc, ref_power)
    err["power_itc"] = max(
        power_err("power_itc_all power", pi_power, ref_power),
        itc_err("power_itc_all itc", pi_itc, ref_itc, ref_power))
    del ref_itc
    xf, bank_f = ew_full._all_data(), morse_full.fft_wavelets
    err["power"] = max(err["power"], power_err(
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
        records.append({"name": f"fused_cwt[{epilogue}]", "route": "cuda",
                        "source": KERNEL_SOURCE, "replaces": REPLACES,
                        "launches": counts[epilogue],
                        "max_abs_err": err[epilogue], "ms": ms,
                        "plain_ms": plain_ms})
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
