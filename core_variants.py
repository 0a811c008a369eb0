#!/usr/bin/env python3
"""Time the kernels on the register-resident FFT core against variants of
themselves, and against another checkout's kernels, in one process on one
CUDA card.

    python3 core_variants.py                  # from the root of the repository
    python3 core_variants.py --parent DIR     # DIR: root of another checkout

Each variant is this checkout's ``ninwavelets_tpu_torch/csrc`` built with
one placement flag of ``Plan`` (``csrc/fft_regs.cuh``) switched off by its
macro: ``NINW_CORE_AHEAD=0`` (the next row's bins not loaded while the row
before is transformed) or ``NINW_CORE_PINGPONG=0`` (one exchange buffer,
two barriers an exchange).  ``--parent`` names the root of another
checkout, for example a ``git archive`` of the parent commit unpacked into
a git-ignored directory; its kernels take the radix-2 twiddle table, as the
parent's did.  Every library is built by ``kernels.build`` (the builds run
at once) and bound by ``kernels.open_library``; for each variant it
prints the core instantiations that spill at N <= 8192 (``ptxas -v``).

The epoch reductions ("power", "itc", "power_itc", real bank) and the
cross-pair sums ("coherence", "phaselag", "plv") are timed alone by CUDA
events (mean of 5 after a warm-up, ``chip_smoke.event_ms``) on the same
tensors, at 200 epochs x 64 channels x 2048 samples x 100 Morse rows
(``interpolate=True``: N/2 bins), in ROUNDS rounds, each library once a
round, in turn and in reverse order on alternate rounds.  For each kernel
it prints every library's median and quartiles and, against the core,
how many rounds each other library lost.  Prints the card's name and
power limit first and a JSON object of every time last.  Needs a CUDA
card and ``nvcc``; exits 2 without CUDA.
"""
import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
VARIANTS = {"core": (), "no_ahead": ("NINW_CORE_AHEAD=0",),
            "no_pingpong": ("NINW_CORE_PINGPONG=0",)}
ROUNDS = 10


def main() -> int:
    import torch
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", help="root of another checkout to time")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("core_variants: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from ninwavelets_tpu_torch import kernels

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    builds = {name: {"defines": d} for name, d in VARIANTS.items()}
    if args.parent:
        builds["parent"] = {"csrc": os.path.join(
            os.path.abspath(args.parent), "ninwavelets_tpu_torch", "csrc")}
    with ThreadPoolExecutor(len(builds)) as pool:
        paths = dict(zip(builds, pool.map(lambda kw: kernels.build(**kw),
                                          builds.values())))
    libs = {name: kernels.open_library(path, ("ninw_fused_cwt",
                                              "ninw_fused_pair"))
            for name, path in paths.items()}
    for name in VARIANTS:
        with contextlib.redirect_stdout(io.StringIO()):
            spilling = cs.print_ptxas(paths[name])
        print(f"build {name}: core instantiations that spill at N <= 8192: "
              f"{', '.join(spilling) or 'none'}")

    e, c, n, f = cs.E, cs.C, cs.N, cs.F
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (e, c, n), dtype=np.float32)).cuda()
    bank = cs.morse_bank(np.arange(1.0, f + 1.0), n, True)
    spec_a = torch.fft.rfft(x).contiguous()
    spec_b = torch.fft.rfft(torch.roll(x, 1, 1)).contiguous()
    tables = {"core": kernels._core_twiddles(n, x.device),
              "parent": kernels._twiddles(n, x.device)}
    out = torch.empty((4, c, f, n), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def call(name, kind, code):
        tw = tables["parent" if name == "parent" else "core"]
        if kind == "cwt":
            return lambda: libs[name].ninw_fused_cwt(
                code, spec_a.data_ptr(), bank.data_ptr(), tw.data_ptr(),
                out[0].data_ptr(), out[1].data_ptr(), e, c, f, n, n // 2,
                n // 2 + 1, 0, stream)
        return lambda: libs[name].ninw_fused_pair(
            code, spec_a.data_ptr(), spec_b.data_ptr(), bank.data_ptr(),
            tw.data_ptr(), out.data_ptr(), e, c, f, n, n // 2, n // 2 + 1,
            stream)

    order = list(libs)
    times = {}
    for kind, epilogues in (("cwt", ("power", "itc", "power_itc")),
                            ("pair", tuple(kernels.PAIR_EPILOGUES))):
        for epi in epilogues:
            code = (kernels.EPILOGUES if kind == "cwt"
                    else kernels.PAIR_EPILOGUES)[epi]
            row = {name: [] for name in order}
            for rnd in range(ROUNDS):
                for name in order if rnd % 2 == 0 else order[::-1]:
                    fn = call(name, kind, code)
                    if fn() != 0:
                        raise RuntimeError(f"{name} {kind}[{epi}] launch failed")
                    row[name].append(cs.event_ms(fn))
            times[f"{kind}[{epi}]"] = row
            for name, ms in row.items():
                q1, med, q3 = np.percentile(ms, [25, 50, 75])
                slower = sum(m > ref for m, ref in zip(ms, row["core"]))
                print(f"time {kind}[{epi}] (E={e} C={c} N={n} F={f}) {name}: "
                      f"median {med} ms, quartiles {q1} {q3}; slower than "
                      f"the core in {slower} of {ROUNDS} rounds", flush=True)
    print(json.dumps({"times_ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
