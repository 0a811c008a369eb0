#!/usr/bin/env python3
"""Time the kernels on the register-resident FFT core against variants of
themselves, and against another checkout's kernels, in one process on one
CUDA card.

    python3 core_variants.py                  # from the root of the repository
    python3 core_variants.py --parent DIR     # DIR: root of another checkout

Each variant is this checkout's ``ninwavelets_tpu_torch/csrc`` built with
one build-time switch, both placement flags of ``Plan``
(``csrc/fft_regs.cuh``): ``NINW_CORE_AHEAD=0`` (the next row's bins not
loaded while the row before is transformed) and ``NINW_CORE_PINGPONG=0``
(one exchange buffer, two barriers an exchange).  A variant is timed only
on the kernels whose code its switch changes at the shapes timed here
(``VARIANTS``): both flags act only to N = 4096, so neither changes
"power_each" or the recording batch of "amax" and synchrosqueezing at
16384, and the backward, "amax" and synchrosqueezing load no bins ahead.
``--parent`` names the root of another checkout, for example a ``git
archive`` of the parent commit unpacked into a git-ignored directory; it
is timed on every kernel.  Its "amax" and synchrosqueezing kernels take
the N/2 radix-2 twiddle table (``radix2_twiddles``, this script's own copy
of the helper the package had) where its ``csrc`` still holds
``radix2.cuh`` (they ran on radix-2 passes up to commit 1904d03), and
every other kernel takes the core's table.  Every library is
built by ``kernels.build`` (the builds run at once) and bound by
``kernels.open_library``; for each variant it prints the instantiations
that spill where ``chip_smoke.print_ptxas`` allows none.

Each kernel is timed alone by CUDA events (mean of 5 after a warm-up,
``chip_smoke.event_ms``) on the same tensors, in ROUNDS rounds, each
library that times it once a round, in turn and in reverse order on
alternate rounds: the epoch reductions ("power", "itc", "power_itc",
real bank), the cross-pair sums ("coherence", "phaselag", "plv"), the
noise gate's peaks ("amax", K5a) and synchrosqueezing (K5b, "lin" rows
1-100 Hz, floors 1e-6 of the peaks), each of the last two with its
output's zero-fill, at 200 epochs x 64 channels x 2048 samples x 100
Morse rows, the backward (K3, real Morse and complex MexicanHat bank) at
64 x 64 x 2048 x 100, alone and with the sums of its partials that
``ops.fused._fused_power_bwd`` runs after it (t over row groups, dbank
over channels), all with ``interpolate=True`` (N/2 bins), and
"power_each" (K4, whole windows), "amax" and synchrosqueezing ("lin"
rows 2-101 Hz) at the long recording's 512 signals x 16384 samples x 100
rows. For each kernel it prints every library's median and quartiles
and, against the core, how many rounds each other library lost. Prints
the card's name and power limit first and a JSON object of every time
last. Needs a CUDA card and ``nvcc``; exits 2 without CUDA.
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
#: Each build of this checkout: its defines and the kernels it is timed on.
VARIANTS = {"core": ((), ("cwt", "pair", "bwd", "each", "ssq", "ssq_rec")),
            "no_ahead": (("NINW_CORE_AHEAD=0",), ("cwt", "pair")),
            "no_pingpong": (("NINW_CORE_PINGPONG=0",),
                            ("cwt", "pair", "bwd", "ssq"))}
ROUNDS = 10


def radix2_twiddles(n: int, device):
    """exp(+2 pi i m / n) for m < n/2, computed in float64, stored complex64:
    the table of the radix-2 passes that "amax" and synchrosqueezing ran on
    before they moved to the core."""
    import torch
    m = np.arange(n // 2, dtype=np.float64)
    return torch.from_numpy(np.exp(2j * np.pi * m / n).astype(
        np.complex64)).to(device)


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
    from ninwavelets_tpu_torch.ops import sst

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    builds = {name: {"defines": d} for name, (d, _) in VARIANTS.items()}
    timed = {name: kinds for name, (_, kinds) in VARIANTS.items()}
    parent_radix2 = False
    if args.parent:
        timed["parent"] = VARIANTS["core"][1]
        builds["parent"] = {"csrc": os.path.join(
            os.path.abspath(args.parent), "ninwavelets_tpu_torch", "csrc")}
        parent_radix2 = os.path.exists(os.path.join(builds["parent"]["csrc"],
                                                    "radix2.cuh"))
        print(f"parent {args.parent}: amax and synchrosqueezing on "
              f"{'radix-2 passes' if parent_radix2 else 'the core'}")
    with ThreadPoolExecutor(len(builds)) as pool:
        paths = dict(zip(builds, pool.map(lambda kw: kernels.build(**kw),
                                          builds.values())))
    libs = {name: kernels.open_library(path, (
        "ninw_fused_cwt", "ninw_fused_pair", "ninw_fused_cwt_bwd",
        "ninw_fused_cwt_bwd_rows", "ninw_fused_power_each", "ninw_fused_ssq"))
        for name, path in paths.items()}
    for name in VARIANTS:
        with contextlib.redirect_stdout(io.StringIO()):
            spilling = cs.print_ptxas(paths[name])
        print(f"build {name}: instantiations that spill where none may: "
              f"{', '.join(spilling) or 'none'}")

    e, c, n, f = cs.E, cs.C, cs.N, cs.F
    gen = np.random.default_rng(0)
    x = torch.from_numpy(gen.standard_normal((e, c, n),
                                             dtype=np.float32)).cuda()
    freqs = np.arange(1.0, f + 1.0)
    bank = cs.morse_bank(freqs, n, True)
    spec_a = torch.fft.rfft(x).contiguous()
    spec_b = torch.fft.rfft(torch.roll(x, 1, 1)).contiguous()
    out = torch.empty((4, c, f, n), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    core_tw = {m: kernels._core_twiddles(m, x.device) for m in (n, cs.REC_EXT)}
    radix2_tw = {m: radix2_twiddles(m, x.device) for m in (n, cs.REC_EXT)}

    def table(name, m, ssq_kernel=False):
        """The twiddle table for library ``name`` at N = ``m``; ssq_kernel:
        for an "amax" or synchrosqueezing launch."""
        return (radix2_tw if name == "parent" and parent_radix2
                and ssq_kernel else core_tw)[m].data_ptr()

    def reduction(name, code):
        return lambda: libs[name].ninw_fused_cwt(
            code, spec_a.data_ptr(), bank.data_ptr(), table(name, n),
            out[0].data_ptr(), out[1].data_ptr(), e, c, f, n, n // 2,
            n // 2 + 1, 0, stream)

    def pair(name, code):
        return lambda: libs[name].ninw_fused_pair(
            code, spec_a.data_ptr(), spec_b.data_ptr(), bank.data_ptr(),
            table(name, n), out.data_ptr(), e, c, f, n, n // 2,
            n // 2 + 1, stream)

    # K3 at the training shape, each library's own t partials.
    e_grad = cs.E_GRAD
    spec_g = spec_a[:e_grad].contiguous()
    g = torch.from_numpy(gen.standard_normal((c, f, n),
                                             dtype=np.float32)).cuda()
    bwd_banks = {"real": bank,
                 "cx": cs.cx_bank("MexicanHat", freqs, n, True)}
    bwd_out = {}
    for name in libs:
        for kind, b in bwd_banks.items():
            rows = libs[name].ninw_fused_cwt_bwd_rows(n, int(kind == "cx"))
            bwd_out[name, kind] = (
                torch.empty((c, f, n // 2), dtype=b.dtype, device="cuda"),
                torch.empty((-(-f // rows), e_grad, c, n // 2),
                            dtype=torch.complex64, device="cuda"))

    def backward(name, kind, sums=False):
        dbank, t_part = bwd_out[name, kind]

        def run():
            err = libs[name].ninw_fused_cwt_bwd(
                spec_g.data_ptr(), bwd_banks[kind].data_ptr(), g.data_ptr(),
                table(name, n), dbank.data_ptr(), t_part.data_ptr(),
                e_grad, c, f, n, n // 2, n // 2 + 1, int(kind == "cx"),
                stream)
            if sums:
                dbank.sum(0)
                t_part.sum(0)
            return err
        return run

    # K4 at one window batch of the long recording, whole windows.
    ext, b_rec, f_rec = cs.REC_EXT, cs.REC_BATCH * cs.REC_C, cs.REC_F
    spec_rec = torch.fft.rfft(torch.from_numpy(gen.standard_normal(
        (b_rec, 1, ext), dtype=np.float32)).cuda()).contiguous()
    bank_rec = cs.morse_bank(np.linspace(2.0, 100.0, f_rec), ext, True)
    each_out = torch.empty((b_rec, f_rec, ext), device="cuda")

    def each(name):
        return lambda: libs[name].ninw_fused_power_each(
            spec_rec.data_ptr(), bank_rec.data_ptr(), table(name, ext),
            each_out.data_ptr(), b_rec, f_rec, ext, ext // 2, ext // 2 + 1,
            *kernels.each_layout(each_out.view(b_rec, 1, f_rec, ext), b_rec,
                                 f_rec, (0, ext)), stream)

    # K5a and K5b at the serving shape ("lin" rows 1-100 Hz) and on one
    # recording batch laid out as the streaming path lays it, (1, 512, 16384).
    rec_freqs = np.arange(2.0, 2.0 + f_rec)
    ssq_bank_rec = cs.morse_bank(rec_freqs, ext, True)
    peaks = kernels.fused_cwt("amax", spec_a, bank, n // 2, "fast3")[0]
    peaks_rec = kernels.fused_cwt("amax", spec_rec.view(1, b_rec, -1),
                                  ssq_bank_rec, ext // 2, "fast3")[0]
    ssq_cases = {
        "ssq": (spec_a, bank, e, c, n, (1e-6 * peaks.amax(1)).contiguous(),
                sst.uniform_grid_hint(np.float32(freqs)), peaks, out[0]),
        "ssq_rec": (spec_rec, ssq_bank_rec, 1, b_rec, ext,
                    (1e-6 * peaks_rec.amax(1)).contiguous(),
                    sst.uniform_grid_hint(np.float32(rec_freqs)), peaks_rec,
                    each_out)}

    def amax(name, case):
        sp, bk, e_, c_, m, _, _, dst, _ = ssq_cases[case]

        def run():
            dst.zero_()
            return libs[name].ninw_fused_cwt(
                kernels.EPILOGUES["amax"], sp.data_ptr(), bk.data_ptr(),
                table(name, m, ssq_kernel=True), dst.data_ptr(), None, e_,
                c_, bk.shape[0], m, m // 2, m // 2 + 1, 0, stream)
        return run

    def ssq(name, case):
        sp, bk, e_, c_, m, floors, hint, _, dst = ssq_cases[case]

        def run():
            dst.zero_()
            return libs[name].ninw_fused_ssq(
                sp.data_ptr(), bk.data_ptr(), table(name, m, ssq_kernel=True),
                floors.data_ptr(), dst.data_ptr(), e_, c_, bk.shape[0], m,
                m // 2 + 1, 0, 2.0 * np.pi * cs.SFREQ / m, hint[1], hint[2],
                stream)
        return run

    rows = {f"cwt[{epi}]": ("cwt", lambda name, epi=epi: reduction(
                name, kernels.EPILOGUES[epi]))
            for epi in ("power", "itc", "power_itc")}
    rows.update({f"pair[{epi}]": ("pair", lambda name, code=code: pair(
                     name, code))
                 for epi, code in kernels.PAIR_EPILOGUES.items()})
    for kind in ("real", "cx"):
        key = "bwd" if kind == "real" else "bwd_cx"
        rows[f"{key}[power]"] = ("bwd", lambda name, kind=kind: backward(
            name, kind))
        rows[f"{key}[power]+sums"] = ("bwd", lambda name, kind=kind:
                                      backward(name, kind, True))
    rows["each[power_each]"] = ("each", each)
    for case in ("ssq", "ssq_rec"):
        rows[f"{case}:cwt[amax]"] = (case, lambda name, case=case: amax(
            name, case))
        rows[f"{case}:ssq"] = (case, lambda name, case=case: ssq(name, case))

    times = {}
    for key, (kind, make) in rows.items():
        order = [name for name in libs if kind in timed[name]]
        row = {name: [] for name in order}
        for rnd in range(ROUNDS):
            for name in order if rnd % 2 == 0 else order[::-1]:
                fn = make(name)
                if fn() != 0:
                    raise RuntimeError(f"{name} {key} launch failed")
                row[name].append(cs.event_ms(fn))
        times[key] = row
        for name, ms in row.items():
            q1, med, q3 = np.percentile(ms, [25, 50, 75])
            slower = sum(m > ref for m, ref in zip(ms, row["core"]))
            print(f"time {key} {name}: median {med} ms, quartiles {q1} "
                  f"{q3}; slower than the core in {slower} of {ROUNDS} "
                  f"rounds", flush=True)
    print(json.dumps({"times_ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
