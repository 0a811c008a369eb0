"""A tool, not part of a run: the readings that the limits of ``correct``
are set from, in one process:

    python3 -m gpubench.calibrate --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 [--seconds 2] [--out result.json]

For each of ``--seeds`` it makes a short run of the cell (set-up, warm-up,
``--seconds`` of the closed loop, the comparison of the last call); for
each of ``--control-seeds`` it makes the cell's inputs and judges the
bfloat16 reference in the program's place, on the first input.  It prints
one JSON object: every reading, and for each compared number the largest
that the program gave (the lower reading) and the smallest that the
control gave (the upper).
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
from typing import Optional

from . import compare
from .harness import load_cell, make_entry, measure


def control(name: str, seed: int, device: str = "cuda",
            overrides: Optional[dict] = None) -> dict:
    """``compare.judge``'s checks of the control on the inputs of ``seed``:
    the reference in bfloat16 in the program's place."""
    import torch
    _, _, cell, config = load_cell(name, overrides)
    entry = make_entry(cell, config, seed, torch.device(device))
    entry.release()
    gc.collect()
    out = entry.control(0)
    return compare.judge(entry.numbers(0, out), cell["limits"])


def readings(cell: str, seeds, control_seeds, seconds: float) -> dict:
    rows = []
    for seed in seeds:
        r = measure(cell, seed, seconds)
        rows.append({"output": "program", "seed": seed,
                     "attempted": r["attempted"],
                     "numbers": {k: c["value"]
                                 for k, c in r["checks"].items()}})
    for seed in control_seeds:
        checks = control(cell, seed)
        rows.append({"output": "control", "seed": seed,
                     "numbers": {k: c["value"] for k, c in checks.items()}})
    summary = {}
    for name in rows[0]["numbers"]:
        def values(kind):
            return [r["numbers"][name] for r in rows if r["output"] == kind]
        prog, ctrl = values("program"), values("control")
        summary[name] = {
            "program_max": max(prog, key=_inf) if prog else None,
            "control_min": min(ctrl, key=_inf) if ctrl else None}
    return {"workload": cell, "readings": rows, "summary": summary}


def _inf(v):
    return float("inf") if v is None else v


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m gpubench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctrl = [int(s) for s in args.control_seeds.split(",") if s]
    result = readings(args.workload, seeds, ctrl, args.seconds)
    text = json.dumps(result)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    print(json.dumps(result["summary"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
