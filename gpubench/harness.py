"""Runs one cell once: load its files by name, set up, warm up, measure a
closed loop for ``--seconds``, check the last call against the reference,
print the result line.

The cell's name finds its entry in ``BENCHMARK.json``, its file
``workloads/<cell>.json`` (the entry, the traffic, the warm-up calls and
the limits of the compared numbers) and its configuration's file
``configs/<config>.json``; the cell's ``entry`` finds
``entries/<entry>.py`` and ``costs/<entry>.py``; each metric that
``BENCHMARK.json`` lists for the cell finds ``metrics/<metric>.py``.

The loop has one client, a script that hands the program one container at
a time and waits for each result: a call starts when the container is
handed over and ends with ``torch.cuda.synchronize()`` once the result is
on the card.  The previous result is dropped before the next call, as a
script that saved it would.  With ``--trace 1`` the window runs under
``torch.profiler`` and the per-layer metrics are read from its trace;
otherwise the end-to-end metrics are reported.
"""
from __future__ import annotations

import argparse
import copy
import gc
import importlib
import json
import os
import subprocess
import sys
import time
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: Top-level module names that may not be loaded in a run's process.
FORBIDDEN = ("jax", "jaxlib", "flax", "ninwavelets_tpu")
_IMPORTED = time.perf_counter()


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def load_cell(name: str, overrides: Optional[dict] = None):
    """``(BENCHMARK.json, its workload entry, the cell's file, the
    configuration's file)``; ``overrides`` replaces keys of the cell's
    ``traffic`` and ``limits`` and, under ``config``, of the configuration
    (the tests' small sizes)."""
    bench = benchmark()
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = load_json(os.path.join(HERE, "workloads", name + ".json"))
    config = load_json(os.path.join(HERE, "configs",
                                    found[0]["config"] + ".json"))
    for key, value in copy.deepcopy(overrides or {}).items():
        if key == "config":
            config.update(value)
        else:
            cell[key] = {**cell[key], **value}
    return bench, found[0], cell, config


def metrics_for(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries a cell reports: its end-to-end ones, or with a
    trace its per-layer ones."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def metric_module(name: str):
    return importlib.import_module("gpubench.metrics." + name)


def make_entry(cell: dict, config: dict, seed: int, device):
    """The cell's entry object (``entries/<entry>.py``), its inputs made
    from ``seed``."""
    return importlib.import_module(
        "gpubench.entries." + cell["entry"]).Entry(config, cell, seed, device)


@dataclass
class Run:
    """What the metric readers read."""
    n_calls: int
    call_s: list
    window_s: float
    peak_bytes: int
    setup_s: float
    channel_seconds: float
    cost: dict
    trace: object = None


def process_age() -> float:
    """Seconds since this process started (``/proc``), or since this
    module was imported where ``/proc`` is missing."""
    try:
        with open("/proc/self/stat") as fh:
            start = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            up = float(fh.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


def card() -> dict:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.splitlines()[0]
        name, limit = (s.strip() for s in out.split(",", 1))
        return {"name": name, "power_limit": limit}
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return {"name": None, "power_limit": None}


def measure(name: str, seed: int, seconds: float, trace: bool = False,
            device: str = "cuda", overrides: Optional[dict] = None) -> dict:
    """One run of the cell ``name``; returns the result line's object.
    ``device`` and ``overrides`` (``load_cell``'s) serve the tests, which
    drive a run on the CPU at small sizes."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from . import compare
    from .trace import Trace

    marks = [("imports", process_age())]
    bench, _, cell, config = load_cell(name, overrides)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    if on_card:
        torch.empty(1, device=dev)
        marks.append(("context", process_age()))
    from ninwavelets_tpu_torch import kernels
    marks.append(("program", process_age()))
    entry = make_entry(cell, config, seed, dev)
    cost = importlib.import_module(
        "gpubench.costs." + cell["entry"]).cost(config, cell["traffic"])
    marks.append(("inputs", process_age()))

    warmup = int(cell["warmup_calls"])
    for i in range(warmup):
        entry.call(i)
        sync()
    setup_s = process_age()
    marks.append(("warm-up", setup_s))
    print("set-up, seconds since the process started: " + ", ".join(
        f"{k} {v:.2f}" for k, v in marks), file=sys.stderr)

    kernels.reset_launches()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    span = record_function if trace else (lambda name: nullcontext())
    prof = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            if trace else nullcontext())
    call_s = []
    i = warmup
    with prof, span("gpubench.window"):
        start = time.perf_counter()
        deadline = start + seconds
        while True:
            out = None
            t0 = time.perf_counter()
            with span("gpubench.call"):
                key, out = entry.call(i)
                sync()
            t1 = time.perf_counter()
            call_s.append(t1 - t0)
            i += 1
            if t1 >= deadline:
                break
    window_s = t1 - start
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    launches = {k: v for k, v in kernels.launches.items() if v}
    tr = Trace.from_profiler(prof) if trace else None

    entry.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checked = time.perf_counter()
    numbers = entry.numbers(key, out)
    del out
    checked = time.perf_counter() - checked
    checks = compare.judge(numbers, cell["limits"])
    correct = all(c["ok"] for c in checks.values())

    run = Run(len(call_s), call_s, window_s, peak, setup_s,
              entry.channel_seconds, cost, tr)
    metrics = {}
    for m in metrics_for(bench, name, trace):
        value = metric_module(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    info = {"platform": "gpu" if on_card else dev.type,
            "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
            "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(call_s),
              "failed": 0 if correct else 1, "metrics": metrics,
              "device": info}
    if tr is not None:
        info["busy_s"] = tr.busy_s()
        info["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps()}
        kinds = {c: sum(1 for d in tr.device if d[0] == c)
                 for c in ("kernel", "gpu_memcpy", "gpu_memset")}
        print(f"profiler: device activities in the trace {kinds}",
              file=sys.stderr)
    result["card"] = card() if on_card else {}
    result["launches"] = launches
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                        for k, c in checks.items()}
    print(f"the comparison with the reference took {checked:.1f} s",
          file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    return result


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m gpubench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache = os.path.join(ROOT, ".gpubench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    import torch
    chips = next((w["chips"] for w in benchmark()["workloads"]
                  if w["name"] == args.workload), None)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = measure(args.workload, args.seed, args.seconds,
                     bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"loaded in the run's process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
