"""A tool, not part of a run: medians and spreads of the result lines of
repeated runs, per metric:

    python3 -m gpubench.spread set1.jsonl [set2.jsonl ...]

Each file holds the result lines of one set of runs of one cell (other
lines are skipped).  For each file and metric it prints the median and the
spread (the quartiles' distance over the median, ``stats.spread``), and
the bound five times the widest spread of the sets would give.
"""
from __future__ import annotations

import json
import statistics
import sys

from .stats import spread


def read_set(path: str) -> list:
    lines = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line.startswith("{") and '"metrics"' in line:
                lines.append(json.loads(line))
    return lines


def summary(paths) -> dict:
    out = {}
    for path in paths:
        runs = read_set(path)
        for name in runs[0]["metrics"] if runs else ():
            values = [r["metrics"][name]["value"] for r in runs
                      if name in r["metrics"]]
            entry = out.setdefault(name, {"sets": []})
            entry["sets"].append({
                "file": path, "n": len(values),
                "median": statistics.median(values),
                "spread": spread(values) if len(values) >= 2 else None,
                "values": values})
    for entry in out.values():
        spreads = [s["spread"] for s in entry["sets"]
                   if s["spread"] is not None]
        entry["five_times_widest"] = 5 * max(spreads) if spreads else None
    return out


def main(argv=None) -> int:
    paths = (argv if argv is not None else sys.argv[1:])
    print(json.dumps(summary(paths), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
