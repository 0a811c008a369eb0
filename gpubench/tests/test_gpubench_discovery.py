"""Every configuration, cell, entry, cost count and metric that
``BENCHMARK.json`` names is found by its name, and the file keeps to the
benchmark's contract in the shapes a test can see."""
import importlib
import json
import os
import re

import pytest

from gpubench.harness import ROOT, load_cell, metric_module, metrics_for

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gpubench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(c["name"]) and LINE.match(c["source"])
    assert c["file"] == f"gpubench/configs/{c['name']}.json"
    data = json.load(open(os.path.join(ROOT, c["file"])))
    assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
    assert data["source"] == c["source"]
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cells_find_their_files(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["name"] == f"{w['config']}.{w['traffic']}"
    assert w["chips"] in (1, 4) and LINE.match(w["why"])
    _, _, cell, config = load_cell(w["name"])
    assert cell["config"] == w["config"] == config["name"]
    entry = importlib.import_module("gpubench.entries." + cell["entry"])
    cost = importlib.import_module("gpubench.costs." + cell["entry"])
    assert hasattr(entry, "Entry") and callable(cost.cost)
    assert set(cell["limits"]) and all(v > 0 for v in
                                       cell["limits"].values())
    assert metrics_for(BENCH, w["name"], False)
    assert metrics_for(BENCH, w["name"], True)


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metrics_find_their_readers(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert callable(metric_module(m["name"]).read)
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", [])) <= cells
    if m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] == "device_trace" and LINE.match(m["layer"])
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_every_cell_reports_setup_and_another_end_to_end_metric():
    for w in BENCH["workloads"]:
        names = {m["name"] for m in metrics_for(BENCH, w["name"], False)}
        assert "setup_s" in names and len(names) >= 2
