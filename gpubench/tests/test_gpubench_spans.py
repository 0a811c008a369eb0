"""The readers of the program's own spans (``gpubench/spans.py``): on
hand-made events, on the profiler's own trace of a small run on the CPU,
and (marked ``card``) in the result line of a traced run on the card."""
import json
import subprocess
import sys

import pytest

from conftest import ROOT, SMALL
from gpubench import spans
from gpubench.harness import Run, benchmark, measure, metric_module, \
    metrics_for
from gpubench.trace import Trace

#: The span each metric of this file reads.
READS = {"snapshot_ms_per_call": "ninw.adapter.snapshot",
         "stream_wait_ms_per_call": "ninw.stream.wait",
         "bank_build_ms_per_call": "ninw.bank.build"}


def _events(program=True):
    """A 10 ms window of two calls: a 3 ms snapshot that starts 1 ms before
    the window, a 2 ms one inside it, a stream wait on another thread; the
    device runs one kernel."""
    def ev(cat, name, ts, dur, tid=1):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "pid": 7 if cat.startswith(("cpu", "user")) else 0,
                "tid": tid}
    events = [ev("user_annotation", "gpubench.window", 1000, 10000),
              ev("user_annotation", "gpubench.call", 1000, 5000),
              ev("user_annotation", "gpubench.call", 6000, 5000),
              ev("kernel", "k", 4000, 1000)]
    if program:
        events += [
            ev("user_annotation", "ninw.adapter.snapshot", 0, 3000),
            ev("user_annotation", "ninw.adapter.snapshot", 6500, 2000),
            ev("user_annotation", "ninw.stream.wait", 2000, 500, tid=2),
            ev("user_annotation", "ninw.transform.kernel:power_itc", 8500,
               1000)]
    return events


def _run(trace):
    return Run(n_calls=2, call_s=[0.005, 0.005], window_s=0.01,
               peak_bytes=0, setup_s=1.0, channel_seconds=1.0, cost={},
               trace=trace)


def test_spans_are_clipped_to_the_window_and_summed_by_name():
    tr = Trace(_events())
    # 2 ms of the first snapshot lie in the window, and the second whole.
    assert spans.seconds(tr, "ninw.adapter.snapshot") == pytest.approx(0.004)
    run = _run(tr)
    assert metric_module("snapshot_ms_per_call").read(run) == \
        pytest.approx(2.0)


def test_absent_work_reads_zero():
    """The program recorded spans, but none of these: the work was not done
    (the wait's only span is on another thread)."""
    run = _run(Trace(_events()))
    assert metric_module("stream_wait_ms_per_call").read(run) == 0.0
    assert metric_module("bank_build_ms_per_call").read(run) == 0.0


def test_a_program_without_spans_or_a_run_without_a_trace_reads_nothing():
    tr = Trace(_events(program=False))
    assert spans.seconds(tr, "ninw.adapter.snapshot") is None
    for name in READS:
        assert metric_module(name).read(_run(tr)) is None
        assert metric_module(name).read(_run(None)) is None
    no_device = Trace([e for e in _events() if e["cat"] != "kernel"])
    assert spans.seconds(no_device, "ninw.adapter.snapshot") > 0
    assert metric_module("snapshot_ms_per_call").read(_run(no_device)) \
        is None


@pytest.mark.parametrize("name", sorted(SMALL))
def test_a_small_traced_run_holds_the_spans_each_cell_lists(monkeypatch,
                                                            name):
    """The profiler's own trace of a small CPU run holds, on the window's
    thread, the spans that each new metric the cell lists reads.  The
    result line leaves them out on the CPU, as every reader of the device
    trace does where the trace holds no device activity."""
    kept = []
    made = Trace.from_profiler.__func__

    def keep(cls, prof):
        kept.append(made(cls, prof))
        return kept[-1]

    monkeypatch.setattr(Trace, "from_profiler", classmethod(keep))
    r = measure(name, 13, 0.2, trace=True, device="cpu",
                overrides=SMALL[name])
    assert r["correct"] and not set(r["metrics"]) & set(READS)
    tr, = kept
    listed = [m["name"] for m in metrics_for(benchmark(), name, True)
              if m["name"] in READS]
    assert "snapshot_ms_per_call" in listed
    if name.startswith("eeg64_recording"):
        assert set(listed) == set(READS)
    for metric in listed:
        assert spans.seconds(tr, READS[metric]) > 0, metric
    # The epochs cell's kernel would take its batch on a card; the
    # recording's extended window, 32768, is past the kernel's range.
    route = {n for _, _, n in tr.host if n.startswith("ninw.transform.")}
    assert route == {"ninw.transform.plain:" + (
        "cpu" if name.startswith("eeg64_epochs") else "n_range")}


@pytest.mark.card
@pytest.mark.parametrize("cell,kernels", [
    ("eeg64_epochs.pow2_2048", {"power_itc"}),
    ("eeg64_recording.default_window", set())])
def test_a_traced_run_on_the_card_reports_the_span_metrics(card, cell,
                                                           kernels):
    r = subprocess.run([sys.executable, "-m", "gpubench.run", "--workload",
                        cell, "--seed", str(2 ** 31 + 5), "--seconds", "2",
                        "--trace", "1"], cwd=ROOT, capture_output=True,
                       text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.splitlines()[-1])
    assert line["correct"]
    listed = {m["name"] for m in metrics_for(benchmark(), cell, True)}
    assert set(line["metrics"]) == listed
    for name in listed & set(READS):
        assert line["metrics"][name]["value"] >= 0
    assert set(line["launches"]) == kernels
