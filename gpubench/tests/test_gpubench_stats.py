"""The arithmetic of the metrics on hand-made numbers and intervals."""
import math

import pytest

from gpubench import stats
from gpubench.harness import Run, metric_module
from gpubench.trace import Trace


def test_percentile_is_linear_between_ranks():
    xs = list(range(1, 21))               # 1..20
    assert stats.percentile(xs, 95) == pytest.approx(19.05)
    assert stats.percentile(xs, 50) == pytest.approx(10.5)
    assert stats.percentile([7.0], 95) == 7.0
    assert stats.percentile([3, 1, 2], 0) == 1


def test_spread_is_the_quartile_distance_over_the_median():
    xs = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, q2, q3 = 10.75, 12.5, 14.25       # statistics.quantiles, "exclusive"
    assert stats.spread(xs) == pytest.approx((q3 - q1) / q2)


def test_intervals_merge_clip_and_leave_gaps():
    iv = [(1, 2), (1.5, 3), (5, 6), (8, 12), (-1, 0.5)]
    assert stats.merge(iv, 0, 10) == [(0, 0.5), (1, 3), (5, 6), (8, 10)]
    assert stats.covered(iv, 0, 10) == pytest.approx(5.5)
    assert stats.gaps(iv, 0, 10) == [(0.5, 1), (3, 5), (6, 8)]
    assert stats.gaps([], 0, 4) == [(0, 4)]


def _events():
    """A 10 ms window, two calls; the device runs a 2 ms copy and a 3 ms
    kernel in the first, a 1 ms kernel and a 1 ms set in the second,
    overlapping it by half."""
    def ev(cat, name, ts, dur, tid=1):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "pid": 7 if cat.startswith(("cpu", "user")) else 0,
                "tid": tid}
    return [
        ev("user_annotation", "gpubench.window", 0, 10000),
        ev("user_annotation", "gpubench.call", 0, 5000),
        ev("cpu_op", "aten::copy_", 1000, 2000),
        ev("user_annotation", "gpubench.call", 5000, 5000),
        ev("cpu_op", "aten::other_thread", 0, 10000, tid=2),
        ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 1000, 2000),
        ev("kernel", "k_a", 3000, 3000),
        ev("kernel", "k_b", 7000, 1000),
        ev("gpu_memset", "Memset (Device)", 7500, 1000),
        ev("kernel", "outside", 20000, 1000),
    ]


def test_trace_busy_idle_and_breakdown():
    tr = Trace(_events())
    assert tr.window_s == pytest.approx(0.010)
    assert tr.busy_s() == pytest.approx(0.0065)      # 1-6 ms, 7-8.5 ms
    assert tr.seconds(("kernel",)) == pytest.approx(0.004)
    assert tr.seconds(("gpu_memcpy",), "HtoD") == pytest.approx(0.002)
    assert tr.device_ops()[0] == ["k_a", pytest.approx(0.003)]
    gaps = dict((n, s) for n, s in tr.idle_gaps())
    # 0-1 ms and 6-7 ms, 8.5-10 ms: the second call's span holds the last
    # two, the first call's span the first; the other thread is ignored.
    assert gaps == {"gpubench.call": pytest.approx(0.0035)}


def test_trace_needs_its_window_span():
    with pytest.raises(ValueError):
        Trace([e for e in _events() if e["name"] != "gpubench.window"])


def _run(trace=None):
    return Run(n_calls=4, call_s=[0.1, 0.2, 0.3, 0.4], window_s=1.0,
               peak_bytes=3 * 2 ** 30, setup_s=12.5, channel_seconds=100.0,
               cost={"flops": 67e12 * 0.001, "bytes": 0.0}, trace=trace)


def test_metric_readers():
    run = _run(Trace(_events()))
    read = {n: metric_module(n).read(run) for n in (
        "ch_seconds_per_s", "call_p95_ms", "peak_mem_GiB", "setup_s",
        "device_idle_pct", "h2d_ms_per_call", "cwt_roofline_pct")}
    assert read["ch_seconds_per_s"] == pytest.approx(400.0)
    assert read["call_p95_ms"] == pytest.approx(385.0)
    assert read["peak_mem_GiB"] == pytest.approx(3.0)
    assert read["setup_s"] == 12.5
    assert read["device_idle_pct"] == pytest.approx(35.0)
    assert read["h2d_ms_per_call"] == pytest.approx(0.5)
    # least time 1 ms a call over 4 ms / 4 calls of kernels
    assert read["cwt_roofline_pct"] == pytest.approx(100.0)


def test_readers_without_a_trace_read_nothing():
    run = _run()
    for n in ("device_idle_pct", "h2d_ms_per_call", "cwt_roofline_pct"):
        assert metric_module(n).read(run) is None
    run.peak_bytes = 0
    assert metric_module("peak_mem_GiB").read(run) is None


def test_judge_holds_each_number_to_its_limit():
    from gpubench.compare import judge
    out = judge({"a": 1e-6, "b": 2.0, "c": math.inf, "d": 0.0},
                {"a": 1e-5, "b": 1.0, "c": 1.0, "e": 1.0})
    assert [out[k]["ok"] for k in "abcde"] == [True, False, False, False,
                                                False]
    assert out["c"]["value"] is None


def test_a_traced_run_reads_the_profilers_own_trace():
    """On the CPU the profiler's trace holds the window span and no device
    activity: the per-layer readers read nothing, and the line still has
    its breakdown."""
    from conftest import SMALL
    from gpubench.harness import measure
    name = "eeg64_epochs.pow2_2048"
    r = measure(name, 11, 0.2, trace=True, device="cpu",
                overrides=SMALL[name])
    assert r["correct"] and r["metrics"] == {}
    assert r["device"]["busy_s"] == 0 and r["device"]["window_s"] > 0
    assert r["breakdown"]["device_ops"] == []
    assert r["breakdown"]["idle_gaps"][0][1] == pytest.approx(
        r["device"]["window_s"])
