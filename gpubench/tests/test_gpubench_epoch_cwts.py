"""The cell ``eeg64_mne_epochs.mne_2001``, its entry
``epochs_mean_power_itc`` and its per-layer metric ``epoch_cwts_per_call``:
the reader on hand-made events, the entry's reference, and small runs of
the cell on the CPU (epochs of 2001 samples, which the fused kernels
refuse, so the plain epoch route runs), with the control and planted
faults, which have to read ``correct: false``."""
import numpy as np
import pytest
import torch

from ninwavelets_tpu_torch.utils import mne_adapter

from gpubench.calibrate import control
from gpubench.harness import Run, benchmark, load_cell, make_entry, \
    measure, metric_module, metrics_for
from gpubench.reference import Precision, epochs_planes
from gpubench.reference.epoch_power import epochs_power_planes
from gpubench.trace import Trace

CELL = "eeg64_mne_epochs.mne_2001"
#: A few epochs and channels at the cell's own 2001 samples, 20 rows.
SMALL = {"traffic": {"shape": [6, 2, 2001], "pool": 2},
         "config": {"channels": 2,
                    "freqs": {"start": 1.0, "stop": 100.0, "count": 20}}}


def _events(epochs=True, other=True, kernel=True):
    """A 10 ms window of two calls on thread 1: two epoch transforms in
    each call, one that starts 1 ms before the window, one that starts
    after it, and one on another thread."""
    def ev(cat, name, ts, dur, tid=1):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "pid": 7 if cat.startswith(("cpu", "user")) else 0,
                "tid": tid}
    events = [ev("user_annotation", "gpubench.window", 1000, 10000),
              ev("user_annotation", "gpubench.call", 1000, 5000),
              ev("user_annotation", "gpubench.call", 6000, 5000)]
    if kernel:
        events.append(ev("kernel", "k", 4000, 1000))
    if epochs:
        events += [ev("user_annotation", "ninw.epoch.cwt", ts, 500)
                   for ts in (0, 2000, 3000, 7000, 8000, 11500)]
        events.append(ev("user_annotation", "ninw.epoch.cwt", 2500, 500,
                         tid=2))
    if other:
        events.append(ev("user_annotation",
                         "ninw.transform.plain:n_not_pow2", 1500, 4000))
    return events


def _run(trace, n_calls=2):
    return Run(n_calls=n_calls, call_s=[0.005] * n_calls, window_s=0.01,
               peak_bytes=0, setup_s=1.0, channel_seconds=1.0, cost={},
               trace=trace)


def _read(trace, n_calls=2):
    return metric_module("epoch_cwts_per_call").read(_run(trace, n_calls))


def test_counts_the_window_threads_spans_that_start_inside_it():
    # Four of the six on thread 1 start inside the window; the one before
    # it, the one after it and the one on thread 2 are not counted.
    assert _read(Trace(_events())) == 2.0
    assert _read(Trace(_events()), n_calls=4) == 1.0


def test_a_window_without_epoch_spans_reads_nothing():
    """A kernel route, or a program that opens no epoch span, is left out
    of the line: the count says nothing of the transforms it computed."""
    assert _read(Trace(_events(epochs=False))) is None


def test_no_program_spans_no_device_activity_or_no_trace_read_nothing():
    assert _read(Trace(_events(epochs=False, other=False))) is None
    assert _read(Trace(_events(kernel=False))) is None
    assert _read(None) is None


def test_the_metric_is_listed_for_the_new_cell_only():
    bench = benchmark()
    for w in bench["workloads"]:
        listed = {m["name"] for m in metrics_for(bench, w["name"], True)}
        assert ("epoch_cwts_per_call" in listed) == (w["name"] == CELL)
    assert {"device_idle_pct", "h2d_ms_per_call", "cwt_roofline_pct",
            "snapshot_ms_per_call"} <= {
        m["name"] for m in metrics_for(bench, CELL, True)}


def test_a_small_traced_run_transforms_each_epoch_once(monkeypatch):
    """The profiler's own trace of a small CPU run: each call opens one
    ``ninw.epoch.cwt`` span per epoch, under the plain route's
    ``n_not_pow2`` transform span, and the run is correct.  The result line
    leaves the metric out on the CPU (no device activity)."""
    kept = []
    made = Trace.from_profiler.__func__

    def keep(cls, prof):
        kept.append(made(cls, prof))
        return kept[-1]

    monkeypatch.setattr(Trace, "from_profiler", classmethod(keep))
    r = measure(CELL, 2 ** 31 + 23, 0.2, trace=True, device="cpu",
                overrides=SMALL)
    assert r["correct"], r["checks"]
    assert "epoch_cwts_per_call" not in r["metrics"]
    tr, = kept
    calls = [s for s, _, n in tr.host if n == "gpubench.call"]
    assert len(calls) == r["attempted"]
    starts = [s for s, _, n in tr.host
              if n == "ninw.epoch.cwt" and tr.lo <= s < tr.hi]
    assert len(starts) == SMALL["traffic"]["shape"][0] * len(calls)
    route = {n for _, _, n in tr.host if n.startswith("ninw.transform.")}
    assert route == {"ninw.transform.plain:n_not_pow2"}
    # The same trace with one device activity added reads one CWT per
    # epoch.
    tr.device.append(("kernel", "k", tr.lo, tr.lo + 1e-6))
    assert metric_module("epoch_cwts_per_call").read(
        _run(tr, r["attempted"])) == SMALL["traffic"]["shape"][0]


@pytest.mark.parametrize("seed", [2 ** 31 + 99, 3000000001])
def test_control_is_not_correct_at_2001_samples(seed):
    checks = control(CELL, seed, device="cpu", overrides=SMALL)
    assert not all(c["ok"] for c in checks.values()), checks


def _half_epochs(signals, bank, original, **kw):
    return original(signals[:signals.shape[0] // 2], bank, **kw)


def _last_epoch_dropped(signals, bank, original, **kw):
    return original(signals[:-1], bank, **kw)


def _channel_duplicated(signals, bank, original, **kw):
    """Channel 0's power plane replaced by channel 1's."""
    power, itc = original(signals, bank, **kw)
    power[0] = power[1].clone()
    return power, itc


def _altered_power(signals, bank, original, **kw):
    """One power sample of the 1 Hz row made 1% too large."""
    power, itc = original(signals, bank, **kw)
    power[0, 0, 1000] *= 1.01
    return power, itc


def _altered_itc(signals, bank, original, **kw):
    power, itc = original(signals, bank, **kw)
    itc[0, 3, 100] += 0.01
    return power, itc


@pytest.mark.parametrize("fault", [_half_epochs, _last_epoch_dropped,
                                   _channel_duplicated, _altered_power,
                                   _altered_itc],
                         ids=["half-batch", "last-epoch-dropped",
                              "power-channel-duplicated", "altered-power",
                              "altered-itc"])
@pytest.mark.parametrize("seed", [2 ** 31 + 99, 3000000001])
def test_broken_timed_path_is_not_correct_at_2001_samples(monkeypatch, seed,
                                                           fault):
    original = mne_adapter.power_itc_auto
    monkeypatch.setattr(mne_adapter, "power_itc_auto",
                        lambda s, b, **kw: fault(s, b, original, **kw))
    # One pooled batch, so that the compared call does not depend on how
    # many calls the window held.
    one = {**SMALL, "traffic": {**SMALL["traffic"], "pool": 1}}
    r = measure(CELL, seed, 0.1, device="cpu", overrides=one)
    assert not r["correct"], r["checks"]
    assert r["failed"] == 1


def test_the_reference_power_is_what_the_z_scored_reference_z_scores():
    """``epochs_power_planes`` gives the planes of ``epochs_planes`` before
    the z-score: the same power z-scored is its plane, the same
    coherence."""
    rng = np.random.default_rng(5)
    x = 1e-5 * rng.standard_normal((4, 3, 2001))
    freqs, args = [1.0, 10.0, 40.0], (1000.0, 17.5, 3.0, False)
    power = epochs_power_planes(x, freqs, *args, Precision(), "cpu",
                                channels_per_block=2)
    zs = epochs_planes(x, freqs, *args, (0.0, 0.2), Precision(), "cpu",
                       channels_per_block=2)
    for (sel, p, itc), (sel2, z, itc2) in zip(power, zs):
        assert sel == sel2 and torch.equal(itc, itc2)
        w = p[..., :200]
        mean = w.mean(-1, keepdim=True)
        std = torch.sqrt(((w - mean) ** 2).mean(-1, keepdim=True))
        assert torch.equal((p - mean) / std, z)


def test_the_entry_hands_back_the_power_its_z_score_was_made_from():
    _, _, cell, config = load_cell(CELL, SMALL)
    entry = make_entry(cell, config, 2 ** 31 + 5, torch.device("cpu"))
    key, (power, zpower, itc) = entry.call(0)
    assert key == 0 and power.shape == zpower.shape == itc.shape
    assert torch.equal(zpower, entry.nt.baseline_tf(power, 1000.0, 0.0, 0.2,
                                                    "zscore"))
    numbers = entry.numbers(key, (power, zpower, itc))
    assert set(numbers) == set(cell["limits"]) == {"power_err", "itc_err"}
    assert numbers["power_err"] <= cell["limits"]["power_err"]
