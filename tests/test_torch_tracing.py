"""The port's own profiler spans (``utils.observability.span``) at its layer
boundaries, and ``ops.fused.why_not``, on the CPU.

Gates, each with its reason:

* with no profiler recording, ``span`` builds no ``record_function`` and
  hands back one shared null context: the spans cost a flag test when off;
* under ``torch.profiler``: an epochs call records one snapshot, one copy
  and one transform span inside its caller's span, with one epoch span
  per epoch inside the plain route's transform span, and a second call on
  the same adapter no snapshot (the cache hit); a streamed recording one
  bank build and, for each window batch, one wait, one copy and one
  transform; every span properly nested on the calling thread, as the
  benchmark's attribution of idle time assumes;
* ``why_not`` names each reject branch, and ``supports()`` is
  ``why_not() is None`` on every case;
* the transform span's reason: "cpu" where the kernel would take the
  workload on a card, "complex_signals", and a stream's own reasons;
  ``route()``'s reasons and keys for each family, "eps" and "off" among
  them;
* every dispatcher that asks ``route()`` opens one transform span: the
  per-signal power, the three epoch reductions, the five pair ``*_auto``
  and the two synchrosqueezing dispatchers.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import ninwavelets_tpu_torch as nt
from ninwavelets_tpu_torch import kernels
from ninwavelets_tpu_torch.ops import connectivity as tconn
from ninwavelets_tpu_torch.ops import extensions as text
from ninwavelets_tpu_torch.ops import fused as tfused
from ninwavelets_tpu_torch.ops import sst as tsst
from ninwavelets_tpu_torch.parallel.streaming import StreamingCWT
from ninwavelets_tpu_torch.utils import observability as tobs

from torch_threads import one_torch_thread  # noqa: F401

SFREQ = 256.0
FREQS = np.array([5.0, 10.0, 15.0])


def _spans(body, prefix="ninw."):
    """``[(name, start, end)]`` of the spans ``body()`` records on this
    thread whose name starts with ``prefix`` or is ``"caller"``, in order
    of start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("caller"):
            body()
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.name.startswith(prefix) or e.name == "caller"),
                  key=lambda x: x[1])


def _names(spans):
    return [n for n, _, _ in spans if n != "caller"]


def _assert_nested(spans):
    for i, (a, s0, e0) in enumerate(spans):
        for b, s1, e1 in spans[i + 1:]:
            assert e0 <= s1 or e1 <= e0, f"{a} and {b} overlap"


class _Raw:
    def __init__(self, data):
        self._data = data
        self.info = {"sfreq": SFREQ}
        self.ch_names = [f"c{i}" for i in range(data.shape[0])]

    def get_data(self):
        return self._data


def test_span_off_builds_nothing(monkeypatch):
    def refuse(name):
        raise AssertionError("record_function built with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    first = tobs.span("ninw.a")
    assert first is tobs.span("ninw.b") is tobs._NO_SPAN
    with first:
        pass
    assert nt.utils.span is tobs.span


def test_span_on_records_under_the_profiler():
    def body():
        with tobs.span("ninw.test"):
            torch.ones(3).sum()

    assert _names(_spans(body)) == ["ninw.test"]


def test_epochs_call_spans_and_the_snapshot_cache():
    rng = np.random.default_rng(1)
    ew = nt.EpochsWavelet(
        nt.ArrayEpochs(rng.standard_normal((4, 2, 256)), SFREQ),
        nt.Morse(SFREQ, device="cpu"))
    first = _spans(lambda: ew.power_itc_all(FREQS))
    names = _names(first)
    assert names.count("ninw.adapter.snapshot") == 1
    assert names.count("ninw.h2d") == 1
    assert names.count("ninw.transform.plain:cpu") == 1
    assert names.count("ninw.bank.build") == 1
    assert [n for n in names if n.startswith("ninw.transform")] == [
        "ninw.transform.plain:cpu"]
    _assert_nested(first)
    _, lo, hi = first[0]
    assert all(lo <= s and e <= hi for _, s, e in first[1:])
    # The snapshot comes before its copy, the copy before the transform.
    # Then each of the 4 epochs' transforms, inside the transform span.
    order = [n for n in names if n != "ninw.bank.build"]
    assert order == ["ninw.adapter.snapshot", "ninw.h2d",
                     "ninw.transform.plain:cpu"] + ["ninw.epoch.cwt"] * 4
    (_, lo, hi), = [x for x in first if x[0] == "ninw.transform.plain:cpu"]
    assert all(lo <= s and e <= hi for n, s, e in first
               if n == "ninw.epoch.cwt")
    again = _names(_spans(lambda: ew.power_itc_all(FREQS)))
    assert again == ["ninw.transform.plain:cpu"] + ["ninw.epoch.cwt"] * 4


def test_streamed_recording_spans_per_batch():
    rng = np.random.default_rng(2)
    raw = _Raw(rng.standard_normal((2, 3 * 512)))
    rw = nt.RawWavelet(raw, nt.Morse(SFREQ, device="cpu"), window=512,
                       batch=1)
    got = _spans(lambda: rw.power(FREQS))
    names = _names(got)
    assert names.count("ninw.adapter.snapshot") == 1
    assert names.count("ninw.bank.build") == 1
    per_batch = [n for n in names if n not in ("ninw.adapter.snapshot",
                                               "ninw.bank.build")]
    assert per_batch == ["ninw.stream.wait", "ninw.h2d",
                         "ninw.transform.plain:cpu"] * 3
    _assert_nested(got)


def test_streamed_without_prefetch_waits_on_the_gather():
    from ninwavelets_tpu_torch.io.stream import ArraySource, iter_ext_batches
    src = ArraySource(np.ones((2, 1000), np.float32))

    def body():
        for _ in iter_ext_batches(src, 256, 32, 2, prefetch=False):
            pass

    assert _names(_spans(body)) == ["ninw.stream.wait"] * 2


@pytest.mark.parametrize("shape,bank,why", [
    ((3, 2, 2048), torch.ones(5, 2048), None),
    ((1, 1, 256), torch.ones(1, 256), None),
    ((19, 64, 16384), torch.ones(2, 16384), None),
    ((3, 2048), torch.ones(5, 2048), "shape"),               # no channel axis
    ((3, 2, 2048), None, "shape"),
    ((3, 2, 2048), torch.ones(5, 1024), "shape"),            # bank for other N
    ((3, 2, 2048), torch.ones(2048), "shape"),               # 1-D bank
    ((3, 2, 2048), torch.ones(0, 2048), "shape"),            # no rows
    ((0, 2, 2048), torch.ones(5, 2048), "shape"),            # no epochs
    ((3, 2, 2048), torch.ones(5, 2048, dtype=torch.complex64),
     "complex_bank"),
    ((3, 2, 2048), torch.ones(5, 2048, dtype=torch.int32), "complex_bank"),
    ((3, 65536, 256), torch.ones(5, 256), "channels"),
    ((3, 0, 256), torch.ones(5, 256), "channels"),
    ((3, 2, 2000), torch.ones(5, 2000), "n_not_pow2"),
    ((3, 2, 2001), torch.ones(5, 2001), "n_not_pow2"),
    ((3, 2, 128), torch.ones(5, 128), "n_range"),
    ((3, 2, 32768), torch.ones(5, 32768), "n_range"),
])
def test_why_not_names_each_reject(shape, bank, why):
    assert tfused.why_not(shape, bank) == why
    assert tfused.supports(shape, bank) == (why is None)
    assert tfused.supports(shape, bank, epilogue="itc") == (why is None)


@pytest.mark.parametrize("grid,interpolate,why", [
    (("lin", 5.0, 5.0), True, None),
    (("log", 5.0, 1.1), True, None),
    (None, True, "row_map"),
    (("pw", 0.0, 0.0), True, "row_map"),
    (("lin", 5.0, 5.0), False, "interpolate"),
])
def test_why_not_ssq(grid, interpolate, why):
    bank = torch.ones(3, 256)
    assert tfused.why_not_ssq((2, 1, 256), bank, grid, interpolate) == why
    assert tfused.supports_ssq((2, 1, 256), bank, grid, interpolate) == (
        why is None)


def test_dispatcher_reasons():
    bank = torch.ones(3, 256)
    real = torch.ones(2, 1, 256)
    def asked(family, signals, bank):
        r = tfused.route(family, signals, bank)
        return r.takes, r.span

    assert asked("power", real, bank) == (True, "ninw.transform.plain:cpu")
    assert asked("power", real.to(torch.complex64), bank) == (
        False, "ninw.transform.plain:complex_signals")
    assert asked("power", torch.ones(2, 1, 200), torch.ones(3, 200)) == (
        False, "ninw.transform.plain:n_not_pow2")
    cx = torch.ones(3, 256, dtype=torch.complex64)
    assert asked("itc", real, cx) == (True, "ninw.transform.plain:cpu")
    assert tfused.transform_span("power_itc", None) == (
        "ninw.transform.kernel:power_itc")


@pytest.mark.parametrize("family,signals,kw,want", [
    ("power_each", (1, 1, 256), {}, (True, "power_each", None)),
    ("power_each", (1, 1, 256), {"use_fused": False}, (False, None, "off")),
    ("power_each", (1, 1, 200), {}, (False, None, "n_not_pow2")),
    ("plv", (2, 1, 256), {}, (True, "plv", None)),
    ("plv", (2, 1, 256), {"eps": 1e-3}, (False, None, "eps")),
    ("phaselag", (2, 1, 256), {"eps": 1e-3}, (True, "phaselag", None)),
    ("coherence", (2, 256), {}, (False, None, "shape")),
    ("ssq", (2, 1, 256), {"grid": ("lin", 5.0, 5.0)}, (True, "ssq", None)),
    ("ssq", (2, 1, 256), {"grid": None}, (False, None, "row_map")),
    ("ssq", (2, 1, 256), {"grid": ("lin", 5.0, 5.0), "interpolate": False},
     (False, None, "interpolate")),
    ("power", (2, 1, 2001), {}, (False, None, "n_not_pow2")),
])
def test_route_reasons_on_a_card(family, signals, kw, want):
    """``route()`` on real signals given by shape on a card: the key where
    the kernel launches, else the reason (a real CPU bank: the shape rule
    reads no device, and the chirp-z route, asked for nowhere here, is the
    only one that needs the bank on the card)."""
    r = tfused.route(family, signals, torch.ones(3, signals[-1]),
                     device="cuda", **kw)
    assert (r.takes, r.key, r.why) == want
    assert r.launch == (want[2] is None)
    assert r.span == tfused.transform_span(want[1], want[2])
    on_cpu = tfused.route(family, signals, torch.ones(3, signals[-1]),
                          device="cpu", **kw)
    assert on_cpu.takes == r.takes
    assert on_cpu.why == (r.why if r.why not in (None, "off") else "cpu")


def _dispatch(auto, bank):
    """``(call, reason)``: the dispatcher ``auto`` on (2, 1, 256) complex
    signals, which no kernel takes, and the reason its span gives; the
    synchrosqueezing dispatchers on real ones, which the kernels would
    take on a card."""
    x = torch.randn(2, 1, 256, dtype=torch.complex64)
    if auto.startswith("ssq_"):
        real = x.real.contiguous()
        return lambda: getattr(tsst, auto)(real, bank, FREQS, SFREQ), "cpu"
    if hasattr(tfused, auto):
        return lambda: getattr(tfused, auto)(x, bank), "complex_signals"
    pairs = tconn if hasattr(tconn, auto) else text
    return lambda: getattr(pairs, auto)(x, x, bank), "complex_signals"


@pytest.mark.parametrize("auto", ["power_auto", "mean_power_auto",
                                  "itc_auto", "power_itc_auto", "plv_auto",
                                  "ppc_auto", "phase_lag_auto",
                                  "epoch_coherence_auto", "imcoh_auto",
                                  "ssq_power", "ssq_mean_power"])
def test_each_dispatcher_opens_one_transform_span(auto):
    call, reason = _dispatch(auto, torch.ones(3, 256))
    before = dict(kernels.launches)
    names = _names(_spans(call))
    # The epoch reductions transform each of the 2 epochs in a span of
    # its own, inside the transform span; the other dispatchers have none.
    epochs = 2 if auto in ("mean_power_auto", "itc_auto",
                           "power_itc_auto") else 0
    assert names == ["ninw.transform.plain:" + reason] + [
        "ninw.epoch.cwt"] * epochs
    assert kernels.launches == before


def test_stream_reasons():
    wdef = nt.Morse(SFREQ, device="cpu")._wdef()
    long = StreamingCWT(wdef, FREQS, SFREQ, window=32768, halo=200,
                        device="cpu")
    assert long._why == "n_range" and not long._fused
    assert StreamingCWT(wdef, FREQS, SFREQ, window=16384, halo=200,
                        device="cpu")._why == "cpu"
    assert StreamingCWT(wdef, FREQS, SFREQ, window=512, halo=200,
                        device="cpu")._why == "cpu"
    assert StreamingCWT(wdef, FREQS, SFREQ, window=512, halo=200,
                        use_fused=False, device="cpu")._why == "cpu"


@pytest.mark.parametrize("interpolate,why", [(False, "interpolate"),
                                             (True, "cpu")])
def test_ssq_stream_span(interpolate, why):
    wdef = nt.Morse(SFREQ, interpolate=interpolate,
                    device="cpu")._wdef()
    s = StreamingCWT(wdef, FREQS, SFREQ, window=512, halo=200,
                     interpolate=interpolate, batch=2, device="cpu")
    sig = np.random.default_rng(3).standard_normal((1, 1024))
    names = _names(_spans(lambda: s.ssq_power_device(sig)))
    assert names == ["ninw.stream.wait", "ninw.h2d",
                     "ninw.transform.plain:" + why]
