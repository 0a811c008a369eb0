"""The port's event-locked recording path (``RawWavelet.epochs`` / ``itc`` /
``epoch_power`` / ``_bad_spans``), the trial groups of ``EpochsWavelet``
(``subset`` / ``split`` / ``_carry_codes``) and the small ``ops`` exports
(``grids.log_freqs``, ``signal_utils.hamming_window`` / ``normalize`` /
``interpolate_alias``, ``bank.pad_spectrum_to``) against the JAX package on
the same seeded inputs, on the CPU.

On the CPU the event-locked epoch reductions take the plain path; on the
card a window of a power-of-two length in 256..16384 reaches K1/K2, which
``chip_smoke.py`` holds against the plain path.

Gates, each with its reason:

* windows, codes and trial subsets: bit-identical (both packages slice the
  same float32 samples with the same native gather, or its numpy twin, and
  read the same EDF+ file);
* event-locked power: max|d| / max|ref| <= 1e-4 and ITC by
  ``tests/test_torch_cwt.py::assert_itc_close`` (1e-4 on sound cells, 2e-3
  elsewhere): slice 1's gates (``tests/test_torch_slice.py``); the
  baselined (z-scored) power within 1e-4 of its max, as slice 1 holds
  ``power(baseline=...)``;
* the small exports: ``log_freqs`` within half an ulp of the float64
  ``np.logspace`` (``torch.logspace`` rounds correctly) and so within 3 ulp
  of JAX's (its float32 ``10 ** linspace`` measured up to 2.8 ulp off the
  float64 grid at 1-100 Hz, 21 points), the Hamming window and
  ``normalize`` within 1e-6 relative, ``interpolate_alias`` and
  ``pad_spectrum_to`` exactly;
* errors: JAX's types and messages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ninwavelets_tpu as nw
import ninwavelets_tpu_torch as nt
from ninwavelets_tpu.io.edf import write_edf
from ninwavelets_tpu.ops import bank as jbank
from ninwavelets_tpu.ops import grids as jgrids
from ninwavelets_tpu.ops import signal_utils as jsu

from test_torch_cwt import assert_itc_close
from torch_threads import one_torch_thread  # noqa: F401

SFREQ = 250.0
RTOL = 1e-4


class _Raw:
    """The duck-typed ``mne.io.Raw`` surface."""

    def __init__(self, x, sfreq=SFREQ):
        self._d = np.asarray(x, np.float32)
        self.info = {"sfreq": float(sfreq)}
        self.ch_names = [f"c{i}" for i in range(self._d.shape[0])]

    def get_data(self):
        return self._d


def _raws(x, sfreq=SFREQ):
    return (nw.RawWavelet(_Raw(x, sfreq), nw.Morse(sfreq), window=1024),
            nt.RawWavelet(_Raw(x, sfreq), nt.Morse(sfreq, device="cpu"),
                          window=1024))


def _host(ew):
    return np.asarray(ew._host_data())


def _same_epochs(j, t):
    """The two adapters hold bit-identical windows, names, times and
    codes."""
    assert _host(t).dtype == np.float32
    assert np.array_equal(_host(t), _host(j))
    assert list(t.epochs.ch_names) == list(j.epochs.ch_names)
    assert np.array_equal(t.epochs.times, j.epochs.times)
    assert hasattr(t, "event_codes") == hasattr(j, "event_codes")
    if hasattr(j, "event_codes"):
        assert np.array_equal(np.asarray(t.event_codes),
                              np.asarray(j.event_codes))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    return np.abs(got - want).max() / np.abs(want).max()


# -- windows --------------------------------------------------------------

@pytest.mark.parametrize("events, tmin, tmax, picks", [
    (np.array([500, 1500, 2500, 3500, 4200]), -0.1, 0.1, None),
    (np.array([[500, 0, 1], [1500, 0, 2], [2500, 0, 1], [3500, 0, 2],
               [4999, 0, 7], [3, 0, 9]]), -0.1, 0.1, None),     # edge drops
    (np.array([[600, 0, 3], [2600, 0, 4]]), 0.0, 1.0, ["c1"]),
    (np.array([100, 2000, 4000]), -0.2, 0.823, ["c1", "c0"]),  # 256 samples
])
def test_windows_are_bit_identical_to_jax(events, tmin, tmax, picks):
    x = np.random.default_rng(0).standard_normal((2, 5000))
    jr, tr = _raws(x)
    je = jr.epochs(events, tmin, tmax, picks=picks)
    te = tr.epochs(events, tmin, tmax, picks=picks)
    _same_epochs(je, te)
    # and they are numpy slices of the recording
    ev = events[:, 0] if events.ndim == 2 else events
    start = int(round(tmin * SFREQ))
    n = int(round((tmax - tmin) * SFREQ)) + 1
    idx = [0, 1] if picks is None else [int(p[1]) for p in picks]
    kept = [e for e in ev if 0 <= e + start and e + start + n <= 5000]
    want = np.stack([x.astype(np.float32)[idx, e + start:e + start + n]
                     for e in kept])
    assert np.array_equal(_host(te), want)


def test_reject_spans_match_jax():
    x = np.random.default_rng(0).standard_normal((2, 5000))
    jr, tr = _raws(x)
    ev = np.array([500, 1500, 2500, 3500, 4200])
    for spans, n_kept in (([(5.8, 1.2)], 4), ([(10.0, 0.0)], 4),
                          ([(8.0, 0.0)], 5)):
        te = tr.epochs(ev, -0.1, 0.1, reject_spans=spans)
        _same_epochs(jr.epochs(ev, -0.1, 0.1, reject_spans=spans), te)
        assert _host(te).shape[0] == n_kept
    with pytest.raises(ValueError) as want:
        jr.epochs(ev, -0.1, 0.1, reject_spans=[(0.0, 30.0)])
    with pytest.raises(ValueError, match="bad-span") as got:
        tr.epochs(ev, -0.1, 0.1, reject_spans=[(0.0, 30.0)])
    assert str(got.value) == str(want.value)


def test_reject_annotations_on_an_edf_file(tmp_path):
    x = np.random.default_rng(1).standard_normal((2, 5000)).astype(
        np.float32)
    path = str(tmp_path / "rec.edf")
    write_edf(path, x, SFREQ, annotations=[(5.8, 1.2, "BAD_motion"),
                                            (14.0, 0.5, "stim")])
    jr = nw.RawWavelet.from_edf(path, nw.Morse(SFREQ), window=1024)
    tr = nt.RawWavelet.from_edf(path, nt.Morse(SFREQ, device="cpu"),
                                window=1024)
    assert tr._bad_spans("bad") == jr._bad_spans("bad") == [(5.8, 1.2)]
    ev = np.array([[500, 0, 1], [1500, 0, 2], [2500, 0, 1], [3500, 0, 2]])
    for prefix, n_kept in (("bad", 3), ("nonsense", 4)):
        te = tr.epochs(ev, -0.1, 0.1, reject_annotations=prefix)
        _same_epochs(jr.epochs(ev, -0.1, 0.1, reject_annotations=prefix),
                     te)
        assert _host(te).shape[0] == n_kept
    # picks gather off the file too
    _same_epochs(jr.epochs(ev, -0.1, 0.1, picks=[tr.raw.ch_names[1]]),
                 tr.epochs(ev, -0.1, 0.1, picks=[tr.raw.ch_names[1]]))


def test_epoching_errors_match_jax():
    x = np.random.default_rng(2).standard_normal((2, 4000))
    jr, tr = _raws(x)
    calls = [
        lambda r: r.epochs(np.array([1000]), -0.1, 0.1,
                           reject_annotations="bad"),
        lambda r: r.epochs(np.array([500, 1500]), -0.1, 0.1,
                           codes=np.array([1])),
        lambda r: r.epochs(np.array([3990]), -0.1, 0.1),
    ]
    for call in calls:
        with pytest.raises(ValueError) as want:
            call(jr)
        with pytest.raises(ValueError) as got:
            call(tr)
        assert str(got.value) == str(want.value)


def test_plain_events_carry_no_codes():
    x = np.random.default_rng(0).standard_normal((2, 5000))
    _, tr = _raws(x)
    ew = tr.epochs(np.array([500, 1500]), -0.1, 0.1)
    assert not hasattr(ew, "event_codes")
    with pytest.raises(ValueError, match="event_codes"):
        ew.split()


# -- event-locked reductions ----------------------------------------------

@pytest.mark.parametrize("interpolate", [False, True])
def test_event_locked_itc_and_power_match_jax(interpolate):
    sf = 1000.0
    rng = np.random.default_rng(4)
    n = 8000
    x = 0.5 * rng.standard_normal((3, n))
    ev = np.arange(700, 7000, 900)
    t = np.arange(256) / sf
    for e in ev:                                 # a locked 40 Hz response
        x[:, e:e + 256] += np.sin(2 * np.pi * 40 * t)
    jr = nw.RawWavelet(_Raw(x, sf), nw.Morse(sf, interpolate=interpolate))
    tr = nt.RawWavelet(_Raw(x, sf), nt.Morse(sf, interpolate=interpolate,
                                             device="cpu"))
    freqs = np.arange(10.0, 80.0, 10.0)
    tmin, tmax = -0.1, 0.411                     # 512 samples
    itc_t = tr.itc(freqs, ev, tmin, tmax).numpy()
    itc_j = np.asarray(jr.itc(freqs, ev, tmin, tmax))
    coeffs = tr.epochs(ev, tmin, tmax).cwt_all(freqs).numpy()
    assert itc_t.shape == (3, freqs.size, 512)
    assert_itc_close(itc_t, itc_j, coeffs)
    p_t = tr.epoch_power(freqs, ev, tmin, tmax).numpy()
    p_j = np.asarray(jr.epoch_power(freqs, ev, tmin, tmax))
    assert _rel(p_t, p_j) <= RTOL
    b_t = tr.epoch_power(freqs, ev, tmin, tmax, baseline=(0.0, 0.09),
                         decim=2).numpy()
    b_j = np.asarray(jr.epoch_power(freqs, ev, tmin, tmax,
                                    baseline=(0.0, 0.09), decim=2))
    assert b_t.shape == (3, freqs.size, 256)
    assert _rel(b_t, b_j) <= RTOL
    # the 40 Hz row locks
    row = int(np.argmin(np.abs(freqs - 40.0)))
    assert itc_t[:, row, 150:300].min() > 0.9


# -- trial groups -----------------------------------------------------------

def test_subset_and_split_compose_as_in_jax():
    rng = np.random.default_rng(0)
    data = rng.standard_normal((12, 3, 256)).astype(np.float32)
    labels = np.array([0, 1] * 6)
    jew = nw.EpochsWavelet(nw.ArrayEpochs(data, SFREQ), nw.Morse(SFREQ))
    tew = nt.EpochsWavelet(nt.ArrayEpochs(data, SFREQ),
                           nt.Morse(SFREQ, device="cpu"))
    sub = tew.subset(labels == 0)
    assert len(sub.epochs) == 6
    assert np.array_equal(sub._all_data().numpy(), data[labels == 0])
    _same_epochs(jew.subset(labels == 0), sub)
    groups, jgroups = tew.split(labels), jew.split(labels)
    assert set(groups) == set(jgroups) == {0, 1}
    for lab in groups:
        _same_epochs(jgroups[lab], groups[lab])
    p = groups[0].power_all([20.0])
    assert tuple(p.shape) == (3, 1, 256)
    assert _rel(p.numpy(), np.asarray(jgroups[0].power_all([20.0]))) <= RTOL
    s2 = tew.subset([3, 1])
    assert np.array_equal(s2._all_data().numpy(), data[[3, 1]])
    for call in (lambda ew: ew.subset(np.zeros(12, bool)),
                 lambda ew: ew.split(np.zeros(5))):
        with pytest.raises(ValueError) as want:
            call(jew)
        with pytest.raises(ValueError) as got:
            call(tew)
        assert str(got.value) == str(want.value)


def test_codes_follow_subsets_and_splits():
    x = np.random.default_rng(1).standard_normal((2, 20000))
    jr, tr = _raws(x)
    ev = np.stack([np.arange(500, 19500, 1000), np.zeros(19, int),
                   np.tile([1, 2], 10)[:19]], 1)
    jew, tew = jr.epochs(ev, -0.2, 0.2), tr.epochs(ev, -0.2, 0.2)
    _same_epochs(jew, tew)
    sel = np.array([0, 4, 5, 9, 18])
    _same_epochs(jew.subset(sel), tew.subset(sel))
    mask = np.arange(19) % 3 == 0
    _same_epochs(jew.subset(mask), tew.subset(mask))
    groups, jgroups = tew.split(), jew.split()
    assert set(groups) == set(jgroups) == {1, 2}
    for lab in groups:
        _same_epochs(jgroups[lab], groups[lab])
        assert (np.asarray(groups[lab].event_codes) == lab).all()
    # _carry_codes onto a rebuilt adapter, all trials or a selection
    out = nt.EpochsWavelet(nt.ArrayEpochs(_host(tew), SFREQ), tew.wavelet)
    assert np.array_equal(tew._carry_codes(out).event_codes, ev[:, 2])
    out2 = nt.EpochsWavelet(nt.ArrayEpochs(_host(tew)[sel], SFREQ),
                            tew.wavelet)
    assert np.array_equal(tew._carry_codes(out2, sel).event_codes,
                          ev[sel, 2])
    # string codes (marker descriptions) split the same way
    tew.event_codes = np.where(ev[:, 2] == 1, "S  1", "S  2")
    assert set(tew.split()) == {"S  1", "S  2"}


# -- the small exports --------------------------------------------------------

def test_log_freqs_matches_jax():
    got = nt.ops.log_freqs(1.0, 100.0, 21).numpy()
    want = np.asarray(jgrids.log_freqs(1.0, 100.0, 21))
    assert got.dtype == np.float32
    assert (np.abs(got - np.logspace(0.0, 2.0, 21))
            <= 0.5 * np.spacing(got)).all()
    assert (np.abs(got - want) <= 3 * np.spacing(want)).all()
    assert got[0] == pytest.approx(1.0) and got[-1] == pytest.approx(100.0)
    ratios = got[1:] / got[:-1]
    np.testing.assert_allclose(ratios, ratios[0], rtol=1e-4)
    for bad in ((0.0, 10.0, 5), (10.0, 5.0, 5), (1.0, 10.0, 1)):
        with pytest.raises(ValueError) as want_e:
            jgrids.log_freqs(*bad)
        with pytest.raises(ValueError) as got_e:
            nt.ops.log_freqs(*bad)
        assert str(got_e.value) == str(want_e.value)


def test_hamming_normalize_interpolate_alias_pad_match_jax():
    rng = np.random.default_rng(0)
    h_t = nt.ops.hamming_window(torch.zeros(100)).numpy()
    h_j = np.asarray(jsu.hamming_window(np.zeros(100)))
    assert h_t.dtype == np.float32 and _rel(h_t, h_j) <= 1e-6
    w = (rng.standard_normal((3, 64))
         + 1j * rng.standard_normal((3, 64))).astype(np.complex64)
    n_t = nt.ops.normalize(torch.from_numpy(w), 2.0).numpy()
    n_j = np.asarray(jsu.normalize(jnp.asarray(w), 2.0))
    assert _rel(n_t, n_j) <= 1e-6
    assert np.linalg.norm(n_t) == pytest.approx(2.0, rel=1e-6)
    for x in (w, w[..., :63], rng.standard_normal((2, 9)).astype(
            np.float32)):
        got = nt.ops.interpolate_alias(torch.from_numpy(x)).numpy()
        assert np.array_equal(got, np.asarray(jsu.interpolate_alias(x)))
    for n in (40, 64, 100):
        got = nt.ops.pad_spectrum_to(torch.from_numpy(w), n).numpy()
        assert np.array_equal(got, np.asarray(jbank.pad_spectrum_to(
            jnp.asarray(w), n)))
