"""The port's BDF and BrainVision readers and writers
(``ninwavelets_tpu_torch.io.bdf`` / ``io.brainvision``) and the adapter
entry points over them (``RawWavelet.from_bdf`` / ``from_brainvision`` /
``epochs_from_markers``, ``reject_annotations`` on a BrainVision file)
against the JAX package on the same seeded inputs, on the CPU.

On the CPU the streamed power and the epoch reductions take the plain path;
on the card a file-backed ``power`` reaches K4 and the marker epochs'
``power_all`` / ``itc_all`` K1/K2, which ``chip_smoke.py`` holds against the
plain path.

Gates, each with its reason:

* files: byte-identical (the two writers are one algorithm over the same
  float64 arithmetic and the same text);
* reads (``get_data``, ``gather`` with halo and edges, picks,
  ``status_events``, markers, marker spans, annotations): exactly equal,
  each package reading the other's file (numpy only on both sides; the
  port's vectorized 24-bit decode calibrates as ``seg * scale + dc`` on
  the int32 decode, the JAX package's per-record arithmetic);
* the streamed recording power: max|d| <= 1e-5 of the max (slice 3's
  streaming gate); the marker epochs' power within 1e-4 of the max and
  their ITC by ``tests/test_torch_cwt.py::assert_itc_close`` (1e-5 on sound
  cells, 2e-3 elsewhere): slice 1's gates, as
  ``tests/test_torch_epoching.py`` holds ``RawWavelet.epochs``;
* windows, codes and kept events: exactly equal;
* errors: JAX's types and messages.
"""
import os

import numpy as np
import pytest
import torch

import ninwavelets_tpu as nw
import ninwavelets_tpu_torch as nt
from ninwavelets_tpu.io import bdf as jbdf
from ninwavelets_tpu.io import brainvision as jbv
from ninwavelets_tpu_torch.io import bdf as tbdf
from ninwavelets_tpu_torch.io import brainvision as tbv
from ninwavelets_tpu_torch.ops import cwt as tcwt

from test_torch_cwt import assert_itc_close
from torch_threads import one_torch_thread  # noqa: F401

SFREQ = 500.0
RTOL = 1e-5
EPOCH_RTOL = 1e-4


def _data(c=4, n=5000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SFREQ
    return np.stack([100.0 * np.sin(2 * np.pi * (7 + 3 * i) * t)
                     + 5.0 * rng.standard_normal(n)
                     for i in range(c)]).astype(np.float32)


def _status(n, seed=1):
    """A BioSemi Status channel: trigger codes in the low 16 bits over a
    constant high word, one active at sample 0, two without a gap."""
    s = np.full(n, 0x3F0000, np.float64)
    s[:40] += 5
    rng = np.random.default_rng(seed)
    for i, start in enumerate(np.sort(rng.choice(np.arange(100, n - 200, 150),
                                                 12, replace=False))):
        s[start:start + 60] += 1 + i % 3
    s[n - 150:n - 100] += 7
    s[n - 100:n - 60] += 3
    return s


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _same_bytes(*paths):
    blobs = [open(p, "rb").read() for p in paths]
    return all(b == blobs[0] for b in blobs[1:])


# -- BDF ------------------------------------------------------------------

@pytest.mark.parametrize("record_duration,n", [(1.0, 5000), (0.5, 4321)])
def test_write_bdf_is_byte_identical(tmp_path, record_duration, n):
    x = np.vstack([_data(3, n), _status(n)[None]])
    names = ["Fp1", "Cz", "O2", "Status"]
    jp, tp = str(tmp_path / "j.bdf"), str(tmp_path / "t.bdf")
    jbdf.write_bdf(jp, x, SFREQ, ch_names=names,
                   record_duration=record_duration)
    tbdf.write_bdf(tp, x, SFREQ, ch_names=names,
                   record_duration=record_duration)
    assert _same_bytes(jp, tp)


@pytest.fixture(scope="module")
def bdf_file(tmp_path_factory):
    """A 4-channel BDF with a Status channel, written by the JAX package
    (the bytes are the port's too: test_write_bdf_is_byte_identical)."""
    n = 4321                                   # a partial last record
    x = np.vstack([_data(4, n, seed=2), _status(n)[None]])
    p = str(tmp_path_factory.mktemp("bdf") / "rec.bdf")
    jbdf.write_bdf(p, x, SFREQ,
                   ch_names=["A1", "A2", "A3", "A4", "Status"],
                   record_duration=0.5)
    return p


@pytest.mark.parametrize("picks", [None, ["A3", "A1"], [4, 0, 2]])
def test_bdf_reads_equal(bdf_file, picks):
    jr, tr = jbdf.BDFReader(bdf_file), tbdf.BDFReader(bdf_file)
    assert (tr.ch_names, tr.units, tr.sfreq, tr.n_samples, tr.markers) == (
        jr.ch_names, jr.units, jr.sfreq, jr.n_samples, jr.markers)
    want = jr.get_data(picks)
    got = tr.get_data(picks)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)
    starts = [-300, 0, 777, 2000, tr.n_samples - 100, tr.n_samples + 50]
    for window, halo in [(256, 64), (1000, 0), (512, 300)]:
        got = tr.gather(starts, window, halo, picks)
        assert np.array_equal(got, jr.gather(starts, window, halo, picks))
    if picks is not None and all(isinstance(p, str) for p in picks):
        tp, jp = tr.pick(picks), jr.pick(picks)
        assert (tp.ch_names, tp.sfreq, tp.n_samples) == (
            jp.ch_names, jp.sfreq, jp.n_samples)
        assert np.array_equal(tp.gather([5, 900], 300, 40),
                              jp.gather([5, 900], 300, 40))


def test_bdf_port_file_read_by_jax(tmp_path):
    x = np.vstack([_data(2, 3000, seed=4), _status(3000, seed=5)[None]])
    p = str(tmp_path / "t.bdf")
    tbdf.write_bdf(p, x, SFREQ, ch_names=["a", "b", "Status"])
    jr, tr = jbdf.BDFReader(p), tbdf.BDFReader(p)
    assert np.array_equal(jr.get_data(), tr.get_data())
    status = tr.get_data(["Status"])[0]
    assert tbdf.status_events(status) == jbdf.status_events(status)
    assert tbdf.status_events(status, mask=0xFF) == jbdf.status_events(
        status, mask=0xFF)
    assert tbdf.status_events(status)[0] == (0, "Status", "5")


def test_bdf_decode24_equals_jax():
    vals = np.random.default_rng(3).integers(-(1 << 23), 1 << 23, 999)
    vals[:4] = [0, -1, (1 << 23) - 1, -(1 << 23)]
    u = np.where(vals < 0, vals + (1 << 24), vals)
    raw = np.stack([u & 0xFF, (u >> 8) & 0xFF, (u >> 16) & 0xFF],
                   -1).astype(np.uint8).reshape(-1)
    got = tbdf._decode24(raw)
    assert np.array_equal(got, jbdf._decode24(raw))
    assert np.array_equal(got, vals)


def _mixed_rate_bdf(path):
    """Two signals at 100 and 50 samples a 1 s record, 3 records, written
    field by field as ``write_bdf`` lays out its header."""
    ns, n_rec = [100, 50], 3

    def f(text, width):
        b = str(text).encode("latin-1")[:width]
        return b + b" " * (width - len(b))

    head = b"\xffBIOSEMI" + b"".join([
        f("X", 80), f("X", 80), f("01.01.00", 8), f("00.00.00", 8),
        f(256 * 3, 8), f("24BIT", 44), f(n_rec, 8), f(1, 8), f(2, 4)])
    fields = [(["fast", "slow"], 16), (["", ""], 80), (["uV", "uV"], 8),
              (["-100", "-50"], 8), (["100", "50"], 8),
              (["-8388608"] * 2, 8), (["8388607"] * 2, 8), (["", ""], 80),
              ([str(v) for v in ns], 8), (["", ""], 32)]
    sig = b"".join(f(v, w) for vals, w in fields for v in vals)
    rng = np.random.default_rng(9)
    digital = rng.integers(-(1 << 23), 1 << 23, n_rec * sum(ns))
    u = np.where(digital < 0, digital + (1 << 24), digital)
    body = np.stack([u & 0xFF, (u >> 8) & 0xFF, (u >> 16) & 0xFF],
                    -1).astype(np.uint8).tobytes()
    with open(path, "wb") as out:
        out.write(head + sig + body)


def test_bdf_mixed_rates_and_errors(tmp_path):
    p = str(tmp_path / "mixed.bdf")
    _mixed_rate_bdf(p)
    jr, tr = jbdf.BDFReader(p), tbdf.BDFReader(p)
    for picks in (["fast"], ["slow"]):
        assert np.array_equal(tr.get_data(picks), jr.get_data(picks))
        assert np.array_equal(tr.gather([-20, 60], 70, 10, picks),
                              jr.gather([-20, 60], 70, 10, picks))
        assert tr.pick(picks).sfreq == jr.pick(picks).sfreq
        assert tr.pick(picks).n_samples == jr.pick(picks).n_samples
    for call in (lambda r: r.sfreq, lambda r: r.get_data(),
                 lambda r: r.get_data(["nope"]), lambda r: r.get_data([7])):
        with pytest.raises(ValueError) as want:
            call(jr)
        with pytest.raises(ValueError) as got:
            call(tr)
        assert str(got.value) == str(want.value)
    edf = str(tmp_path / "x.edf")
    from ninwavelets_tpu.io.edf import write_edf
    write_edf(edf, np.zeros((1, 500), np.float32), SFREQ)
    with pytest.raises(ValueError, match="not a BDF"):
        tbdf.BDFReader(edf)
    with pytest.raises(ValueError, match="8-char"):
        tbdf.write_bdf(str(tmp_path / "x.bdf"), np.zeros((1, 200)), 300.0,
                       record_duration=2.0 / 3.0)


def test_bdf_raw_surface(bdf_file):
    jraw = jbdf.BDFRaw(bdf_file, picks=["A2", "Status"])
    traw = tbdf.BDFRaw(bdf_file, picks=["A2", "Status"])
    assert (traw.ch_names, traw.info) == (jraw.ch_names, jraw.info)
    assert np.array_equal(traw.get_data(), jraw.get_data())


# -- BrainVision ----------------------------------------------------------

MARKERS = [(100, "Stimulus", "S  1"), (900, "Stimulus", "S  2"),
           (1450, "Bad Interval", "", 300),
           (2000, "Comment", "note, with comma", 5),
           (2600, "Response", "R  1")]


@pytest.mark.parametrize("orientation,binary_format,resolution", [
    ("MULTIPLEXED", "IEEE_FLOAT_32", 1.0),
    ("VECTORIZED", "IEEE_FLOAT_32", 0.5),
    ("MULTIPLEXED", "INT_16", 0.1),
    ("VECTORIZED", "INT_16", 0.1)])
def test_write_brainvision_is_byte_identical_and_reads_equal(
        tmp_path, orientation, binary_format, resolution):
    x = _data(3, 3001, seed=6)
    names = ["Fz", "C,z", "Pz"]                # a comma in a name
    files = {}
    for tag, mod in (("j", jbv), ("t", tbv)):
        os.makedirs(tmp_path / tag)
        p = str(tmp_path / tag / "rec.vhdr")
        mod.write_brainvision(p, x, SFREQ, ch_names=names,
                              orientation=orientation,
                              binary_format=binary_format,
                              resolution=resolution, markers=MARKERS)
        files[tag] = p
    for ext in (".vhdr", ".eeg", ".vmrk"):
        assert _same_bytes(*(os.path.splitext(p)[0] + ext
                             for p in files.values())), ext
    # each package reads the other's file
    for path in files.values():
        jr, tr = jbv.BVReader(path), tbv.BVReader(path)
        assert (tr.ch_names, tr.units, tr.sfreq, tr.n_samples,
                tr.orientation) == (jr.ch_names, jr.units, jr.sfreq,
                                    jr.n_samples, jr.orientation)
        assert tr.markers == jr.markers
        assert tr._marker_spans == jr._marker_spans
        assert tr.read_annotations() == jr.read_annotations()
        for picks in (None, ["Pz", "Fz"]):
            assert np.array_equal(tr.get_data(picks), jr.get_data(picks))
            starts = [-200, 0, 1234, 2900]
            for window, halo in [(256, 64), (700, 0)]:
                assert np.array_equal(
                    tr.gather(starts, window, halo, picks),
                    jr.gather(starts, window, halo, picks))
    vmrk = os.path.splitext(files["t"])[0] + ".vmrk"
    assert tbv.read_markers(vmrk) == jbv.read_markers(vmrk)
    assert tbv.read_marker_spans(vmrk) == jbv.read_marker_spans(vmrk)


def test_brainvision_vendor_header_and_bad_markers(tmp_path):
    """A vendor-style header with a free-form [Comment] section, and
    markers with commas, a corrupt position and a corrupt size."""
    x = _data(2, 2000, seed=7)
    p = str(tmp_path / "rec.vhdr")
    tbv.write_brainvision(p, x, SFREQ, ch_names=["Fz", "Cz"],
                          markers=[(500, "Comment", "bad, electrode"),
                                   (900, "Stimulus", "S  1")])
    with open(p, "a", encoding="utf-8") as f:
        f.write("\n[Comment]\n"
                "A m p l i f i e r  S e t u p\n"
                "=============================\n"
                "Chn Name Res % of full scale\n"
                "1 Fz 0.1 100%\n")
    vmrk = str(tmp_path / "rec.vmrk")
    with open(vmrk, "a", encoding="utf-8") as f:
        f.write("Mk3=Stimulus,oops,notanint,1,0\n"
                "Mk4=Stimulus,S  3,1200,nosize,0\n")
    jr, tr = jbv.BVReader(p), tbv.BVReader(p)
    assert tr.ch_names == jr.ch_names == ["Fz", "Cz"]
    assert np.array_equal(tr.get_data(), jr.get_data())
    assert tr.markers == jr.markers == [
        (500, "Comment", "bad, electrode"), (900, "Stimulus", "S  1"),
        (1199, "Stimulus", "S  3")]
    assert tbv.read_marker_spans(vmrk) == jbv.read_marker_spans(vmrk)


def test_brainvision_errors_and_source(tmp_path):
    x = _data(2, 1500, seed=8)
    p = str(tmp_path / "rec.vhdr")
    tbv.write_brainvision(p, x, SFREQ, ch_names=["a", "b"])
    for mod in (jbv, tbv):
        assert mod.BVReader(p).markers == []
    calls = [
        lambda m: m.BVReader(p).get_data(["zz"]),
        lambda m: m.BVRaw(p, picks=["zz"]),
        lambda m: m.write_brainvision(str(tmp_path / "o.vhdr"), x, SFREQ,
                                      orientation="DIAGONAL"),
        lambda m: m.write_brainvision(str(tmp_path / "o.vhdr"), x, SFREQ,
                                      binary_format="INT_64"),
        lambda m: m.write_brainvision(str(tmp_path / "o.vhdr"), x, SFREQ,
                                      ch_names=["a"])]
    for call in calls:
        with pytest.raises(ValueError) as want:
            call(jbv)
        with pytest.raises(ValueError) as got:
            call(tbv)
        assert str(got.value) == str(want.value)
    bad = str(tmp_path / "bad.vhdr")
    with open(bad, "w") as f:
        f.write("[Binary Infos]\nBinaryFormat=INT_16\n")
    with pytest.raises(ValueError, match="Common Infos"):
        tbv.BVReader(bad)
    src = tbv.BVSource(p, picks=["b"])
    jsrc = jbv.BVSource(p, picks=["b"])
    assert (src.sfreq, src.n_samples, src.lead) == (
        jsrc.sfreq, jsrc.n_samples, jsrc.lead)
    assert np.array_equal(src.gather([0, 700], 512, 128),
                          jsrc.gather([0, 700], 512, 128))
    assert isinstance(src, nt.io.EDFSource)


# -- the adapter entry points ----------------------------------------------

FREQS = [12.0, 25.0, 40.0]


def _open(kind, path, module, picks=None):
    if module is nw:
        w = nw.Morse(SFREQ)
    else:
        w = nt.Morse(SFREQ, device="cpu")
    opener = (module.RawWavelet.from_bdf if kind == "bdf"
              else module.RawWavelet.from_brainvision)
    return opener(path, w, picks=picks, window=1024)


@pytest.mark.parametrize("kind", ["bdf", "brainvision"])
def test_file_power_matches_jax(tmp_path, kind):
    x = _data(3, 6000, seed=10)
    if kind == "bdf":
        p = str(tmp_path / "rec.bdf")
        tbdf.write_bdf(p, np.vstack([x, _status(6000)[None]]), SFREQ,
                       ch_names=["a", "b", "c", "Status"])
    else:
        p = str(tmp_path / "rec.vhdr")
        tbv.write_brainvision(p, x, SFREQ, ch_names=["a", "b", "c"],
                              markers=MARKERS)
    picks = ["c", "a"]
    trw = _open(kind, p, nt, picks)
    assert trw._file_source() is not None       # streamed off the file
    got = trw.power(FREQS)
    want = np.asarray(_open(kind, p, nw, picks).power(FREQS))
    assert got.device.type == "cpu" and got.shape == (2, 3, 6000)
    assert _rel(got, want) <= RTOL
    # the streamed plane equals the in-memory recording's
    raw = type("R", (), {"info": {"sfreq": SFREQ}, "ch_names": picks,
                         "get_data": lambda s: trw.raw.get_data()})()
    mem = nt.RawWavelet(raw, nt.Morse(SFREQ, device="cpu"), window=1024)
    assert mem._file_source() is None
    assert _rel(got, mem.power(FREQS)) <= RTOL
    ch = trw.power_channel("a", FREQS)
    assert _rel(ch, want[1]) <= RTOL


@pytest.fixture(scope="module")
def marker_file(tmp_path_factory):
    """A BrainVision recording with "S  1" / "S  2" markers every 0.4 s, an
    evoked 10 Hz burst after each "S  1", a bad interval and a comment."""
    n, every = 12000, 200
    rng = np.random.default_rng(11)
    x = (0.5 * rng.standard_normal((3, n))).astype(np.float32)
    t = np.arange(100) / SFREQ
    burst = (np.sin(2 * np.pi * 10 * t) * np.hanning(100)).astype(np.float32)
    marks = []
    for i, s in enumerate(range(300, n - 300, every)):
        desc = "S  1" if i % 2 == 0 else "S  2"
        marks.append((s, "Stimulus", desc))
        if desc == "S  1":
            x[:2, s + 50:s + 150] += 2.0 * burst
    marks += [(4000, "Bad Interval", "", 700), (8000, "Comment", "x, y")]
    p = str(tmp_path_factory.mktemp("bv") / "rec.vhdr")
    tbv.write_brainvision(p, x, SFREQ, ch_names=["O1", "O2", "Fz"],
                          markers=sorted(marks))
    return p


@pytest.mark.parametrize("description,kind", [("S  1", None),
                                              (None, "Stimulus")])
def test_epochs_from_markers_match_jax(marker_file, description, kind):
    tew = _open("brainvision", marker_file, nt).epochs_from_markers(
        -0.1, 0.41, description=description, kind=kind)
    jew = _open("brainvision", marker_file, nw).epochs_from_markers(
        -0.1, 0.41, description=description, kind=kind)
    host = tew._host_data()
    assert host.shape[-1] == 256                # a power of two: K1/K2
    assert np.array_equal(host, jew._host_data())
    assert np.array_equal(tew.event_codes, np.asarray(jew.event_codes))
    assert tew.event_codes.dtype.kind == "U"    # strings stay numpy
    freqs = np.arange(6.0, 40.0, 2.0)
    got = tew.power_all(freqs)
    assert _rel(got, jew.power_all(freqs)) <= EPOCH_RTOL
    coeffs = tcwt.cwt_from_bank(tew._all_data(), tew.wavelet._bank, False)
    assert_itc_close(tew.itc_all(freqs).numpy(),
                     np.asarray(jew.itc_all(freqs)), coeffs.numpy())
    if description is None:
        groups = tew.split()
        assert sorted(groups) == ["S  1", "S  2"]
        assert sum(g._host_data().shape[0] for g in groups.values()) == \
            host.shape[0]


def test_reject_annotations_on_brainvision(marker_file):
    trw = _open("brainvision", marker_file, nt)
    jrw = _open("brainvision", marker_file, nw)
    assert trw._bad_spans("bad") == jrw._bad_spans("bad") == [(8.0, 1.4)]
    ev = np.arange(300, 11700, 200)
    tew = trw.epochs(ev, -0.1, 0.2, reject_annotations="bad",
                     codes=np.arange(ev.size))
    jew = jrw.epochs(ev, -0.1, 0.2, reject_annotations="bad",
                     codes=np.arange(ev.size))
    assert np.array_equal(tew._host_data(), jew._host_data())
    assert np.array_equal(tew.event_codes, jew.event_codes)
    assert tew._host_data().shape[0] == ev.size - 5   # 5 overlap the span
    tew = trw.epochs_from_markers(-0.1, 0.2, kind="Stimulus")
    assert tew._host_data().shape[0] == 57


def test_epochs_from_markers_errors(marker_file, tmp_path):
    cases = [(lambda m: _open("brainvision", marker_file, m)
              .epochs_from_markers(-0.1, 0.4, description="nope"))]
    x = _data(2, 3000)
    p = str(tmp_path / "plain.bdf")
    tbdf.write_bdf(p, x, SFREQ)
    cases.append(lambda m: _open("bdf", p, m).epochs_from_markers(0, 0.1))
    cases.append(lambda m: m.RawWavelet(
        type("R", (), {"info": {"sfreq": SFREQ}, "ch_names": ["a", "b"],
                       "get_data": lambda s: x})(),
        m.Morse(SFREQ) if m is nw else m.Morse(SFREQ, device="cpu"))
        .epochs_from_markers(0, 0.1))
    cases.append(lambda m: _open("bdf", p, m).epochs(
        np.array([500]), 0, 0.1, reject_annotations="bad"))
    for call in cases:
        with pytest.raises(ValueError) as want:
            call(nw)
        with pytest.raises(ValueError) as got:
            call(nt)
        assert str(got.value) == str(want.value)
