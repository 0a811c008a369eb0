"""The port's own copy of the long-recording input pipeline
(``ninwavelets_tpu_torch.io``) against its numpy oracle and the JAX
package's ``io``: the native gathers bit for bit, EDF files written by one
package read identically by the other, and the prefetching batch iterator.
"""
import numpy as np
import pytest

from ninwavelets_tpu.io import edf as jedf
from ninwavelets_tpu.io import stream as jstream
from ninwavelets_tpu_torch.io import (ArraySource, EDFReader, EDFSource,
                                      edf, iter_ext_batches, native,
                                      native_available, write_edf)

from torch_threads import one_torch_thread  # noqa: F401

SFREQ = 250.0


def _data(c=3, n=2600, seed=0):
    return (40.0 * np.random.default_rng(seed).standard_normal((c, n))
            ).astype(np.float32)


def test_native_library_builds_in_the_ports_own_directory():
    assert native_available()
    assert native.BUILD_DIR.endswith(
        "ninwavelets_tpu_torch/io/_native/_build")


@pytest.mark.parametrize("window,halo", [(256, 0), (256, 100), (1000, 700)])
def test_f32_gather_bit_identical_to_oracle(window, halo):
    data = _data()
    starts = np.array([0, 256, 1024, 2500, 2599, -300, 5000], np.int64)
    got = native.f32_gather(data, starts, window, halo)
    want = native._f32_gather_np(data, starts, window, halo)
    assert got.shape == (7, 3, window + 2 * halo)
    np.testing.assert_array_equal(got, want)


@pytest.fixture
def edf_file(tmp_path):
    path = str(tmp_path / "rec.edf")
    data = _data(4, 2600, seed=1)
    jedf.write_edf(path, data, SFREQ, ch_names=["Fz", "Cz", "Pz", "Oz"],
                   record_duration=2.0,
                   annotations=[(1.5, 0.5, "stim"), (7.25, 0.0, "resp")])
    return path, data


@pytest.mark.parametrize("window,halo", [(256, 64), (500, 300)])
def test_edf_gather_bit_identical_to_oracle(edf_file, window, halo):
    r = EDFReader(edf_file[0])
    starts = np.array([0, 500, 2400, 2999], np.int64)
    idx = r._indices([2, 0])
    args = (r._mm, r._rec_stride, r._ch_off_all[idx], r._scale_all[idx],
            r._dc_all[idx], r._ns0)
    got = native.edf_gather(*args, starts, window, halo, r.n_samples)
    want = native._edf_gather_np(*args, starts, window, halo, r.n_samples)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        native.edf_load(*args, r.n_samples),
        native._edf_load_np(*args, r.n_samples))


def test_reads_a_file_written_by_jax(edf_file):
    path, data = edf_file
    got, want = EDFReader(path), jedf.EDFReader(path)
    assert got.ch_names == want.ch_names == ["Fz", "Cz", "Pz", "Oz"]
    assert (got.sfreq, got.n_samples) == (want.sfreq, want.n_samples)
    assert got.n_samples == 3000            # padded to whole 2 s records
    np.testing.assert_array_equal(got.get_data(), want.get_data())
    np.testing.assert_array_equal(got.get_data(["Pz", 0]),
                                  want.get_data(["Pz", 0]))
    starts = [0, 700, 2900]
    np.testing.assert_array_equal(got.gather(starts, 256, 128),
                                  want.gather(starts, 256, 128))
    assert got.read_annotations() == want.read_annotations()
    assert got.markers == want.markers
    # 16-bit quantization: within (max - min) / 65535 of the data.
    span = data.max(1) - data.min(1)
    err = np.abs(got.get_data()[:, :2600] - data).max(1)
    assert np.all(err <= span / 65535 * 1.01)


def test_jax_reads_a_file_written_by_the_port(tmp_path):
    data = _data(2, 1000, seed=2)
    kw = dict(ch_names=["C3", "C4"], record_duration=1.0,
              annotations=[(0.5, 0.0, "go")])
    ours, theirs = str(tmp_path / "a.edf"), str(tmp_path / "b.edf")
    write_edf(ours, data, SFREQ, **kw)
    jedf.write_edf(theirs, data, SFREQ, **kw)
    with open(ours, "rb") as fa, open(theirs, "rb") as fb:
        assert fa.read() == fb.read()
    np.testing.assert_array_equal(jedf.EDFReader(ours).get_data(),
                                  EDFReader(ours).get_data())


def test_edf_pick_and_raw(edf_file):
    path, _ = edf_file
    r = EDFReader(path)
    pick = r.pick(["Oz", "Fz"])
    assert pick.ch_names == ["Oz", "Fz"] and pick.sfreq == SFREQ
    np.testing.assert_array_equal(pick.get_data(), r.get_data()[[3, 0]])
    raw = edf.EDFRaw(path, picks=["Cz"])
    assert raw.ch_names == ["Cz"] and raw.info == {"sfreq": SFREQ}
    np.testing.assert_array_equal(raw.get_data(), r.get_data()[[1]])
    with pytest.raises(KeyError):
        r.get_data(["T7"])


@pytest.mark.parametrize("prefetch", [False, True])
def test_iter_ext_batches_matches_jax(edf_file, prefetch):
    """Full batch shape with zero rows for the ragged tail, the same
    groups and bits as the JAX package's iterator."""
    path, _ = edf_file
    for ours, theirs in [(EDFSource(path), jstream.EDFSource(path)),
                         (EDFSource(EDFReader(path), picks=["Cz"]),
                          jstream.EDFSource(jedf.EDFReader(path),
                                            picks=["Cz"])),
                         (ArraySource(_data()), jstream.ArraySource(_data()))]:
        got = list(iter_ext_batches(ours, 512, 128, 4, prefetch=prefetch))
        want = list(jstream.iter_ext_batches(theirs, 512, 128, 4,
                                             prefetch=prefetch))
        assert [g for g, _ in got] == [g for g, _ in want]
        for (_, a), (_, b) in zip(got, want):
            np.testing.assert_array_equal(a, b)
        last_group, last = got[-1]
        assert last.shape[0] == 4
        assert not last[len(last_group):].any()


def test_edf_source_refuses_to_repick_a_pick(edf_file):
    r = EDFReader(edf_file[0])
    with pytest.raises(ValueError, match="re-pick"):
        EDFSource(r.pick(["Cz"]), picks=["Cz"])
