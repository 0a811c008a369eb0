"""The adapters' float32 host snapshot of ``get_data()``
(``utils.mne_adapter._snapshot``), on the CPU and, marked ``card``, on a
CUDA card, where those tests skip without one.

Gates, each with its reason:

* for float64 in C and Fortran order, a negative-stride view, float32 and
  int16, the snapshot of both adapters equals
  ``np.asarray(get_data()).astype(np.float32)`` bit for bit, so every
  plane downstream is the one the numpy cast gave; ``power_itc_all`` and
  ``RawWavelet.power`` equal the same transforms of the numpy-cast block;
* ``invalidate()`` and a fingerprint change drop the snapshot with the
  device block made from it;
* for the CPU device nothing is asked pinned, for a CUDA device it is;
* on the card: the snapshot is pinned; a freed block goes to the next
  adapter of its shape; the device block equals the snapshot; a block
  whose copy is still in flight is not handed on.

This file imports neither JAX nor the JAX package, so that the card tests
run on a machine without it (``--noconftest``; README).
"""
import numpy as np
import pytest
import torch

import ninwavelets_tpu_torch as nt
from ninwavelets_tpu_torch.ops.fused import power_itc_auto
from ninwavelets_tpu_torch.ops.signal_utils import pad_to
from ninwavelets_tpu_torch.utils import mne_adapter

from torch_threads import one_torch_thread  # noqa: F401

SFREQ = 256.0
FREQS = np.array([5.0, 10.0, 15.0])
KINDS = ["f64_c", "f64_f", "f64_neg_stride", "f32", "i16"]


def _data(kind, shape, seed=0):
    """A ``get_data()`` block of ``kind``: about 10 uV in volts as MNE
    hands EEG, or int16 counts."""
    x = np.random.default_rng(seed).standard_normal(shape) * 1e-5
    if kind == "f64_f":
        return np.asfortranarray(x)
    if kind == "f64_neg_stride":
        return x[..., ::-1]
    if kind == "f32":
        return x.astype(np.float32)
    if kind == "i16":
        return (x * 3e8).astype(np.int16)
    return x


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


class _Raw:
    def __init__(self, data):
        self._data = data
        self.info = {"sfreq": SFREQ}
        self.ch_names = [f"c{i}" for i in range(data.shape[0])]

    def get_data(self):
        return self._data


@pytest.fixture
def pins(monkeypatch):
    """The ``pin_memory`` of each ``torch.empty`` the adapters ask for; a
    pinned request is served unpinned, so that it runs without CUDA."""
    asked = []
    empty = torch.empty

    def spy(*args, **kw):
        if "pin_memory" in kw:
            asked.append(kw.pop("pin_memory"))
        return empty(*args, **kw)

    monkeypatch.setattr(mne_adapter.torch, "empty", spy)
    return asked


@pytest.mark.parametrize("kind", KINDS)
def test_snapshot_is_the_numpy_cast(kind, pins):
    x = _data(kind, (4, 2, 256))
    want = np.asarray(x).astype(np.float32)
    ew = nt.EpochsWavelet(nt.ArrayEpochs(x, SFREQ),
                          nt.Morse(SFREQ, device="cpu"))
    host = ew._host_data()
    assert isinstance(host, np.ndarray) and host.dtype == np.float32
    assert np.array_equal(_bits(host), _bits(want))
    assert pins == [False]
    assert not ew._host.is_pinned()

    # The planes are those of the numpy-cast block, laid out in C order
    # as the snapshot is whatever the order of ``get_data()``.
    assert ew._host.is_contiguous()
    power, itc = ew.power_itc_all(FREQS)
    block = torch.from_numpy(np.ascontiguousarray(want))
    p_want, i_want = power_itc_auto(block, pad_to(ew.wavelet._bank, block),
                                    interpolate=ew.wavelet.interpolate)
    assert torch.equal(power, p_want) and torch.equal(itc, i_want)

    # invalidate() drops the snapshot and its device block; so does a
    # change the fingerprint sees (here, the epoch count).
    x[...] = _data(kind, x.shape, seed=1)
    ew.invalidate()
    assert not hasattr(ew, "_host") and not hasattr(ew, "_data")
    assert np.array_equal(_bits(ew._all_data().numpy()),
                          _bits(np.asarray(x).astype(np.float32)))
    ew.epochs._data = _data(kind, (3, 2, 256), seed=2)
    assert ew._all_data().shape == (3, 2, 256)
    assert np.array_equal(_bits(ew._host_data()),
                          _bits(ew.epochs._data.astype(np.float32)))

    # RawWavelet's snapshot is the same helper.
    r = _data(kind, (2, 3 * 512))
    rw = nt.RawWavelet(_Raw(r), nt.Morse(SFREQ, device="cpu"), window=512,
                       batch=1)
    want = np.ascontiguousarray(np.asarray(r).astype(np.float32))
    assert np.array_equal(_bits(rw._host_data()), _bits(want))
    assert torch.equal(rw.power(FREQS),
                       rw._stream_for(FREQS).power_device(want))
    rw.invalidate()
    assert not hasattr(rw, "_host")
    assert pins == [False] * 4


def test_a_cuda_device_asks_for_pinned_memory(pins):
    x = _data("f64_c", (2, 3, 16))
    got = mne_adapter._snapshot(x, torch.device("cuda"))
    assert pins == [True]
    assert np.array_equal(_bits(got.numpy()), _bits(x.astype(np.float32)))


@pytest.fixture
def card():
    """Skips the test where no CUDA card is visible."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _epochs(data, device):
    return nt.EpochsWavelet(nt.ArrayEpochs(data, SFREQ),
                            nt.Morse(SFREQ, device=device))


@pytest.mark.card
def test_card_snapshot_is_pinned_reused_and_copied(card):
    x = _data("f64_c", (20, 8, 2048))
    a = _epochs(x, card)
    host = a._host_data()
    assert a._host.is_pinned()
    block = a._all_data()
    torch.cuda.synchronize()
    assert np.array_equal(_bits(block.cpu().numpy()), _bits(host))
    ptr = a._host.data_ptr()
    del a, host, block
    b = _epochs(_data("f64_c", x.shape, seed=1), card)
    b._host_data()
    assert b._host.is_pinned() and b._host.data_ptr() == ptr


@pytest.mark.card
def test_card_block_in_flight_is_not_handed_on(card):
    x = _data("f64_c", (20, 8, 2048))
    a = _epochs(x, card)
    a._host_data()
    torch.cuda._sleep(200_000_000)       # the copy queues behind this
    block = a._all_data()
    ptr = a._host.data_ptr()
    del a
    b = _epochs(_data("f64_c", x.shape, seed=1), card)
    b._host_data()
    assert b._host.data_ptr() != ptr
    torch.cuda.synchronize()
    assert np.array_equal(_bits(block.cpu().numpy()),
                          _bits(x.astype(np.float32)))
