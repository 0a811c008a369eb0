"""The port's long-recording path against the JAX package: the per-signal
power (``fused_power_from_bank``, K4's plain version here), the halo
geometry, ``StreamingCWT``, ``OnlineCWT`` and ``RawWavelet``.

The tensors lie on the CPU, so the port runs its plain versions; the JAX
package's fused path runs its Pallas kernel with ``interpret=True``.  The
CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py``.  Gates: max|d| / max|ref| <= 1e-5 between the packages
(two float32 FFT libraries, ~1e-7 apart), bit-identity where one package
is compared with itself.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ninwavelets_tpu as nw
from ninwavelets_tpu.ops import fused as jfused
from ninwavelets_tpu.ops.bank import make_fft_bank as jbank
from ninwavelets_tpu.parallel import OnlineCWT as JOnline
from ninwavelets_tpu.parallel import StreamingCWT as JStreaming
from ninwavelets_tpu.parallel import chunked as jchunked
from ninwavelets_tpu.io.edf import write_edf as jwrite_edf
import ninwavelets_tpu_torch as nt
from ninwavelets_tpu_torch import kernels
from ninwavelets_tpu_torch.convert import wavelet_from_jax
from ninwavelets_tpu_torch.ops import cwt as tcwt
from ninwavelets_tpu_torch.ops import fused as tfused
from ninwavelets_tpu_torch.parallel import (OnlineCWT, StreamingCWT,
                                            chunk_bank, halo_samples,
                                            pow2_halo)

from torch_threads import one_torch_thread  # noqa: F401

SFREQ = 1000.0
RTOL = 1e-5
FREQS = np.arange(25.0, 80.0, 5.0, dtype=np.float32)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _pair(cls="Morse", **kw):
    jw = getattr(nw, cls)(SFREQ, **kw)
    return jw, wavelet_from_jax(jw, device="cpu")


def _recording(shape, seed=0):
    """Seeded noise plus a 60 Hz tone: (..., N) float32."""
    rng = np.random.default_rng(seed)
    t = np.arange(shape[-1]) / SFREQ
    return (np.sin(2 * np.pi * 60.0 * t)
            + 0.5 * rng.standard_normal(shape)).astype(np.float32)


# -- K4's plain version against the Pallas kernel ---------------------------

@pytest.mark.parametrize("lead", [(3,), (2, 3)])
@pytest.mark.parametrize("n", [1024, 2048])
@pytest.mark.parametrize("interpolate", [True, False])
def test_power_each_matches_pallas(lead, n, interpolate):
    bank = np.array(jbank(nw.Morse(SFREQ)._wdef(), jnp.arange(2.0, 9.0), n,
                          SFREQ, interpolate), np.float32)
    sig = np.random.default_rng(n).standard_normal(lead + (n,)).astype(
        np.float32)
    want = jfused.fused_power_from_bank(jnp.asarray(sig), jnp.asarray(bank),
                                        interpolate, interpret=True,
                                        precision="exact")
    got = tfused.fused_power_from_bank(torch.from_numpy(sig),
                                       torch.from_numpy(bank), interpolate)
    assert got.shape == lead + (7, n) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= RTOL


def test_power_each_on_cpu_is_the_plain_path():
    sig = torch.from_numpy(_recording((2, 3, 1024)))
    bank = nt.Morse(SFREQ, device="cpu").make_fft_wavelets(FREQS, 1.024)
    want = tcwt.power_from_bank(sig, bank, True)
    before = dict(kernels.launches)
    torch.testing.assert_close(tfused.fused_power_from_bank(sig, bank, True),
                               want, rtol=0, atol=0)
    torch.testing.assert_close(tfused.power_auto(sig, bank,
                                                 interpolate=True),
                               want, rtol=0, atol=0)
    assert tfused.fused_power_from_bank(sig[0, 0], bank).shape == (11, 1024)
    assert kernels.launches == before


def test_power_each_off_the_cpu_launches_or_raises():
    """A tensor off the CPU never takes the plain path: it goes to the
    launcher (which wants CUDA), and an input that requires grad raises
    first, since the kernel has no derivative.  ``meta`` tensors stand in
    for the card here."""
    bank = torch.ones(3, 1024, device="meta")
    x = torch.empty((2, 5, 1024), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tfused.fused_power_from_bank(x, bank, True)
    with pytest.raises(RuntimeError, match="no derivative"):
        tfused.fused_power_from_bank(x.requires_grad_(), bank, True)
    with pytest.raises(ValueError, match="supports"):
        tfused.fused_power_from_bank(x[..., :1000].detach(), bank[:, :1000])


def test_power_auto_sends_complex_banks_to_the_plain_path():
    sig = torch.from_numpy(_recording((3, 1024)))
    bank = nt.MexicanHat(SFREQ, device="cpu").make_fft_wavelets(FREQS, 1.024)
    assert bank.is_complex()
    assert not tfused.route("power_each", sig.reshape(-1, 1, 1024),
                            bank).takes
    torch.testing.assert_close(tfused.power_auto(sig, bank),
                               tcwt.power_from_bank(sig, bank))


def test_power_each_has_an_epilogue_and_a_counter():
    """"power_each" has its own launcher and entry point, not a code of
    ``ninw_fused_cwt``, and its own counter."""
    assert "power_each" not in kernels.EPILOGUES
    assert "ninw_fused_power_each" in kernels.SIGNATURES
    assert "power_each" in kernels.launches
    with pytest.raises(ValueError, match="CUDA"):
        kernels.fused_power_each(
            torch.zeros((4, 1, 513), dtype=torch.complex64),
            torch.zeros(3, 1024), 512, torch.zeros((4, 1, 3, 1024)),
            (0, 1024))


# -- halo geometry ------------------------------------------------------------

@pytest.mark.parametrize("cls,kw,freq,want", [
    ("Morse", {}, 1.0, 4859), ("Morse", {}, 2.0, 2430),
    ("Morse", {}, 4.0, 1215),
    ("Morlet", {}, 2.0, None), ("Morlet", {}, 4.0, None),
    ("Shannon", {}, 1.0, None), ("Shannon", {}, 2.0, None),
    ("Shannon", {}, 4.0, None),
    ("Morse", dict(b=5.0, r=2.0), 3.0, None),
])
def test_halo_samples_equal_jax(cls, kw, freq, want):
    jw, tw = _pair(cls, **kw)
    got = halo_samples(tw._wdef(), freq, SFREQ)
    assert got == jchunked.halo_samples(jw._wdef(), freq, SFREQ)
    if want is not None:
        assert got == want


def test_halo_samples_morlet_1hz_within_one_sample():
    """XLA's and torch's float32 exp differ by ulps, which moves the 1 Hz
    Morlet envelope's 1e-4 crossing by one sample (4787 against 4786)."""
    jw, tw = _pair("Morlet")
    assert abs(halo_samples(tw._wdef(), 1.0, SFREQ)
               - jchunked.halo_samples(jw._wdef(), 1.0, SFREQ)) <= 1


@pytest.mark.parametrize("cls", ["MexicanHat", "Haar"])
def test_halo_samples_rejects_time_domain_families(cls):
    w = getattr(nt, cls)(SFREQ, device="cpu")
    with pytest.raises(ValueError, match="Reverse/Both"):
        halo_samples(w._wdef(), 2.0, SFREQ)


@pytest.mark.parametrize("window,min_halo", [
    (1024, 0), (1024, 1), (1024, 512), (11524, 2430), (1000, 300),
    (16384, 100)])
def test_pow2_halo_equals_jax(window, min_halo):
    got = pow2_halo(window, min_halo)
    assert got == jchunked.pow2_halo(window, min_halo)
    ext = window + 2 * got
    assert got >= min_halo and ext & (ext - 1) == 0


def test_pow2_halo_rejects_odd_windows():
    with pytest.raises(ValueError, match="even"):
        pow2_halo(1001, 10)


def test_bench_geometry():
    """The long-recording bench's geometry: 2-100 Hz Morse at 1 kHz, window
    11524 -> halo 2430, extended window 16384 (the kernel's ceiling)."""
    _, tw = _pair("Morse", interpolate=True)
    s = StreamingCWT(tw._wdef(), np.linspace(2, 100, 100), SFREQ,
                     window=11524, interpolate=True, device="cpu")
    assert (s.halo, s.window + 2 * s.halo) == (2430, 16384)
    assert tfused.supports((1, 1, 16384), s._bank)
    assert not s._fused                   # "auto" on the CPU: plain path


def test_default_window_geometry_takes_the_split_kernel():
    """``RawWavelet``'s default window, 16384 at 1 kHz with 1-100 Hz Morse
    rows, extends to 32768: on a card the stream launches "power_each"
    under "power_each_split" (two 16384-point transforms a row), where it
    ran the plain chain before; on the CPU "auto" keeps the plain path."""
    _, tw = _pair("Morse")
    s = StreamingCWT(tw._wdef(), np.linspace(1, 100, 100), SFREQ,
                     window=16384, device="cpu")
    ext = s.window + 2 * s.halo
    assert (s.halo, ext) == (8192, 32768)
    r = tfused.route("power_each", (1, 1, ext), s._bank, device="cuda")
    assert (r.key, r.why, r.span) == (
        "power_each_split", None,
        "ninw.transform.kernel:power_each_split")
    assert s._why == "cpu" and not s._fused


@pytest.mark.parametrize("interpolate", [False, True])
def test_streaming_at_32768_forced_fused_is_the_plain_path_on_cpu(
        interpolate):
    """``use_fused=True`` at an extended window of 32768 is accepted now
    (the split kernel on a card) and runs its plain version on the CPU:
    the same plane as ``use_fused=False``, bit for bit."""
    _, tw = _pair("Morse", interpolate=interpolate)
    kw = dict(window=16384, halo=300, interpolate=interpolate, batch=2,
              device="cpu")
    fused = StreamingCWT(tw._wdef(), [40.0], SFREQ, use_fused=True, **kw)
    plain = StreamingCWT(tw._wdef(), [40.0], SFREQ, use_fused=False, **kw)
    assert fused.window + 2 * fused.halo == 32768 and fused._fused
    sig = _recording((40000,), seed=27)
    before = dict(kernels.launches)
    got = fused.power_device(sig)
    assert got.shape == (1, 40000)
    torch.testing.assert_close(got, plain.power_device(sig), rtol=0, atol=0)
    assert kernels.launches == before


def test_chunk_bank_matches_jax():
    jw, tw = _pair("Morse", interpolate=True)
    got = chunk_bank(tw._wdef(), FREQS, 1024, 512, SFREQ, True,
                     device="cpu")
    br, bi = jchunked.chunk_bank(jw._wdef(), FREQS, 1024, 512, SFREQ, True)
    assert bi is None and got.shape == (11, 2048)
    assert _rel(got.numpy(), br) <= 1e-6


# -- StreamingCWT ---------------------------------------------------------------

STREAM_KW = dict(window=1024, halo=512, interpolate=True)


def _streams(use_fused, batch=3):
    jw, tw = _pair("Morse")
    jkw = dict(STREAM_KW, use_fused=use_fused, batch=batch)
    if use_fused:
        jkw.update(interpret=True, precision="exact")
    return (JStreaming(jw._wdef(), FREQS, SFREQ, **jkw),
            StreamingCWT(tw._wdef(), FREQS, SFREQ, use_fused=use_fused,
                         batch=batch, device="cpu", **STREAM_KW))


@pytest.mark.parametrize("use_fused", [False, True])
@pytest.mark.parametrize("lead", [(), (2,)])
def test_streaming_power_matches_jax(use_fused, lead):
    """Multichannel, with a ragged tail (5000 = 4 x 1024 + 904) and a
    ragged last batch (5 windows in batches of 3)."""
    js, ts = _streams(use_fused)
    assert ts._fused is use_fused
    sig = _recording(lead + (5000,))
    want = js.power(sig)
    got = ts.power(sig)
    assert got.shape == lead + (11, 5000) and got.dtype == np.float32
    assert _rel(got, want) <= RTOL
    dev = ts.power_device(sig)
    assert isinstance(dev, torch.Tensor) and dev.device.type == "cpu"
    assert _rel(dev.numpy(), np.asarray(js.power_device(sig))) <= RTOL
    np.testing.assert_array_equal(dev.numpy(), got)


def test_streaming_blocks_match_jax():
    js, ts = _streams(False, batch=2)
    sig = _recording((2, 3500), seed=1)
    got, want = list(ts.blocks(sig)), list(js.blocks(sig))
    assert [s for s, _ in got] == [s for s, _ in want] == [0, 1024, 2048,
                                                           3072]
    for (_, g), (_, w) in zip(got, want):
        assert g.shape == np.asarray(w).shape
        assert _rel(g, w) <= RTOL
    assert got[-1][1].shape == (2, 11, 3500 - 3072)


def test_streaming_interior_matches_whole_signal():
    """The JAX package's gate (``tests/test_utils.py``): the streamed
    interior equals the whole-signal transform to 1e-3 of the max."""
    _, tw = _pair("Morse")
    sig = _recording((8192,), seed=2)
    s = StreamingCWT(tw._wdef(), FREQS, SFREQ, window=2048, halo_tol=1e-5,
                     device="cpu")
    got = s.power(sig)
    whole = tcwt.power_from_bank(
        torch.from_numpy(sig),
        tw.make_fft_wavelets(FREQS, 8192 / SFREQ), False).numpy()
    m = s.halo
    err = np.abs(got[:, m:-m] - whole[:, m:-m]).max()
    assert err < 1e-3 * np.abs(whole).max()


def test_streaming_force_fused_raises_on_bad_geometry():
    _, tw = _pair("Morse")
    with pytest.raises(ValueError, match="power of two"):
        StreamingCWT(tw._wdef(), [40.0], SFREQ, window=32768, halo=300,
                     use_fused=True, device="cpu")   # ext 65536 > 32768
    mh = nt.MexicanHat(SFREQ, device="cpu")
    with pytest.raises(ValueError, match="real bank"):
        StreamingCWT(mh._wdef(), [40.0], SFREQ, window=1024, halo=512,
                     use_fused=True, device="cpu")   # complex bank


def test_streaming_halo_must_fit_the_window():
    _, tw = _pair("Morse")
    with pytest.raises(ValueError, match="smaller than the window"):
        StreamingCWT(tw._wdef(), [1.0], SFREQ, window=128, device="cpu")


# -- OnlineCWT ------------------------------------------------------------------

def _drain(oc, sig, chunks):
    blocks, pos = [], 0
    for size in chunks:
        blocks += oc.push(sig[..., pos:pos + size])
        pos += size
    blocks += oc.flush()
    out = np.zeros(sig.shape[:-1] + (len(oc.freqs), sig.shape[-1]),
                   np.float32)
    covered = 0
    for start, blk in blocks:
        blk = np.asarray(blk)
        out[..., start:start + blk.shape[-1]] = blk
        covered += blk.shape[-1]
    assert covered == sig.shape[-1]
    return out


def _chunks(n, seed):
    rng, sizes = np.random.default_rng(seed), []
    while sum(sizes) < n:
        sizes.append(int(min(rng.integers(1, 1500), n - sum(sizes))))
    return sizes


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("lead", [(), (2,)])
def test_online_bit_identical_to_streaming(seed, lead):
    _, tw = _pair("Morse")
    kw = dict(STREAM_KW, device="cpu")
    sig = _recording(lead + (4500,), seed=seed)
    want = StreamingCWT(tw._wdef(), FREQS, SFREQ, batch=1, **kw).power(sig)
    got = _drain(OnlineCWT(tw._wdef(), FREQS, SFREQ, **kw), sig,
                 _chunks(4500, seed))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("batch", [1, 3])
def test_online_matches_jax(batch):
    jw, tw = _pair("Morse")
    sig = _recording((2, 4500), seed=4)
    chunks = _chunks(4500, 7)
    want = _drain(JOnline(jw._wdef(), FREQS, SFREQ, use_fused=False,
                          batch=batch, **STREAM_KW), sig, chunks)
    got = _drain(OnlineCWT(tw._wdef(), FREQS, SFREQ, batch=batch,
                           device="cpu", **STREAM_KW), sig, chunks)
    assert _rel(got, want) <= RTOL


def test_online_rejects_pushes_after_flush_and_new_lead():
    _, tw = _pair("Morse")
    oc = OnlineCWT(tw._wdef(), FREQS, SFREQ, device="cpu", **STREAM_KW)
    oc.push(np.zeros((2, 100), np.float32))
    with pytest.raises(ValueError, match="lead dims"):
        oc.push(np.zeros((3, 100), np.float32))
    oc.flush()
    assert oc.flush() == []
    with pytest.raises(RuntimeError, match="flushed"):
        oc.push(np.zeros((2, 10), np.float32))


# -- RawWavelet: the slice end to end ------------------------------------------

class _Raw:
    """The duck-typed ``mne.io.Raw`` surface."""

    def __init__(self, data):
        self._data = data
        self.info = {"sfreq": SFREQ}
        self.ch_names = [f"EEG{i:02d}" for i in range(data.shape[0])]

    def get_data(self):
        return self._data


RAW_KW = dict(window=1024, batch=2)
RAW_FREQS = np.arange(10.0, 101.0, 10.0)


def _raws(data, **kw):
    jw, tw = _pair("Morse", interpolate=True)
    return (nw.RawWavelet(_Raw(data), jw, **RAW_KW, **kw),
            nt.RawWavelet(_Raw(data), tw, **RAW_KW, **kw))


def test_raw_wavelet_power_matches_jax():
    data = _recording((3, 6000), seed=5)
    jr, tr = _raws(data)
    got = tr.power(RAW_FREQS)
    assert isinstance(got, torch.Tensor) and got.shape == (3, 10, 6000)
    assert _rel(got.numpy(), np.asarray(jr.power(RAW_FREQS))) <= RTOL
    assert tr._stream_for(RAW_FREQS).halo == jr._stream_for(RAW_FREQS).halo
    picked = tr.power(RAW_FREQS, picks=["EEG02", "EEG00"])
    np.testing.assert_array_equal(picked.numpy(), got.numpy()[[2, 0]])
    one = tr.power_channel("EEG01", RAW_FREQS)
    assert _rel(one.numpy(),
                np.asarray(jr.power_channel("EEG01", RAW_FREQS))) <= RTOL
    # 60 Hz is the tone's row on every channel.
    assert np.all(got.numpy().mean(-1).argmax(-1) == 5)


def test_raw_wavelet_from_edf_matches_jax(tmp_path):
    data = 50.0 * _recording((3, 6000), seed=6)
    path = str(tmp_path / "rec.edf")
    jwrite_edf(path, data, SFREQ, ch_names=["Fz", "Cz", "Pz"])
    jw, tw = _pair("Morse", interpolate=True)
    jr = nw.RawWavelet.from_edf(path, jw, **RAW_KW)
    tr = nt.RawWavelet.from_edf(path, tw, **RAW_KW)
    got = tr.power(RAW_FREQS)
    assert _rel(got.numpy(), np.asarray(jr.power(RAW_FREQS))) <= RTOL
    ch = tr.power_channel("Cz", RAW_FREQS)
    np.testing.assert_array_equal(ch.numpy(), got.numpy()[1])
    sub = nt.RawWavelet.from_edf(path, tw, picks=["Pz"], **RAW_KW)
    np.testing.assert_array_equal(sub.power(RAW_FREQS).numpy()[0],
                                  got.numpy()[2])
    with pytest.raises(ValueError, match="not in raw.ch_names"):
        sub.power(RAW_FREQS, picks=["Fz"])


def test_raw_wavelet_invalidate_refetches():
    data = _recording((2, 3000), seed=7)
    _, tr = _raws(data)
    first = tr.power(RAW_FREQS).clone()
    tr.raw._data = 2.0 * data
    np.testing.assert_array_equal(tr.power(RAW_FREQS).numpy(),
                                  first.numpy())      # cached snapshot
    tr.invalidate()
    np.testing.assert_allclose(tr.power(RAW_FREQS).numpy(),
                               4.0 * first.numpy(), rtol=1e-5,
                               atol=1e-6 * float(first.max()))
