"""The port's main path end to end against the JAX package: the class layer,
``EpochsWavelet`` over ``ArrayEpochs``, baseline correction, the stale-bank
contract, conversion, and the import / smoke-script boundaries."""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_example

import ninwavelets_tpu as nw
import ninwavelets_tpu_torch as nt
from ninwavelets_tpu.ops import bank as jbank
from ninwavelets_tpu.ops import baseline as jbl
from ninwavelets_tpu_torch import convert
from ninwavelets_tpu_torch.ops import baseline as tbl

from torch_threads import one_torch_thread  # noqa: F401

SFREQ = 1000.0
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-4
FREQS = np.arange(8.0, 70.0, 4.0)       # F = 16


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _epochs(e=4, c=3, n=1024, seed=0):
    data = np.random.default_rng(seed).standard_normal((e, c, n))
    return nw.ArrayEpochs(data, SFREQ), nt.ArrayEpochs(data, SFREQ)


def _adapters(interpolate, family="Morse", **kw):
    je, te = _epochs(**kw)
    jw = getattr(nw, family)(SFREQ, interpolate=interpolate)
    return (nw.EpochsWavelet(je, jw),
            nt.EpochsWavelet(te, convert.wavelet_from_jax(jw, device="cpu")))


def _zscores_close(got, want, power, baseline):
    """z = (p - mean) / std over the baseline window, so a power error of
    at most RTOL x the row's max P moves z by at most
    2 RTOL P (1 + |z|) / std: that bound is the gate, cell by cell (as
    ``chip_smoke.baselined_err`` gates it).  A gate relative to the plane's
    max cannot hold: where a row's baseline std is round-off, two float32
    paths differ there by O(1) z-units."""
    got, want, power = (np.asarray(x, np.float64) for x in (got, want, power))
    window = power[..., int(baseline[0] * SFREQ):int(baseline[1] * SFREQ)]
    std = window.std(-1, keepdims=True)
    std = np.where(std > 0, std, 1.0)                   # the "unit" rule
    bound = 2 * RTOL * power.max(-1, keepdims=True) * (1 + np.abs(want)) / std
    assert (np.abs(got - want) <= bound).all(), (np.abs(got - want)
                                                 / bound).max()


@pytest.mark.parametrize("interpolate", [True, False])
def test_power_all_with_baseline_matches_jax(interpolate):
    jew, tew = _adapters(interpolate)
    got = tew.power_all(FREQS, baseline=(0.0, 0.2))
    want = jew.power_all(FREQS, baseline=(0.0, 0.2))
    assert got.shape == (3, len(FREQS), 1024)
    _zscores_close(got.numpy(), want, jew.power_all(FREQS), (0.0, 0.2))
    got = tew.power_all(FREQS, baseline=(0.0, 0.1), baseline_method="mean",
                        decim=4)
    want = jew.power_all(FREQS, baseline=(0.0, 0.1), baseline_method="mean",
                         decim=4)
    assert got.shape == (3, len(FREQS), 256)
    assert _rel(got.numpy(), want) <= RTOL


@pytest.mark.parametrize("interpolate", [True, False])
def test_itc_and_power_itc_all_match_jax(interpolate):
    jew, tew = _adapters(interpolate)
    want_itc = np.asarray(jew.itc_all(FREQS))
    np.testing.assert_allclose(tew.itc_all(FREQS).numpy(), want_itc,
                               rtol=RTOL, atol=1e-5)
    p, i = tew.power_itc_all(FREQS)
    wp, wi = jew.power_itc_all(FREQS)
    assert _rel(p.numpy(), wp) <= RTOL
    np.testing.assert_allclose(i.numpy(), np.asarray(wi), rtol=RTOL,
                               atol=1e-5)


@pytest.mark.parametrize("family", ["Morse", "Morlet", "MexicanHat"])
def test_per_channel_calls_match_jax(family):
    jew, tew = _adapters(True, family=family)
    assert _rel(tew.power("ch1", FREQS).numpy(),
                jew.power("ch1", FREQS)) <= RTOL
    np.testing.assert_allclose(tew.itc("ch1", FREQS).numpy(),
                               np.asarray(jew.itc("ch1", FREQS)),
                               rtol=RTOL, atol=1e-5)
    got = tew.cwt("ch2", FREQS)
    assert got.dtype == torch.complex64 and got.shape == (4, len(FREQS), 1024)
    assert _rel(got.numpy(), jew.cwt("ch2", FREQS)) <= RTOL
    assert _rel(tew.cwt_all(FREQS).numpy(), jew.cwt_all(FREQS)) <= RTOL


def test_epochs_cache_follows_the_data():
    _, te = _epochs()
    tew = nt.EpochsWavelet(te, nt.Morse(SFREQ, device="cpu"))
    a = tew.power_all(FREQS)
    te._data = te._data[:, :2]
    te.ch_names = te.ch_names[:2]
    assert tew.power_all(FREQS).shape[0] == 2          # fingerprint changed
    te._data = te._data * 2.0                           # same shapes
    tew.invalidate()
    torch.testing.assert_close(tew.power_all(FREQS), 4.0 * a[:2])


def test_array_epochs_validation():
    with pytest.raises(ValueError):
        nt.ArrayEpochs(np.zeros((3, 10)), SFREQ)
    with pytest.raises(ValueError):
        nt.ArrayEpochs(np.zeros((2, 3, 10)), SFREQ, ch_names=["a"])
    ep = nt.ArrayEpochs(np.zeros((2, 3, 10)), 100.0)
    assert len(ep) == 2 and ep.ch_names == ["ch0", "ch1", "ch2"]
    assert ep.times[-1] == pytest.approx(0.09)


def _tf_plane(seed=0):
    tf = np.random.default_rng(seed).uniform(0.5, 2.0, (2, 5, 400))
    tf[0, 2] = 1.25              # a row whose baseline std is exactly 0
    return tf.astype(np.float32)


@pytest.mark.parametrize("method", list(tbl.METHODS))
@pytest.mark.parametrize("degenerate", ["unit", "strict"])
def test_baseline_tf_matches_jax(method, degenerate):
    tf = _tf_plane()
    got = tbl.baseline_tf(torch.from_numpy(tf), 1000.0, 0.0, 0.1, method,
                          degenerate).numpy()
    want = np.asarray(jbl.baseline_tf(jnp.asarray(tf), 1000.0, 0.0, 0.1,
                                      method, degenerate))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                               equal_nan=True)
    if degenerate == "unit":
        assert np.isfinite(got).all()


def test_baseline_tf_rejects_unknown_options():
    tf = torch.ones(2, 100)
    with pytest.raises(ValueError):
        tbl.baseline_tf(tf, 100.0, 0.0, 0.1, degenerate="nope")
    with pytest.raises(ValueError):
        tbl.baseline_tf(tf, 100.0, 0.0, 0.1, method="nope")


@pytest.mark.parametrize("method", list(tbl.METHODS))
def test_baseline_class_and_correct_match_jax(method):
    wave = np.random.default_rng(1).uniform(0.5, 2.0, (300, 4)).astype(
        np.float32)
    got = getattr(tbl.Baseline(torch.from_numpy(wave), 1000.0, 0.0, 0.05),
                  method)().numpy()
    want = np.asarray(getattr(jbl.Baseline(jnp.asarray(wave), 1000.0, 0.0,
                                           0.05), method)())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tbl.baseline_correct(wave, 1000.0, 0.0, 0.05, method).numpy(), want,
        rtol=1e-5, atol=1e-6)
    assert tbl.baseline_of(wave, 1000.0, 0.0, 0.05).shape == (50, 4)


def test_morse_power_of_60hz_sine_peaks_at_row_60():
    sin = np.sin(np.arange(0, 3, 0.001) * 60 * 2 * np.pi)
    p = nt.Morse(SFREQ, 17.5, 3, device="cpu").power(sin, range(1, 100))
    assert p.shape == (99, 3000)
    assert int(torch.argmax(p.mean(-1))) + 1 == 60


@pytest.mark.parametrize("family", ["Morse", "Morlet", "Shannon",
                                    "MexicanHat", "Haar"])
def test_class_layer_matches_jax(family):
    sig = make_example(1.0)
    jw = getattr(nw, family)(SFREQ, interpolate=True)
    tw = convert.wavelet_from_jax(jw, device="cpu")
    freqs = np.arange(1.0, 100.0, 7.0)
    assert _rel(tw.cwt(sig, freqs).numpy(), jw.cwt(sig, freqs)) <= RTOL
    assert _rel(tw.power(sig).numpy(), jw.power(sig)) <= RTOL
    assert _rel(tw.abs(sig).numpy(), jw.abs(sig)) <= RTOL
    ph_t, ph_j = tw.phase(sig).numpy(), jw.phase(sig)
    mag = np.abs(np.asarray(jw.cwt(sig)))
    strong = mag > 1e-2 * mag.max()
    d = np.angle(np.exp(1j * (ph_t - ph_j)))
    assert np.abs(d[strong]).max() <= 1e-3


def test_stale_bank_contract_matches_jax():
    """reuse=True keeps the cached bank (center-padded / truncated to the
    signal) even after a parameter change; reuse=False rebuilds it from the
    current parameters.  The JAX package behaves the same way."""
    jm, tm = nw.Morse(SFREQ), nt.Morse(SFREQ, device="cpu")
    freqs = np.arange(1.0, 50.0, 5.0)
    sin1, sin2 = make_example(1.0), make_example(2.0)
    tm.cwt(sin1, freqs)
    jm.cwt(sin1, freqs)
    bank1, jbank1 = tm.fft_wavelets.clone(), np.array(jm.fft_wavelets)
    got, want = tm.cwt(sin2, freqs), jm.cwt(sin2, freqs)
    assert torch.equal(tm.fft_wavelets, bank1)
    assert np.array_equal(jm.fft_wavelets, jbank1)
    assert _rel(got.numpy(), want) <= RTOL
    jm.b = tm.b = 5.0
    got, want = tm.cwt(sin1), jm.cwt(sin1)                # stale in both
    assert torch.equal(tm.fft_wavelets, bank1)
    assert np.array_equal(jm.fft_wavelets, jbank1)
    assert _rel(got.numpy(), want) <= RTOL
    got, want = tm.cwt(sin1, freqs, reuse=False), jm.cwt(sin1, freqs,
                                                         reuse=False)
    assert _rel(tm.fft_wavelets.numpy(), bank1.numpy()) > 0.1   # rebuilt
    assert _rel(tm.fft_wavelets.numpy(), jm.fft_wavelets) <= 1e-5
    assert _rel(got.numpy(), want) <= RTOL


def test_freq_errors():
    m = nt.Morse(SFREQ, device="cpu")
    with pytest.raises(ZeroDivisionError):
        m.cwt(make_example(1.0), [0.0, 10.0])
    with pytest.raises(ZeroDivisionError):
        m.make_fft_wavelet(0.0)
    with pytest.raises(ZeroDivisionError):
        m.make_wavelet(0)
    with pytest.raises(ValueError):
        m.cwt(make_example(1.0), [])
    with pytest.raises(ValueError):
        nt.Morse(SFREQ, device="cpu").cwt(make_example(1.0))   # no bank
    with pytest.raises(AttributeError):
        nt.Morse(SFREQ, device="cpu").fft_wavelets
    m.make_fft_wavelets([10.0])
    assert m.freq_dist == 0.0 and m.fft_wavelets.shape == (1, 1000)
    m.make_fft_wavelets(torch.tensor([10.0, 12.5]))
    assert m.freq_dist == 2.5


def test_device_selection():
    """The card unless the caller asks for the CPU: ``device=`` wins, an
    explicit ``cuda=False`` means the CPU, and with neither the wavelet goes
    to CUDA, raising (with the way out named) when CUDA is absent."""
    cpu = torch.device("cpu")
    assert nt.Morse(SFREQ, device="cpu").device == cpu
    assert nt.Morse(SFREQ, cuda=True, device="cpu").device == cpu  # wins
    assert nt.Morse(SFREQ, cuda=False).device == cpu
    assert nt.Haar(SFREQ, device="cpu").device == cpu
    assert convert.bank_from_jax(np.ones((2, 8)), device="cpu").device == cpu
    defaults = [lambda: nt.Morse(SFREQ), lambda: nt.Morse(SFREQ, cuda=True),
                lambda: nt.Haar(SFREQ),
                lambda: convert.wavelet_from_jax(nw.Morse(SFREQ)),
                lambda: convert.bank_from_jax(np.ones((2, 8)))]
    for make in defaults:
        if torch.cuda.is_available():
            out = make()
            assert getattr(out, "device").type == "cuda"
        else:
            with pytest.raises(RuntimeError, match='device="cpu"'):
                make()


@pytest.mark.parametrize("family", ["Morse", "Morlet", "Shannon",
                                    "MexicanHat", "Haar"])
def test_convert_round_trip(family):
    jw = getattr(nw, family)(SFREQ, interpolate=True)
    if family == "Morse":
        jw.b, jw.r = 9.0, 2.5
    jw.mode = nw.WaveletMode.Both if family == "Morlet" else jw.mode
    tw = convert.wavelet_from_jax(jw, device="cpu")
    assert type(tw).__name__ == family and tw.mode.name == jw.mode.name
    for key in ("sfreq", "real_wave_length", "interpolate", "b", "r",
                "sigma", "gabor"):
        assert getattr(tw, key, None) == getattr(jw, key, None), key
    freqs = jnp.arange(5.0, 45.0, 10.0)
    br, bi = jbank.make_fft_bank_ri(jw._wdef(), freqs, 1024, SFREQ, True)
    bank = convert.bank_from_jax(np.asarray(br), None if bi is None
                                 else np.asarray(bi), device="cpu")
    assert bank.dtype == (torch.float32 if bi is None else torch.complex64)
    tw.make_fft_wavelets(np.asarray(freqs), 1.024)
    assert _rel(bank.numpy(), tw.fft_wavelets.numpy()) <= 1e-5


@pytest.mark.parametrize("n", [512, 2048])
@pytest.mark.parametrize("family, params", [("Paul", {"m": 6.0}),
                                            ("DOG", {"m": 4.0}),
                                            ("Bump", {"sigma": 0.8})])
def test_convert_zoo_family(family, params, n):
    jw = getattr(nw, family)(SFREQ, interpolate=True, **params)
    tw = convert.wavelet_from_jax(jw, device="cpu")
    assert type(tw).__name__ == family and tw.mode.name == jw.mode.name
    for key in ("sfreq", "real_wave_length", "interpolate", *params):
        assert getattr(tw, key) == getattr(jw, key), key
    freqs = jnp.arange(5.0, 45.0, 10.0)
    br, bi = jbank.make_fft_bank_ri(jw._wdef(), freqs, n, SFREQ, True)
    assert bi is None
    tw.make_fft_wavelets(np.asarray(freqs), n / SFREQ)
    assert _rel(tw.fft_wavelets.numpy(), np.asarray(br)) <= 1e-5


def test_convert_rejects_unported_class():
    # Every class of the JAX package has a port; a class of the caller's
    # own (here a Morse subclass) has none.
    class CustomMorse(nw.Morse):
        pass

    with pytest.raises(TypeError, match="CustomMorse"):
        convert.wavelet_from_jax(CustomMorse(SFREQ), device="cpu")


@pytest.mark.parametrize("family, params", [
    ("Superlet", {"sigma": 2.5, "order_min": 2, "order_max": 5,
                  "adaptive": False, "interpolate": True}),
    ("Superlet", {"sigma": 3.0, "order_min": 1, "order_max": 4}),
    ("MorseMultitaper", {"b": 9.0, "r": 2.5, "n_tapers": 4,
                         "interpolate": True}),
    ("MorseMNE", {"b": 12.0, "r": 3.5, "interpolate": True}),
])
def test_convert_families_of_banks_and_morse_mne(family, params):
    """A JAX ``Superlet``, ``MorseMultitaper`` or ``MorseMNE`` becomes the
    port's class with the same parameters, and its power (the epoch mean
    too, for the families) equals the JAX package's at slice 6's power gate
    (``tests/test_torch_zoo.py``: 1e-4 of the max)."""
    jw = getattr(nw, family)(SFREQ, **params)
    tw = convert.wavelet_from_jax(jw, device="cpu")
    assert type(tw).__name__ == family
    for key in ("sfreq", "interpolate", *params):
        assert getattr(tw, key) == getattr(jw, key), key
    if family == "MorseMNE":
        assert tw.mode.name == jw.mode.name
        assert tw.real_wave_length == jw.real_wave_length
    freqs = np.arange(8.0, 72.0, 8.0)
    x = np.random.default_rng(0).standard_normal((3, 2, 512)).astype(
        np.float32)
    got = tw.power(torch.from_numpy(x[0]), freqs).numpy()
    want = np.asarray(jw.power(x[0], freqs))
    assert _rel(got, want) <= RTOL
    if family != "MorseMNE":
        got = tw.mean_power(torch.from_numpy(x), freqs).numpy()
        assert _rel(got, np.asarray(jw.mean_power(x, freqs))) <= RTOL


def test_package_imports_neither_jax_nor_the_jax_package():
    code = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'ninwavelets_tpu'):
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
import pkgutil, ninwavelets_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):
    importlib.import_module(m.name)
assert not {'jax', 'ninwavelets_tpu'} & set(sys.modules)
print('ok')
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_chip_smoke_fails_without_a_card():
    """``chip_smoke.py`` needs a CUDA card: without one it exits non-zero
    and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run")
    out = subprocess.run([sys.executable, "chip_smoke.py"],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
