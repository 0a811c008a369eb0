"""The port's 2-D wavelet transforms (``ninwavelets_tpu_torch.ops.dwt2d`` and
``ops.cwt2d``) against the JAX package on the same seeded images, on the
CPU, and against ``tests/test_wavelet2d.py``'s oracles (separability
through the 1-D ``wavedec``, the float64 transcription of the directional
Morlet transform, plane waves).

Gates, each with its reason:

* subbands, reconstructions, coefficient and power planes: max|d| <= 1e-5
  x max|ref|.  The port's default 2-D CWT multiplies ``fft2`` by the
  separable bank factors; the JAX package forms the same product as a
  sandwich of DFT matrices at full float32 precision.  Both are float32
  evaluations of one linear map, measured about 5e-7 of the max apart;
* the float64 oracle: SNR above 90 dB, ``tests/test_wavelet2d.py``'s gate;
* banks and the reflect padding: exact (the same host arithmetic; the same
  samples gathered);
* validation: the JAX package's exception type.
"""
import numpy as np
import pytest
import torch

from ninwavelets_tpu.ops import cwt2d as jc
from ninwavelets_tpu.ops import dwt2d as jd
from ninwavelets_tpu_torch.ops import cwt2d as tc
from ninwavelets_tpu_torch.ops import dwt as t1
from ninwavelets_tpu_torch.ops import dwt2d as td

from test_torch_dwt import _close
from test_wavelet2d import _oracle_cwt2
from torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"
FREQS = (0.03, 0.06, 0.12, 0.24)
THETAS = tuple(np.arange(4) * np.pi / 4.0)


def _img(h=64, w=64, seed=0):
    return np.random.default_rng(seed).standard_normal((h, w)).astype(
        np.float32)


def _jcwt2(img, *a, **kw):
    r, i = jc.cwt2(img, *a, **kw)
    return np.asarray(r) + 1j * np.asarray(i)


def _snr_db(got, want):
    return 10 * np.log10((np.abs(want) ** 2).sum()
                         / float((np.abs(got - want) ** 2).sum()))


# -- 2-D DWT ----------------------------------------------------------------

def _close_coeffs(got, want):
    _close(got[0], want[0])
    for dg, dw in zip(got[1:], want[1:]):
        for a, b in zip(dg, dw):
            _close(a, b)


@pytest.mark.parametrize("name,level", [("db4", 3), ("db6", 2), ("haar", 4)])
def test_wavedec2_waverec2_match_jax(name, level):
    img = _img(64, 128, seed=level)
    c = td.wavedec2(img, name, level=level, device=CPU)
    cj = jd.wavedec2(img, name, level=level)
    _close_coeffs(c, cj)
    rec = td.waverec2(c, name)
    _close(rec, jd.waverec2(cj, name))
    np.testing.assert_allclose(rec.numpy(), img, atol=2e-5)
    e = float((c[0].double() ** 2).sum()) + sum(
        float((a.double() ** 2).sum()) for d in c[1:] for a in d)
    np.testing.assert_allclose(e, float((img.astype(np.float64) ** 2).sum()),
                               rtol=1e-5)


def test_wavedec2_separable_oracle_vs_1d():
    """On a rank-one image a(y) b(x) every subband is an outer product of
    the port's 1-D ``wavedec`` coefficients."""
    rng = np.random.default_rng(1)
    a = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(128).astype(np.float32)
    c = td.wavedec2(np.outer(a, b), "db4", level=3, device=CPU)
    for i, (lh, hl, hh) in enumerate(c[1:]):
        j = 3 - i
        ca = t1.wavedec(a, "db4", level=j, device=CPU)
        cb = t1.wavedec(b, "db4", level=j, device=CPU)
        np.testing.assert_allclose(lh.numpy(), np.outer(ca[1], cb[0]),
                                   atol=1e-4)
        np.testing.assert_allclose(hl.numpy(), np.outer(ca[0], cb[1]),
                                   atol=1e-4)
        np.testing.assert_allclose(hh.numpy(), np.outer(ca[1], cb[1]),
                                   atol=1e-4)
    ca = t1.wavedec(a, "db4", level=3, device=CPU)
    cb = t1.wavedec(b, "db4", level=3, device=CPU)
    np.testing.assert_allclose(c[0].numpy(), np.outer(ca[0], cb[0]),
                               atol=1e-4)


def test_batched_and_single_level_match_jax():
    imgs = np.stack([_img(seed=s) for s in range(3)])
    c = td.wavedec2(imgs, "db2", level=2, device=CPU)
    assert c[0].shape == (3, 16, 16)
    _close_coeffs(c, jd.wavedec2(imgs, "db2", level=2))
    ll, det = td.dwt2(imgs[0, :32, :32], "db4", device=CPU)
    llj, detj = jd.dwt2(imgs[0, :32, :32], "db4")
    _close_coeffs([ll, det], [llj, detj])
    rec = td.idwt2(ll, det, "db4")
    _close(rec, jd.idwt2(llj, detj, "db4"))
    np.testing.assert_allclose(rec.numpy(), imgs[0, :32, :32], atol=2e-5)


def test_dwt2d_validation_and_levels_match_jax():
    for pkg, kw in ((td, {"device": CPU}), (jd, {})):
        with pytest.raises(ValueError):
            pkg.wavedec2(_img(48, 64), "db4", level=5, **kw)
        ll, det = pkg.dwt2(_img(32, 32), **kw)
        with pytest.raises(ValueError):
            pkg.waverec2([ll, (det[0][:4], det[1], det[2])])
    for h, w, name in ((64, 64, "db4"), (64, 8, "db1"), (96, 48, "db2"),
                       (256, 256, "db8")):
        assert td.max_level2(h, w, name) == jd.max_level2(h, w, name)
    c = td.wavedec2(_img(96, 48), "db2", device=CPU)
    assert len(c) == len(jd.wavedec2(_img(96, 48), "db2"))


# -- 2-D CWT ------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(64, 64), (48, 100), (2, 32, 32)])
def test_cwt2_matches_jax_and_the_float64_oracle(shape):
    img = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    got = tc.cwt2(img, FREQS, THETAS, device=CPU)
    assert got.dtype == torch.complex64
    assert got.shape == shape[:-2] + (4, 4) + shape[-2:]
    _close(got.numpy(), _jcwt2(img, FREQS, THETAS))
    flat = img.reshape((-1,) + shape[-2:])
    for k in range(flat.shape[0]):
        assert _snr_db(got.numpy().reshape((-1, 4, 4) + shape[-2:])[k],
                       _oracle_cwt2(flat[k], FREQS, THETAS)) > 90.0


@pytest.mark.parametrize("use_fft", [False, True])
def test_power2d_matches_jax(use_fft):
    imgs = np.stack([_img(32, 64, seed=s) for s in range(2)])
    got = tc.power2d(imgs, FREQS, use_fft=use_fft, device=CPU)
    _close(got, jc.power2d(imgs, FREQS, use_fft=use_fft))
    assert got.shape == (2, 4, 6, 32, 64)       # 6 default orientations
    wv = tc.cwt2(imgs, FREQS, use_fft=use_fft, device=CPU)
    np.testing.assert_allclose(got.numpy(), np.abs(wv.numpy()) ** 2,
                               rtol=1e-5, atol=1e-7)


def test_default_and_fft_paths_agree():
    img = _img(64, 64, seed=9)
    a = tc.power2d(img, FREQS, THETAS, device=CPU)
    b = tc.power2d(img, FREQS, THETAS, use_fft=True, device=CPU)
    _close(a, b.numpy())
    _close(tc.cwt2(img, FREQS, THETAS, use_fft=True, device=CPU),
           _jcwt2(img, FREQS, THETAS, use_fft=True))


def test_plane_wave_localizes():
    y, x = np.mgrid[0:64, 0:64]
    f0, th0 = 0.12, np.pi / 4.0
    img = np.cos(2 * np.pi * f0 * (x * np.cos(th0) + y * np.sin(th0))
                 ).astype(np.float32)
    mean = tc.power2d(img, FREQS, THETAS, device=CPU).numpy().mean((-2, -1))
    fi, ti = np.unravel_index(mean.argmax(), mean.shape)
    assert FREQS[fi] == pytest.approx(f0) and THETAS[ti] == pytest.approx(th0)


def test_morlet2d_bank_is_the_jax_packages():
    got = tc.morlet2d_bank(FREQS, THETAS, 32, 48, device=CPU)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jc.morlet2d_bank(FREQS, THETAS, 32, 48)))
    by, bx = tc._bank_sep_np(FREQS, THETAS, 32, 48, 1.0, tc.OMEGA0)
    np.testing.assert_allclose(by[..., :, None] * bx[..., None, :],
                               got.numpy(), rtol=1e-6, atol=1e-30)


@pytest.mark.parametrize("bad", [[0.7], [0.0], [-0.1]])
def test_freq_validation_matches_jax(bad):
    with pytest.raises(ValueError):
        jc.morlet2d_bank(bad, [0.0], 32, 32)
    with pytest.raises(ValueError):
        tc.morlet2d_bank(bad, [0.0], 32, 32, device=CPU)
    with pytest.raises(ValueError):
        tc.cwt2(_img(32, 32), bad, device=CPU)


def test_use_fft_needs_power_of_two_sizes_in_both():
    img = _img(48, 100)
    with pytest.raises(ValueError):
        jc.cwt2(img, FREQS, use_fft=True)
    with pytest.raises(ValueError):
        tc.cwt2(img, FREQS, use_fft=True, device=CPU)
    with pytest.raises(ValueError):
        tc.power2d(img, FREQS, use_fft=True, device=CPU)


@pytest.mark.parametrize("shape", [(48, 100), (1, 300), (1, 1), (3, 2),
                                   (2, 5, 17), (64, 128)])
def test_pow2_pad2_matches_jax(shape):
    """numpy's "reflect", as ``jnp.pad`` applies it; a length-1 axis
    repeats its row, where ``torch.nn.functional.pad`` would raise."""
    img = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    got, crop = tc.pow2_pad2(img, device=CPU)
    want, crop_j = jc.pow2_pad2(img)
    assert crop == crop_j == shape[-2:]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
