"""The port's discrete wavelet transforms (``ninwavelets_tpu_torch.ops.dwt``:
filters, MODWT, inverse, MRA, the decimated DWT, wavelet variance,
covariance, correlation, their confidence intervals, ``pow2_pad`` and
shrinkage) against the JAX package on the same seeded inputs, on the CPU,
and against ``tests/test_dwt.py``'s oracles.

Gates, each with its reason:

* filters, banks, masks and levels: exact (the same float64 numpy code on
  the host, copied);
* coefficients, reconstructions, MRA components, denoised signals and
  variances: max|d| <= 1e-5 x max|ref| (both are float32 FFT pipelines of
  the same bank; they differ only in the FFT's round-off, about 1e-7 of
  the max);
* the unbiased estimators and correlations: the same NaN cells (0/0 where
  a level has no boundary-free coefficient), the rest at 1e-5 of the max;
* ``modwt_var_ci``: rtol 1e-5 (the same host quantiles times the same
  variance);
* ``pow2_pad``: exact (a gather of the same samples);
* validation: the JAX package's exception type.
"""
import numpy as np
import pytest
import torch

from ninwavelets_tpu.ops import dwt as jd
from ninwavelets_tpu_torch.ops import dwt as td

from test_dwt import _pyramid_modwt
from torch_threads import one_torch_thread  # noqa: F401

GATE = 1e-5
CPU = "cpu"


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, gate=GATE):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    wide = np.complex128 if np.iscomplexobj(got) else np.float64
    d = np.nan_to_num(np.abs(got.astype(wide) - want), nan=0.0)
    scale = np.nanmax(np.abs(want))
    assert d.max() <= gate * scale, (d.max(), scale)


# -- filters and banks -------------------------------------------------------

@pytest.mark.parametrize("name", ["haar", "db2", "db3", "db4", "db7", "db10",
                                  "db16", "db20"])
def test_wavelet_filter_is_the_jax_packages(name):
    g, h = td.wavelet_filter(name)
    gj, hj = jd.wavelet_filter(name)
    np.testing.assert_array_equal(g, gj)
    np.testing.assert_array_equal(h, hj)
    assert abs(g.sum() - np.sqrt(2.0)) < 1e-10 and abs(np.dot(g, h)) < 1e-9


@pytest.mark.parametrize("bad", ["sym4", "db21", "db0"])
def test_wavelet_filter_rejects_what_jax_rejects(bad):
    with pytest.raises(ValueError):
        jd.wavelet_filter(bad)
    with pytest.raises(ValueError):
        td.wavelet_filter(bad)


def test_banks_masks_and_levels_are_the_jax_packages():
    for args in (("db4", 5, 1024), ("haar", 1, 16), ("db8", 7, 2048)):
        for a, b in zip(td.modwt_bank(*args), jd.modwt_bank(*args)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(td._dwt_transfers("db6", 256),
                    jd._dwt_transfers("db6", 256)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(td._interior_masks("db4", 6, 512),
                    jd._interior_masks("db4", 6, 512)):
        np.testing.assert_array_equal(a, b)
    for n in (2, 7, 64, 1000, 1024, 2 ** 20):
        assert td.max_level(n, "db4") == jd.max_level(n, "db4")
    assert td.max_level(2 ** 20, "db4") == 17
    br, bi = td.modwt_bank("db4", 5, 1024)
    np.testing.assert_allclose((br.astype(np.float64) ** 2
                                + bi.astype(np.float64) ** 2).sum(0), 1.0,
                               atol=1e-6)
    for bad in (("db4", 0, 64), ("db4", 9, 64)):
        with pytest.raises(ValueError):
            jd.modwt_bank(*bad)
        with pytest.raises(ValueError):
            td.modwt_bank(*bad)


# -- MODWT, inverse, MRA ------------------------------------------------------

@pytest.mark.parametrize("name", ["haar", "db4", "db8"])
def test_modwt_matches_jax_and_the_pyramid(name):
    x = _x((2, 256))
    got = td.modwt(x, name, 4, device=CPU)
    _close(got, jd.modwt(x, name, 4))
    _close(got, _pyramid_modwt(x, name, 4))


def test_modwt_haar_level1_closed_form():
    x = _x((512,), 1)
    w = td.modwt(x, "haar", 1, device=CPU).numpy()
    np.testing.assert_allclose(w[0], (x - np.roll(x, 1)) / 2, atol=1e-6)
    np.testing.assert_allclose(w[1], (x + np.roll(x, 1)) / 2, atol=1e-6)


def test_imodwt_round_trip_and_energy_match_jax():
    x = _x((3, 1024), 2)
    w = td.modwt(x, "db4", 5, device=CPU)
    rec = td.imodwt(w, "db4")
    _close(rec, jd.imodwt(jd.modwt(x, "db4", 5), "db4"))
    np.testing.assert_allclose(rec.numpy(), x, atol=2e-6)
    np.testing.assert_allclose(float((w.double() ** 2).sum()),
                               float((x.astype(np.float64) ** 2).sum()),
                               rtol=1e-6)


def test_modwt_shift_invariance():
    x = _x((512,), 3)
    w = td.modwt(x, "db4", 3, device=CPU).numpy()
    ws = td.modwt(np.roll(x, 17), "db4", 3, device=CPU).numpy()
    np.testing.assert_allclose(ws, np.roll(w, 17, axis=-1), atol=2e-5)


def test_modwt_mra_matches_jax_and_adds_back():
    n, sfreq = 2048, 1000.0
    t = np.arange(n) / sfreq
    x = (np.sin(2 * np.pi * (sfreq / 24.0) * t)
         + 0.3 * _x((n,), 4)).astype(np.float32)
    got = td.modwt_mra(x, "db8", 7, device=CPU)
    _close(got, jd.modwt_mra(x, "db8", 7))
    np.testing.assert_allclose(got.numpy().sum(-2), x, atol=2e-5)
    energy = (got.numpy() ** 2).sum(-1)
    assert np.argmax(energy) == 3


def test_default_level_and_batch_shapes():
    x = np.zeros((4, 3, 256), np.float32)
    w = td.modwt(x, "db2", 3, device=CPU)
    assert w.shape == (4, 3, 4, 256)
    assert td.imodwt(w, "db2").shape == (4, 3, 256)
    assert td.modwt_var(x, "db2", 3, device=CPU).shape == (4, 3, 3)
    z = td.modwt(np.zeros(64, np.float32), "db4", device=CPU)
    assert z.shape[0] == td.max_level(64) + 1
    t = torch.zeros(2, 64, dtype=torch.float64)
    assert td.modwt(t, "db4", 2).dtype == torch.float32


def test_numpy_input_needs_a_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: numpy input goes to it")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        td.modwt(np.zeros(64, np.float32))


# -- decimated DWT ------------------------------------------------------------

@pytest.mark.parametrize("name", ["haar", "db2", "db4", "db8"])
def test_wavedec_waverec_match_jax(name):
    x = _x((2, 512))
    c = td.wavedec(x, name, 4, device=CPU)
    cj = jd.wavedec(x, name, 4)
    assert [a.shape[-1] for a in c] == [32, 32, 64, 128, 256]
    for a, b in zip(c, cj):
        _close(a, b)
    rec = td.waverec(c, name)
    _close(rec, jd.waverec(cj, name))
    np.testing.assert_allclose(rec.numpy(), x, atol=3e-6)
    e = sum(float((a.double() ** 2).sum()) for a in c)
    np.testing.assert_allclose(e, float((x.astype(np.float64) ** 2).sum()),
                               rtol=1e-5)


def test_wavedec_is_the_subsampled_modwt():
    x = _x((512,), 1)
    wm = td.modwt(x, "db4", 4, device=CPU).numpy()
    c = td.wavedec(x, "db4", 4, device=CPU)
    for j in range(1, 5):
        idx = (2 ** j * (np.arange(512 >> j) + 1) - 1) % 512
        np.testing.assert_allclose(c[5 - j].numpy(),
                                   2 ** (j / 2) * wm[j - 1, idx], atol=2e-5)


def test_wavedec_default_level_and_validation():
    x = np.zeros((96,), np.float32)             # 96 = 2^5 * 3
    c = td.wavedec(x, "haar", device=CPU)
    assert len(c) == len(jd.wavedec(x, "haar"))
    assert c[0].shape[-1] * (1 << (len(c) - 1)) == 96
    for pkg in (td, jd):
        kw = {"device": CPU} if pkg is td else {}
        with pytest.raises(ValueError):
            pkg.wavedec(x, "haar", 6, **kw)     # 2^6 does not divide 96
        c = list(pkg.wavedec(np.zeros((64,), np.float32), "db2", 3, **kw))
        c[1] = c[1][:7]
        with pytest.raises(ValueError):
            pkg.waverec(tuple(c), "db2")


# -- variance, covariance, correlation ----------------------------------------

@pytest.mark.parametrize("unbiased", [False, True])
def test_modwt_var_matches_jax(unbiased):
    x = _x((3, 512), 5)
    _close(td.modwt_var(x, "db8", 7, unbiased=unbiased, device=CPU),
           jd.modwt_var(x, "db8", 7, unbiased=unbiased))
    if unbiased:      # levels whose span exceeds N: NaN in both
        v = td.modwt_var(x, "db8", 7, unbiased=True, device=CPU).numpy()
        assert np.isnan(v[:, -2:]).all() and np.isfinite(v[:, :-2]).all()


def test_modwt_var_partitions_the_variance():
    x = _x((2, 1024), 5)
    w = td.modwt(x, "db4", 6, device=CPU).numpy()
    v = td.modwt_var(x, "db4", 6, device=CPU).numpy()
    total = v.sum(-1) + (w[:, -1] ** 2).mean(-1)
    np.testing.assert_allclose(total, (x ** 2).mean(-1), rtol=1e-5)


@pytest.mark.parametrize("unbiased", [False, True])
def test_modwt_cov_and_corr_match_jax(unbiased):
    rng = np.random.default_rng(7)
    n = 2048
    tone = np.sin(2 * np.pi * 40 * np.arange(n) / 1000.0)
    a = (tone + 0.5 * rng.standard_normal(n)).astype(np.float32)
    b = (tone + 0.5 * rng.standard_normal(n)).astype(np.float32)
    _close(td.modwt_cov(a, b, "db8", 6, unbiased=unbiased, device=CPU),
           jd.modwt_cov(a, b, "db8", 6, unbiased=unbiased))
    c = td.modwt_corr(a, b, "db8", 6, unbiased=unbiased, device=CPU)
    _close(c, jd.modwt_corr(a, b, "db8", 6, unbiased=unbiased))
    assert int(np.argmax(c.numpy())) == 3 and c[3] > 0.8
    np.testing.assert_allclose(
        td.modwt_corr(a, -a, "db4", 6, unbiased=unbiased,
                      device=CPU).numpy(), -1.0, atol=1e-5)


def test_modwt_corr_of_a_silent_scale_is_nan_in_both():
    """eps=0 keeps 0/0: a constant signal has no energy at any level."""
    x = np.ones(256, np.float32)
    y = _x((256,), 8)
    got = td.modwt_corr(x, y, "haar", 3, device=CPU).numpy()
    want = np.asarray(jd.modwt_corr(x, y, "haar", 3))
    assert np.isnan(want).all() and np.isnan(got).all()
    floored = td.modwt_corr(x, y, "haar", 3, eps=1e-3, device=CPU)
    _close(floored, jd.modwt_corr(x, y, "haar", 3, eps=1e-3))


def test_modwt_var_ci_matches_jax():
    x = _x((6, 2048), 9)
    got = td.modwt_var_ci(x, "db4", 4, device=CPU)
    want = jd.modwt_var_ci(x, "db4", 4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)
    v, lo, hi = (g.numpy() for g in got)
    assert np.all(lo < v) and np.all(v < hi) and np.all(lo > 0)
    v, lo, hi = (g.numpy() for g in td.modwt_var_ci(
        np.zeros(64, np.float32), "db8", 5, device=CPU))
    assert np.isnan(v[-1]) and np.isnan(lo[-1]) and np.isnan(hi[-1])


# -- pow2_pad and shrinkage ---------------------------------------------------

@pytest.mark.parametrize("n", [4, 5, 8, 9, 16, 17, 64, 65, 1024, 1025])
def test_pow2_pad_at_each_power_of_two_boundary(n):
    x = _x((2, n), n)
    got, n0 = td.pow2_pad(torch.from_numpy(x))
    want, nj = jd.pow2_pad(x)
    assert n0 == nj == n
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape[-1] == 1 << (n - 1).bit_length()


@pytest.mark.parametrize("mode", ["soft", "hard"])
@pytest.mark.parametrize("pad_pow2", [False, True])
def test_modwt_denoise_matches_jax(mode, pad_pow2):
    n = 3000 if pad_pow2 else 4096
    t = np.arange(n) / 1000.0
    clean = np.sin(2 * np.pi * 8 * t).astype(np.float32)
    noisy = clean + 0.4 * _x((3, n), 6)
    got = td.modwt_denoise(noisy, "db8", mode=mode, pad_pow2=pad_pow2,
                           device=CPU)
    _close(got, jd.modwt_denoise(noisy, "db8", mode=mode,
                                 pad_pow2=pad_pow2))
    assert got.shape == (3, n)
    mse_in = ((noisy - clean) ** 2).mean()
    assert ((got.numpy() - clean) ** 2).mean() < 0.5 * mse_in


def test_modwt_denoise_explicit_sigma_and_level_match_jax():
    x = _x((2, 1024), 10)
    _close(td.modwt_denoise(x, "db4", 5, sigma=0.4, device=CPU),
           jd.modwt_denoise(x, "db4", 5, sigma=0.4))
    with pytest.raises(ValueError):
        jd.modwt_denoise(x, mode="medium")
    with pytest.raises(ValueError):
        td.modwt_denoise(x, mode="medium", device=CPU)


def test_modwt_denoise_median_of_an_even_count():
    """The MAD's median of an even count is the mean of the two middle
    values (``jnp.median``), not ``torch.median``'s lower one: a 4-sample
    level-1 row tells them apart."""
    x = np.array([[0.0, 3.0, -1.0, 2.0]], np.float32)
    _close(td.modwt_denoise(x, "haar", 1, device=CPU),
           jd.modwt_denoise(x, "haar", 1))
