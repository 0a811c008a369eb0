"""The port's EMD / EEMD (``ninwavelets_tpu_torch.ops.emd``) against the
JAX package, on the CPU: the envelope machinery bit for bit, the sifting
on ``tests/test_emd.py``'s signals, completeness on random inputs.

Gates, each with its reason:

* the extrema masks, the knot compaction, the Akima envelope and the
  odd / even associative scan: exact, against the JAX functions run op by
  op (the same operations in the same order, each exactly rounded;
  ``_assoc_scan`` combines on the tree of ``jax.lax.associative_scan``);
  the natural-spline grid envelope within 1e-6 of the max of JAX's jitted
  one (it is bit for bit op by op too, but that run compiles every op of
  every scan level apart and costs 15 s);
* the envelopes against scipy's splines: ``tests/test_emd.py``'s 2e-4;
* the IMFs of the two-tone signals at 1e-4 of max|x| where the sifting
  has not met a near-tie: inside its ``jit`` XLA fuses ``a * b + c``
  into FMAs and turns ``x / 6`` into ``x * (1/6)``, so a sifted residual
  differs by an ulp or two, and an extremum that compares two samples
  within that ulp can flip and change every later sifting.  The
  natural-spline IMFs of the two tones hold to the fourth IMF; the Akima
  ones to the second (the third flips); the signals of the other JAX
  tests are held by those tests' own criteria;
* completeness ``sum(imfs) + residual == signal``: atol 2e-5 (the JAX
  tests' gate), on random inputs of several shapes;
* EEMD fed JAX's noise (``_eemd_from_noise``): the completeness gate, the
  JAX tests' criteria, and the first IMF at 1e-4 of max|x| where the
  ensemble averages the rare flips of single realizations.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from scipy.interpolate import Akima1DInterpolator, CubicSpline

from torch_threads import one_torch_thread  # noqa: F401

je = importlib.import_module("ninwavelets_tpu.ops.emd")
te = importlib.import_module("ninwavelets_tpu_torch.ops.emd")

from test_emd import N, SFREQ, _corr, _two_tones

CPU = "cpu"


def _knot_signal(seed, n=256, b=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n))
    k = np.hanning(21) / np.hanning(21).sum()
    return np.stack([np.convolve(r, k, mode="same") for r in x]).astype(
        np.float32)


def _both(x, kind):
    return (te._interior_extrema(torch.from_numpy(x), kind),
            je._interior_extrema(jnp.asarray(x), kind))


def test_knots_and_envelopes_are_the_jax_packages():
    """The masks, knots and Akima envelope bit for bit (op by op); the
    grid envelope, whose scans ``test_assoc_scan_is_lax_associative_scan``
    holds bit for bit, against JAX's jitted one within 1e-6 of the max
    (XLA's FMAs and reciprocal products)."""
    x = _knot_signal(0, n=256, b=3)
    grid = jax.jit(je._envelope_grid)
    for kind in ("max", "min"):
        mt, mj = _both(x, kind)
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
        for a, b in zip(te._knots(torch.from_numpy(x), mt),
                        je._knots(jnp.asarray(x), mj)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        got = te._envelope(torch.from_numpy(x), mt, "akima").numpy()
        want = np.asarray(je._envelope(jnp.asarray(x), mj, "akima"))
        np.testing.assert_array_equal(got, want)
        got = te._envelope(torch.from_numpy(x), mt, "natural").numpy()
        want = np.asarray(grid(jnp.asarray(x), mj))
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("n", [1, 2, 7, 24])
def test_assoc_scan_is_lax_associative_scan(n):
    rng = np.random.default_rng(n)
    mats = tuple(rng.standard_normal((2, n)).astype(np.float32)
                 for _ in range(4))
    got = te._assoc_scan(te._mob, tuple(map(torch.from_numpy, mats)))
    want = lax.associative_scan(_jax_mob, tuple(map(jnp.asarray, mats)),
                                axis=-1)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    aff = mats[:2]
    got = te._assoc_scan(te._aff, tuple(map(torch.from_numpy, aff)))
    want = lax.associative_scan(
        lambda p, q: (p[0] * q[0], q[1] + q[0] * p[1]),
        tuple(map(jnp.asarray, aff)), axis=-1)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _jax_mob(p, q):
    """The JAX package's Moebius combine (a closure of its grid envelope)."""
    p00, p01, p10, p11 = p
    q00, q01, q10, q11 = q
    r = (q00 * p00 + q01 * p10, q00 * p01 + q01 * p11,
         q10 * p00 + q11 * p10, q10 * p01 + q11 * p11)
    s = jnp.maximum(jnp.maximum(jnp.abs(r[0]), jnp.abs(r[1])),
                    jnp.maximum(jnp.abs(r[2]), jnp.abs(r[3])))
    s = jnp.where(s > 0, s, 1.0)
    return tuple(v / s for v in r)


def test_envelopes_match_scipy():
    """``tests/test_emd.py``'s spline oracles, on the port."""
    for seed in range(3):
        x = _knot_signal(seed, b=1)
        xt = torch.from_numpy(x)
        mask = te._interior_extrema(xt, "max")
        t, y, k, _ = te._knots(xt, mask)
        kv = int(k[0])
        tt, yy = t[0, :kv].double().numpy(), y[0, :kv].double().numpy()
        ref = CubicSpline(tt, yy, bc_type="natural")(np.arange(256))
        env = te._envelope(xt, mask, "natural")[0].numpy()
        assert np.abs(env - ref).max() / (np.abs(ref).max() + 1e-9) < 2e-4
        ref = Akima1DInterpolator(tt, yy)(np.arange(256))
        env = te._envelope(xt, mask, "akima")[0].numpy()
        lo, hi = int(tt[2]), int(tt[-3])
        assert (np.abs(env[lo:hi] - ref[lo:hi]).max()
                / (np.abs(ref[lo:hi]).max() + 1e-9)) < 2e-4


@pytest.mark.parametrize("spline,n_imfs,held", [("natural", 4, 4),
                                                ("akima", 4, 2)])
def test_two_tones_match_jax(spline, n_imfs, held):
    for kw in ({}, dict(a_hi=0.5, f_hi=60.0)):
        sig, hi, lo = _two_tones(**kw)
        imfs, res = te.emd(sig, n_imfs=n_imfs, spline=spline, device=CPU)
        ji, jr = je.emd(sig, n_imfs=n_imfs, spline=spline)
        scale = np.abs(sig).max()
        d = np.abs(imfs.numpy() - np.asarray(ji)).max(-1)
        assert d[:held].max() <= 1e-4 * scale, d
        assert _corr(imfs[0].numpy(), hi) > 0.95
        if spline == "natural":
            rest = imfs[1:].sum(0).numpy() + res.numpy()
            assert _corr(rest, lo) > 0.95


@pytest.mark.parametrize("shape,spline", [((3, 512), "natural"),
                                          ((2, 2, 300), "akima"),
                                          ((1000,), "natural")])
def test_completeness_on_random_inputs(shape, spline):
    x = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    imfs, res = te.emd(x, spline=spline, device=CPU)
    assert imfs.shape == shape[:-1] + (te.n_imfs_default(shape[-1]),
                                       shape[-1])
    np.testing.assert_allclose((imfs.sum(-2) + res).numpy(), x, atol=2e-5)


def test_batched_matches_single_and_degenerate_inputs():
    sig1, _, _ = _two_tones()
    sig2, _, _ = _two_tones(a_hi=0.5, f_hi=60.0)
    ib, _ = te.emd(np.stack([sig1, sig2]), n_imfs=3, device=CPU)
    i1, _ = te.emd(sig1, n_imfs=3, device=CPU)
    np.testing.assert_allclose(ib[0].numpy(), i1.numpy(), atol=1e-6)
    for x in (np.linspace(-1.0, 1.0, N).astype(np.float32),
              np.full(N, 0.7, np.float32)):
        imfs, res = te.emd(x, n_imfs=2, device=CPU)
        np.testing.assert_allclose(imfs.numpy(), 0.0, atol=1e-7)
        np.testing.assert_allclose(res.numpy(), x, atol=1e-7)
    imfs, res = te.emd(sig1.astype(np.float64), n_imfs=2, device=CPU)
    assert imfs.dtype == torch.float32 and res.dtype == torch.float32


def test_validation():
    for fn in (je.emd, je.eemd):
        with pytest.raises(ValueError):
            fn(np.zeros(4, np.float32))
    for fn in (te.emd, te.eemd):
        with pytest.raises(ValueError):
            fn(np.zeros(4, np.float32), device=CPU)
        with pytest.raises(ValueError):
            fn(np.zeros(64, np.float32), spline="pchip", device=CPU)


def _jax_noise(seed, e, b, n):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (e, b, n),
                                        jnp.float32))


def test_eemd_fed_jax_noise_matches_jax():
    sig, hi, _ = _two_tones()
    noise = _jax_noise(3, 12, 1, N)
    imfs, res = te._eemd_from_noise(
        torch.from_numpy(sig[None]), torch.from_numpy(noise), n_imfs=3,
        n_siftings=10, spline="natural", noise_strength=0.2)
    ji, jr = je.eemd(sig, n_imfs=3, n_ensembles=12, noise_strength=0.2,
                     seed=3)
    np.testing.assert_allclose((imfs.sum(-2) + res)[0].numpy(), sig,
                               atol=2e-5)
    d = np.abs(imfs[0, 0].numpy() - np.asarray(ji)[0]).max()
    assert d <= 1e-4 * np.abs(sig).max(), d
    got = imfs[0].numpy()
    assert max(_corr(got[j], hi) for j in range(2)) > 0.7
    assert _corr(got[:2].sum(0), hi) > 0.9


def test_eemd_separates_the_intermittent_burst():
    """``tests/test_emd.py``'s mode-mixing demo, on the port with its own
    generator: the carrier concentrates in one EEMD IMF."""
    t = np.arange(N) / SFREQ
    carrier = np.sin(2 * np.pi * 8.0 * t)
    burst = 0.4 * np.sin(2 * np.pi * 80.0 * t) * (
        np.sin(2 * np.pi * 1.0 * t) > 0.95)
    sig = (carrier + burst).astype(np.float32)
    i_emd, _ = te.emd(sig, n_imfs=4, device=CPU)
    i_eemd, r = te.eemd(sig, n_imfs=4, n_ensembles=32, seed=1, device=CPU)
    best_eemd = max(_corr(i_eemd[j].numpy(), carrier) for j in range(4))
    best_emd = max(_corr(i_emd[j].numpy(), carrier) for j in range(4))
    assert best_eemd > 0.95 and best_eemd >= best_emd - 0.02
    np.testing.assert_allclose((i_eemd.sum(-2) + r).numpy(), sig,
                               atol=2e-5)


def test_emd_imfs_feed_instantaneous():
    """The Hilbert-Huang pipeline: EMD modes through ``ops.vmd``'s
    ``instantaneous`` (``tests/test_emd.py``)."""
    from ninwavelets_tpu_torch.ops import instantaneous
    sig, _, _ = _two_tones()
    imfs, _ = te.emd(sig, n_imfs=2, device=CPU)
    if_hz, _ = instantaneous(imfs, SFREQ, smooth=9)
    assert abs(float(if_hz[0, N // 4:3 * N // 4].median()) - 40.0) < 2.0
