"""The port's signal simulators (``ninwavelets_tpu_torch.ops.sim``) against
the JAX package, on the CPU, each random generator fed the JAX package's
own draws through its ``_*_from_noise`` entry.

Gates, each with its reason:

* shaped noise, AR(1) noise, oscillations and mixtures: max|d| <= 1e-5 x
  max|ref| (float32 FFTs, sums and ``sin`` on both sides; the AR(1)
  recurrence blocked here, sequential there, held at r = 0.7 and beyond);
* the burst gate exactly; the gated sine within 4 ulps of its phase (the
  jitted JAX program rounds ``2 pi f t`` to another float32 neighbour at
  large t);
* IAAFT fed JAX's shuffles: equal surrogates (stable sorts on both
  sides) and the sorted values kept exactly; where a surrogate parts from
  JAX's, it parts first at values that the amplitude step put within 1e-5
  of the max of another one (a rank near-tie; shown by bisection on a
  random walk, whose amplitude steps converge on close values).
"""
import jax
import numpy as np
import pytest
import torch

from ninwavelets_tpu.ops import sim as js
from ninwavelets_tpu_torch.ops import sim as ts

from torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"
GATE = 1e-5
KEY = jax.random.PRNGKey(7)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, gate=GATE):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got.astype(np.float64) - want).max() <= gate * max(
        np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("exponent,shape", [(-2.0, (2, 1000)),
                                            (-1.0, (3, 512)),
                                            (0.0, (700,))])
def test_powerlaw_from_jax_noise(exponent, shape):
    npad = 1 << int(np.ceil(np.log2(shape[-1])))
    white = jax.random.normal(KEY, shape[:-1] + (npad,))
    got = ts._powerlaw_from_noise(_t(white), exponent, shape[-1])
    _close(got, js.powerlaw_noise(KEY, shape, exponent))
    x = ts.powerlaw_noise(0, shape, exponent, device=CPU)
    assert x.shape == shape
    assert torch.allclose(x.std(-1, correction=0), torch.ones(()), atol=1e-5)


@pytest.mark.parametrize("r", [0.7, 0.95, -0.5])
def test_ar1_from_jax_noise(r):
    e = jax.random.normal(KEY, (3, 4000))
    _close(ts._ar1_from_noise(_t(e), r), js.ar1_noise(KEY, (3, 4000), r))


def test_ar1_lag_one_autocorrelation_and_validation():
    x = ts.ar1_noise(1, (4, 20000), 0.7, device=CPU).double()
    lag1 = (x[:, 1:] * x[:, :-1]).mean(-1) / (x * x).mean(-1)
    assert torch.all((lag1 - 0.7).abs() < 0.03)
    with pytest.raises(ValueError):
        ts.ar1_noise(0, (10,), 1.0, device=CPU)


@pytest.mark.parametrize("freq,phase,rdsym", [(10.0, 0.3, 0.3),
                                              (3.5, 0.0, 0.7)])
def test_oscillations_match_jax(freq, phase, rdsym):
    _close(ts.oscillation(3000, 250.0, freq, phase, device=CPU),
           js.oscillation(3000, 250.0, freq, phase))
    _close(ts.asym_oscillation(3000, 250.0, freq, rdsym, device=CPU),
           js.asym_oscillation(3000, 250.0, freq, rdsym))
    with pytest.raises(ValueError):
        ts.asym_oscillation(100, 250.0, freq, 1.0, device=CPU)


@pytest.mark.parametrize("enter,leave", [(0.2, 0.3), (0.05, 0.5),
                                         (1.0, 0.0)])
def test_bursty_from_jax_noise(enter, leave):
    n, sfreq, freq = 5000, 250.0, 10.0
    n_cycles = int(np.ceil(n * freq / sfreq)) + 1
    u = jax.random.uniform(KEY, (n_cycles,))
    sig, gate = ts._bursty_from_noise(_t(u), n, sfreq, freq, enter, leave)
    rs, rg = js.bursty_oscillation(KEY, n, sfreq, freq, enter, leave)
    np.testing.assert_array_equal(gate.numpy(), np.asarray(rg))
    phase = 2 * np.pi * freq * np.arange(n) / sfreq
    bound = 4 * np.finfo(np.float32).eps * np.maximum(phase, 1.0)
    assert np.all(np.abs(sig.numpy() - np.asarray(rs)) <= bound)
    # the chain itself, against a host loop
    state, want = 0.0, []
    for v in np.asarray(u):
        state = float(v > leave) if state > 0 else float(v < enter)
        want.append(state)
    np.testing.assert_array_equal(
        ts._markov_gate(_t(u), enter, leave).numpy(), want)


def test_combine_matches_jax_and_seeds_repeat():
    rng = np.random.default_rng(0)
    s, nz = rng.standard_normal((2, 2, 800)).astype(np.float32)
    _close(ts.combine(s, nz, 3.0, device=CPU), js.combine(s, nz, 3.0))
    a = ts.bursty_oscillation(5, 1000, 250.0, 8.0, device=CPU)
    b = ts.bursty_oscillation(torch.Generator().manual_seed(5), 1000, 250.0,
                              8.0)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(ValueError):
        ts.bursty_oscillation(0, 100, 250.0, 8.0, enter_prob=2.0, device=CPU)


def _jax_noise(x, s=3):
    return np.stack([np.asarray(jax.random.normal(k, x.shape))
                     for k in jax.random.split(KEY, s)])


@pytest.mark.parametrize("n_iter,shape", [(1, (256,)), (5, (2, 128)),
                                          (40, (512,))])
def test_iaaft_from_jax_noise(n_iter, shape):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    got = ts._iaaft_from_noise(_t(x), _t(_jax_noise(x)), n_iter)
    ref = js.iaaft_surrogates(KEY, x, 3, n_iter)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(np.sort(got.numpy(), -1),
                                  np.broadcast_to(np.sort(x, -1), got.shape))


def test_iaaft_parts_from_jax_only_at_a_rank_near_tie():
    """A random walk's surrogates follow JAX's until an amplitude step puts
    two values within round-off of each other; the first iteration where a
    surrogate differs (found by bisection) differs only at such values."""
    x = np.cumsum(np.random.default_rng(1).standard_normal(512)).astype(
        np.float32)
    noise = _t(_jax_noise(x))

    def same(k):
        return np.array_equal(
            ts._iaaft_from_noise(_t(x), noise, k).numpy(),
            np.asarray(js.iaaft_surrogates(KEY, x, 3, k)))

    lo, hi = 1, 16
    assert same(lo)
    if same(hi):
        return
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if same(mid) else (lo, mid)
    prev = ts._iaaft_from_noise(_t(x), noise, lo)
    spec = torch.fft.rfft(prev)
    y = torch.fft.irfft(spec / spec.abs().clamp(min=1e-30)
                        * torch.fft.rfft(_t(x)).abs(), n=x.size).numpy()
    diff = ts._iaaft_from_noise(_t(x), noise, hi).numpy() != np.asarray(
        js.iaaft_surrogates(KEY, x, 3, hi))
    ys = np.sort(y, -1)
    gaps = np.minimum(np.abs(np.diff(ys, prepend=-np.inf)),
                      np.abs(np.diff(ys, append=np.inf)))
    near = gaps[np.arange(3)[:, None], np.argsort(np.argsort(y, -1), -1)]
    assert np.all(near[diff] <= 1e-5 * np.abs(y).max()), near[diff]


def test_iaaft_keeps_values_and_spectrum_and_validation():
    x = ts.powerlaw_noise(2, (1024,), -1.0, device=CPU)
    s = ts.iaaft_surrogates(3, x, n_surrogates=4, n_iter=50, device=CPU)
    assert s.shape == (4, 1024)
    assert torch.equal(torch.sort(s, -1).values,
                       torch.sort(x, -1).values.expand(4, -1))
    amp = torch.fft.rfft(x).abs()
    err = (torch.fft.rfft(s).abs() - amp).norm(dim=-1) / amp.norm()
    assert torch.all(err < 0.1), err
    assert not torch.equal(s[0], x)
    with pytest.raises(ValueError):
        ts.iaaft_surrogates(0, x[:1000], device=CPU)
    with pytest.raises(ValueError):
        ts.iaaft_surrogates(0, x, n_iter=0, device=CPU)
