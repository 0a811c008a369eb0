"""The port's sleep-event detectors and microstates
(``ninwavelets_tpu_torch.ops.sleep`` / ``ops.microstates``) against the JAX
package, on the CPU, on ``tests/test_sleep.py``'s and
``tests/test_microstates.py``'s planted recordings.

Gates, each with its reason:

* event tables: starts, stops, validity and overflow flags exact (the
  planted events cross their thresholds well clear of round-off);
  durations, amplitudes and frequencies 1e-5 of the max (float32 filters
  on both sides; the moving RMS sums in float64 here, in float32 there,
  which at these lengths is within 1e-5; at an hour the JAX package's sum
  loses 3e-3, shown by ``test_moving_rms_float32_fault_in_jax_package``);
* the even-count median: ``jnp.median``'s mean of the two middle values
  exactly (``torch.median`` takes the lower one);
* microstates fed the JAX package's seed samples (``_fit_from_idx``):
  labels exact, maps per row at PR 15's eigenvector gate (1e-5 + 1e-6 x
  max|lam| / gap of that state's scatter, gaps asserted) up to its sign,
  GEV 1e-5; the statistics of a label series 1e-6 (float32 ratios of
  exact counts); the syntax test exactly (host numpy in both).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ninwavelets_tpu.ops import microstates as jm
from ninwavelets_tpu.ops import sleep as js
from ninwavelets_tpu_torch import convert
from ninwavelets_tpu_torch.ops import microstates as tm
from ninwavelets_tpu_torch.ops import sleep as ts
from ninwavelets_tpu_torch.ops.denoise import _median

from test_microstates import _match, _planted
from test_sleep import SFREQ, _so_signal, _spindle_signal
from torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"
GATE = 1e-5


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, gate=GATE):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got.astype(np.float64) - want).max() <= gate * max(
        np.abs(want).max(), 1e-30)


def _same_table(got, ref):
    assert isinstance(got, ts.EventTable)
    for f in ("start", "stop", "valid", "overflow"):
        np.testing.assert_array_equal(_np(getattr(got, f)),
                                      np.asarray(getattr(ref, f)))
    for f in ("duration", "peak_amp", "freq"):
        _close(getattr(got, f), getattr(ref, f))


def test_even_count_median_is_jnp_median():
    """``jnp.median`` averages the two middle values of an even count;
    ``torch.median`` takes the lower one; the detectors use the former."""
    x = np.random.default_rng(0).standard_normal((3, 10)).astype(np.float32)
    got = _median(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.median(x, -1)))
    assert not torch.equal(got, torch.median(torch.from_numpy(x), -1).values)
    np.testing.assert_array_equal(
        _median(torch.from_numpy(x[:, :9])).numpy(),
        np.asarray(jnp.median(x[:, :9], -1)))


def test_moving_rms_float32_fault_in_jax_package():
    """An hour at 256 Hz: the JAX package's float32 running sum loses 3e-3
    of the envelope's max against float64; the port's float64 sum keeps
    1e-6."""
    x = np.random.default_rng(1).standard_normal(921600).astype(np.float32)
    xf = ts._bandpass(torch.from_numpy(x)[None], 256.0, 11.0, 16.0)[0]
    x64 = xf.double().numpy()
    c = np.cumsum(x64 * x64)
    idx = np.arange(c.size)
    hi = np.minimum(idx + 25, c.size - 1)
    lo = np.maximum(idx - 26, -1)
    want = np.sqrt((c[hi] - np.where(lo >= 0, c[np.maximum(lo, 0)], 0.0))
                   / (hi - lo))
    jax_err = np.abs(np.asarray(js._moving_rms(jnp.asarray(xf.numpy()), 51))
                     - want).max() / want.max()
    port_err = np.abs(ts._moving_rms(xf[None], 51)[0].numpy()
                      - want).max() / want.max()
    assert jax_err > 1e-3 and port_err < 1e-6, (jax_err, port_err)


def test_spindles_match_jax_and_find_the_planted_events():
    x, starts = _spindle_signal()
    got = ts.detect_spindles(x, SFREQ, kmax=256, device=CPU)
    ref = js.detect_spindles(x, SFREQ, kmax=256)
    _same_table(got, ref)
    v = got.valid.numpy()
    np.testing.assert_allclose(got.start.numpy()[v] / SFREQ, starts,
                               atol=0.35)
    assert np.all(np.abs(got.freq.numpy()[v] - 13.0) < 1.5)
    tab = convert.event_table_from_jax(ref, device=CPU)
    np.testing.assert_array_equal(tab.start.numpy(), got.start.numpy())


@pytest.mark.parametrize("kw", [dict(thresh=2.0, duration=(0.3, 3.0)),
                                dict(freq_range=(10.0, 15.0),
                                     rms_win_s=0.3)])
def test_spindles_batched_match_jax(kw):
    rows = np.stack([_spindle_signal(seed=s, n_s=30,
                                     events=((5.0, 1.0), (18.0, 0.7)))[0]
                     for s in range(4)]).reshape(2, 2, -1)
    got = ts.detect_spindles(rows, SFREQ, kmax=128, device=CPU, **kw)
    ref = js.detect_spindles(rows, SFREQ, kmax=128, **kw)
    assert got.start.shape == (2, 2, 128)
    _same_table(got, ref)


def test_spindles_quiet_overflow_and_validation():
    rng = np.random.default_rng(3)
    quiet = rng.standard_normal(int(30 * SFREQ)).astype(np.float32)
    got = ts.detect_spindles(quiet, SFREQ, thresh=10.0, kmax=64, device=CPU)
    assert not got.valid.any()
    _same_table(got, js.detect_spindles(quiet, SFREQ, thresh=10.0, kmax=64))
    with pytest.raises(ValueError, match="kmax"):
        ts.detect_spindles(quiet, SFREQ, thresh=0.5, kmax=2, device=CPU)
    with pytest.raises(ValueError):
        ts.detect_spindles(quiet[:100], SFREQ, device=CPU)
    with pytest.raises(ValueError):
        ts.detect_spindles(quiet, SFREQ, freq_range=(11.0, 120.0),
                           device=CPU)


@pytest.mark.parametrize("amps", [None, (1.5, 3.0)])
def test_slow_oscillations_match_jax(amps):
    x, starts = _so_signal()
    kw = {} if amps is None else dict(amp_neg=amps[0], amp_ptp=amps[1])
    got = ts.detect_slow_oscillations(x, SFREQ, kmax=1024, device=CPU, **kw)
    ref = js.detect_slow_oscillations(x, SFREQ, kmax=1024, **kw)
    _same_table(got, ref)
    v = got.valid.numpy()
    np.testing.assert_allclose(got.start.numpy()[v] / SFREQ, starts,
                               atol=0.1)


def test_slow_oscillations_batched_starting_positive_and_validation():
    x, _ = _so_signal(n_s=60, events=(10.0, 30.0))
    rows = np.stack([x, -x[::-1], np.roll(x, 37), 0.5 * x])
    got = ts.detect_slow_oscillations(rows, SFREQ, kmax=1024, device=CPU)
    _same_table(got, js.detect_slow_oscillations(rows, SFREQ, kmax=1024))
    with pytest.raises(ValueError):
        ts.detect_slow_oscillations(x, SFREQ, amp_neg=1.0, device=CPU)
    with pytest.raises(ValueError):
        ts.detect_slow_oscillations(x[:500], SFREQ, device=CPU)
    with pytest.raises(ValueError, match="kmax"):
        ts.detect_slow_oscillations(x, SFREQ, kmax=4, device=CPU)


# -- microstates --------------------------------------------------------------

def _jax_idx(x, k, n_init, seed, peaks_only=True):
    """The JAX package's seed samples of each restart."""
    xa = jm._avg_ref(jnp.asarray(x, jnp.float32))
    g = jm.gfp(xa)
    w = jm._peak_mask(g) if peaks_only else jnp.ones_like(g)
    keys = jax.random.split(jax.random.PRNGKey(seed), n_init)
    return np.stack([np.asarray(jax.random.choice(
        key, x.shape[1], (k,), replace=False, p=w / jnp.sum(w)))
        for key in keys])


def _maps_agree(got, ref, x, labels, w):
    """Each map at the eigenvector gate of its state's scatter, up to
    sign."""
    xa = x - x.mean(0, keepdims=True)
    for k in range(ref.shape[0]):
        sel = (labels == k) & (w > 0)
        s = (xa[:, sel].astype(np.float64) @ xa[:, sel].T.astype(
            np.float64))
        lam = np.linalg.eigvalsh(s)
        gap = lam[-1] - lam[-2]
        assert gap > 0.1 * lam[-1]
        sign = np.sign(np.dot(got[k], ref[k]))
        gate = 1e-5 + 1e-6 * np.abs(lam).max() / gap
        assert np.abs(sign * got[k] - ref[k]).max() <= gate


def test_gfp_and_backfit_match_jax():
    x, maps, _ = _planted(c=12, t=1500)
    _close(tm.gfp(x, device=CPU), jm.gfp(x))
    np.testing.assert_array_equal(
        tm.microstate_backfit(x, maps, device=CPU).numpy(),
        np.asarray(jm.microstate_backfit(x, maps)))


@pytest.mark.parametrize("peaks_only,n_init", [(True, 4), (False, 2)])
def test_fit_from_jax_draws_matches_jax(peaks_only, n_init):
    x, _, _ = _planted(c=12, t=1200, seed=1)
    idx = _jax_idx(x, 4, n_init, 3, peaks_only)
    got = tm._fit_from_idx(x, idx, n_states=4, peaks_only=peaks_only,
                           n_iter=8, device=CPU)
    ref = jm.microstate_fit(x, 4, peaks_only=peaks_only, n_init=n_init,
                            n_iter=8, seed=3)
    assert isinstance(got, tm.MicrostateResult)
    labels = got.labels.numpy()
    np.testing.assert_array_equal(labels, np.asarray(ref.labels))
    assert got.labels.dtype == torch.int32
    g = np.asarray(jm.gfp(jm._avg_ref(jnp.asarray(x))))
    w = np.asarray(jm._peak_mask(g)) if peaks_only else np.ones_like(g)
    _maps_agree(got.maps.numpy(), np.asarray(ref.maps), x, labels, w)
    _close(got.gev, ref.gev)
    _close(got.gev_per_state, ref.gev_per_state)


def test_fit_with_own_draws_recovers_the_planted_maps():
    x, maps, _ = _planted(c=16, t=2000, seed=2)
    res = tm.microstate_fit(x, 4, n_init=4, n_iter=15, seed=0, device=CPU)
    _, score = _match(res.maps.numpy(), maps)
    assert score > 0.95, score
    assert float(res.gev) > 0.9
    again = tm.microstate_fit(x, 4, n_init=4, n_iter=15, seed=0, device=CPU)
    assert torch.equal(res.labels, again.labels)
    conv = convert.microstate_result_from_jax(
        jm.microstate_fit(x, 4, n_init=2, n_iter=5), device=CPU)
    assert conv.maps.shape == (4, 16)


def test_fit_validation():
    x, _, _ = _planted(c=8, t=500)
    with pytest.raises(ValueError):
        tm.microstate_fit(x[0], 4, device=CPU)
    with pytest.raises(ValueError):
        tm.microstate_fit(x, 8, device=CPU)
    flat = np.ones((8, 500), np.float32)
    with pytest.raises(ValueError, match="GFP peaks"):
        tm.microstate_fit(flat, 3, device=CPU)


def test_stats_and_syntax_test_match_jax():
    rng = np.random.default_rng(4)
    labels = np.repeat(rng.integers(0, 4, 300),
                       rng.integers(3, 30, 300)).astype(np.int32)
    got = tm.microstate_stats(torch.from_numpy(labels), 4, 250.0)
    ref = jm.microstate_stats(labels, 4, 250.0)
    assert got.keys() == ref.keys()
    for k in ref:
        assert isinstance(got[k], np.ndarray)
        _close(got[k], ref[k], 1e-6)
    assert tm.microstate_syntax_test(labels, 4, 50, seed=1) == \
        jm.microstate_syntax_test(labels, 4, 50, seed=1)
    with pytest.raises(ValueError):
        tm.microstate_syntax_test(np.zeros(10, np.int32), 4)
