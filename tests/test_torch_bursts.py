"""The port's burst detection (``ninwavelets_tpu_torch.ops.bursts`` and
``EpochsWavelet.bursts``) against the JAX package on the same planes, on
the CPU, and against ``tests/test_bursts.py``'s hand-placed bursts.

Gates, each with its reason:

* thresholds: exact on planes whose row medians are exact in float32 (the
  median of an even count is the mean of its two middle values in both
  packages: ``jnp.median``'s rule, which ``torch.median`` does not follow);
* burst counts, durations and spans, the table's rows (epoch, times, rows,
  area): exact (counts, minima and maxima of integer indices); peaks: exact
  (a max);
* the summary's rates and per-epoch means: rtol 1e-6 (a float32 sum over
  the roots in another order; XLA divides by a constant, the seconds or
  ``sfreq``, as a product by its reciprocal, 1 ulp from a division);
* the adapter: the single-trial power planes differ at float32 round-off
  (``tests/test_torch_zoo.py``), so its threshold is moved off every pixel
  by rule (a factor for which no pixel lies within 1e-4 relative of a row
  threshold); then counts and the table's times, rows and areas are held
  exactly, the means as above, and peaks at rtol 1e-5 (the planes' own
  round-off).
"""
import numpy as np
import pytest
import torch

import ninwavelets_tpu as nw
import ninwavelets_tpu_torch as nt
from ninwavelets_tpu.ops import bursts as jb
from ninwavelets_tpu_torch.ops import bursts as tb

from torch_threads import one_torch_thread  # noqa: F401

SFREQ = 250.0
MEAN_RTOL = 1e-6


def _planes():
    """(3, 8, 100) power planes with hand-placed bursts over a floor of
    1.0: epoch 0 has two bursts, epoch 1 one, epoch 2 none."""
    x = np.ones((3, 8, 100), np.float32)
    x[0, 2:4, 10:20] = 10.0    # burst A: rows 2-3, samples 10-19
    x[0, 6:7, 50:75] = 8.0     # burst B: row 6, samples 50-74
    x[1, 1:5, 30:40] = 12.0
    return x


def _noisy(seed=3, e=5, f=9, n=64):
    rng = np.random.default_rng(seed)
    return rng.exponential(1.0, (e, f, n)).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _check_summary(got, want):
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=MEAN_RTOL, atol=0)


class TestSummary:
    def test_counts_and_stats(self):
        x = _planes()
        thr = np.full(8, 5.0, np.float32)
        s = tb.burst_summary(_t(x), threshold=_t(thr), sfreq=SFREQ,
                             freq_step=2.0)
        _check_summary(s, jb.burst_summary(x, threshold=thr, sfreq=SFREQ,
                                           freq_step=2.0))
        np.testing.assert_array_equal(s.count.numpy(), [2, 1, 0])
        assert float(s.mean_duration[0]) == pytest.approx(17.5 / SFREQ)
        assert float(s.mean_span[1]) == pytest.approx(8.0)
        np.testing.assert_allclose(s.mean_peak.numpy(), [9.0, 12.0, 0.0])

    @pytest.mark.parametrize("min_area", [1, 3, 8])
    def test_noise_matches_jax(self, min_area):
        x = _noisy()
        thr = np.asarray(jb.burst_threshold(x, 2.0))
        got = tb.burst_summary(_t(x), threshold=_t(thr), sfreq=SFREQ,
                               freq_step=0.5, min_area=min_area)
        want = jb.burst_summary(x, threshold=thr, sfreq=SFREQ,
                                freq_step=0.5, min_area=min_area)
        _check_summary(got, want)
        assert float(got.count.sum()) > 5

    def test_median_threshold(self):
        x = _planes()
        thr = tb.burst_threshold(_t(x), factor=6.0)
        np.testing.assert_array_equal(thr.numpy(), np.full(8, 6.0))
        s = tb.burst_summary(_t(x), sfreq=SFREQ)
        np.testing.assert_array_equal(s.count.numpy(), [2, 1, 0])

    def test_median_of_an_even_count_is_the_mid_mean(self):
        # 2 x 3 values a row: the two middle ones are averaged, as
        # jnp.median does (torch.median would take the lower one)
        x = np.arange(2 * 4 * 3, dtype=np.float32).reshape(2, 4, 3)
        got = tb.burst_threshold(_t(x), factor=1.0).numpy()
        np.testing.assert_array_equal(got, np.asarray(
            jb.burst_threshold(x, factor=1.0)))
        np.testing.assert_array_equal(got, np.median(
            x.transpose(1, 0, 2).reshape(4, -1), -1))

    def test_min_area_filters_specks(self):
        x = _planes()
        x[2, 0, 0] = 100.0           # single-pixel speck
        thr = _t(np.full(8, 5.0))
        s = tb.burst_summary(_t(x), threshold=thr, sfreq=SFREQ)
        np.testing.assert_array_equal(s.count.numpy(), [2, 1, 1])
        s2 = tb.burst_summary(_t(x), threshold=thr, sfreq=SFREQ,
                              min_area=5)
        np.testing.assert_array_equal(s2.count.numpy(), [2, 1, 0])
        t = tb.burst_table(_t(x), threshold=thr, sfreq=SFREQ, min_area=5)
        assert all(b["epoch"] != 2 for b in t)

    def test_validation(self):
        with pytest.raises(ValueError):
            tb.burst_summary(torch.zeros((4, 8)))


class TestTable:
    def test_burst_listing_matches_jax(self):
        x = _planes()
        freqs = np.arange(10.0, 26.0, 2.0)
        thr = np.full(8, 5.0, np.float32)
        table = tb.burst_table(_t(x), threshold=_t(thr), sfreq=SFREQ,
                               freqs=freqs)
        assert table == jb.burst_table(x, threshold=thr, sfreq=SFREQ,
                                       freqs=freqs)
        assert len(table) == 3
        a = [b for b in table if b["epoch"] == 0 and b["area"] == 20][0]
        assert (a["t_start"], a["t_stop"]) == (10 / SFREQ, 20 / SFREQ)
        assert (a["f_lo"], a["f_hi"]) == (14.0, 16.0)
        assert a["peak"] == 10.0

    @pytest.mark.parametrize("min_area,freqs", [(1, None), (4, "hz")])
    def test_noise_listing_matches_jax(self, min_area, freqs):
        x = _noisy(seed=4)
        if freqs == "hz":
            freqs = np.linspace(4.0, 12.0, x.shape[1])
        got = tb.burst_table(_t(x), sfreq=SFREQ, freqs=freqs, factor=2.5,
                             min_area=min_area)
        want = jb.burst_table(x, sfreq=SFREQ, freqs=freqs, factor=2.5,
                              min_area=min_area)
        assert got == want and len(got) > 5


class TestEndToEnd:
    def test_beta_bursts_on_synthetic_signal(self):
        rng = np.random.default_rng(2)
        n, e = 1024, 6
        t = np.arange(n) / SFREQ
        sig = 0.3 * rng.standard_normal((e, n)).astype(np.float32)
        for win in ((0.8, 1.1), (2.4, 2.8)):
            m = ((t > win[0]) & (t < win[1])).astype(np.float32)
            sig += (2.0 * np.sin(2 * np.pi * 20 * t) * m).astype(np.float32)
        ew = nt.EpochsWavelet(
            nt.ArrayEpochs(sig[:, None, :], SFREQ, ch_names=["c"]),
            nt.Morse(SFREQ, device="cpu"))
        freqs = np.arange(12.0, 30.0, 2.0)
        trials = ew.single_trial_power("c", freqs)
        s = tb.burst_summary(trials, sfreq=SFREQ, freq_step=2.0,
                             factor=20.0, min_area=10)
        np.testing.assert_array_equal(s.count.numpy(), np.full(e, 2.0))
        assert 0.2 < float(s.mean_duration.mean()) < 0.6
        table = tb.burst_table(trials, sfreq=SFREQ, freqs=freqs,
                               factor=20.0, min_area=10)
        starts = sorted(b["t_start"] for b in table if b["epoch"] == 0)
        assert abs(starts[0] - 0.8) < 0.15 and abs(starts[1] - 2.4) < 0.15
        # the same planes through the JAX package
        x = trials.numpy()
        _check_summary(s, jb.burst_summary(x, sfreq=SFREQ, freq_step=2.0,
                                           factor=20.0, min_area=10))
        assert table == jb.burst_table(x, sfreq=SFREQ, freqs=freqs,
                                       factor=20.0, min_area=10)


def _clear_factor(trials, factor):
    """The first of factor, factor + 0.01, ... for which no pixel lies
    within 1e-4 (relative) of its row threshold."""
    x = np.asarray(trials, np.float64)
    med = np.median(x.transpose(1, 0, 2).reshape(x.shape[1], -1), -1)
    while (np.abs(x / (factor * med)[None, :, None] - 1) < 1e-4).any():
        factor += 0.01
    return factor


@pytest.mark.parametrize("table", [False, True])
def test_adapter_bursts_match_jax(table):
    rng = np.random.default_rng(4)
    n = 512
    t = np.arange(n) / SFREQ
    sig = 0.2 * rng.standard_normal((4, 1, n)).astype(np.float32)
    m = ((t > 0.8) & (t < 1.2)).astype(np.float32)
    sig[:, 0, :] += (2.0 * np.sin(2 * np.pi * 20 * t) * m).astype(np.float32)
    ew_j = nw.EpochsWavelet(nw.ArrayEpochs(sig, SFREQ, ch_names=["c"]),
                            nw.Morse(SFREQ))
    ew_t = nt.EpochsWavelet(nt.ArrayEpochs(sig, SFREQ, ch_names=["c"]),
                            nt.Morse(SFREQ, device="cpu"))
    freqs = np.arange(14.0, 28.0, 2.0)
    factor = _clear_factor(ew_j.single_trial_power("c", freqs), 20.0)
    got = ew_t.bursts("c", freqs, factor=factor, min_area=10, table=table)
    want = ew_j.bursts("c", freqs, factor=factor, min_area=10, table=table)
    if table:
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            assert {k: g[k] for k in g if k != "peak"} == \
                {k: w[k] for k in w if k != "peak"}
            assert g["peak"] == pytest.approx(w["peak"], rel=1e-5)
            assert 0.6 < g["t_start"] < 1.0
    else:
        np.testing.assert_array_equal(got.count.numpy(), np.ones(4))
        np.testing.assert_array_equal(got.count.numpy(),
                                      np.asarray(want.count))
        for name in ("rate", "mean_duration", "mean_span"):
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(want, name)),
                                       rtol=MEAN_RTOL, atol=0)
        np.testing.assert_allclose(got.mean_peak.numpy(),
                                   np.asarray(want.mean_peak), rtol=1e-5)


def test_adapter_bursts_need_a_uniform_grid():
    ew = nt.EpochsWavelet(nt.ArrayEpochs(np.zeros((2, 1, 256), np.float32),
                                         SFREQ, ch_names=["c"]),
                          nt.Morse(SFREQ, device="cpu"))
    with pytest.raises(ValueError, match="uniformly spaced"):
        ew.bursts("c", [10.0, 12.0, 16.0])
