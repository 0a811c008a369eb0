"""The port's ERP measures and complexity measures
(``ninwavelets_tpu_torch.ops.erp`` / ``ops.complexity``) against the JAX
package, on the CPU, on numpy-seeded inputs.

Gates, each with its reason:

* waveforms, amplitudes, entropies, DFA exponents and fluctuations:
  max|d| <= 1e-5 x max|ref| (float32 sums and logs on both sides, in
  other orders);
* latencies, onsets, template-match counts and ordinal codes: exact,
  except at a decision whose margin is below round-off (a crossing of the
  area or onset criterion, or a peak, within 1e-5 of the window's scale;
  a template distance within 1e-6 of the tolerance), with the margins
  computed in float64 and asserted;
* the tie rule of the ordinal patterns: exact against JAX and against a
  numpy stable double argsort.
"""
import jax
import numpy as np
import pytest
import torch

from ninwavelets_tpu.ops import complexity as jc
from ninwavelets_tpu.ops import erp as je
from ninwavelets_tpu_torch import convert
from ninwavelets_tpu_torch.ops import complexity as tc
from ninwavelets_tpu_torch.ops import erp as te
from ninwavelets_tpu_torch.ops.signal_utils import row_cumsum

CPU = "cpu"
GATE = 1e-5


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, gate=GATE):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got.astype(np.float64) - want).max() <= gate * max(
        np.abs(want).max(), 1e-30)


def _equal_but_ties(got, want, margin, tol):
    """Equal, except where a decision's margin is below ``tol``."""
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape
    diff = got != want
    assert np.all(np.asarray(margin)[diff] < tol), np.asarray(margin)[diff]
    assert diff.mean() <= 0.05


def _waves(e=8, c=3, n=240, seed=0):
    """Noisy trials of a positive component at 120 samples and a
    negative one at 170."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    comp = (3.0 * np.exp(-0.5 * ((t - 120) / 15.0) ** 2)
            - 2.0 * np.exp(-0.5 * ((t - 170) / 10.0) ** 2))
    return (comp + rng.standard_normal((e, c, n))).astype(np.float32)


def _peak_margin(seg):
    """Gap between the two largest values of each (..., L) row."""
    s = np.sort(seg, axis=-1)
    return s[..., -1] - s[..., -2]


def _onset_margin(seg, crit):
    """Smallest |seg_t - crit x peak| over the samples that decide the
    onset (from the last one below the criterion to the peak), and the
    peak's own margin."""
    pk = seg.argmax(-1)
    thr = crit * np.take_along_axis(seg, pk[..., None], -1)
    t = np.arange(seg.shape[-1])
    below = (seg < thr) & (t <= pk[..., None])
    last = np.where(below.any(-1), seg.shape[-1] - 1
                    - np.argmax(below[..., ::-1], -1), 0)
    rel = (t >= last[..., None]) & (t <= pk[..., None])
    m = np.where(rel, np.abs(seg - thr), np.inf).min(-1)
    return np.minimum(m, _peak_margin(seg))


def test_evoked_and_mean_amplitude_match_jax():
    x = _waves()
    _close(te.evoked(x, device=CPU), je.evoked(x))
    _close(te.mean_amplitude(x, (100, 140), device=CPU),
           je.mean_amplitude(x, (100, 140)))
    assert te.evoked(torch.from_numpy(x)).device.type == "cpu"


@pytest.mark.parametrize("polarity,window", [(1, (90, 150)), (-1, None),
                                             (-1, (140, 200))])
def test_peak_measures_match_jax(polarity, window):
    x = _waves()
    got = te.peak_measures(x, window, polarity, device=CPU)
    ref = je.peak_measures(x, window, polarity)
    assert isinstance(got, te.PeakResult)
    assert got.latency.dtype == torch.int32
    lo, hi = window or (0, x.shape[-1])
    seg = x[..., lo:hi].astype(np.float64) * polarity
    _equal_but_ties(got.latency, ref.latency, _peak_margin(seg),
                    GATE * np.abs(seg).max())
    _close(got.amplitude, ref.amplitude)
    conv = convert.peak_result_from_jax(ref, device=CPU)
    np.testing.assert_array_equal(conv.latency.numpy(), ref.latency)


@pytest.mark.parametrize("fraction", [0.25, 0.5, 0.8])
@pytest.mark.parametrize("polarity", [1, -1])
def test_fractional_area_latency_matches_jax(fraction, polarity):
    x = _waves()
    window = (90, 200)
    got = te.fractional_area_latency(x, window, fraction, polarity,
                                     device=CPU)
    ref = je.fractional_area_latency(x, window, fraction, polarity)
    seg = np.maximum(x[..., 90:200].astype(np.float64) * polarity, 0.0)
    c = np.cumsum(seg, -1)
    margin = np.abs(c - fraction * c[..., -1:]).min(-1)
    _equal_but_ties(got, ref, margin, GATE * c[..., -1].max())
    assert got.dtype == torch.int32


@pytest.mark.parametrize("criterion", [0.3, 0.5])
@pytest.mark.parametrize("polarity", [1, -1])
def test_fractional_peak_onset_matches_jax(criterion, polarity):
    x = _waves(seed=1)
    window = (60, 200)
    got = te.fractional_peak_onset(x, window, criterion, polarity,
                                   device=CPU)
    ref = je.fractional_peak_onset(x, window, criterion, polarity)
    seg = x[..., 60:200].astype(np.float64) * polarity
    _equal_but_ties(got, ref, _onset_margin(seg, criterion),
                    GATE * np.abs(seg).max())


@pytest.mark.parametrize("polarity", [1, -1])
def test_jackknife_onsets_match_jax(polarity):
    x = _waves(e=12, seed=2)
    got = te.jackknife_onsets(x, (60, 200), 0.5, polarity, device=CPU)
    ref = je.jackknife_onsets(x, (60, 200), 0.5, polarity)
    x64 = x.astype(np.float64)
    loo = (x64.sum(0, keepdims=True) - x64) / (x.shape[0] - 1.0)
    seg = loo[..., 60:200] * polarity
    _equal_but_ties(got[0], ref[0], _onset_margin(seg, 0.5),
                    GATE * np.abs(seg).max())
    if np.array_equal(_np(got[0]), np.asarray(ref[0])):
        _close(got[1], ref[1])
        _close(got[2], ref[2])


def test_erp_known_answers_and_validation():
    t = np.arange(600)
    wave = (5.0 * np.exp(-0.5 * ((t - 300) / 40.0) ** 2)).astype(np.float32)
    pk = te.peak_measures(wave, device=CPU)
    assert int(pk.latency) == 300 and abs(float(pk.amplitude) - 5.0) < 1e-5
    assert int(te.fractional_area_latency(wave, (100, 500), 0.5,
                                          device=CPU)) in (299, 300)
    with pytest.raises(ValueError):
        te.peak_measures(wave, (500, 100), device=CPU)
    with pytest.raises(ValueError):
        te.fractional_area_latency(wave, (0, 10), 1.0, device=CPU)
    with pytest.raises(ValueError):
        te.fractional_peak_onset(wave, (0, 10), 0.0, device=CPU)
    with pytest.raises(ValueError):
        te.jackknife_onsets(wave[None], (0, 10), device=CPU)


# -- complexity ---------------------------------------------------------------

def _series(shape=(2, 3, 160), seed=3):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _pair_margin(x, m, r):
    """Smallest |Chebyshev distance - r| over the template pairs at m and
    m + 1 of each (N,) row, in float64."""
    out = []
    rows = x.reshape(-1, x.shape[-1]).astype(np.float64)
    for row, rr in zip(rows, np.broadcast_to(r, x.shape[:-1]).reshape(-1)):
        np_ = row.size - m
        d = np.abs(row[:, None] - row[None, :])
        cheb = d[:np_, :np_]
        for k in range(1, m):
            cheb = np.maximum(cheb, d[k:k + np_, k:k + np_])
        cheb1 = np.maximum(cheb, d[m:m + np_, m:m + np_])
        out.append(min(np.abs(cheb - rr).min(), np.abs(cheb1 - rr).min()))
    return np.asarray(out).reshape(x.shape[:-1])


@pytest.mark.parametrize("m", [1, 2, 3])
def test_sample_entropy_counts_exact(m):
    """The template-match counts at a given tolerance, pair by pair."""
    x = _series((5, 150))
    r = 0.2 * x.std(-1)
    got_b, got_a = tc._sampen_counts(torch.from_numpy(x), m,
                                     torch.from_numpy(r))
    ref_b, ref_a = jax.vmap(lambda s, q: jc._sampen_counts(s, m, q))(x, r)
    margin = _pair_margin(x, m, r)
    _equal_but_ties(got_b, np.asarray(ref_b).astype(np.int64), margin, 1e-6)
    _equal_but_ties(got_a, np.asarray(ref_a).astype(np.int64), margin, 1e-6)


@pytest.mark.parametrize("m,scale_r", [(2, True), (1, False), (3, True)])
def test_sample_entropy_matches_jax(m, scale_r):
    x = _series()
    r = 0.2 if scale_r else 0.3
    got = tc.sample_entropy(x, m, r, scale_r, device=CPU)
    ref = jc.sample_entropy(x, m, r, scale_r)
    rr = r * x.astype(np.float64).std(-1) if scale_r else r
    margin = _pair_margin(x, m, rr)
    got, ref = _np(got), np.asarray(ref)
    assert np.array_equal(np.isinf(got), np.isinf(ref))
    fin = np.isfinite(ref)
    bad = np.abs(got[fin] - ref[fin]) > GATE * np.abs(ref[fin]).max()
    assert np.all(margin[fin][bad] < 1e-6 * max(np.max(rr), 1.0))


def test_sample_entropy_of_a_constant_is_inf_and_validation():
    x = np.ones((2, 50), np.float32)
    assert torch.isinf(tc.sample_entropy(x, device=CPU)).all()
    with pytest.raises(ValueError):
        tc.sample_entropy(x[:, :3], m=2, device=CPU)
    with pytest.raises(ValueError):
        tc.sample_entropy(x, m=9, device=CPU)


@pytest.mark.parametrize("scales", [3, [1, 2, 4]])
def test_multiscale_entropy_matches_jax(scales):
    x = _series((2, 2, 200), seed=4)
    got = tc.multiscale_entropy(x, scales=scales, device=CPU)
    ref = jc.multiscale_entropy(x, scales=scales)
    assert got.shape == ref.shape
    _close(got, ref)
    with pytest.raises(ValueError):
        tc.multiscale_entropy(x, scales=[0, 1], device=CPU)


def test_ordinal_tie_rule_is_stable_by_index():
    """Ties rank by original position (Bandt-Pompe): the codes of integer
    data with many ties equal JAX's and a numpy stable double argsort."""
    x = np.random.default_rng(5).integers(0, 3, (2, 60)).astype(np.float32)
    for m, tau in ((3, 1), (4, 2), (5, 1)):
        got = tc._ordinal_codes(torch.from_numpy(x), m, tau).numpy()
        np.testing.assert_array_equal(got, np.asarray(jax.jit(
            jc._ordinal_codes, static_argnums=(1, 2))(x, m, tau)))
        el = x.shape[-1] - (m - 1) * tau
        win = np.stack([x[:, k * tau:k * tau + el] for k in range(m)], -1)
        ranks = np.argsort(np.argsort(win, -1, kind="stable"), -1,
                           kind="stable")
        np.testing.assert_array_equal(got, (ranks * m ** np.arange(m)).sum(-1))
    # a window [2, 1, 2]: ranks (1, 0, 2), code 1 + 2 * 9
    assert tc._ordinal_codes(torch.tensor([2.0, 1.0, 2.0]), 3, 1).item() == 19


@pytest.mark.parametrize("m,tau,normalized", [(2, 1, True), (3, 2, False),
                                              (4, 1, True), (6, 1, True)])
def test_permutation_entropy_matches_jax(m, tau, normalized):
    x = _series((2, 2, 400), seed=6)
    _close(tc.permutation_entropy(x, m, tau, normalized, device=CPU),
           jc.permutation_entropy(x, m, tau, normalized))


def test_permutation_entropy_known_answers_and_validation():
    ramp = np.arange(100, dtype=np.float32)
    assert float(tc.permutation_entropy(ramp, device=CPU)) == 0.0
    with pytest.raises(ValueError):
        tc.permutation_entropy(ramp, m=7, device=CPU)
    with pytest.raises(ValueError):
        tc.permutation_entropy(ramp[:3], m=3, tau=2, device=CPU)


def test_multiscale_permutation_entropy_matches_jax():
    x = _series((3, 300), seed=7)
    _close(tc.multiscale_permutation_entropy(x, scales=4, device=CPU),
           jc.multiscale_permutation_entropy(x, scales=4))


@pytest.mark.parametrize("scales", [None, (4, 8, 16, 32)])
def test_dfa_matches_jax(scales):
    x = _series((2, 2, 1024), seed=8)
    got = tc.dfa(x, scales=scales, device=CPU)
    ref = jc.dfa(x, scales=scales)
    _close(got[0], ref[0])
    _close(got[1], ref[1])


def test_dfa_known_answers_and_validation():
    x = np.random.default_rng(9).standard_normal((4, 8192)).astype(
        np.float32)
    white = tc.dfa(x, device=CPU)[0]
    brown = tc.dfa(np.cumsum(x, -1), device=CPU)[0]
    assert torch.all((white - 0.5).abs() < 0.1), white
    assert torch.all((brown - 1.5).abs() < 0.15), brown
    with pytest.raises(ValueError):
        tc.dfa(x[:, :16], device=CPU)
    with pytest.raises(ValueError):
        tc.dfa(x, scales=(2, 8), device=CPU)


@pytest.mark.parametrize("shape", [(7,), (1, 9), (3, 4, 5)])
def test_row_cumsum_is_cumsum(shape):
    """The single-row scan beside its copy is the plain cumsum."""
    x = torch.randn(shape, generator=torch.Generator().manual_seed(0))
    got = row_cumsum(x)
    assert got.shape == x.shape
    assert torch.equal(got, torch.cumsum(x, dim=-1))
