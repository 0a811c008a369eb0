"""The port's configs and one-call pipeline (``ninwavelets_tpu_torch.config``:
``MorseConfig``, ``MorletConfig``, ``EngineConfig``, ``PipelineConfig``,
``run_pipeline``) and ``convert.pipeline_config_from_jax`` against the JAX
package on the same seeded epochs, on the CPU.  Both packages get the same
configuration: the JAX one, carried across field by field.

On the CPU every stage takes the plain path; on the card the epoch
reductions reach K2 "power_itc", synchrosqueezing K5a / K5b and the superlet
and cluster planes K4, which ``chip_smoke.py`` holds against the plain
path at the serving width.

Gates, each key under its family's gate:

* ``power`` (z-scored), ``global_spectrum``: max|d| / max|ref| <= 1e-4, as
  ``tests/test_torch_epoching.py`` holds the event-locked and baselined
  power; ``superlet_power`` 1e-4 of the max (slice 6's power gate);
* ``itc``: within 2e-3 everywhere and, cell by cell, within the
  coefficient tolerance (1e-5 of the row's max |c|) carried through each
  epoch's unit phase, ``mean_e 2e-5 max|c| / |c_e|`` (slice 1's conditioned
  ITC gate, as ``chip_smoke.py`` holds the complex-bank ITC): at 4 epochs
  of 1000 samples a cell whose weakest coefficient is 1e-2 of the row max
  still moves by 3e-5 between two float32 FFTs, so the fixed sound-cell
  rule of ``tests/test_torch_cwt.py`` does not apply; both packages sit
  within 3e-4 of the float64 ITC;
* ``ssq_power``: each time column's energy within rtol 1e-5, SNR >= 60 dB
  and every cell within 1e-5 of the max (``tests/test_torch_sst.py``'s
  gates, which these inputs pass without a cell on a row edge);
* the connectivity matrices: max|d| / max|ref| <= 1e-4
  (``tests/test_torch_conn_matrices.py``);
* ``freqs``, ``coi``: exactly equal; ``significant``: equal except at
  cells whose uncorrected power lies within the power gate (1e-4 of the
  plane's max) of the threshold; ``ridge_hz``: the ridge rows equal except
  where two rows' path scores tie within float32 round-off, the Hz track
  within 1e-5 of the top frequency (the sub-row refinement is a float32
  parabola through rounded logs in both packages);
* ``specparam`` (2000 Adam steps): the model within 5e-3 of its max,
  ``r_squared`` within 1e-4, exponent and offset within 2e-3 of their max
  (``tests/test_torch_specparam.py``);
* ``cluster``: the port's ``t_one_sample`` of JAX's baselined planes
  within 1e-5 of the max of JAX's ``t_obs``; the pipeline's ``t_obs``
  (from its own planes) within the planes' tolerance carried through the
  z-score and the t statistic, cell by cell (``_t_gate``: at 4 nearly
  equal epochs t reaches 380 and its float32 variance, ``s2 - E m^2``,
  cancels, in both packages alike); and the whole result equal to the
  port's own ``cluster_test_one_sample`` on the same planes (the sign
  flips come from a ``torch.Generator``: other draws than JAX's, by
  design);
* errors: JAX's types and messages.
"""
import dataclasses
import logging

import numpy as np
import pytest
import torch

import ninwavelets_tpu as nw
import ninwavelets_tpu_torch as nt
from ninwavelets_tpu import config as jcfg
from ninwavelets_tpu_torch import config as tcfg
from ninwavelets_tpu_torch import convert
from ninwavelets_tpu_torch.ops import cluster as tcl
from ninwavelets_tpu_torch.ops import cwt as tcwt
from ninwavelets_tpu_torch.ops import ridge as tridge
from ninwavelets_tpu_torch.ops import tc_stats as ttc
from ninwavelets_tpu_torch.ops.baseline import baseline_tf
from ninwavelets_tpu_torch.ops.fused import power_auto

from conftest import make_example
from torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-4


class _Epochs:
    """The duck-typed ``mne.Epochs`` surface."""

    def __init__(self, data, ch_names, sfreq=1000.0):
        self._d = data
        self.info = {"sfreq": sfreq}
        self.ch_names = list(ch_names)

    def get_data(self):
        return self._d


def _all_stages_epochs():
    """``tests/test_utils.py::test_pipeline_all_stages_integration``'s
    epochs: the reference's golden signal plus noise, 4 x 2 x 1000."""
    base = make_example(1.0)
    rng = np.random.default_rng(5)
    data = np.stack([np.stack([base + 0.05 * rng.standard_normal(base.shape),
                               base + 0.05 * rng.standard_normal(base.shape)])
                     for _ in range(4)])
    return _Epochs(data, ["a", "b"])


def _conn_epochs():
    """``tests/test_utils.py::test_connectivity_stages``'s epochs: channels
    0 and 1 share a 40 Hz source, channel 2 carries 25 Hz; 6 x 3 x 512."""
    rng = np.random.default_rng(1)
    t = np.arange(512) / 1000.0
    base = np.sin(2 * np.pi * 40 * t)
    data = np.stack([base, base, np.cos(2 * np.pi * 25 * t)])
    return _Epochs(data[None] + 0.2 * rng.standard_normal((6, 3, 512)),
                   ["a", "b", "c"])


ALL_STAGES = jcfg.PipelineConfig(
    freqs=(20.0, 340.0, 20.0), baseline=(0.0, 0.1), significance=0.95,
    global_spectrum=True, ridge=True, ssq=True, superlet=(1, 4),
    connectivity="both", connectivity_window=(0.1, 0.9), specparam=True,
    cluster_test=True, cluster_adjacency=((0, 1),), cluster_n_perm=29)


def _run(cfg, epochs):
    """(JAX's output, the port's output) of one JAX config."""
    want = jcfg.run_pipeline(cfg, epochs)
    got = tcfg.run_pipeline(convert.pipeline_config_from_jax(cfg), epochs,
                            device="cpu")
    return got, want


@pytest.fixture(scope="module")
def all_stages():
    epochs = _all_stages_epochs()
    got, want = _run(ALL_STAGES, epochs)
    return got, want, epochs


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(got, want):
    """max|d| / max|ref| over the cells that are not NaN, whose masks must
    be equal (the phase-lag matrices' diagonals are NaN in both)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    return np.nanmax(np.abs(got - want)) / np.nanmax(np.abs(want))


def assert_itc_conditioned(got, want, coeffs):
    """The module docstring's ITC gate; ``coeffs`` (E, C, F, N)."""
    got, want = _np(got), _np(want)
    mag = np.abs(coeffs)
    bound = 2e-5 * (mag.max(axis=(0, 3))[..., None] / mag).mean(0)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    d = np.nan_to_num(np.abs(got - want))
    assert d.max() <= 2e-3, d.max()
    assert (d <= bound).all(), (d / bound).max()


def _pieces(epochs, interpolate=False):
    """The port's wavelet, (E, C, N) data and bank for ``ALL_STAGES``."""
    w = nt.Morse(1000.0, interpolate=interpolate, device="cpu")
    ew = nt.EpochsWavelet(epochs, w)
    x = ew._all_data()
    freqs = np.arange(*ALL_STAGES.freqs)
    return w, x, ew._bank_for(x, freqs), freqs


def test_output_keys_and_types(all_stages):
    got, want, _ = all_stages
    assert set(got) == set(want)
    for key in ("power", "itc", "significant", "ssq_power", "superlet_power",
                "plv_matrix", "coherence_matrix", "global_spectrum"):
        assert isinstance(got[key], torch.Tensor), key
        assert got[key].device.type == "cpu"
    for key in ("freqs", "coi", "ridge_hz"):
        assert isinstance(got[key], np.ndarray), key
        assert got[key].dtype == np.asarray(want[key]).dtype, key
    assert got["significant"].dtype == torch.bool
    assert type(got["wavelet"]).__name__ == type(want["wavelet"]).__name__
    assert np.array_equal(got["freqs"], want["freqs"])
    assert np.array_equal(got["coi"], want["coi"])


@pytest.mark.parametrize("key", ["power", "global_spectrum",
                                 "superlet_power", "plv_matrix",
                                 "coherence_matrix"])
def test_planes_match_jax(all_stages, key):
    got, want, _ = all_stages
    assert _rel(got[key], want[key]) <= RTOL


def test_itc_matches_jax(all_stages):
    got, want, epochs = all_stages
    _, x, bank, _ = _pieces(epochs)
    coeffs = tcwt.cwt_from_bank(x, bank, False).numpy()
    assert_itc_conditioned(got["itc"], want["itc"], coeffs)


def test_ssq_matches_jax(all_stages):
    got, want = (np.asarray(_np(p[ "ssq_power"]), np.float64)
                 for p in all_stages[:2])
    colsum = np.abs(got.sum(-2) - want.sum(-2)).max() / np.abs(
        want.sum(-2)).max()
    snr = 10 * np.log10((want ** 2).sum() / max(((got - want) ** 2).sum(),
                                                 1e-300))
    assert colsum <= 1e-5 and snr >= 60.0, (colsum, snr)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_significance_matches_jax_but_at_the_threshold(all_stages):
    got, want, epochs = all_stages
    _, x, bank, _ = _pieces(epochs)
    power = tcwt.mean_power_from_bank(x, bank, False)
    host = np.asarray(epochs.get_data(), np.float32)
    margin = []
    for ch in range(host.shape[1]):
        alpha = float(np.mean([ttc.ar1_coefficient(r) for r in host[:, ch]]))
        var = float(np.mean(np.var(host[:, ch], axis=-1)))
        thr = ttc.significance_level(bank, 1000.0, alpha, var, 0.95,
                                     host.shape[0])
        margin.append((power[ch] - thr[:, None]).abs())
    near = (torch.stack(margin) <= RTOL * power.max()).numpy()
    differ = got["significant"].numpy() != np.asarray(want["significant"])
    assert not (differ & ~near).any()
    assert got["significant"].any() and not got["significant"].all()


def test_ridge_matches_jax_but_at_ties(all_stages):
    got, want, epochs = all_stages
    freqs = got["freqs"]
    d = np.abs(got["ridge_hz"] - np.asarray(want["ridge_hz"]))
    assert d.max() <= 1e-5 * freqs.max(), d.max()
    # the rows themselves: the port's row path, read off the Hz track,
    # against JAX's
    step = freqs[1] - freqs[0]
    rows_got = np.rint((got["ridge_hz"] - freqs[0]) / step)
    rows_want = np.rint((np.asarray(want["ridge_hz"]) - freqs[0]) / step)
    assert np.array_equal(rows_got, rows_want)
    # and the pipeline's track is ``ridge_frequencies`` of the power
    w, x, bank, _ = _pieces(epochs)
    power = tcwt.mean_power_from_bank(x, bank, False)
    direct = np.stack([tridge.ridge_frequencies(power[ch], freqs)
                       for ch in range(power.shape[0])])
    assert np.array_equal(direct, got["ridge_hz"])


def test_specparam_matches_jax(all_stages):
    got, want, _ = all_stages
    g, w = got["specparam"], want["specparam"]
    model_g, model_w = _np(g.model), np.asarray(w.model)
    assert np.abs(model_g - model_w).max() <= 5e-3 * np.abs(model_w).max()
    assert np.abs(_np(g.r_squared) - np.asarray(w.r_squared)).max() <= 1e-4
    for f in ("exponent", "offset"):
        a, b = _np(getattr(g, f)), np.asarray(getattr(w, f))
        assert np.abs(a - b).max() <= 2e-3 * np.abs(b).max(), f


def _t_gate(power, z, tol=1e-5):
    """Cell bound on the t map of z-scored planes whose power is within
    ``tol`` of each row's max: the z-score's bound (``chip_smoke.py``'s
    baselined gate, ``2 tol P (1 + |z|) / std``) carried through the mean,
    the float32 raw-moment variance (its rounding, 4 ulp of ``sum z^2``,
    included) and t = m sqrt(E) / s."""
    power, z = (np.asarray(_np(a), np.float64) for a in (power, z))
    n_base = int(round(ALL_STAGES.baseline[1] * 1000.0))
    std = power[..., :n_base].std(-1, keepdims=True)
    std[std == 0] = 1.0
    delta = 2 * tol * power.max(-1, keepdims=True) * (1 + np.abs(z)) / std
    e = z.shape[0]
    m = z.mean(0)
    s2 = ((z - m) ** 2).sum(0) / (e - 1)
    dm = delta.mean(0)
    ds2 = (2 * (np.abs(z) * delta).sum(0) + 2 * np.abs(m) * delta.sum(0)
           + 4 * 2.0 ** -24 * (z * z).sum(0)) / (e - 1)
    t = m * np.sqrt(e / s2)
    return np.sqrt(e) * dm / np.sqrt(s2) + np.abs(t) * ds2 / (2 * s2)


def test_cluster_stage(all_stages):
    from ninwavelets_tpu.ops import baseline as jbl
    from ninwavelets_tpu.ops import cwt as jcwt
    got, want, epochs = all_stages
    res = got["cluster"]
    assert res.null_max.shape == (29,)
    _, x, bank, _ = _pieces(epochs)
    power = power_auto(x, bank, interpolate=False)
    planes = baseline_tf(power, 1000.0, *ALL_STAGES.baseline,
                         ALL_STAGES.baseline_method)
    # the statistic: the port's t of JAX's planes
    jew = nw.EpochsWavelet(epochs, nw.Morse(1000.0))
    waves = jew._all_data()
    jplanes = jbl.baseline_tf(jcwt.power(
        waves, *jew._bank_for(waves, np.arange(*ALL_STAGES.freqs))),
        1000.0, *ALL_STAGES.baseline)
    t_jax = np.asarray(want["cluster"].t_obs)
    assert _rel(tcl.t_one_sample(torch.from_numpy(np.array(jplanes))),
                t_jax) <= 1e-5
    # the pipeline's t from its own planes, conditioned
    d = np.abs(_np(res.t_obs) - t_jax)
    assert (d <= _t_gate(power, planes)).all()
    # the stage is the port's own test on the same planes
    ref = tcl.cluster_test_one_sample(
        planes, n_perm=29, adjacency=np.array([[0, 1]], np.int32))
    for f in ("t_obs", "p_map", "mass_map", "null_max"):
        assert np.array_equal(_np(getattr(res, f)), _np(getattr(ref, f))), f
    assert res.threshold == ref.threshold
    assert res.clusters == ref.clusters


CONNECTIVITY = ["both", "wpli,ppc,pli", "pcoh,psi", "dwpli, coherence"]


@pytest.mark.parametrize("subset", CONNECTIVITY)
def test_connectivity_subsets_match_jax(subset):
    window = (0.1, 0.4) if subset == "both" else None
    cfg = jcfg.PipelineConfig(freqs=(20.0, 60.0, 5.0), connectivity=subset,
                              connectivity_window=window)
    got, want = _run(cfg, _conn_epochs())
    keys = [k for k in want if k.endswith("matrix") or k == "partial_coherence"]
    assert keys and set(got) == set(want)
    for key in keys:
        assert _rel(got[key], want[key]) <= RTOL, key
    if subset == "both":                   # test_utils' known answer
        assert got["plv_matrix"][4, 0, 1] > 0.9


def test_plain_engine_matches_fused_and_jax():
    """``use_fused=False`` takes ``mean_power_from_bank`` / ``itc_from_bank``:
    on the CPU the same numbers as the fused route's plain path, and
    JAX's plain route within the gates; ``mesh_shape`` is unused."""
    epochs = _conn_epochs()
    cfg = jcfg.PipelineConfig(freqs=(20.0, 60.0, 5.0), baseline=(0.0, 0.1),
                              engine=jcfg.EngineConfig(use_fused=False,
                                                       mesh_shape=(2, 1, 1)))
    got, want = _run(cfg, epochs)
    fused = tcfg.run_pipeline(tcfg.PipelineConfig(
        freqs=(20.0, 60.0, 5.0), baseline=(0.0, 0.1)), epochs, device="cpu")
    assert torch.equal(got["power"], fused["power"])
    assert torch.equal(got["itc"], fused["itc"])
    assert _rel(got["power"], want["power"]) <= RTOL
    w = nt.Morse(1000.0, device="cpu")
    ew = nt.EpochsWavelet(epochs, w)
    x = ew._all_data()
    coeffs = tcwt.cwt_from_bank(
        x, ew._bank_for(x, np.arange(20.0, 60.0, 5.0)), False).numpy()
    assert_itc_conditioned(got["itc"], want["itc"], coeffs)


def test_morlet_pipeline_matches_jax():
    cfg = jcfg.PipelineConfig(wavelet=jcfg.MorletConfig(sigma=5.0,
                                                        gabor=True),
                              freqs=(20.0, 60.0, 5.0), global_spectrum=True)
    got, want = _run(cfg, _conn_epochs())
    assert type(got["wavelet"]).__name__ == "Morlet"
    assert got["wavelet"].gabor and got["wavelet"].sigma == 5.0
    for key in ("power", "global_spectrum"):
        assert _rel(got[key], want[key]) <= RTOL, key
    assert np.array_equal(got["coi"], want["coi"])


class _ComplexConfig:
    """A wavelet config whose ``build`` gives a MexicanHat (a complex
    bank) in either package: the pipeline's complex-bank refusals."""

    def __init__(self, module):
        self.module = module

    def build(self, device=None):
        if self.module is nw:
            return nw.MexicanHat(1000.0)
        return nt.MexicanHat(1000.0, device=device)


def _tiny():
    x = np.random.default_rng(2).standard_normal((3, 2, 256))
    return _Epochs(x, ["a", "b"])


@pytest.mark.parametrize("fields,match", [
    (dict(connectivity="plv,nope"), "connectivity must be"),
    (dict(connectivity="psi", freqs=(60.0, 20.0, -5.0)), "ascending"),
    (dict(connectivity="psi", freqs=(20.0, 25.0, 5.0)), "ascending"),
    (dict(cluster_test=True), "cluster_test needs baseline"),
    (dict(specparam=True), "specparam needs global_spectrum"),
    (dict(ssq=True, complex_bank=True), "ssq needs an analytic"),
    (dict(connectivity="plv", complex_bank=True), "phase connectivity"),
    (dict(connectivity="coherence,ppc", complex_bank=True),
     "phase connectivity"),
])
def test_errors_match_jax(fields, match):
    fields = dict(fields)
    complex_bank = fields.pop("complex_bank", False)
    fields.setdefault("freqs", (20.0, 60.0, 5.0))
    cfg = jcfg.PipelineConfig(**fields)
    tc = convert.pipeline_config_from_jax(cfg)
    if complex_bank:
        cfg = dataclasses.replace(cfg, wavelet=_ComplexConfig(nw))
        tc = dataclasses.replace(tc, wavelet=_ComplexConfig(nt))
    with pytest.raises(ValueError) as want:
        jcfg.run_pipeline(cfg, _tiny())
    with pytest.raises(ValueError) as got:
        tcfg.run_pipeline(tc, _tiny(), device="cpu")
    assert str(got.value) == str(want.value)
    assert match in str(got.value)


def test_complex_bank_coherence_runs():
    """Coherence alone is allowed on a complex bank, in both packages."""
    cfg = jcfg.PipelineConfig(freqs=(20.0, 60.0, 5.0),
                              connectivity="coherence")
    want = jcfg.run_pipeline(dataclasses.replace(
        cfg, wavelet=_ComplexConfig(nw)), _tiny())
    got = tcfg.run_pipeline(dataclasses.replace(
        convert.pipeline_config_from_jax(cfg), wavelet=_ComplexConfig(nt)),
        _tiny(), device="cpu")
    assert _rel(got["coherence_matrix"], want["coherence_matrix"]) <= RTOL
    assert _rel(got["power"], want["power"]) <= RTOL


def test_config_fields_and_defaults_match_jax():
    for name in ("MorseConfig", "MorletConfig", "EngineConfig",
                 "PipelineConfig"):
        jf = [(f.name, f.default if f.default is not dataclasses.MISSING
               else f.default_factory()) for f in
              dataclasses.fields(getattr(jcfg, name))]
        tf = [(f.name, f.default if f.default is not dataclasses.MISSING
               else f.default_factory()) for f in
              dataclasses.fields(getattr(tcfg, name))]
        assert [n for n, _ in tf] == [n for n, _ in jf], name
        for (n, a), (_, b) in zip(tf, jf):
            if dataclasses.is_dataclass(a):
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, (name, n)
        assert getattr(tcfg, name).__dataclass_params__.frozen
    m = tcfg.MorseConfig().build("cpu")
    assert isinstance(m, nt.Morse) and (m.sfreq, m.b, m.r) == (1000.0, 17.5,
                                                                3.0)
    g = tcfg.MorletConfig().build("cpu")
    assert isinstance(g, nt.Morlet) and g.sigma == 7.0 and not g.gabor
    p = tcfg.PipelineConfig(baseline=(0.0, 0.2))
    assert p.engine.precision == "fast3" and p.baseline_method == "zscore"
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.ssq = True


def test_pipeline_config_from_jax_carries_every_field():
    cfg = jcfg.PipelineConfig(
        wavelet=jcfg.MorseConfig(sfreq=512.0, b=9.0, r=2.5, interpolate=True),
        engine=jcfg.EngineConfig(precision="exact", use_fused=False,
                                 mesh_shape=(1, 2, 1), streaming_window=4096,
                                 halo_tol=1e-5),
        freqs=(2.0, 40.0, 2.0), baseline=(0.0, 0.3), baseline_method="ratio",
        significance=0.99, ridge=True, superlet=(2, 5), superlet_sigma=2.0,
        connectivity="wpli", connectivity_window=(0.1, 0.2),
        cluster_test=True, cluster_adjacency=((0, 1), (1, 2)),
        cluster_n_perm=99)
    got = convert.pipeline_config_from_jax(cfg)
    assert type(got) is tcfg.PipelineConfig
    assert type(got.wavelet) is tcfg.MorseConfig
    assert type(got.engine) is tcfg.EngineConfig
    assert dataclasses.asdict(got) == dataclasses.asdict(cfg)
    morlet = convert.pipeline_config_from_jax(jcfg.PipelineConfig(
        wavelet=jcfg.MorletConfig(gabor=True)))
    assert type(morlet.wavelet) is tcfg.MorletConfig and morlet.wavelet.gabor
    with pytest.raises(TypeError, match="wavelet config"):
        convert.pipeline_config_from_jax(dataclasses.replace(
            cfg, wavelet=_ComplexConfig(nw)))


def test_stage_timers_log_only_at_debug(caplog):
    cfg = tcfg.PipelineConfig(freqs=(20.0, 60.0, 5.0), baseline=(0.0, 0.1),
                              global_spectrum=True, ridge=True)
    with caplog.at_level(logging.DEBUG, logger="ninwavelets_tpu_torch"):
        tcfg.run_pipeline(cfg, _tiny(), device="cpu")
    names = [r.args[0] for r in caplog.records
             if r.name == "ninwavelets_tpu_torch"]
    assert names == ["run_pipeline power_itc",
                     "run_pipeline global_spectrum", "run_pipeline ridge",
                     "run_pipeline baseline"]
    assert all(r.args[1] >= 0 for r in caplog.records)
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="ninwavelets_tpu_torch"):
        tcfg.run_pipeline(cfg, _tiny(), device="cpu")
    assert not caplog.records
