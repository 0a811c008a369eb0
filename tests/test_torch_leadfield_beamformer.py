"""The port's forward models, dipole fits and beamformers
(``ninwavelets_tpu_torch.ops.leadfield`` / ``ops.beamformer``) against the
JAX package, on the CPU, at small sizes (32 electrodes, 2 cm grids, 60
series terms and 40 Adam steps in the fits).

Gates, each with its reason:

* leadfields, scans' residuals, filters, powers, CSDs, kernels and
  projections: max|d| <= 1e-5 x max|ref| (float32 series and products on
  both sides; ``Precision.HIGHEST`` there, ``fp32_matmul("exact")``
  here);
* the electrode layouts and source grids: exact (the same host numpy);
* the dipole fits: the grid stage exactly (the same winning grid point),
  the refined position within 1 um (float32 positions in unit-sphere
  units: about 1e-7 of the radius a step, through 40 Adam steps), the
  moment 1e-5 of its max, the goodness of fit 1e-6;
* free-orientation LCMV: the port solves the orientation in float64 (in
  float32, as the JAX package does, ``G2 = L C^-2 L^T`` squares the
  covariance's conditioning: 0.07 of error at a condition of 1e9); each
  source's orientation is held against the JAX package's algorithm run
  in float64 at PR 15's eigenvector gate (1e-5 + 1e-6 x max|lam| / gap of
  its 3 x 3 problem), up to its sign; the filters, power and NAI against
  the JAX package's fixed-orientation fit of those orientations (1e-5;
  1e-4 at a covariance condition of 1e9 with 1% loading, where both
  float32 solves amplify the products' round-off).
"""
import numpy as np
import pytest
import torch

import ninwavelets_tpu as nw
from ninwavelets_tpu.ops import beamformer as jb
from ninwavelets_tpu.ops import leadfield as jl
from ninwavelets_tpu.ops.bank import make_fft_bank
from ninwavelets_tpu_torch import convert
from ninwavelets_tpu_torch.ops import beamformer as tb
from ninwavelets_tpu_torch.ops import leadfield as tl

from test_beamformer import _leadfield, _simulate

CPU = "cpu"
GATE = 1e-5
R = 0.09


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, gate=GATE):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got.astype(np.float64) - want).max() <= gate * max(
        np.abs(want).max(), 1e-30)


def test_layouts_and_grids_are_the_jax_host_math():
    for n, upper in ((64, True), (33, False)):
        np.testing.assert_array_equal(tl.fibonacci_electrodes(n, R, upper),
                                      jl.fibonacci_electrodes(n, R, upper))
    np.testing.assert_array_equal(tl.source_grid(R, 0.015, 0.8),
                                  jl.source_grid(R, 0.015, 0.8))


@pytest.mark.parametrize("n_terms,radius", [(200, None), (60, 0.095)])
def test_sphere_leadfield_matches_jax(n_terms, radius):
    elec = jl.fibonacci_electrodes(32, R, upper_only=False)
    grid = np.concatenate([np.zeros((1, 3)), jl.source_grid(R, 0.025, 0.85)])
    got = tl.sphere_leadfield(elec, grid, radius, n_terms=n_terms,
                              device=CPU)
    _close(got, jl.sphere_leadfield(elec, grid, radius, n_terms=n_terms))
    ori = np.random.default_rng(0).standard_normal(grid.shape)
    _close(tl.sphere_leadfield(elec, grid, radius, orientation=ori,
                               device=CPU),
           jl.sphere_leadfield(elec, grid, radius, orientation=ori))


def test_sphere_leadfield_known_answer_and_validation():
    elec = jl.fibonacci_electrodes(60, R, upper_only=False)
    q = np.array([0.2, -0.7, 0.4])
    got = tl.sphere_leadfield(elec, np.zeros((1, 3)), radius=R,
                              device=CPU).numpy()[:, 0, :] @ q
    want = 3.0 * (elec / R) @ q / (4 * np.pi * 0.33 * R * R)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    with pytest.raises(ValueError, match="0.95"):
        tl.sphere_leadfield(elec, np.array([[0.0, 0.0, 0.089]]), radius=R,
                            device=CPU)
    with pytest.raises(ValueError):
        tl.sphere_leadfield(elec, np.zeros((4, 2)), device=CPU)
    with pytest.raises(ValueError):
        tl.sphere_leadfield(elec, np.zeros((2, 3)),
                            orientation=np.ones((3, 3)), device=CPU)


def test_meg_leadfield_matches_jax_and_radial_dipoles_are_silent():
    sens = jl.fibonacci_electrodes(32, R) * 1.3
    sori = sens / np.linalg.norm(sens, axis=1, keepdims=True)
    grid = jl.source_grid(R, 0.025, 0.8)
    grid = grid[np.linalg.norm(grid, axis=1) > 0]
    _close(tl.sphere_leadfield_meg(sens, sori, grid, device=CPU),
           jl.sphere_leadfield_meg(sens, sori, grid))
    radial = tl.sphere_leadfield_meg(sens, sori, grid, orientation=grid,
                                     device=CPU)
    tang = tl.sphere_leadfield_meg(sens, sori, grid, device=CPU)
    assert radial.abs().max() <= 1e-5 * tang.abs().max()
    with pytest.raises(ValueError, match="outside"):
        tl.sphere_leadfield_meg(sens * 0.1, sori, grid, device=CPU)


def _planted_eeg(pos, n=32, noise=0.0):
    elec = jl.fibonacci_electrodes(n, R)
    q = np.array([2.0, -1.0, 3.0]) * 1e-9
    v = np.asarray(jl.sphere_leadfield(elec, pos[None], radius=R))[:, 0] @ q
    if noise:
        v = v + noise * v.std() * np.random.default_rng(0).standard_normal(n)
    return elec, v


def _same_fit(got, ref):
    np.testing.assert_array_equal(got["grid_pos"], ref["grid_pos"])
    assert np.abs(got["pos"] - ref["pos"]).max() <= 1e-6
    _close(got["moment"], ref["moment"])
    assert abs(got["gof"] - ref["gof"]) <= 1e-6


@pytest.mark.parametrize("pos,noise", [((0.021, -0.013, 0.047), 0.0),
                                       ((-0.04, 0.03, 0.03), 0.05)])
def test_fit_dipole_matches_jax(pos, noise):
    elec, v = _planted_eeg(np.array(pos), noise=noise)
    kw = dict(radius=R, spacing=0.02, n_terms=60, n_steps=40)
    got = tl.fit_dipole(v, elec, device=CPU, **kw)
    _same_fit(got, jl.fit_dipole(v, elec, **kw))
    assert np.linalg.norm(got["pos"] - np.array(pos)) < 3e-3


def test_fit_dipole_scan_is_the_jax_scan():
    """The grid stage alone: the same residual at every grid point."""
    import jax.numpy as jnp
    elec, v = _planted_eeg(np.array([0.01, 0.02, 0.05]))
    re_hat = elec / np.linalg.norm(elec, axis=1, keepdims=True)
    grid = jl.source_grid(R, 0.02, 0.9)
    b = np.linalg.norm(grid, axis=1)
    r0 = np.where(b[:, None] > 0, grid / np.maximum(b[:, None], 1e-30),
                  [0.0, 0.0, 1.0])
    scale = np.float32(1.0 / (4.0 * np.pi * 0.33 * R * R))
    vn = (v - v.mean()) / np.linalg.norm(v - v.mean())
    ref, _ = jl._scan_grid_jit(
        jnp.asarray(vn, jnp.float32), jnp.asarray(re_hat, jnp.float32),
        jnp.asarray(r0, jnp.float32), jnp.asarray(b / R, jnp.float32),
        scale, n_terms=60)
    t32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)  # noqa
    lf = tl._series(t32(re_hat), t32(r0), t32(b / R), 60) * float(scale)
    got, _ = tl._grid_rss(lf - lf.mean(0, keepdim=True), t32(vn))
    _close(got, ref)
    assert int(got.argmin()) == int(np.argmin(np.asarray(ref)))


def test_fit_dipole_evoked_matches_jax_and_validation():
    elec, v = _planted_eeg(np.array([0.02, 0.0, 0.05]))
    t = np.arange(40)
    v_ts = np.outer(v, np.sin(2 * np.pi * t / 40.0) + 0.1)
    kw = dict(radius=R, spacing=0.02, n_terms=60, n_steps=40)
    got = tl.fit_dipole_evoked(v_ts, elec, device=CPU, **kw)
    ref = jl.fit_dipole_evoked(v_ts, elec, **kw)
    _same_fit(got, ref)
    assert got["peak_sample"] == ref["peak_sample"]
    for k in ("moment_ts", "amplitude", "gof_ts"):
        _close(got[k], ref[k], 1e-4)
    with pytest.raises(ValueError):
        tl.fit_dipole(v[:5], elec, device=CPU)
    with pytest.raises(ValueError):
        tl.fit_dipole(np.zeros(32), elec, device=CPU)
    with pytest.raises(ValueError):
        tl.fit_dipole(v, elec, max_eccentricity=0.97, device=CPU)
    with pytest.raises(ValueError):
        tl.fit_dipole_evoked(v, elec, device=CPU)


@pytest.mark.parametrize("pos", [(0.021, -0.013, 0.047), (-0.04, 0.03, 0.03)])
def test_fit_dipole_meg_matches_jax(pos):
    sens = jl.fibonacci_electrodes(32, R) * 1.3
    sori = sens / np.linalg.norm(sens, axis=1, keepdims=True)
    v = np.asarray(jl.sphere_leadfield_meg(sens, sori, np.array([pos])))[
        :, 0] @ np.array([1.0, 0.5, 0.0])
    got = tl.fit_dipole_meg(v, sens, sori, spacing=0.02, n_steps=60,
                            device=CPU)
    _same_fit(got, jl.fit_dipole_meg(v, sens, sori, spacing=0.02,
                                     n_steps=60))
    assert np.linalg.norm(got["pos"] - np.array(pos)) < 1e-3
    with pytest.raises(ValueError):
        tl.fit_dipole_meg(v, sens * 0.5, sori, device=CPU)


# -- beamformers --------------------------------------------------------------

def _cov(x):
    return (x @ x.T / x.shape[1]).astype(np.float32)


@pytest.mark.parametrize("reg,noise", [(0.05, False), (0.01, True)])
def test_lcmv_fixed_matches_jax(reg, noise):
    lf = _leadfield()
    x, _ = _simulate(lf, [7, 31], n=4000)
    ncov = (np.eye(32) * 2.0 + 0.1).astype(np.float32) if noise else None
    got = tb.lcmv(_cov(x), lf, reg, ncov, device=CPU)
    ref = jb.lcmv(_cov(x), lf, reg, ncov)
    assert isinstance(got, tb.LCMVResult)
    for f in ("filters", "power", "nai"):
        _close(getattr(got, f), getattr(ref, f))
    assert torch.isnan(got.orientations).all()
    _close(tb.lcmv_apply(got, x[:, :300]), jb.lcmv_apply(ref, x[:, :300]))
    assert {7, 31} == set(np.argsort(-got.nai.numpy())[:2])
    conv = convert.lcmv_result_from_jax(ref, device=CPU)
    _close(tb.lcmv_apply(conv, x[:, :300]), jb.lcmv_apply(ref, x[:, :300]))


def _orient_gaps(cov, lead3, reg):
    """Each source's top eigengap and largest |eigenvalue| of the 3 x 3
    problem ``G2^-1/2 G G2^-1/2``, in float64."""
    c = cov.shape[0]
    covr = cov + reg * np.trace(cov) / c * np.eye(c)
    ci = np.linalg.solve(covr, lead3.transpose(2, 0, 1).reshape(c, -1))
    ci = ci.reshape(c, -1, 3).transpose(1, 0, 2)
    g = np.einsum("sic,sco->sio", lead3, ci)
    g2 = np.einsum("sci,sco->sio", ci, ci)
    d2, v2 = np.linalg.eigh(0.5 * (g2 + g2.transpose(0, 2, 1)))
    isq = np.einsum("sij,sj,skj->sik", v2, 1 / np.sqrt(d2), v2)
    lam = np.linalg.eigvalsh(isq @ (0.5 * (g + g.transpose(0, 2, 1))) @ isq)
    return lam[:, -1] - lam[:, -2], np.abs(lam).max(-1)


def _free_problem(amp, reg):
    elec = jl.fibonacci_electrodes(32, R)
    grid = jl.source_grid(R, 0.02, 0.8)
    lead3 = np.asarray(jl.sphere_leadfield(elec, grid)).transpose(1, 2, 0)
    rng = np.random.default_rng(1)
    src = np.sin(np.arange(3000) * 0.1)
    x = (rng.standard_normal((32, 3000)) + amp * np.outer(
        lead3[40].T @ np.array([0.3, 0.9, 0.3]), src)).astype(np.float32)
    return _cov(x), lead3


def _jax_orient64(cov, lead3, reg):
    import jax
    import jax.numpy as jnp
    with jax.enable_x64(True):
        return np.asarray(jb._orient_jit(jnp.asarray(cov, jnp.float64),
                                         jnp.asarray(lead3, jnp.float64),
                                         reg=reg))


@pytest.mark.parametrize("amp,reg,gate", [(50.0, 0.01, 1e-4),
                                          (5.0, 0.05, GATE)])
def test_lcmv_free_orientation_is_the_jax_algorithm_in_float64(amp, reg,
                                                              gate):
    """The port solves the orientation in float64: held against the JAX
    package's ``_orient_jit`` run in float64 on the same float32 inputs,
    per source up to sign; the rest of the fit against the JAX package's
    fixed-orientation fit of the port's orientations."""
    cov, lead3 = _free_problem(amp, reg)
    got = tb.lcmv(cov, lead3, reg=reg, device=CPU)
    ori = got.orientations.numpy()
    ref = _jax_orient64(cov, lead3, reg)
    gap, big = _orient_gaps(cov.astype(np.float64),
                            lead3.astype(np.float64), reg)
    sign = np.sign(np.sum(ori * ref, -1))
    assert np.all(np.abs(sign[:, None] * ori - ref).max(-1)
                  <= 1e-5 + 1e-6 * big / gap)
    lead_fixed = np.einsum("so,soc->sc", ori, lead3.astype(np.float32))
    w, power, nai = jb._lcmv_fixed_jit(cov, lead_fixed, reg=reg)
    _close(got.filters, w, gate)
    _close(got.power, power, gate)
    _close(got.nai, nai, gate)
    assert int(got.nai.argmax()) == 40


def test_free_orientation_float32_fault_in_jax_package():
    """The JAX package's float32 orientations err by more than 1e-2 (0.07
    at a covariance condition of 1e9) against its own algorithm in float64;
    the port's, solved in float64, within 1e-6."""
    cov, lead3 = _free_problem(50.0, 0.01)
    ref = _jax_orient64(cov, lead3, 0.01)

    def err(u):
        u = np.asarray(u)
        return np.abs(np.sign(np.sum(u * ref, -1))[:, None] * u - ref).max()

    assert err(jb.lcmv(cov, lead3, reg=0.01).orientations) > 1e-2
    assert err(tb.lcmv(cov, lead3, reg=0.01, device=CPU).orientations) < 1e-6


def test_lcmv_validation():
    lf = _leadfield()
    cov = np.eye(32, dtype=np.float32)
    with pytest.raises(ValueError):
        tb.lcmv(cov[:4], lf, device=CPU)
    with pytest.raises(ValueError):
        tb.lcmv(cov, lf[:, :10], device=CPU)
    with pytest.raises(ValueError):
        tb.lcmv(cov, lf[:, None, :].repeat(2, 1), device=CPU)
    res = tb.lcmv(cov, lf, device=CPU)
    with pytest.raises(ValueError):
        tb.lcmv_apply(res, np.zeros((5, 10), np.float32))


def _csd_data():
    rng = np.random.default_rng(2)
    sigs = rng.standard_normal((4, 6, 256)).astype(np.float32)
    bank = np.asarray(make_fft_bank(
        nw.Morse(256.0)._wdef(), np.asarray([8.0, 12.0], np.float32), 256,
        256.0, True), np.float32)
    return sigs, bank


@pytest.mark.parametrize("interpolate,time_range", [(True, None),
                                                    (False, (20, 200))])
def test_wavelet_csd_dics_and_coherence_match_jax(interpolate, time_range):
    sigs, bank = _csd_data()
    csd = tb.wavelet_csd(sigs, torch.from_numpy(bank), interpolate,
                         time_range, device=CPU)
    cr, ci = jb.wavelet_csd(sigs, bank, interpolate, time_range)
    assert csd.dtype == torch.complex64 and csd.shape == (2, 6, 6)
    _close(csd.real, cr)
    _close(csd.imag, ci)
    lf = _leadfield(c=6, s=10)
    got = tb.dics(csd[0], lf, device=CPU)
    ref = jb.dics(cr[0], ci[0], lf)
    for f in got._fields:
        _close(getattr(got, f), getattr(ref, f))
    _close(tb.source_coherence(got, csd[0]),
           jb.source_coherence(ref, cr[0], ci[0]))
    conv = convert.dics_result_from_jax(ref, device=CPU)
    _close(tb.source_coherence(conv, np.asarray(csd[0])),
           jb.source_coherence(ref, cr[0], ci[0]))
    # a real CSD is its own real part
    _close(tb.dics(csd[0].real, lf, device=CPU).nai, ref.nai)
    with pytest.raises(ValueError):
        tb.dics(csd[0, :3], lf, device=CPU)


@pytest.mark.parametrize("method", ["mne", "dspm", "sloreta"])
@pytest.mark.parametrize("depth,noise", [(0.0, False), (0.8, True)])
def test_minimum_norm_matches_jax(method, depth, noise):
    lf = _leadfield()
    x, _ = _simulate(lf, [3], n=500)
    ncov = (np.eye(32) * 1.5).astype(np.float32) if noise else None
    got = tb.minimum_norm(lf, noise_cov=ncov, method=method, depth=depth,
                          device=CPU)
    ref = jb.minimum_norm(lf, noise_cov=ncov, method=method, depth=depth)
    assert got.method == ref.method
    _close(got.kernel, ref.kernel)
    _close(tb.minimum_norm_apply(got, x), jb.minimum_norm_apply(ref, x))
    conv = convert.minimum_norm_result_from_jax(ref, device=CPU)
    assert conv.method == method
    _close(conv.kernel, ref.kernel)


def test_minimum_norm_validation_and_sloreta_zero_bias():
    lf = _leadfield(s=40)
    with pytest.raises(ValueError):
        tb.minimum_norm(lf, method="eloreta", device=CPU)
    with pytest.raises(ValueError):
        tb.minimum_norm(lf[None], device=CPU)
    res = tb.minimum_norm(lf, lam=1e-6, method="sloreta", device=CPU)
    with pytest.raises(ValueError):
        tb.minimum_norm_apply(res, np.zeros((5, 3), np.float32))
    est = tb.minimum_norm_apply(res, lf.T.copy()).abs()   # (S, S)
    assert torch.equal(est.argmax(0), torch.arange(40))
