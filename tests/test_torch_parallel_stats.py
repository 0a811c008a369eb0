"""The port's multi-device layer, world 2: the cluster permutation nulls and
tests (and ``EpochsWavelet.cluster_test`` / ``cluster_test_all`` /
``cluster_f`` with ``mesh=``), MODWT, the S-transform, TF decoding, the HMM,
FastICA, covariance and CSP, on the (2,1,1) and (1,2,1) meshes.

One ``run_on_mesh`` group of two gloo CPU ranks runs every case
(``torch_parallel_cases.stats_cases``).  Given the same draws the mesh null
equals the single-device null bit for bit (padded chunk count included);
every result is also held against the JAX package's sharded function on the
conftest's virtual CPU mesh of the same shape, fed the JAX package's draws
where there are draws, at the gates of the port's single-device tests
(``test_torch_cluster``, ``test_torch_hmm``, ``test_torch_ica_asr``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ninwavelets_tpu import parallel as jpar
from ninwavelets_tpu.ops import cluster as jc
from ninwavelets_tpu_torch import convert
from ninwavelets_tpu_torch.ops import cluster as tc
from ninwavelets_tpu_torch.ops import dwt as tdwt
from ninwavelets_tpu_torch.ops import ica as tica

import torch_parallel_cases as cases
from torch_threads import one_torch_thread  # noqa: F401

SF = 1000.0
N_PERM, CHUNK = 40, 16         # 3 chunks, padded to 4 over the data axis
NA, SIZES = 3, (4, 4)
RTOL = 1e-5


def _key(seed):
    return jax.random.PRNGKey(seed)


@pytest.fixture(scope="module")
def inp():
    rng = np.random.default_rng(31)
    x = rng.standard_normal((8, 4, 32)).astype(np.float32)
    x[:, 1:3, 10:20] += 1.2
    y = rng.standard_normal((6, 4, 32)).astype(np.float32)
    sig = rng.standard_normal((4, 2, 256)).astype(np.float32)
    t = np.arange(256) / SF
    sig += np.sin(2 * np.pi * 40 * t).astype(np.float32)
    epochs = rng.standard_normal((10, 2, 128)).astype(np.float32)
    tt = np.arange(128) / 250.0
    epochs[:, :, 64:] += (3 * np.sin(2 * np.pi * 30 * tt[64:])).astype(
        np.float32)
    ta = rng.standard_normal((6, 2, 4, 16)).astype(np.float32)
    ta[:, :, 1] += 1.0
    tb = rng.standard_normal((5, 2, 4, 16)).astype(np.float32)
    states = np.repeat(rng.integers(0, 3, (4, 8)), 5, axis=1)    # (4, 40)
    hmm_x = (np.array([[-2.0, 0.0], [0.0, 2.0], [2.0, -1.0]])[states]
             + 0.4 * rng.standard_normal((4, 40, 2))).astype(np.float32)
    n = 512
    src = np.stack([np.sign(np.sin(2 * np.pi * 7 * np.arange(n) / n * 3)),
                    rng.uniform(-1.7, 1.7, n), rng.laplace(0, 1, n)])
    mix = np.array([[1.0, 0.5, 0.2], [0.3, 1.0, -0.4], [-0.2, 0.6, 1.0]])
    cov_x = rng.standard_normal((4, 3, 64)).astype(np.float32)
    cov_x[:, 0] *= 3.0
    cov_y = rng.standard_normal((4, 3, 64)).astype(np.float32)
    cov_y[:, 2] *= 2.0
    thr = float(jc.t_threshold(0.05, 7))
    return dict(
        cl_x=x, cl_y=y, cl_thr=thr, n_perm=N_PERM, na=NA, sizes=SIZES,
        signs=np.array(jc.sign_draws(_key(1), N_PERM, 8, CHUNK)),
        relabel=np.array(jc.relabel_draws(_key(2), N_PERM, 8, NA, CHUNK)),
        anova=np.array(jc.anova_draws(_key(3), N_PERM, SIZES, CHUNK)),
        epochs=epochs, ad_freqs=np.array([20.0, 30.0, 40.0], np.float32),
        other=(1.0 + rng.standard_normal((8, 3, 128))).astype(np.float32),
        sig=sig, st_freqs=np.array([20.0, 40.0, 60.0, 80.0], np.float32),
        tf_a=ta, tf_b=tb, hmm_x=hmm_x,
        hmm_perm=np.asarray(jax.random.permutation(_key(0), 160)),
        ica_x=(mix @ src).astype(np.float32),
        ica_w0=np.asarray(jax.random.normal(_key(0), (3, 3), jnp.float32)),
        cov_x=cov_x, cov_y=cov_y)


def _jx(inp, *keys):
    return [jnp.asarray(inp[k]) for k in keys]


def _m(*shape):
    return jpar.make_mesh(*shape)


#: The JAX package's sharded results, by case.
JAX = {
    "null_sign": lambda i: jpar.sharded_cluster_null(
        i["cl_x"], _key(1), mesh=_m(2, 1, 1), n_perm=N_PERM,
        threshold=i["cl_thr"], chunk=CHUNK),
    "null_relabel": lambda i: jpar.sharded_cluster_null(
        i["cl_x"], _key(2), mesh=_m(2, 1, 1), n_perm=N_PERM,
        threshold=i["cl_thr"], na=NA, chunk=CHUNK),
    "null_anova": lambda i: jpar.sharded_cluster_null(
        i["cl_x"], _key(3), mesh=_m(2, 1, 1), n_perm=N_PERM,
        threshold=i["cl_thr"], sizes=SIZES, chunk=CHUNK),
    "modwt": lambda i: jpar.sharded_modwt(
        jnp.asarray(i["sig"]), mesh=_m(2, 1, 1), level=3),
    "modwt_denoise": lambda i: jpar.sharded_modwt(
        jnp.asarray(i["sig"]), mesh=_m(2, 1, 1), denoise=True, mode="hard"),
    "stockwell": lambda i: jpar.sharded_stockwell(
        jnp.asarray(i["sig"]), i["st_freqs"], mesh=_m(1, 2, 1), sfreq=SF),
    "tf_decode": lambda i: jpar.sharded_tf_decode(
        *_jx(i, "tf_a", "tf_b"), mesh=_m(1, 2, 1), n_folds=3),
    "hmm": lambda i: jpar.sharded_hmm_fit(
        jnp.asarray(i["hmm_x"]), mesh=_m(2, 1, 1), n_states=3, n_iter=5,
        stickiness=0.8, seed=0),
    "ica": lambda i: jpar.sharded_fastica(
        jnp.asarray(i["ica_x"]), mesh=_m(2, 1, 1), n_iter=200, seed=0),
    "covariance": lambda i: jpar.sharded_covariance(
        jnp.asarray(i["cov_x"]), mesh=_m(2, 1, 1)),
    "csp": lambda i: tuple(jpar.sharded_csp(
        *_jx(i, "cov_x", "cov_y"), mesh=_m(2, 1, 1), n_components=2)),
}


@pytest.fixture(scope="module")
def run(inp):
    return cases.start(cases.stats_cases, (2, 1, 1), inp)


@pytest.fixture(scope="module")
def want(run, inp):
    """Computed while the ranks run."""
    return {k: jax.tree_util.tree_map(np.asarray, f(inp))
            for k, f in JAX.items()}


@pytest.fixture(scope="module")
def got(run, want):
    return run.result().result


_ok = cases.ok


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(a, b, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


# -- the permutation nulls ------------------------------------------------------------

@pytest.mark.parametrize("case,single,kw", [
    ("null_sign", tc._sign_flip_null_from_draws, {}),
    ("null_relabel", tc._relabel_null_from_draws, {"na": NA}),
    ("null_anova", tc._anova_null_from_draws, {"sizes": SIZES})])
def test_null_is_the_single_device_null_bit_for_bit(got, want, inp, case,
                                                    single, kw):
    """Fed the JAX package's draws: the mesh null (3 chunks padded to 4
    over the data axis) is the port's single-device null exactly, and the
    JAX package's sharded null at the cluster tests' rtol."""
    draws = inp[{"null_sign": "signs", "null_relabel": "relabel",
                 "null_anova": "anova"}[case]]
    out = _ok(got, case)
    assert out.shape == (N_PERM,)
    ref = single(_t(inp["cl_x"]), _t(draws), n_perm=N_PERM,
                 threshold=inp["cl_thr"], **kw).numpy()
    np.testing.assert_array_equal(out, ref)
    _close(out, want[case], RTOL)


def test_null_from_a_seed_is_the_single_device_null(got, inp):
    ref = tc._sign_flip_null(_t(inp["cl_x"]), 5, n_perm=20,
                             threshold=inp["cl_thr"], chunk=8).numpy()
    np.testing.assert_array_equal(_ok(got, "null_seed"), ref)


def _same_result(a, b):
    for fa, fb in zip(a, b):
        if isinstance(fa, np.ndarray):
            np.testing.assert_array_equal(fa, fb)
        else:
            assert fa == fb


@pytest.mark.parametrize("case,fn,args", [
    ("test_one", tc.cluster_test_one_sample, ("cl_x",)),
    ("test_ind", tc.cluster_test_independent, ("cl_x", "cl_y"))])
def test_cluster_tests_equal_one_device(got, inp, case, fn, args):
    ref = fn(*[_t(inp[a]) for a in args], n_perm=30, seed=3)
    _same_result(_ok(got, case), ref)


def test_cluster_test_f_equals_one_device(got, inp):
    xa, xb = _t(inp["cl_x"]), _t(inp["cl_y"])
    ref = tc.cluster_test_f([xa, xb, xa[:4] - 0.5], n_perm=30, seed=3)
    _same_result(_ok(got, "test_f"), ref)


@pytest.mark.parametrize("method", ["test", "paired", "ind", "all", "f"])
def test_adapter_mesh_equals_no_mesh(got, method):
    """``EpochsWavelet.cluster_test`` / ``cluster_test_all`` /
    ``cluster_f`` with a port mesh: the same result as ``mesh=None`` for
    the same seed (the planes ride the per-signal power on either)."""
    _same_result(_ok(got, f"adapter_{method}_mesh"),
                 _ok(got, f"adapter_{method}_none"))


# -- transforms -----------------------------------------------------------------------

@pytest.mark.parametrize("case", ["modwt", "modwt_denoise"])
def test_modwt(got, want, inp, case):
    out = _ok(got, case)
    _close(out, want[case], 1e-5, 1e-5 * np.abs(want[case]).max())
    if case == "modwt":
        single = tdwt.modwt(_t(inp["sig"]), level=3).numpy()
        _close(out, single, 1e-6, 1e-6 * np.abs(single).max())


def test_stockwell(got, want):
    for g, w in zip(_ok(got, "stockwell"), want["stockwell"]):
        _close(g, w, 1e-5, 1e-5 * np.abs(w).max())


def test_stockwell_validates_frequencies(got):
    cases.raised(got, "stockwell_bad", ValueError, "FFT bins")


# -- decoders and the state model ---------------------------------------------------

def test_tf_decode(got, want):
    _close(_ok(got, "tf_decode"), want["tf_decode"], 1e-5, 1e-6)


def test_tf_decode_needs_n_folds_trials(got):
    cases.raised(got, "tf_decode_few", ValueError, "n_folds")


def test_hmm_fed_the_jax_permutation(got, want):
    """The gates of ``test_torch_hmm``; and ``convert.hmm_result_from_jax``
    carries the JAX package's sharded result into the port's type."""
    out = _ok(got, "hmm")
    ref = convert.hmm_result_from_jax(want["hmm"], device="cpu")
    np.testing.assert_allclose(out.pi, ref.pi.numpy(), atol=1e-4)
    np.testing.assert_allclose(out.transition, ref.transition.numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(out.means, ref.means.numpy(), atol=1e-3)
    np.testing.assert_allclose(out.variances, ref.variances.numpy(),
                               atol=1e-3)
    np.testing.assert_allclose(out.gamma, ref.gamma.numpy(), atol=1e-4)
    np.testing.assert_array_equal(out.states, ref.states.numpy())
    np.testing.assert_allclose(out.loglik, ref.loglik.numpy(), rtol=1e-5)


def test_hmm_seeded_and_divisibility(got):
    res = _ok(got, "hmm_seed")
    assert res.gamma.shape == (4, 40, 3) and res.states.shape == (4, 40)
    np.testing.assert_allclose(res.gamma.sum(-1), 1.0, atol=1e-5)
    cases.raised(got, "hmm_odd", ValueError, "divisible by the data axis")


def test_fastica_fed_the_jax_draw(got, want, inp):
    """The gates of ``test_torch_ica_asr``: the converged model within 1e-4
    of max|ref| of the JAX package's sharded fit and of the port's single
    device, fed the same initial unmixing."""
    out = _ok(got, "ica")
    ref = convert.ica_result_from_jax(want["ica"], device="cpu")
    single = tica._fastica_from_w0(_t(inp["ica_x"]), _t(inp["ica_w0"]),
                                   n_iter=200)
    for name in ("unmixing", "mixing", "mean"):
        w = getattr(ref, name).numpy()
        _close(getattr(out, name), w, 0, 1e-4 * np.abs(w).max())
    np.testing.assert_allclose(out.unmixing, single.unmixing.numpy(),
                               atol=1e-4 * np.abs(single.unmixing.numpy())
                               .max())
    assert out.sources.shape == (3, 512)


def test_fastica_seeded_and_divisibility(got):
    res = _ok(got, "ica_seed")
    assert res.unmixing.shape == (3, 3) and res.convergence.shape == (4,)
    cases.raised(got, "ica_odd", ValueError, "divisible by the data axis")


def test_covariance_and_csp(got, want):
    _close(_ok(got, "covariance"), want["covariance"], 1e-5, 1e-6)
    cases.raised(got, "covariance_odd", ValueError,
                 "divisible by the data axis")
    out = _ok(got, "csp")
    for g, w in zip(out, want["csp"]):
        _close(g, w, 1e-4, 1e-4 * np.abs(w).max())
