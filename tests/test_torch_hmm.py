"""The port's HMM (``ninwavelets_tpu_torch.ops.hmm``) against the JAX
package and a float64 sequential oracle, on the CPU.  The port runs the
forward, backward and Viterbi recursions as log-depth scans; the JAX
package and the oracle run them step by step.

Gates, each with its reason (the fit's are the JAX package's own
``test_sharded_matches_single_device``, which compares two reduction
orders of the same EM):

* a fit fed the JAX package's permutations (``_hmm_from_perms``): gamma
  and the transition matrix at atol 1e-4, the means at 1e-3, the
  log-likelihood trace at rtol 1e-5, the Viterbi paths equal;
* the forward / backward passes against the float64 oracle: log alpha at
  atol 1e-4 (float32 logs of order 1e2 a frame), gamma at 1e-5, the xi
  sums at rtol 1e-5, the log-likelihood at rtol 1e-6;
* Viterbi: equal paths, against the JAX package and the oracle, also at
  exact ties (the first maximum wins in all three);
* the scans: at most ceil(log2 T) combines a pass.
"""
import importlib
import math

import jax
import numpy as np
import pytest
import torch

from ninwavelets_tpu_torch import convert

from torch_threads import one_torch_thread  # noqa: F401

jh = importlib.import_module("ninwavelets_tpu.ops.hmm")
th = importlib.import_module("ninwavelets_tpu_torch.ops.hmm")

from test_hmm import A, MEANS, PI, STDS, _best_accuracy, _sample_hmm

CPU = "cpu"


def _jax_perms(n_frames, seed, restarts):
    key = jax.random.PRNGKey(seed)
    keys = [key] if restarts == 1 else list(jax.random.split(key, restarts))
    return torch.from_numpy(np.stack([
        np.asarray(jax.random.permutation(k, n_frames)) for k in keys]))


def _fit_fed_jax(x, k, n_iter, restarts=1, seed=0):
    x3 = x if x.ndim == 3 else x[None]
    res = th._hmm_from_perms(torch.from_numpy(x3),
                             _jax_perms(x3.shape[0] * x3.shape[1], seed,
                                        restarts),
                             n_states=k, n_iter=n_iter, stickiness=0.9)
    if x.ndim == 2:
        res = res._replace(gamma=res.gamma[0], states=res.states[0])
    return res


def _oracle(x, pi, a, means, var):
    """float64 sequential forward-backward and Viterbi of one (T, D)
    sequence: (log_alpha, gamma, xi_sum, loglik, path)."""
    x, pi, a, means, var = (np.asarray(v, np.float64)
                            for v in (x, pi, a, means, var))
    v = np.maximum(var, th._VAR_FLOOR)
    lb = -0.5 * (((x[:, None, :] - means[None]) ** 2 / v[None]).sum(-1)
                 + np.log(2 * np.pi * v).sum(-1))
    la, lpi = np.log(a), np.log(pi)
    t, k = lb.shape

    def lse(z, axis=None):
        m = np.max(z, axis=axis, keepdims=True)
        return np.squeeze(m + np.log(np.exp(z - m).sum(axis, keepdims=True)),
                          axis)

    alpha = np.zeros((t, k))
    cur = lpi + lb[0]
    total = lse(cur)
    alpha[0] = cur - total
    for i in range(1, t):
        cur = lb[i] + lse(alpha[i - 1][:, None] + la, 0)
        z = lse(cur)
        alpha[i] = cur - z
        total += z
    beta = np.zeros((t, k))
    xi = np.zeros((k, k))
    for i in range(t - 2, -1, -1):
        m = la + (lb[i + 1] + beta[i + 1])[None]
        beta[i] = lse(m, 1)
        lxi = alpha[i][:, None] + m
        xi += np.exp(lxi - lse(lxi))
        beta[i] -= beta[i].max()
    lg = alpha + beta
    gamma = np.exp(lg - lse(lg, 1)[:, None])
    delta = lpi + lb[0]
    ptr = np.zeros((t, k), int)
    for i in range(1, t):
        cand = delta[:, None] + la
        ptr[i] = cand.argmax(0)
        delta = cand.max(0) + lb[i]
    path = np.zeros(t, int)
    path[-1] = delta.argmax()
    for i in range(t - 1, 0, -1):
        path[i - 1] = ptr[i][path[i]]
    return alpha, gamma, xi, total, path


def _params(k=3, d=4, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.random((k, k)) + 2 * np.eye(k)
    pi = rng.random(k) + 0.1
    return (pi / pi.sum(), a / a.sum(1, keepdims=True),
            1.5 * rng.standard_normal((k, d)), 0.5 + rng.random((k, d)))


@pytest.mark.parametrize("t", [1, 2, 7, 300])
def test_passes_match_the_float64_oracle(t):
    pi, a, means, var = _params()
    x = np.random.default_rng(t).standard_normal((2, t, 4))
    args = [torch.tensor(v, dtype=torch.float32) for v in (pi, a, means,
                                                            var)]
    gamma, xi, ll = th._e_step(torch.tensor(x, dtype=torch.float32), *args)
    log_b = th._log_obs(torch.tensor(x, dtype=torch.float32), args[2],
                        args[3])
    log_alpha, _ = th._forward(log_b, torch.log(args[0]),
                               torch.log(args[1]))
    path = th._viterbi(torch.tensor(x, dtype=torch.float32), *args)
    for b in range(2):
        alpha, g, xs, total, p = _oracle(x[b], pi, a, means, var)
        np.testing.assert_allclose(log_alpha[b].numpy(), alpha, atol=1e-4)
        np.testing.assert_allclose(gamma[b].numpy(), g, atol=1e-5)
        np.testing.assert_allclose(xi[b].numpy(), xs, rtol=1e-5,
                                   atol=1e-5 * max(xs.max(), 1.0))
        np.testing.assert_allclose(float(ll[b]), total, rtol=1e-6)
        np.testing.assert_array_equal(path[b].numpy(), p)


def test_viterbi_keeps_the_first_maximum_at_ties():
    """States 1 and 2 are copies of each other and the transitions are
    symmetric in them: every step ties between them, and the first index
    must win, as ``jnp.argmax`` and the oracle decide."""
    pi = np.array([0.2, 0.4, 0.4])
    a = np.array([[0.8, 0.1, 0.1], [0.1, 0.45, 0.45], [0.1, 0.45, 0.45]])
    means = np.array([[0.0, 0.0], [2.0, 2.0], [2.0, 2.0]])
    var = np.ones((3, 2))
    x = _sample_hmm(200, np.array([0.5, 0.5]), np.array([[0.9, 0.1],
                                                         [0.1, 0.9]]),
                    np.array([[0.0, 0.0], [2.0, 2.0]]), np.ones((2, 2)),
                    seed=5)[0]
    got = th._viterbi(torch.from_numpy(x[None]), *[
        torch.tensor(v, dtype=torch.float32) for v in (pi, a, means, var)])
    want = jh._viterbi_jit_body(x, *[np.float32(v) for v in (pi, a, means,
                                                             var)])
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[0].numpy(),
                                  _oracle(x, pi, a, means, var)[-1])
    assert set(got[0].tolist()) == {0, 1}


def test_scans_take_log_depth(monkeypatch):
    """Each pass combines whole time axes ceil(log2 T) times, never once a
    step."""
    calls = {"lse": 0, "max": 0}
    lse, mx = th._lse_mm, th._max_mm

    def count(key, fn):
        def wrapped(p, q):
            calls[key] += 1
            return fn(p, q)
        return wrapped

    monkeypatch.setattr(th, "_lse_mm", count("lse", lse))
    monkeypatch.setattr(th, "_max_mm", count("max", mx))
    pi, a, means, var = (torch.tensor(v, dtype=torch.float32)
                         for v in _params())
    x = torch.randn(1, 1000, 4)
    th._e_step(x, pi, a, means, var)
    th._viterbi(x, pi, a, means, var)
    steps = math.ceil(math.log2(999))
    assert calls == {"lse": 2 * steps, "max": steps}


@pytest.mark.parametrize("multi,restarts", [(False, 1), (True, 1),
                                            (True, 3)])
def test_fit_fed_jax_permutations_matches_jax(multi, restarts):
    if multi:
        x = np.stack([_sample_hmm(300, PI, A, MEANS, STDS, seed=s)[0]
                      for s in range(3)])
    else:
        x = _sample_hmm(600, PI, A, MEANS, STDS, seed=1)[0]
    got = _fit_fed_jax(x, 2, 20, restarts)
    want = jh.hmm_fit(x, 2, n_iter=20, n_restarts=restarts)
    np.testing.assert_allclose(got.gamma.numpy(), np.asarray(want.gamma),
                               atol=1e-4)
    np.testing.assert_allclose(got.transition.numpy(),
                               np.asarray(want.transition), atol=1e-4)
    np.testing.assert_allclose(got.means.numpy(), np.asarray(want.means),
                               atol=1e-3)
    np.testing.assert_allclose(got.pi.numpy(), np.asarray(want.pi),
                               atol=1e-4)
    np.testing.assert_allclose(got.loglik.numpy(), np.asarray(want.loglik),
                               rtol=1e-5)
    np.testing.assert_array_equal(got.states.numpy(),
                                  np.asarray(want.states))
    assert got.states.dtype == torch.int32


def test_init_params_matches_jax():
    x = np.stack([_sample_hmm(100, PI, A, MEANS, STDS, seed=s)[0]
                  for s in range(2)])
    perm = _jax_perms(200, 3, 1)[0]
    got = th._init_params(torch.from_numpy(x), perm, 3, 0.8)
    want = jh._init_params(x, jax.random.PRNGKey(3), 3, 0.8)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_viterbi_of_a_converted_jax_model():
    x, s = _sample_hmm(1500, PI, A, MEANS, STDS, seed=4)
    res = jh.hmm_fit(x[:1000], 2, n_iter=30)
    ours = convert.hmm_result_from_jax(res, device=CPU)
    assert isinstance(ours, th.HMMResult)
    path = th.viterbi(x[1000:], ours)
    assert path.shape == (500,)
    np.testing.assert_array_equal(path.numpy(),
                                  np.asarray(jh.viterbi(x[1000:], res)))
    both = th.viterbi(np.stack([x[1000:], x[:500]]), ours)
    np.testing.assert_array_equal(both[0].numpy(), path.numpy())


def test_own_draws_recover_the_chain():
    """``tests/test_hmm.py``'s recovery with the port's generator: the
    states found, sticky transitions, a log-likelihood that never falls."""
    x, s = _sample_hmm(3000, PI, A, MEANS, STDS, seed=1)
    res = th.hmm_fit(x, 2, n_iter=40, seed=0, device=CPU)
    assert _best_accuracy(res.states.numpy(), s, 2) > 0.95
    assert (torch.diagonal(res.transition) > 0.8).all()
    ll = res.loglik.double()
    assert ((ll[1:] - ll[:-1]) >= -1e-6 * ll[1:].abs()).all()
    r3 = th.hmm_fit(x, 2, n_iter=10, n_restarts=3, device=CPU)
    assert r3.loglik.shape == (10,) and r3.gamma.shape == (3000, 2)


def test_validation():
    x = np.zeros((100, 3), np.float32)
    for fn in (jh.hmm_fit, lambda *a, **k: th.hmm_fit(*a, device=CPU,
                                                      **k)):
        for args, kw in (((np.zeros(50, np.float32), 2), {}),
                         ((x, 50), {}), ((x, 2), dict(n_iter=0)),
                         ((x, 2), dict(n_restarts=0))):
            with pytest.raises(ValueError):
                fn(*args, **kw)
