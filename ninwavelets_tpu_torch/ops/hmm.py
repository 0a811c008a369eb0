"""Hidden-Markov-model spectral state detection (Baum-Welch EM + Viterbi;
the osl-dynamics / Vidaurre et al., NeuroImage 2016 workflow), port of
``ninwavelets_tpu.ops.hmm``: segment feature tracks into K recurring
states, each a diagonal Gaussian profile with Markov dwell-time structure.

The JAX package runs the forward, backward and Viterbi recursions as
sequential ``lax.scan``s over time, which compile into one device loop.
Here no pass loops over time steps:

* the step ``alpha_t = b_t + lse_i(alpha_{t-1}[i] + log A[i, j])`` is a
  K x K matrix product in the log semiring, ``M_t[i, j] = log A[i, j] +
  log b_t[j]``; the prefix products of the M_t come from a log-depth
  (doubling) scan, each product rescaled by its largest entry, which
  changes no normalized alpha.  The backward betas are the suffix products
  of the same matrices.  One parallel step from the scanned neighbour then
  forms each alpha, beta and per-step normalizer as the JAX recursion
  does, so the log-likelihood is the sum of the same per-step terms;
* the transition counts xi are formed in parallel over t from alpha and
  beta and summed, in chunks of time when K x K x T is large;
* Viterbi is the same scan in the max-plus semiring; its pointers are the
  argmax (first maximum, as ``jnp.argmax``) of each step, and the
  backtrack composes the (T, K) pointer maps by pointer doubling, which
  follows them exactly as the sequential backtrack does;
* EM runs a fixed number of iterations; several sequences share the
  parameters; restarts are a leading batch axis of every parameter.

The M-step's moment products run in ``fp32_matmul("exact")`` (the JAX
package's ``Precision.HIGHEST``).  The frames that seed the means are
chosen by a permutation from a ``torch.Generator``; ``_hmm_from_perms``
takes given permutations.  The scans round differently from the
sequential recursion, so a path may differ from the JAX package's where
two candidates are within round-off.

A numpy input goes to ``device`` (the card when None); a tensor stays on
its device.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..device import as_float32
from .scattering import fp32_matmul

__all__ = ["hmm_fit", "viterbi", "HMMResult"]

_VAR_FLOOR = 1e-5
#: elements of the (..., T, K, K) xi block formed at once
_XI_CHUNK = 1 << 24


class HMMResult(NamedTuple):
    """Fitted HMM.  ``gamma`` are posterior state probabilities per frame,
    ``states`` the Viterbi path; ``loglik`` the per-EM-iteration total
    log-likelihood trace (non-decreasing up to round-off)."""
    pi: torch.Tensor          # (K,) initial distribution
    transition: torch.Tensor  # (K, K) row-stochastic
    means: torch.Tensor       # (K, D)
    variances: torch.Tensor   # (K, D) diagonal
    gamma: torch.Tensor       # (..., T, K)
    states: torch.Tensor      # (..., T) int32 Viterbi path
    loglik: torch.Tensor      # (n_iter,)


def _log_obs(x, means, variances):
    """(..., T, K) log N(x_t | mu_k, diag var_k) of (..., T, D) frames under
    (..., K, D) parameters (leading dims broadcast)."""
    v = variances.clamp(min=_VAR_FLOOR)
    d2 = (x[..., :, None, :] - means[..., None, :, :]) ** 2 \
        / v[..., None, :, :]
    return -0.5 * (d2.sum(-1)
                   + torch.log(2.0 * math.pi * v).sum(-1)[..., None, :])


def _scan(fn, x, dim):
    """Inclusive scan of the associative ``fn(earlier, later)`` along
    ``dim`` by doubling: log2(T) steps, each combining every element with
    the one ``d`` before it."""
    t = x.shape[dim]
    d = 1
    while d < t:
        x = torch.cat([x.narrow(dim, 0, d),
                       fn(x.narrow(dim, 0, t - d), x.narrow(dim, d, t - d))],
                      dim)
        d *= 2
    return x


def _rescale(r):
    return r - r.amax((-2, -1), keepdim=True)


def _lse_mm(p, q):
    """Log-semiring product of (..., K, K) matrices, rescaled."""
    return _rescale(torch.logsumexp(p[..., :, :, None] + q[..., None, :, :],
                                    -2))


def _max_mm(p, q):
    """Max-plus product of (..., K, K) matrices, rescaled."""
    return _rescale((p[..., :, :, None] + q[..., None, :, :]).amax(-2))


def _step_mats(log_b, log_a):
    """M_t[i, j] = log A[i, j] + log b_t[j] for t = 1 .. T-1:
    (..., T-1, K, K)."""
    return log_a[..., None, :, :] + log_b[..., 1:, None, :]


def _forward(log_b, log_pi, log_a):
    """Normalized forward pass: (log_alpha (..., T, K), loglik (...,))."""
    la0 = log_pi + log_b[..., 0, :]
    z0 = torch.logsumexp(la0, -1)
    a0 = la0 - z0[..., None]
    pref = _scan(_lse_mm, _step_mats(log_b, log_a), -3)
    scanned = torch.logsumexp(a0[..., None, :, None] + pref, -2)
    prev = torch.cat([a0[..., None, :], scanned[..., :-1, :]], -2)
    prev = prev - torch.logsumexp(prev, -1, keepdim=True)
    # one step of the recursion from each scanned alpha_{t-1}
    la = log_b[..., 1:, :] + torch.logsumexp(
        prev[..., :, :, None] + log_a[..., None, :, :], -2)
    z = torch.logsumexp(la, -1)
    log_alpha = torch.cat([a0[..., None, :], la - z[..., None]], -2)
    return log_alpha, z0 + z.sum(-1)


def _backward_stats(log_b, log_a, log_alpha):
    """(gamma (..., T, K), xi_sum (..., K, K)): the betas from the suffix
    products of the step matrices, each then formed by one step of the
    recursion; xi summed over t in chunks."""
    k = log_a.shape[-1]
    t = log_b.shape[-2]
    if t == 1:
        gamma = torch.softmax(log_alpha, -1)
        return gamma, torch.zeros(log_alpha.shape[:-2] + (k, k),
                                  device=log_b.device)
    mats = _step_mats(log_b, log_a)                       # M_1 .. M_{T-1}
    suff = _scan(lambda p, q: _lse_mm(q, p), mats.flip(-3), -3).flip(-3)
    scanned = torch.logsumexp(suff, -1)                   # beta_0 .. T-2
    nxt = torch.cat([scanned[..., 1:, :],
                     torch.zeros_like(scanned[..., :1, :])], -2)
    nxt = nxt - nxt.amax(-1, keepdim=True)                # beta_1 .. T-1
    lbeta = torch.logsumexp(mats + nxt[..., None, :], -1)
    lbeta = lbeta - lbeta.amax(-1, keepdim=True)
    lbeta_full = torch.cat([lbeta, torch.zeros_like(lbeta[..., :1, :])], -2)
    lg = log_alpha + lbeta_full
    gamma = torch.exp(lg - torch.logsumexp(lg, -1, keepdim=True))

    # xi(t) propto alpha_t(i) A_ij b_{t+1}(j) beta_{t+1}(j)
    xi_sum = 0.0
    step = max(1, _XI_CHUNK // max(1, mats[..., :1, :, :].numel()))
    for s in range(0, t - 1, step):
        e = min(t - 1, s + step)
        lxi = log_alpha[..., s:e, :, None] + mats[..., s:e, :, :] \
            + nxt[..., s:e, None, :]
        lxi = lxi - torch.logsumexp(lxi, (-2, -1), keepdim=True)
        xi_sum = xi_sum + torch.exp(lxi).sum(-3)
    return gamma, xi_sum


def _e_step(x, pi, a, means, variances):
    """E-step of (B, T, D) sequences under parameters with leading dims P
    ((*P, K), (*P, K, K), (*P, K, D), (*P, K, D)): gamma (*P, B, T, K),
    xi_sum (*P, B, K, K), loglik (*P, B)."""
    log_b = _log_obs(x, means[..., None, :, :], variances[..., None, :, :])
    log_pi = torch.log(pi)[..., None, :]
    log_a = torch.log(a)[..., None, :, :]
    log_alpha, loglik = _forward(log_b, log_pi, log_a)
    gamma, xi_sum = _backward_stats(log_b, log_a, log_alpha)
    return gamma, xi_sum, loglik


def _init_params(x, perm, k, stickiness):
    """EM seeding from a (B, T, D) block: means from the frames at
    ``perm`` (a permutation of the B*T frames) in k chunks, the global
    variance, sticky uniform transitions."""
    d = x.shape[-1]
    flat = x.reshape(-1, d)
    chunk = max(1, min(16, flat.shape[0] // k))
    seeds = flat[perm[:k * chunk]].reshape(k, chunk, d).mean(1)  # (K, D)
    gvar = flat.var(0, correction=0) + _VAR_FLOOR
    pi0 = torch.full((k,), 1.0 / k, device=x.device)
    eye = torch.eye(k, device=x.device)
    a0 = (1.0 - stickiness) / (k - 1.0) * (1.0 - eye) + stickiness * eye
    return pi0, a0, seeds, gvar.expand(k, d)


def _viterbi(x, pi, a, means, variances):
    """(B, T) int32 most-likely paths of (B, T, D) sequences under one
    parameter set."""
    log_b = _log_obs(x, means, variances)                 # (B, T, K)
    log_a = torch.log(a)
    delta0 = torch.log(pi) + log_b[:, 0, :]
    t = x.shape[-2]
    if t == 1:
        return delta0.argmax(-1, keepdim=True).to(torch.int32)
    pref = _scan(_max_mm, _step_mats(log_b, log_a), -3)
    scanned = (delta0[:, None, :, None] + pref).amax(-2)  # delta_1 .. T-1
    prev = torch.cat([delta0[:, None, :], scanned[:, :-1, :]], 1)
    prev = prev - prev.amax(-1, keepdim=True)
    # pointer of step t: argmax_i delta_{t-1}[i] + log A[i, j]
    ptrs = (prev[..., :, None] + log_a).argmax(-2)        # (B, T-1, K)
    s_last = scanned[:, -1, :].argmax(-1)                 # (B,)
    # g_t = ptr_{t+1} o ... o ptr_{T-1}: suffix compositions of the maps
    comp = _scan(lambda p, q: torch.gather(q, -1, p), ptrs.flip(1),
                 1).flip(1)
    path = torch.gather(comp, -1, s_last[:, None, None].expand(
        -1, t - 1, 1))[..., 0]
    return torch.cat([path, s_last[:, None]], 1).to(torch.int32)


def _hmm_from_perms(x, perms, *, n_states, n_iter, stickiness):
    """EM from the seeds that each (R, B*T) permutation row picks (one row a
    restart), the restarts run as a batch; the restart with the best final
    log-likelihood (the first of equals) is decoded and returned."""
    b, t, d = x.shape
    k = int(n_states)
    init = [_init_params(x, p, k, stickiness) for p in perms]
    pi, a, means, variances = (torch.stack(z) for z in zip(*init))
    flat = x.reshape(-1, d)
    trace = []
    for _ in range(int(n_iter)):
        gamma, xi, ll = _e_step(x, pi, a, means, variances)
        g = gamma.reshape(gamma.shape[0], -1, k)          # (R, B*T, K)
        nk = g.sum(1) + 1e-8
        with fp32_matmul("exact"):
            means = (g.transpose(1, 2) @ flat) / nk[..., None]
            ex2 = (g.transpose(1, 2) @ (flat * flat)) / nk[..., None]
        variances = (ex2 - means * means).clamp(min=_VAR_FLOOR)
        xi_tot = xi.sum(1) + 1e-8
        a = xi_tot / xi_tot.sum(-1, keepdim=True)
        pi = gamma[:, :, 0, :].mean(1) + 1e-8
        pi = pi / pi.sum(-1, keepdim=True)
        trace.append(ll.sum(-1))
    trace = torch.stack(trace, -1)                        # (R, n_iter)
    best = int(trace[:, -1].argmax())
    pi, a, means, variances = pi[best], a[best], means[best], variances[best]
    gamma, _, _ = _e_step(x, pi, a, means, variances)
    states = _viterbi(x, pi, a, means, variances)
    return HMMResult(pi, a, means, variances, gamma, states, trace[best])


def hmm_fit(features, n_states: int, n_iter: int = 50,
            stickiness: float = 0.9, seed: int = 0,
            n_restarts: int = 1, device=None) -> HMMResult:
    """Fit a K-state diagonal-Gaussian HMM to (T, D) or (B, T, D) feature
    tracks (the sequences share one parameter set) and decode them: an
    ``HMMResult`` with posteriors, the Viterbi path and the EM
    log-likelihood trace.

    ``stickiness`` sets the initial self-transition mass; ``n_restarts``
    runs that many independently seeded EMs as one batch and keeps the
    best final log-likelihood.  The seeding permutations come from a
    ``torch.Generator`` seeded with ``seed`` on the features' device
    (other draws than the JAX package's for one seed)."""
    x = as_float32(features, device)
    if x.ndim == 2:
        x, squeeze = x[None], True
    elif x.ndim == 3:
        squeeze = False
    else:
        raise ValueError("features must be (T, D) or (B, T, D)")
    if not (2 <= n_states <= x.shape[1] // 4):
        raise ValueError("need 2 <= n_states <= T/4")
    if n_iter < 1:
        raise ValueError("n_iter >= 1")
    if n_restarts < 1:
        raise ValueError("n_restarts >= 1")
    gen = torch.Generator(device=x.device).manual_seed(int(seed))
    frames = x.shape[0] * x.shape[1]
    perms = torch.stack([torch.randperm(frames, generator=gen,
                                        device=x.device)
                         for _ in range(int(n_restarts))])
    res = _hmm_from_perms(x, perms, n_states=n_states, n_iter=n_iter,
                          stickiness=float(stickiness))
    if squeeze:
        res = res._replace(gamma=res.gamma[0], states=res.states[0])
    return res


def viterbi(features, result: HMMResult) -> torch.Tensor:
    """(..., T) most-likely state path of new (T, D) / (B, T, D) features
    under a fitted model (on the model's device)."""
    x = as_float32(features, result.means.device)
    one = x.ndim == 2
    if one:
        x = x[None]
    out = _viterbi(x, result.pi, result.transition, result.means,
                   result.variances)
    return out[0] if one else out
