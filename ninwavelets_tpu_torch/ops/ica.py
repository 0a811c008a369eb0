"""Independent component analysis (symmetric FastICA, Hyvärinen & Oja
2000) for artifact separation, port of ``ninwavelets_tpu.ops.ica``.

Whitening is the ``eigh`` of the C x C channel covariance; the fixed point
runs a static number of iterations (a Python loop of the JAX package's
``lax.scan`` steps), each two (K, N) x (N, K) products and a K x K
symmetric decorrelation ``eigh``, whose result the host waits for on the
card.  Every product runs inside ``fp32_matmul("exact")`` (the JAX
package's ``Precision.HIGHEST``).  Components are sorted by explained
variance and each mixing column's largest-|.| coefficient is made
positive, so order and sign are deterministic whatever signs ``eigh``
gives its eigenvectors.  ``_whiten_from_cov``, ``_ica_step``,
``_finalize_components`` and ``_sym_decorrelate`` keep the JAX package's
names and signatures.

The initial unmixing comes from a ``torch.Generator`` seeded with
``seed``; ``_fastica_from_w0`` takes a given one (the CPU tests feed the
JAX package's ``jax.random`` draw).  A numpy input goes to ``device`` (the
card when None); a tensor stays on its device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import as_float32
from .scattering import fp32_matmul, sym_eigh

__all__ = ["fastica", "ica_transform", "ica_remove", "ICAResult",
           "ica_scores", "ica_kurtosis", "ica_find_bads"]


class ICAResult(NamedTuple):
    """Fitted ICA model.  ``sources = unmixing @ (x - mean)``;
    ``x ~= mixing @ sources + mean``."""
    unmixing: torch.Tensor    # (K, C)
    mixing: torch.Tensor      # (C, K)
    mean: torch.Tensor        # (C,)
    sources: torch.Tensor     # (K, N)
    convergence: torch.Tensor  # (n_iter,) max |1 - |<w_new, w_old>||


def _g(u, fun: str):
    """FastICA nonlinearity g(u) and its derivative."""
    if fun == "logcosh":
        gu = torch.tanh(u)
        gpu = 1.0 - gu * gu
    elif fun == "exp":
        e = torch.exp(-0.5 * u * u)
        gu = u * e
        gpu = (1.0 - u * u) * e
    elif fun == "cube":
        gu = u ** 3
        gpu = 3.0 * u * u
    else:
        raise ValueError("fun must be 'logcosh', 'exp' or 'cube'")
    return gu, gpu


def _sym_decorrelate(w):
    """W <- (W W^T)^(-1/2) W via eigh of the K x K Gram."""
    with fp32_matmul("exact"):
        s, e = sym_eigh(w @ w.T)
        inv_sqrt = (e / torch.sqrt(s.clamp(min=1e-12))) @ e.T
        return inv_sqrt @ w


def _whiten_from_cov(cov, xc, k, precision=None):
    """Top-K PCA whitening from a (C, C) covariance: ``(whiten (K, C),
    z (K, N), e_top, s_top)``.  ``precision`` is accepted for the JAX
    package's signature; products are always full float32."""
    s, e = sym_eigh(cov)                   # ascending
    s_top = s[-k:].flip(0)
    e_top = e[:, -k:].flip(1)
    whiten = (e_top / torch.sqrt(s_top.clamp(min=1e-12))).T  # (K, C)
    with fp32_matmul("exact"):
        return whiten, whiten @ xc, e_top, s_top


def _ica_step(w, z, fun, n, reduce_m=None, reduce_gp=None,
              precision=None):
    """One symmetric FastICA fixed-point update.  ``reduce_m`` /
    ``reduce_gp`` complete the two data-axis moments across devices
    (identity on one device)."""
    with fp32_matmul("exact"):
        u = w @ z                                   # (K, N)
        gu, gpu = _g(u, fun)
        m = gu @ z.T
    gp = gpu.sum(1)
    if reduce_m is not None:
        m = reduce_m(m)
    if reduce_gp is not None:
        gp = reduce_gp(gp)
    w_new = _sym_decorrelate(m / n - (gp / n)[:, None] * w)
    conv = (1.0 - (w_new * w).sum(1).abs()).abs().amax()
    return w_new, conv


def _finalize_components(w, whiten, e_top, s_top, xc, precision=None):
    """Unmixing / mixing assembly and the deterministic ORDER (explained
    variance) and SIGN (largest-|.| mixing coefficient positive)."""
    with fp32_matmul("exact"):
        unmixing = w @ whiten                                   # (K, C)
        mixing = (e_top * torch.sqrt(s_top.clamp(min=1e-12))) @ w.T
        power = (mixing * mixing).sum(0)
        order = torch.argsort(-power, stable=True)
        unmixing = unmixing[order]
        mixing = mixing[:, order]
        flip = torch.sign(torch.gather(
            mixing, 0, mixing.abs().argmax(0)[None, :]))[0]
        flip = torch.where(flip == 0, 1.0, flip)
        unmixing = unmixing * flip[:, None]
        mixing = mixing * flip[None, :]
        sources = unmixing @ xc
    return unmixing, mixing, sources


def _check(x, n_components, fun):
    if x.ndim != 2:
        raise ValueError("expected (channels, samples)")
    c, n = x.shape
    if n < c:
        raise ValueError("need more samples than channels")
    k = c if n_components is None else int(n_components)
    if not (1 <= k <= c):
        raise ValueError("n_components must be in [1, channels]")
    if fun not in ("logcosh", "exp", "cube"):
        raise ValueError("fun must be 'logcosh', 'exp' or 'cube'")
    return k


def _fastica_from_w0(x, w0, *, n_components=None, fun="logcosh",
                     n_iter=200) -> ICAResult:
    """``fastica`` from a given (K, K) initial unmixing ``w0`` (before its
    symmetric decorrelation, as the JAX package draws it)."""
    x = as_float32(x)
    k = _check(x, n_components, fun)
    n = x.shape[1]
    mean = x.mean(1)
    xc = x - mean[:, None]
    with fp32_matmul("exact"):
        cov = (xc @ xc.T) / n
    whiten, z, e_top, s_top = _whiten_from_cov(cov, xc, k)
    w = _sym_decorrelate(as_float32(w0, x.device))
    conv = []
    for _ in range(int(n_iter)):
        w, c = _ica_step(w, z, fun, n)
        conv.append(c)
    conv = torch.stack(conv) if conv else torch.zeros(0, device=x.device)
    un, mix, src = _finalize_components(w, whiten, e_top, s_top, xc)
    return ICAResult(un, mix, mean, src, conv)


def fastica(x, n_components: int | None = None, fun: str = "logcosh",
            n_iter: int = 200, seed: int = 0, device=None) -> ICAResult:
    """Symmetric FastICA of a (C, N) recording: ``ICAResult`` with
    variance-sorted, sign-fixed components.  ``fun`` is the contrast
    (``logcosh``, ``exp`` or ``cube``); ``n_iter`` a static iteration
    count: check ``convergence[-1]`` (~0 once converged).  The initial
    unmixing is standard normal from a ``torch.Generator`` seeded with
    ``seed`` on the data's device (other draws than the JAX package's)."""
    x = as_float32(x, device)
    k = _check(x, n_components, fun)
    gen = torch.Generator(device=x.device).manual_seed(int(seed))
    w0 = torch.randn((k, k), generator=gen, device=x.device,
                     dtype=torch.float32)
    return _fastica_from_w0(x, w0, n_components=k, fun=fun, n_iter=n_iter)


def ica_transform(x, result: ICAResult) -> torch.Tensor:
    """(K, N) source estimates of new data under a fitted model."""
    x = as_float32(x, result.unmixing.device)
    c = result.unmixing.shape[1]
    if x.shape[0] != c:
        raise ValueError(
            f"data has {x.shape[0]} channels but the model was fitted "
            f"on {c} — pass the same channel subset (picks) it was "
            "fitted with")
    with fp32_matmul("exact"):
        return result.unmixing @ (x - result.mean[:, None])


def _corr_jit(src, ref):
    """|Pearson r| of each (K, N) source row against each (R, N)
    reference row."""
    sc = src - src.mean(1, keepdim=True)
    sc = sc / torch.linalg.vector_norm(sc, dim=1, keepdim=True).clamp(
        min=1e-20)
    rc = ref - ref.mean(1, keepdim=True)
    rc = rc / torch.linalg.vector_norm(rc, dim=1, keepdim=True).clamp(
        min=1e-20)
    with fp32_matmul("exact"):
        return (sc @ rc.T).abs()                          # (K, R)


def ica_scores(result: ICAResult, ref) -> np.ndarray:
    """(K,) artifact score per component: the max |Pearson correlation| of
    each source with the reference channel(s) ``ref`` ((N,) or (R, N)),
    host numpy as in the JAX package."""
    src = as_float32(result.sources)
    ref = as_float32(ref, src.device)
    if ref.ndim == 1:
        ref = ref[None]
    if ref.shape[-1] != src.shape[-1]:
        raise ValueError(
            f"reference length {ref.shape[-1]} != source length "
            f"{src.shape[-1]}")
    return _corr_jit(src, ref).amax(1).cpu().numpy()


def _kurt_jit(src):
    sc = src - src.mean(1, keepdim=True)
    v = (sc * sc).mean(1).clamp(min=1e-20)
    return (sc ** 4).mean(1) / (v * v) - 3.0


def ica_kurtosis(result: ICAResult) -> np.ndarray:
    """(K,) excess kurtosis per source (host numpy)."""
    return _kurt_jit(as_float32(result.sources)).cpu().numpy()


def ica_find_bads(result: ICAResult, ref=None, threshold: float = 3.0,
                  measure: str = "zscore") -> tuple[list, np.ndarray]:
    """Flag artifact components: with ``ref`` by the max |correlation| per
    component (``ica_scores``), else by the excess kurtosis.
    ``measure="zscore"`` flags scores ``threshold`` robust z-units (median
    / 1.4826 MAD) above the rest, ``"absolute"`` compares the raw score.
    Returns ``(bad_indices, scores)``."""
    scores = (ica_scores(result, ref) if ref is not None
              else ica_kurtosis(result))
    if measure == "zscore":
        med = np.median(scores)
        mad = np.median(np.abs(scores - med)) * 1.4826
        z = (scores - med) / max(mad, 1e-12)
        bads = np.flatnonzero(z > float(threshold))
    elif measure == "absolute":
        bads = np.flatnonzero(scores > float(threshold))
    else:
        raise ValueError("measure must be 'zscore' or 'absolute'")
    return [int(i) for i in bads], scores


def ica_remove(x, result: ICAResult, exclude) -> torch.Tensor:
    """(C, N) reconstruction of ``x`` with the ``exclude``d component
    indices zeroed (mne's ``ica.apply``)."""
    x = as_float32(x, result.unmixing.device)
    k = result.unmixing.shape[0]
    exclude = np.atleast_1d(np.asarray(exclude, np.int64))
    if exclude.size and (exclude.min() < 0 or exclude.max() >= k):
        raise ValueError(f"exclude indices must be in [0, {k})")
    keep = np.ones(k, np.float32)
    keep[exclude] = 0.0
    src = ica_transform(x, result)
    with fp32_matmul("exact"):
        return ((result.mixing * torch.from_numpy(keep).to(x.device)[None])
                @ src + result.mean[:, None])
