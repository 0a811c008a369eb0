"""Analytic forward models and dipole fits, port of
``ninwavelets_tpu.ops.leadfield``: the EEG potential of a current dipole in
a homogeneous conducting sphere (exact series), the MEG field of a
spherically symmetric conductor (Sarvas 1987), electrode layouts, source
grids and single-dipole fits (mne's ``fit_dipole`` for a spherical head).

EEG: for a dipole ``q`` at radius ``b`` in a sphere of radius ``R`` and
conductivity ``sigma``, the surface potential at electrode direction
``r_e`` is

    V = 1/(4 pi sigma R^2) * sum_{n>=1} (2n+1)/n * f^(n-1)
        * [ n (q . r0_hat) P_n(c)  +  (q . (r_e_hat - c r0_hat)) P_n'(c) ]

with ``f = b/R`` and ``c = cos(angle(r0, r_e))``.  ``P_n`` and ``P_n'``
come from the Bonnet recurrences in a loop over the terms, every (E, S)
plane at once, with the JAX scan's operations in its order.

The fits scan a source grid (the best closed-form moment at every point:
batched 3 x 3 ``solve_ex``), then refine the position by Adam steps whose
gradient ``torch.autograd`` takes through the series (EEG) or the Sarvas
form (MEG), the moment re-solved in closed form inside the loss.  The
steps keep the JAX package's norm clamp and origin nudge.  Every product
runs in ``fp32_matmul("exact")``.

Positions are host numpy (float64); the planes go to ``device`` (the card
when None); the fits return host numpy, as the JAX package's do.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .scattering import fp32_matmul

__all__ = ["sphere_leadfield", "fibonacci_electrodes", "source_grid",
           "fit_dipole", "fit_dipole_evoked", "sphere_leadfield_meg",
           "fit_dipole_meg"]

_MU0 = 4e-7 * np.pi


def _f32(x, device):
    return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                           device=device)


def _series(re_hat, r0_hat, f, n_terms: int):
    """(E, S, 3) leadfield series for unit dipoles along x / y / z:
    ``re_hat`` (E, 3) unit electrode directions, ``r0_hat`` (S, 3) unit
    source directions, ``f`` (S,) eccentricities in [0, 1).  The caller
    applies 1 / (4 pi sigma R^2)."""
    with fp32_matmul("exact"):
        c = re_hat @ r0_hat.T                              # cos gamma
    t = re_hat[:, None, :] - c[..., None] * r0_hat[None, :, :]
    # n = 1 seeded: P_1 = c, P_1' = 1, weight 3 f^0
    p_nm1, p_n = torch.ones_like(c), c
    dp_nm1, dp_n = torch.zeros_like(c), torch.ones_like(c)
    acc_r, acc_t = 3.0 * p_n, 3.0 * dp_n
    fpow = f
    for n in range(1, int(n_terms)):
        nf = float(n)
        # Bonnet: (n+1) P_{n+1} = (2n+1) c P_n - n P_{n-1}
        p_np1 = ((2 * nf + 1) * c * p_n - nf * p_nm1) / (nf + 1)
        # P'_{n+1} = P'_{n-1} + (2n+1) P_n
        dp_np1 = dp_nm1 + (2 * nf + 1) * p_n
        m = nf + 1
        w = float(np.float32(2 * m + 1) / np.float32(m)) * fpow   # (S,)
        acc_r = acc_r + w[None, :] * m * p_np1
        acc_t = acc_t + w[None, :] * dp_np1
        fpow = fpow * f
        p_nm1, p_n, dp_nm1, dp_n = p_n, p_np1, dp_n, dp_np1
    return (acc_r[..., None] * r0_hat[None, :, :]
            + acc_t[..., None] * t)


def _oriented(lf, orientation, src):
    ori = np.asarray(orientation, np.float64)
    if ori.shape != src.shape:
        raise ValueError("orientation must match src_pos (S, 3)")
    ori = ori / np.maximum(np.linalg.norm(ori, axis=1, keepdims=True),
                           1e-30)
    with fp32_matmul("exact"):
        return torch.einsum("esk,sk->es", lf, _f32(ori, lf.device))


def sphere_leadfield(elec_pos, src_pos, radius: float | None = None,
                     sigma: float = 0.33, n_terms: int = 200,
                     orientation=None, device=None) -> torch.Tensor:
    """EEG leadfield of a homogeneous conducting sphere: (E, S, 3), the
    potential at each electrode for unit x / y / z dipoles, or (E, S) with
    (S, 3) ``orientation``s.  ``elec_pos`` (E, 3) are projected onto the
    sphere; ``src_pos`` (S, 3) must stay below 0.95 x ``radius`` (default
    the mean electrode radius); ``sigma`` in S/m; ``n_terms`` truncates
    the series (error about f^n_terms)."""
    elec = np.asarray(elec_pos, np.float64)
    src = np.asarray(src_pos, np.float64)
    if elec.ndim != 2 or elec.shape[1] != 3:
        raise ValueError("elec_pos must be (E, 3)")
    if src.ndim != 2 or src.shape[1] != 3:
        raise ValueError("src_pos must be (S, 3)")
    er = np.linalg.norm(elec, axis=1)
    if np.any(er <= 0):
        raise ValueError("electrode at the origin")
    r = float(radius) if radius is not None else float(er.mean())
    if r <= 0:
        raise ValueError("radius must be positive")
    re_hat = elec / er[:, None]
    b = np.linalg.norm(src, axis=1)
    f = b / r
    if np.any(f >= 0.95):
        raise ValueError(
            f"source eccentricity up to {f.max():.3f} — the series "
            "model needs |src| < 0.95 * radius")
    # a source at the origin has no direction: any unit vector will do
    # (f = 0 leaves only the n = 1 term)
    safe_b = np.where(b > 0, b, 1.0)
    r0_hat = src / safe_b[:, None]
    r0_hat[b == 0] = np.array([0.0, 0.0, 1.0])
    device = resolve_device(device)
    lf = _series(_f32(re_hat, device), _f32(r0_hat, device),
                 _f32(f, device), int(n_terms))
    lf = lf / float(np.float32(4.0 * np.pi * float(sigma) * r * r))
    if orientation is not None:
        return _oriented(lf, orientation, src)
    return lf


def fibonacci_electrodes(n: int, radius: float = 0.09,
                         upper_only: bool = True) -> np.ndarray:
    """(n, 3) quasi-uniform electrode layout on the sphere (Fibonacci
    lattice); ``upper_only`` builds it on the z > 0 hemisphere, as a cap."""
    if n < 1:
        raise ValueError("need at least one electrode")
    i = np.arange(n) + 0.5
    golden = (1 + 5 ** 0.5) / 2
    phi = 2 * np.pi * i / golden
    z = (i / n) if upper_only else (1 - 2 * i / n)
    s = np.sqrt(np.maximum(1 - z * z, 0.0))
    return radius * np.stack([s * np.cos(phi), s * np.sin(phi), z], 1)


def source_grid(radius: float = 0.09, spacing: float = 0.015,
                max_eccentricity: float = 0.85) -> np.ndarray:
    """(S, 3) cubic source grid inside the sphere (the volumetric source
    space of LCMV / DICS scans)."""
    lim = radius * max_eccentricity
    ax = np.arange(-lim, lim + spacing / 2, spacing)
    g = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
    return g[np.linalg.norm(g, axis=1) <= lim]


def _grid_rss(lf, v):
    """Best closed-form moment per source and its residual: (S,) rss,
    (S, 3) q of an (E, S, 3) leadfield stack (the EEG and MEG scans)."""
    with fp32_matmul("exact"):
        g = torch.einsum("esk,esl->skl", lf, lf)
        b = torch.einsum("esk,e->sk", lf, v)
        eye = torch.eye(3, device=lf.device)
        g = g + 1e-6 * torch.diagonal(g, dim1=-2, dim2=-1).sum(-1)[
            :, None, None] * eye
        q = torch.linalg.solve_ex(g, b[..., None])[0][..., 0]
        fit = torch.einsum("esk,sk->es", lf, q)
    return torch.sum((v[:, None] - fit) ** 2, dim=0), q


def _adam_position(loss, p0, max_b: float, n_steps: int, lr: float):
    """Adam on a 3-vector position with a norm clamp into (0, max_b] and a
    nudge off the origin; ``loss(p) -> (val, q)``, its gradient by
    ``torch.autograd`` (forward and backward products in full float32).
    Shared by the EEG and MEG refinements."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    up = torch.tensor([0.0, 0.0, 1.0], device=p0.device)
    p = p0.clone()
    m = torch.zeros(3, device=p0.device)
    s2 = torch.zeros(3, device=p0.device)
    for i in range(int(n_steps)):
        p.requires_grad_(True)
        with fp32_matmul("exact"):            # the backward's products too
            val, _ = loss(p)
            grad, = torch.autograd.grad(val, p)
        p = p.detach()
        m = b1 * m + (1 - b1) * grad
        s2 = b2 * s2 + (1 - b2) * grad * grad
        mh = m / float(1 - np.float32(b1) ** np.float32(i + 1.0))
        sh = s2 / float(1 - np.float32(b2) ** np.float32(i + 1.0))
        p = p - lr * mh / (torch.sqrt(sh) + eps)
        b = torch.linalg.vector_norm(p)
        p = torch.where(b > max_b, p * (max_b / b), p)
        # and away from the origin: both models are degenerate there
        p = torch.where(b < 1e-3 * max_b, p + 1e-3 * max_b * up, p)
    with torch.no_grad():
        val, q = loss(p)
    return p, q, val


def _moment_loss(lf, v):
    """Residual of the best closed-form moment of an (E, 3) leadfield."""
    with fp32_matmul("exact"):
        g = lf.T @ lf
        # 1e-6 relative: a smaller floor is below float32 resolution
        g = g + 1e-6 * torch.trace(g) * torch.eye(3, device=lf.device)
        q = torch.linalg.solve_ex(g, lf.T @ v)[0]
        r = v - lf @ q
    return torch.sum(r * r), q


def _refine(v, re_hat, p0, scale, max_f: float, n_terms: int,
            n_steps: int):
    """Adam refinement of the EEG dipole POSITION (unit-sphere units)."""

    def loss(p):
        b = torch.linalg.vector_norm(p)
        fe = torch.clamp(b, max=max_f)
        r0 = p / torch.clamp(b, min=1e-12)
        lf = _series(re_hat, r0[None, :], fe[None], n_terms)[:, 0, :] * scale
        return _moment_loss(lf - torch.mean(lf, dim=0, keepdim=True), v)

    return _adam_position(loss, p0, max_f, n_steps, lr=3e-3)


def fit_dipole(v, elec_pos, radius: float | None = None,
               sigma: float = 0.33, spacing: float = 0.01,
               n_terms: int = 120, n_steps: int = 200,
               max_eccentricity: float = 0.90, device=None) -> dict:
    """Single equivalent-current-dipole fit of an (E,) topography ``v``
    (average-referenced here) in the spherical head: a grid scan with the
    best closed-form moment at every point, then ``n_steps`` Adam steps on
    the position through the series.  Returns a dict of host values:
    ``pos`` (3,), ``moment`` (3,), ``gof`` (1 - rss / ||v||^2) and
    ``grid_pos`` (the grid winner)."""
    v = np.asarray(v, np.float64)
    if v.ndim != 1:
        raise ValueError("v must be a single (E,) topography")
    elec = np.asarray(elec_pos, np.float64)
    if elec.shape != (v.shape[0], 3):
        raise ValueError("elec_pos must be (E, 3) matching v")
    er = np.linalg.norm(elec, axis=1)
    if np.any(er <= 0):
        raise ValueError("electrode at the origin")
    if not 0 < max_eccentricity < 0.95:
        raise ValueError("max_eccentricity must be in (0, 0.95) — the "
                         "series diverges beyond")
    r = float(radius) if radius is not None else float(er.mean())
    if r <= 0:
        raise ValueError("radius must be positive")
    re_hat = elec / er[:, None]
    v = v - v.mean()
    vn = float(np.linalg.norm(v))
    if vn == 0:
        raise ValueError("zero topography")
    grid = source_grid(r, spacing=spacing, max_eccentricity=max_eccentricity)
    b = np.linalg.norm(grid, axis=1)
    r0 = np.where(b[:, None] > 0, grid / np.maximum(b[:, None], 1e-30),
                  [0.0, 0.0, 1.0])
    scale = float(np.float32(1.0 / (4.0 * np.pi * float(sigma) * r * r)))
    device = resolve_device(device)
    vt = _f32(v / vn, device)
    ret = _f32(re_hat, device)
    lf = _series(ret, _f32(r0, device), _f32(b / r, device),
                 int(n_terms)) * scale
    # average-reference the MODEL too: the sphere potential is zero-mean
    # only over the full sphere, not a cap
    rss, _ = _grid_rss(lf - torch.mean(lf, dim=0, keepdim=True), vt)
    best = int(torch.argmin(rss))
    p, q, val = _refine(vt, ret, _f32(grid[best] / r, device), scale,
                        float(np.float32(max_eccentricity)), int(n_terms),
                        int(n_steps))
    return {"pos": p.cpu().numpy().astype(np.float64) * r,
            "moment": q.cpu().numpy().astype(np.float64) * vn,
            "gof": 1.0 - float(val),        # v was unit-normalized
            "grid_pos": grid[best]}


def fit_dipole_evoked(v_ts, elec_pos, radius: float | None = None,
                      sigma: float = 0.33, **kw) -> dict:
    """Dipole model of an (E, T) evoked time series (mne's ``fit_dipole``
    on an Evoked): the position fitted once on the peak-GFP topography,
    the moment time course the closed-form least-squares solve of that
    (E, 3) leadfield against every sample (host float64).  Returns the
    ``fit_dipole`` dict plus ``moment_ts`` (3, T), ``amplitude`` (T,),
    ``gof_ts`` (T,) and ``peak_sample``; ``device=`` and the other
    keywords pass to ``fit_dipole``."""
    v_ts = np.asarray(v_ts, np.float64)
    if v_ts.ndim != 2:
        raise ValueError("v_ts must be (E, T)")
    vc = v_ts - v_ts.mean(axis=0, keepdims=True)
    peak = int(np.argmax(vc.std(axis=0)))
    res = fit_dipole(v_ts[:, peak], elec_pos, radius=radius, sigma=sigma,
                     **kw)
    # the same truncation as the position fit, so res["gof"] and
    # gof_ts[peak_sample] agree
    lf = sphere_leadfield(elec_pos, res["pos"][None], radius=radius,
                          sigma=sigma, n_terms=int(kw.get("n_terms", 120)),
                          device=kw.get("device")).cpu().numpy()[:, 0, :]
    lf = lf - lf.mean(axis=0, keepdims=True)
    g = lf.T @ lf + 1e-12 * np.trace(lf.T @ lf) * np.eye(3)
    q_ts = np.linalg.solve(g, lf.T @ vc)                   # (3, T)
    rss = np.sum((vc - lf @ q_ts) ** 2, axis=0)
    tot = np.maximum(np.sum(vc * vc, axis=0), 1e-30)
    res.update(moment_ts=q_ts, amplitude=np.linalg.norm(q_ts, axis=0),
               gof_ts=1.0 - rss / tot, peak_sample=peak)
    return res


def _sarvas(r, n_hat, r0):
    """(E, S, 3) MEG leadfield by the Sarvas (1987, eq. 25) closed form:
    for a dipole q at r0 in a spherically symmetric conductor, B =
    mu0/(4 pi F^2) (F (q x r0) - ((q x r0) . r) grad F), F = a (r a +
    r^2 - r0 . r), a_vec = r - r0; the sensor reads B . n_hat."""
    with fp32_matmul("exact"):
        av = r[:, None, :] - r0[None, :, :]                   # (E, S, 3)
        a = torch.linalg.vector_norm(av, dim=-1)              # (E, S)
        rn = torch.linalg.vector_norm(r, dim=-1)[:, None]     # (E, 1)
        adr = torch.einsum("esk,ek->es", av, r)               # a . r
        r0dr = torch.einsum("sk,ek->es", r0, r)               # r0 . r
        f = a * (rn * a + rn * rn - r0dr)
        gf = ((a * a / rn + adr / a + 2 * a + 2 * rn)[..., None]
              * r[:, None, :]
              - (a + 2 * rn + adr / a)[..., None] * r0[None, :, :])
        # q x r0 for unit q along x / y / z: (e_k x r0)
        zeros = torch.zeros_like(r0[:, 0])
        qxr0 = torch.stack([
            torch.stack([zeros, r0[:, 2], -r0[:, 1]], -1),
            torch.stack([-r0[:, 2], zeros, r0[:, 0]], -1),
            torch.stack([r0[:, 1], -r0[:, 0], zeros], -1),
        ], 0)                                                 # (3, S, 3)
        num = (f[..., None, None] * qxr0[None].permute(0, 2, 1, 3)
               - torch.einsum("qsk,ek->esq", qxr0, r)[..., None]
               * gf[:, :, None, :])
        b = num * (_MU0 / (4 * np.pi)) / (f * f)[..., None, None]
        return torch.einsum("esqk,ek->esq", b, n_hat)


def sphere_leadfield_meg(sensor_pos, sensor_ori, src_pos, orientation=None,
                         device=None) -> torch.Tensor:
    """MEG leadfield of a spherically symmetric conductor (Sarvas):
    (E, S, 3), ``B . ori`` in tesla per A m for unit x / y / z dipoles, or
    (E, S) with ``orientation``.  ``sensor_pos`` (E, 3) must lie outside
    every source radius; ``sensor_ori`` (E, 3) is normalized here.  Radial
    dipoles are silent, the conductivity profile does not enter, and a
    center dipole makes no field."""
    sp = np.asarray(sensor_pos, np.float64)
    so = np.asarray(sensor_ori, np.float64)
    src = np.asarray(src_pos, np.float64)
    if sp.ndim != 2 or sp.shape[1] != 3:
        raise ValueError("sensor_pos must be (E, 3)")
    if so.shape != sp.shape:
        raise ValueError("sensor_ori must match sensor_pos")
    if src.ndim != 2 or src.shape[1] != 3:
        raise ValueError("src_pos must be (S, 3)")
    rs = np.linalg.norm(sp, axis=1)
    rq = np.linalg.norm(src, axis=1)
    if rs.min() <= rq.max():
        raise ValueError(
            f"sensors must sit outside the source region "
            f"(min |sensor| {rs.min():.4f} <= max |src| {rq.max():.4f})")
    so = so / np.maximum(np.linalg.norm(so, axis=1, keepdims=True), 1e-30)
    device = resolve_device(device)
    lf = _sarvas(_f32(sp, device), _f32(so, device), _f32(src, device))
    if orientation is not None:
        return _oriented(lf, orientation, src)
    return lf


def _refine_meg(v, sp, so, p0, max_b: float, n_steps: int):
    """Adam refinement of the MEG dipole position through the Sarvas
    form; the 1e-6 relative ridge keeps the rank-2 (radially silent)
    Gram solvable."""

    def loss(p):
        b = torch.linalg.vector_norm(p)
        pc = torch.where(b > max_b, p * (max_b / b), p)
        return _moment_loss(_sarvas(sp, so, pc[None, :])[:, 0, :], v)

    return _adam_position(loss, p0, max_b, n_steps, lr=2e-3)


def fit_dipole_meg(v, sensor_pos, sensor_ori, radius: float = 0.09,
                   spacing: float = 0.01, n_steps: int = 300,
                   max_eccentricity: float = 0.90, device=None) -> dict:
    """Single-dipole fit of an (E,) MEG topography (Sarvas model): the
    grid scan and Adam refinement of :func:`fit_dipole`.  The returned
    ``moment`` is the tangential part only (the radial one is silent);
    ``gof`` is against the field directly.  ``radius`` bounds the SOURCE
    region (the grid), not the sensors.  Host values, as ``fit_dipole``."""
    v = np.asarray(v, np.float64)
    if v.ndim != 1:
        raise ValueError("v must be a single (E,) topography")
    sp = np.asarray(sensor_pos, np.float64)
    so = np.asarray(sensor_ori, np.float64)
    if sp.shape != (v.shape[0], 3) or so.shape != sp.shape:
        raise ValueError("sensor_pos/sensor_ori must be (E, 3) "
                         "matching v")
    if not 0 < max_eccentricity < 1.0:
        raise ValueError("max_eccentricity must be in (0, 1)")
    vn = float(np.linalg.norm(v))
    if vn == 0:
        raise ValueError("zero topography")
    so = so / np.maximum(np.linalg.norm(so, axis=1, keepdims=True), 1e-30)
    grid = source_grid(radius, spacing=spacing,
                       max_eccentricity=max_eccentricity)
    # a (near-)center grid point is magnetically silent: its Gram is ~0
    # and its solve NaN, so the degenerate seeds are dropped
    grid = grid[np.linalg.norm(grid, axis=1) > 0.05 * radius]
    if np.linalg.norm(sp, axis=1).min() <= radius * max_eccentricity:
        raise ValueError("sensors must sit outside the source region")
    device = resolve_device(device)
    spt, sot = _f32(sp, device), _f32(so, device)
    vt = _f32(v / vn, device)
    rss, _ = _grid_rss(_sarvas(spt, sot, _f32(grid, device)), vt)
    best = int(torch.argmin(rss))
    p, q, val = _refine_meg(vt, spt, sot, _f32(grid[best], device),
                            float(np.float32(radius * max_eccentricity)),
                            int(n_steps))
    pos = p.cpu().numpy().astype(np.float64)
    # report the observable (tangential) moment only
    r0 = pos / max(np.linalg.norm(pos), 1e-30)
    qn = q.cpu().numpy().astype(np.float64) * vn
    return {"pos": pos, "moment": qn - (qn @ r0) * r0,
            "gof": 1.0 - float(val), "grid_pos": grid[best]}
