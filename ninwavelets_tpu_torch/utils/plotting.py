"""Host-side plotting helpers (port of ``ninwavelets_tpu.utils.plotting``;
the reference's ``base.py:445-520``).

Pure matplotlib; tensors are pulled to the host with
``.detach().cpu().numpy()``.  matplotlib is imported inside each function,
so the package and the compute path work where it is not installed.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

Floats = Union[None, Tuple[float, float], Tuple[float, float, float]]


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def plot_wavelet(wavelet_obj, freq: float, show: bool = True):
    """Render one wavelet: time trace plus a 3-D real/imag scatter, and the
    object's ``help`` caution text when present (reference
    ``base.py:449-489``).
    """
    import matplotlib.pyplot as plt

    wavelet = _host(wavelet_obj.make_wavelets(np.array([freq]))[0])
    plt_num = 3 if wavelet_obj.help else 2
    fig = plt.figure(figsize=(6, 8))
    ax = fig.add_subplot(plt_num, 1, 1)
    idx = np.arange(wavelet.shape[0])
    ax.plot(idx, wavelet.real, label='real')
    if np.iscomplexobj(wavelet):
        ax.plot(idx, wavelet.imag, label='imag')
    ax.set_title(type(wavelet_obj).__name__ + ' wavelet')
    ax.legend(loc='upper right')
    ax1 = fig.add_subplot(plt_num, 1, 2, projection='3d')
    ax1.scatter3D(wavelet.real, idx, wavelet.imag)
    if plt_num == 3:
        ax2 = fig.add_subplot(313)
        ax2.set_title('Caution')
        ax2.text(0.05, 0.1, wavelet_obj.help)
        ax2.tick_params(labelbottom=False, labelleft=False, labelright=False,
                        labeltop=False, bottom=False, left=False, right=False,
                        top=False)
    if show:
        plt.show()
    return fig


def _tick_spec(n_cells: int, rng, cells_per_unit: float):
    """(positions, labels) for a ``(start, stop, step)`` range spec laid
    over an axis of ``n_cells`` image cells.  Matches the reference's tick
    arithmetic (``base.py:506-510``): labels are ``arange(start, stop,
    step)`` and positions advance ``step * cells_per_unit`` cells.
    """
    labels = np.arange(*rng)
    positions = np.arange(0, n_cells, rng[2] * cells_per_unit)
    return positions, labels


def plot_tf(data, sfreq: float = 1000, frange: Floats = None,
            trange: Floats = None, vmin: Optional[float] = None,
            vmax: Optional[float] = None, cmap: str = 'RdBu_r',
            show: bool = True):
    """Time-frequency heatmap, rendered like the reference's
    (``base.py:492-520``): frequency rows bottom-up (inverted image y),
    a slim colorbar hugging the right edge, and ``frange``/``trange`` as
    ``(start, stop, step)`` tick specs — frequency steps in rows-per-Hz
    units derived from the plotted band, time steps in seconds at
    ``sfreq``.
    """
    import matplotlib.pyplot as plt

    data = _host(data)
    n_f, n_t = data.shape
    fig, ax = plt.subplots()
    image = ax.imshow(data, vmin=vmin, vmax=vmax, cmap=cmap, aspect='auto',
                      origin='lower')
    if frange is not None:
        ax.set_yticks(*_tick_spec(n_f, frange,
                                  n_f / (frange[1] - frange[0])))
    if trange is not None:
        ax.set_xticks(*_tick_spec(n_t, trange, sfreq))
    # Slim bar pinned to the image's right edge (the reference uses an
    # axes_grid1 divider for the same 2%-wide geometry).
    fig.colorbar(image, cax=ax.inset_axes((1.01, 0.0, 0.02, 1.0)))
    if show:
        plt.show()
    return ax


def _disc_projection(pos):
    """Azimuthal-equidistant projection of unit-sphere electrode
    positions onto the viewing disc (vertex = +z, the head apex):
    radius = polar angle (radians), so the equator lands on a circle of
    radius pi/2.  Returns (C, 2) plane coordinates."""
    u = _host(pos).astype(np.float64)
    u = u / np.linalg.norm(u, axis=1, keepdims=True)
    theta = np.arccos(np.clip(u[:, 2], -1.0, 1.0))
    rho = np.hypot(u[:, 0], u[:, 1])
    safe = np.where(rho > 1e-12, rho, 1.0)
    return np.stack([theta * u[:, 0] / safe, theta * u[:, 1] / safe],
                    axis=1)


def _topo_grid(values, pos, res: int, stiffness: int = 4,
               n_legendre: int = 50, lam: float = 1e-5):
    """(res, res) spherical-spline interpolation of per-electrode
    ``values`` over the projection disc (NaN outside the head circle),
    plus the disc radius used.  The same Perrin system as
    ``ops.csd.interpolation_matrix``, evaluated at every grid pixel's
    back-projected sphere point."""
    from ..ops.csd import (_bordered_system, _legendre_series,
                           spline_matrices)

    u = _host(pos).astype(np.float64)
    u = u / np.linalg.norm(u, axis=1, keepdims=True)
    vals = _host(values).astype(np.float64)
    c = u.shape[0]
    p2d = _disc_projection(u)
    rad = float(np.max(np.hypot(p2d[:, 0], p2d[:, 1]))) * 1.1 + 1e-9
    g, _ = spline_matrices(u, stiffness, n_legendre)
    sol = np.linalg.solve(_bordered_system(g, lam),
                          np.concatenate([vals, [0.0]]))
    w, d = sol[:c], sol[c]
    xs = np.linspace(-rad, rad, res)
    gx, gy = np.meshgrid(xs, xs)
    r = np.hypot(gx, gy)
    inside = r <= rad
    theta = np.minimum(r, np.pi - 1e-6)
    safe = np.where(r > 1e-12, r, 1.0)
    sx = np.sin(theta) * gx / safe
    sy = np.sin(theta) * gy / safe
    sz = np.cos(theta)
    pts = np.stack([sx.ravel(), sy.ravel(), sz.ravel()], axis=1)
    cosang = np.clip(pts @ u.T, -1.0, 1.0)
    gk = _legendre_series(cosang, stiffness, n_legendre)
    img = (gk @ w + d).reshape(res, res)
    img[~inside] = np.nan
    return img, rad


def plot_topomap(values, pos, ax=None, res: int = 64,
                 cmap: str = 'RdBu_r', vlim=None, sensors: bool = True,
                 contours: int = 6, show: bool = True):
    """Scalp topography of one value per electrode (extension — the
    mne ``plot_topomap`` workflow): spherical-spline interpolation
    (``ops/csd.py``'s Perrin system) over the azimuthal-equidistant
    head disc, head outline + nose, optional sensor dots and contour
    lines.  ``pos`` is (C, 3) electrode coordinates (projected to the
    unit sphere, +z = vertex); ``vlim`` a (vmin, vmax) pair (default
    symmetric about 0).  Returns the matplotlib axes."""
    import matplotlib.pyplot as plt

    vals = _host(values).astype(np.float64)
    img, rad = _topo_grid(vals, pos, res)
    if ax is None:
        _, ax = plt.subplots(figsize=(4, 4))
    if vlim is None:
        m = float(np.nanmax(np.abs(img)))
        vlim = (-m, m)
    ax.imshow(img, origin='lower', extent=(-rad, rad, -rad, rad),
              cmap=cmap, vmin=vlim[0], vmax=vlim[1])
    if contours:
        ax.contour(img, levels=contours, colors='k', linewidths=0.4,
                   extent=(-rad, rad, -rad, rad), origin='lower',
                   alpha=0.5)
    circ = plt.Circle((0, 0), rad, fill=False, color='k', linewidth=1.5)
    ax.add_patch(circ)
    ax.plot([-(0.08 * rad), 0, 0.08 * rad],
            [rad * 0.995, rad * 1.08, rad * 0.995], color='k',
            linewidth=1.5)                                  # nose
    if sensors:
        p2d = _disc_projection(pos)
        ax.scatter(p2d[:, 0], p2d[:, 1], s=4, c='k', zorder=3)
    ax.set_xlim(-1.15 * rad, 1.15 * rad)
    ax.set_ylim(-1.15 * rad, 1.15 * rad)
    ax.set_aspect('equal')
    ax.axis('off')
    if show:
        plt.show()
    return ax


def plot_microstates(maps, pos, stats=None, show: bool = True):
    """One topomap per microstate map (extension — pairs with
    ``RawWavelet.microstates``): ``maps`` is (K, C); subplot titles are
    the canonical A, B, C, ... letters, with coverage percentages when
    a ``stats`` dict (from ``ops.microstates.microstate_stats``) is
    given.  Returns the figure."""
    import matplotlib.pyplot as plt

    maps = _host(maps).astype(np.float64)
    k = maps.shape[0]
    fig, axes = plt.subplots(1, k, figsize=(2.4 * k, 2.6))
    axes = np.atleast_1d(axes)
    for j in range(k):
        plot_topomap(maps[j], pos, ax=axes[j], show=False)
        name = chr(ord('A') + j) if j < 26 else str(j)
        title = name
        if stats is not None:
            title += f"  {100 * float(_host(stats['coverage'])[j]):.0f}%"
        axes[j].set_title(title)
    if show:
        plt.show()
    return fig
