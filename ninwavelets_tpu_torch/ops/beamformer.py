"""Source-space projection from a leadfield, port of
``ninwavelets_tpu.ops.beamformer``: the LCMV beamformer (Van Veen et al.
1997), DICS at one frequency (Gross et al. 2001) on a wavelet
cross-spectral density, source coherence, and the minimum-norm family
(MNE, dSPM, sLORETA).  Any (S, C) fixed-orientation or (S, 3, C)
free-orientation leadfield will do (``ops.leadfield``, mne, FieldTrip).

One regularized (C, C) system is solved for every source at once
(``torch.linalg.solve_ex``, no error check, so the card is not synced);
free orientations take two batched 3 x 3 ``sym_eigh`` per source (the
unit-noise-gain max-power orientation), in float64.  Every float32
product runs in ``fp32_matmul("exact")`` (the JAX package's
``Precision.HIGHEST``).

``wavelet_csd`` returns one complex (F, C, C) tensor, and ``dics`` and
``source_coherence`` take a complex (C, C) CSD where the JAX package takes
its (real, imag) float pair.

A numpy input goes to ``device`` (the card when None); a tensor stays on
its device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import as_float32, resolve_device
from .connectivity import pair_matrix_scan
from .scattering import fp32_matmul, sym_eigh

__all__ = ["LCMVResult", "lcmv", "lcmv_apply",
           "DICSResult", "dics", "wavelet_csd",
           "source_coherence", "MinimumNormResult",
           "minimum_norm", "minimum_norm_apply"]


class LCMVResult(NamedTuple):
    """Fitted beamformer: ``filters`` (S, C) spatial filters (rows apply
    to sensor data), ``power`` (S,) source variance, ``nai`` (S,) neural
    activity index (unit-noise-gain power: localize on THIS),
    ``orientations`` (S, 3) (NaN for a fixed-orientation leadfield, else
    the max-power orientation per source)."""
    filters: torch.Tensor
    power: torch.Tensor
    nai: torch.Tensor
    orientations: torch.Tensor


def _loaded(cov, reg):
    c = cov.shape[0]
    return cov + reg * torch.trace(cov) / c * torch.eye(
        c, dtype=cov.dtype, device=cov.device)


def _solve(a, b):
    with fp32_matmul("exact"):
        return torch.linalg.solve_ex(a, b)[0]


def _lcmv_fixed(cov, lead, reg):
    ci_l = _solve(_loaded(cov, reg), lead.T)             # (C, S)
    denom = torch.clamp(torch.sum(lead * ci_l.T, dim=1), min=1e-30)
    w = ci_l.T / denom[:, None]                          # (S, C)
    power = 1.0 / denom
    noise = torch.sum(w * w, dim=1)
    return w, power, power / torch.clamp(noise, min=1e-30)


def _sym(a):
    return 0.5 * (a + a.transpose(-1, -2))


def _orient(cov, lead3, reg):
    """Unit-noise-gain max-power orientation per source of an (S, 3, C)
    leadfield (Sekihara): the dominant generalized eigenvector of (G, G2),
    ``G = L C^-1 L^T``, ``G2 = L C^-2 L^T``, as the ordinary ``eigh`` of
    ``G2^-1/2 G G2^-1/2``.  Solved in float64: ``G2`` squares the
    covariance's conditioning, and in float32 (the JAX package) an
    orientation errs by up to 0.07 at a covariance condition of 1e9."""
    c = cov.shape[0]
    s = lead3.shape[0]
    cov, lead3 = cov.double(), lead3.double()
    # one (C, S*3) solve: the sensor axis leads before the flatten
    lt = lead3.permute(2, 0, 1).reshape(c, s * 3)
    ci_lt = _solve(_loaded(cov, reg), lt).reshape(c, s, 3).permute(1, 0, 2)
    g = _sym(torch.einsum("sic,sco->sio", lead3, ci_lt))
    g2 = _sym(torch.einsum("sci,sco->sio", ci_lt, ci_lt))
    d2, v2 = sym_eigh(g2)
    d2 = torch.maximum(d2, 1e-12 * d2[..., -1:])
    isq = torch.einsum("sij,sj,skj->sik", v2, 1.0 / torch.sqrt(d2), v2)
    m = _sym(torch.einsum("sij,sjk,skl->sil", isq, g, isq))
    u = torch.einsum("sij,sj->si", isq, sym_eigh(m)[1][..., -1])
    u = u / torch.clamp(torch.linalg.vector_norm(u, dim=-1, keepdim=True),
                        min=1e-30)
    return u.to(torch.float32)


def lcmv(cov, leadfield, reg: float = 0.05,
         noise_cov=None, device=None) -> LCMVResult:
    """LCMV spatial filters from a (C, C) data covariance and an (S, C)
    fixed-orientation or (S, 3, C) free-orientation leadfield (the
    max-power orientation chosen per source).  ``reg`` is the relative
    Tikhonov loading of the diagonal; ``noise_cov`` whitens the NAI
    denominator (``w^T N w`` for ``w^T w``)."""
    cov = as_float32(cov, device)
    lead = as_float32(leadfield, cov.device)
    if cov.ndim != 2 or cov.shape[0] != cov.shape[1]:
        raise ValueError("cov must be (C, C)")
    c = cov.shape[0]
    if lead.ndim == 3:
        if lead.shape[-1] != c or lead.shape[1] != 3:
            raise ValueError("free-orientation leadfield must be "
                             "(S, 3, C) matching cov")
        ori = _orient(cov, lead, float(reg))
        with fp32_matmul("exact"):
            lead_fixed = torch.einsum("so,soc->sc", ori, lead)
    elif lead.ndim == 2:
        if lead.shape[-1] != c:
            raise ValueError("leadfield must be (S, C) matching cov")
        lead_fixed = lead
        ori = torch.full((lead.shape[0], 3), torch.nan, device=cov.device)
    else:
        raise ValueError("leadfield must be (S, C) or (S, 3, C)")
    w, power, nai = _lcmv_fixed(cov, lead_fixed, float(reg))
    if noise_cov is not None:
        ncov = as_float32(noise_cov, cov.device)
        with fp32_matmul("exact"):
            noise = torch.einsum("sc,cd,sd->s", w, ncov, w)
        nai = power / torch.clamp(noise, min=1e-30)
    return LCMVResult(filters=w, power=power, nai=nai, orientations=ori)


def _project(filters, x, what="filters"):
    x = as_float32(x, filters.device)
    if x.shape[-2] != filters.shape[1]:
        raise ValueError(f"channel count does not match the {what}")
    with fp32_matmul("exact"):
        return torch.einsum("sc,...cn->...sn", filters, x)


def lcmv_apply(result: LCMVResult, x) -> torch.Tensor:
    """Project sensor data (..., C, N) to source space (..., S, N) with
    the fitted filters."""
    return _project(result.filters, x)


class DICSResult(NamedTuple):
    """Frequency-domain beamformer at one frequency: ``filters`` (S, C)
    real spatial filters, ``power`` (S,) source cross-spectral power,
    ``nai`` (S,) unit-noise-gain power."""
    filters: torch.Tensor
    power: torch.Tensor
    nai: torch.Tensor


def wavelet_csd(sigs, bank, interpolate: bool = False, time_range=None,
                device=None) -> torch.Tensor:
    """Epoch- and time-averaged wavelet cross-spectral density per bank
    row: (E, C, N) signals and an (F, N) bank -> complex64 (F, C, C), the
    input of :func:`dics` (the sums the connectivity matrices are built
    from, ``connectivity.pair_matrix_scan``)."""
    sigs = as_float32(sigs, device)
    bank = torch.as_tensor(bank, device=sigs.device)
    tr = None if time_range is None else (int(time_range[0]),
                                          int(time_range[1]))
    e_n = sigs.shape[0] * (sigs.shape[-1] if tr is None else tr[1] - tr[0])

    def per_row(sr, si):
        return torch.complex(torch.sum(sr, dim=-1) / e_n,
                             torch.sum(si, dim=-1) / e_n)

    return pair_matrix_scan(sigs, bank, per_row, bool(interpolate),
                            time_range=tr)


def _csd_parts(csd, device):
    """The float32 (real, imag or None) parts of a CSD, on ``device`` when
    given, else where a tensor lies, else the card."""
    if device is None:
        device = (csd.device if isinstance(csd, torch.Tensor)
                  else resolve_device())
    csd = torch.as_tensor(csd, device=device)
    if csd.is_complex():
        return csd.real.to(torch.float32), csd.imag.to(torch.float32)
    return csd.to(torch.float32), None


def dics(csd, leadfield, reg: float = 0.05, device=None) -> DICSResult:
    """DICS spatial filters at ONE frequency from a complex (C, C)
    cross-spectral density (a real one is taken as its real part) and an
    (S, C) fixed-orientation leadfield: ``w_s = Re(S)^-1 l_s / (l_s^T
    Re(S)^-1 l_s)`` (the real-filter variant), source power ``w^T Re(S)
    w``, NAI normalized by ``w^T w``."""
    cr, _ = _csd_parts(csd, device)
    lead = as_float32(leadfield, cr.device)
    if cr.ndim != 2 or cr.shape[0] != cr.shape[1]:
        raise ValueError("csd must be (C, C)")
    if lead.ndim != 2 or lead.shape[-1] != cr.shape[0]:
        raise ValueError("leadfield must be (S, C) matching the csd")
    w, _, _ = _lcmv_fixed(cr, lead, float(reg))
    with fp32_matmul("exact"):
        power = torch.einsum("sc,cd,sd->s", w, cr, w)
    noise = torch.sum(w * w, dim=1)
    return DICSResult(filters=w, power=power,
                      nai=power / torch.clamp(noise, min=1e-30))


def source_coherence(result: DICSResult, csd,
                     eps: float = 1e-12) -> torch.Tensor:
    """(S, S) magnitude-squared coherence between the beamformed sources
    at this frequency: the complex (C, C) sensor CSD projected through
    the DICS filters (``W S W^T``), normalized by the source
    auto-spectra."""
    w = result.filters
    cr, ci = _csd_parts(csd, w.device)
    with fp32_matmul("exact"):
        sr = torch.einsum("ac,cd,bd->ab", w, cr, w)
        num = sr * sr
        if ci is not None:
            si = torch.einsum("ac,cd,bd->ab", w, ci, w)
            num = num + si * si
    p = torch.diagonal(sr)
    den = p[:, None] * p[None, :]
    den = torch.maximum(den, eps * torch.max(den))
    return num / den


class MinimumNormResult(NamedTuple):
    """Linear inverse operator: ``kernel`` (S, C) maps sensor data to
    source estimates; ``method`` names the noise normalization."""
    kernel: torch.Tensor
    method: str


def minimum_norm(leadfield, lam: float = 1.0 / 9.0, noise_cov=None,
                 method: str = "mne", depth: float = 0.0,
                 device=None) -> MinimumNormResult:
    """Minimum-norm inverse of an (S, C) fixed-orientation leadfield:
    ``K = R L^T (L R L^T + lam N)^-1`` (Hamalainen) with depth weighting
    ``R = diag(||l_s||^(-2 depth))``.  ``method``: "mne" (raw currents),
    "dspm" (rows divided by their noise standard deviation) or "sloreta"
    (by ``sqrt(K L R)_ss``: no localization bias for one noiseless
    source).  ``lam`` is mne's ``1 / SNR^2``; ``noise_cov`` defaults to
    the identity."""
    lead = as_float32(leadfield, device)
    if lead.ndim != 2:
        raise ValueError("leadfield must be (S, C) fixed-orientation")
    method = str(method).lower()
    if method not in ("mne", "dspm", "sloreta"):
        raise ValueError("method must be mne / dspm / sloreta")
    s, c = lead.shape
    ncov = (torch.eye(c, device=lead.device) if noise_cov is None
            else as_float32(noise_cov, lead.device))
    if depth:
        r = torch.sum(lead * lead, dim=1) ** (-float(depth))
    else:
        r = torch.ones((s,), device=lead.device)
    rl = lead * r[:, None]                          # rows of R L^T
    with fp32_matmul("exact"):
        gram = torch.einsum("sc,sd->cd", rl, lead)  # L^T R L
        kern = torch.linalg.solve_ex(gram + float(lam) * ncov, rl.T)[0].T
        if method == "dspm":
            var = torch.einsum("sc,cd,sd->s", kern, ncov, kern)
            kern = kern / torch.sqrt(torch.clamp(var, min=1e-30))[:, None]
        elif method == "sloreta":
            res = torch.einsum("sc,sc,s->s", kern, lead, r)
            kern = kern / torch.sqrt(torch.clamp(res, min=1e-30))[:, None]
    return MinimumNormResult(kernel=kern, method=method)


def minimum_norm_apply(result: MinimumNormResult, x) -> torch.Tensor:
    """Project sensor data (..., C, N) to (..., S, N) source estimates
    with the fitted inverse kernel."""
    return _project(result.kernel, x, "kernel")
