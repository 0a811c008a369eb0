"""Artifact subspace reconstruction (ASR; Mullen et al. 2015, the
EEGLAB ``clean_rawdata`` method), port of ``ninwavelets_tpu.ops.asr``.

Calibration is one covariance, one ``eigh`` and robust (median / MAD)
window-RMS moments per principal direction.  Processing takes every
50%-overlapped Hann window at once: (W, C, C) window covariances, one
batched ``eigh``, the keep test ``d_j <= sum_i th_i^2 (v_cal_i .
v_w_j)^2``, and the reconstruction ``R = M pinv_keep(V_w^T M) V_w^T`` by a
masked batched solve (rejected rows zeroed, their diagonal padded with
1s).  Every product runs inside ``fp32_matmul("exact")``.

The overlap-add is deterministic: the windows are split into
``ceil(win / hop)`` groups in which no two windows overlap, and the groups
are added in turn, each as one strided slice add (no scatter, no float
atomics), so the card gives the same output on every run.  With the even
windows here every output sample sums two windows, and a sum of two terms
does not depend on their order: the result equals the JAX package's
scatter-add.

A numpy input goes to ``device`` (the card when None); a tensor stays on
its device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import as_float32
from .denoise import _median
from .scattering import fp32_matmul, sym_eigh

__all__ = ["ASRModel", "asr_calibrate", "asr_process"]


class ASRModel(NamedTuple):
    """Calibration state: ``mixing`` (C, C) = sqrtm of the calibration
    covariance, ``v_cal`` (C, C) its eigenvectors (columns), and
    ``thresholds`` (C,) the per-direction RMS limits (mu + cutoff * sigma
    of the calibration window RMS, robust moments)."""
    mixing: torch.Tensor
    v_cal: torch.Tensor
    thresholds: torch.Tensor


def _window(win_s: float, sfreq: float) -> int:
    return max(4, int(round(win_s * sfreq)) & ~1)      # even


def _frames(x, win: int, hop: int):
    """(C, N) -> (W, C, win) sliding frames (the ragged tail dropped)."""
    return x.unfold(-1, win, hop).transpose(0, 1)


def _calibrate_jit(x, *, win, hop, cutoff):
    c, n = x.shape
    x = x - x.mean(-1, keepdim=True)
    with fp32_matmul("exact"):
        cov = (x @ x.T) / n
        d, v = sym_eigh(cov)                  # ascending
        d = torch.maximum(d, 1e-12 * d[-1])
        mixing = (v * torch.sqrt(d)[None, :]) @ v.T    # sqrtm
        fr = _frames(x, win, hop)                      # (W, C, win)
        proj = v.T @ fr
    rms = torch.sqrt((proj * proj).mean(-1))           # (W, C)
    mu = _median(rms.T)
    sigma = 1.4826 * _median((rms - mu[None, :]).abs().T)
    return ASRModel(mixing=mixing, v_cal=v, thresholds=mu + cutoff * sigma)


def asr_calibrate(x_cal, sfreq: float, cutoff: float = 5.0,
                  win_s: float = 0.5, device=None) -> ASRModel:
    """Fit the ASR model on (C, N) CALIBRATION data (a clean stretch; see
    ``RawWavelet.asr_clean`` for automatic selection).  ``cutoff`` is the
    standard deviations above calibration (EEGLAB's default 5); ``win_s``
    the RMS window."""
    x_cal = as_float32(x_cal, device)
    if x_cal.ndim != 2:
        raise ValueError("x_cal must be (C, N)")
    win = _window(win_s, sfreq)
    if x_cal.shape[-1] < 4 * win:
        raise ValueError("calibration needs at least 4 windows")
    return _calibrate_jit(x_cal, win=win, hop=win // 2,
                          cutoff=float(cutoff))


def _overlap_add(fr, hop: int, length: int):
    """Sum (W, C, win) frames placed at ``hop * w`` into (C, length), group
    by group: the windows ``g, g + G, g + 2G, ...`` (G = ceil(win / hop))
    never overlap, so each group is one slice add."""
    w, c, win = fr.shape
    groups = -(-win // hop)
    stride = hop * groups
    out = fr.new_zeros((c, length + stride + win))
    for g in range(groups):
        part = fr[g::groups]                           # (Wg, C, win)
        if part.shape[0] == 0:
            continue
        if stride > win:
            part = torch.nn.functional.pad(part, (0, stride - win))
        flat = part.permute(1, 0, 2).reshape(c, -1)    # (C, Wg * stride)
        start = hop * g
        out[:, start:start + flat.shape[1]] += flat
    return out[:, :length]


def _process_jit(x, mixing, v_cal, thresholds, *, win):
    c, n = x.shape
    # centered per channel GLOBALLY (the calibration statistics are of
    # centered data), the offsets restored on the output
    ch_mean = x.mean(-1, keepdim=True)
    x = x - ch_mean
    hop = win // 2
    # padded so every sample is covered by exactly two Hann windows
    xp = torch.nn.functional.pad(x, (hop, win))
    np_ = xp.shape[-1]
    fr = _frames(xp, win, hop)                         # (W, C, win)
    hann = 0.5 - 0.5 * torch.cos(
        2.0 * torch.pi * (torch.arange(win, device=x.device,
                                       dtype=torch.float32) + 0.5) / win)
    frw = fr * hann[None, None, :]
    eye = torch.eye(c, dtype=torch.float32, device=x.device)
    with fp32_matmul("exact"):
        cov = (frw @ frw.transpose(1, 2)) / (hann * hann).sum()
        dw, vw = sym_eigh(cov)                # (W, C), (W, C, C)
        # thresholds projected onto the window's eigendirections
        proj = v_cal.T @ vw                            # (W, Ccal, j)
        limit = ((thresholds ** 2)[None, :, None] * proj * proj).sum(1)
        keep = dw <= limit                             # (W, C)
        # masked reconstruction R = M pinv_keep(Vw^T M) Vw^T
        a = vw.transpose(1, 2) @ mixing                # (W, C, C)
        ak = torch.where(keep[..., None], a, 0.0)
        b = ak @ ak.transpose(1, 2)
        b = b + torch.where(keep, 0.0, 1.0)[..., None] * eye
        pinv = torch.linalg.solve_ex(b, ak)[0].transpose(1, 2)
        r = (mixing @ pinv) @ vw.transpose(1, 2)
        clean_fr = r @ fr
    # all-kept windows pass through untouched
    allkeep = keep.all(-1)
    clean_fr = torch.where(allkeep[:, None, None], fr, clean_fr)
    acc = _overlap_add(clean_fr * hann[None, None, :], hop, np_)
    wsum = _overlap_add(hann.expand(fr.shape[0], 1, win), hop, np_)
    out = acc / wsum.clamp(min=1e-12)
    return out[:, hop:hop + n] + ch_mean, keep


def asr_process(x, sfreq: float, model: ASRModel, win_s: float = 0.5,
                device=None):
    """Clean a (C, N) recording with a fitted :class:`ASRModel`.  Returns
    ``(cleaned (C, N), keep (W, C))``: ``keep`` flags which principal
    components of each window survived (all-True windows pass through
    bit-exactly).  A numpy ``x`` goes to the model's device unless
    ``device`` says otherwise."""
    x = as_float32(x, device if device is not None
                   else model.mixing.device)
    if x.ndim != 2:
        raise ValueError("x must be (C, N)")
    if x.shape[0] != model.mixing.shape[0]:
        raise ValueError("channel count does not match the model")
    return _process_jit(x, model.mixing, model.v_cal, model.thresholds,
                        win=_window(win_s, sfreq))
