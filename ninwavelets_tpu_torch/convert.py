"""Carry a wavelet, its bank and fitted results across from the JAX package.

A wavelet's "weights" are its hyper-parameters and its (F, N) bank; a fitted
HMM, a matching-pursuit decomposition, an ICA, ASR, spatial-filter or TRF
model, a rejection search, an ERP peak, an event table, a microstate fit
and a beamformer or minimum-norm inverse are tuples of arrays; a pipeline
configuration is a frozen dataclass of plain values.  All are
read here as plain Python and numpy values, so this module imports neither
``jax`` nor ``ninwavelets_tpu``: hand it the JAX object or arrays, or anything
with the same attributes.

Placement follows the port's rule (``device.resolve_device``): ``device=``
wins; with no device the result goes to the CUDA card, and the call raises
when CUDA is absent.  Pass ``device="cpu"`` for the CPU.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import config as _config
from .device import resolve_device
from .models import zoo
from .ops.asr import ASRModel
from .ops.beamformer import DICSResult, LCMVResult, MinimumNormResult
from .ops.erp import PeakResult
from .ops.bank import WaveletMode
from .ops.hmm import HMMResult
from .ops.ica import ICAResult
from .ops.microstates import MicrostateResult
from .ops.mp import MPResult
from .ops.reject import RejectResult
from .ops.sleep import EventTable
from .ops.spatial import SpatialResult
from .ops.trf import TRFResult

_CLASSES = {cls.__name__: cls for cls in
            (zoo.Morse, zoo.MorseMNE, zoo.Morlet, zoo.MexicanHat,
             zoo.Shannon, zoo.Haar, zoo.Paul, zoo.DOG, zoo.Bump)}
# The shape parameters a class takes: Morse's b and r, Morlet's sigma and
# gabor, MexicanHat's, Shannon's and Bump's sigma, Paul's and DOG's order m.
_PARAMS = ("b", "r", "sigma", "gabor", "m")
# The families of banks (not a WaveletBase: no mode, no real_wave_length)
# and the parameters each takes besides sfreq and interpolate.
_FAMILIES = {"Superlet": (zoo.Superlet, ("sigma", "order_min", "order_max",
                                          "adaptive")),
             "MorseMultitaper": (zoo.MorseMultitaper, ("b", "r",
                                                       "n_tapers"))}


def wavelet_from_jax(w, device=None):
    """The port's wavelet of the same class as ``w`` (a JAX-package wavelet),
    with the same ``sfreq``, ``b``, ``r``, ``sigma``, ``gabor``, ``m``,
    ``real_wave_length``, ``interpolate`` and ``mode``, on ``device`` (the
    card when None).  The families of banks carry theirs: a ``Superlet``
    its ``sigma``, ``order_min``, ``order_max`` and ``adaptive``, a
    ``MorseMultitaper`` its ``b``, ``r`` and ``n_tapers`` (with ``sfreq``
    and ``interpolate``).  Any other class raises ``TypeError``."""
    name = type(w).__name__
    if name in _FAMILIES:
        cls, params = _FAMILIES[name]
        return cls(sfreq=float(w.sfreq), interpolate=bool(w.interpolate),
                   device=resolve_device(device),
                   **{k: getattr(w, k) for k in params})
    if name not in _CLASSES:
        raise TypeError(f"no port of wavelet class {name!r}; one of "
                        f"{sorted(set(_CLASSES) | set(_FAMILIES))}")
    kwargs = {k: getattr(w, k) for k in _PARAMS if hasattr(w, k)}
    out = _CLASSES[name](sfreq=float(w.sfreq),
                         real_wave_length=float(w.real_wave_length),
                         interpolate=bool(w.interpolate),
                         device=resolve_device(device),
                         **kwargs)
    out.mode = WaveletMode[w.mode.name]
    return out


def bank_from_jax(bank_r, bank_i=None, device=None) -> torch.Tensor:
    """The JAX float-pair bank (real part, imaginary part or None) as the
    port's (F, N) bank: float32 when real, complex64 otherwise, on
    ``device`` (the card when None)."""
    device = resolve_device(device)
    real = np.asarray(bank_r, dtype=np.float32)
    if bank_i is None:
        return torch.from_numpy(real.copy()).to(device)
    bank = real + 1j * np.asarray(bank_i, dtype=np.float32)
    return torch.from_numpy(bank.astype(np.complex64)).to(device)


def _result_from_jax(cls, res, device):
    device = resolve_device(device)
    return cls(*(torch.from_numpy(np.array(getattr(res, f))).to(device)
                 for f in cls._fields))


def hmm_result_from_jax(res, device=None) -> HMMResult:
    """The port's ``ops.hmm.HMMResult`` with the fields of a JAX-package
    ``HMMResult`` (or anything with the same attributes) as tensors on
    ``device`` (the card when None): a fitted model for ``ops.viterbi``."""
    return _result_from_jax(HMMResult, res, device)


def mp_result_from_jax(res, device=None) -> MPResult:
    """The port's ``ops.mp.MPResult`` with the fields of a JAX-package
    ``MPResult`` as tensors on ``device`` (the card when None): atoms for
    ``ops.mp_tfr``."""
    return _result_from_jax(MPResult, res, device)


def ica_result_from_jax(res, device=None) -> ICAResult:
    """The port's ``ops.ica.ICAResult`` of a JAX-package FastICA fit, on
    ``device`` (the card when None): a model for ``ica_remove`` /
    ``ica_transform``."""
    return _result_from_jax(ICAResult, res, device)


def asr_model_from_jax(model, device=None) -> ASRModel:
    """The port's ``ops.asr.ASRModel`` of a JAX-package calibration, on
    ``device`` (the card when None): a model for ``asr_process``."""
    return _result_from_jax(ASRModel, model, device)


def spatial_result_from_jax(res, device=None) -> SpatialResult:
    """The port's ``ops.spatial.SpatialResult`` (filters, patterns,
    eigenvalues) of a JAX-package GED / CSP / SSD fit, on ``device`` (the
    card when None): filters for ``spatial_apply``."""
    return _result_from_jax(SpatialResult, res, device)


def trf_result_from_jax(res, device=None) -> TRFResult:
    """The port's ``ops.trf.TRFResult`` of a JAX-package TRF fit: the
    weights as a tensor on ``device`` (the card when None), the lags as
    host numpy and the ridge as a float, as both packages keep them."""
    weights = torch.from_numpy(np.array(res.weights, np.float32)).to(
        resolve_device(device))
    return TRFResult(weights=weights, lags=np.asarray(res.lags),
                     lam=float(res.lam))


def reject_result_from_jax(res, device=None) -> RejectResult:
    """The port's ``ops.reject.RejectResult`` of a JAX-package threshold
    search: the threshold as a float, the drop mask, grid and errors as
    tensors on ``device`` (the card when None)."""
    device = resolve_device(device)
    return RejectResult(
        threshold=float(res.threshold),
        drop_mask=torch.from_numpy(np.array(res.drop_mask, bool)).to(device),
        thresholds=torch.from_numpy(np.array(res.thresholds)).to(device),
        cv_error=torch.from_numpy(np.array(res.cv_error)).to(device))


def peak_result_from_jax(res, device=None) -> PeakResult:
    """The port's ``ops.erp.PeakResult`` of a JAX-package peak measure, on
    ``device`` (the card when None)."""
    return _result_from_jax(PeakResult, res, device)


def event_table_from_jax(tab, device=None) -> EventTable:
    """The port's ``ops.sleep.EventTable`` of a JAX-package spindle or
    slow-oscillation table, on ``device`` (the card when None)."""
    return _result_from_jax(EventTable, tab, device)


def microstate_result_from_jax(res, device=None) -> MicrostateResult:
    """The port's ``ops.microstates.MicrostateResult`` of a JAX-package
    fit, on ``device`` (the card when None): maps for
    ``microstate_backfit``, labels for ``microstate_stats``."""
    return _result_from_jax(MicrostateResult, res, device)


def lcmv_result_from_jax(res, device=None) -> LCMVResult:
    """The port's ``ops.beamformer.LCMVResult`` of a JAX-package LCMV fit,
    on ``device`` (the card when None): filters for ``lcmv_apply``."""
    return _result_from_jax(LCMVResult, res, device)


def dics_result_from_jax(res, device=None) -> DICSResult:
    """The port's ``ops.beamformer.DICSResult`` of a JAX-package DICS fit,
    on ``device`` (the card when None): filters for
    ``source_coherence``."""
    return _result_from_jax(DICSResult, res, device)


def minimum_norm_result_from_jax(res, device=None) -> MinimumNormResult:
    """The port's ``ops.beamformer.MinimumNormResult`` of a JAX-package
    inverse: the kernel as a tensor on ``device`` (the card when None),
    the method name as a string."""
    kernel = torch.from_numpy(np.array(res.kernel, np.float32)).to(
        resolve_device(device))
    return MinimumNormResult(kernel=kernel, method=str(res.method))


def _config_from_jax(cls, cfg, nested=None):
    """``cls`` with each of its fields read off ``cfg``; ``nested`` maps a
    field to the converter of its value."""
    nested = nested or {}
    return cls(**{f.name: nested.get(f.name, lambda v: v)(
        getattr(cfg, f.name)) for f in dataclasses.fields(cls)})


def _wavelet_config_from_jax(w):
    name = type(w).__name__
    if name not in ("MorseConfig", "MorletConfig"):
        raise TypeError(f"no port of wavelet config {name!r}; one of "
                        "['MorletConfig', 'MorseConfig']")
    return _config_from_jax(getattr(_config, name), w)


def pipeline_config_from_jax(cfg) -> "_config.PipelineConfig":
    """The port's ``config.PipelineConfig`` of a JAX-package one, field by
    field: its wavelet config (``MorseConfig`` or ``MorletConfig``) and
    ``EngineConfig`` carried the same way.  Any other wavelet config class
    raises ``TypeError``."""
    return _config_from_jax(
        _config.PipelineConfig, cfg,
        {"wavelet": _wavelet_config_from_jax,
         "engine": lambda e: _config_from_jax(_config.EngineConfig, e)})
