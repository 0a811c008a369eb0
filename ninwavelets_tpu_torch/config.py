"""Dataclass configs and the one-call analysis pipeline (port of
``ninwavelets_tpu.config``).

The four frozen dataclasses keep the JAX package's names, fields and
defaults: the wavelet's constructor keywords (``sfreq=1000, b=17.5, r=3,
sigma=7, interpolate=False``), the engine knobs and the optional stages of
``run_pipeline``.  ``EngineConfig.precision`` names one of the fused
kernels' precisions (``ops.fused.PRECISIONS``); ``use_fused`` lets the
epoch reductions take the kernel where it fits.  ``mesh_shape``,
``streaming_window`` and ``halo_tol`` are carried but unused by
``run_pipeline``, as in the JAX package.

``run_pipeline(cfg, epochs)`` runs the stages of the JAX package's one in
the same order, on the port's counterparts: on the card the epoch-mean
power and ITC take one K2 "power_itc" launch, synchrosqueezing K5a and K5b,
the superlet orders and the cluster stage's single-trial planes K4.  Each
stage's wall-clock time, the device synchronized before its clock stops,
is logged at DEBUG level to the ``"ninwavelets_tpu_torch"`` logger
(``utils.observability``); with DEBUG off nothing is timed or synchronized.
"""
from __future__ import annotations

import contextlib
import logging
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class MorseConfig:
    """Generalized Morse parameters (the reference's defaults)."""
    sfreq: float = 1000.0
    b: float = 17.5          # beta
    r: float = 3.0           # gamma
    real_wave_length: float = 1.0
    interpolate: bool = False

    def build(self, device=None):
        """The ``Morse`` wavelet, on ``device`` (the card when None)."""
        from .models import Morse
        return Morse(self.sfreq, self.b, self.r, self.real_wave_length,
                     self.interpolate, device=device)


@dataclass(frozen=True)
class MorletConfig:
    """Morlet/Gabor parameters (the reference's defaults)."""
    sfreq: float = 1000.0
    sigma: float = 7.0
    real_wave_length: float = 1.0
    gabor: bool = False
    interpolate: bool = False

    def build(self, device=None):
        """The ``Morlet`` wavelet, on ``device`` (the card when None)."""
        from .models import Morlet
        return Morlet(self.sfreq, self.sigma, self.real_wave_length,
                      self.gabor, self.interpolate, device=device)


@dataclass(frozen=True)
class EngineConfig:
    """Engine knobs (no reference counterpart).  ``mesh_shape``,
    ``streaming_window`` and ``halo_tol`` are unused by ``run_pipeline``."""
    precision: str = "fast3"       # fused-kernel precision name
    use_fused: bool = True         # allow the fused kernel where it fits
    mesh_shape: Tuple[int, int, int] = (1, 1, 1)   # (data, freq, time)
    streaming_window: int = 65536  # StreamingCWT window, samples
    halo_tol: float = 1e-4         # halo sizing envelope tolerance


@dataclass(frozen=True)
class PipelineConfig:
    """A full analysis pipeline: wavelet + engine + baseline window, plus
    the optional statistics stages (``ops.tc_stats`` / ``ops.ridge``)."""
    wavelet: MorseConfig = field(default_factory=MorseConfig)
    engine: EngineConfig = field(default_factory=EngineConfig)
    freqs: Tuple[float, float, float] = (1.0, 101.0, 1.0)  # (lo, hi, step) Hz
    baseline: Optional[Tuple[float, float]] = None   # (start_s, stop_s)
    baseline_method: str = "zscore"
    significance: Optional[float] = None   # p-level (e.g. 0.95) -> mask
    global_spectrum: bool = False          # COI-masked time average
    ridge: bool = False                    # per-channel DP ridge (Hz)
    ssq: bool = False                      # epoch-mean synchrosqueezed power
    superlet: Optional[Tuple[int, int]] = None  # (order_min, order_max)
    superlet_sigma: float = 3.0            # base cycle parameter
    connectivity: Optional[str] = None     # None or any subset (comma-sep)
    # of {"plv", "coherence", "wpli", "pli", "dwpli", "ppc", "pcoh",
    # "psi"}; "both" is kept as an alias for "plv,coherence"
    connectivity_window: Optional[Tuple[float, float]] = None  # (start_s, stop_s)
    specparam: bool = False         # FOOOF-style fit of each channel's
    # COI-masked global spectrum (requires ``global_spectrum``)
    specparam_peaks: int = 4
    cluster_test: bool = False      # one-sample cluster permutation test of
    # the baseline-corrected single-trial power against zero (needs
    # ``baseline``); spatio-spectral when ``cluster_adjacency`` is set
    cluster_adjacency: Optional[tuple] = None  # (M, 2) channel edges
    cluster_n_perm: int = 999


class _StageTimer:
    """One stage's wall clock, the device synchronized before it stops,
    logged by ``utils.observability.Timer`` as ``run_pipeline <stage>``."""

    def __init__(self, name: str, device: torch.device) -> None:
        from .utils.observability import Timer
        self._timer = Timer(f"run_pipeline {name}")
        self._device = device

    def __enter__(self):
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        self._timer.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        self._timer.__exit__(*exc)


def run_pipeline(cfg: PipelineConfig, epochs, device=None) -> dict:
    """Execute a configured analysis pipeline over an MNE-style epochs
    container: build the wavelet (on ``device``, the card when None),
    compute the all-channel epoch-mean power TFR and ITC at ``cfg.freqs``
    (one fused kernel pass for both where ``cfg.engine.use_fused`` and the
    kernel takes the workload, the plain path otherwise) and optionally
    baseline-correct the power.

    Returns a dict with ``power`` (C, F, N) and ``itc`` (C, F, N) tensors on
    the device plus the frequency grid (numpy) and the wavelet instance.
    Optional stages add: ``significant`` ((C, F, N) bool mask of the
    UNCORRECTED epoch-mean power against each channel's AR(1) background,
    chi-square 2E DOF), ``global_spectrum`` ((C, F), COI-masked time
    average) with ``coi`` ((F, N) bool numpy), ``ridge_hz`` ((C, N) numpy
    dominant-ridge track), ``ssq_power``, ``superlet_power``, the
    connectivity matrices, ``specparam`` and ``cluster``.
    """
    from .ops.baseline import baseline_tf
    from .ops.cwt import power_itc_from_bank
    from .ops.fused import power_itc_auto
    from .utils.mne_adapter import EpochsWavelet
    from .utils.observability import log

    wavelet = cfg.wavelet.build(device)
    ew = EpochsWavelet(epochs, wavelet)       # sets wavelet.sfreq
    sfreq = wavelet.sfreq
    freqs = np.arange(*cfg.freqs)
    waves = ew._all_data()
    bank = ew._bank_for(waves, freqs)
    interp = wavelet.interpolate
    timing = log.isEnabledFor(logging.DEBUG)

    def stage(name):
        return (_StageTimer(name, waves.device) if timing
                else contextlib.nullcontext())

    with stage("power_itc"):
        if cfg.engine.use_fused:
            # One kernel pass for BOTH epoch reductions.
            power, itc = power_itc_auto(waves, bank, interpolate=interp,
                                        precision=cfg.engine.precision)
        else:
            power, itc = power_itc_from_bank(waves, bank, interp)
    out = {"itc": itc, "freqs": freqs, "wavelet": wavelet}
    # The T&C background takes the bank's real part, as the JAX package's
    # float-pair ``bank_r`` is.
    bank_r = bank.real if bank.is_complex() else bank

    if cfg.significance is not None:
        # Per-channel AR(1) fit on the raw epochs; the epoch-mean power is
        # chi-square with 2E DOF against the bank-aware background.
        from .ops import tc_stats
        with stage("significance"):
            # AR(1) fitting is host numpy: the adapter's host snapshot.
            host = ew._host_data()                        # (E, C, N)
            e_count = host.shape[0]
            masks = []
            for ch in range(host.shape[1]):
                x = host[:, ch, :]
                alpha = float(np.mean([tc_stats.ar1_coefficient(row)
                                       for row in x]))
                var = float(np.mean(np.var(x, axis=-1)))
                masks.append(tc_stats.significant_mask(
                    power[ch], bank_r, sfreq, alpha, var,
                    p=float(cfg.significance), n_epochs=e_count))
            out["significant"] = torch.stack(masks)

    if cfg.ssq:
        # Epoch-mean synchrosqueezed power; reuses the bank already built
        # (real banks only: phase needed).
        if bank.is_complex():
            raise ValueError(
                "ssq needs an analytic (real-bank) wavelet family — "
                "Normal/Twice-mode banks carry no usable phase")
        from .ops.sst import ssq_mean_power
        with stage("ssq"):
            out["ssq_power"] = ssq_mean_power(waves, bank, freqs, sfreq,
                                              interpolate=interp)

    if cfg.superlet is not None:
        # Fractional adaptive superlet power (its own growing-cycle Morlet
        # member banks, independent of the pipeline wavelet's bank).
        from .ops.superlets import superlet_mean_power
        o_min, o_max = cfg.superlet
        with stage("superlet"):
            out["superlet_power"] = superlet_mean_power(
                waves, freqs, sfreq, base_sigma=cfg.superlet_sigma,
                order_min=int(o_min), order_max=int(o_max),
                interpolate=interp)

    if cfg.connectivity is not None:
        # All-pairs (F, C, C) matrices over every channel; reuses the bank
        # already built for the TFR.
        from .ops.connectivity import (coherence_matrix, partial_coherence,
                                       plv_matrix, ppc_matrix, psi_matrix,
                                       wpli_matrix)
        known = ("plv", "coherence", "wpli", "pli", "dwpli", "ppc",
                 "pcoh", "psi")
        asked = ("plv", "coherence") if cfg.connectivity == "both" else \
            tuple(m.strip() for m in cfg.connectivity.split(","))
        bad = [m for m in asked if m not in known]
        if bad:
            raise ValueError(
                f"connectivity must be 'both' or a comma-separated subset "
                f"of {known}, got {cfg.connectivity!r}")
        trange = None
        if cfg.connectivity_window is not None:
            start_s, stop_s = cfg.connectivity_window
            trange = (int(round(start_s * sfreq)),
                      int(round(stop_s * sfreq)))
        if bank.is_complex() and set(asked) - {"coherence"}:
            raise ValueError(
                "phase connectivity needs an analytic (real-bank) wavelet "
                "family — Normal/Twice-mode banks carry no usable phase")
        with stage("connectivity"):
            if "plv" in asked:
                out["plv_matrix"] = plv_matrix(
                    waves, bank, interpolate=interp, time_range=trange)
            if "coherence" in asked:
                out["coherence_matrix"] = coherence_matrix(
                    waves, bank, interpolate=interp, time_range=trange)
            for m in ("pli", "wpli", "dwpli"):
                if m in asked:
                    out[f"{m}_matrix"] = wpli_matrix(
                        waves, bank, method=m, interpolate=interp,
                        time_range=trange)
            if "ppc" in asked:
                out["ppc_matrix"] = ppc_matrix(
                    waves, bank, interpolate=interp, time_range=trange)
            if "pcoh" in asked:
                out["partial_coherence"] = partial_coherence(
                    waves, bank, interpolate=interp, time_range=trange)
            if "psi" in asked:
                # directed (C, C) phase-slope index: adjacent bank rows
                # form the slope, so the grid must ascend (a descending
                # grid would negate every direction estimate).
                if len(freqs) < 2 or freqs[1] <= freqs[0]:
                    raise ValueError(
                        "connectivity='psi' needs an ascending cfg.freqs "
                        f"grid with >= 2 rows, got {cfg.freqs}")
                out["psi_matrix"] = psi_matrix(
                    waves, bank, interpolate=interp, time_range=trange)

    if cfg.global_spectrum or cfg.ridge:
        from .ops import tc_stats
        if cfg.global_spectrum:
            with stage("global_spectrum"):
                tau = tc_stats.efolding_times(wavelet._wdef(), freqs, sfreq)
                coi = tc_stats.coi_mask(power.shape[-1], sfreq, tau)
                out["coi"] = coi
                out["global_spectrum"] = tc_stats.global_spectrum(power,
                                                                  coi)
        if cfg.ridge:
            from .ops.ridge import ridge_frequencies
            with stage("ridge"):
                # power[ch] stays on the device; only the (N,) track
                # comes to the host.
                out["ridge_hz"] = np.stack([
                    ridge_frequencies(power[ch], freqs)
                    for ch in range(power.shape[0])])

    if cfg.specparam:
        # Aperiodic + peaks parametrization of the global wavelet spectrum.
        if not cfg.global_spectrum:
            raise ValueError("specparam needs global_spectrum=True "
                             "(it fits the COI-masked global spectrum)")
        from .ops.specparam import specparam as _specfit
        with stage("specparam"):
            out["specparam"] = _specfit(
                out["global_spectrum"], freqs,
                max_peaks=int(cfg.specparam_peaks))

    if cfg.cluster_test:
        # One-sample sign-flip cluster test of the baseline-corrected
        # single-trial power against zero, across ALL channels
        # (spatio-spectral with ``cluster_adjacency`` edges; an empty
        # adjacency still corrects the FWER over every channel).  The
        # planes are ``ops.fused.power_auto``'s (K4 on the card), the
        # function the JAX package computes with XLA's ``ops.cwt.power``.
        if cfg.baseline is None:
            raise ValueError(
                "cluster_test needs baseline=(start, stop) so zero is the "
                "null hypothesis for the single-trial planes")
        from .ops import cluster as _cluster
        from .ops.fused import power_auto
        with stage("cluster"):
            trials = power_auto(waves, bank, interpolate=interp)
            trials = baseline_tf(trials, sfreq, cfg.baseline[0],
                                 cfg.baseline[1], cfg.baseline_method)
            adj = EpochsWavelet._as_edges(
                () if cfg.cluster_adjacency is None
                else cfg.cluster_adjacency)
            out["cluster"] = _cluster.cluster_test_one_sample(
                trials, n_perm=int(cfg.cluster_n_perm), adjacency=adj)
            del trials

    if cfg.baseline is not None:
        start, stop = cfg.baseline
        with stage("baseline"):
            power = baseline_tf(power, sfreq, start, stop,
                                cfg.baseline_method)
    out["power"] = power
    return out
