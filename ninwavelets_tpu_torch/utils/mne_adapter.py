"""MNE ingestion (port of the core of ``ninwavelets_tpu.utils.mne_adapter``):
``EpochsWavelet`` and ``ArrayEpochs`` for epoched data, ``RawWavelet`` for
continuous recordings.

For epochs the whole (epochs, channels, time) block moves to the wavelet's
device once, from the float32 host snapshot (``_snapshot``: pinned for a
card, so the copy is asynchronous); the epoch reductions run through ``ops.fused`` (the CUDA kernel
on the card, the plain path on the CPU), for real banks and for the complex
banks of the Normal-mode families (MexicanHat, Haar).  The power variants
(``superlet_power``, ``multitaper_power``, ``induced_power``,
``evoked_power``, ``single_trial_power(_all)``) ride the same kernels
through ``mean_power_auto`` and ``power_auto``.  The pair connectivity methods
(``plv``, ``coherence``, ``phase_lag`` ...) hand one channel pair to the
``*_auto`` entry points as (E, N) signals, which run the plain sums, as in
the JAX package; the all-pairs ``*_matrix`` methods stream the bank rows
through plain FFTs and batched matrix products.  The rest of connectivity
(``partial_coherence``, ``psi_matrix``, ``kuramoto_order``, ``nm_plv``,
``plv_significance``, ``pac``, ``erpac``, ``bicoherence``, ``cfd``,
``lagged_coherence``, ``env_corr`` ...) is plain torch as well;
``wavelet_entropy`` takes its power through ``power``, the kernel on the
card.  ``granger`` (spectral Granger causality, pairwise or conditional,
``ops.granger``) and ``network`` (graph measures of a ``*_matrix``,
``ops.graph``) are plain torch too.  The statistics
(``cluster_test``, ``cluster_test_all``, ``cluster_regression``,
``cluster_f``, ``bursts``; ``ops.cluster``, ``ops.bursts``) test and
summarize the single-trial planes of ``single_trial_power(_all)``, which
run K4 on the card; the tests themselves are plain torch.  ``subset`` and
``split`` carve trial groups, carrying the event codes.
``RawWavelet.coherence`` is the single-trial smoothed wavelet coherence of
two channels of a recording.  The other transforms are plain torch:
``EpochsWavelet.tfr_power2d`` (the directional 2-D CWT of the epoch-mean
plane that ``power`` makes with the kernel), ``modwt_var`` and
``modwt_denoise`` (a new adapter over the cleaned trials, whose reductions
run the kernels); ``RawWavelet.filter``, ``resample``, ``modwt_denoise``
and ``modwt_var``, which return host numpy, as the JAX package's do.  A continuous recording streams through ``parallel.StreamingCWT`` in
overlap-discard windows; ``RawWavelet.epochs`` cuts event-locked windows
out of it into an ``EpochsWavelet``, whose epoch reductions then run the
kernels (``epoch_power``, ``itc``).  The decompositions are plain torch
on top of the planes: ``EpochsWavelet.specparam`` (the time mean of
``power``, K1 on the card), ``cp_power`` (``power_all`` for "cfn", K1;
``single_trial_power(_all)`` for "efn" / "ecfn", K4), ``cycles``,
``matching_pursuit`` and ``psd``; ``RawWavelet.states`` and ``specparam``
(``power``, K4 where the extended window is at most 32768), ``irasa`` and
``psd``.  ``psd``, ``_welch_of`` and the ``SpectralFit`` of ``specparam``
are host numpy, as in the JAX package.  Sensor-space preprocessing and
decoding is plain torch on the wavelet's device: ``EpochsWavelet.decode``
and ``decode_generalization`` (the planes of ``single_trial_power_all``,
K4 on the card), ``ssvep``, ``riemann_decode``, ``csp``, ``csp_decode``,
``ged``, ``ssd``, and the new adapters of ``regress_out``, ``drop_bad``
(with ``.reject_result``), ``csd``, ``interpolate_bads`` and
``spatial_epochs`` (whose reductions run the kernels); ``RawWavelet``'s
``find_bad_channels``, ``interpolate_bads``, ``ica``, ``ica_clean``,
``ica_find_bads``, ``trf`` and ``asr_clean`` (host numpy recordings, as in
the JAX package).  The last slice is plain torch on the wavelet's device
too: ``EpochsWavelet.evoked``, ``erp_peak``, ``erp_onset`` (``ops.erp``),
``sample_entropy``, ``permutation_entropy``, ``multiscale_entropy``
(``ops.complexity``) and ``fit_dipole`` (``ops.leadfield``); and
``RawWavelet.dfa`` (the envelope of ``power_channel``, K4 on the card),
``spindles``, ``slow_oscillations`` (``ops.sleep``) and ``microstates``.
A recording opens straight off an EDF, BDF or BrainVision file
(``RawWavelet.from_edf``, ``from_bdf``, ``from_brainvision``): ``power``
then streams window batches off the file mmap into K4, and
``epochs_from_markers`` cuts epochs at the file's own markers.
Both need only the duck-typed MNE surface
``.info['sfreq']``, ``.ch_names`` and ``.get_data()``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import as_float32
from ..io.bdf import BDFRaw
from ..io.brainvision import BVRaw
from ..io.edf import EDFRaw
from ..io.native import f32_gather
from ..io.stream import EDFSource
from ..models.base import Numbers, WaveletBase
from ..ops import asr as _asr
from ..ops import bank as _bank
from ..ops import cluster as _cl
from ..ops import connectivity as _conn
from ..ops import csd as _csd
from ..ops import decoding as _dec
from ..ops import complexity as _cx
from ..ops import dwt as _dwt
from ..ops import erp as _erp
from ..ops import extensions as _ext
from ..ops import filtering as _flt
from ..ops import granger as _granger
from ..ops import graph as _graph
from ..ops import ica as _ica
from ..ops import leadfield as _lf
from ..ops import microstates as _ms
from ..ops import reject as _rej
from ..ops import riemann as _riem
from ..ops import sleep as _sleep
from ..ops import spatial as _sp
from ..ops import trf as _trf
from ..ops.baseline import _correct, _tf_stats, baseline_tf
from ..ops.bursts import burst_summary, burst_table
from ..ops.cwt import cwt_from_bank
from ..ops.cpd import cp_decompose
from ..ops.cwt2d import pow2_pad2, power2d
from ..ops.cycles import cycle_features
from ..ops.dwt import pow2_pad
from ..ops.fused import itc_auto, mean_power_auto, power_auto, power_itc_auto
from ..ops.envelope import env_corr_matrix
from ..ops.hmm import hmm_fit
from ..ops.irasa import irasa as _irasa
from ..ops.irasa import welch_psd
from ..ops.mp import matching_pursuit as _mp
from ..ops.multitaper import (multitaper_coherence_matrix,
                              multitaper_mean_power,
                              multitaper_partial_coherence)
from ..ops.signal_utils import pad_to
from ..ops.reassign import reassigned_mean_power
from ..ops.specparam import specparam as _specparam
from ..ops.sst import ssq_mean_power
from ..ops.superlets import superlet_mean_power
from ..parallel.streaming import StreamingCWT
from .observability import span


def _welch_of(data, ch_names, sfreq, picks, nperseg, band,
              epoch_mean=False, device=None):
    """Welch PSD for the adapters (``ops.irasa.welch_psd`` on ``device``):
    channels picked on the host, ``nperseg`` clamped to the largest power
    of two that fits the record (the JAX package's frequency grid),
    optionally the epoch mean and a band crop; ``(freqs, psd)`` as host
    numpy."""
    if picks is not None:
        data = data[..., [ch_names.index(ch) for ch in picks], :]
    n = data.shape[-1]
    seg = 1 << min(int(nperseg).bit_length() - 1, int(n).bit_length() - 1)
    if seg < 4:
        raise ValueError(f"record too short for Welch PSD (N={n})")
    psd = welch_psd(np.ascontiguousarray(data), sfreq=float(sfreq),
                           nperseg=seg, device=device)
    if epoch_mean and psd.ndim == 3:
        psd = psd.mean(0)
    freqs = np.arange(seg // 2 + 1) * float(sfreq) / seg
    psd = psd.cpu().numpy()
    if band is not None:
        lo, hi = float(band[0]), float(band[1])
        keep = (freqs >= lo) & (freqs <= hi)
        if not keep.any():
            raise ValueError(f"band {band} outside the PSD grid "
                             f"(0..{freqs[-1]:g} Hz)")
        psd = psd[..., keep]
        freqs = freqs[keep]
    return freqs, psd


def _snapshot(data, device) -> torch.Tensor:
    """The adapters' float32 host snapshot of ``get_data()``: bit for bit
    ``np.asarray(data).astype(np.float32)``, cast by ``Tensor.copy_`` on
    torch's intra-op thread pool.

    For a CUDA ``device`` the snapshot is page-locked, from torch's caching
    host allocator: the next adapter of the same shape gets the same block
    back (no fresh pages and no new pinning once warm), and the device copy
    from it runs asynchronously.  The cost is host memory: a live adapter
    holds its snapshot pinned, rounded up by the allocator to a power of
    two (128 MB for a 200 x 64 x 2048 epochs block, 256 MB for a 64 x
    600000 recording).  Arrays ``torch.from_numpy`` refuses (negative
    strides, a foreign byte order, object arrays) are cast by numpy into
    the same block.
    """
    src = np.asarray(data)
    dst = torch.empty(src.shape, dtype=torch.float32,
                      pin_memory=torch.device(device).type == "cuda")
    try:
        dst.copy_(torch.from_numpy(src))
    except (TypeError, ValueError):
        np.copyto(dst.numpy(), src, casting="unsafe")
    return dst


class EpochsWavelet:
    """Wavelet transforms over an MNE-style epochs container.

    epochs: an ``mne.Epochs``-like object (``.info['sfreq']``, ``.ch_names``,
        ``.get_data() -> (E, C, N)``).
    wavelet: a ``WaveletBase``.  Its ``sfreq`` is overwritten from
        ``epochs.info`` as the reference does; its ``device`` places the data.
    """

    def __init__(self, epochs, wavelet: WaveletBase) -> None:
        self.epochs = epochs
        self.wavelet = wavelet
        wavelet.sfreq = float(epochs.info['sfreq'])

    # -- internals -------------------------------------------------------

    def _fingerprint(self):
        """Cheap identity of the epochs' current state: the data are cached,
        and refetched when the epochs object is visibly mutated (length,
        channel count or sample count changes)."""
        try:
            n_times = len(self.epochs.times)
        except (AttributeError, TypeError):
            n_times = None
        return (id(self.epochs), len(self.epochs.ch_names),
                getattr(self.epochs, '__len__', lambda: None)(), n_times)

    def invalidate(self) -> None:
        """Drop the cached ``get_data()`` snapshot (host and device): call
        after in-place mutations the fingerprint cannot see."""
        for attr in ('_host', '_data', '_fp'):
            if hasattr(self, attr):
                delattr(self, attr)

    def _host_data(self) -> np.ndarray:
        """The float32 snapshot (``_snapshot``) as a numpy view, refetched
        when the fingerprint changes."""
        fp = self._fingerprint()
        if getattr(self, '_fp', None) != fp:
            self.invalidate()
            self._fp = fp
        if not hasattr(self, '_host'):
            with span("ninw.adapter.snapshot"):
                self._host = _snapshot(self.epochs.get_data(),
                                       self.wavelet.device)
        return self._host.numpy()

    def _channel_data(self, ch_name: str) -> torch.Tensor:
        # Slice on the host so one channel moves only (E, N).
        idx = self.epochs.ch_names.index(ch_name)
        host = np.ascontiguousarray(self._host_data()[:, idx, :])
        with span("ninw.h2d"):
            return torch.from_numpy(host).to(self.wavelet.device)

    def _all_data(self) -> torch.Tensor:
        """Device copy of the full (E, C, N) block (cached, invalidated with
        the host snapshot)."""
        self._host_data()
        if not hasattr(self, '_data'):
            # From the pinned tensor itself: the allocator then holds the
            # block until the copy has landed.
            with span("ninw.h2d"):
                self._data = self._host.to(self.wavelet.device,
                                           non_blocking=True)
        return self._data

    def _bank_for(self, waves: torch.Tensor, freqs) -> torch.Tensor:
        w = self.wavelet
        if not hasattr(w, '_bank'):
            if freqs is None:
                raise ValueError("freqs is required when no bank is cached")
            w._build_bank(freqs, waves.shape[-1] / w.sfreq)
        return pad_to(w._bank, waves)

    @staticmethod
    def _post(tf, sfreq, baseline, baseline_method, decim):
        """Optional per-row baseline correction, then time decimation
        (plain slicing AFTER the transform).  With both, the statistics
        come from the whole plane and only the kept samples are corrected:
        the same values, without a corrected copy of the whole plane.  A
        decimated plane is a copy: a strided view would keep the whole
        plane alive."""
        decim = int(decim) if decim else 1
        if baseline is None:
            return tf if decim == 1 else tf[..., ::decim].contiguous()
        if decim == 1:
            return baseline_tf(tf, sfreq, baseline[0], baseline[1],
                               baseline_method)
        stats = _tf_stats(tf, sfreq, baseline[0], baseline[1])
        return _correct(tf[..., ::decim], *stats, baseline_method)

    # -- reference-parity per-channel API ---------------------------------

    def cwt(self, ch_name: str, freqs: Numbers) -> torch.Tensor:
        """(E, F, N) complex CWT of one channel."""
        waves = self._channel_data(ch_name)
        bank = self._bank_for(waves, freqs)
        return cwt_from_bank(waves, bank, self.wavelet.interpolate)

    def power(self, ch_name: str, freqs: Numbers, baseline=None,
              baseline_method: str = "zscore",
              decim: int = 1) -> torch.Tensor:
        """(F, N) epoch-mean power of one channel.  ``baseline=(start_s,
        stop_s)`` applies ``ops.baseline.baseline_tf``; ``decim`` slices the
        time axis of the result."""
        waves = self._channel_data(ch_name)
        bank = self._bank_for(waves, freqs)
        tf = mean_power_auto(waves[:, None, :], bank,
                             interpolate=self.wavelet.interpolate)[0]
        return self._post(tf, self.wavelet.sfreq, baseline,
                          baseline_method, decim)

    def itc(self, ch_name: str, freqs: Numbers) -> torch.Tensor:
        """(F, N) inter-trial coherence of one channel."""
        waves = self._channel_data(ch_name)
        bank = self._bank_for(waves, freqs)
        return itc_auto(waves[:, None, :], bank,
                        interpolate=self.wavelet.interpolate)[0]

    # -- batched all-channel forms ----------------------------------------

    def cwt_all(self, freqs: Numbers) -> torch.Tensor:
        """(E, C, F, N) complex CWT of every channel and epoch.  Memory
        scales with the full coefficient tensor; prefer the reductions."""
        waves = self._all_data()
        bank = self._bank_for(waves, freqs)
        return cwt_from_bank(waves, bank, self.wavelet.interpolate)

    def power_all(self, freqs: Numbers, baseline=None,
                  baseline_method: str = "zscore",
                  decim: int = 1) -> torch.Tensor:
        """(C, F, N) epoch-mean power of all channels, with the same
        ``baseline`` / ``decim`` options as ``power``."""
        waves = self._all_data()
        bank = self._bank_for(waves, freqs)
        tf = mean_power_auto(waves, bank,
                             interpolate=self.wavelet.interpolate)
        return self._post(tf, self.wavelet.sfreq, baseline,
                          baseline_method, decim)

    def itc_all(self, freqs: Numbers) -> torch.Tensor:
        """(C, F, N) inter-trial coherence of all channels."""
        waves = self._all_data()
        bank = self._bank_for(waves, freqs)
        return itc_auto(waves, bank, interpolate=self.wavelet.interpolate)

    def power_itc_all(self, freqs: Numbers):
        """((C, F, N), (C, F, N)) epoch-mean power AND inter-trial coherence
        of all channels off one pass of the fused kernel."""
        waves = self._all_data()
        bank = self._bank_for(waves, freqs)
        return power_itc_auto(waves, bank,
                              interpolate=self.wavelet.interpolate)

    # -- power variants -------------------------------------------------------

    def superlet_power(self, ch_name: str, freqs: Numbers,
                       sigma: float = 3.0, order_min: int = 1,
                       order_max: int = 8,
                       adaptive: bool = True) -> torch.Tensor:
        """(F, N) epoch-mean superlet power of one channel
        (``ops.superlets``), with its own growing-cycle Morlet member banks:
        the wavelet contributes only ``sfreq`` and ``interpolate``."""
        waves = self._channel_data(ch_name)
        return superlet_mean_power(
            waves[:, None, :], np.asarray(freqs, np.float32),
            self.wavelet.sfreq, base_sigma=sigma, order_min=order_min,
            order_max=order_max, adaptive=adaptive,
            interpolate=self.wavelet.interpolate)[0]

    def multitaper_power(self, ch_name: str, freqs: Numbers,
                         n_tapers: int = 3, b=None, r=None) -> torch.Tensor:
        """(F, N) epoch-mean multitaper Morse power of one channel
        (``ops.multitaper``).  ``b`` / ``r`` default to the wavelet's Morse
        parameters when it has them (taper 0 then matches ``power``)."""
        waves = self._channel_data(ch_name)
        return multitaper_mean_power(
            waves[:, None, :], np.asarray(freqs, np.float32),
            self.wavelet.sfreq,
            b=float(getattr(self.wavelet, "b", 17.5) if b is None else b),
            r=float(getattr(self.wavelet, "r", 3.0) if r is None else r),
            n_tapers=n_tapers, interpolate=self.wavelet.interpolate)[0]

    def induced_power(self, ch_name: str, freqs: Numbers,
                      baseline=None, baseline_method: str = "zscore",
                      decim: int = 1) -> torch.Tensor:
        """(F, N) induced power: the evoked (epoch-mean) response is
        subtracted from every epoch before the epoch-mean power."""
        waves = self._channel_data(ch_name)
        waves = waves - waves.mean(0, keepdim=True)
        bank = self._bank_for(waves, freqs)
        tf = mean_power_auto(waves[:, None, :], bank,
                             interpolate=self.wavelet.interpolate)[0]
        return self._post(tf, self.wavelet.sfreq, baseline,
                          baseline_method, decim)

    def evoked_power(self, ch_name: str, freqs: Numbers,
                     baseline=None, baseline_method: str = "zscore",
                     decim: int = 1) -> torch.Tensor:
        """(F, N) evoked power: the power of the epoch-mean response."""
        waves = self._channel_data(ch_name).mean(0)
        bank = self._bank_for(waves, freqs)
        tf = mean_power_auto(waves[None, None, :], bank,
                             interpolate=self.wavelet.interpolate)[0]
        return self._post(tf, self.wavelet.sfreq, baseline,
                          baseline_method, decim)

    def single_trial_power(self, ch_name: str, freqs: Numbers,
                           baseline=None, baseline_method: str = "zscore",
                           decim: int = 1) -> torch.Tensor:
        """(E, F, N) per-epoch power planes of one channel
        (``ops.fused.power_auto``)."""
        waves = self._channel_data(ch_name)
        bank = self._bank_for(waves, freqs)
        tf = power_auto(waves[:, None, :], bank,
                        interpolate=self.wavelet.interpolate)[:, 0]
        return self._post(tf, self.wavelet.sfreq, baseline,
                          baseline_method, decim)

    def single_trial_power_all(self, freqs: Numbers, baseline=None,
                               baseline_method: str = "zscore",
                               decim: int = 1) -> torch.Tensor:
        """(E, C, F, N) per-epoch power planes of every channel
        (``ops.fused.power_auto``)."""
        waves = self._all_data()
        bank = self._bank_for(waves, freqs)
        tf = power_auto(waves, bank, interpolate=self.wavelet.interpolate)
        return self._post(tf, self.wavelet.sfreq, baseline,
                          baseline_method, decim)

    # -- statistics ---------------------------------------------------------

    @staticmethod
    def _cluster(test: str, *args, mesh, **kw):
        """``ops.cluster.cluster_test_<test>`` on one device, or its sharded
        twin (``parallel.sharded_cluster_test_<test>``: the permutation
        null over the mesh's ``data`` axis, the same result for one seed)
        when a mesh is given; "paired" is the one-sample test of the
        per-epoch differences."""
        if mesh is None:
            return getattr(_cl, f"cluster_test_{test}")(*args, **kw)
        from ..parallel import sharded
        if test == "paired":
            test, args = "one_sample", (args[0] - args[1],)
        return getattr(sharded, f"sharded_cluster_test_{test}")(
            *args, mesh=mesh, **kw)

    def cluster_test(self, ch_name: str, freqs: Numbers, other=None, *,
                     paired: bool = False, baseline=None,
                     baseline_method: str = "zscore", decim: int = 1,
                     n_perm: int = 999, threshold=None, alpha: float = 0.05,
                     seed: int = 0, mesh=None):
        """Cluster-based permutation test (Maris & Oostenveld 2007) on this
        channel's single-trial power planes (``ops.cluster``).

        ``other=None`` runs the one-sample sign-flip test of the
        baseline-corrected power against zero (``baseline`` is REQUIRED:
        raw power has no meaningful zero).  ``other`` may be another
        ``EpochsWavelet`` (same channel / freqs computed there) or a
        precomputed (E, F, N) array; ``paired=True`` tests the per-epoch
        difference, else the independent-groups relabeling null.  The
        permutations come from a ``torch.Generator`` seeded with ``seed``.
        ``mesh`` (from ``parallel.make_mesh``; every rank calls this) splits
        the permutation null over its ``data`` axis, with the same result
        for one seed."""
        if other is None and baseline is None:
            raise ValueError(
                "one-sample cluster test needs baseline=(start, stop) "
                "so zero is the null hypothesis for the trial planes")
        x = self.single_trial_power(ch_name, freqs, baseline,
                                    baseline_method, decim)
        kw = dict(n_perm=n_perm, threshold=threshold, alpha=alpha,
                  seed=seed, mesh=mesh)
        if other is None:
            return self._cluster("one_sample", x, **kw)
        if isinstance(other, EpochsWavelet):
            y = other.single_trial_power(ch_name, freqs, baseline,
                                         baseline_method, decim)
        else:
            y = as_float32(other, x.device)
        return self._cluster("paired" if paired else "independent", x, y,
                             **kw)

    def cluster_test_all(self, freqs: Numbers, other=None, *,
                         adjacency=(), paired: bool = False, baseline=None,
                         baseline_method: str = "zscore", decim: int = 1,
                         n_perm: int = 999, threshold=None,
                         alpha: float = 0.05, seed: int = 0, mesh=None):
        """Spatio-spectral cluster permutation test over ALL channels (the
        MNE ``spatio_temporal_cluster_test`` analog): clusters live in
        (channel, frequency, time) with 4-connectivity in the TF plane plus
        same-pixel links between ``adjacency`` channel edges ((M, 2) ints,
        or a (C, C) boolean matrix; the default empty adjacency keeps
        channels independent but still corrects across all of them).
        Other arguments as :meth:`cluster_test`."""
        adjacency = self._as_edges(adjacency)
        if other is None and baseline is None:
            # validate BEFORE the expensive all-channel transform
            raise ValueError(
                "one-sample cluster test needs baseline=(start, stop) "
                "so zero is the null hypothesis for the trial planes")
        x = self.single_trial_power_all(freqs, baseline, baseline_method,
                                        decim)
        if other is None:
            y = None
        elif isinstance(other, EpochsWavelet):
            y = other.single_trial_power_all(freqs, baseline,
                                             baseline_method, decim)
        else:
            y = as_float32(other, x.device)
        if y is not None and paired:
            x, y = x - y, None
        kw = dict(n_perm=n_perm, threshold=threshold, alpha=alpha,
                  seed=seed, adjacency=adjacency, mesh=mesh)
        if y is None:
            return self._cluster("one_sample", x, **kw)
        return self._cluster("independent", x, y, **kw)

    @staticmethod
    def _as_edges(adjacency) -> np.ndarray:
        """Normalize a channel adjacency to an (M, 2) int edge array:
        accepts an edge list / array or a square boolean / 0-1 matrix
        (upper triangle taken, diagonal ignored)."""
        adjacency = np.asarray(adjacency)
        if adjacency.size == 0:
            return np.zeros((0, 2), np.int32)
        if adjacency.ndim == 2 and adjacency.shape[0] == adjacency.shape[1] \
                and (adjacency.shape[1] != 2 or adjacency.dtype == bool):
            iu, ju = np.triu_indices(adjacency.shape[0], k=1)
            keep = adjacency[iu, ju] != 0
            return np.stack([iu[keep], ju[keep]], -1).astype(np.int32)
        return adjacency.reshape(-1, 2).astype(np.int32)

    def cluster_regression(self, ch_name: str, freqs: Numbers,
                           covariate, *, baseline=None,
                           baseline_method: str = "zscore",
                           decim: int = 1, n_perm: int = 999,
                           threshold=None, alpha: float = 0.05,
                           seed: int = 0):
        """Cluster permutation test of a CONTINUOUS per-trial covariate
        (reaction time, intensity, dose...) against this channel's
        single-trial power (``ops.cluster.cluster_test_regression``):
        pixelwise regression t, covariate shuffled across trials for the
        null.  Baseline correction optional (the regression centres the
        planes itself)."""
        x = self.single_trial_power(ch_name, freqs, baseline,
                                    baseline_method, decim)
        return _cl.cluster_test_regression(
            x, as_float32(np.asarray(covariate, np.float32), x.device),
            n_perm=n_perm, threshold=threshold, alpha=alpha, seed=seed)

    def cluster_f(self, ch_name: str, freqs: Numbers, others, *,
                  baseline=None, baseline_method: str = "zscore",
                  decim: int = 1, n_perm: int = 999, threshold=None,
                  alpha: float = 0.05, seed: int = 0, mesh=None):
        """One-way-ANOVA cluster permutation test across G >= 2 conditions
        of this channel's single-trial power (``ops.cluster.cluster_test_f``):
        this adapter is condition 1; ``others`` is a sequence of
        ``EpochsWavelet`` adapters (same channel / freqs computed there) or
        precomputed (E_g, F, N) arrays for the remaining conditions.
        ``mesh`` splits the relabeling null over its ``data`` axis (see
        :meth:`cluster_test`)."""
        x = self.single_trial_power(ch_name, freqs, baseline,
                                    baseline_method, decim)
        groups = [x]
        for o in others:
            if isinstance(o, EpochsWavelet):
                groups.append(o.single_trial_power(
                    ch_name, freqs, baseline, baseline_method, decim))
            else:
                groups.append(as_float32(o, x.device))
        return self._cluster("f", groups, n_perm=n_perm, threshold=threshold,
                             alpha=alpha, seed=seed, mesh=mesh)

    def bursts(self, ch_name: str, freqs: Numbers, factor: float = 6.0,
               min_area: int = 1, threshold=None, table: bool = False):
        """Oscillatory burst statistics of one channel's single-trial power
        (``ops.bursts``, Shin et al. 2017): per-epoch ``BurstSummary``
        (count / rate / duration / span / peak), or the host burst listing
        with ``table=True``.  ``freqs`` must be uniformly spaced (the span
        unit is its step)."""
        freqs = np.asarray(freqs, np.float32)
        step = float(freqs[1] - freqs[0]) if freqs.size > 1 else 1.0
        if freqs.size > 2 and not np.allclose(np.diff(freqs), step,
                                              rtol=1e-5):
            raise ValueError(
                "bursts needs a uniformly spaced freqs grid (the Hz "
                "span unit is its step); got non-uniform spacing")
        trials = self.single_trial_power(ch_name, freqs)
        if table:
            return burst_table(trials, threshold, self.wavelet.sfreq, freqs,
                               factor, min_area)
        return burst_summary(trials, threshold, self.wavelet.sfreq, step,
                             factor, min_area)

    # -- decompositions -------------------------------------------------------

    def specparam(self, ch_name: str, freqs: Numbers, max_peaks: int = 4,
                  fit_knee: bool = False, **kw):
        """FOOOF-style spectral fit (``ops.specparam``) of the channel's
        time-averaged epoch-mean power (``power``, the "power" kernel on the
        card): a host ``SpectralFit``."""
        power = self.power(ch_name, freqs).mean(-1)
        return _specparam(power, np.asarray(freqs, np.float64),
                          max_peaks=max_peaks, fit_knee=fit_knee, **kw)

    def psd(self, picks=None, nperseg: int = 1024, band=None,
            average: bool = True):
        """``(freqs, psd)``: the Welch power spectral density
        (``ops.irasa.welch_psd``; Hamming, 50% overlap, density scaling) as
        host numpy, the (C, F) epoch mean (``average=True``) or (E, C, F);
        ``band=(lo, hi)`` Hz crops the frequency axis.  The segment length
        is clamped to the largest power of two that fits the epoch."""
        return _welch_of(self._host_data(), self.epochs.ch_names,
                         self.wavelet.sfreq, picks, nperseg, band,
                         epoch_mean=average, device=self.wavelet.device)

    def cycles(self, ch_name: str, f_range, **kw):
        """Cycle-by-cycle waveform features of one channel
        (``ops.cycles``, bycycle): a ``CycleTable`` of per-epoch padded
        (E, K) features and burst flags; the thresholds pass through to
        ``cycle_features``."""
        return cycle_features(self._channel_data(ch_name),
                              self.wavelet.sfreq, f_range, **kw)

    def cp_power(self, freqs: Numbers, rank: int, tensor: str = "cfn",
                 ch_name=None, nonneg=None, n_iter: int = 100,
                 seed: int = 0, baseline=None,
                 baseline_method: str = "zscore", decim: int = 1):
        """Rank-R PARAFAC model (``ops.cpd``) of a power tensor:
        ``"cfn"`` (channel x freq x time of the epoch-mean power,
        ``power_all``), ``"efn"`` (epoch x freq x time of ``ch_name``,
        ``single_trial_power``) or ``"ecfn"`` (4-way single-trial,
        ``single_trial_power_all``).  Returns ``(weights, factors, fit)``.
        ``nonneg`` defaults True for raw power and False under a
        ``baseline`` (signed tensors); ``nonneg=True`` with a baseline
        raises."""
        if nonneg is None:
            nonneg = baseline is None
        elif nonneg and baseline is not None:
            raise ValueError(
                "nonneg=True with a baseline correction: baselined "
                "power is signed and HALS would clamp the negative "
                "half; pass nonneg=False (or drop the baseline)")
        if tensor == "cfn":
            x = self.power_all(freqs, baseline, baseline_method, decim)
        elif tensor == "efn":
            if ch_name is None:
                raise ValueError("tensor='efn' needs ch_name")
            x = self.single_trial_power(ch_name, freqs, baseline,
                                        baseline_method, decim)
        elif tensor == "ecfn":
            x = self.single_trial_power_all(freqs, baseline,
                                            baseline_method, decim)
        else:
            raise ValueError("tensor must be 'cfn', 'efn' or 'ecfn'")
        return cp_decompose(x, rank, n_iter=n_iter, nonneg=nonneg,
                            seed=seed)

    def matching_pursuit(self, ch_name: str, n_atoms: int = 20,
                         scales_s=None, freqs=None):
        """Per-epoch greedy Gabor decomposition of one channel
        (``ops.mp``): an ``MPResult`` of (E, n_atoms) atom parameters and
        the (E, N) residuals; render with ``ops.mp_tfr``."""
        return _mp(self._channel_data(ch_name), n_atoms, self.wavelet.sfreq,
                   scales_s=scales_s, freqs=freqs)

    # -- synchrosqueezing ---------------------------------------------------

    def _ssq_bank(self, waves: torch.Tensor, freqs) -> torch.Tensor:
        bank = self._bank_for(waves, freqs)
        if bank.is_complex():
            raise ValueError(
                "synchrosqueezing needs an analytic (real-bank) family; "
                "Normal/Twice-mode banks carry no usable phase")
        return bank

    def ssq_power(self, ch_name: str, freqs: Numbers,
                  rel_threshold: float = 1e-6) -> torch.Tensor:
        """(F, N) epoch-mean synchrosqueezed power of one channel (see
        ``ops.sst``): each epoch's scalogram energy is reassigned to its
        instantaneous-frequency row before the epoch mean, with the noise
        gate per epoch."""
        waves = self._channel_data(ch_name)
        bank = self._ssq_bank(waves, freqs)
        return ssq_mean_power(waves[:, None, :], bank,
                              self.wavelet._bank_freqs, self.wavelet.sfreq,
                              interpolate=self.wavelet.interpolate,
                              rel_threshold=rel_threshold)[0]

    def ssq_power_all(self, freqs: Numbers,
                      rel_threshold: float = 1e-6) -> torch.Tensor:
        """(C, F, N) epoch-mean synchrosqueezed power of all channels.  On
        the card, a single "lin" or "log" grid (``ops.sst.uniform_grid_hint``)
        on the analytic path runs the two synchrosqueezing kernels, one
        launch each; a piecewise or irregular grid runs the plain path."""
        waves = self._all_data()
        bank = self._ssq_bank(waves, freqs)
        return ssq_mean_power(waves, bank, self.wavelet._bank_freqs,
                              self.wavelet.sfreq,
                              interpolate=self.wavelet.interpolate,
                              rel_threshold=rel_threshold)

    def reassigned_power(self, ch_name: str, freqs: Numbers,
                         rel_threshold: float = 1e-6,
                         t_decim: int = 16) -> torch.Tensor:
        """(F, ceil(N / t_decim)) epoch-mean reassigned scalogram of one
        channel (see ``ops.reassign``): each cell's energy moves to its
        local centroid in time and frequency, per trial, then the trials
        are averaged.  Analytic (real-bank) families only."""
        waves = self._channel_data(ch_name)
        bank = self._ssq_bank(waves, freqs)
        return reassigned_mean_power(waves, bank, self.wavelet._bank_freqs,
                                     self.wavelet.sfreq,
                                     interpolate=self.wavelet.interpolate,
                                     rel_threshold=rel_threshold,
                                     t_decim=t_decim)

    # -- other transforms -----------------------------------------------------

    def tfr_power2d(self, ch_name: str, freqs: Numbers,
                    img_freqs=(0.02, 0.05, 0.1, 0.2), thetas=None,
                    log_power: bool = True):
        """Directional 2-D wavelet analysis of the channel's epoch-mean TFR
        plane (``ops.cwt2d``): the (F, N) map, from ``power`` (the "power"
        kernel on the card), is an image decomposed over oriented 2-D
        Morlets, so sustained rhythms, broadband events and frequency
        sweeps land in different orientation channels.

        Returns ``(power, (F, N))``: a (F2, T, Fp, Np) tensor over the
        plane reflect-padded to powers of two, and the crop for the
        original sizes.  ``img_freqs`` are cycles/pixel of the image;
        ``log_power`` applies log1p first."""
        plane = self.power(ch_name, freqs)              # (F, N)
        if log_power:
            plane = torch.log1p(plane)
        padded, crop = pow2_pad2(plane)
        return power2d(padded, img_freqs, thetas), crop

    def modwt_var(self, ch_name: str, wavelet: str = "db4", level=None,
                  mean: bool = True) -> torch.Tensor:
        """Wavelet variance by octave of one channel (``ops.dwt.modwt_var``)
        of each epoch reflect-padded to a power of two: the (J,) epoch mean
        (``mean=True``) or (E, J) per epoch, a tensor on the wavelet's
        device."""
        padded, _ = pow2_pad(self._channel_data(ch_name))
        out = _dwt.modwt_var(padded, wavelet, level)
        return torch.mean(out, dim=0) if mean else out

    def modwt_denoise(self, wavelet: str = "db4", level=None,
                      mode: str = "soft") -> "EpochsWavelet":
        """A NEW ``EpochsWavelet`` over MODWT-shrinkage-denoised copies of
        every epoch and channel (``ops.dwt.modwt_denoise``, level-dependent
        universal thresholds, each row reflect-padded to a power of two),
        with the same channel names, sfreq, wavelet object and event codes:
        its ``power_all`` / ``itc_all`` run the kernels on the cleaned
        trials."""
        data = self._all_data()                         # (E, C, N)
        den = _dwt.modwt_denoise(data.reshape(-1, data.shape[-1]), wavelet,
                                 level, mode, pad_pow2=True)
        times = getattr(self.epochs, "times", None)
        return self._carry_codes(EpochsWavelet(
            ArrayEpochs(den.reshape(data.shape).cpu().numpy(),
                        self.wavelet.sfreq, list(self.epochs.ch_names),
                        times=times),
            self.wavelet))

    # -- pair connectivity ----------------------------------------------------

    def _conn_bank(self, n: int, freqs: Numbers,
                   need_phase: bool = True) -> torch.Tensor:
        """Signal-length bank for the connectivity metrics, built directly
        on the wavelet's device (the cached cwt / power bank is not
        touched)."""
        w = self.wavelet
        bank = _bank.make_fft_bank(w._wdef(), w._check_freqs(freqs), int(n),
                                   w.sfreq, w.interpolate,
                                   w.real_wave_length, device=w.device)
        if need_phase and bank.is_complex():
            raise ValueError(
                "phase metrics need an analytic (real-bank) family — "
                "Normal/Twice-mode banks carry no usable phase")
        return bank

    def _pair(self, ch_a: str, ch_b: str, freqs: Numbers,
              need_phase: bool = True):
        sa = self._channel_data(ch_a)
        sb = self._channel_data(ch_b)
        return sa, sb, self._conn_bank(sa.shape[-1], freqs, need_phase)

    def plv(self, ch_a: str, ch_b: str, freqs: Numbers,
            eps: float = 0.0) -> torch.Tensor:
        """(F, N) phase-locking value between two channels across epochs
        (``ops.connectivity.plv_auto``)."""
        sa, sb, bank = self._pair(ch_a, ch_b, freqs)
        return _conn.plv_auto(sa, sb, bank,
                              interpolate=self.wavelet.interpolate, eps=eps)

    def coherence(self, ch_a: str, ch_b: str, freqs: Numbers,
                  eps: float = 1e-12) -> torch.Tensor:
        """(F, N) epoch-wise wavelet coherence between two channels
        (``ops.extensions.epoch_coherence_auto``; any family)."""
        sa, sb, bank = self._pair(ch_a, ch_b, freqs, need_phase=False)
        return _ext.epoch_coherence_auto(
            sa, sb, bank, interpolate=self.wavelet.interpolate, eps=eps)

    def phase_lag(self, ch_a: str, ch_b: str, freqs: Numbers,
                  method: str = "wpli", eps: float = 0.0) -> torch.Tensor:
        """(F, N) phase-lag connectivity between two channels across
        epochs (``ops.connectivity.phase_lag_auto``): "pli", "wpli" or
        "dwpli".  Only the imaginary cross-spectrum counts, so zero-lag
        (volume-conduction) coupling contributes nothing."""
        sa, sb, bank = self._pair(ch_a, ch_b, freqs)
        return _conn.phase_lag_auto(sa, sb, bank, method=method,
                                    interpolate=self.wavelet.interpolate,
                                    eps=eps)

    def pli(self, ch_a: str, ch_b: str, freqs: Numbers,
            eps: float = 0.0) -> torch.Tensor:
        """(F, N) phase-lag index (``phase_lag(method="pli")``)."""
        return self.phase_lag(ch_a, ch_b, freqs, "pli", eps)

    def wpli(self, ch_a: str, ch_b: str, freqs: Numbers,
             eps: float = 0.0) -> torch.Tensor:
        """(F, N) weighted phase-lag index (``phase_lag(method="wpli")``)."""
        return self.phase_lag(ch_a, ch_b, freqs, "wpli", eps)

    def ppc(self, ch_a: str, ch_b: str, freqs: Numbers,
            eps: float = 0.0) -> torch.Tensor:
        """(F, N) pairwise phase consistency between two channels across
        epochs (``ops.connectivity.ppc_auto``); needs 2 epochs."""
        sa, sb, bank = self._pair(ch_a, ch_b, freqs)
        return _conn.ppc_auto(sa, sb, bank,
                              interpolate=self.wavelet.interpolate, eps=eps)

    def imcoh(self, ch_a: str, ch_b: str, freqs: Numbers,
              eps: float = 1e-12) -> torch.Tensor:
        """(F, N) imaginary coherency between two channels across epochs
        (``ops.extensions.imcoh_auto``; any family)."""
        sa, sb, bank = self._pair(ch_a, ch_b, freqs, need_phase=False)
        return _ext.imcoh_auto(sa, sb, bank,
                               interpolate=self.wavelet.interpolate, eps=eps)

    def psi(self, ch_a: str, ch_b: str, freqs: Numbers, band=None,
            eps: float = 1e-12) -> torch.Tensor:
        """(N,) time-resolved phase slope index between two channels
        (``ops.extensions.psi``): positive where ``ch_a`` leads ``ch_b``.
        ``freqs`` must ascend; ``band`` restricts the slope to a (lo, hi)
        row-index slice."""
        arr = np.asarray(freqs, np.float64)
        if arr.size < 2 or np.any(np.diff(arr) <= 0):
            raise ValueError("psi needs >= 2 strictly ascending freqs")
        sa, sb, bank = self._pair(ch_a, ch_b, freqs, need_phase=False)
        return _ext.psi(sa, sb, bank, band=band,
                        interpolate=self.wavelet.interpolate, eps=eps)

    def _matrix_input(self, freqs: Numbers, need_phase: bool = True):
        waves = self._all_data()
        return waves, self._conn_bank(waves.shape[-1], freqs, need_phase)

    def wpli_matrix(self, freqs: Numbers, method: str = "wpli",
                    time_range=None, eps: float = 0.0) -> torch.Tensor:
        """(F, C, C) all-pairs phase-lag matrix over every channel,
        time-averaged (``ops.connectivity.wpli_matrix``).  The diagonal is
        NaN at ``eps = 0`` (a channel has no lag against itself)."""
        waves, bank = self._matrix_input(freqs)
        return _conn.wpli_matrix(waves, bank, method=method,
                                 interpolate=self.wavelet.interpolate,
                                 eps=eps,
                                 time_range=self._samples(time_range))

    def ppc_matrix(self, freqs: Numbers, time_range=None,
                   eps: float = 0.0) -> torch.Tensor:
        """(F, C, C) all-pairs pairwise-phase-consistency matrix,
        time-averaged (``ops.connectivity.ppc_matrix``)."""
        waves, bank = self._matrix_input(freqs)
        return _conn.ppc_matrix(waves, bank,
                                interpolate=self.wavelet.interpolate,
                                eps=eps, time_range=self._samples(time_range))

    def plv_matrix(self, freqs: Numbers, time_range=None,
                   eps: float = 0.0) -> torch.Tensor:
        """(F, C, C) all-pairs phase-locking matrix, time-averaged
        (``ops.connectivity.plv_matrix``).  ``time_range=(start_s, stop_s)``
        windows the average in seconds."""
        waves, bank = self._matrix_input(freqs)
        return _conn.plv_matrix(waves, bank,
                                interpolate=self.wavelet.interpolate,
                                eps=eps, time_range=self._samples(time_range))

    def coherence_matrix(self, freqs: Numbers, time_range=None,
                         eps: float = 1e-12) -> torch.Tensor:
        """(F, C, C) all-pairs epoch-wise coherence matrix, time-averaged
        (``ops.connectivity.coherence_matrix``; any family)."""
        waves, bank = self._matrix_input(freqs, need_phase=False)
        return _conn.coherence_matrix(waves, bank,
                                      interpolate=self.wavelet.interpolate,
                                      eps=eps,
                                      time_range=self._samples(time_range))

    def multitaper_coherence_matrix(self, freqs: Numbers, n_tapers: int = 3,
                                    time_range=None) -> torch.Tensor:
        """(F, C, C) all-pairs multitaper coherence
        (``ops.multitaper.multitaper_coherence_matrix``): the K Morse tapers
        fold into the epoch axis, so even one epoch gives a usable matrix.
        ``time_range=(start_s, stop_s)`` windows the sums in seconds."""
        return multitaper_coherence_matrix(
            self._all_data(), np.asarray(list(freqs), np.float64),
            self.wavelet.sfreq, n_tapers=n_tapers,
            interpolate=self.wavelet.interpolate,
            time_range=self._samples(time_range))

    def multitaper_partial_coherence(self, freqs: Numbers,
                                     n_tapers: int = 3, lam: float = 1e-5,
                                     time_range=None) -> torch.Tensor:
        """(F, C, C) multitaper partial coherence
        (``ops.multitaper.multitaper_partial_coherence``): the conditioning
        inverse runs on the taper-augmented cross-spectra, so it stays well
        posed where ``partial_coherence`` is rank-starved."""
        return multitaper_partial_coherence(
            self._all_data(), np.asarray(list(freqs), np.float64),
            self.wavelet.sfreq, n_tapers=n_tapers, lam=lam,
            interpolate=self.wavelet.interpolate,
            time_range=self._samples(time_range))

    def kuramoto_order(self, freqs: Numbers,
                       mean_epochs: bool = True) -> torch.Tensor:
        """(F, N) Kuramoto order parameter across every channel
        (``ops.connectivity.kuramoto_order``): 1 for a whole-head phase
        lock, ~1/sqrt(C) under independence; (E, F, N) with
        ``mean_epochs=False``."""
        waves, bank = self._matrix_input(freqs)
        return _conn.kuramoto_order(waves, bank,
                                    interpolate=self.wavelet.interpolate,
                                    mean_epochs=mean_epochs)

    def partial_coherence(self, freqs: Numbers, time_range=None,
                          lam: float = 1e-5) -> torch.Tensor:
        """(F, C, C) all-pairs partial coherence, each pair conditioned on
        every other channel (``ops.connectivity.partial_coherence``)."""
        waves, bank = self._matrix_input(freqs)
        return _conn.partial_coherence(waves, bank,
                                       interpolate=self.wavelet.interpolate,
                                       lam=lam,
                                       time_range=self._samples(time_range))

    def psi_matrix(self, freqs: Numbers, time_range=None,
                   normalize: bool = True) -> torch.Tensor:
        """(C, C) phase slope index over every channel pair
        (``ops.connectivity.psi_matrix``): positive ``[a, b]`` where ``a``
        leads ``b`` across the band of ``freqs`` (sorted ascending here);
        ``normalize`` divides by the jackknife standard error."""
        freqs = np.sort(np.asarray(list(freqs), np.float64))
        waves, bank = self._matrix_input(freqs)
        return _conn.psi_matrix(waves, bank,
                                interpolate=self.wavelet.interpolate,
                                time_range=self._samples(time_range),
                                normalize=normalize)

    def network(self, freqs: Numbers, method: str = "wpli",
                time_range=None, n_nulls: int = 0) -> dict:
        """Graph summary of the all-pairs connectivity at each frequency
        (``ops.graph`` over the ``*_matrix`` estimators): a dict with the
        (F, C, C) ``matrix``, per-node ``strength`` and ``clustering``
        (F, C), per-frequency ``efficiency`` and ``path_length`` (F,), the
        leading-eigenvector ``communities`` (F, C) and ``modularity`` (F,)
        as numpy arrays; ``n_nulls > 0`` adds ``small_world`` sigma against
        that many weight-shuffled nulls.  ``method``: "wpli", "plv",
        "coherence", "ppc" or "pcoh" (partial coherence)."""
        fn = {"wpli": self.wpli_matrix, "plv": self.plv_matrix,
              "coherence": self.coherence_matrix,
              "ppc": self.ppc_matrix,
              "pcoh": self.partial_coherence}.get(method)
        if fn is None:
            raise ValueError("method must be one of wpli/plv/coherence/"
                             "ppc/pcoh, got %r" % (method,))
        m = fn(freqs, time_range=time_range)
        labels, q = _graph.modularity_communities(m)   # batched over F
        out = {"matrix": m,
               "strength": _graph.strength(m),
               "clustering": _graph.clustering_onnela(m),
               "efficiency": _graph.global_efficiency(m),
               "path_length": _graph.char_path_length(m),
               "communities": labels.cpu().numpy(),
               "modularity": q.cpu().numpy()}
        if n_nulls:
            out["small_world"] = _graph.small_worldness(m, n_nulls=n_nulls)
        return out

    def granger(self, picks=None, n_bins: int = 65, time_decim: int = 16,
                n_iter: int = 60, conditional: bool = False) -> torch.Tensor:
        """(T', K, C, C) time-resolved spectral Granger causality over
        channels (``ops.granger``, Dhamala et al. 2008): ``out[t, k, i, j]``
        is the influence j -> i at the ``k``-th uniform bin
        (``ops.granger.uniform_freqs(n_bins, sfreq)``) and every
        ``time_decim``-th sample.  ``picks`` restricts to a channel-name
        subset (order kept).  Uses its own energy-normalized uniform-grid
        Morse bank, independent of this wavelet's.  ``conditional=True``
        takes the multivariate conditional estimator (needs >= 3 channels;
        indirect routes suppressed)."""
        waves = self._all_data()
        if picks is not None:
            idx = [self.epochs.ch_names.index(ch) for ch in picks]
            waves = waves[:, idx, :]
        fn = (_granger.wavelet_conditional_granger if conditional
              else _granger.wavelet_granger)
        return fn(waves, self.wavelet.sfreq, n_bins=n_bins,
                  time_decim=time_decim, n_iter=n_iter)

    def nm_plv(self, ch_a: str, ch_b: str, freqs: Numbers, n: int = 1,
               m: int = 1, eps: float = 0.0) -> torch.Tensor:
        """(F, N) n:m phase locking of ``n * phase(ch_a at freqs[k])``
        against ``m * phase(ch_b at (n / m) * freqs[k])``
        (``ops.connectivity.nm_plv``)."""
        sa, sb, bank_a = self._pair(ch_a, ch_b, freqs)
        scaled = np.asarray(freqs, np.float64) * (float(n) / float(m))
        bank_b = self._conn_bank(sa.shape[-1], scaled)
        return _conn.nm_plv(sa, sb, bank_a, bank_b, n=n, m=m,
                            interpolate=self.wavelet.interpolate, eps=eps)

    def plv_significance(self, ch_a: str, ch_b: str, freqs: Numbers,
                         n_surrogates: int = 199, seed: int = 0,
                         eps: float = 0.0):
        """((F, N) plv, (F, N) p-values) with circular-shift surrogates
        (``ops.connectivity.plv_significance``)."""
        sa, sb, bank = self._pair(ch_a, ch_b, freqs)
        return _conn.plv_significance(sa, sb, bank,
                                      interpolate=self.wavelet.interpolate,
                                      eps=eps, n_surrogates=n_surrogates,
                                      seed=seed)

    def pac(self, ch_name: str, freqs_phase: Numbers, freqs_amp: Numbers,
            method: str = "mvl", n_bins: int = 18, ch_amp=None,
            significance: int = 0, seed: int = 0):
        """(F_phase, F_amp) epoch-mean comodulogram
        (``ops.connectivity.pac``); ``ch_amp`` takes the amplitude from
        another channel; ``significance=S`` also returns S-surrogate
        p-values, ``(pac, p)`` (same channel only)."""
        cross = ch_amp is not None and ch_amp != ch_name
        if significance and cross:
            raise ValueError("significance is same-channel only "
                             "(the surrogate rolls the amplitude "
                             "copy of the SAME signal)")
        waves = self._channel_data(ch_name)
        bp = self._conn_bank(waves.shape[-1], freqs_phase)
        ba = self._conn_bank(waves.shape[-1], freqs_amp)
        interp = self.wavelet.interpolate
        if significance:
            return _conn.pac_significance(waves, bp, ba, interpolate=interp,
                                          method=method, n_bins=n_bins,
                                          n_surrogates=int(significance),
                                          seed=seed)
        if cross:
            return _conn.pac_pair(waves, self._channel_data(ch_amp), bp, ba,
                                  interpolate=interp, method=method,
                                  n_bins=n_bins)
        return _conn.pac(waves, bp, ba, interpolate=interp, method=method,
                         n_bins=n_bins, mean_epochs=True)

    def lagged_coherence(self, ch_name: str, freqs: Numbers,
                         n_cycles: float = 3.0, lag=None) -> torch.Tensor:
        """(F,) rhythmicity of one channel
        (``ops.connectivity.lagged_coherence_morse``, pair sums pooled over
        epochs)."""
        return _conn.lagged_coherence_morse(
            self._channel_data(ch_name), freqs, self.wavelet.sfreq,
            n_cycles=n_cycles, lag=lag, pooled=True)

    def cfd(self, ch_name: str, freqs_slow: Numbers, freqs_fast: Numbers,
            band=None) -> torch.Tensor:
        """(N,) cross-frequency directionality of one channel
        (``ops.extensions.cfd``): positive where the slow phase leads the
        fast amplitude envelope."""
        waves = self._channel_data(ch_name)
        bs = self._conn_bank(waves.shape[-1], freqs_slow)
        bf = self._conn_bank(waves.shape[-1], freqs_fast)
        return _ext.cfd(waves, bs, bf, band=band,
                        interpolate=self.wavelet.interpolate)

    def erpac(self, ch_name: str, freqs_phase: Numbers,
              freqs_amp: Numbers) -> torch.Tensor:
        """(Fp, Fa, N) event-related PAC of one channel across trials
        (``ops.connectivity.erpac``)."""
        waves = self._channel_data(ch_name)
        bp = self._conn_bank(waves.shape[-1], freqs_phase)
        ba = self._conn_bank(waves.shape[-1], freqs_amp)
        return _conn.erpac(waves, bp, ba,
                           interpolate=self.wavelet.interpolate)

    def bicoherence(self, ch_name: str, freqs1: Numbers,
                    freqs2: Numbers = None,
                    eps: float = 1e-12) -> torch.Tensor:
        """(F1, F2) wavelet bicoherence of one channel across epochs
        (``ops.extensions.bicoherence``); ``freqs2`` defaults to
        ``freqs1``.  Every pairwise sum must stay below Nyquist."""
        f1 = np.asarray(freqs1, np.float64)
        f2 = f1 if freqs2 is None else np.asarray(freqs2, np.float64)
        sums = (f1[:, None] + f2[None, :]).ravel()
        nyq = self.wavelet.sfreq / 2.0
        if sums.max() >= nyq:
            raise ValueError(
                f"f1 + f2 reaches {sums.max():g} Hz >= Nyquist {nyq:g} — "
                "shrink the grids")
        waves = self._channel_data(ch_name)[:, None, :]
        n = waves.shape[-1]
        return _ext.bicoherence(waves, self._conn_bank(n, f1),
                                self._conn_bank(n, f2),
                                self._conn_bank(n, sums),
                                interpolate=self.wavelet.interpolate,
                                eps=eps)[0]

    def wavelet_entropy(self, ch_name: str, freqs: Numbers,
                        normalized: bool = True) -> torch.Tensor:
        """(N,) time-resolved wavelet entropy of the channel's epoch-mean
        power (``ops.extensions.wavelet_entropy``; the power through
        ``power``, the "power" kernel on the card)."""
        return _ext.wavelet_entropy(self.power(ch_name, freqs), normalized)

    def env_corr(self, freqs: Numbers, orthogonalize: bool = True,
                 log: bool = True, time_range=None) -> torch.Tensor:
        """(F, C, C) power-envelope correlations over every channel
        (``ops.envelope``); ``orthogonalize`` removes the zero-lag leakage
        component first; ``time_range`` is a seconds pair."""
        waves, bank = self._matrix_input(freqs)
        return env_corr_matrix(waves, bank, orthogonalize=orthogonalize,
                               interpolate=self.wavelet.interpolate, log=log,
                               time_range=self._samples(time_range))

    # -- sensor-space preprocessing and decoding ------------------------------

    def _derived(self, data: torch.Tensor, names=None, sel=None
                 ) -> "EpochsWavelet":
        """A NEW adapter over ``data`` ((E, C, N), copied to the host), on
        the same wavelet and time axis, with the event codes carried."""
        times = getattr(self.epochs, "times", None)
        out = EpochsWavelet(
            ArrayEpochs(data.cpu().numpy(), self.wavelet.sfreq,
                        list(self.epochs.ch_names) if names is None
                        else names, times=times),
            self.wavelet)
        return self._carry_codes(out, sel)

    def _channel_index(self, names) -> list:
        all_names = list(self.epochs.ch_names)
        for ch in names:
            if ch not in all_names:
                raise ValueError(f"channel {ch!r} not in ch_names")
        return [all_names.index(ch) for ch in names]

    def _two_classes(self, labels):
        """The (E, C, N) block split into the two classes of ``labels``
        (class A the smaller label), on the wavelet's device."""
        data = self._all_data()
        y = np.asarray(labels)
        if y.shape != (data.shape[0],):
            raise ValueError("labels must be one value per epoch")
        classes = np.unique(y)
        if classes.size != 2:
            raise ValueError(f"need exactly 2 classes, got {classes}")
        return tuple(data.index_select(0, torch.from_numpy(
            np.flatnonzero(y == cl)).to(data.device)) for cl in classes)

    def decode(self, other, freqs: Numbers, n_folds: int = 5,
               lam: float = 1e-3, log_power: bool = True, baseline=None,
               baseline_method: str = "zscore",
               decim: int = 1) -> torch.Tensor:
        """(F, N) cross-validated decoding AUC between this adapter's trials
        and ``other``'s from the all-channel power pattern at every TF pixel
        (``ops.decoding.tf_decode``); the planes are
        ``single_trial_power_all`` (K4 on the card).  ``log_power`` applies
        log1p before the optional baseline correction."""
        xa = self.single_trial_power_all(freqs, None, decim=decim)
        xb = other.single_trial_power_all(freqs, None, decim=decim)
        if log_power:
            # the planes are fresh: take the log in place (a full-width
            # class holds gigabytes)
            xa.log1p_()
            xb.log1p_()
        if baseline is not None:
            sf = self.wavelet.sfreq / max(int(decim), 1)
            xa = baseline_tf(xa, sf, baseline[0], baseline[1],
                             baseline_method)
            xb = baseline_tf(xb, sf, baseline[0], baseline[1],
                             baseline_method)
        return _dec.tf_decode(xa, xb, n_folds=n_folds, lam=lam)

    def decode_generalization(self, other, freqs: Numbers,
                              n_folds: int = 5, lam: float = 1e-3,
                              decim: int = 4,
                              log_power: bool = True) -> torch.Tensor:
        """(T, T) temporal generalization matrix (King & Dehaene) from the
        band-mean power per channel of ``single_trial_power_all`` (K4 on
        the card), decimated by ``decim``."""
        xa = self.single_trial_power_all(freqs, decim=decim).mean(-2)
        xb = other.single_trial_power_all(freqs, decim=decim).mean(-2)
        if log_power:
            xa, xb = torch.log1p(xa), torch.log1p(xb)
        return _dec.temporal_generalization(xa, xb, n_folds=n_folds,
                                            lam=lam)

    def ssvep(self, stim_freqs, n_harmonics: int = 3):
        """CCA-based SSVEP frequency recognition per trial
        (``ops.decoding.ssvep_cca``): ``(labels (E,), rho (E, F))``."""
        return _dec.ssvep_cca(self._all_data(), list(stim_freqs),
                              self.wavelet.sfreq, n_harmonics=n_harmonics)

    def riemann_decode(self, other: "EpochsWavelet",
                       method: str = "tangent", n_folds: int = 5,
                       shrink: float = 0.05, **kw) -> float:
        """Cross-validated Riemannian covariance decoding against ``other``
        (``ops.riemann``): ``"tangent"`` (tangent-space LDA, an AUC) or
        ``"mdm"`` (minimum distance to the Karcher mean, an accuracy)."""
        fn = {"tangent": _riem.tangent_decode,
              "mdm": _riem.mdm_decode}.get(method)
        if fn is None:
            raise ValueError("method must be 'tangent' or 'mdm'")
        return fn(self._all_data(), other._all_data(), n_folds=n_folds,
                  shrink=shrink, **kw)

    def regress_out(self, ref_names) -> "EpochsWavelet":
        """A NEW adapter with the listed reference channels (EOG / ECG)
        regressed out of every other channel per epoch
        (``ops.reject.regress_out``) and the references dropped."""
        names = list(self.epochs.ch_names)
        ref_idx = self._channel_index(ref_names)
        keep_idx = [i for i in range(len(names)) if i not in ref_idx]
        if not keep_idx:
            raise ValueError("no data channels left after removing refs")
        data = self._all_data()
        dev = data.device
        cleaned = _rej.regress_out(
            data.index_select(1, torch.tensor(keep_idx, device=dev)),
            data.index_select(1, torch.tensor(ref_idx, device=dev)))
        return self._derived(cleaned, [names[i] for i in keep_idx])

    def drop_bad(self, threshold=None, **kw) -> "EpochsWavelet":
        """A NEW adapter without the trials whose worst-channel
        peak-to-peak exceeds ``threshold``; with ``threshold=None`` the
        threshold is chosen by cross-validation
        (``ops.reject.autoreject_global``; ``n_folds=`` / ``n_candidates=``
        / ``seed=`` pass through) and its ``RejectResult`` attached as
        ``.reject_result``.  Raises if every trial would be dropped."""
        data = self._all_data()
        res = None
        if threshold is None:
            res = _rej.autoreject_global(data, **kw)
            mask = res.drop_mask.cpu().numpy()
        else:
            mask = _rej.ptp_reject(data, float(threshold)).cpu().numpy()
        if mask.all():
            raise ValueError("drop_bad would reject every trial — "
                             "threshold too low for this data")
        out = self._derived(data.index_select(0, torch.from_numpy(
            np.flatnonzero(~mask)).to(data.device)), sel=~mask)
        out.reject_result = res
        return out

    def csd(self, positions, **kw) -> "EpochsWavelet":
        """A NEW adapter over the current-source density of every trial
        (``ops.csd``, Perrin spherical splines); ``positions`` (C, 3) in
        this adapter's channel order; ``stiffness=`` / ``lam=`` /
        ``head_radius=`` pass through."""
        data = self._all_data()
        if np.asarray(positions).shape[0] != data.shape[1]:
            raise ValueError("positions must match the channel count")
        return self._derived(_csd.csd(data, positions, **kw))

    def interpolate_bads(self, positions, bads, **kw) -> "EpochsWavelet":
        """A NEW adapter with the listed channel NAMES replaced by
        spherical-spline interpolations from the good ones
        (``ops.csd.interpolate_channels``)."""
        idx = self._channel_index(bads)
        return self._derived(_csd.interpolate_channels(
            self._all_data(), positions, idx, **kw))

    def csp(self, labels, n_components: int = 4, f_lo=None, f_hi=None,
            shrink: float = 0.01):
        """Common spatial patterns over all channels (``ops.spatial.csp``)
        for the two classes of ``labels``: a ``SpatialResult`` for
        ``spatial_epochs`` or ``ops.spatial.csp_features``."""
        xa, xb = self._two_classes(labels)
        return _sp.csp(xa, xb, n_components=n_components, f_lo=f_lo,
                       f_hi=f_hi, sfreq=self.wavelet.sfreq, shrink=shrink)

    def csp_decode(self, labels, n_folds: int = 5, n_components: int = 4,
                   f_lo=None, f_hi=None, **kw):
        """Scalar cross-validated CSP + LDA decoding AUC between the two
        classes of ``labels`` (``ops.decoding.csp_decode``)."""
        xa, xb = self._two_classes(labels)
        return _dec.csp_decode(xa, xb, n_folds=n_folds,
                               n_components=n_components, f_lo=f_lo,
                               f_hi=f_hi, sfreq=self.wavelet.sfreq, **kw)

    def ged(self, f_lo: float, f_hi: float, n_components=None,
            shrink: float = 0.01):
        """Narrowband-vs-broadband GED over all channels
        (``ops.spatial.ged``): components maximize [f_lo, f_hi] power
        relative to the raw trials."""
        data = self._all_data()
        xs = _flt.bandpass(data, self.wavelet.sfreq, f_lo, f_hi)
        return _sp.ged(_sp.covariance(xs), _sp.covariance(data),
                       n_components=n_components, shrink=shrink)

    def ssd(self, f_lo: float, f_hi: float, n_components=None,
            flank: float = 2.0, gap: float = 1.0, shrink: float = 0.01):
        """Spatio-spectral decomposition over all channels
        (``ops.spatial.ssd``)."""
        return _sp.ssd(self._all_data(), self.wavelet.sfreq, f_lo, f_hi,
                       n_components=n_components, flank=flank, gap=gap,
                       shrink=shrink)

    def spatial_epochs(self, result, n_components=None) -> "EpochsWavelet":
        """A NEW adapter over the spatially filtered component time series
        (channels ``comp0, comp1, ...``): its reductions (``power_all``,
        K1 on the card) run on the components."""
        filters = result.filters if hasattr(result, "filters") else result
        if n_components is not None:
            filters = filters[:, :n_components]
        src = _sp.spatial_apply(self._all_data(), filters)
        return self._derived(src, [f"comp{k}" for k in range(src.shape[1])])

    # -- ERP measures, complexity, dipoles ------------------------------------

    def evoked(self) -> torch.Tensor:
        """(C, N) trial-average (ERP) waveform of every channel
        (``ops.erp.evoked``), the time-domain counterpart of
        ``evoked_power``."""
        return _erp.evoked(self._all_data())

    def fit_dipole(self, elec_pos, **kw) -> dict:
        """Equivalent-current-dipole model of the evoked response
        (``ops.leadfield.fit_dipole_evoked`` on ``evoked``, mne's
        ``fit_dipole``): the position fitted at the peak-GFP sample, the
        moment time course in closed form; a dict of host values.
        ``elec_pos`` is (C, 3) in this adapter's channel order;
        ``radius=`` / ``n_terms=`` / ``spacing=`` pass through."""
        ev = self.evoked().cpu().numpy()
        if np.asarray(elec_pos).shape != (ev.shape[0], 3):
            raise ValueError("elec_pos must be (C, 3) matching ch_names")
        kw.setdefault("device", self.wavelet.device)
        return _lf.fit_dipole_evoked(ev, elec_pos, **kw)

    def _event_window(self, window):
        """(start_s, stop_s) EVENT-relative seconds -> sample window, on
        the epochs' ``times`` axis when they carry one (mne epochs start at
        tmin), else relative to the epoch start."""
        if window is None:
            return None
        times = getattr(self.epochs, "times", None)
        if times is not None:
            t = np.asarray(times, np.float64)
            lo = int(np.searchsorted(t, float(window[0]), side="left"))
            hi = int(np.searchsorted(t, float(window[1]), side="right"))
            return (lo, hi)
        return self._samples(window)

    def erp_peak(self, window=None, polarity: int = 1):
        """Windowed ERP peak of every channel's evoked waveform
        (``ops.erp.peak_measures``): a ``PeakResult`` of (C,) latencies
        (samples from the epoch start) and amplitudes; ``window`` in
        seconds, event-relative when the epochs carry ``times``."""
        return _erp.peak_measures(self.evoked(), self._event_window(window),
                                  polarity)

    def erp_onset(self, window, criterion: float = 0.5, polarity: int = 1):
        """Jackknife component-onset latency per channel
        (``ops.erp.jackknife_onsets``, Miller-Ulrich): ``(onsets, mean,
        se)`` in samples from the epoch start; ``window`` as in
        ``erp_peak``."""
        return _erp.jackknife_onsets(self._all_data(),
                                     self._event_window(window), criterion,
                                     polarity)

    def sample_entropy(self, m: int = 2, r: float = 0.2) -> torch.Tensor:
        """(E, C) sample entropy of every epoch and channel
        (``ops.complexity.sample_entropy``; tolerance ``r * std``)."""
        return _cx.sample_entropy(self._all_data(), m=m, r=r)

    def permutation_entropy(self, m: int = 3, tau: int = 1,
                            normalized: bool = True) -> torch.Tensor:
        """(E, C) permutation entropy of every epoch and channel
        (``ops.complexity.permutation_entropy``, Bandt-Pompe)."""
        return _cx.permutation_entropy(self._all_data(), m=m, tau=tau,
                                       normalized=normalized)

    def multiscale_entropy(self, m: int = 2, r: float = 0.2,
                           scales=10) -> torch.Tensor:
        """(E, C, S) multiscale-entropy profile of every epoch and channel
        (``ops.complexity.multiscale_entropy``, Costa 2002)."""
        return _cx.multiscale_entropy(self._all_data(), m=m, r=r,
                                      scales=scales)

    # -- trial groups ------------------------------------------------------

    def _carry_codes(self, out: "EpochsWavelet", sel=None
                     ) -> "EpochsWavelet":
        """Carry ``event_codes`` onto a new adapter (``sel`` filters the
        trials; None keeps them all), so ``split()`` works down a chain of
        transforms."""
        codes = getattr(self, "event_codes", None)
        if codes is not None:
            codes = np.asarray(codes)
            out.event_codes = codes if sel is None else codes[sel]
        return out

    def subset(self, sel) -> "EpochsWavelet":
        """A NEW ``EpochsWavelet`` over a trial subset: ``sel`` is a boolean
        mask or integer indices over epochs (order kept); the event codes
        follow."""
        sel = np.asarray(sel)
        sub = self._host_data()[sel]
        if sub.ndim != 3 or sub.shape[0] == 0:
            raise ValueError("selection keeps no trials")
        times = getattr(self.epochs, "times", None)
        out = EpochsWavelet(
            ArrayEpochs(sub, self.wavelet.sfreq,
                        list(self.epochs.ch_names), times=times),
            self.wavelet)
        return self._carry_codes(out, sel)

    def split(self, labels=None) -> dict:
        """``{label: EpochsWavelet}``, the trials partitioned by a per-epoch
        label array; with no argument by the ``event_codes`` carried over
        from ``RawWavelet.epochs`` (events with an mne-style id column)."""
        if labels is None:
            labels = getattr(self, "event_codes", None)
            if labels is None:
                raise ValueError(
                    "no labels given and this adapter carries no "
                    "event_codes — pass (E,) labels, or build the "
                    "epochs from (E, 3) mne-style events")
        labels = np.asarray(labels)
        # count epochs off the data: duck-typed containers need only
        # get_data()
        if labels.shape[0] != self._host_data().shape[0]:
            raise ValueError("labels must have one entry per epoch")
        return {lab: self.subset(labels == lab)
                for lab in np.unique(labels)}

    def _samples(self, time_range):
        """(start_s, stop_s) -> integer sample window, or None."""
        if time_range is None:
            return None
        sf = self.wavelet.sfreq
        return (int(round(time_range[0] * sf)),
                int(round(time_range[1] * sf)))


class ArrayEpochs:
    """Minimal epochs container over a plain ``(E, C, N)`` array: the
    duck-typed MNE surface ``EpochsWavelet`` needs (``.info['sfreq']``,
    ``.ch_names``, ``.get_data()``, ``len``, ``.times``)."""

    def __init__(self, data, sfreq: float, ch_names=None, times=None):
        data = np.asarray(data)
        if data.ndim != 3:
            raise ValueError(f"expected (E, C, N), got {data.shape}")
        self._data = data
        self.info = {'sfreq': float(sfreq)}
        self.ch_names = (list(ch_names) if ch_names is not None
                         else [f"ch{c}" for c in range(data.shape[1])])
        if len(self.ch_names) != data.shape[1]:
            raise ValueError("ch_names length != channel axis")
        self.times = (np.asarray(times) if times is not None
                      else np.arange(data.shape[2]) / float(sfreq))

    def __len__(self) -> int:
        return self._data.shape[0]

    def get_data(self) -> np.ndarray:
        return self._data


class RawWavelet:
    """Wavelet power over a CONTINUOUS MNE-style raw recording.

    Wraps ``parallel.StreamingCWT``: the recording is processed in
    fixed-size overlap-discard windows, with every channel riding the
    device batch beside the windows, into a (C, F, N) plane on the
    wavelet's device.

    Parameters
    ----------
    raw: an ``mne.io.Raw``-like object (``.info['sfreq']``, ``.ch_names``,
        ``.get_data() -> (C, N)``), or ``io.EDFRaw`` / ``BDFRaw`` /
        ``BVRaw`` (``from_edf``, ``from_bdf``, ``from_brainvision``).
    wavelet: a ``WaveletBase``; its ``sfreq`` is overwritten from
        ``raw.info`` and its ``device`` places the planes.
    window / halo / batch: see ``StreamingCWT`` (the halo defaults from the
        wavelet's envelope decay at the lowest analysis frequency; the
        extended window is rounded up to a power of two).  The fused kernel
        takes extended windows up to 32768 samples: the default window of
        16384 extends to 32768, which it runs as two 16384-point
        transforms an output parity ("power_each_split"); a window whose
        extension passes 32768 runs the plain path on the card.
    """

    def __init__(self, raw, wavelet: WaveletBase, window: int = 16384,
                 halo=None, batch: int = 8,
                 precision: str = "fast3") -> None:
        self.raw = raw
        self.wavelet = wavelet
        wavelet.sfreq = float(raw.info['sfreq'])
        self._window = int(window)
        self._halo = halo
        self._batch = int(batch)
        self._precision = precision

    @classmethod
    def from_edf(cls, path, wavelet: WaveletBase, picks=None,
                 **kw) -> "RawWavelet":
        """Open an EDF recording directly (``io.EDFRaw``): ``power`` and
        ``power_channel`` then stream window batches straight off the file
        mmap through the native gathers; the recording is never
        materialized in host memory."""
        return cls(EDFRaw(path, picks=picks), wavelet, **kw)

    @classmethod
    def from_bdf(cls, path, wavelet: WaveletBase, picks=None,
                 **kw) -> "RawWavelet":
        """Open a BioSemi BDF recording (24-bit; ``io.BDFRaw``): ``power``
        and ``power_channel`` stream window batches decoded straight off the
        file mmap.  Trigger events live on the ``Status`` channel: extract
        them with ``io.status_events(rw.raw.reader.get_data(["Status"])[0])``
        (the underlying ``BDFReader`` takes channel-name picks)."""
        return cls(BDFRaw(path, picks=picks), wavelet, **kw)

    @classmethod
    def from_brainvision(cls, vhdr_path, wavelet: WaveletBase,
                         picks=None, **kw) -> "RawWavelet":
        """Open a BrainVision recording (.vhdr; ``io.BVRaw``): ``power``
        and ``power_channel`` stream window batches off the file mmap; the
        markers are at ``.raw.reader.markers``, for
        :meth:`epochs_from_markers` or :meth:`epochs`."""
        return cls(BVRaw(vhdr_path, picks=picks), wavelet, **kw)

    def invalidate(self) -> None:
        """Drop the cached ``get_data()`` snapshot and streams: call after
        mutating the raw object (crop, filter)."""
        for attr in ('_host', '_streams'):
            if hasattr(self, attr):
                delattr(self, attr)

    def _host_data(self) -> np.ndarray:
        """The float32 snapshot of ``raw.get_data()`` (``_snapshot``), made
        once, as a numpy view."""
        if not hasattr(self, '_host'):
            with span("ninw.adapter.snapshot"):
                self._host = _snapshot(self.raw.get_data(),
                                       self.wavelet.device)
        return self._host.numpy()

    def _file_source(self, picks=None):
        """An ``io.stream`` source gathering straight off the file mmap
        when the raw object is file-backed (``io.EDFRaw``, ``io.BDFRaw``,
        ``io.BVRaw``: a ``reader`` with ``gather``), else None."""
        reader = getattr(self.raw, "reader", None)
        if reader is None or not hasattr(reader, "gather"):
            return None
        if picks is not None:
            # Picks resolve against THIS adapter's channel list (which
            # honours any construction-time subset), never the full file.
            for ch in picks:
                if ch not in self.raw.ch_names:
                    raise ValueError(f"channel {ch!r} not in raw.ch_names")
            names = list(picks)
        else:
            names = getattr(self.raw, "_picks", None)
        return EDFSource(reader, picks=names)

    def _stream_for(self, freqs: Numbers):
        """One ``StreamingCWT`` (bank and halo) per frequency grid,
        cached."""
        w = self.wavelet
        arr = w._check_freqs(freqs).numpy()
        key = (tuple(arr.tolist()), w.sfreq, w.interpolate)
        streams = getattr(self, '_streams', None)
        if streams is None:
            streams = self._streams = {}
        if key not in streams:
            streams[key] = StreamingCWT(
                w._wdef(), arr, w.sfreq, window=self._window,
                halo=self._halo, interpolate=w.interpolate,
                batch=self._batch, precision=self._precision,
                device=w.device)
        return streams[key]

    def power(self, freqs: Numbers, picks=None) -> torch.Tensor:
        """(C, F, N) power TFR of the whole recording, assembled on the
        wavelet's device.  ``picks``: optional list of channel names."""
        source = self._file_source(picks)
        if source is not None:
            return self._stream_for(freqs).power_device_source(source)
        data = self._host_data()
        if picks is not None:
            idx = [self.raw.ch_names.index(ch) for ch in picks]
            data = data[idx]
        return self._stream_for(freqs).power_device(data)

    def power_channel(self, ch_name: str, freqs: Numbers) -> torch.Tensor:
        """(F, N) power TFR of one channel (sliced on the host: only that
        channel's samples ride the stream)."""
        source = self._file_source([ch_name])
        if source is not None:
            return self._stream_for(freqs).power_device_source(source)[0]
        data = self._host_data()[self.raw.ch_names.index(ch_name)]
        return self._stream_for(freqs).power_device(data)

    def ssq_power(self, freqs: Numbers, picks=None,
                  rel_threshold: float = 1e-6) -> torch.Tensor:
        """(C, F, N) synchrosqueezed power of the whole recording, streamed
        windowwise (``StreamingCWT.ssq_power_device``: the noise gate is
        per window and channel).  Real banks only."""
        data = self._host_data()
        if picks is not None:
            idx = [self.raw.ch_names.index(ch) for ch in picks]
            data = data[idx]
        return self._stream_for(freqs).ssq_power_device(
            data, rel_threshold=rel_threshold)

    # -- preprocessing and discrete transforms ------------------------------

    def _picked(self, picks) -> torch.Tensor:
        """The recording's (C, N) samples on the wavelet's device, restricted
        to the ``picks`` channel names (order kept) when given."""
        data = self._host_data()
        if picks is not None:
            data = data[[self.raw.ch_names.index(ch) for ch in picks]]
        return torch.from_numpy(np.ascontiguousarray(data)).to(
            self.wavelet.device)

    def filter(self, f_lo=None, f_hi=None, notch_hz=None,
               picks=None) -> np.ndarray:
        """(C, N) zero-phase filtered copy of the recording
        (``ops.filtering``), host numpy as in the JAX package: a band, low
        or high pass from whichever of ``f_lo`` / ``f_hi`` is given, then
        each ``notch_hz`` (a line frequency or a list of them) in turn.
        Wrap the result in a new ``RawWavelet`` for further analysis."""
        out = self._picked(picks)
        sfreq = self.wavelet.sfreq
        if f_lo is not None and f_hi is not None:
            out = _flt.bandpass(out, sfreq, f_lo, f_hi)
        elif f_hi is not None:
            out = _flt.lowpass(out, sfreq, f_hi)
        elif f_lo is not None:
            out = _flt.highpass(out, sfreq, f_lo)
        if notch_hz is not None:
            for f0 in np.atleast_1d(notch_hz):
                out = _flt.notch(out, sfreq, float(f0))
        return out.cpu().numpy()

    def resample(self, new_sfreq: float, picks=None):
        """``(data, new_sfreq)``: the FFT-resampled recording
        (``ops.filtering.resample``) as host numpy, as in the JAX
        package."""
        y, sf = _flt.resample(self._picked(picks), self.wavelet.sfreq,
                              new_sfreq)
        return y.cpu().numpy(), sf

    def modwt_denoise(self, picks=None, wavelet: str = "db4", level=None,
                      mode: str = "soft") -> np.ndarray:
        """(C, N) MODWT-shrinkage-denoised copy of the recording
        (``ops.dwt.modwt_denoise``, each channel reflect-padded to a power
        of two and cropped), host numpy as in the JAX package."""
        return _dwt.modwt_denoise(self._picked(picks), wavelet, level, mode,
                                  pad_pow2=True).cpu().numpy()

    def modwt_var(self, ch_name: str, wavelet: str = "db4",
                  level=None) -> np.ndarray:
        """(J,) wavelet variance by scale of one channel
        (``ops.dwt.modwt_var`` of the channel reflect-padded to a power of
        two; level j covers ``[sfreq / 2^{j+1}, sfreq / 2^j]`` Hz), host
        numpy as in the JAX package."""
        padded, _ = pow2_pad(self._picked([ch_name])[0])
        return _dwt.modwt_var(padded, wavelet, level).cpu().numpy()

    # -- decompositions -------------------------------------------------------

    def irasa(self, band=(1.0, 40.0), picks=None, hset=None,
              nperseg: int = 1024):
        """Fractal / oscillatory split of each channel's Welch spectrum
        (``ops.irasa``): an ``IrasaResult`` of (C, Fb) tensors on the
        wavelet's device; ``ops.aperiodic_fit`` gives its 1/f exponent."""
        return _irasa(self._picked(picks), self.wavelet.sfreq,
                            band=band, hset=hset, nperseg=nperseg)

    def psd(self, picks=None, nperseg: int = 1024, band=None):
        """``(freqs, psd)``: the (C, F) Welch power spectral density of the
        recording as host numpy (``ops.irasa.welch_psd``; ``band=(lo, hi)``
        Hz crops; the segment length is clamped to a power of two)."""
        return _welch_of(self._host_data(), self.raw.ch_names,
                         self.wavelet.sfreq, picks, nperseg, band,
                         device=self.wavelet.device)

    def states(self, n_states: int = 4,
               bands=((1.0, 4.0), (4.0, 8.0), (8.0, 13.0), (13.0, 30.0)),
               picks=None, decim=None, n_iter: int = 50,
               stickiness: float = 0.9, seed: int = 0):
        """Recurring spectral states of the recording (``ops.hmm``): the
        per-channel log band-power envelopes of ``power`` (4 rows a band,
        averaged; decimated to about 20 Hz unless ``decim`` is given),
        z-scored, segmented by a K-state Gaussian HMM.  Returns the
        ``HMMResult``: ``means`` rows are the state profiles over the
        (channel x band) features, ``states`` / ``gamma`` the decoded time
        course at the decimated rate."""
        bands = [(float(lo), float(hi)) for lo, hi in bands]
        rows = 4                       # freq rows averaged per band
        freqs = np.concatenate([np.linspace(lo, hi, rows)
                                for lo, hi in bands]).astype(np.float32)
        p = self.power(freqs, picks)                     # (C, F, N)
        c, _, n = p.shape
        if decim is None:
            decim = max(1, int(self.wavelet.sfreq // 20))
        nt = n // decim
        p = p[:, :, :nt * decim].reshape(c, len(bands), rows, nt, decim)
        p = p.mean((2, 4))                               # (C, B, nt)
        feats = torch.log(p + 1e-12).reshape(c * len(bands), nt).T
        feats = ((feats - feats.mean(0))
                 / (feats.std(0, correction=0) + 1e-6))
        return hmm_fit(feats, n_states, n_iter=n_iter,
                       stickiness=stickiness, seed=seed)

    def specparam(self, freqs: Numbers, picks=None, max_peaks: int = 4,
                  fit_knee: bool = False, **kw):
        """FOOOF-style spectral fit (``ops.specparam``) of the recording's
        time-averaged ``power``, batched over channels; the mean is taken
        on the device, so only the (C, F) spectra cross to the host for
        the seeding.  A host ``SpectralFit`` whose leading axis is the
        channels."""
        power = self.power(freqs, picks=picks).mean(-1)
        return _specparam(power, np.asarray(freqs, np.float64),
                          max_peaks=max_peaks, fit_knee=fit_knee, **kw)

    # -- sensor-space preprocessing -------------------------------------------

    def _raw_index(self, names) -> list:
        for ch in names:
            if ch not in self.raw.ch_names:
                raise ValueError(f"channel {ch!r} not in ch_names")
        return [self.raw.ch_names.index(ch) for ch in names]

    def interpolate_bads(self, positions, bads) -> np.ndarray:
        """(C, N) host copy of the recording with the listed channel NAMES
        replaced by spherical-spline interpolations from the good ones
        (``ops.csd.interpolate_channels``, on the wavelet's device)."""
        idx = self._raw_index(bads)
        return _csd.interpolate_channels(self._picked(None), positions,
                                         idx).cpu().numpy()

    def find_bad_channels(self, **kw) -> dict:
        """Channel QC of the recording (``ops.reject.find_bad_channels``,
        PREP-style): flat / noisy / high-frequency / uncorrelated channels
        and bridged pairs, as channel NAMES; keywords pass through."""
        r = _rej.find_bad_channels(self._picked(None), self.wavelet.sfreq,
                                   **kw)
        names = self.raw.ch_names
        out = {k: [names[i] for i in v] for k, v in r.items()
               if k != "bridged"}
        out["bridged"] = [(names[i], names[j]) for i, j in r["bridged"]]
        return out

    def ica(self, n_components=None, picks=None, **kw):
        """FastICA of the recording (``ops.ica.fastica``): an ``ICAResult``
        on the wavelet's device; ``n_iter=`` / ``fun=`` / ``seed=`` pass
        through."""
        return _ica.fastica(self._picked(picks), n_components, **kw)

    def ica_clean(self, result, exclude, picks=None) -> np.ndarray:
        """(C, N) host copy of the recording with the ``exclude``d ICA
        components removed (``ops.ica.ica_remove``); ``picks`` must match
        the fit's, and the other channels pass through."""
        if picks is None:
            return _ica.ica_remove(self._picked(None), result,
                                   exclude).cpu().numpy()
        out = np.array(self._host_data(), copy=True)
        out[self._raw_index(picks)] = _ica.ica_remove(
            self._picked(picks), result, exclude).cpu().numpy()
        return out

    def ica_find_bads(self, result, ref=None, threshold: float = 3.0,
                      measure: str = "zscore"):
        """``(bad_indices, scores)``: artifact components by correlation
        with the ``ref`` channel NAME(s) (EOG / ECG), or by excess kurtosis
        with ``ref=None`` (``ops.ica.ica_find_bads``)."""
        trace = None
        if ref is not None:
            trace = self._picked([ref] if isinstance(ref, str)
                                 else list(ref))
        return _ica.ica_find_bads(result, trace, threshold=float(threshold),
                                  measure=measure)

    def trf(self, stim, tmin_s: float = 0.0, tmax_s: float = 0.25,
            lams=(1e-4, 1e-3, 1e-2, 1e-1, 1.0), n_folds: int = 5,
            picks=None):
        """Cross-validated temporal response function from a continuous
        (N,) or (K, N) stimulus to the recording (``ops.trf.trf_cv``,
        contiguous folds), lags ``tmin_s``..``tmax_s`` seconds: ``(TRFResult,
        r, best_lam)``."""
        sf = self.wavelet.sfreq
        lags = range(int(round(tmin_s * sf)), int(round(tmax_s * sf)) + 1)
        return _trf.trf_cv(stim, self._picked(picks), lags, lams=lams,
                           n_folds=n_folds, device=self.wavelet.device)

    def asr_clean(self, cutoff: float = 5.0, win_s: float = 0.5,
                  calib_frac: float = 0.25, return_keep: bool = False):
        """(C, N) ASR-cleaned host copy of the recording (``ops.asr``):
        the model calibrates on the ``calib_frac`` cleanest ``win_s``
        windows (lowest worst-channel peak-to-peak, picked on the host as
        in the JAX package), then every window's high-variance components
        are reconstructed.  ``return_keep=True`` also returns the (W, C)
        survival flags."""
        data = self._picked(None)
        sfreq = self.wavelet.sfreq
        win = max(2, int(round(win_s * sfreq)))
        nw_ = data.shape[-1] // win
        frames = data[:, :nw_ * win].reshape(data.shape[0], nw_, win)
        score = _rej.ptp(frames).amax(0).cpu().numpy()         # (W,)
        n_keep = max(4, int(round(calib_frac * nw_)))
        order = torch.from_numpy(np.sort(np.argsort(score)[:n_keep]))
        calib = frames.index_select(1, order.to(data.device)).reshape(
            data.shape[0], -1)
        model = _asr.asr_calibrate(calib, sfreq, cutoff=cutoff, win_s=win_s)
        cleaned, keep = _asr.asr_process(data, sfreq, model, win_s=win_s)
        cleaned = cleaned.cpu().numpy()
        return (cleaned, keep) if return_keep else cleaned

    # -- complexity, sleep events, microstates --------------------------------

    def dfa(self, ch_name: str, freq: float, scales=None, decim: int = 4,
            **kw):
        """Long-range temporal correlation of one channel's band amplitude
        envelope (Linkenkaer-Hansen 2001): the wavelet amplitude at
        ``freq`` Hz (``power_channel``, streamed; K4 on the card where the
        extended window fits the kernel), decimated by ``decim``, through
        ``ops.complexity.dfa``.  Returns ``(alpha, fluctuations)``;
        ``scales`` are in decimated samples."""
        p = self.power_channel(ch_name, [float(freq)])        # (1, N)
        env = torch.sqrt(torch.clamp(p[0], min=0.0))[::int(decim)]
        return _cx.dfa(env, scales=scales, **kw)

    def spindles(self, picks=None, **kw):
        """Sleep-spindle detection over the recording's channels
        (``ops.sleep.detect_spindles``, on the wavelet's device): an
        ``EventTable`` with a leading channel axis; the criteria pass
        through."""
        return _sleep.detect_spindles(self._picked(picks),
                                      self.wavelet.sfreq, **kw)

    def slow_oscillations(self, picks=None, **kw):
        """Slow-oscillation detection (``ops.sleep.
        detect_slow_oscillations``, Massimini criteria, robust-sigma
        thresholds by default) over the recording's channels."""
        return _sleep.detect_slow_oscillations(self._picked(picks),
                                               self.wavelet.sfreq, **kw)

    def microstates(self, n_states: int = 4, peaks_only: bool = True,
                    n_init: int = 8, n_iter: int = 40, seed: int = 0):
        """EEG microstates of the recording (``ops.microstates``): maps
        fitted on the GFP peaks, every sample backfitted.  Returns
        ``(MicrostateResult, stats)``, the statistics as host numpy."""
        res = _ms.microstate_fit(self._picked(None), n_states,
                                 peaks_only=peaks_only, n_init=n_init,
                                 n_iter=n_iter, seed=seed)
        return res, _ms.microstate_stats(res.labels, int(n_states),
                                         self.wavelet.sfreq)

    # -- event-locked epochs -------------------------------------------------

    def epochs_from_markers(self, tmin: float, tmax: float,
                            description=None, kind=None,
                            picks=None) -> EpochsWavelet:
        """Event-locked epochs from the recording's embedded markers
        (BrainVision .vmrk via ``io.BVReader.markers``): filter by marker
        ``description`` (e.g. ``"S  1"``) and / or ``kind`` (e.g.
        ``"Stimulus"``), then slice as :meth:`epochs` does.  The marker
        descriptions ride along as a numpy string array of
        ``event_codes``, so ``split()`` partitions by stimulus type."""
        reader = getattr(self.raw, "reader", None)
        markers = getattr(reader, "markers", None)
        if not markers:
            raise ValueError(
                "this recording carries no markers (open a BrainVision "
                "file with a .vmrk via RawWavelet.from_brainvision)")
        hits = [(s, d) for (s, k, d) in markers
                if (kind is None or k == kind)
                and (description is None or d == description)]
        if not hits:
            raise ValueError(
                f"no markers match kind={kind!r} "
                f"description={description!r}")
        ev = np.asarray([s for s, _ in hits], np.int64)
        return self.epochs(ev, tmin, tmax, picks=picks,
                           codes=np.asarray([d for _, d in hits]))

    def _bad_spans(self, prefix: str):
        """[(onset_s, duration_s), ...] of the annotations whose text starts
        with ``prefix`` (case-insensitive, mne's "bad" convention).  Needs a
        reader with ``read_annotations`` (EDF+, or BrainVision's marker
        spans)."""
        reader = getattr(self.raw, "reader", None)
        read = getattr(reader, "read_annotations", None)
        if read is None:
            raise ValueError(
                "this recording carries no annotation spans (open an "
                "EDF+ file via RawWavelet.from_edf, or pass explicit "
                "reject_spans=[(onset_s, duration_s), ...])")
        p = prefix.lower()
        return [(o, d) for (o, d, txt) in read()
                if txt.lower().startswith(p)]

    def epochs(self, events, tmin: float, tmax: float, picks=None,
               reject_spans=None, reject_annotations=None,
               codes=None) -> EpochsWavelet:
        """An ``EpochsWavelet`` over event-locked windows of the recording
        (the ``mne.Epochs(raw, events)`` workflow without mne); its epoch
        reductions (``power_all``, ``itc_all`` ...) run the kernels on the
        card.

        events: an ``(E,)`` array of event sample indices, or an mne-style
            ``(E, 3)`` int array whose first column is the sample index; its
            third (event-id) column survives as ``.event_codes`` (filtered
            with the kept events), so ``split()`` partitions by condition.
        tmin / tmax: the window in seconds around each event, both end
            samples included (mne: ``n = round((tmax - tmin) * sfreq) + 1``).
        picks: optional channel names (only those rows are gathered).
        reject_spans: optional ``[(onset_s, duration_s), ...]``: events
            whose window overlaps a span are dropped.
        reject_annotations: optional text prefix (e.g. ``"bad"``): the spans
            come from the recording's EDF+ annotations (or BrainVision
            marker spans) too.
        codes: optional per-event codes (instead of an id column).

        Events whose window would cross either edge of the recording are
        dropped, as mne drops them.
        """
        ev = np.asarray(events)
        codes = None if codes is None else np.asarray(codes)
        if ev.ndim == 2:
            if codes is None and ev.shape[1] >= 3:
                codes = ev[:, 2].copy()          # mne event-id column
            ev = ev[:, 0]
        if codes is not None and codes.shape[0] != ev.shape[0]:
            raise ValueError("codes must have one entry per event")
        ev = ev.astype(np.int64)
        sf = self.wavelet.sfreq
        start = int(round(tmin * sf))
        n_win = int(round((tmax - tmin) * sf)) + 1
        ch_names = (list(picks) if picks is not None
                    else list(self.raw.ch_names))
        source = self._file_source(picks)
        if source is not None:
            n = int(source.n_samples)
        else:
            data = self._host_data()
            if picks is not None:
                idx = [self.raw.ch_names.index(ch) for ch in picks]
                data = data[idx]
            n = data.shape[-1]
        keep = (ev + start >= 0) & (ev + start + n_win <= n)
        spans = list(reject_spans) if reject_spans else []
        if reject_annotations is not None:
            spans += self._bad_spans(reject_annotations)
        if spans:
            lo = ev + start                       # window [lo, hi)
            hi = lo + n_win
            for onset_s, dur_s in spans:
                s0 = int(np.floor(float(onset_s) * sf))
                s1 = int(np.ceil((float(onset_s) + float(dur_s)) * sf))
                keep &= (hi <= s0) | (lo >= max(s1, s0 + 1))
        ev = ev[keep]
        if codes is not None:
            codes = codes[keep]
        if ev.size == 0:
            raise ValueError(
                "no event window fits inside the recording "
                f"(N={n}, window={n_win} samples at offset {start}"
                + (", after bad-span rejection" if spans else "") + ")")
        # One native gather builds the (E, C, Nw) batch: off the file mmap
        # for an EDF-backed recording, off the host snapshot otherwise
        # (halo 0: every kept window is interior, nothing is zero-padded).
        if source is not None:
            windows = source.gather(ev + start, n_win, 0)
        else:
            windows = f32_gather(data.reshape(-1, n), ev + start, n_win,
                                 0).reshape((len(ev),) + data.shape[:-1]
                                            + (n_win,))
        times = tmin + np.arange(n_win) / sf
        out = EpochsWavelet(
            ArrayEpochs(windows, sf, ch_names, times=times), self.wavelet)
        if codes is not None:
            out.event_codes = codes
        return out

    def itc(self, freqs: Numbers, events, tmin: float, tmax: float,
            picks=None) -> torch.Tensor:
        """(C, F, Nw) inter-trial coherence locked to ``events``
        (``self.epochs(...).itc_all``): ITC is defined only across repeated
        trials, so a continuous recording needs event markers."""
        return self.epochs(events, tmin, tmax, picks=picks).itc_all(freqs)

    def epoch_power(self, freqs: Numbers, events, tmin: float, tmax: float,
                    picks=None, **kw) -> torch.Tensor:
        """(C, F, Nw) event-locked epoch-mean power
        (``self.epochs(...).power_all``, with its ``baseline`` / ``decim``
        keywords)."""
        return self.epochs(events, tmin, tmax, picks=picks).power_all(
            freqs, **kw)

    def coherence(self, ch_a: str, ch_b: str, freqs: Numbers,
                  cycles: float = 1.0, scale_width: float = 0.6,
                  eps: float = 1e-12, return_phase: bool = False,
                  significance: int = 0, seed: int = 0):
        """(F, N) single-trial smoothed wavelet coherence between two
        channels of the recording (``ops.extensions.wavelet_coherence``),
        over the whole recording at once: O(F*N) device memory.
        ``significance=S`` appends the (F,) AR(1) Monte-Carlo levels of
        ``wtc_significance`` from S surrogates (real banks only), whose
        (S, F, N) stack must fit the device."""
        w = self.wavelet
        data = self._host_data()
        ia = self.raw.ch_names.index(ch_a)
        ib = self.raw.ch_names.index(ch_b)
        arr = w._check_freqs(freqs).numpy()
        bank = _bank.make_fft_bank(w._wdef(), arr, data.shape[-1], w.sfreq,
                                   w.interpolate, w.real_wave_length,
                                   device=w.device)
        sa = torch.from_numpy(np.ascontiguousarray(data[ia])).to(w.device)
        sb = torch.from_numpy(np.ascontiguousarray(data[ib])).to(w.device)
        out = _ext.wavelet_coherence(sa, sb, bank, arr, w.sfreq,
                                     interpolate=w.interpolate,
                                     cycles=cycles, scale_width=scale_width,
                                     eps=eps, return_phase=return_phase)
        if significance:
            if bank.is_complex():
                raise ValueError(
                    "significance levels need an analytic (real-bank) "
                    "family — the AR(1) null is built on the real bank "
                    "and would not match a Normal/Twice-mode estimator")
            thr = _ext.wtc_significance(
                data[ia], data[ib], bank, arr, w.sfreq,
                n_surrogates=int(significance), seed=seed,
                interpolate=w.interpolate, cycles=cycles,
                scale_width=scale_width, eps=eps)
            return (*(out if return_phase else (out,)), thr)
        return out
