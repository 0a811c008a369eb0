"""MNE ingestion (port of the core of ``ninwavelets_tpu.utils.mne_adapter``):
``EpochsWavelet`` and ``ArrayEpochs`` for epoched data, ``RawWavelet`` for
continuous recordings.

For epochs the whole (epochs, channels, time) block moves to the wavelet's
device once; the epoch reductions run through ``ops.fused`` (the CUDA kernel
on the card, the plain path on the CPU).  A continuous recording streams
through ``parallel.StreamingCWT`` in overlap-discard windows.  Both need
only the duck-typed MNE surface ``.info['sfreq']``, ``.ch_names`` and
``.get_data()``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..io.edf import EDFRaw
from ..io.stream import EDFSource
from ..models.base import Numbers, WaveletBase
from ..ops.baseline import baseline_tf
from ..ops.cwt import cwt_from_bank
from ..ops.fused import itc_auto, mean_power_auto, power_itc_auto
from ..ops.signal_utils import pad_to
from ..parallel.streaming import StreamingCWT


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
        fp = self._fingerprint()
        if getattr(self, '_fp', None) != fp:
            self.invalidate()
            self._fp = fp
        if not hasattr(self, '_host'):
            self._host = np.asarray(self.epochs.get_data()).astype(
                np.float32)
        return self._host

    def _channel_data(self, ch_name: str) -> torch.Tensor:
        # Slice on the host so one channel moves only (E, N).
        idx = self.epochs.ch_names.index(ch_name)
        return torch.from_numpy(np.ascontiguousarray(
            self._host_data()[:, idx, :])).to(self.wavelet.device)

    def _all_data(self) -> torch.Tensor:
        """Device copy of the full (E, C, N) block (cached, invalidated with
        the host snapshot)."""
        host = self._host_data()
        if not hasattr(self, '_data'):
            self._data = torch.from_numpy(host).to(self.wavelet.device)
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
        (plain slicing AFTER the transform)."""
        if baseline is not None:
            tf = baseline_tf(tf, sfreq, baseline[0], baseline[1],
                             baseline_method)
        if decim and decim != 1:
            tf = tf[..., ::int(decim)]
        return tf

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
        ``.get_data() -> (C, N)``), or ``io.EDFRaw``.
    wavelet: a ``WaveletBase``; its ``sfreq`` is overwritten from
        ``raw.info`` and its ``device`` places the planes.
    window / halo / batch: see ``StreamingCWT`` (the halo defaults from the
        wavelet's envelope decay at the lowest analysis frequency; the
        extended window is rounded up to a power of two).  The fused kernel
        takes extended windows up to 16384 samples: the default window of
        16384 extends past that and runs the plain path on the card.
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

    def invalidate(self) -> None:
        """Drop the cached ``get_data()`` snapshot and streams: call after
        mutating the raw object (crop, filter)."""
        for attr in ('_host', '_streams'):
            if hasattr(self, attr):
                delattr(self, attr)

    def _host_data(self) -> np.ndarray:
        """Host copy of ``raw.get_data()``, fetched once."""
        if not hasattr(self, '_host'):
            self._host = np.asarray(self.raw.get_data(), np.float32)
        return self._host

    def _file_source(self, picks=None):
        """An ``io.stream`` source gathering straight off the file mmap
        when the raw object is EDF-backed (``io.EDFRaw``), else None."""
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
