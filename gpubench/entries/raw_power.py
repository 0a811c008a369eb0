"""Entry ``raw_power``: the long-recording path as users call it.

Each call wraps one (C, N) float64 recording in a new ``mne.io.Raw``-like
container, builds a new ``RawWavelet(raw, morse, **adapter)`` (the traffic
passes only the settings it changes; none at the defaults) and runs
``.power(freqs)``: the (C, F, N) power plane on the device, streamed in
overlap-discard windows.

Compared with the float64 reference over the whole plane: ``power_err``,
the widest gap of a (channel, frequency) row over that row's peak.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from .. import compare, config as cfg, traffic
from ..reference import Precision, recording_power_blocks


class ArrayRaw:
    """The ``mne.io.Raw`` surface ``RawWavelet`` reads: ``info['sfreq']``,
    ``ch_names`` and ``get_data()``, which hands float64 as MNE does."""

    def __init__(self, data, sfreq: float) -> None:
        self._data = data
        self.info = {"sfreq": sfreq}
        self.ch_names = [f"EEG{i:03d}" for i in range(data.shape[0])]

    def get_data(self):
        return self._data


class Entry:
    def __init__(self, config: dict, cell: dict, seed: int, device) -> None:
        import ninwavelets_tpu_torch as nt
        self.nt = nt
        self.device = torch.device(device)
        self.sfreq = float(config["sfreq"])
        self.freqs = cfg.freqs(config)
        self.morse = cfg.morse(config)
        t = cell["traffic"]
        if t["shape"][0] != config["channels"]:
            raise ValueError("the traffic's channels differ from the "
                             "configuration's")
        self.kwargs = dict(t.get("adapter", {}))
        self.geometry = cfg.adapter(config, t)
        self.pool = traffic.make_pool(t, self.sfreq, seed, self.device)
        self.channel_seconds = traffic.channel_seconds(t, self.sfreq)
        self.wavelet = nt.Morse(self.sfreq, self.morse["b"], self.morse["r"],
                                interpolate=self.morse["interpolate"],
                                device=self.device)

    def call(self, i: int):
        key = i % len(self.pool)
        with record_function("RawWavelet"):
            rw = self.nt.RawWavelet(ArrayRaw(self.pool[key], self.sfreq),
                                    self.wavelet, **self.kwargs)
        with record_function("RawWavelet.power"):
            return key, rw.power(self.freqs)

    def release(self) -> None:
        self.wavelet = None

    def _reference(self, key: int, prec: Precision):
        return recording_power_blocks(
            self.pool[key], self.freqs, self.sfreq, self.morse["b"],
            self.morse["r"], self.morse["interpolate"],
            int(self.geometry["window"]), float(self.geometry["halo_tol"]),
            prec, self.device)

    def numbers(self, key: int, output) -> dict:
        err = compare.RowErrors(tuple(output.shape[:2]), self.device)
        for sel, t0, t1, ref in self._reference(key, Precision()):
            err.add(sel, output[sel, :, t0:t1], ref)
        return {"power_err": err.relative()}

    def control(self, key: int):
        c, n = self.pool[key].shape
        out = torch.empty(c, len(self.freqs), n, dtype=torch.float32,
                          device=self.device)
        for sel, t0, t1, p in self._reference(key, Precision("bfloat16")):
            out[sel, :, t0:t1] = p
        return out
