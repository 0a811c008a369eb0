"""Entry ``epochs_power_itc``: the MNE epochs main path.

Each call wraps one (E, C, N) float64 batch in a new ``ArrayEpochs``, runs
``EpochsWavelet(epochs, morse).power_itc_all(freqs)`` and z-scores the
power against its baseline with ``baseline_tf``.  The ``Morse`` instance
lives across calls, so its bank stays cached, as a user's would.  The
output is the z-scored epoch-mean power and the inter-trial coherence.

Compared with the float64 reference: ``zpower_err``, the widest gap of a
(channel, frequency) row of the z-scored power over that row's peak, and
``itc_err``, the widest gap of the coherence (which lies in [0, 1]).
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from .. import compare, config as cfg, traffic
from ..reference import Precision, epochs_planes


class Entry:
    def __init__(self, config: dict, cell: dict, seed: int, device) -> None:
        import ninwavelets_tpu_torch as nt
        self.nt = nt
        self.device = torch.device(device)
        self.sfreq = float(config["sfreq"])
        self.freqs = cfg.freqs(config)
        self.morse = cfg.morse(config)
        base = config["baseline"]
        self.baseline = (float(base["start_s"]), float(base["stop_s"]))
        if base["method"] != "zscore":
            raise ValueError("the entry z-scores its baseline")
        t = cell["traffic"]
        if t["shape"][1] != config["channels"]:
            raise ValueError("the traffic's channels differ from the "
                             "configuration's")
        self.pool = traffic.make_pool(t, self.sfreq, seed, self.device)
        self.channel_seconds = traffic.channel_seconds(t, self.sfreq)
        self.wavelet = nt.Morse(self.sfreq, self.morse["b"], self.morse["r"],
                                interpolate=self.morse["interpolate"],
                                device=self.device)

    def call(self, i: int):
        key = i % len(self.pool)
        nt = self.nt
        with record_function("ArrayEpochs + EpochsWavelet"):
            ew = nt.EpochsWavelet(nt.ArrayEpochs(self.pool[key], self.sfreq),
                                  self.wavelet)
        with record_function("EpochsWavelet.power_itc_all"):
            power, itc = ew.power_itc_all(self.freqs)
        with record_function("baseline_tf"):
            zpower = nt.baseline_tf(power, self.sfreq, *self.baseline,
                                    "zscore")
        return key, (zpower, itc)

    def release(self) -> None:
        self.wavelet = None

    def _reference(self, key: int, prec: Precision):
        return epochs_planes(self.pool[key], self.freqs, self.sfreq,
                             self.morse["b"], self.morse["r"],
                             self.morse["interpolate"], self.baseline, prec,
                             self.device)

    def numbers(self, key: int, output) -> dict:
        zpower, itc = output
        rows = tuple(zpower.shape[:2])
        z_err = compare.RowErrors(rows, self.device)
        i_err = compare.RowErrors(rows, self.device)
        for sel, z_ref, itc_ref in self._reference(key, Precision()):
            z_err.add(sel, zpower[sel], z_ref)
            i_err.add(sel, itc[sel], itc_ref)
        return {"zpower_err": z_err.relative(), "itc_err": i_err.absolute()}

    def control(self, key: int):
        planes = list(self._reference(key, Precision("bfloat16")))
        return (torch.cat([z for _, z, _ in planes]),
                torch.cat([i for _, _, i in planes]))
