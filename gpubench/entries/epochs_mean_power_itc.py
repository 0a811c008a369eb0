"""Entry ``epochs_mean_power_itc``: the call of ``epochs_power_itc`` (a
new ``ArrayEpochs``, ``EpochsWavelet.power_itc_all``, the ``baseline_tf``
z-score), compared before the z-score.

The output is the epoch-mean power, its z-score and the inter-trial
coherence.  Compared with the float64 reference: ``power_err``, the
widest gap of a (channel, frequency) row of the epoch-mean power over that
row's peak, and ``itc_err``, the widest gap of the coherence.  The
z-scored plane is not compared: where a row's baseline std is small next
to its mean (the 1 Hz row under a 0.2 s baseline), the z-score divides the
power's float32 round-off by that std, and its gap says more of the row
than of the program.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from .. import compare
from ..reference import Precision
from ..reference.epoch_power import epochs_power_planes
from . import epochs_power_itc


class Entry(epochs_power_itc.Entry):
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
        return key, (power, zpower, itc)

    def _planes(self, key: int, prec: Precision):
        return epochs_power_planes(self.pool[key], self.freqs, self.sfreq,
                                   self.morse["b"], self.morse["r"],
                                   self.morse["interpolate"], prec,
                                   self.device)

    def numbers(self, key: int, output) -> dict:
        power, _, itc = output
        rows = tuple(power.shape[:2])
        p_err = compare.RowErrors(rows, self.device)
        i_err = compare.RowErrors(rows, self.device)
        for sel, p_ref, itc_ref in self._planes(key, Precision()):
            p_err.add(sel, power[sel], p_ref)
            i_err.add(sel, itc[sel], itc_ref)
        return {"power_err": p_err.relative(), "itc_err": i_err.absolute()}

    def control(self, key: int):
        planes = list(self._planes(key, Precision("bfloat16")))
        return (torch.cat([p for _, p, _ in planes]), None,
                torch.cat([i for _, _, i in planes]))
