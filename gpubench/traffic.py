"""The one generator of the benchmark's inputs.

A cell's ``traffic`` object (in ``workloads/<cell>.json``) gives:

* ``shape``: the array each call hands the program, time last: (epochs,
  channels, samples) or (channels, samples);
* ``pool``: how many such arrays are made; call ``i`` takes array
  ``i % pool``;
* ``noise_std``: white noise;
* ``tones``: sinusoids ``{"hz", "amp", "phase_jitter"}``, each with a phase
  drawn per row (every index but the last) uniformly in
  ``[-pi, pi] * phase_jitter``: 0 is phase-locked, 1 fully random;
* ``scale``: a factor on the sum (1e-5: tens of microvolts, in volts, as
  MNE hands EEG).

The arrays are made on ``device`` from ``seed`` with a ``torch.Generator``,
in float64, and handed back as host numpy float64 arrays, as
``mne.Epochs.get_data()`` and ``mne.io.Raw.get_data()`` hand them.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def make_pool(traffic: dict, sfreq: float, seed: int, device) -> list:
    shape = tuple(int(s) for s in traffic["shape"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2 ** 63)
    t = torch.arange(shape[-1], dtype=torch.float64, device=device) / sfreq
    pool = []
    for _ in range(int(traffic["pool"])):
        x = torch.randn(shape, generator=gen, dtype=torch.float64,
                        device=device)
        x *= float(traffic["noise_std"])
        for tone in traffic.get("tones", ()):
            phase = torch.rand(shape[:-1] + (1,), generator=gen,
                               dtype=torch.float64, device=device)
            phase = (2.0 * phase - 1.0) * (math.pi * tone["phase_jitter"])
            x += tone["amp"] * torch.sin(2.0 * math.pi * tone["hz"] * t
                                         + phase)
        x *= float(traffic["scale"])
        pool.append(x.cpu().numpy())
        del x
    return pool


def channel_seconds(traffic: dict, sfreq: float) -> float:
    """Channel-seconds of signal in one call's array (every index but the
    last counts as a channel)."""
    return float(np.prod(traffic["shape"])) / sfreq
