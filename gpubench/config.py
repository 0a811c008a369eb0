"""What the entries and cost counts read from a configuration file."""
from __future__ import annotations

import numpy as np


def freqs(config: dict) -> np.ndarray:
    """The analysis frequencies: ``count`` evenly from ``start`` to
    ``stop`` Hz."""
    f = config["freqs"]
    return np.linspace(f["start"], f["stop"], int(f["count"]))


def morse(config: dict) -> dict:
    """The Morse wavelet's ``b``, ``r`` and ``interpolate``."""
    w = config["wavelet"]
    if w["family"] != "Morse":
        raise ValueError(f"unsupported wavelet family {w['family']!r}")
    return {"b": float(w["b"]), "r": float(w["r"]),
            "interpolate": bool(w["interpolate"])}


def adapter(config: dict, traffic: dict) -> dict:
    """The adapter's settings: the configuration's defaults, overridden by
    those the traffic passes to the adapter."""
    return {**config.get("adapter", {}), **traffic.get("adapter", {})}
