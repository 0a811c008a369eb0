"""Cost of one ``raw_power`` call: ceil(N / window) windows a channel, each
transformed at the extended length that the halo rule of
``gpubench.reference`` gives (forward once, inverse for every row); the
(C, N) recording and the bank read, the (C, F, N) plane written."""

from . import fft_flops
from .. import config as cfg
from ..reference import halo_samples, window_geometry


def cost(config: dict, traffic: dict) -> dict:
    c, n = traffic["shape"]
    freqs = cfg.freqs(config)
    f = len(freqs)
    m = cfg.morse(config)
    geo = cfg.adapter(config, traffic)
    window = int(geo["window"])
    _, ext, starts = window_geometry(
        n, window, halo_samples(m["b"], m["r"], float(freqs.min()),
                                float(config["sfreq"]),
                                float(geo["halo_tol"])))
    bank = 0.5 if m["interpolate"] else 1.0
    flops = len(starts) * c * (0.5 * fft_flops(ext) + f * fft_flops(ext))
    hbm = 4.0 * (c * n + bank * f * ext + c * f * n)
    return {"flops": flops, "bytes": hbm}
