"""Cost of one ``epochs_power_itc`` call: E x C forward transforms of N
points, E x C x F inverse ones; the (E, C, N) signal and the (F, N) bank
(its lower half on the analytic path) read, two (C, F, N) planes
(z-scored power, coherence) written."""
from . import fft_flops
from .. import config as cfg


def cost(config: dict, traffic: dict) -> dict:
    e, c, n = traffic["shape"]
    f = len(cfg.freqs(config))
    bank = 0.5 if cfg.morse(config)["interpolate"] else 1.0
    flops = e * c * (0.5 * fft_flops(n) + f * fft_flops(n))
    hbm = 4.0 * (e * c * n + bank * f * n + 2 * c * f * n)
    return {"flops": flops, "bytes": hbm}
