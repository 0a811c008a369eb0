"""Plain PyTorch reference of what the benchmark's cells compute.

It is written from the published formulas (the generalized Morse wavelet,
the FFT-domain continuous wavelet transform, the epoch reductions, the
baseline z-score and the overlap-discard windows of a long recording),
computed in float64, and imports nothing of the measured program.  The same
code computed with bfloat16 storage (``Precision("bfloat16")``) is the
benchmark's control: a lower precision than the float32 the configurations
state, which the comparison has to refuse.
"""
from .cwt import (Precision, epochs_planes, halo_samples, morse_bank,
                  recording_power_blocks, window_geometry)

__all__ = ["Precision", "epochs_planes", "halo_samples", "morse_bank",
           "recording_power_blocks", "window_geometry"]
