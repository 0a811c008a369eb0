"""ninwavelets_tpu_torch — the analytic-wavelet transform engine in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper.

A port of ``ninwavelets_tpu`` (JAX), which stays beside it as the reference;
this package imports neither ``jax`` nor ``ninwavelets_tpu``.  It covers the
main path so far: the Morse / Morlet / MexicanHat / Shannon / Haar banks, the
CWT and its epoch reductions (epoch-mean power, inter-trial coherence, both
off one pass), baseline correction, and the ``EpochsWavelet`` adapter.  On a
CUDA tensor the epoch reductions run the fused kernel of
``csrc/fused_cwt.cu``; on the CPU they run the plain ``torch.fft`` path.
"""
from . import convert, kernels, ops
from .models import (Haar, MexicanHat, Morlet, Morse, Shannon, WaveletBase,
                     WaveletMode)
from .ops.baseline import Baseline, baseline_correct, baseline_tf
from .utils import ArrayEpochs, EpochsWavelet

__version__ = "0.1.0"

__all__ = [
    "WaveletBase", "WaveletMode", "Baseline",
    "Morse", "Morlet", "Haar", "MexicanHat", "Shannon",
    "ArrayEpochs", "EpochsWavelet",
    "baseline_correct", "baseline_tf", "ops", "kernels", "convert",
]
