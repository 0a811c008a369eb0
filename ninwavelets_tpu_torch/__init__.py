"""ninwavelets_tpu_torch — the analytic-wavelet transform engine in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper.

A port of ``ninwavelets_tpu`` (JAX), which stays beside it as the reference;
this package imports neither ``jax`` nor ``ninwavelets_tpu``.  It covers the
main path so far: the Morse / Morlet / MexicanHat / Shannon / Haar banks, the
CWT and its epoch reductions (epoch-mean power, inter-trial coherence, both
off one pass), baseline correction, the ``EpochsWavelet`` adapter, the
training path (``learn_bank``, ``fit_frequencies``), and the long-recording
path (``RawWavelet``, ``parallel.StreamingCWT`` / ``OnlineCWT``, the EDF
reader in ``io``, and ``scattering``), and the synchrosqueezing path
(``ssq_power`` on the wavelet classes, ``EpochsWavelet.ssq_power_all``,
``RawWavelet.ssq_power``, ``StreamingCWT.ssq_power_device``) with the
reassignment, inverse-CWT, denoising, ridge and Torrence & Compo extensions
in ``ops``.  On a CUDA tensor the epoch reductions and the per-signal power
run the fused kernels of ``csrc/fused_cwt.cu``, the power's gradient the
fused backward of ``csrc/fused_cwt_bwd.cu``, and synchrosqueezing on a
single "lin" or "log" grid the "amax" epilogue and ``csrc/fused_ssq.cu``;
on the CPU they run the plain ``torch.fft`` path.
Entry points place their data on the card unless the caller passes
``device="cpu"``.
"""
from . import convert, io, kernels, ops, parallel
from .models import (Haar, MexicanHat, Morlet, Morse, Shannon, WaveletBase,
                     WaveletMode)
from .ops.baseline import Baseline, baseline_correct, baseline_tf
from .ops.fit import fit_frequencies, learn_bank
from .parallel import OnlineCWT, StreamingCWT
from .utils import ArrayEpochs, EpochsWavelet, RawWavelet

__version__ = "0.1.0"

__all__ = [
    "WaveletBase", "WaveletMode", "Baseline",
    "Morse", "Morlet", "Haar", "MexicanHat", "Shannon",
    "ArrayEpochs", "EpochsWavelet", "RawWavelet", "StreamingCWT",
    "OnlineCWT",
    "baseline_correct", "baseline_tf", "fit_frequencies", "learn_bank",
    "ops", "kernels", "convert", "io", "parallel",
]
