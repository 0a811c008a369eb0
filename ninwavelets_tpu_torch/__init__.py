"""ninwavelets_tpu_torch — the analytic-wavelet transform engine in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper.

A port of ``ninwavelets_tpu`` (JAX), which stays beside it as the reference;
this package imports neither ``jax`` nor ``ninwavelets_tpu``.  It covers the
main path so far: the Morse / Morlet / MexicanHat / Shannon / Haar banks and
the rest of the zoo (Paul, DOG, Bump, the multitaper Morse family, superlets,
``MorseMNE`` where mne is installed), the CWT and its epoch reductions
(epoch-mean power, inter-trial coherence, both off one pass), baseline
correction, the ``EpochsWavelet`` adapter, the
training path (``learn_bank``, ``fit_frequencies``), and the long-recording
path (``RawWavelet``, ``parallel.StreamingCWT`` / ``OnlineCWT``, the EDF
reader in ``io``, and ``scattering``), and the synchrosqueezing path
(``ssq_power`` on the wavelet classes, ``EpochsWavelet.ssq_power_all``,
``RawWavelet.ssq_power``, ``StreamingCWT.ssq_power_device``) with the
reassignment, inverse-CWT, denoising, ridge and Torrence & Compo extensions
in ``ops``, and pair connectivity (coherence, imaginary coherency, PLV,
PPC, PLI / wPLI / debiased wPLI^2, the phase slope index in ``ops``; the
all-pairs matrices; the ``EpochsWavelet`` pair and matrix methods), the rest
of connectivity, directed connectivity (spectral Granger causality, DTF /
PDC) and graph measures (``EpochsWavelet.granger`` / ``network``), and
event-locked epochs of a recording (``RawWavelet.epochs``), the statistics
of single-trial planes, and the other transforms (MODWT / DWT and
shrinkage, wavelet packets, the 2-D DWT, zero-phase filters and
resampling, the S-transform and the directional 2-D CWT in ``ops``, with
``EpochsWavelet.tfr_power2d`` / ``modwt_denoise`` and
``RawWavelet.filter`` / ``resample``), and the decompositions (Welch and
IRASA, specparam, EWT, VMD, EMD / EEMD, matching pursuit, CP / PARAFAC,
cycle features and HMM states in ``ops``, with
``EpochsWavelet.specparam`` / ``cp_power`` / ``matching_pursuit`` /
``cycles`` / ``psd`` and ``RawWavelet.states`` / ``specparam`` /
``irasa`` / ``psd``), sensor-space preprocessing and decoding, ERP,
complexity, sleep, microstate, simulation and source modules, the BDF and
BrainVision readers (``RawWavelet.from_bdf`` / ``from_brainvision`` /
``epochs_from_markers``), the one-call pipeline (``config.run_pipeline``)
and the utilities (``utils.observability``, ``tooltip``, ``report``; the
plots need matplotlib, imported only when one is drawn).  On a
CUDA tensor the epoch reductions (for real and complex banks) and the
per-signal power run the fused kernels of ``csrc/fused_cwt.cu``, the power's
gradient the fused backward of ``csrc/fused_cwt_bwd.cu`` (real and complex
banks), synchrosqueezing on a single "lin" or "log"
grid the "amax" epilogue and ``csrc/fused_ssq.cu``, and the pair
statistics of (E, C, N) pair batches ``csrc/fused_pair.cu``; on the CPU
they run the plain ``torch.fft`` path.
Entry points place their data on the card unless the caller passes
``device="cpu"``.
"""
from . import config, convert, io, kernels, ops, parallel
from .models import (DOG, Bump, Haar, MexicanHat, Morlet, Morse, MorseMNE,
                     MorseMultitaper, Paul, Shannon, Superlet, WaveletBase,
                     WaveletMode)
from .ops.baseline import Baseline, baseline_correct, baseline_tf
from .ops.ewt import ewt
from .ops.fit import fit_frequencies, learn_bank
from .ops.vmd import vmd
from .parallel import OnlineCWT, StreamingCWT
from .utils import (ArrayEpochs, EpochsWavelet, Parallel, RawWavelet, Report,
                    Sequence, compose, dict_map, plot_microstates, plot_tf,
                    plot_topomap, plot_wavelet)

__version__ = "0.1.0"

__all__ = [
    "WaveletBase", "WaveletMode", "plot_tf", "plot_topomap",
    "plot_microstates", "Report", "Baseline",
    "Morse", "MorseMNE", "Morlet", "Haar", "MexicanHat", "Shannon",
    "Paul", "DOG", "Bump", "Superlet", "MorseMultitaper",
    "ArrayEpochs", "EpochsWavelet", "RawWavelet", "StreamingCWT",
    "OnlineCWT",
    "plot_wavelet", "baseline_correct", "baseline_tf", "fit_frequencies",
    "learn_bank", "Parallel", "Sequence", "compose", "dict_map",
    "ewt", "vmd",
    "ops", "config", "kernels", "convert", "io", "parallel",
]
