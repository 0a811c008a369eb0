"""Functional core in PyTorch: wavelet bank synthesis, the plain CWT and its
epoch reductions, the fused CUDA reductions and their gradients, gradient
fitting of frequency grids and banks, baseline correction, synchrosqueezing
and reassignment, the inverse CWT and denoising, ridges and modes, and the
Torrence & Compo statistics.
"""
from .bank import (WaveletDef, WaveletMode, make_fft_bank, make_fft_wavelet,
                   make_time_wavelet)
from .baseline import (Baseline, baseline_correct, baseline_of, baseline_tf,
                       METHODS as BASELINE_METHODS)
from .cwt import (abs_from_bank, analytic_spectrum, cwt_from_bank,
                  itc_from_bank, mean_power_from_bank, power_from_bank)
from .fit import fit_frequencies, learn_bank
from .denoise import denoise_from_bank
from .fused import (fused_itc_from_bank, fused_mean_power_from_bank,
                    fused_power_from_bank, fused_power_itc_from_bank,
                    fused_ssq_mean_power, fused_ssq_power_from_bank,
                    itc_auto, mean_power_auto, mean_power_bwd, power_auto,
                    power_itc_auto, supports, supports_ssq)
from .icwt import coverage, icwt_from_bank
from .reassign import reassigned_mean_power, reassigned_power
from .ridge import (extract_modes, extract_modes_ri, extract_ridge,
                    ridge_frequencies)
from .signal_utils import SizeError, pad_last_axis_to, pad_to
from .sst import (ssq_mean_power, ssq_mean_power_from_bank, ssq_power,
                  ssq_power_from_bank, uniform_grid_hint)
