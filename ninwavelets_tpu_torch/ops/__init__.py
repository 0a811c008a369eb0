"""Functional core in PyTorch: wavelet bank synthesis, the plain CWT and its
epoch reductions, the fused CUDA reductions, and baseline correction.
"""
from .bank import (WaveletDef, WaveletMode, make_fft_bank, make_fft_wavelet,
                   make_time_wavelet)
from .baseline import (Baseline, baseline_correct, baseline_of, baseline_tf,
                       METHODS as BASELINE_METHODS)
from .cwt import (abs_from_bank, analytic_spectrum, cwt_from_bank,
                  itc_from_bank, mean_power_from_bank, power_from_bank)
from .fused import (fused_itc_from_bank, fused_mean_power_from_bank,
                    fused_power_itc_from_bank, itc_auto, mean_power_auto,
                    power_itc_auto, supports)
from .signal_utils import SizeError, pad_last_axis_to, pad_to
