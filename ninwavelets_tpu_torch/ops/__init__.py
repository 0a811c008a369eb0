"""Functional core in PyTorch: wavelet bank synthesis, the plain CWT and its
epoch reductions, the fused CUDA reductions and their gradients, gradient
fitting of frequency grids and banks, baseline correction, synchrosqueezing
and reassignment, the inverse CWT and denoising, ridges and modes, the
Torrence & Compo statistics, pair connectivity (coherence, imaginary
coherency, the phase slope index, PLV, PPC, the phase-lag family and the
all-pairs matrices), the Paul / DOG / Bump spectra, multitaper Morse
spectrograms and superlets.
"""
from .bank import (WaveletDef, WaveletMode, make_fft_bank, make_fft_wavelet,
                   make_time_wavelet)
from .baseline import (Baseline, baseline_correct, baseline_of, baseline_tf,
                       METHODS as BASELINE_METHODS)
from .cwt import (abs_from_bank, analytic_spectrum, cwt_from_bank,
                  itc_from_bank, mean_power_from_bank, power_from_bank)
from .connectivity import (PHASE_LAG_METHODS, coherence_matrix,
                           coherence_matrix_from_bank, pair_matrix_scan,
                           phase_lag, phase_lag_auto, phase_lag_from_bank,
                           phase_lag_from_sums, phase_lag_sums, plv,
                           plv_auto, plv_from_bank, plv_matrix,
                           plv_matrix_from_bank, plv_sums, ppc, ppc_auto,
                           ppc_from_bank, ppc_matrix, ppc_matrix_from_bank,
                           wpli_matrix, wpli_matrix_from_bank)
from .extensions import (bump_spectrum, coherence_from_sums,
                         coherence_sums, cross_power_from_bank,
                         dog_spectrum, epoch_coherence,
                         epoch_coherence_auto, epoch_coherence_from_bank,
                         imcoh, imcoh_auto, imcoh_from_bank, imcoh_from_sums,
                         paul_spectrum, psi, psi_from_bank, psi_from_sums)
from .fit import fit_frequencies, learn_bank
from .denoise import denoise_from_bank
from .fused import (fused_coherence, fused_coherence_sums,
                    fused_epoch_coherence, fused_imcoh, fused_itc_from_bank,
                    fused_mean_power_from_bank, fused_phase_lag,
                    fused_phase_lag_sums, fused_plv, fused_plv_sums,
                    fused_ppc,
                    fused_power_from_bank, fused_power_itc_from_bank,
                    fused_ssq_mean_power, fused_ssq_power_from_bank,
                    itc_auto, mean_power_auto, mean_power_bwd, power_auto,
                    power_itc_auto, supports, supports_ssq)
from .icwt import coverage, icwt_from_bank
from .multitaper import (morse_taper_def, multitaper_banks,
                         multitaper_coherence_matrix, multitaper_mean_power,
                         multitaper_power, multitaper_power_from_banks)
from .reassign import reassigned_mean_power, reassigned_power
from .ridge import (extract_modes, extract_modes_ri, extract_ridge,
                    ridge_frequencies)
from .signal_utils import SizeError, pad_last_axis_to, pad_to
from .sst import (ssq_mean_power, ssq_mean_power_from_bank, ssq_power,
                  ssq_power_from_bank, uniform_grid_hint)
from .superlets import (superlet_banks, superlet_mean_power, superlet_power,
                        superlet_power_from_banks, superlet_weights)
