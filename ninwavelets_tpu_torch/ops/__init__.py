"""Functional core in PyTorch: wavelet bank synthesis, the plain CWT and its
epoch reductions, the fused CUDA reductions and their gradients, gradient
fitting of frequency grids and banks, baseline correction, synchrosqueezing
and reassignment, the inverse CWT and denoising, ridges and modes, the
Torrence & Compo statistics, pair connectivity (coherence, imaginary
coherency, the phase slope index, PLV, PPC, the phase-lag family and the
all-pairs matrices), the rest of connectivity (partial coherence, the PSI
matrix, the Kuramoto order, n:m PLV, PAC and ERPAC, surrogate
significance, lagged coherence, bicoherence, the smoothed single-trial
wavelet coherence with its AR(1) levels, cross-frequency directionality,
wavelet entropy and envelope correlations), directed connectivity
(spectral Granger causality by Wilson factorization, pairwise and
conditional, DTF / PDC, trial-shuffle significance), graph measures over the
connectivity matrices, the statistics of single-trial planes (cluster
permutation tests, TFCE, the max-statistic correction, FDR, bootstrap
confidence bounds, oscillatory bursts), the Paul / DOG / Bump spectra,
multitaper Morse spectrograms and superlets, and the other transforms: the
MODWT / DWT with wavelet variance and shrinkage, wavelet packets and best
bases, the 2-D DWT, zero-phase filters and FFT resampling, the S-transform
and the directional 2-D CWT, and the decompositions: Welch spectra and
IRASA, specparam, the empirical wavelet transform, (multivariate) VMD with
instantaneous attributes and the Hilbert spectrum, EMD / EEMD, matching
pursuit, CP / PARAFAC, cycle-by-cycle features and HMM states, and
sensor-space preprocessing and decoding: peak-to-peak and cross-validated
trial rejection, regression of reference channels, PREP-style channel QC,
spherical-spline CSD and channel interpolation, FastICA, artifact subspace
reconstruction, spatial filters (covariances, Ledoit-Wolf, GED, CSP, SSD,
correlated components, xDAWN), Riemannian covariance geometry and
decoders, time-frequency / temporal-generalization / CSP decoding, CCA
SSVEP recognition and temporal response functions, and the rest: ERP
measures, entropy and DFA, sleep spindles and slow oscillations,
microstates, simulation and IAAFT surrogates, sphere leadfields and dipole
fits, LCMV / DICS beamformers and minimum-norm inverses.

As in the JAX package, ``ops.ewt`` and ``ops.vmd`` are the submodules: the
transforms are ``empirical_wavelet_transform``,
``variational_mode_decomposition`` and ``empirical_mode_decomposition``
(``ops.emd`` is the submodule too).  The bare ``csd`` function is not
exported either: it would shadow the ``ops.csd`` submodule; reach it as
``ops.csd.csd`` or through ``EpochsWavelet.csd``.  ``ops.sim`` stays a
submodule, as in the JAX package.
"""
from .asr import ASRModel, asr_calibrate, asr_process
from .bank import (WaveletDef, WaveletMode, make_fft_bank, make_fft_wavelet,
                   make_time_wavelet, pad_spectrum_to)
from .baseline import (Baseline, baseline_correct, baseline_of, baseline_tf,
                       METHODS as BASELINE_METHODS)
from .beamformer import (DICSResult, LCMVResult, MinimumNormResult, dics,
                         lcmv, lcmv_apply, minimum_norm, minimum_norm_apply,
                         source_coherence, wavelet_csd)
from .bootstrap import bootstrap_ci
from .bursts import (BurstSummary, burst_summary, burst_table,
                     burst_threshold)
from .cluster import (ClusterResult, TfceResult, cluster_mass,
                      cluster_test_f, cluster_test_independent,
                      cluster_test_one_sample, cluster_test_paired,
                      cluster_test_regression, f_oneway, f_threshold,
                      fdr_correction, label_components,
                      max_stat_test_independent, max_stat_test_one_sample,
                      max_stat_test_regression, t_independent, t_one_sample,
                      t_regression, t_threshold, tfce_map,
                      tfce_test_independent, tfce_test_one_sample)
from .complexity import (dfa, multiscale_entropy,
                         multiscale_permutation_entropy,
                         permutation_entropy, sample_entropy)
from .cpd import cp_decompose, cp_reconstruct
from .csd import (csd_transform, interpolate_channels,
                  interpolation_matrix, spline_matrices)
from .cwt2d import cwt2, morlet2d_bank, pow2_pad2, power2d
from .cycles import CycleTable, cycle_features
from .cwt import (abs_from_bank, analytic_spectrum, cwt_from_bank,
                  itc_from_bank, mean_power_from_bank, power_from_bank,
                  power_itc_from_bank)
from .connectivity import (PAC_METHODS, PHASE_LAG_METHODS,
                           coherence_matrix, coherence_matrix_from_bank,
                           erpac, erpac_from_banks, kuramoto_order,
                           kuramoto_order_from_bank, lagged_coherence,
                           lagged_coherence_morse, nm_plv, nm_plv_from_bank,
                           nm_plv_sums, pac, pac_from_banks,
                           pac_mean_from_banks, pac_pair,
                           pac_pair_from_banks, pac_pair_mean,
                           pac_significance, pair_matrix_scan,
                           partial_coherence, partial_coherence_from_bank,
                           partial_coherence_per_row, phase_lag,
                           phase_lag_auto, phase_lag_from_bank,
                           phase_lag_from_sums, phase_lag_significance,
                           phase_lag_sums, plv, plv_auto, plv_from_bank,
                           plv_matrix, plv_matrix_from_bank,
                           plv_significance, plv_sums, ppc, ppc_auto,
                           ppc_from_bank, ppc_matrix, ppc_matrix_from_bank,
                           psi_matrix, psi_matrix_from_bank, psi_reps_scan,
                           roll_epochs, surrogate_pvalues,
                           surrogate_pvalues_from_shifts, surrogate_shifts,
                           wpli_matrix, wpli_matrix_from_bank)
from .dwt import (imodwt, max_level, modwt, modwt_corr, modwt_cov,
                  modwt_denoise, modwt_mra, modwt_var, modwt_var_ci,
                  pow2_pad, wavedec, waverec, wavelet_filter)
from .dwt2d import dwt2, idwt2, max_level2, wavedec2, waverec2
from .emd import eemd
from .emd import emd as empirical_mode_decomposition
from .envelope import env_corr_matrix, env_corr_matrix_from_bank
from .erp import (PeakResult, evoked, fractional_area_latency,
                  fractional_peak_onset, jackknife_onsets, mean_amplitude,
                  peak_measures)
from .ewt import ewt_boundaries, ewt_filterbank, ewt_reconstruct
from .ewt import ewt as empirical_wavelet_transform
from .extensions import (ar1_filter, bicoherence, bicoherence_from_banks,
                         bump_spectrum, cfd, cfd_from_banks,
                         coherence_from_sums, coherence_sums,
                         cross_power_from_bank, dog_spectrum,
                         epoch_coherence, epoch_coherence_auto,
                         epoch_coherence_from_bank, imcoh, imcoh_auto,
                         imcoh_from_bank, imcoh_from_sums, paul_spectrum,
                         psi, psi_from_bank, psi_from_sums, row_quantile,
                         wavelet_coherence, wavelet_coherence_from_bank,
                         wavelet_entropy, wtc_significance)
from .filtering import bandpass, highpass, lowpass, notch, resample
from .fit import fit_frequencies, learn_bank
from .granger import (conditional_granger, dtf_pdc, granger_from_factors,
                      spectral_granger_pairwise, uniform_freqs,
                      wavelet_conditional_granger, wavelet_dtf_pdc,
                      wavelet_granger, wavelet_granger_significance,
                      wilson_factorize)
from .graph import (char_path_length, clustering_onnela, global_efficiency,
                    modularity_communities, shortest_paths, small_worldness,
                    strength)
from .grids import (analytic_mask, fft_bin_freqs, log_freqs,
                    reverse_timeline, wavelet_timeline)
from .decoding import (cca_reference, csp_decode, decode_auc,
                       ssvep_cca, temporal_generalization, tf_decode)
from .denoise import denoise_from_bank
from .fused import (fused_coherence, fused_coherence_sums,
                    fused_epoch_coherence, fused_imcoh, fused_itc_from_bank,
                    fused_mean_power_from_bank, fused_phase_lag,
                    fused_phase_lag_sums, fused_plv, fused_plv_sums,
                    fused_ppc,
                    fused_power_from_bank, fused_power_itc_from_bank,
                    fused_ssq_mean_power, fused_ssq_power_from_bank,
                    itc_auto, mean_power_auto, mean_power_bwd, power_auto,
                    power_itc_auto, supports, supports_ssq, why_not,
                    why_not_ssq)
from .hmm import HMMResult, hmm_fit, viterbi
from .ica import (ICAResult, fastica, ica_find_bads, ica_kurtosis,
                  ica_remove, ica_scores, ica_transform)
from .icwt import coverage, icwt_from_bank
from .irasa import IrasaResult, aperiodic_fit, irasa, welch_psd
from .leadfield import (fibonacci_electrodes, fit_dipole,
                        fit_dipole_evoked, fit_dipole_meg, source_grid,
                        sphere_leadfield, sphere_leadfield_meg)
from .microstates import (MicrostateResult, gfp, microstate_backfit,
                          microstate_fit, microstate_stats,
                          microstate_syntax_test)
from .mp import MPResult, gabor_dictionary, matching_pursuit, mp_tfr
from .multitaper import (morse_taper_def, multitaper_banks,
                         multitaper_coherence_matrix, multitaper_mean_power,
                         multitaper_partial_coherence, multitaper_power,
                         multitaper_power_from_banks)
from .reassign import reassigned_mean_power, reassigned_power
from .reject import (RejectResult, autoreject_global,
                     find_bad_channels, ptp, ptp_reject, regress_out)
from .riemann import (epoch_covariances, mdm_decode,
                      riemannian_distance, riemannian_mean,
                      spd_expm, spd_logm, spd_sqrtm,
                      tangent_decode, tangent_space)
from .ridge import (extract_modes, extract_modes_ri, extract_ridge,
                    ridge_frequencies)
from .sleep import EventTable, detect_slow_oscillations, detect_spindles
from .specparam import (SpectralFit, aperiodic_model, peaks_model,
                        specparam)
from .spatial import (SpatialResult, corrca, covariance, csp,
                      csp_features, ged, ledoit_wolf, spatial_apply,
                      ssd, xdawn)
from .signal_utils import (SizeError, hamming_window, interpolate_alias,
                           normalize, pad_last_axis_to, pad_to)
from .sst import (ssq_mean_power, ssq_mean_power_from_bank, ssq_power,
                  ssq_power_from_bank, uniform_grid_hint)
from .stockwell import istockwell, stockwell
from .superlets import (superlet_banks, superlet_mean_power, superlet_power,
                        superlet_power_from_banks, superlet_weights)
from .trf import (TRFResult, lagged_design, trf_cv, trf_fit,
                  trf_predict)
from .vmd import hilbert_spectrum, instantaneous, mvmd
from .vmd import vmd as variational_mode_decomposition
from .wpt import (best_basis, best_basis_reconstruct, imodwpt, modwpt,
                  node_band)
