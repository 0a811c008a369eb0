from . import observability, tooltip
from .mne_adapter import ArrayEpochs, EpochsWavelet, RawWavelet
from .observability import CwtCost, Timer, cwt_cost, debug_nans, trace
from .plotting import plot_microstates, plot_tf, plot_topomap, plot_wavelet
from .report import Report
from .tooltip import (Parallel, Sequence, compose, dict_map, not_none,
                      oneline_csv)

__all__ = ["ArrayEpochs", "EpochsWavelet", "RawWavelet", "plot_tf",
           "plot_wavelet", "plot_topomap", "plot_microstates", "Report",
           "Parallel", "Sequence", "compose", "dict_map", "not_none",
           "oneline_csv", "Timer", "CwtCost", "cwt_cost", "debug_nans",
           "trace", "observability", "tooltip"]
