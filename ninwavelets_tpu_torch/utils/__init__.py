from . import observability, tooltip
from .observability import (CwtCost, Timer, cwt_cost, debug_nans, span,
                            trace)
from .plotting import plot_microstates, plot_tf, plot_topomap, plot_wavelet
from .report import Report
from .tooltip import (Parallel, Sequence, compose, dict_map, not_none,
                      oneline_csv)

__all__ = ["ArrayEpochs", "EpochsWavelet", "RawWavelet", "plot_tf",
           "plot_wavelet", "plot_topomap", "plot_microstates", "Report",
           "Parallel", "Sequence", "compose", "dict_map", "not_none",
           "oneline_csv", "Timer", "CwtCost", "cwt_cost", "debug_nans",
           "trace", "span", "observability", "tooltip"]

#: The adapters, loaded on first use: they import most of the package,
#: whose modules import ``observability`` (``span``) from here.
_ADAPTERS = ("ArrayEpochs", "EpochsWavelet", "RawWavelet")


def __getattr__(name):
    if name in _ADAPTERS:
        from . import mne_adapter
        return getattr(mne_adapter, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
