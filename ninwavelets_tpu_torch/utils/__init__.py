from .mne_adapter import ArrayEpochs, EpochsWavelet

__all__ = ["ArrayEpochs", "EpochsWavelet"]
