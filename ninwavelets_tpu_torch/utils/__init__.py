from .mne_adapter import ArrayEpochs, EpochsWavelet, RawWavelet

__all__ = ["ArrayEpochs", "EpochsWavelet", "RawWavelet"]
