from ..ops.bank import WaveletMode
from .base import WaveletBase
from .zoo import Haar, MexicanHat, Morlet, Morse, Shannon

__all__ = ["WaveletBase", "WaveletMode", "Morse", "Morlet", "Haar",
           "MexicanHat", "Shannon"]
