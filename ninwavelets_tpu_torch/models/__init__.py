from ..ops.bank import WaveletMode
from .base import WaveletBase
from .zoo import (Bump, DOG, Haar, MexicanHat, Morlet, Morse, MorseMNE,
                  MorseMultitaper, Paul, Shannon, Superlet)

__all__ = ["WaveletBase", "WaveletMode", "Morse", "MorseMNE", "Morlet",
           "Haar", "MexicanHat", "Shannon", "Paul", "DOG", "Bump", "Superlet",
           "MorseMultitaper"]
