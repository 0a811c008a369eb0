"""The long-recording input pipeline (port of the EDF and stream parts of
``ninwavelets_tpu.io``): native (C++) window gathers built with ``g++`` at
first use, the EDF reader and writer, and the prefetching stream sources
that feed ``parallel.StreamingCWT``.  Host code only: numpy and ctypes.
"""
from .edf import EDFPick, EDFRaw, EDFReader, write_edf
from .native import native_available
from .stream import ArraySource, EDFSource, iter_ext_batches

__all__ = ["EDFReader", "EDFPick", "EDFRaw", "write_edf", "native_available",
           "ArraySource", "EDFSource", "iter_ext_batches"]
