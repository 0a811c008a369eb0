"""The long-recording input pipeline (port of ``ninwavelets_tpu.io``):
native (C++) window gathers built with ``g++`` at first use, the EDF, BDF
and BrainVision readers and writers, and the prefetching stream sources
that feed ``parallel.StreamingCWT``.  Host code only: numpy and ctypes.
"""
from .bdf import BDFRaw, BDFReader, status_events, write_bdf
from .brainvision import (BVRaw, BVReader, BVSource, read_markers,
                          write_brainvision)
from .edf import EDFPick, EDFRaw, EDFReader, write_edf
from .native import native_available
from .stream import ArraySource, EDFSource, iter_ext_batches

__all__ = ["EDFReader", "EDFPick", "EDFRaw", "write_edf", "native_available",
           "ArraySource", "EDFSource", "iter_ext_batches",
           "BVReader", "BVRaw", "BVSource", "read_markers",
           "write_brainvision",
           "BDFReader", "BDFRaw", "write_bdf", "status_events"]
