"""Host time the stream's consumer waits for its window batches (the
first gather, which the prefetch thread cannot hide, and any later one
not yet done), per call, in ms: the program's ``ninw.stream.wait``
spans in the traced window."""
from ..spans import ms_per_call


def read(run):
    return ms_per_call(run, "ninw.stream.wait")
