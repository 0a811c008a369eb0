"""Seconds from the process's start to the first timed call: imports, the
card's context, the kernels' build or load, the inputs, the warm-up."""


def read(run):
    return run.setup_s
