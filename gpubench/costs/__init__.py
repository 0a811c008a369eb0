"""One module per entry: ``cost(config, traffic) -> {"flops", "bytes"}``,
the least work of one call, counted from the cell's own parameters alone,
whatever path the program takes.

Operations are the FFTs' (5 n log2 n for a complex transform of n points,
half that for the forward transform of a real signal, whichever transform
the program takes); the elementwise products are left out, so the count
is a floor.  Bytes are
the compulsory traffic of the device's memory: each float32 input sample
read once, the bank read once, each float32 output plane written once.
"""
import math


def fft_flops(n: int) -> float:
    return 5.0 * n * math.log2(n)
