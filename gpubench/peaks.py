"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W power limit): the roofline's ceilings.  A card set below
700 W runs slower; the harness prints its ``power.limit`` beside every
share of these peaks."""

FP32_FLOPS = 67e12        # float32 outside the tensor cores, FLOP/s
HBM_BYTES = 3.35e12       # HBM3, bytes/s


def least_seconds(flops: float, hbm_bytes: float) -> float:
    """The least time the work can take on the card: the larger of its
    operations over the float32 peak and its bytes over the bandwidth."""
    return max(flops / FP32_FLOPS, hbm_bytes / HBM_BYTES)
