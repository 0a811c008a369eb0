"""Long recordings on one device (port of the single-device parts of
``ninwavelets_tpu.parallel``): the overlap-discard ``StreamingCWT``, the
push-based ``OnlineCWT``, and their halo geometry."""
from .chunked import chunk_bank, halo_samples, pow2_halo
from .online import OnlineCWT
from .streaming import StreamingCWT

__all__ = ["StreamingCWT", "OnlineCWT", "halo_samples", "pow2_halo",
           "chunk_bank"]
