"""Long recordings and multi-device scale-out (port of
``ninwavelets_tpu.parallel``): the overlap-discard ``StreamingCWT``, the
push-based ``OnlineCWT`` and their halo geometry; the (data, freq, time)
device mesh over ``torch.distributed`` ranks (``mesh``), the sharded epoch,
connectivity, statistics, transform and decoder functions (``sharded``),
``distributed_mean_power`` / ``distributed_itc`` (``api``), and the
halo-exchanged chunked CWT of a recording split over time (``chunked``).
Collectives go through ``collectives``, the one module that knows the
backend (NCCL a card a rank, or gloo for ranks that share a card or run on
the CPU)."""
from . import collectives
from .api import distributed_itc, distributed_mean_power
from .chunked import (chunk_bank, chunked_abs, chunked_cwt_ri,
                      chunked_fused_power, chunked_power, chunked_power_auto,
                      halo_samples, pow2_halo)
from .mesh import (DATA_AXIS, FREQ_AXIS, TIME_AXIS, MeshRun, auto_mesh,
                   flat_mesh, init_multihost, make_mesh, pad_to_multiple,
                   run_on_mesh, shard_batch)
from .online import OnlineCWT
from .sharded import (full_tensor, sharded_cluster_null,
                      sharded_cluster_test_f,
                      sharded_cluster_test_independent,
                      sharded_cluster_test_one_sample, sharded_coherence,
                      sharded_coherence_matrix, sharded_covariance,
                      sharded_cross_power, sharded_csp, sharded_cwt_ri,
                      sharded_env_corr, sharded_fastica,
                      sharded_fused_coherence, sharded_fused_itc,
                      sharded_fused_mean_power, sharded_fused_phase_lag,
                      sharded_fused_power_itc, sharded_hmm_fit,
                      sharded_imcoh, sharded_itc, sharded_mean_power,
                      sharded_mean_power_grad, sharded_modwt,
                      sharded_multitaper_mean_power, sharded_nm_plv,
                      sharded_pac, sharded_partial_coherence,
                      sharded_phase_lag, sharded_plv, sharded_plv_matrix,
                      sharded_power, sharded_ppc, sharded_psi_matrix,
                      sharded_reassigned_mean_power, sharded_ssq_mean_power,
                      sharded_stockwell, sharded_superlet_mean_power,
                      sharded_tf_decode, sharded_wavelet_granger)
from .streaming import StreamingCWT

__all__ = [
    "DATA_AXIS", "FREQ_AXIS", "TIME_AXIS",
    "make_mesh", "flat_mesh", "auto_mesh", "shard_batch", "pad_to_multiple",
    "init_multihost", "run_on_mesh", "MeshRun", "full_tensor",
    "collectives",
    "sharded_mean_power", "sharded_itc", "sharded_cwt_ri", "sharded_power",
    "sharded_fused_mean_power", "sharded_fused_itc",
    "sharded_fused_power_itc", "sharded_fused_coherence",
    "sharded_cross_power", "sharded_coherence", "sharded_ssq_mean_power",
    "sharded_reassigned_mean_power",
    "sharded_plv", "sharded_plv_matrix", "sharded_coherence_matrix",
    "sharded_psi_matrix", "sharded_partial_coherence",
    "sharded_pac", "sharded_mean_power_grad", "sharded_nm_plv",
    "sharded_phase_lag", "sharded_fused_phase_lag", "sharded_ppc",
    "sharded_imcoh", "sharded_modwt",
    "sharded_hmm_fit", "sharded_fastica",
    "sharded_covariance", "sharded_csp",
    "sharded_cluster_null", "sharded_cluster_test_one_sample",
    "sharded_cluster_test_independent", "sharded_cluster_test_f",
    "sharded_superlet_mean_power", "sharded_multitaper_mean_power",
    "sharded_wavelet_granger", "sharded_env_corr", "sharded_stockwell",
    "sharded_tf_decode",
    "distributed_mean_power", "distributed_itc",
    "chunk_bank", "chunked_power", "chunked_abs", "chunked_cwt_ri",
    "chunked_fused_power", "chunked_power_auto",
    "halo_samples", "pow2_halo", "StreamingCWT", "OnlineCWT",
]
