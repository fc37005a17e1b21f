"""The port's kernels: CUDA C++ for Hopper (``repro_torch/csrc``), each
with a plain torch version that CPU tensors take.

  superstep_fused   gather + min-plus relax + scatter-min of a frontier
                    (one lane, or a batch of lanes in one launch)
  relax_push        push-mode frontier gather (scatter-min in torch;
                    one lane, or a batch of lanes in one launch)
  relax_ell         pull-mode min-plus ELL row minima (rule R1)
  flash_attention   streaming-softmax GQA attention (LM prefill), and
                    its gradient (LM training)
  embedding_bag     gather + weighted sum per bag (MIND profile pooling;
                    its backward is spmm_ell's vertex sum)
  spmm_ell          ELL SpMM, sum or max over slots, or straight into
                    vertex sums (GNN neighbour sums, forward and, over
                    the transpose ELL, backward)
"""

from repro_torch.kernels._lib import (
    KERNELS,
    build,
    call_counts,
    launch_counts,
    launch_shapes,
    library,
    reset_launch_counts,
)
from repro_torch.kernels.embedding_bag import (
    BagSum,
    bag_pool,
    bag_sum,
    embedding_bag_cuda,
    embedding_bag_ref,
)
from repro_torch.kernels.flash_attention import (
    FlashAttention,
    attention_bwd_ref,
    attention_lse_ref,
    attention_ref,
    flash_attention_bwd_cuda,
    flash_attention_cuda,
    mha,
)
from repro_torch.kernels.relax_ell import relax_ell_cuda, relax_ell_ref, relax_rows
from repro_torch.kernels.relax_push import (
    relax_push_gather,
    relax_push_gather_batch,
    relax_push_gather_batch_cuda,
    relax_push_gather_batch_ref,
    relax_push_gather_cuda,
    relax_push_gather_ref,
    relax_push_rows,
    relax_push_rows_batch,
)
from repro_torch.kernels.spmm_ell import (
    VertexSum,
    aggregate_neighbors,
    spmm_ell_cuda,
    spmm_ell_ref,
    spmm_ell_vertex_cuda,
    spmm_ell_vertex_ref,
    spmm_rows,
    vertex_sum,
)
from repro_torch.kernels.superstep_fused import (
    fused_superstep,
    fused_superstep_batch,
    fused_superstep_batch_cuda,
    fused_superstep_batch_ref,
    fused_superstep_cuda,
    fused_superstep_ref,
)

__all__ = [
    "KERNELS", "build", "call_counts", "launch_counts", "launch_shapes", "library",
    "reset_launch_counts",
    "relax_ell_cuda", "relax_ell_ref", "relax_rows",
    "relax_push_gather", "relax_push_gather_cuda", "relax_push_gather_ref",
    "relax_push_rows", "relax_push_gather_batch", "relax_push_gather_batch_cuda",
    "relax_push_gather_batch_ref", "relax_push_rows_batch",
    "fused_superstep", "fused_superstep_cuda", "fused_superstep_ref",
    "fused_superstep_batch", "fused_superstep_batch_cuda",
    "fused_superstep_batch_ref",
    "attention_ref", "attention_lse_ref", "attention_bwd_ref", "flash_attention_cuda",
    "flash_attention_bwd_cuda", "FlashAttention", "mha",
    "BagSum", "bag_pool", "bag_sum", "embedding_bag_cuda", "embedding_bag_ref",
    "aggregate_neighbors", "spmm_rows", "spmm_ell_cuda", "spmm_ell_ref",
    "vertex_sum", "VertexSum", "spmm_ell_vertex_cuda", "spmm_ell_vertex_ref",
]
