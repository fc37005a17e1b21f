from repro_torch.kernels.superstep_fused.kernel import (
    fused_superstep_batch_cuda,
    fused_superstep_cuda,
)
from repro_torch.kernels.superstep_fused.ops import (
    fused_superstep,
    fused_superstep_batch,
)
from repro_torch.kernels.superstep_fused.ref import (
    fused_superstep_batch_ref,
    fused_superstep_ref,
)

__all__ = ["fused_superstep", "fused_superstep_batch",
           "fused_superstep_batch_cuda", "fused_superstep_batch_ref",
           "fused_superstep_cuda", "fused_superstep_ref"]
