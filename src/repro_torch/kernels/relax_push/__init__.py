from repro_torch.kernels.relax_push.kernel import (
    relax_push_gather_batch_cuda,
    relax_push_gather_cuda,
)
from repro_torch.kernels.relax_push.ops import (
    relax_push_gather,
    relax_push_gather_batch,
    relax_push_rows,
    relax_push_rows_batch,
)
from repro_torch.kernels.relax_push.ref import (
    relax_push_gather_batch_ref,
    relax_push_gather_ref,
)

__all__ = ["relax_push_gather", "relax_push_gather_batch",
           "relax_push_gather_batch_cuda", "relax_push_gather_batch_ref",
           "relax_push_gather_cuda", "relax_push_gather_ref",
           "relax_push_rows", "relax_push_rows_batch"]
