"""repro_torch.roofline — what the port's programs must move and run on
an H100, beside what they do.

  model.py      the H100 SXM's three-term roofline (device memory,
                compute by dtype, NVLink) and :func:`bound`, the least
                time of a kernel's must-move bytes and operations
  ops.py        the recorder of eager torch programs (aten ops with
                their bytes, host reads, rank-axis collectives) and the
                charges read from it
  kernels.py    the must-move bytes and operations of each kernel entry
  superstep.py  the engine's per-superstep profile
"""

from repro_torch.roofline.kernels import fused_kernel_bytes, push_gather_bytes
from repro_torch.roofline.model import (
    BF16_OPS_PER_S,
    F32_OPS_PER_S,
    HBM_BW,
    LINK_BW,
    MEM_BYTES_PER_S,
    PEAK_FLOPS,
    TF32X3_OPS_PER_S,
    Roofline,
    bound,
    from_record,
    peak_for,
)
from repro_torch.roofline.ops import (
    OpRecorder,
    RecordingRanks,
    collective_bytes,
    flops_and_bytes,
    op_traffic,
)
from repro_torch.roofline.superstep import (
    relax_region_bytes,
    seeded_partition,
    superstep_profile,
)

__all__ = [
    "BF16_OPS_PER_S", "F32_OPS_PER_S", "HBM_BW", "LINK_BW", "MEM_BYTES_PER_S",
    "PEAK_FLOPS", "Roofline", "TF32X3_OPS_PER_S", "bound", "from_record", "peak_for",
    "OpRecorder", "RecordingRanks", "collective_bytes", "flops_and_bytes",
    "op_traffic",
    "fused_kernel_bytes", "push_gather_bytes", "relax_region_bytes",
    "seeded_partition", "superstep_profile",
]
