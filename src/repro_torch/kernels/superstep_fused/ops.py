"""Public ops: the fused sparse-superstep relaxation, for one lane and
for S lanes in one launch.  A CUDA tensor launches the kernel; a CPU
tensor takes the plain torch version.  Each call is counted by route
(``kernels/_lib.py::kernel_call``)."""

from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.superstep_fused.kernel import (
    fused_superstep_batch_cuda,
    fused_superstep_cuda,
)
from repro_torch.kernels.superstep_fused.ref import (
    fused_superstep_batch_ref,
    fused_superstep_ref,
)


def fused_superstep(dist, row_idx, count, row_src, col, wgt,
                    n_out: int) -> torch.Tensor:
    """(n_out+1,) f32 candidates of rows ``row_idx[:count]``, scatter-
    min'd over +inf (slot ``n_out`` takes the ELL padding)."""
    cpu = dist.device.type == "cpu"
    with _lib.kernel_call("fused_superstep", "ref" if cpu else "cuda",
                          lanes=1, rows=row_idx.shape[-1], width=wgt.shape[-1],
                          n_local=dist.shape[-1] - 1, n_out=n_out):
        if cpu:
            return fused_superstep_ref(dist, row_idx, count, row_src, col,
                                       wgt, n_out)
        return fused_superstep_cuda(dist, row_idx, count, row_src, col, wgt,
                                    n_out)


def fused_superstep_batch(dist, row_idx, count, row_src, col, wgt,
                          n_out: int) -> torch.Tensor:
    """(S, n_out+1) f32: lane s's candidates of rows
    ``row_idx[s, :count[s]]`` of rank s % P (``col`` (P, R, W))."""
    cpu = dist.device.type == "cpu"
    with _lib.kernel_call("fused_superstep_batch", "ref" if cpu else "cuda",
                          lanes=row_idx.shape[0], rows=row_idx.shape[-1],
                          width=wgt.shape[-1], n_local=dist.shape[-1] - 1,
                          n_out=n_out):
        if cpu:
            return fused_superstep_batch_ref(dist, row_idx, count, row_src,
                                             col, wgt, n_out)
        return fused_superstep_batch_cuda(dist, row_idx, count, row_src, col,
                                          wgt, n_out)
