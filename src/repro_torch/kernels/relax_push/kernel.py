"""CUDA launch of the push-mode frontier gather (``csrc/relax_push.cu``),
which replaces the TPU kernel
``repro/kernels/relax_push/kernel.py::relax_push_gather``.  Bound by
device-memory bytes: 3.35 TB/s on an H100 SXM at its 700 W limit
(data sheet).  The kernel moves the strips as 16-byte vectors where W
is a multiple of 4 and wgt and the output start on 16 bytes, else as
scalars."""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _lib

NAME = "relax_push_gather"


@functools.cache
def _launch():
    return _lib.entry(
        "relax_push_gather_launch",
        [_lib.ptr] * 6 + [_lib.c_int] * 4 + [_lib.ptr],
    )


def relax_push_gather_cuda(dist, row_idx, count, row_src, col,
                           wgt) -> torch.Tensor:
    """Launch the kernel; returns the (F, W) f32 candidates.  ``col``
    only shapes the frontier, as in the TPU kernel's signature."""
    count = _lib.count_tensor(count, dist)
    _lib.check_cuda_tensors(NAME, dist=dist, row_idx=row_idx, count=count,
                            row_src=row_src, col=col, wgt=wgt)
    _lib.check_frontier_args(NAME, dist, row_idx, row_src, col, wgt)
    F = row_idx.shape[0]
    R, W = wgt.shape
    out = torch.empty((F, W), dtype=torch.float32, device=dist.device)
    if F * W:
        rc = _launch()(
            dist.data_ptr(), row_idx.data_ptr(), count.data_ptr(),
            row_src.data_ptr(), wgt.data_ptr(), out.data_ptr(), F, R, W,
            int(_lib.vector_strips(W, wgt, out)), _lib.stream_of(dist),
        )
        _lib.check(rc, NAME)
        _lib.count_launch(NAME)
    return out
