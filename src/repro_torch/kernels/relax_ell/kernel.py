"""CUDA launch of the pull-mode min-plus ELL relaxation
(``csrc/relax_ell.cu``), which replaces the TPU kernel
``repro/kernels/relax_ell/kernel.py::relax_ell``.  Bound by
device-memory bytes: 3.35 TB/s on an H100 SXM at its 700 W limit
(data sheet)."""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _lib

NAME = "relax_ell"


@functools.cache
def _launch():
    return _lib.entry(
        "relax_ell_launch", [_lib.ptr] * 4 + [_lib.c_int] * 2 + [_lib.ptr]
    )


def relax_ell_cuda(dist, col, wgt) -> torch.Tensor:
    """Launch the kernel; returns the (R,) f32 row minima.  ``col``
    entries must index ``dist`` (ELL padding points at its last slot)."""
    _lib.check_cuda_tensors(NAME, dist=dist, col=col, wgt=wgt)
    _lib.require(dist.dtype == torch.float32 and dist.dim() == 1, NAME,
                 f"dist must be 1-D float32, got {dist.dtype} {tuple(dist.shape)}")
    _lib.require(col.dtype == torch.int32 and col.dim() == 2, NAME,
                 f"col must be 2-D int32, got {col.dtype} {tuple(col.shape)}")
    _lib.require(wgt.dtype == torch.float32 and wgt.shape == col.shape, NAME,
                 f"wgt must be float32 of col's shape {tuple(col.shape)}, "
                 f"got {wgt.dtype} {tuple(wgt.shape)}")
    R, W = col.shape
    _lib.require(R < 2**31 and W < 2**31, NAME, f"shape {R}x{W} exceeds int32")
    out = torch.empty((R,), dtype=torch.float32, device=dist.device)
    if R:
        rc = _launch()(dist.data_ptr(), col.data_ptr(), wgt.data_ptr(),
                       out.data_ptr(), R, W, _lib.stream_of(dist))
        _lib.check(rc, NAME)
        _lib.count_launch(NAME)
    return out
