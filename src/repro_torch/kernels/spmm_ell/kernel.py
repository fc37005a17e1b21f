"""CUDA launch of the ELL SpMM (``csrc/spmm_ell.cu``), which replaces
the TPU kernel ``repro/kernels/spmm_ell/kernel.py::spmm_ell``.  Bound by
device-memory bytes: 3.35 TB/s on an H100 SXM at its 700 W limit (data
sheet)."""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.spmm_ell.ref import OPS

NAME = "spmm_ell"


@functools.cache
def _launch():
    return _lib.entry(
        "spmm_ell_launch", [_lib.ptr] * 4 + [_lib.c_int] * 4 + [_lib.ptr]
    )


def check_spmm_args(x, col, wgt, op) -> None:
    """x (n_x, d) f32, col (R, W) int32, wgt (R, W) f32, op sum|max."""
    _lib.require(op in OPS, NAME, f"op must be one of {OPS}, got {op!r}")
    _lib.require(x.dtype == torch.float32 and x.dim() == 2, NAME,
                 f"x must be 2-D float32, got {x.dtype} {tuple(x.shape)}")
    _lib.require(col.dtype == torch.int32 and col.dim() == 2, NAME,
                 f"col must be 2-D int32, got {col.dtype} {tuple(col.shape)}")
    _lib.require(wgt.dtype == torch.float32 and wgt.shape == col.shape, NAME,
                 f"wgt must be float32 of col's shape {tuple(col.shape)}, "
                 f"got {wgt.dtype} {tuple(wgt.shape)}")
    _lib.require(max(*x.shape, *col.shape) < 2**31, NAME, "sizes exceed int32")


def spmm_ell_cuda(x, col, wgt, op: str = "sum") -> torch.Tensor:
    """Launch the kernel; returns the (R, d) f32 rows.  Every column
    index must lie in [0, n_x): one host read checks that."""
    check_spmm_args(x, col, wgt, op)
    _lib.check_cuda_tensors(NAME, x=x, col=col, wgt=wgt)
    (n_x, d), (R, W) = x.shape, col.shape
    out = torch.empty((R, d), dtype=torch.float32, device=x.device)
    if R * d == 0:
        return out
    if col.numel():
        lo, hi = (int(v) for v in torch.aminmax(col))
        _lib.require(0 <= lo and hi < n_x, NAME,
                     f"col must lie in [0, {n_x}), got [{lo}, {hi}]")
    rc = _launch()(x.data_ptr(), col.data_ptr(), wgt.data_ptr(), out.data_ptr(),
                   R, W, d, OPS.index(op), _lib.stream_of(x))
    _lib.check(rc, NAME)
    _lib.count_launch(NAME)
    return out
