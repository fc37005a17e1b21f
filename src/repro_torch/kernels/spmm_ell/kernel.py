"""CUDA launch of the ELL SpMM (``csrc/spmm_ell.cu``), which replaces
the TPU kernel ``repro/kernels/spmm_ell/kernel.py::spmm_ell``.  Bound by
device-memory bytes: 3.35 TB/s on an H100 SXM at its 700 W limit (data
sheet)."""

from __future__ import annotations

import functools
import weakref

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.spmm_ell.ref import OPS

NAME = "spmm_ell"
#: the last col whose range was read: (weak reference, version, min, max)
_checked = None


@functools.cache
def _launch():
    return _lib.entry(
        "spmm_ell_launch", [_lib.ptr] * 4 + [_lib.c_int] * 4 + [_lib.ptr]
    )


def check_spmm_args(x, col, wgt, op) -> None:
    """x (n_x, d) f32, col (R, W) int32, wgt (R, W) f32, op sum|max.
    Messages are formatted only on failure: this runs before every
    launch."""
    if op not in OPS:
        _lib.require(False, NAME, f"op must be one of {OPS}, got {op!r}")
    if x.dtype != torch.float32 or x.dim() != 2:
        _lib.require(False, NAME, f"x must be 2-D float32, got {x.dtype} {tuple(x.shape)}")
    if col.dtype != torch.int32 or col.dim() != 2:
        _lib.require(False, NAME,
                     f"col must be 2-D int32, got {col.dtype} {tuple(col.shape)}")
    if wgt.dtype != torch.float32 or wgt.shape != col.shape:
        _lib.require(False, NAME, f"wgt must be float32 of col's shape {tuple(col.shape)}, "
                                  f"got {wgt.dtype} {tuple(wgt.shape)}")
    if max(*x.shape, *col.shape) >= 2**31:
        _lib.require(False, NAME, "sizes exceed int32")


def _index_range(col) -> tuple[int, int]:
    """col's (min, max) from one host read, remembered for that tensor
    until it is written again (its version counter moves) or freed: the
    GIN forward launches once a layer on one neighbour ELL."""
    global _checked
    if _checked is not None:
        ref, version, lo, hi = _checked
        if ref() is col and col._version == version:
            return lo, hi
    lo, hi = torch.stack(torch.aminmax(col)).tolist()
    _checked = (weakref.ref(col), col._version, lo, hi)
    return lo, hi


def spmm_ell_cuda(x, col, wgt, op: str = "sum") -> torch.Tensor:
    """Launch the kernel; returns the (R, d) f32 rows.  Every column
    index must lie in [0, n_x), or this raises before the launch (one
    host read per col tensor, see _index_range)."""
    check_spmm_args(x, col, wgt, op)
    _lib.check_cuda_tensors(NAME, x=x, col=col, wgt=wgt)
    (n_x, d), (R, W) = x.shape, col.shape
    out = torch.empty((R, d), dtype=torch.float32, device=x.device)
    if R * d == 0:
        return out
    if col.numel():
        lo, hi = _index_range(col)
        _lib.require(0 <= lo and hi < n_x, NAME,
                     f"col must lie in [0, {n_x}), got [{lo}, {hi}]")
    rc = _launch()(x.data_ptr(), col.data_ptr(), wgt.data_ptr(), out.data_ptr(),
                   R, W, d, OPS.index(op), _lib.stream_of(x))
    _lib.check(rc, NAME)
    _lib.count_launch(NAME)
    return out
