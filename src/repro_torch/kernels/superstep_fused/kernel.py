"""CUDA launch of the fused sparse-superstep kernel
(``csrc/fused_superstep.cu``), which replaces the TPU kernel
``repro/kernels/superstep_fused/kernel.py::fused_superstep``.  Bound by
device-memory bytes: 3.35 TB/s on an H100 SXM at its 700 W limit
(data sheet).  The kernel reads the strips as 16-byte vectors where W
is a multiple of 4 and col and wgt start on 16 bytes, else as
scalars.

``fused_superstep_batch_cuda`` launches the batched entry: S = B·P
lanes in one launch on one 1-D grid whose warps the lanes share by
their live rows, lane s walking its own frontier over rank s % P
(``csrc/fused_superstep.cu``)."""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _lib

NAME = "fused_superstep"
BATCH = "fused_superstep_batch"


@functools.cache
def _launch():
    return _lib.entry(
        "fused_superstep_launch",
        [_lib.ptr] * 7 + [_lib.c_int] * 4 + [_lib.ptr],
    )


def fused_superstep_cuda(dist, row_idx, count, row_src, col, wgt,
                         n_out: int) -> torch.Tensor:
    """Launch the kernel; returns the (n_out+1,) f32 candidate buffer.
    Raises on a tensor the kernel does not take or a failed launch."""
    count = _lib.count_tensor(count, dist)
    _lib.check_cuda_tensors(NAME, dist=dist, row_idx=row_idx, count=count,
                            row_src=row_src, col=col, wgt=wgt)
    _lib.check_frontier_args(NAME, dist, row_idx, row_src, col, wgt)
    _lib.require(n_out >= 0, NAME, f"n_out must be >= 0, got {n_out}")
    F = row_idx.shape[0]
    R, W = wgt.shape
    out = torch.full((n_out + 1,), float("inf"), dtype=torch.float32,
                     device=dist.device)
    if F * W:
        rc = _launch()(
            dist.data_ptr(), row_idx.data_ptr(), count.data_ptr(),
            row_src.data_ptr(), col.data_ptr(), wgt.data_ptr(),
            out.data_ptr(), F, R, W, int(_lib.vector_strips(W, col, wgt)),
            _lib.stream_of(dist),
        )
        _lib.check(rc, NAME)
        _lib.count_launch(NAME)
    return out


@functools.cache
def _batch_launch():
    return _lib.entry(
        "fused_superstep_batch_launch",
        [_lib.ptr] * 7 + [_lib.c_int] * 8 + [_lib.ptr],
    )


def batch_grid(F: int, W: int, S: int, vec: bool = True) -> int:
    """The blocks of the 1-D grid the batched entry launches: the
    persistent grid, or fewer where S lanes of F rows fill fewer."""
    fn = _lib.entry("fused_superstep_batch_grid", [_lib.c_int] * 4 + [_lib.ptr])
    grid = ctypes.c_uint()
    _lib.check(fn(F, W, S, int(vec), ctypes.addressof(grid)), BATCH)
    return grid.value


def fused_superstep_batch_cuda(dist, row_idx, count, row_src, col, wgt,
                               n_out: int) -> torch.Tensor:
    """Launch the batched entry once for all S lanes; returns the
    (S, n_out+1) f32 candidate buffers.  Raises on a tensor the kernel
    does not take or a failed launch."""
    _lib.check_cuda_tensors(BATCH, dist=dist, row_idx=row_idx, count=count,
                            row_src=row_src, col=col, wgt=wgt)
    _lib.check_frontier_batch_args(BATCH, dist, row_idx, count, row_src,
                                   col, wgt)
    _lib.require(n_out >= 0, BATCH, f"n_out must be >= 0, got {n_out}")
    S, F = row_idx.shape
    P, R, W = wgt.shape
    out = torch.full((S, n_out + 1), float("inf"), dtype=torch.float32,
                     device=dist.device)
    if S * F * W:
        rc = _batch_launch()(
            dist.data_ptr(), row_idx.data_ptr(), count.data_ptr(),
            row_src.data_ptr(), col.data_ptr(), wgt.data_ptr(),
            out.data_ptr(), F, R, W, P, dist.shape[1], n_out + 1, S,
            int(_lib.vector_strips(W, col, wgt)), _lib.stream_of(dist),
        )
        _lib.check(rc, BATCH)
        _lib.count_launch(BATCH)
    return out
