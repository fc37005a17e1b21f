"""CUDA launch of the embedding bag (``csrc/embedding_bag.cu``), which
replaces the TPU kernel ``repro/kernels/embedding_bag/kernel.py::
embedding_bag``.  Bound by device-memory bytes: 3.35 TB/s on an H100
SXM at its 700 W limit (data sheet)."""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _lib

NAME = "embedding_bag"


@functools.cache
def _launch():
    return _lib.entry(
        "embedding_bag_launch", [_lib.ptr] * 4 + [_lib.c_int] * 3 + [_lib.ptr]
    )


def check_bag_args(table, idx, w) -> None:
    """table (V, d) f32, idx (B, L) int32, w (B, L) f32."""
    _lib.require(table.dtype == torch.float32 and table.dim() == 2, NAME,
                 f"table must be 2-D float32, got {table.dtype} {tuple(table.shape)}")
    _lib.require(idx.dtype == torch.int32 and idx.dim() == 2, NAME,
                 f"idx must be 2-D int32, got {idx.dtype} {tuple(idx.shape)}")
    _lib.require(w.dtype == torch.float32 and w.shape == idx.shape, NAME,
                 f"w must be float32 of idx's shape {tuple(idx.shape)}, "
                 f"got {w.dtype} {tuple(w.shape)}")
    _lib.require(table.numel() < 2**31 * 4 and idx.numel() < 2**31, NAME,
                 "sizes exceed int32")


def refuse_grad(table, w) -> None:
    """Raise where grad mode is on and ``table`` or ``w`` needs a
    gradient: the launch is not recorded by autograd, so its output
    would drop that gradient."""
    if torch.is_grad_enabled() and (table.requires_grad or w.requires_grad):
        raise RuntimeError(f"{NAME}: an input needs a gradient, and the kernel's launch is "
                           f"not recorded by autograd; train through "
                           f"kernels.embedding_bag.ops.BagSum (bag_pool)")


def embedding_bag_cuda(table, idx, w) -> torch.Tensor:
    """Launch the kernel; returns the (B, d) f32 weighted bag sums.
    Refuses a ``table`` or ``w`` that needs a gradient while grad mode
    is on (:func:`refuse_grad`), before anything else is checked.
    Every index must lie in [0, V): one host read checks that."""
    refuse_grad(table, w)
    check_bag_args(table, idx, w)
    _lib.check_cuda_tensors(NAME, table=table, idx=idx, w=w)
    (V, d), (B, L) = table.shape, idx.shape
    out = torch.empty((B, d), dtype=torch.float32, device=table.device)
    if B * d == 0:
        return out
    if idx.numel():
        lo, hi = torch.stack(torch.aminmax(idx)).tolist()
        _lib.require(0 <= lo and hi < V, NAME,
                     f"idx must lie in [0, {V}), got [{lo}, {hi}]")
    rc = _launch()(table.data_ptr(), idx.data_ptr(), w.data_ptr(),
                   out.data_ptr(), B, L, d, _lib.stream_of(table))
    _lib.check(rc, NAME)
    _lib.count_launch(NAME)
    return out
