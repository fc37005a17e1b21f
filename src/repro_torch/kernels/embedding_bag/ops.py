"""Public op: embedding bag (sum / mean).  A CUDA tensor launches the
kernel; a CPU tensor takes the plain torch version."""

from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.embedding_bag.kernel import embedding_bag_cuda
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

IMPLS = ("ref", "pallas", "pallas_interpret")


def bag_sum(table, idx, w) -> torch.Tensor:
    """(B, d) f32 weighted bag sums ``sum_l w[b, l] * table[idx[b, l]]``."""
    if table.device.type == "cpu":
        _lib.count_call("embedding_bag", "ref")
        return embedding_bag_ref(table, idx, w)
    _lib.count_call("embedding_bag", "cuda")
    return embedding_bag_cuda(table, idx, w)


def bag_pool(table, idx, mask, *, mode: str = "mean",
             impl: str = "ref") -> torch.Tensor:
    """Pool ``table[idx]`` per bag; ``mask`` marks valid slots.
    ``impl="ref"`` takes the plain version on any device; any other
    value (the JAX package's ``"pallas"``, ``"pallas_interpret"``) takes
    the kernel op.  The mean divides outside the kernel."""
    if impl not in IMPLS:
        raise ValueError(f"bag impl must be one of {IMPLS}, got {impl!r}")
    w = mask.to(torch.float32)
    if impl == "ref":
        s = embedding_bag_ref(table, idx, w)
    else:
        s = bag_sum(table, idx.to(torch.int32), w)
    if mode == "sum":
        return s
    if mode == "mean":
        cnt = torch.clamp(torch.sum(w, dim=1, keepdim=True), min=1.0)
        return s / cnt
    raise ValueError(mode)
