"""Public op: embedding bag (sum / mean).  A CUDA tensor launches the
kernel; a CPU tensor takes the plain torch version.

The kernel's launch is invisible to autograd, so its entry refuses a
``table`` or ``w`` that needs a gradient (``kernel.py::refuse_grad``).
``BagSum`` is the differentiable bag: its backward is the ``spmm_ell``
vertex sum over the bag's segment ELL."""

from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.embedding_bag.kernel import embedding_bag_cuda
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
from repro_torch.kernels.spmm_ell.ops import vertex_sum

IMPLS = ("ref", "pallas", "pallas_interpret")


def bag_sum(table, idx, w) -> torch.Tensor:
    """(B, d) f32 weighted bag sums ``sum_l w[b, l] * table[idx[b, l]]``."""
    if table.device.type == "cpu":
        _lib.count_call("embedding_bag", "ref")
        return embedding_bag_ref(table, idx, w)
    _lib.count_call("embedding_bag", "cuda")
    return embedding_bag_cuda(table, idx, w)


class BagSum(torch.autograd.Function):
    """``BagSum.apply(table, idx, w)``: :func:`bag_sum`, differentiable
    in ``table``.

    ``out[b] = sum_l w[b, l] table[idx[b, l]]``, so ``grad_table[v] =
    sum over the slots (b, l) with idx[b, l] = v of w[b, l] g[b]``: a
    segment sum over the table's rows.  The backward builds the bag ELL
    of idx and w (``models/gnn/ell.py::build_bag_ell``; a train step's
    batch is new every step, so nothing is kept) and takes the sum as
    the spmm_ell vertex sum (:func:`vertex_sum`) of the incoming (B, d)
    gradient over it.  On the card it launches the kernel, and its
    gradient is the plain version's bits (``spmm_ell_vertex_ref``, which
    the CPU takes), the same every run: no atomics.  No gradient flows
    to ``idx``; a ``w`` that needs one is refused."""

    @staticmethod
    def forward(ctx, table, idx, w):
        if ctx.needs_input_grad[2]:
            raise RuntimeError("BagSum: w needs a gradient, and the bag's backward computes "
                               "only the table's")
        ctx.save_for_backward(idx, w)
        ctx.n = table.shape[0]
        return bag_sum(table, idx, w)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        from repro_torch.models.gnn.ell import build_bag_ell  # models/ imports the kernels

        idx, w = ctx.saved_tensors
        ell = build_bag_ell(idx, w, ctx.n)
        return vertex_sum(g.contiguous(), ell.col, ell.wgt, ell.row_ptr, ell.deg), None, None


def bag_pool(table, idx, mask, *, mode: str = "mean",
             impl: str = "ref") -> torch.Tensor:
    """Pool ``table[idx]`` per bag; ``mask`` marks valid slots.
    ``impl="ref"`` takes the plain, differentiable version on any
    device; any other value (the JAX package's ``"pallas"``,
    ``"pallas_interpret"``) takes :class:`BagSum`.  The mean divides
    outside the kernel."""
    if impl not in IMPLS:
        raise ValueError(f"bag impl must be one of {IMPLS}, got {impl!r}")
    w = mask.to(torch.float32)
    if impl == "ref":
        s = embedding_bag_ref(table, idx, w)
    else:
        s = BagSum.apply(table, idx.to(torch.int32), w)
    if mode == "sum":
        return s
    if mode == "mean":
        cnt = torch.clamp(torch.sum(w, dim=1, keepdim=True), min=1.0)
        return s / cnt
    raise ValueError(mode)
