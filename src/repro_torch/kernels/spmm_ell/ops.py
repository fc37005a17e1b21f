"""Public ops: ELL SpMM (GNN neighbour aggregation), by rows
(``spmm_rows``, ``aggregate_neighbors``) or straight into vertex sums
(``vertex_sum``, and ``VertexSum``, its autograd Function).  A CUDA
tensor launches the kernel; a CPU tensor takes the plain torch version.
The kernel masks the ragged edge itself, so neither rows nor features
need padding.

The kernel's launch is invisible to autograd, so ``spmm_rows`` and
``vertex_sum`` refuse an input that needs a gradient, on either device,
rather than return an output that would drop it.  ``VertexSum`` is the
differentiable vertex sum: its backward is the same kernel over the
transpose ELL."""

from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.spmm_ell.kernel import spmm_ell_cuda, spmm_ell_vertex_cuda
from repro_torch.kernels.spmm_ell.ref import spmm_ell_ref, spmm_ell_vertex_ref

IMPLS = ("ref", "pallas", "pallas_interpret")


def _refuse_grad(op: str, hint: str, *tensors) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{op}: an input needs a gradient, and the spmm_ell kernel's "
                           f"launch is not recorded by autograd; {hint}")


def spmm_rows(x, col, wgt, op: str = "sum") -> torch.Tensor:
    """(R, d) f32 rows ``reduce_s x[col[r, s]] * wgt[r, s]``."""
    _refuse_grad("spmm_rows", "the row entry has no backward on any path yet "
                 "(ROADMAP.md Queue 1)", x, wgt)
    if x.device.type == "cpu":
        _lib.count_call("spmm_ell", "ref")
        return spmm_ell_ref(x, col, wgt, op)
    _lib.count_call("spmm_ell", "cuda")
    return spmm_ell_cuda(x, col, wgt, op)


def vertex_sum(x, col, wgt, row_ptr, deg) -> torch.Tensor:
    """(n, d) f32 ``out[v] = sum over v's rows, in order, of the sum over
    the row's live slots, in order, of x[col[r, s]] * wgt[r, s]`` over a
    neighbour ELL (``models/gnn/ell.py``); padding is never read, so x
    needs no zero row."""
    _refuse_grad("vertex_sum", "take VertexSum (models/gnn/ell.py::neighbor_sum)", x, wgt)
    if x.device.type == "cpu":
        _lib.count_call("spmm_ell", "ref")
        return spmm_ell_vertex_ref(x, col, wgt, row_ptr, deg)
    _lib.count_call("spmm_ell", "cuda")
    return spmm_ell_vertex_cuda(x, col, wgt, row_ptr, deg)


class VertexSum(torch.autograd.Function):
    """``VertexSum.apply(x, ell, transpose)``: :func:`vertex_sum` of x
    over ``ell`` = (col, wgt, row_ptr, deg), differentiable in x.

    ``out[v] = sum over edges u -> v of x[u] * mask``, so ``grad_x[u] =
    sum over the same edges of g[v] * mask``: the vertex sum of the
    incoming gradient over the transpose ELL (the edges reversed), which
    ``transpose()`` returns in the same layout.  The backward applies
    this Function to it (so a second derivative takes the forward ELL
    again); on the card both ways launch the kernel, and both give the
    bits of the plain version.  No gradient flows to the ELL, and none
    is computed for an x that needs none."""

    @staticmethod
    def forward(ctx, x, ell, transpose):
        if ctx.needs_input_grad[0] and transpose is None:
            raise RuntimeError("VertexSum: x needs a gradient, but no transpose ELL "
                               "was given to take it over")
        ctx.ell, ctx.transpose = ell, transpose
        return vertex_sum(x, *ell)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        ell = ctx.ell
        return VertexSum.apply(g.contiguous(), ctx.transpose(), lambda: ell), None, None


def aggregate_neighbors(x, col, wgt, *, op: str = "sum",
                        impl: str = "ref") -> torch.Tensor:
    """``reduce_s x[col[r, s]] * wgt[r, s]`` over an ELL whose padding
    slots carry weight 0 and point at a zero row of ``x``.
    ``impl="ref"`` takes the plain version on any device; any other
    value (the JAX package's ``"pallas"``, ``"pallas_interpret"``)
    takes the kernel op."""
    if impl not in IMPLS:
        raise ValueError(f"spmm impl must be one of {IMPLS}, got {impl!r}")
    if impl == "ref":
        return spmm_ell_ref(x, col, wgt, op)
    return spmm_rows(x, col, wgt, op)
