"""Public ops: ELL SpMM (GNN neighbour aggregation), by rows
(``spmm_rows``, ``aggregate_neighbors``) or straight into vertex sums
(``vertex_sum``).  A CUDA tensor launches the kernel; a CPU tensor
takes the plain torch version.  The kernel masks the ragged edge
itself, so neither rows nor features need padding."""

from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.spmm_ell.kernel import spmm_ell_cuda, spmm_ell_vertex_cuda
from repro_torch.kernels.spmm_ell.ref import spmm_ell_ref, spmm_ell_vertex_ref

IMPLS = ("ref", "pallas", "pallas_interpret")


def spmm_rows(x, col, wgt, op: str = "sum") -> torch.Tensor:
    """(R, d) f32 rows ``reduce_s x[col[r, s]] * wgt[r, s]``."""
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
    if x.device.type == "cpu":
        _lib.count_call("spmm_ell", "ref")
        return spmm_ell_vertex_ref(x, col, wgt, row_ptr, deg)
    _lib.count_call("spmm_ell", "cuda")
    return spmm_ell_vertex_cuda(x, col, wgt, row_ptr, deg)


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
