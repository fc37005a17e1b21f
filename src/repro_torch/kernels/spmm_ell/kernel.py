"""CUDA launches of the ELL SpMM (``csrc/spmm_ell.cu``), which replaces
the TPU kernel ``repro/kernels/spmm_ell/kernel.py::spmm_ell``: the row
entry (``spmm_ell_cuda``, the TPU function's (R, d) rows, sum or max)
and the vertex sum (``spmm_ell_vertex_cuda``, GIN's (n, d) neighbour
sum over a neighbour ELL).  Bound by device-memory bytes: 3.35 TB/s on
an H100 SXM at its 700 W limit (data sheet)."""

from __future__ import annotations

import functools
import weakref
from typing import NamedTuple

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.spmm_ell.ref import OPS, live_slots

NAME = "spmm_ell"
#: a vertex of more rows than this has its rows summed as segments of their
#: own and folded by a second kernel (csrc/spmm_ell.cu); 2 was the fastest
#: of 1, 2, 4 and 16 at both GIN widths on an H100 (scripts/spmm_ab.py)
SPLIT_ROWS = 2
#: the last col whose range was read: (weak reference, version, min, max)
_checked = None
#: vertex plans kept, newest first: a DimeNet train step sums over six
#: ELLs in turn (the segment ELLs of edge_src, edge_dst, tri_kj and
#: tri_ji forward, for its sums and its gathers' backward, and those of
#: tri_ji and edge_dst transposed, for its sums' backward); GIN's over
#: its neighbour ELL and the transpose.  ``models/gnn/ell.py`` keeps the
#: segment ELLs of half as many indices, each forward and transposed
PLANS_KEPT = 8
#: the last PLANS_KEPT vertex plans: (weak references, key, VertexPlan)
_planned: list = []


@functools.cache
def _launch():
    return _lib.entry(
        "spmm_ell_launch", [_lib.ptr] * 4 + [_lib.c_int] * 4 + [_lib.ptr]
    )


@functools.cache
def _vertex_launch():
    return _lib.entry(
        "spmm_ell_vertex_launch", [_lib.ptr] * 11 + [_lib.c_int] * 6 + [_lib.ptr]
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


class VertexPlan(NamedTuple):
    """What the vertex sum needs beside the ELL: the fat vertices (more
    than ``split_rows`` rows), the ELL row and live slots of each of
    their rows, one scratch row each."""
    fat_vertex: torch.Tensor  # (n_fat,) int32
    fat_start: torch.Tensor   # (n_fat + 1,) int64, first scratch row of each
    fat_row: torch.Tensor     # (n_fat_rows,) int64 ELL row
    fat_live: torch.Tensor    # (n_fat_rows,) int32 live slots
    split_rows: int


def check_vertex_args(x, col, wgt, row_ptr, deg) -> None:
    """x (n_x, d) f32, col (R, W) int32, wgt (R, W) f32, row_ptr (n+1,)
    int64, deg (n,) int32.  Messages are formatted only on failure."""
    check_spmm_args(x, col, wgt, "sum")
    if row_ptr.dtype != torch.int64 or row_ptr.dim() != 1 or row_ptr.shape[0] < 1:
        _lib.require(False, NAME, f"row_ptr must be 1-D int64 of n+1 >= 1 entries, got "
                                  f"{row_ptr.dtype} {tuple(row_ptr.shape)}")
    if deg.dtype != torch.int32 or deg.shape != (row_ptr.shape[0] - 1,):
        _lib.require(False, NAME, f"deg must be int32 ({row_ptr.shape[0] - 1},), got "
                                  f"{deg.dtype} {tuple(deg.shape)}")


def vertex_plan(x, col, row_ptr, deg, split_rows: int) -> VertexPlan:
    """Check a neighbour ELL and plan the vertex sum over it, splitting
    the vertices of more than ``split_rows`` (>= 1) rows; remembered for
    the last PLANS_KEPT (col, row_ptr, deg) until one of them is written
    or freed, since a GNN forward sums over the same ELLs every layer and
    its backward over their transposes.  Raises unless
    row_ptr runs from 0 to R without falling, every deg[v] fits v's
    rows, and every live slot's col lies in [0, n_x).  A few host reads;
    n >= 1."""
    _lib.require(split_rows >= 1, NAME, f"split_rows must be >= 1, got {split_rows}")
    tensors = (col, row_ptr, deg)
    key = (*(t._version for t in tensors), split_rows, x.shape[0])
    for i, (refs, old_key, plan) in enumerate(_planned):
        if old_key == key and all(r() is t for r, t in zip(refs, tensors)):
            _planned.insert(0, _planned.pop(i))
            return plan
    R, W = col.shape
    nrows = row_ptr[1:] - row_ptr[:-1]
    first, last, least_rows, most_over, least_deg = torch.stack([
        row_ptr[0], row_ptr[-1], nrows.min(), (deg.long() - nrows * W).max(),
        deg.min().long(),
    ]).tolist()
    _lib.require(first == 0 and last == R and least_rows >= 0, NAME,
                 f"row_ptr must rise from 0 to R = {R}, got {first} .. {last}, "
                 f"least step {least_rows}")
    _lib.require(least_deg >= 0 and most_over <= 0, NAME,
                 f"deg must lie in [0, rows x W]: least {least_deg}, "
                 f"most over {most_over}")
    live = live_slots(row_ptr, deg, W)
    live_col = col[torch.arange(W, device=col.device) < live[:, None]]
    if live_col.numel():
        lo, hi = torch.stack(torch.aminmax(live_col)).tolist()
        _lib.require(0 <= lo and hi < x.shape[0], NAME,
                     f"live col must lie in [0, {x.shape[0]}), got [{lo}, {hi}]")
    del live_col
    fat_vertex = torch.nonzero(nrows > split_rows).flatten()
    counts = nrows[fat_vertex]
    fat_start = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    n_fat_rows = int(fat_start[-1])
    rank = torch.arange(n_fat_rows, device=col.device) - torch.repeat_interleave(
        fat_start[:-1], counts, output_size=n_fat_rows)
    fat_row = torch.repeat_interleave(row_ptr[fat_vertex], counts,
                                      output_size=n_fat_rows) + rank
    plan = VertexPlan(fat_vertex.to(torch.int32), fat_start, fat_row,
                      live[fat_row].to(torch.int32), split_rows)
    _planned.insert(0, (tuple(weakref.ref(t) for t in tensors), key, plan))
    del _planned[PLANS_KEPT:]
    return plan


def vertex_launch_args(x, col, wgt, row_ptr, deg, plan: VertexPlan, scratch, out) -> tuple:
    """The C entry's arguments, for a caller that times the bare launch."""
    W, (n, d) = col.shape[1], out.shape
    return (x.data_ptr(), col.data_ptr(), wgt.data_ptr(), row_ptr.data_ptr(),
            deg.data_ptr(), plan.fat_row.data_ptr(), plan.fat_live.data_ptr(),
            plan.fat_vertex.data_ptr(), plan.fat_start.data_ptr(), scratch.data_ptr(),
            out.data_ptr(), n, W, d, plan.split_rows, plan.fat_row.shape[0],
            plan.fat_vertex.shape[0], _lib.stream_of(x))


def spmm_ell_vertex_cuda(x, col, wgt, row_ptr, deg) -> torch.Tensor:
    """Launch the vertex sum; returns the (n, d) f32 sums of each vertex's
    live slots, row by row in order (``ref.spmm_ell_vertex_ref``).
    Checks and plans the ELL once (vertex_plan, at SPLIT_ROWS); counts
    one ``spmm_ell`` launch a call, at the shape (rows of x, n, W, d)."""
    check_vertex_args(x, col, wgt, row_ptr, deg)
    _lib.check_cuda_tensors(NAME, x=x, col=col, wgt=wgt, row_ptr=row_ptr, deg=deg)
    n, d = deg.shape[0], x.shape[1]
    out = torch.empty((n, d), dtype=torch.float32, device=x.device)
    if n * d == 0:
        return out
    plan = vertex_plan(x, col, row_ptr, deg, SPLIT_ROWS)
    scratch = torch.empty((plan.fat_row.shape[0], d), dtype=torch.float32, device=x.device)
    rc = _vertex_launch()(*vertex_launch_args(x, col, wgt, row_ptr, deg, plan, scratch, out))
    _lib.check(rc, NAME)
    _lib.count_launch(NAME, (x.shape[0], n, col.shape[1], d))
    return out
