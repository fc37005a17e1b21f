"""The neighbour ELL: the in-edges of every vertex as padded ELL rows,
the layout the ``spmm_ell`` kernel sums over.  It plays for GNN message
passing the role ``core/selfstab.py::in_ell`` plays for SSSP, with
three differences: ``wgt`` is the edge mask as f32 (a masked edge
counts 0, as in GIN's ``x[src] * mask``); padding is ``col = n``,
``wgt = 0`` (the JAX package's ``spmm_ell`` op points it at a zero row
appended to the features); and a vertex's virtual rows are combined by
a sum.

A vertex of in-degree > W is split into ceil(deg / W) virtual rows, as
``graph/partition.py::chunk_fat_rows`` splits fat rows, and every
vertex has at least one row.  Slots keep the edges' order (a stable
sort by destination), so a vertex's rows are contiguous and its live
slots are the first ``deg[v]`` of them: ``row_ptr`` and ``deg`` say
where, and the vertex sum reads only those, never the padding.  The
build runs in torch on the edges' device, so on the card it is a sort
there.

The transpose ELL is the neighbour ELL of the reversed edges
(``build_neighbor_ell(edge_dst, edge_src, edge_mask, n)``): the vertex
sum over it is the gradient of the vertex sum over the neighbour ELL,
so training builds it (once a graph) for the backward.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import VertexSum

# memo of the last graph only, so a graph the caller drops pins no more
# than its two ELLs on the card: (key, edge tensors, {"forward": ELL,
# "transpose": ELL}, each built at first need), keyed by the edge
# tensors' identity and version counters (an in-place torch update
# invalidates) + n; it holds its edge tensors, so their ids are not
# reused while it lives
_LAST: tuple | None = None


class NeighborELL(NamedTuple):
    row_ptr: torch.Tensor  # (n+1,) int64, vertex v's rows row_ptr[v] .. row_ptr[v+1]-1
    deg: torch.Tensor      # (n,) int32 in-degree: v's live slots
    col: torch.Tensor      # (R, W) int32 source vertex; n for padding
    wgt: torch.Tensor      # (R, W) f32 edge mask; 0 for padding
    n: int


def build_neighbor_ell(edge_src, edge_dst, edge_mask, n: int,
                       width: int | None = None) -> NeighborELL:
    """The neighbour ELL of ``n`` vertices and the edges
    ``edge_src -> edge_dst`` (int tensors), weighted by ``edge_mask``;
    W = ``width`` or min(64, max in-degree)."""
    dev, m = edge_dst.device, edge_dst.shape[0]
    if m:
        lo = int(torch.minimum(edge_src.min(), edge_dst.min()))
        hi = int(torch.maximum(edge_src.max(), edge_dst.max()))
        if lo < 0 or hi >= n:
            raise ValueError(f"edge endpoints must lie in [0, {n}), got [{lo}, {hi}]")
    dst = edge_dst.long()
    order = torch.argsort(dst, stable=True)
    dst_sorted = dst[order]
    deg = torch.bincount(dst, minlength=n)
    W = int(width or max(1, min(64, int(deg.max()))))
    chunks = torch.clamp((deg + W - 1) // W, min=1)  # >= 1: empty rows exist
    row_ptr = torch.cat([chunks.new_zeros(1), torch.cumsum(chunks, 0)])
    R = int(row_ptr[-1])
    # each edge's flat (virtual row, slot) position: its vertex's first
    # row times W plus its rank among the vertex's in-edges
    rank = torch.arange(m, device=dev) - (torch.cumsum(deg, 0) - deg)[dst_sorted]
    flat = row_ptr[dst_sorted] * W + rank
    col = torch.full((R * W,), n, dtype=torch.int32, device=dev)
    wgt = torch.zeros((R * W,), dtype=torch.float32, device=dev)
    col[flat] = edge_src[order].to(torch.int32)
    wgt[flat] = edge_mask[order].to(torch.float32)
    return NeighborELL(row_ptr, deg.to(torch.int32), col.view(R, W), wgt.view(R, W), n)


def _last_graph(edge_src, edge_dst, edge_mask, n: int) -> dict:
    global _LAST
    edges = (edge_src, edge_dst, edge_mask)
    key = (*(id(t) for t in edges), *(t._version for t in edges), n)
    if _LAST is None or _LAST[0] != key:
        _LAST = (key, edges, {})
    return _LAST[2]


def neighbor_ell(edge_src, edge_dst, edge_mask, n: int) -> NeighborELL:
    """:func:`build_neighbor_ell`, memoised for the last graph asked."""
    ells = _last_graph(edge_src, edge_dst, edge_mask, n)
    if "forward" not in ells:
        ells["forward"] = build_neighbor_ell(edge_src, edge_dst, edge_mask, n)
    return ells["forward"]


def transpose_ell(edge_src, edge_dst, edge_mask, n: int) -> NeighborELL:
    """The transpose ELL (the reversed edges' neighbour ELL), memoised
    with :func:`neighbor_ell`'s for the last graph asked."""
    ells = _last_graph(edge_src, edge_dst, edge_mask, n)
    if "transpose" not in ells:
        ells["transpose"] = build_neighbor_ell(edge_dst, edge_src, edge_mask, n)
    return ells["transpose"]


def _layout(ell: NeighborELL) -> tuple:
    return ell.col, ell.wgt, ell.row_ptr, ell.deg


def neighbor_sum(ell: NeighborELL, x, transpose=None) -> torch.Tensor:
    """(n, d) ``sum over in-edges (src -> v) of x[src] * mask``: the
    kernel op's vertex sum, each row's live slots in order, then each
    vertex's rows in order (the same bits every call).  Differentiable
    in x (``VertexSum``): the backward sums the incoming gradient over
    ``transpose()``, the transpose ELL (:func:`transpose_ell`), called at
    the first backward; without it x must need no gradient."""
    t = None if transpose is None else (lambda: _layout(transpose()))
    return VertexSum.apply(x, _layout(ell), t)
