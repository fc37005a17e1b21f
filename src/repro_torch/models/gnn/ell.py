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

A segment ELL (:func:`build_segment_ell`) lays out the reference's
``scatter_sum(values, index, n)`` for the same kernel over the live
rows of a (T, d) value table, those of nonzero ``mask``: its "edges"
are ``t -> index[t]`` at weight ``mask[t]`` for those rows t, so its col
entries are value-row ids in [0, T), grouped by segment in stable
order, ``deg[v]`` counts v's live rows and W is set by the live
segments.  A masked row has no slot.  Every caller's values carry the
mask already, so on finite values such a row only ever added x * 0 =
+-0; and the padding of a sampled block (masked edges 0 -> 0, masked
triplets (0, 0)) makes no fat segment of vertex 0 or edge 0.  Its
transpose is the W = 1 ELL of T rows whose one slot is ``index[t]`` at
weight ``mask[t]``, live where the row is (:func:`build_segment_transpose`):
the vertex sum over it is the gather ``g[index] * mask``, +0 at a masked
row, which reads nothing of g.  The segment mean's count, which counts
masked rows as the reference's ``scatter_mean`` does, is a tensor of its
own beside them (:func:`segment_count`).
EGNN, MACE and DimeNet sum edge rows into nodes and triplet rows into
edges this way (``layers.py::segment_sum``), and take the gradient of
their gathers over the same ELL (``layers.py::gather_rows``).

A bag ELL (:func:`build_bag_ell`) is the segment ELL of an embedding
bag's ``B x L`` table ids, each slot's column its bag (``t // L``) in
place of its row: the vertex sum of the bag's (B, d) incoming gradient
over it is the table's gradient, and reads no (B L, d) copy of it
(``kernels/embedding_bag/ops.py::BagSum``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import VertexSum
from repro_torch.kernels.spmm_ell.kernel import PLANS_KEPT


class Recent:
    """The last ``size`` values built, newest first, each keyed by the
    identity and version counters of its tensors (an in-place torch
    update invalidates) and a tuple of other keys; an entry holds its
    tensors, so their ids are not reused while it lives."""

    def __init__(self, size: int):
        self.size, self.entries = size, []

    def get(self, tensors: tuple, extra: tuple, build):
        """The value kept for (``tensors``, ``extra``), else ``build()``'s."""
        key = (*(id(t) for t in tensors), *(t._version for t in tensors), *extra)
        for i, (old, _, value) in enumerate(self.entries):
            if old == key:
                self.entries.insert(0, self.entries.pop(i))
                return value
        self.entries.insert(0, (key, tensors, build()))
        del self.entries[self.size:]
        return self.entries[0][2]


# the last graph only, so a graph the caller drops pins no more than its
# two ELLs on the card: {"forward": ELL, "transpose": ELL}, each built at
# first need
_GRAPHS = Recent(1)
# the layouts of a segment index, one entry an (index, mask, n):
# {"forward": ELL, "transpose": ELL, "count": tensor}, each built at
# first need; half as many indices as the kernel keeps plans, since each
# is summed over forward and transposed (a DimeNet step gathers and sums
# over four: edge_src, edge_dst, tri_kj, tri_ji)
_SEGMENTS = Recent(PLANS_KEPT // 2)


class NeighborELL(NamedTuple):
    row_ptr: torch.Tensor  # (n+1,) int64, vertex v's rows row_ptr[v] .. row_ptr[v+1]-1
    deg: torch.Tensor      # (n,) int32 in-degree: v's live slots
    col: torch.Tensor      # (R, W) int32 source vertex; n for padding
    wgt: torch.Tensor      # (R, W) f32 edge mask; 0 for padding
    n: int


def build_neighbor_ell(edge_src, edge_dst, edge_mask, n: int,
                       width: int | None = None, n_src: int | None = None) -> NeighborELL:
    """The neighbour ELL of ``n`` vertices and the edges
    ``edge_src -> edge_dst`` (int tensors), weighted by ``edge_mask``;
    W = ``width`` or min(64, max in-degree).  Sources lie in [0,
    ``n_src``) (default n): the rows of the table the sum reads."""
    dev, m = edge_dst.device, edge_dst.shape[0]
    n_src = n if n_src is None else n_src
    if m:
        lo_s, hi_s, lo_d, hi_d = torch.stack([edge_src.min(), edge_src.max(),
                                              edge_dst.min(), edge_dst.max()]).tolist()
        if min(lo_s, lo_d) < 0 or hi_s >= n_src or hi_d >= n:
            raise ValueError(f"edge sources must lie in [0, {n_src}) and destinations in "
                             f"[0, {n}), got [{lo_s}, {hi_s}] and [{lo_d}, {hi_d}]")
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


def neighbor_ell(edge_src, edge_dst, edge_mask, n: int) -> NeighborELL:
    """:func:`build_neighbor_ell`, memoised for the last graph asked."""
    ells = _GRAPHS.get((edge_src, edge_dst, edge_mask), (n,), dict)
    if "forward" not in ells:
        ells["forward"] = build_neighbor_ell(edge_src, edge_dst, edge_mask, n)
    return ells["forward"]


def transpose_ell(edge_src, edge_dst, edge_mask, n: int) -> NeighborELL:
    """The transpose ELL (the reversed edges' neighbour ELL), memoised
    with :func:`neighbor_ell`'s for the last graph asked."""
    ells = _GRAPHS.get((edge_src, edge_dst, edge_mask), (n,), dict)
    if "transpose" not in ells:
        ells["transpose"] = build_neighbor_ell(edge_dst, edge_src, edge_mask, n)
    return ells["transpose"]


def _check_segment_ids(index, n: int) -> None:
    if index.shape[0]:
        lo, hi = torch.stack([index.min(), index.max()]).tolist()
        if lo < 0 or hi >= n:
            raise ValueError(f"segment ids must lie in [0, {n}), got [{lo}, {hi}]")


def build_segment_ell(index, mask, n: int) -> NeighborELL:
    """The segment ELL of ``index`` (T segment ids in [0, n)) over the
    rows of nonzero ``mask``: n rows of value-row ids (the rows ``t ->
    index[t]``), each weighted by ``mask[t]``."""
    _check_segment_ids(index, n)
    live = torch.nonzero(mask).flatten()
    return build_neighbor_ell(live, index[live], mask[live], n, n_src=index.shape[0])


def build_segment_transpose(index, mask, n: int) -> NeighborELL:
    """The W = 1 transpose of :func:`build_segment_ell`'s ELL: T rows,
    row t's one slot ``index[t]`` at weight ``mask[t]``, live (``deg`` 1)
    where the mask is nonzero and empty (``deg`` 0) where it is not."""
    _check_segment_ids(index, n)
    T, dev = index.shape[0], index.device
    return NeighborELL(torch.arange(T + 1, device=dev), (mask != 0).to(torch.int32),
                       index.to(torch.int32).reshape(T, 1).contiguous(),
                       mask.to(torch.float32).reshape(T, 1).contiguous(), T)


def build_bag_ell(idx, w, n: int) -> NeighborELL:
    """The bag ELL of the (B, L) table ids ``idx`` (in [0, n)) and their
    weights ``w``: :func:`build_segment_ell`'s layout of ``idx`` over the
    slots t = (b, l) of nonzero weight, each slot's column its bag b = t //
    L, so n rows of bag ids in [0, B), a row's slots in flat order, each
    weighted by ``w[b, l]``."""
    B, L = idx.shape
    flat_w = w.reshape(-1)
    live = torch.nonzero(flat_w).flatten()
    return build_neighbor_ell(live // L, idx.reshape(-1)[live], flat_w[live], n, n_src=B)


def _kept(index, mask, n: int, way: str, build):
    layouts = _SEGMENTS.get((index, mask), (n,), dict)
    if way not in layouts:
        layouts[way] = build(index, mask, n)
    return layouts[way]


def segment_ell(index, mask, n: int) -> NeighborELL:
    """:func:`build_segment_ell`, memoised for the last PLANS_KEPT / 2
    (index, mask, n) asked."""
    return _kept(index, mask, n, "forward", build_segment_ell)


def segment_transpose(index, mask, n: int) -> NeighborELL:
    """:func:`build_segment_transpose`, memoised with
    :func:`segment_ell`'s."""
    return _kept(index, mask, n, "transpose", build_segment_transpose)


def segment_count(index, mask, n: int) -> torch.Tensor:
    """(n,) int64 rows of each segment, masked or not (the reference's
    ``scatter_mean`` count), memoised with :func:`segment_ell`'s."""
    return _kept(index, mask, n, "count",
                 lambda index, mask, n: torch.bincount(index.long(), minlength=n))


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
