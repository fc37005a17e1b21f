"""Shared GNN building blocks.

Message passing is a gather of source rows and a segment reduce over an
edge-index list, as in the JAX package (``index_select`` and
``index_add_``/``scatter_reduce_`` here, ``jnp.take`` and
``jax.ops.segment_*`` there).  The ``spmm_ell`` kernel computes the
same neighbour sum over an ELL layout of the graph (``gnn/ell.py``);
GIN's forward runs through it, :func:`segment_sum` runs every segment
sum of EGNN, MACE and DimeNet through it over a segment ELL, and
:func:`gather_rows` their gathers' backward.

Single device only.  The port has the JAX package's ``Topology`` and
trains and serves the LMs across ranks, but the GNNs' sharded segment
ops (``segment_output_sharding``, ``aligned_scatter``,
``scatter_sum_owner_aligned``, ``align_segments``) and the GNNs across
ranks are still to be ported (ROADMAP.md Queue 1).  Segment ids must lie
in [0, n).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import fan_in_init
from repro_torch.models.gnn.ell import (
    Recent,
    neighbor_sum,
    segment_count,
    segment_ell,
    segment_transpose,
)

#: the segment sum's routes: the kernel over a segment ELL, or the plain
#: ``index_add_`` (the JAX package's ``jax.ops.segment_sum``)
AGG_IMPLS = ("spmm_ell", "segment_sum")


def scatter_sum(values, index, n) -> torch.Tensor:
    """(n, ...) sums of ``values`` rows by segment ``index``."""
    out = torch.zeros((n, *values.shape[1:]), dtype=values.dtype,
                      device=values.device)
    return out.index_add_(0, index, values)


def segment_sum(values, index, mask, n, agg_impl: str = "spmm_ell") -> torch.Tensor:
    """(n, ...) sums of the ``values`` rows by segment ``index``, each
    row weighted by ``mask`` (every caller's values carry the mask
    already, so the weight changes no sum).
    ``agg_impl="spmm_ell"`` sums the live rows (nonzero mask) over the
    memoised segment ELL through the kernel's vertex sum (``VertexSum``:
    its backward is the gather over the transpose, on the card the same
    kernel), in f32: a bf16 table is upcast exactly and the sums cast
    back; ``"segment_sum"`` is :func:`scatter_sum`."""
    if agg_impl == "segment_sum":
        return scatter_sum(values, index, n)
    if agg_impl != "spmm_ell":
        raise ValueError(f"agg_impl must be one of {AGG_IMPLS}, got {agg_impl!r}")
    return _kernel_segment_sum(values, index, mask, n)


def _kernel_segment_sum(values, index, mask, n) -> torch.Tensor:
    ell = segment_ell(index, mask, n)
    width = math.prod(values.shape[1:])
    # at least f32, the kernel's type (float64 stays, for gradcheck on the CPU)
    dtype = torch.promote_types(values.dtype, torch.float32)
    flat = values.reshape(values.shape[0], width).to(dtype).contiguous()
    out = neighbor_sum(ell, flat, lambda: segment_transpose(index, mask, n))
    return out.reshape((n, *values.shape[1:])).to(values.dtype)


def segment_mean(values, index, mask, n, agg_impl: str = "spmm_ell",
                 eps: float = 1e-9) -> torch.Tensor:
    """:func:`segment_sum` over each segment's row count, masked rows
    counted as the JAX package's ``scatter_mean`` counts them: the
    memoised :func:`ell.segment_count` on the kernel route (no launch),
    the plain :func:`scatter_mean` on the other."""
    if agg_impl == "segment_sum":
        return scatter_mean(values, index, n, eps)
    s = segment_sum(values, index, mask, n, agg_impl)
    cnt = segment_count(index, mask, n).to(values.dtype)
    return s / torch.clamp(cnt, min=eps)[:, None]


#: the packed batch's keys, and what each is shifted by in the flat one
_PACKED = {"x": None, "coords": None, "edge_mask": None, "tri_mask": None,
           "edge_src": "n", "edge_dst": "n", "tri_kj": "e", "tri_ji": "e"}
#: the last packed batch flattened
_BLOCK = Recent(1)


def block_diagonal(batch: dict) -> dict:
    """A packed molecule batch (B graphs of n nodes, e edge slots and T
    triplet slots; ``y`` is left out) as one block-diagonal graph: nodes
    (B n, ...), graph b's edges shifted by b n and its triplets' edge ids
    by b e, so each segment sum of a layer is one launch, not B.  Remembered for the
    last batch asked (its tensors' identity and versions), so a train
    step's ELLs are built once for the batch, not once a step."""
    keys = tuple(k for k in _PACKED if k in batch)
    return _BLOCK.get(tuple(batch[k] for k in keys), keys, lambda: _flatten(batch, keys))


def _flatten(batch: dict, keys: tuple) -> dict:
    B, n = batch["x"].shape[:2]
    step = {"n": n, "e": batch["edge_src"].shape[1]}
    flat = {}
    for k in keys:
        v = batch[k]
        if _PACKED[k] is not None:
            v = v + (torch.arange(B, device=v.device) * step[_PACKED[k]])[:, None].to(v.dtype)
        flat[k] = v.reshape(B * v.shape[1], *v.shape[2:])
    return flat


def node_nll(logits, labels) -> torch.Tensor:
    """Mean cross-entropy of (N, C) logits against int labels (N,).
    The label's logit is picked by a mask, not a gather, so the backward
    scatters nothing."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    pick = labels.long()[:, None] == torch.arange(logits.shape[1], device=logits.device)
    return torch.mean(logz - torch.where(pick, logits, 0.0).sum(-1))


def scatter_mean(values, index, n, eps: float = 1e-9) -> torch.Tensor:
    s = scatter_sum(values, index, n)
    cnt = scatter_sum(torch.ones(values.shape[:1], dtype=values.dtype,
                                 device=values.device), index, n)
    return s / torch.clamp(cnt, min=eps)[:, None]


def scatter_max(values, index, n) -> torch.Tensor:
    """(n, ...) maxima by segment; -inf for an empty segment, as
    ``jax.ops.segment_max`` gives."""
    out = torch.full((n, *values.shape[1:]), float("-inf"), dtype=values.dtype,
                     device=values.device)
    idx = index.long().reshape(-1, *([1] * (values.dim() - 1))).expand_as(values)
    return out.scatter_reduce_(0, idx, values, "amax", include_self=False)


def gather_src(x, edge_src) -> torch.Tensor:
    return x.index_select(0, edge_src)


class _GatherRows(torch.autograd.Function):
    """``x.index_select(0, index)``, whose gradient is the kernel route's
    segment sum of g over ``segment_ell(index, mask, rows of x)``."""

    @staticmethod
    def forward(ctx, x, index, mask):
        # saved, so that autograd raises if either is written before the
        # backward (the segment memo would rebuild from the new index)
        ctx.save_for_backward(index, mask)
        ctx.rows = x.shape[0]
        return x.index_select(0, index)

    @staticmethod
    def backward(ctx, g):
        index, mask = ctx.saved_tensors
        return _kernel_segment_sum(g, index, mask, ctx.rows), None, None


def gather_rows(x, index, mask, agg_impl: str = "spmm_ell") -> torch.Tensor:
    """``x.index_select(0, index)``: every row, masked or not, as the JAX
    package's ``jnp.take`` gathers.  Its gradient, the segment sum of g
    by ``index``, takes ``agg_impl``'s route: ``"segment_sum"`` keeps
    ``index_select``'s own backward (atomic adds, in bf16 for a bf16
    table); ``"spmm_ell"`` sums g's live rows (nonzero ``mask``) over the
    memoised segment ELL through the kernel, as :func:`segment_sum` does
    (in f32, a bf16 table upcast and cast back), the same bits every run.

    That backward leaves out g's masked rows, so it is exact only where g
    is 0 at every masked row: where each path from a gathered row to the
    loss is multiplied by the row's mask.  Every call site in EGNN, MACE
    and DimeNet meets this (``tests/test_torch_gnn_zoo.py`` hooks each)."""
    if agg_impl == "segment_sum":
        return x.index_select(0, index)
    if agg_impl != "spmm_ell":
        raise ValueError(f"agg_impl must be one of {AGG_IMPLS}, got {agg_impl!r}")
    return _GatherRows.apply(x, index, mask)


def init_mlp(gen: torch.Generator, dims, dtype=torch.float32) -> dict:
    """Weights ``w{i}`` (dims[i], dims[i+1]), fan-in scaled, and zero
    biases ``b{i}``, on ``gen``'s device."""
    p = {f"w{i}": fan_in_init(gen, (dims[i], dims[i + 1]), dims[i], dtype)
         for i in range(len(dims) - 1)}
    p |= {f"b{i}": torch.zeros((dims[i + 1],), dtype=dtype, device=gen.device)
          for i in range(len(dims) - 1)}
    return p


def mlp_apply(p, x, act=F.silu, final_act: bool = False):
    n = len([k for k in p if k.startswith("w")])
    for i in range(n):
        x = x @ p[f"w{i}"] + p[f"b{i}"]
        if i < n - 1 or final_act:
            x = act(x)
    return x
