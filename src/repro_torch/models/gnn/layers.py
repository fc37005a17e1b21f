"""Shared GNN building blocks.

Message passing is a gather of source rows and a segment reduce over an
edge-index list, as in the JAX package (``index_select`` and
``index_add_``/``scatter_reduce_`` here, ``jnp.take`` and
``jax.ops.segment_*`` there).  The ``spmm_ell`` kernel computes the
same neighbour sum over an ELL layout of the graph (``gnn/ell.py``);
GIN's forward runs through it.

Single device only: the JAX package's ``segment_output_sharding``,
``aligned_scatter`` and ``scatter_sum_owner_aligned`` wait for the
Topology/TP port (ROADMAP.md).  Segment ids must lie in [0, n).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import fan_in_init


def scatter_sum(values, index, n) -> torch.Tensor:
    """(n, ...) sums of ``values`` rows by segment ``index``."""
    out = torch.zeros((n, *values.shape[1:]), dtype=values.dtype,
                      device=values.device)
    return out.index_add_(0, index, values)


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
