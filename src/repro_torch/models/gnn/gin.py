"""GIN (Graph Isomorphism Network, arXiv:1810.00826).

h_i' = MLP( (1 + eps) * h_i + sum_{j in N(i)} h_j ),  eps learnable.
Assigned config: 5 layers, d_hidden 64, sum aggregator.

The neighbour sum takes one of two routes, chosen by
``GINConfig.agg_impl``: ``"spmm_ell"`` sums over the graph's neighbour
ELL through the ``spmm_ell`` kernel op's vertex sum (the plain version
on the CPU), each vertex's live slots row by row in order;
``"segment_sum"`` is the JAX package's
``scatter_sum(gather_src(x, edge_src) * mask, edge_dst, n)``, walked in
chunks of edges so that the gathered messages stay a few GB at
ogb-products scale.  Tests and the card's reference check use the
second.  Both routes are differentiable: the first through
``VertexSum``, whose backward runs the same kernel over the transpose
ELL; the second through torch's own autograd.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models.gnn.ell import neighbor_ell, neighbor_sum, transpose_ell
from repro_torch.models.gnn.layers import AGG_IMPLS, gather_src, init_mlp, mlp_apply, node_nll

EDGE_CHUNK = 1 << 22  # edges a step of the segment-sum route gathers


@dataclasses.dataclass(frozen=True)
class GINConfig:
    name: str = "gin-tu"
    n_layers: int = 5
    d_hidden: int = 64
    d_in: int = 64
    n_classes: int = 7
    agg_impl: str = "spmm_ell"  # one of AGG_IMPLS

    def __post_init__(self):
        if self.agg_impl not in AGG_IMPLS:
            raise ValueError(f"agg_impl must be one of {AGG_IMPLS}, got {self.agg_impl!r}")


def init_params(gen: torch.Generator, cfg: GINConfig) -> dict:
    """The JAX package's layout: ``layers[i].mlp.{w0,b0,w1,b1}``,
    ``layers[i].eps`` (0) and ``readout.{w0,b0}``, on ``gen``'s
    device."""
    layers = []
    for i in range(cfg.n_layers):
        d_in = cfg.d_in if i == 0 else cfg.d_hidden
        layers.append({
            "mlp": init_mlp(gen, [d_in, cfg.d_hidden, cfg.d_hidden]),
            "eps": torch.zeros((), device=gen.device),
        })
    return {"layers": layers,
            "readout": init_mlp(gen, [cfg.d_hidden, cfg.n_classes])}


def segment_neighbor_sum(x, edge_src, edge_dst, w) -> torch.Tensor:
    """(n, d) ``scatter_sum(gather_src(x, edge_src) * w, edge_dst, n)``,
    EDGE_CHUNK edges at a time.  The sum is ``scatter_add_``, whose
    backward keeps only the index: ``index_add_``'s keeps every chunk of
    messages, 16 GB a layer at ogb-products scale."""
    out = torch.zeros_like(x)
    for lo in range(0, edge_src.shape[0], EDGE_CHUNK):
        hi = lo + EDGE_CHUNK
        msgs = gather_src(x, edge_src[lo:hi]) * w[lo:hi]
        out.scatter_add_(0, edge_dst[lo:hi].long()[:, None].expand_as(msgs), msgs)
    return out


def forward(params, x, edge_src, edge_dst, edge_mask, cfg: GINConfig):
    """Node logits (N, n_classes).  Edge tensors are int32 or int64;
    the spmm_ell route memoises the neighbour ELL per edge tensors (and
    the transpose ELL, at the first backward)."""
    n = x.shape[0]
    if cfg.agg_impl == "spmm_ell":
        edges = (edge_src, edge_dst, edge_mask)
        ell = neighbor_ell(*edges, n)

        def aggregate(h):
            return neighbor_sum(ell, h, lambda: transpose_ell(*edges, n))
    else:
        w = edge_mask.to(x.dtype)[:, None]

        def aggregate(h):
            return segment_neighbor_sum(h, edge_src, edge_dst, w)
    for lp in params["layers"]:
        x = mlp_apply(lp["mlp"], (1.0 + lp["eps"]) * x + aggregate(x), act=F.relu)
    return mlp_apply(params["readout"], x)


def node_classification_loss(params, batch, cfg: GINConfig) -> torch.Tensor:
    """Mean cross-entropy of the node logits against ``batch["labels"]``
    (``layers.node_nll``: the backward scatters nothing)."""
    logits = forward(params, batch["x"], batch["edge_src"], batch["edge_dst"],
                     batch["edge_mask"], cfg)
    return node_nll(logits, batch["labels"])
