"""EGNN (E(n)-equivariant GNN, arXiv:2102.09844).

    m_ij  = phi_e(h_i, h_j, ||x_i - x_j||^2)
    x_i' = x_i + C sum_j (x_i - x_j) phi_x(m_ij)
    h_i' = phi_h(h_i, sum_j m_ij)

Assigned config: 4 layers, d_hidden 64.  Coordinates update
equivariantly (rotate and translate the inputs: h is invariant, x
equivariant).

Each layer has two segment sums over ``edge_dst``: the messages (E, d)
and the coordinate update (E, 3), whose mean divides by the segment's
row count, masked edges counted (the JAX package's ``scatter_mean``).
Both take ``EGNNConfig.agg_impl``'s route (``layers.py::segment_sum``):
on ``"spmm_ell"`` one segment ELL of ``edge_dst`` serves both sums of
every layer, and the count is kept beside it (``ell.segment_count``).
The gathers of h and the coordinates at both ends of every edge take
their backward on the same route (``layers.py::gather_rows``): the
segment ELLs of ``edge_src`` and ``edge_dst``.  Their gradient is 0 at a
masked edge, since the messages and the coordinate update carry the
edge mask.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.gnn.layers import (
    AGG_IMPLS,
    block_diagonal,
    gather_rows,
    init_mlp,
    mlp_apply,
    node_nll,
    segment_mean,
    segment_sum,
)


@dataclasses.dataclass(frozen=True)
class EGNNConfig:
    name: str = "egnn"
    n_layers: int = 4
    d_hidden: int = 64
    d_in: int = 64
    n_classes: int = 0       # 0 -> regression readout (energy)
    agg_impl: str = "spmm_ell"  # one of layers.AGG_IMPLS

    def __post_init__(self):
        if self.agg_impl not in AGG_IMPLS:
            raise ValueError(f"agg_impl must be one of {AGG_IMPLS}, got {self.agg_impl!r}")


def init_params(gen: torch.Generator, cfg: EGNNConfig) -> dict:
    """The JAX package's layout: ``layers[i].{phi_e, phi_x, phi_h}``
    and ``readout``, on ``gen``'s device."""
    d = cfg.d_hidden
    layers = []
    for i in range(cfg.n_layers):
        d_in = cfg.d_in if i == 0 else d
        layers.append({
            "phi_e": init_mlp(gen, [2 * d_in + 1, d, d]),
            "phi_x": init_mlp(gen, [d, d, 1]),
            "phi_h": init_mlp(gen, [d_in + d, d, d]),
        })
    out_dim = cfg.n_classes if cfg.n_classes > 0 else 1
    return {"layers": layers, "readout": init_mlp(gen, [d, d, out_dim])}


def forward(params, x, coords, edge_src, edge_dst, edge_mask, cfg: EGNNConfig):
    """Returns (node features (N, d), coords (N, 3))."""
    n = x.shape[0]
    w = edge_mask.to(x.dtype)[:, None]
    h = x

    def src(t):
        return gather_rows(t, edge_src, edge_mask, cfg.agg_impl)

    def dst(t):
        return gather_rows(t, edge_dst, edge_mask, cfg.agg_impl)

    for lp in params["layers"]:
        hs, hd = src(h), dst(h)
        diff = dst(coords) - src(coords)
        d2 = torch.sum(diff * diff, dim=-1, keepdim=True)
        m = mlp_apply(lp["phi_e"], torch.cat([hd, hs, d2], -1), final_act=True) * w
        xw = mlp_apply(lp["phi_x"], m)  # (E, 1)
        coords = coords + segment_mean(diff * xw * w, edge_dst, edge_mask, n, cfg.agg_impl)
        agg = segment_sum(m, edge_dst, edge_mask, n, cfg.agg_impl)
        h = mlp_apply(lp["phi_h"], torch.cat([h, agg], -1))
    return h, coords


def energy(params, x, coords, edge_src, edge_dst, edge_mask, cfg: EGNNConfig):
    h, _ = forward(params, x, coords, edge_src, edge_dst, edge_mask, cfg)
    return torch.sum(mlp_apply(params["readout"], h))


def regression_loss(params, batch, cfg: EGNNConfig):
    """Packed molecule batch: the mean squared error of each graph's
    energy.  The JAX package maps over the graphs (``vmap``); here they
    are one block-diagonal graph (``layers.block_diagonal``), so each
    segment sum is one launch."""
    flat = block_diagonal(batch)
    h, _ = forward(params, flat["x"], flat["coords"], flat["edge_src"], flat["edge_dst"],
                   flat["edge_mask"], cfg)
    # each graph's energy: the sum of its nodes' readout
    e = mlp_apply(params["readout"], h).reshape(batch["x"].shape[0], -1).sum(1)
    return torch.mean((e - batch["y"]) ** 2)


def node_classification_loss(params, batch, cfg: EGNNConfig):
    h, _ = forward(params, batch["x"], batch["coords"], batch["edge_src"],
                   batch["edge_dst"], batch["edge_mask"], cfg)
    return node_nll(mlp_apply(params["readout"], h), batch["labels"])
