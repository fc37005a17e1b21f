"""gin-tu [arXiv:1810.00826].

5 layers, d_hidden 64, sum aggregator, learnable eps.  On the card the
neighbour sum of every layer runs through the ``spmm_ell`` kernel,
forward and (over the transpose ELL) backward.
"""

import torch

from repro_torch.configs.cells import GNN_SHAPES, gnn_train_cell
from repro_torch.models.gnn import gin
from repro_torch.models.gnn.gin import GINConfig
from repro_torch.models.gnn.layers import block_diagonal

ARCH_ID = "gin-tu"
FAMILY = "gnn"
SHAPES = list(GNN_SHAPES)


def make_config(reduced: bool = False, cell: str = "full_graph_sm") -> GINConfig:
    sh = GNN_SHAPES.get(cell, GNN_SHAPES["full_graph_sm"])
    d_in = sh.get("d_feat", 64)
    n_classes = max(2, sh.get("classes", 2))
    if reduced:
        return GINConfig(n_layers=2, d_hidden=16, d_in=d_in, n_classes=n_classes)
    return GINConfig(n_layers=5, d_hidden=64, d_in=d_in, n_classes=n_classes)


def _flops(cell: str, cfg) -> float:
    sh = GNN_SHAPES[cell]
    e = sh["e"] * sh.get("batch", 1)
    n = sh["n"] * sh.get("batch", 1)
    per_node = 2 * (cfg.d_hidden * cfg.d_hidden * 2)
    return 3.0 * cfg.n_layers * (e * cfg.d_hidden + n * per_node)


def _molecule_loss(params, batch, cfg):
    """Graph-level regression for the packed molecule cell: mean-pool
    each graph's node logits, then the squared error against ``y``,
    averaged over the B graphs.  The JAX package maps the forward over
    the graphs (``vmap``); here they are one block-diagonal graph of B·n
    nodes (``layers.block_diagonal``: graph b's edges shifted by b·n, kept
    for the batch, so its ELLs are built once), so each layer is one
    neighbour sum: one kernel launch, not B."""
    flat = block_diagonal(batch)
    logits = gin.forward(params, flat["x"], flat["edge_src"], flat["edge_dst"],
                         flat["edge_mask"], cfg)
    pred = torch.mean(logits.reshape(batch["x"].shape[0], -1), dim=1)
    return torch.mean((pred - batch["y"]) ** 2)


def make_cell(cell: str, ranks: int = 1, reduced: bool = False):
    """Every gin-tu cell trains (the JAX package's ``gnn_train_cell``)."""
    if cell not in GNN_SHAPES:
        raise KeyError(f"unknown {ARCH_ID} cell {cell!r}: {SHAPES}")
    cfg = make_config(reduced, cell)
    loss = _molecule_loss if cell == "molecule" else gin.node_classification_loss
    return gnn_train_cell(ARCH_ID, cell, loss, gin.init_params, cfg, ranks,
                          coords=False, triplets=False, model_flops=_flops(cell, cfg))
