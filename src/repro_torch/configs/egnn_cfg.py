"""egnn [arXiv:2102.09844].

4 layers, d_hidden 64, E(n)-equivariant coordinate updates.  On the
card both segment sums of every layer (messages and coordinates) run
through the ``spmm_ell`` kernel, forward and backward.
"""

from repro_torch.configs.cells import GNN_SHAPES, gnn_train_cell
from repro_torch.models.gnn import egnn

ARCH_ID = "egnn"
FAMILY = "gnn"
SHAPES = list(GNN_SHAPES)


def make_config(reduced: bool = False, cell: str = "molecule") -> egnn.EGNNConfig:
    sh = GNN_SHAPES.get(cell, GNN_SHAPES["molecule"])
    d_in = sh.get("d_feat", 10)
    n_classes = 0 if cell == "molecule" else sh.get("classes", 0)
    if reduced:
        return egnn.EGNNConfig(n_layers=2, d_hidden=16, d_in=d_in, n_classes=n_classes)
    return egnn.EGNNConfig(n_layers=4, d_hidden=64, d_in=d_in, n_classes=n_classes)


def _flops(cell: str, cfg) -> float:
    sh = GNN_SHAPES[cell]
    e = sh["e"] * sh.get("batch", 1)
    n = sh["n"] * sh.get("batch", 1)
    d = cfg.d_hidden
    per_edge = 2 * ((2 * d + 1) * d + d * d + d * d + d)
    per_node = 2 * (2 * d * d + d * d)
    return 3.0 * cfg.n_layers * (e * per_edge + n * per_node)


def make_cell(cell: str, ranks: int = 1, reduced: bool = False):
    """Every egnn cell trains (the JAX package's ``gnn_train_cell``)."""
    if cell not in GNN_SHAPES:
        raise KeyError(f"unknown {ARCH_ID} cell {cell!r}: {SHAPES}")
    cfg = make_config(reduced, cell)
    loss = egnn.regression_loss if cell == "molecule" else egnn.node_classification_loss
    return gnn_train_cell(ARCH_ID, cell, loss, egnn.init_params, cfg, ranks,
                          coords=True, triplets=False, model_flops=_flops(cell, cfg))
