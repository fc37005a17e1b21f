"""mace [arXiv:2206.07697].

2 layers, d_hidden 128, l_max 2, correlation order 3, 8 radial Bessel
functions, E(3)-equivariant ACE features (``models/gnn/mace.py`` has
the invariant-channel variant).  The reduced config keeps ``d_in=10``
on every cell, as the JAX package's does.  On the card the density
``A`` of every layer sums through the ``spmm_ell`` kernel.
"""

from repro_torch.configs.cells import GNN_SHAPES, gnn_train_cell
from repro_torch.models.gnn import mace

ARCH_ID = "mace"
FAMILY = "gnn"
SHAPES = list(GNN_SHAPES)


def make_config(reduced: bool = False, cell: str = "molecule") -> mace.MACEConfig:
    sh = GNN_SHAPES.get(cell, GNN_SHAPES["molecule"])
    d_in = sh.get("d_feat", 10)
    n_classes = 0 if cell == "molecule" else sh.get("classes", 0)
    if reduced:
        return mace.MACEConfig(n_layers=2, d_hidden=16, d_in=10, n_classes=n_classes)
    return mace.MACEConfig(n_layers=2, d_hidden=128, l_max=2, correlation=3, n_rbf=8,
                           d_in=d_in, n_classes=n_classes)


def _flops(cell: str, cfg) -> float:
    sh = GNN_SHAPES[cell]
    e = sh["e"] * (sh.get("batch", 1))
    n = sh["n"] * (sh.get("batch", 1))
    C = cfg.d_hidden
    # per edge: radial MLP + C*9 message; per node: C*9^3 bispectrum
    per_edge = 2 * (cfg.n_rbf * 32 + 32 * C * 3) + 2 * C * 9
    per_node = 2 * C * 9 ** 3 + 2 * C * (C * 9 + C)
    return 3.0 * cfg.n_layers * (e * per_edge + n * per_node)


def make_cell(cell: str, ranks: int = 1, reduced: bool = False):
    """Every mace cell trains (the JAX package's ``gnn_train_cell``)."""
    if cell not in GNN_SHAPES:
        raise KeyError(f"unknown {ARCH_ID} cell {cell!r}: {SHAPES}")
    cfg = make_config(reduced, cell)
    loss = mace.regression_loss if cell == "molecule" else mace.node_classification_loss
    return gnn_train_cell(ARCH_ID, cell, loss, mace.init_params, cfg, ranks,
                          coords=True, triplets=False, model_flops=_flops(cell, cfg))
