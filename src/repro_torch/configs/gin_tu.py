"""gin-tu [arXiv:1810.00826].

5 layers, d_hidden 64, sum aggregator, learnable eps.  On the card the
neighbour sum of every layer runs through the ``spmm_ell`` kernel.
"""

from repro_torch.configs.cells import GNN_SHAPES
from repro_torch.models.gnn.gin import GINConfig

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
