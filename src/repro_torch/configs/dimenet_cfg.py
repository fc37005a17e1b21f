"""dimenet [arXiv:2003.03123].

6 blocks, d_hidden 128, n_bilinear 8, n_spherical 7, n_radial 6.
Triplet lists are exact for the molecule cell and capped at 2 per edge
for the web-scale graphs (DimeNet is molecular; an OGB-scale topology
needs the truncation), with bf16 messages there, as the JAX package
has them.  On the card both segment sums of every block (triplets into
edges, edges into nodes) run through the ``spmm_ell`` kernel, in f32.
"""

from repro_torch.configs.cells import GNN_SHAPES, gnn_train_cell
from repro_torch.models.gnn import dimenet

ARCH_ID = "dimenet"
FAMILY = "gnn"
SHAPES = list(GNN_SHAPES)
TRIPLET_CAP = 2


def make_config(reduced: bool = False, cell: str = "molecule") -> dimenet.DimeNetConfig:
    sh = GNN_SHAPES.get(cell, GNN_SHAPES["molecule"])
    d_in = sh.get("d_feat", 10)
    n_classes = 0 if cell == "molecule" else sh.get("classes", 0)
    if reduced:
        return dimenet.DimeNetConfig(n_blocks=2, d_hidden=16, d_in=d_in,
                                     n_classes=n_classes, n_bilinear=4)
    # bf16 messages on the web-scale cells; exact f32 for molecules
    mdt = "float32" if cell == "molecule" else "bfloat16"
    return dimenet.DimeNetConfig(n_blocks=6, d_hidden=128, n_bilinear=8, n_spherical=7,
                                 n_radial=6, d_in=d_in, n_classes=n_classes, msg_dtype=mdt)


def _flops(cell: str, cfg) -> float:
    sh = GNN_SHAPES[cell]
    b = sh.get("batch", 1)
    e = sh["e"] * b
    t = (sh.get("triplet_pad", sh["e"] * TRIPLET_CAP)) * b
    d, nb = cfg.d_hidden, cfg.n_bilinear
    per_tri = 2 * (cfg.n_radial * cfg.n_spherical * nb + nb * d * d)
    per_edge = 2 * (3 * d * d)
    return 3.0 * cfg.n_blocks * (t * per_tri + e * per_edge)


def make_cell(cell: str, ranks: int = 1, reduced: bool = False):
    """Every dimenet cell trains (the JAX package's ``gnn_train_cell``)."""
    if cell not in GNN_SHAPES:
        raise KeyError(f"unknown {ARCH_ID} cell {cell!r}: {SHAPES}")
    cfg = make_config(reduced, cell)
    loss = dimenet.regression_loss if cell == "molecule" else dimenet.node_classification_loss
    return gnn_train_cell(ARCH_ID, cell, loss, dimenet.init_params, cfg, ranks,
                          coords=True, triplets=True, model_flops=_flops(cell, cfg))
