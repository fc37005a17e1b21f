"""Architecture registry of the port: ``--arch <id>`` resolves here.

Each ported module exposes ARCH_ID, FAMILY, SHAPES, make_config(reduced)
(the GNN archs' also take the cell) and make_cell(cell, ranks, reduced),
which returns a :class:`~repro_torch.configs.cells.CellPlan`.

The JAX package's registry holds ten assigned architectures and the
paper's own SSSP workload: 47 (arch, cell) pairs.  The port plans
every one of them: :func:`all_cells` returns them in the same order.
"""

from repro_torch.configs import (
    dbrx,
    dimenet_cfg,
    egnn_cfg,
    gin_tu,
    mace_cfg,
    mind_cfg,
    minicpm3,
    minitron,
    phi3_mini,
    phi35_moe,
    sssp_cfg,
)
from repro_torch.configs.cells import GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES

_MODULES = [phi35_moe, dbrx, phi3_mini, minitron, minicpm3, mace_cfg, gin_tu, egnn_cfg,
            dimenet_cfg, mind_cfg, sssp_cfg]

REGISTRY = {m.ARCH_ID: m for m in _MODULES}

#: the JAX package's architectures in its registry's order, with the
#: family that names their cells
REFERENCE_ARCHS = (
    ("phi3.5-moe-42b-a6.6b", "lm"), ("dbrx-132b", "lm"),
    ("phi3-mini-3.8b", "lm"), ("minitron-8b", "lm"), ("minicpm3-4b", "lm"),
    ("mace", "gnn"), ("gin-tu", "gnn"), ("egnn", "gnn"), ("dimenet", "gnn"),
    ("mind", "recsys"), ("sssp", "graph"),
)
ASSIGNED = [a for a, _ in REFERENCE_ARCHS if a != "sssp"]

_SHAPES = {"lm": LM_SHAPES, "gnn": GNN_SHAPES, "recsys": RECSYS_SHAPES,
           "graph": sssp_cfg.SSSP_CELLS}


def reference_cells(include_sssp: bool = True) -> list:
    """The JAX package's ``all_cells()``: every (arch, cell) pair."""
    return [(a, c) for a, fam in REFERENCE_ARCHS
            if include_sssp or a != "sssp" for c in _SHAPES[fam]]


def get_arch(arch_id: str):
    if arch_id not in REGISTRY:
        raise KeyError(
            f"unknown or not yet ported arch {arch_id!r} (ROADMAP.md lists "
            f"what is still to port); ported: {sorted(REGISTRY)}"
        )
    return REGISTRY[arch_id]


def list_cells(arch_id: str) -> list:
    return list(get_arch(arch_id).SHAPES)


def all_cells(include_sssp: bool = True) -> list:
    """The (arch, cell) pairs the port plans: all of the JAX package's."""
    return reference_cells(include_sssp)
