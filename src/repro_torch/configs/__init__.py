"""Architecture registry of the port: ``--arch <id>`` resolves here.

Each ported module exposes ARCH_ID, FAMILY, SHAPES, make_config(reduced)
(the GNN archs' also take the cell) and make_cell(cell, ranks, reduced),
which returns a :class:`~repro_torch.configs.cells.CellPlan`.

The JAX package's registry holds ten assigned architectures and the
paper's own SSSP workload: 47 (arch, cell) pairs.  :func:`all_cells`
returns those the port can plan, in the same order: the 47 less
:data:`EXCLUDED`, each excluded pair with the ``ROADMAP.md`` Queue 1
item that brings it.
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
from repro_torch.configs.cells import (
    GNN_SHAPES,
    LM_SHAPES,
    RECSYS_SHAPES,
    TRAIN_ITEMS,
    TRAINED_FAMILIES,
)

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

#: the architectures not ported yet, with the ROADMAP.md item that
#: ports them (none since MLA and MoE serving)
UNPORTED: dict = {}

_SHAPES = {"lm": LM_SHAPES, "gnn": GNN_SHAPES, "recsys": RECSYS_SHAPES,
           "graph": sssp_cfg.SSSP_CELLS}


def _is_train(family: str, cell: str) -> bool:
    # every GNN cell of the JAX package trains (gnn_train_cell)
    return family == "gnn" or _SHAPES[family][cell].get("kind") == "train"


def _waits(arch: str, family: str, cell: str) -> bool:
    return arch in UNPORTED or (_is_train(family, cell) and family not in TRAINED_FAMILIES)


def reference_cells(include_sssp: bool = True) -> list:
    """The JAX package's ``all_cells()``: every (arch, cell) pair."""
    return [(a, c) for a, fam in REFERENCE_ARCHS
            if include_sssp or a != "sssp" for c in _SHAPES[fam]]


#: (arch, cell) -> the ROADMAP.md Queue 1 item that brings it
EXCLUDED = {
    (a, c): (UNPORTED[a] if a in UNPORTED else TRAIN_ITEMS[fam])
    for a, fam in REFERENCE_ARCHS for c in _SHAPES[fam] if _waits(a, fam, c)
}


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
    """The (arch, cell) pairs the port plans: the JAX package's less
    :data:`EXCLUDED`."""
    return [p for p in reference_cells(include_sssp) if p not in EXCLUDED]
