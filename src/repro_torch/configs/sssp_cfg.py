"""sssp — the paper's own workload as a first-class architecture.

Each cell plans a distributed EAGM solve for a representative (ordering
× EAGM variant × exchange) point on a Graph500-scale-26 R-MAT (67M
vertices, ~1B directed edges after symmetrization) and a
road-network-diameter proxy: the engine's arguments at the partition
shape reckoned without building the graph (``configs/cells.py::
sssp_cell``), which ``launch/dryrun.py`` turns into bytes and a peak
a card.
"""

from repro_torch.configs.cells import sssp_cell

ARCH_ID = "sssp"
FAMILY = "graph"

# cell -> engine configuration
SSSP_CELLS = {
    # paper-faithful Δ-stepping baseline with the dense pmin exchange
    "rmat26_delta_buffer_pmin": dict(
        scale=26, avg_degree=32, width=32,
        root="delta:5", variant="buffer", exchange="pmin",
    ),
    # same AGM, optimized exchange (beyond-paper)
    "rmat26_delta_buffer_a2a": dict(
        scale=26, avg_degree=32, width=32,
        root="delta:5", variant="buffer", exchange="a2a",
    ),
    # the paper's overall winner: chaotic + thread(chunk)-level dj
    "rmat26_chaotic_threadq_a2a": dict(
        scale=26, avg_degree=32, width=32,
        root="chaotic", variant="threadq", exchange="a2a",
    ),
    # KLA with pod-level ordering (nodeq)
    "rmat26_kla_nodeq_a2a": dict(
        scale=26, avg_degree=32, width=32,
        root="kla:2", variant="nodeq", exchange="a2a",
    ),
    # high-diameter road proxy (Δ large, like the paper's Δ=1200)
    "road27_delta_nodeq_a2a": dict(
        scale=27, avg_degree=4, width=4,
        root="delta:1200", variant="nodeq", exchange="a2a",
    ),
    # beyond-paper 3-level hierarchy: Δ globally, Dijkstra within the
    # pod, a finer Δ drained per chunk
    "rmat26_hier3_sparse": dict(
        scale=26, avg_degree=32, width=32,
        spec="delta:5 > pod:dijkstra > chunk:delta:1 /sparse",
    ),
    # beyond-paper partition point: edge-balanced relabeling (@ebal)
    "rmat26_delta_ebal_sparse": dict(
        scale=26, avg_degree=32, width=32,
        spec="delta:5+threadq/sparse@ebal",
    ),
}
SHAPES = list(SSSP_CELLS)


def make_config(reduced: bool = False):
    return dict(SSSP_CELLS)


def make_cell(cell: str, ranks: int = 1, reduced: bool = False):
    kw = dict(SSSP_CELLS[cell])
    if reduced:
        kw.update(scale=10, avg_degree=8, width=8)
    return sssp_cell(ARCH_ID, cell, ranks, **kw)
