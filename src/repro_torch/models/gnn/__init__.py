from repro_torch.models.gnn import gin
from repro_torch.models.gnn.batch import (
    FlatGraphBatch,
    PackedGraphBatch,
    flat_batch_from_graph,
    random_molecule_batch,
)
from repro_torch.models.gnn.ell import (
    NeighborELL,
    build_neighbor_ell,
    neighbor_ell,
    neighbor_sum,
    transpose_ell,
)
from repro_torch.models.gnn.layers import (
    gather_src,
    init_mlp,
    mlp_apply,
    scatter_max,
    scatter_mean,
    scatter_sum,
)

__all__ = [
    "gin", "FlatGraphBatch", "PackedGraphBatch", "flat_batch_from_graph",
    "random_molecule_batch",
    "NeighborELL", "build_neighbor_ell", "neighbor_ell", "neighbor_sum",
    "transpose_ell", "gather_src", "init_mlp", "mlp_apply", "scatter_max", "scatter_mean",
    "scatter_sum",
]
