from repro_torch.models.gnn import gin
from repro_torch.models.gnn.batch import FlatGraphBatch, flat_batch_from_graph
from repro_torch.models.gnn.ell import (
    NeighborELL,
    build_neighbor_ell,
    neighbor_ell,
    neighbor_sum,
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
    "gin", "FlatGraphBatch", "flat_batch_from_graph",
    "NeighborELL", "build_neighbor_ell", "neighbor_ell", "neighbor_sum",
    "gather_src", "init_mlp", "mlp_apply", "scatter_max", "scatter_mean",
    "scatter_sum",
]
