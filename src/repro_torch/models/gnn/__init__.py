from repro_torch.models.gnn import dimenet, egnn, gin, mace
from repro_torch.models.gnn.batch import (
    FlatGraphBatch,
    PackedGraphBatch,
    build_triplets,
    flat_batch_from_graph,
    random_molecule_batch,
)
from repro_torch.models.gnn.dimenet import DimeNetConfig
from repro_torch.models.gnn.egnn import EGNNConfig
from repro_torch.models.gnn.ell import (
    NeighborELL,
    build_bag_ell,
    build_neighbor_ell,
    build_segment_ell,
    build_segment_transpose,
    neighbor_ell,
    neighbor_sum,
    segment_ell,
    segment_transpose,
    transpose_ell,
)
from repro_torch.models.gnn.gin import GINConfig
from repro_torch.models.gnn.layers import (
    block_diagonal,
    gather_rows,
    gather_src,
    init_mlp,
    mlp_apply,
    scatter_max,
    scatter_mean,
    scatter_sum,
    segment_mean,
    segment_sum,
)
from repro_torch.models.gnn.mace import MACEConfig

__all__ = [
    "gin", "egnn", "dimenet", "mace",
    "GINConfig", "EGNNConfig", "DimeNetConfig", "MACEConfig",
    "FlatGraphBatch", "PackedGraphBatch", "build_triplets", "flat_batch_from_graph",
    "random_molecule_batch",
    "NeighborELL", "build_bag_ell", "build_neighbor_ell", "build_segment_ell",
    "build_segment_transpose",
    "neighbor_ell", "neighbor_sum", "segment_ell", "segment_transpose", "transpose_ell",
    "block_diagonal", "gather_rows", "gather_src", "init_mlp", "mlp_apply",
    "scatter_max", "scatter_mean", "scatter_sum", "segment_mean", "segment_sum",
]
