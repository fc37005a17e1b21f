"""Graph substrate of the port: host-side numpy formats, generators and
the partitioner, byte-identical to the JAX package's ``repro.graph``."""

from repro_torch.graph.formats import (
    CSR,
    Graph,
    chain_fingerprint,
    clear_fingerprint_chain,
    coo_to_csr,
    graph_fingerprint,
)
from repro_torch.graph.generators import (
    erdos_renyi_graph,
    grid_road_graph,
    rmat1,
    rmat2,
    rmat_graph,
    small_world_graph,
)
from repro_torch.graph.partition import (
    PARTITIONER_KINDS,
    DeviceELL,
    PartitionedGraph,
    canonical_partitioner,
    from_arrays,
    partition_graph,
)
from repro_torch.graph.sampler import FanoutSampler, SampledBlock

__all__ = [
    "CSR", "Graph", "chain_fingerprint", "clear_fingerprint_chain", "coo_to_csr",
    "graph_fingerprint",
    "erdos_renyi_graph", "grid_road_graph", "rmat1", "rmat2", "rmat_graph",
    "small_world_graph",
    "PARTITIONER_KINDS", "DeviceELL", "PartitionedGraph",
    "canonical_partitioner", "from_arrays", "partition_graph",
    "FanoutSampler", "SampledBlock",
]
