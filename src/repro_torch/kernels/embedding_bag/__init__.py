from repro_torch.kernels.embedding_bag.kernel import embedding_bag_cuda
from repro_torch.kernels.embedding_bag.ops import BagSum, bag_pool, bag_sum
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

__all__ = ["BagSum", "bag_pool", "bag_sum", "embedding_bag_cuda", "embedding_bag_ref"]
