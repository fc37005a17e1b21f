from repro_torch.kernels.spmm_ell.kernel import spmm_ell_cuda, spmm_ell_vertex_cuda
from repro_torch.kernels.spmm_ell.ops import VertexSum, aggregate_neighbors, spmm_rows, vertex_sum
from repro_torch.kernels.spmm_ell.ref import spmm_ell_ref, spmm_ell_vertex_ref

__all__ = ["VertexSum", "aggregate_neighbors", "spmm_rows", "vertex_sum", "spmm_ell_cuda",
           "spmm_ell_vertex_cuda", "spmm_ell_ref", "spmm_ell_vertex_ref"]
