from repro_torch.kernels.spmm_ell.kernel import spmm_ell_cuda
from repro_torch.kernels.spmm_ell.ops import aggregate_neighbors, spmm_rows
from repro_torch.kernels.spmm_ell.ref import spmm_ell_ref

__all__ = ["aggregate_neighbors", "spmm_rows", "spmm_ell_cuda", "spmm_ell_ref"]
