from repro_torch.kernels.relax_ell.kernel import relax_ell_cuda
from repro_torch.kernels.relax_ell.ops import relax_rows
from repro_torch.kernels.relax_ell.ref import relax_ell_ref

__all__ = ["relax_ell_cuda", "relax_ell_ref", "relax_rows"]
