"""Public op: pull-mode min-plus ELL relaxation.  A CUDA tensor launches
the kernel; a CPU tensor takes the plain torch version.  No row padding
is needed: the kernel masks the ragged edge itself."""

from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.relax_ell.kernel import relax_ell_cuda
from repro_torch.kernels.relax_ell.ref import relax_ell_ref


def relax_rows(dist, col, wgt) -> torch.Tensor:
    """(R,) f32 row minima ``min_w dist[col[r, w]] + wgt[r, w]``."""
    if dist.device.type == "cpu":
        _lib.count_call("relax_ell", "ref")
        return relax_ell_ref(dist, col, wgt)
    _lib.count_call("relax_ell", "cuda")
    return relax_ell_cuda(dist, col, wgt)
