"""Plain torch version of the pull-mode min-plus ELL relaxation."""

from __future__ import annotations

import torch


def relax_ell_ref(dist: torch.Tensor, col: torch.Tensor,
                  wgt: torch.Tensor) -> torch.Tensor:
    """out[r] = min_w dist[col[r, w]] + wgt[r, w]."""
    gathered = torch.index_select(dist, 0, col.reshape(-1)).reshape(col.shape)
    return (gathered + wgt).amin(dim=1)
