"""Plain torch version of the push-mode frontier gather."""

from __future__ import annotations

import torch


def relax_push_gather_ref(
    dist: torch.Tensor,     # (n_local+1,) f32; slot n_local = +inf dummy
    row_idx: torch.Tensor,  # (F,) int32 virtual-row ids; entries past count ignored
    count,                  # int or int32 scalar tensor: live prefix of row_idx
    row_src: torch.Tensor,  # (R,) int32
    wgt: torch.Tensor,      # (R, W) f32
) -> torch.Tensor:
    """(F, W) f32 candidates ``dist[row_src[r]] + wgt[r]`` of the listed
    rows (ids clipped to [0, R-1]); +inf for f >= count."""
    F = row_idx.shape[0]
    R = wgt.shape[0]
    live = torch.arange(F, device=dist.device) < count
    r = row_idx.clamp(0, R - 1)
    src = torch.index_select(row_src, 0, r)
    cand = torch.index_select(dist, 0, src)[:, None] + torch.index_select(wgt, 0, r)
    return torch.where(live[:, None], cand, float("inf"))
