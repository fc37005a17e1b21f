"""Plain torch versions of the push-mode frontier gather: one lane, and
S lanes at once."""

from __future__ import annotations

import torch

from repro_torch.kernels.superstep_fused.ref import lane_rows


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


def relax_push_gather_batch_ref(
    dist: torch.Tensor,     # (S, n_local+1) f32, S = B·P lanes, lane-major
    row_idx: torch.Tensor,  # (S, F) int32
    count: torch.Tensor,    # (S,) int32
    row_src: torch.Tensor,  # (P, R) int32
    wgt: torch.Tensor,      # (P, R, W) f32
) -> torch.Tensor:
    """(S, F, W) f32: lane s's candidates of its listed rows of rank
    s % P; +inf for f >= count[s]."""
    F = row_idx.shape[1]
    q, r = lane_rows(row_idx, wgt.shape[0], wgt.shape[1])
    live = torch.arange(F, device=dist.device)[None] < count[:, None]
    src = row_src[q, r].to(torch.int64)
    cand = torch.gather(dist, 1, src)[..., None] + wgt[q, r]
    return torch.where(live[..., None], cand, float("inf"))
