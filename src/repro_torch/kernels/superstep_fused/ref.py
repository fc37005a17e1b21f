"""Plain torch versions of the fused sparse-superstep relaxation: one
lane, and S lanes at once."""

from __future__ import annotations

import torch


def fused_superstep_ref(
    dist: torch.Tensor,     # (n_local+1,) f32; slot n_local = +inf dummy
    row_idx: torch.Tensor,  # (F,) int32 virtual-row ids; entries past count ignored
    count,                  # int or int32 scalar tensor: live prefix of row_idx
    row_src: torch.Tensor,  # (R,) int32 local source per virtual row
    col: torch.Tensor,      # (R, W) int32 destination ids (padding: n_out)
    wgt: torch.Tensor,      # (R, W) f32 weights (+inf padding)
    n_out: int,
) -> torch.Tensor:
    """(n_out+1,) f32: the min-plus candidates of rows ``row_idx[:count]``
    scatter-min'd over +inf; slot ``n_out`` takes the padding.  Row ids
    are clipped to [0, R-1] as the kernel clips them."""
    F = row_idx.shape[0]
    R = wgt.shape[0]
    live = torch.arange(F, device=dist.device) < count
    r = row_idx.clamp(0, R - 1)
    src = torch.index_select(row_src, 0, r)
    cand = torch.index_select(dist, 0, src)[:, None] + torch.index_select(wgt, 0, r)
    cand = torch.where(live[:, None], cand, float("inf"))
    cols = torch.index_select(col, 0, r).reshape(-1).to(torch.int64)
    out = torch.full((n_out + 1,), float("inf"), dtype=torch.float32,
                     device=dist.device)
    return out.scatter_reduce_(0, cols, cand.reshape(-1), "amin")


def lane_rows(row_idx: torch.Tensor, n_parts: int, R: int):
    """(rank, clipped row) index pair of every (lane, frontier slot): lane
    s reads rank s % P."""
    q = torch.arange(row_idx.shape[0], device=row_idx.device) % n_parts
    return q[:, None], row_idx.clamp(0, R - 1).to(torch.int64)


def fused_superstep_batch_ref(
    dist: torch.Tensor,     # (S, n_local+1) f32, S = B·P lanes, lane-major
    row_idx: torch.Tensor,  # (S, F) int32
    count: torch.Tensor,    # (S,) int32: live prefix of each lane's row_idx
    row_src: torch.Tensor,  # (P, R) int32, shared by the lanes of a rank
    col: torch.Tensor,      # (P, R, W) int32
    wgt: torch.Tensor,      # (P, R, W) f32
    n_out: int,
) -> torch.Tensor:
    """(S, n_out+1) f32: lane s's candidates of rows
    ``row_idx[s, :count[s]]`` of rank s % P, scatter-min'd over +inf
    into its own row (slot ``n_out`` takes the padding)."""
    S, F = row_idx.shape
    q, r = lane_rows(row_idx, col.shape[0], col.shape[1])
    live = torch.arange(F, device=dist.device)[None] < count[:, None]
    src = row_src[q, r].to(torch.int64)
    cand = torch.gather(dist, 1, src)[..., None] + wgt[q, r]
    cand = torch.where(live[..., None], cand, float("inf"))
    cols = col[q, r].reshape(S, -1).to(torch.int64)
    out = torch.full((S, n_out + 1), float("inf"), dtype=torch.float32,
                     device=dist.device)
    return out.scatter_reduce_(1, cols, cand.reshape(S, -1), "amin")
