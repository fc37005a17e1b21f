"""Plain torch version of the fused sparse-superstep relaxation."""

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
