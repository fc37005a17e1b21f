"""Plain torch versions of the ELL SpMM.

``spmm_ell_ref`` is the row entry: gather, weight, reduce over the
slots; it materialises the (R, W, d) gather.  ``spmm_ell_vertex_ref`` is
the vertex sum in the kernel's order: the live slots of every row in
slot order, then each vertex's rows in row order."""

from __future__ import annotations

import torch

OPS = ("sum", "max")


def spmm_ell_ref(x, col, wgt, op: str = "sum") -> torch.Tensor:
    """out[r] = sum_s x[col[r, s]] * wgt[r, s]  (``op="sum"``), or the
    max of x[col[r, s]] over the slots with wgt[r, s] > 0, -inf where
    there is none (``op="max"``) -> (R, d)."""
    g = x[col.long()]  # (R, W, d)
    if op == "sum":
        return torch.sum(g * wgt[..., None], dim=1)
    if op == "max":
        masked = torch.where((wgt > 0)[..., None], g, float("-inf"))
        return torch.amax(masked, dim=1)
    raise ValueError(f"spmm_ell op must be one of {OPS}, got {op!r}")


def live_slots(row_ptr, deg, W: int) -> torch.Tensor:
    """(R,) int64 live slots of each ELL row: vertex v owns rows
    row_ptr[v] .. row_ptr[v+1]-1 and the first deg[v] of their flat
    slots, so its k-th row holds clamp(deg[v] - k W, 0, W)."""
    nrows = row_ptr[1:] - row_ptr[:-1]
    R = int(row_ptr[-1])
    vertex = torch.repeat_interleave(torch.arange(nrows.shape[0], device=row_ptr.device),
                                     nrows, output_size=R)
    rank = torch.arange(R, device=row_ptr.device) - row_ptr[vertex]
    return (deg.long()[vertex] - rank * W).clamp(0, W)


def spmm_ell_vertex_ref(x, col, wgt, row_ptr, deg) -> torch.Tensor:
    """(n, d) vertex sums ``out[v] = (((+0 + rowsum(r0)) + rowsum(r1))
    + ...)`` over v's rows row_ptr[v] .. row_ptr[v+1]-1, where
    ``rowsum(r)`` sums ``x[col[r, s]] * wgt[r, s]`` over r's live slots
    s (live_slots) in slot order; every product and sum rounded, as
    the kernel takes them.  Padding slots are never read."""
    n, d = deg.shape[0], x.shape[1]
    R, W = col.shape
    live = live_slots(row_ptr, deg, W)
    rows = x.new_zeros((R, d))
    for s in range(W):  # slot order within every row
        r = torch.nonzero(live > s).flatten()
        rows[r] = rows[r] + x[col[r, s].long()] * wgt[r, s, None]
    nrows = row_ptr[1:] - row_ptr[:-1]
    out = x.new_zeros((n, d))
    if n == 0:
        return out
    # row order within every vertex: its k-th rows, k = 0, 1, ...
    by_rows = torch.argsort(nrows, descending=True, stable=True)
    more_than = (n - torch.cumsum(torch.bincount(nrows), 0)).tolist()  # vertices of > k rows
    for k, count in enumerate(more_than[:-1]):
        v = by_rows[:count]
        out[v] = out[v] + rows[row_ptr[v] + k]
    return out
