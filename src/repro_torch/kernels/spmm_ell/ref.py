"""Plain torch version of the ELL SpMM: gather, weight, reduce over the
slots.  It materialises the (R, W, d) gather."""

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
