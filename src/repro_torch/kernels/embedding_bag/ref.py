"""Plain torch version of the embedding bag: gather + weighted sum."""

from __future__ import annotations

import torch


def embedding_bag_ref(table, idx, w) -> torch.Tensor:
    """out[b] = sum_l w[b, l] * table[idx[b, l]] -> (B, d)."""
    rows = table[idx.long()]  # (B, L, d)
    return torch.sum(rows * w[..., None], dim=1)
