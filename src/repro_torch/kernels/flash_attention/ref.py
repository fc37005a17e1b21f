"""Plain torch version of flash attention: materializes the score
matrix, all in f32, output cast to q's dtype."""

from __future__ import annotations

import torch


def attention_ref(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D) -> (B, Hq, Sq, D).  Query
    head h reads kv head h // (Hq/Hkv); a causal query row i sees keys
    up to i + Sk - Sq."""
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    group = Hq // Hkv
    kf = k.repeat_interleave(group, dim=1).float()
    vf = v.repeat_interleave(group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) / (D ** 0.5)
    if causal:
        mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device).tril(Sk - Sq)
        s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)
