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


def attention_partials_ref(q, k, v, *, causal: bool, n_split: int):
    """The f32 kernel's split in plain torch: for each chunk c of
    ``n_split`` (``kernel.chunk_bounds`` of the key tiles each 128-row q
    tile visits, ``kernel.key_tiles``), each row's partial over the
    chunk's keys: m (the max of its scaled, masked scores), l (the sum
    of exp(s - m)) and acc (exp(s - m) v, unnormalized).  Returns m, l
    (n_split, B, Hq, Sq) and acc (n_split, B, Hq, Sq, D), in f32."""
    from repro_torch.kernels.flash_attention.kernel import (
        BLOCK_K,
        BLOCK_Q,
        chunk_bounds,
        key_tiles,
    )

    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    group = Hq // Hkv
    kf = k.repeat_interleave(group, dim=1).float()
    vf = v.repeat_interleave(group, dim=1).float()
    m = torch.empty((n_split, B, Hq, Sq), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    acc = torch.empty((n_split, B, Hq, Sq, D), dtype=torch.float32, device=q.device)
    for qt in range(Sq // BLOCK_Q):
        rows = slice(qt * BLOCK_Q, (qt + 1) * BLOCK_Q)
        n_tiles = key_tiles(qt, Sq, Sk, causal)
        for c in range(n_split):
            lo, hi = chunk_bounds(n_tiles, n_split, c)
            keys = slice(lo * BLOCK_K, hi * BLOCK_K)
            s = torch.einsum("bhqd,bhkd->bhqk", q[:, :, rows].float(),
                             kf[:, :, keys]) * (1.0 / D ** 0.5)
            if causal:
                last = torch.arange(rows.start, rows.stop, device=q.device)[:, None] + (Sk - Sq)
                key = torch.arange(keys.start, keys.stop, device=q.device)[None, :]
                s = torch.where(key <= last, s, -1e30)
            mc = s.amax(-1, keepdim=True) if hi > lo else torch.full(
                s.shape[:-1] + (1,), -1e30, device=q.device)
            p = torch.exp(s - mc)
            m[c, :, :, rows] = mc[..., 0]
            l[c, :, :, rows] = p.sum(-1)
            acc[c, :, :, rows] = torch.einsum("bhqk,bhkd->bhqd", p, vf[:, :, keys])
    return m, l, acc


def merge_partials_ref(m, l, acc):
    """Fold the chunks' partials in chunk order, as the kernel's merge
    does: m* = max m_i, l = sum l_i e^(m_i - m*), o = sum acc_i
    e^(m_i - m*) / max(l, 1e-30).  Returns (B, Hq, Sq, D) f32."""
    m_star = m.amax(0)
    lsum = torch.zeros_like(m_star)
    out = torch.zeros_like(acc[0])
    for i in range(m.shape[0]):
        w = torch.exp(m[i] - m_star)
        lsum = lsum + l[i] * w
        out = out + acc[i] * w[..., None]
    return out / lsum.clamp_min(1e-30)[..., None]
