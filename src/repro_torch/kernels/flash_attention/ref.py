"""Plain torch versions of flash attention and of its gradient:
they materialize the score matrix, all in f32 (f64 for f64 inputs, so
that ``torch.autograd.gradcheck`` can hold the gradient), and cast each
result to its input's dtype.

``lse`` is the natural-log log-sum-exp of each row's scaled, masked
scores, f32 (B, Hq, Sq): ``p = exp(s * scale - lse)``.  The forward
kernels write it on request, and the backward reads it to recompute p
without the row max and sum."""

from __future__ import annotations

import torch

NEG_INF = -1e30  # the TPU kernel's mask value


def _acc(t) -> torch.dtype:
    return torch.promote_types(t.dtype, torch.float32)


def _scores(q, k, causal: bool):
    """f32 scaled, masked scores (B, Hq, Sq, Sk), and k's heads
    repeated to q's as f32."""
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    kf = k.repeat_interleave(Hq // Hkv, dim=1).to(_acc(q))
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(_acc(q)), kf) / (D ** 0.5)
    if causal:
        mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device).tril(Sk - Sq)
        s = torch.where(mask, s, NEG_INF)
    return s, kf


def _attend(q, k, v, causal: bool):
    """The output in q's dtype, and the f32 scores it came from."""
    s, _ = _scores(q, k, causal)
    vf = v.repeat_interleave(q.shape[1] // k.shape[1], dim=1).to(_acc(q))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype), s


def attention_ref(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D) -> (B, Hq, Sq, D).  Query
    head h reads kv head h // (Hq/Hkv); a causal query row i sees keys
    up to i + Sk - Sq."""
    return _attend(q, k, v, causal)[0]


def attention_lse_ref(q, k, v, *, causal: bool = True):
    """:func:`attention_ref`'s output (the same bits) and each row's
    f32 ``lse`` (B, Hq, Sq)."""
    out, s = _attend(q, k, v, causal)
    return out, torch.logsumexp(s, dim=-1)


def _group_sum(x, Hkv: int):
    """(B, Hq, S, D) -> (B, Hkv, S, D): the sum over each kv head's
    G = Hq / Hkv q heads."""
    B, Hq, S, D = x.shape
    return x.reshape(B, Hkv, Hq // Hkv, S, D).sum(dim=2)


def attention_bwd_ref(q, k, v, out, lse, dout, *, causal: bool = True):
    """The gradient of :func:`attention_ref` from its output and ``lse``,
    in f32 from the inputs' values:

        P = exp(S * scale - lse)     dV = sum_g P^T dO
        dP = dO V^T                  delta = rowsum(dO * O)
        dS = P * (dP - delta)        dQ = dS K * scale
                                     dK = sum_g dS^T Q * scale

    where sum_g runs over the G q heads of each kv head.  Returns (dq,
    dk, dv), each in its input's dtype."""
    Hkv, D = k.shape[1], q.shape[-1]
    scale = 1.0 / D ** 0.5
    s, kf = _scores(q, k, causal)
    vf = v.repeat_interleave(q.shape[1] // Hkv, dim=1).to(_acc(q))
    p = torch.exp(s - lse[..., None])
    do = dout.to(_acc(q))
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do)
    dp = torch.einsum("bhqd,bhkd->bhqk", do, vf)
    delta = (do * out.to(_acc(q))).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.to(_acc(q))) * scale
    return (dq.to(q.dtype), _group_sum(dk, Hkv).to(k.dtype),
            _group_sum(dv, Hkv).to(v.dtype))


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
