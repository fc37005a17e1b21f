"""Decoder-only transformer LM, dense GQA (phi3-mini, minitron):
prefill and greedy decode for serving.

The port of the JAX package's ``models/lm.py`` for one card.  A model
is an :class:`LM` module: the embedding, an ``nn.ModuleList`` of
:class:`Block` (one per layer, each weight in the JAX package's
``(in, out)`` layout so ``x @ w`` reads the same) and the final norm
and head.  The public functions keep the JAX package's names and its
``(B, S, H, dh)`` activation layout; they take the module where the
JAX package takes its parameter tree, and drop the sharding topology.

  prefill_step  build the KV cache from a prompt, last-position logits
  decode_step   one token against the cache (updated in place)
  forward       teacher-forced final hidden states

MLA (minicpm3), MoE (phi3.5-moe, dbrx) and ``lm_loss`` (training) are
not ported yet: see ROADMAP.md, Queue 1.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from repro_torch.kernels.flash_attention import mha as mha_kernel
from repro_torch.models.common import (
    apply_rope,
    fan_in_init,
    normal_init,
    relu2,
    rms_norm,
    rope_angles,
    swiglu,
)

#: ``attn_impl`` values: plain full-score attention, plain blockwise
#: attention, and the kernel op (the JAX package's Pallas names; both
#: take the port's kernel, which a CPU tensor runs as its plain version)
ATTN_IMPLS = ("xla", "xla_flash", "pallas", "pallas_interpret")
NEG_INF = -1e30
# the JAX package's defaults, which none of the ported configs changes
ROPE_THETA = 10000.0
NORM_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    mlp_type: str = "swiglu"          # 'swiglu' | 'relu2'
    attn_type: str = "gqa"            # only 'gqa' is ported
    moe: Optional[object] = None      # not ported: must stay None
    param_dtype: str = "bfloat16"
    attn_impl: str = "xla"            # one of ATTN_IMPLS
    attn_chunk: int = 1024            # kv chunk for xla_flash

    def __post_init__(self):
        if self.attn_type != "gqa":
            raise NotImplementedError(
                f"attn_type={self.attn_type!r} is not ported yet (ROADMAP.md "
                "Queue 1: MLA and MoE serving)")
        if self.moe is not None:
            raise NotImplementedError(
                "MoE layers are not ported yet (ROADMAP.md Queue 1: MLA and "
                "MoE serving)")
        if self.mlp_type not in ("swiglu", "relu2"):
            raise ValueError(f"mlp_type must be 'swiglu' or 'relu2', got {self.mlp_type!r}")
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {self.attn_impl!r}")

    def n_params(self) -> int:
        """Weights less the norm scales, embedding and head untied (the
        JAX package's count)."""
        d, f, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab
        dh = self.head_dim
        attn = d * self.n_heads * dh + 2 * d * self.n_kv_heads * dh \
            + self.n_heads * dh * d
        mlp = (3 if self.mlp_type == "swiglu" else 2) * d * f
        return L * (attn + mlp) + 2 * V * d

    def n_active_params(self) -> int:
        """Per-token active parameters: all of them (no MoE is ported)."""
        return self.n_params()

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)


# ----------------------------------------------------------------- #
# parameters


def layer_shapes(cfg: LMConfig) -> dict:
    """Per-layer weight name -> (shape, fan-in); fan-in None marks a
    norm scale (initialised to ones)."""
    d, f = cfg.d_model, cfg.d_ff
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    shapes = {
        "ln1": ((d,), None), "ln2": ((d,), None),
        "wq": ((d, H * dh), d), "wk": ((d, KV * dh), d),
        "wv": ((d, KV * dh), d), "wo": ((H * dh, d), H * dh),
        "wg": ((d, f), d), "wd": ((f, d), f),
    }
    if cfg.mlp_type == "swiglu":
        shapes["wu"] = ((d, f), d)
    return shapes


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Block(nn.Module):
    """One decoder layer's weights (the JAX package's per-layer slice of
    ``params["layers"]``, under the same names)."""

    def __init__(self, tensors: dict):
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(name, _param(t))


class LM(nn.Module):
    """Embedding, decoder layers, final norm and (untied) head."""

    def __init__(self, cfg: LMConfig, embed, layers: list, final_norm,
                 lm_head):
        super().__init__()
        if len(layers) != cfg.n_layers:
            raise ValueError(f"{cfg.name}: {len(layers)} layers, config says {cfg.n_layers}")
        want = layer_shapes(cfg)
        for li, tensors in enumerate(layers):
            got = {k: tuple(t.shape) for k, t in tensors.items()}
            if got != {k: s for k, (s, _) in want.items()}:
                raise ValueError(f"{cfg.name}: layer {li} weights {got} do not match {want}")
        self.cfg = cfg
        self.embed = _param(embed)
        self.layers = nn.ModuleList(Block(t) for t in layers)
        self.final_norm = _param(final_norm)
        self.lm_head = _param(lm_head)


def init_params(gen: torch.Generator, cfg: LMConfig) -> LM:
    """Random weights drawn on ``gen``'s device (a full-size model is
    made on the card, one tensor at a time, never on the host)."""
    dt = cfg.dtype
    dev = gen.device

    def layer():
        return {
            name: (torch.ones(shape, dtype=dt, device=dev) if fan is None
                   else fan_in_init(gen, shape, fan, dt))
            for name, (shape, fan) in layer_shapes(cfg).items()
        }

    d, V = cfg.d_model, cfg.vocab
    embed = normal_init(gen, (V, d), 0.02, dt)
    layers = [layer() for _ in range(cfg.n_layers)]
    head = fan_in_init(gen, (d, V), d, dt)
    return LM(cfg, embed, layers, torch.ones((d,), dtype=dt, device=dev), head)


# ----------------------------------------------------------------- #
# attention


def _grouped_scores(q, k):
    """q (B,S,H,dh), k (B,T,KV,dh) -> f32 scores (B,KV,G,S,T) without
    materializing head-expanded KV."""
    B, S, H, dh = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, dh)
    return torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())


def _grouped_out(p, v):
    """p (B,KV,G,S,T), v (B,T,KV,dh) -> f32 (B,S,H,dh)."""
    B, KV, G, S, T = p.shape
    out = torch.einsum("bkgst,btkd->bskgd", p.float(), v.float())
    return out.reshape(B, S, KV * G, -1)


def attention_xla(q, k, v, *, causal: bool, scale: float):
    """Full-score attention (small S / correctness path); p is rounded
    to q's dtype before p @ v, as in the JAX package."""
    s = _grouped_scores(q, k) * scale
    S, T = s.shape[-2], s.shape[-1]
    if causal:
        mask = torch.ones((S, T), dtype=torch.bool, device=q.device).tril(T - S)
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return _grouped_out(p.to(q.dtype), v).to(q.dtype)


def attention_xla_flash(q, k, v, *, causal: bool, scale: float,
                        chunk: int):
    """Blockwise-softmax attention in plain torch over KV chunks; memory
    O(S·chunk).  The key length must be a multiple of ``chunk``: the JAX
    package's version visits only ``T // chunk`` chunks and so drops the
    keys past the last whole chunk; this one raises instead."""
    B, S, H, dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    G = H // KV
    if T % chunk:
        raise ValueError(
            f"attention_xla_flash: key length {T} is not a multiple of the "
            f"chunk {chunk}; the keys past the last whole chunk would be dropped")
    qg = q.reshape(B, S, KV, G, dh).float()
    m = torch.full((B, KV, G, S), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, KV, G, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, G, S, dv), dtype=torch.float32, device=q.device)
    rows = torch.arange(S, device=q.device)[:, None] + (T - S)
    for ci in range(T // chunk):
        if causal and ci * chunk > (T - S) + S - 1:
            continue  # chunk entirely above the causal diagonal
        ks = k[:, ci * chunk:(ci + 1) * chunk].float()
        vs = v[:, ci * chunk:(ci + 1) * chunk].float()
        sc = torch.einsum("bskgd,btkd->bkgst", qg, ks) * scale
        if causal:
            cols = ci * chunk + torch.arange(chunk, device=q.device)[None, :]
            sc = torch.where(rows >= cols, sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        pexp = torch.exp(sc - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + pexp.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgst,btkd->bkgsd", pexp, vs)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, dv).to(q.dtype)


def run_attention(q, k, v, cfg: LMConfig, *, causal=True):
    """q (B,S,H,dh), k/v (B,T,KV,dh) -> (B,S,H*dh)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    if cfg.attn_impl.startswith("pallas"):
        out = mha_kernel(
            q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous(), causal=causal,
        ).transpose(1, 2)
    elif cfg.attn_impl == "xla_flash" and k.shape[1] >= cfg.attn_chunk:
        out = attention_xla_flash(q, k, v, causal=causal, scale=scale,
                                  chunk=cfg.attn_chunk)
    else:
        out = attention_xla(q, k, v, causal=causal, scale=scale)
    B, S = q.shape[0], q.shape[1]
    return out.reshape(B, S, -1)


def decode_attention(q, k_cache, v_cache, pos: int, scale: float):
    """One-position attention against the cache: q (B,1,H,dh), k/v
    (B,T,KV,dh); positions past ``pos`` are masked."""
    s = _grouped_scores(q, k_cache) * scale  # (B,KV,G,1,T)
    T = k_cache.shape[1]
    valid = torch.arange(T, device=q.device) <= pos
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = _grouped_out((p / l).to(q.dtype), v_cache).to(q.dtype)
    return out.reshape(q.shape[0], 1, -1)


# ----------------------------------------------------------------- #
# blocks


def _mlp(lp: Block, x, cfg: LMConfig):
    if cfg.mlp_type == "swiglu":
        h = swiglu(x @ lp.wg, x @ lp.wu)
    else:
        h = relu2(x @ lp.wg)
    return h @ lp.wd


def _gqa_qkv(lp: Block, x, cfg: LMConfig, positions):
    B, S, d = x.shape
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ lp.wq).reshape(B, S, H, dh)
    k = (x @ lp.wk).reshape(B, S, KV, dh)
    v = (x @ lp.wv).reshape(B, S, KV, dh)
    cos, sin = rope_angles(positions, dh, ROPE_THETA)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _layer(lp: Block, x, cfg: LMConfig, positions):
    """One prefill/teacher-forced layer; returns (x, k, v)."""
    h = rms_norm(x, lp.ln1, NORM_EPS)
    q, k, v = _gqa_qkv(lp, h, cfg, positions)
    x = x + run_attention(q, k, v, cfg, causal=True) @ lp.wo
    h = rms_norm(x, lp.ln2, NORM_EPS)
    return x + _mlp(lp, h, cfg), k, v


def lm_head_weight(params: LM, cfg: LMConfig):
    """The (d, V) head (the ported configs do not tie it to the
    embedding)."""
    return params.lm_head


def _embed(params: LM, tokens):
    return params.embed[tokens.long()]


@torch.inference_mode()
def forward(params: LM, tokens, cfg: LMConfig):
    """Token ids (B, S) -> final hidden states (B, S, d)."""
    B, S = tokens.shape
    x = _embed(params, tokens)
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    for lp in params.layers:
        x, _, _ = _layer(lp, x, cfg, positions)
    return rms_norm(x, params.final_norm, NORM_EPS)


# ----------------------------------------------------------------- #
# serving: prefill + single-token decode with a static-size cache


def cache_shapes(cfg: LMConfig, batch: int, max_len: int) -> dict:
    """The cache's tensors as meta tensors (shape and dtype, no data)."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {name: torch.empty(shape, dtype=cfg.dtype, device="meta")
            for name in ("k", "v")}


@torch.inference_mode()
def prefill_step(params: LM, tokens, cfg: LMConfig, max_len: int):
    """Prompt (B, S) -> (cache dict, last-position logits (B, V) f32).
    The cache holds ``max_len`` positions, zero past the prompt."""
    B, S = tokens.shape
    if S > max_len:
        raise ValueError(f"prompt length {S} exceeds max_len {max_len}")
    x = _embed(params, tokens)
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    cache = {name: torch.zeros(m.shape, dtype=m.dtype, device=x.device)
             for name, m in cache_shapes(cfg, B, max_len).items()}
    for li, lp in enumerate(params.layers):
        x, k, v = _layer(lp, x, cfg, positions)
        cache["k"][li, :, :S] = k
        cache["v"][li, :, :S] = v
    x = rms_norm(x, params.final_norm, NORM_EPS)
    logits = (x[:, -1] @ lm_head_weight(params, cfg)).float()
    return cache, logits


@torch.inference_mode()
def decode_step(params: LM, cache: dict, tokens, pos: int, cfg: LMConfig):
    """One decode step: tokens (B,) at position ``pos`` against the
    cache.  Returns (logits (B, V) f32, cache).  The cache is updated
    in place (the JAX package returns a new one); the returned dict is
    the one given."""
    B = tokens.shape[0]
    T = cache["k"].shape[2]
    if not 0 <= pos < T:
        raise ValueError(f"position {pos} outside the cache's {T} slots")
    x = _embed(params, tokens)[:, None, :]  # (B,1,d)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    for li, lp in enumerate(params.layers):
        h = rms_norm(x, lp.ln1, NORM_EPS)
        q, k, v = _gqa_qkv(lp, h, cfg, positions)
        cache["k"][li, :, pos] = k[:, 0]
        cache["v"][li, :, pos] = v[:, 0]
        attn = decode_attention(q, cache["k"][li], cache["v"][li], pos, scale)
        x = x + attn @ lp.wo
        h = rms_norm(x, lp.ln2, NORM_EPS)
        x = x + _mlp(lp, h, cfg)
    x = rms_norm(x, params.final_norm, NORM_EPS)
    logits = (x[:, 0] @ lm_head_weight(params, cfg)).float()
    return logits, cache
