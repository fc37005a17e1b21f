"""Decoder-only transformer LM: dense GQA (phi3-mini, minitron), MLA
(minicpm3) and GQA with MoE FFNs (phi3.5-moe, dbrx); prefill and greedy
decode for serving, and the training loss.

The port of the JAX package's ``models/lm.py`` for one card.  A model
is an :class:`LM` module: the embedding, an ``nn.ModuleList`` of
:class:`Block` (one per layer, each weight in the JAX package's
``(in, out)`` layout so ``x @ w`` reads the same) and the final norm
and head (none when the embedding is tied).  The public functions keep
the JAX package's names and its ``(B, S, H, dh)`` activation layout;
they take the module where the JAX package takes its parameter tree,
and drop the sharding topology.

  prefill_step  build the KV cache from a prompt, last-position logits
  decode_step   one token against the cache (updated in place)
  forward       teacher-forced final hidden states, for serving (no
                gradient)
  lm_loss       the training loss: chunked-vocab next-token CE plus the
                MoE aux loss, over :func:`forward_train` (the JAX
                package's ``forward``), which autograd runs through

Training takes the parameters as a tree of tensors in the JAX package's
layout (:func:`params_tree`): ``embed``, ``layers`` (each weight
stacked over a leading layer axis), ``final_norm`` and ``lm_head``
unless tied, so that the generic train step, the checkpoints and
``models/convert.py`` read it as the JAX package's tree.

MLA keeps a latent cache, ``c`` (kv_lora) and ``kr`` (qk_rope) a token;
its prefill materialises K and V, its decode attends in latent space
(absorbed).  MoE layers run :func:`repro_torch.models.moe.moe_ffn`.
"""

from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

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
from repro_torch.models.moe import MoEConfig, moe_ffn

#: ``attn_impl`` values: plain full-score attention, plain blockwise
#: attention, and the kernel op (the JAX package's Pallas names; both
#: take the port's kernel, which a CPU tensor runs as its plain version)
ATTN_IMPLS = ("xla", "xla_flash", "pallas", "pallas_interpret")
ATTN_TYPES = ("gqa", "mla")
REMATS = ("none", "full")
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
    attn_type: str = "gqa"            # 'gqa' | 'mla'
    moe: Optional[MoEConfig] = None
    # --- MLA (minicpm3) ---
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_dim: int = 64
    qk_rope_dim: int = 32
    v_head_dim: int = 64
    tie_embeddings: bool = False
    param_dtype: str = "bfloat16"
    remat: str = "full"               # 'none' | 'full': recompute each layer in backward
    attn_impl: str = "xla"            # one of ATTN_IMPLS
    attn_chunk: int = 1024            # kv chunk for xla_flash
    loss_chunk: int = 512             # seq chunk for the vocab CE

    def __post_init__(self):
        if self.attn_type not in ATTN_TYPES:
            raise ValueError(f"attn_type must be one of {ATTN_TYPES}, got {self.attn_type!r}")
        if self.moe is not None and self.moe.d_model != self.d_model:
            raise ValueError(f"moe.d_model {self.moe.d_model} differs from the model's "
                             f"d_model {self.d_model}")
        if self.mlp_type not in ("swiglu", "relu2"):
            raise ValueError(f"mlp_type must be 'swiglu' or 'relu2', got {self.mlp_type!r}")
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {self.attn_impl!r}")
        if self.remat not in REMATS:
            raise ValueError(f"remat must be one of {REMATS}, got {self.remat!r}")

    def n_params(self) -> int:
        """Weights less the norm scales, the embedding counted once when
        tied (the JAX package's count)."""
        d, f, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab
        if self.attn_type == "mla":
            qk = self.qk_nope_dim + self.qk_rope_dim
            attn = (
                d * self.q_lora_rank
                + self.q_lora_rank * self.n_heads * qk
                + d * (self.kv_lora_rank + self.qk_rope_dim)
                + self.kv_lora_rank * self.n_heads
                * (self.qk_nope_dim + self.v_head_dim)
                + self.n_heads * self.v_head_dim * d
            )
        else:
            dh = self.head_dim
            attn = d * self.n_heads * dh + 2 * d * self.n_kv_heads * dh \
                + self.n_heads * dh * d
        if self.moe:
            mlp = self.moe.n_experts * 3 * d * self.moe.d_ff + \
                d * self.moe.n_experts
        else:
            mlp = (3 if self.mlp_type == "swiglu" else 2) * d * f
        emb = V * d * (1 if self.tie_embeddings else 2)
        return L * (attn + mlp) + emb

    def n_active_params(self) -> int:
        """Per-token active parameters (MoE counts top_k experts)."""
        if not self.moe:
            return self.n_params()
        d = self.d_model
        dense = self.n_params() - self.n_layers * (
            self.moe.n_experts * 3 * d * self.moe.d_ff
        )
        return dense + self.n_layers * self.moe.top_k * 3 * d * self.moe.d_ff

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
    shapes = {"ln1": ((d,), None), "ln2": ((d,), None)}
    if cfg.attn_type == "gqa":
        shapes.update(
            wq=((d, H * dh), d), wk=((d, KV * dh), d),
            wv=((d, KV * dh), d), wo=((H * dh, d), H * dh),
        )
    else:
        ql, kvr, rope = cfg.q_lora_rank, cfg.kv_lora_rank, cfg.qk_rope_dim
        qk, vd = cfg.qk_nope_dim + rope, cfg.v_head_dim
        shapes.update(
            wq_a=((d, ql), d), q_norm=((ql,), None), wq_b=((ql, H * qk), ql),
            wkv_a=((d, kvr + rope), d), kv_norm=((kvr,), None),
            wk_b=((kvr, H * cfg.qk_nope_dim), kvr), wv_b=((kvr, H * vd), kvr),
            wo=((H * vd, d), H * vd),
        )
    if cfg.moe:
        E, fe = cfg.moe.n_experts, cfg.moe.d_ff
        shapes.update(
            router=((d, E), d), wg_e=((E, d, fe), d), wu_e=((E, d, fe), d),
            wd_e=((E, fe, d), fe),
        )
    else:
        shapes.update(wg=((d, f), d), wd=((f, d), f))
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
    """Embedding, decoder layers, final norm and head; ``lm_head`` is
    None where the config ties the head to the embedding."""

    def __init__(self, cfg: LMConfig, embed, layers: list, final_norm,
                 lm_head=None):
        super().__init__()
        if len(layers) != cfg.n_layers:
            raise ValueError(f"{cfg.name}: {len(layers)} layers, config says {cfg.n_layers}")
        if (lm_head is None) != cfg.tie_embeddings:
            raise ValueError(f"{cfg.name}: tie_embeddings={cfg.tie_embeddings} but "
                             f"lm_head is {'absent' if lm_head is None else 'given'}")
        want = layer_shapes(cfg)
        for li, tensors in enumerate(layers):
            got = {k: tuple(t.shape) for k, t in tensors.items()}
            if got != {k: s for k, (s, _) in want.items()}:
                raise ValueError(f"{cfg.name}: layer {li} weights {got} do not match {want}")
        self.cfg = cfg
        self.embed = _param(embed)
        self.layers = nn.ModuleList(Block(t) for t in layers)
        self.final_norm = _param(final_norm)
        self.lm_head = None if lm_head is None else _param(lm_head)


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
    head = None if cfg.tie_embeddings else fan_in_init(gen, (d, V), d, dt)
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
    if cfg.attn_impl.startswith("pallas") and q.shape[-1] != v.shape[-1]:
        # the kernel takes one head dim; MLA (qk 96 / v 64) takes the
        # blockwise path instead, as in the JAX package
        return run_attention(q, k, v, dataclasses.replace(cfg, attn_impl="xla_flash"),
                             causal=causal)
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


def _ffn(lp: Block, x, cfg: LMConfig):
    """The layer's FFN and its f32 aux loss: MoE's load-balance term
    where the config has it, else the dense MLP and 0."""
    if cfg.moe:
        return moe_ffn(x, lp.router, lp.wg_e, lp.wu_e, lp.wd_e, cfg.moe)
    return _mlp(lp, x, cfg), torch.zeros((), dtype=torch.float32, device=x.device)


def _gqa_qkv(lp: Block, x, cfg: LMConfig, positions):
    B, S, d = x.shape
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ lp.wq).reshape(B, S, H, dh)
    k = (x @ lp.wk).reshape(B, S, KV, dh)
    v = (x @ lp.wv).reshape(B, S, KV, dh)
    cos, sin = rope_angles(positions, dh, ROPE_THETA)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _mla_q(lp: Block, x, cfg: LMConfig, positions):
    B, S, d = x.shape
    nope, rope = cfg.qk_nope_dim, cfg.qk_rope_dim
    qa = rms_norm(x @ lp.wq_a, lp.q_norm, NORM_EPS)
    q = (qa @ lp.wq_b).reshape(B, S, cfg.n_heads, nope + rope)
    cos, sin = rope_angles(positions, rope, ROPE_THETA)
    return q[..., :nope], apply_rope(q[..., nope:], cos, sin)


def _mla_latent(lp: Block, x, cfg: LMConfig, positions):
    """Compressed KV: (c (B,S,kvr) post-norm, k_rope (B,S,rope))."""
    kvr, rope = cfg.kv_lora_rank, cfg.qk_rope_dim
    kv = x @ lp.wkv_a
    c = rms_norm(kv[..., :kvr], lp.kv_norm, NORM_EPS)
    cos, sin = rope_angles(positions, rope, ROPE_THETA)
    k_rope = apply_rope(kv[..., kvr:][:, :, None, :], cos, sin)[:, :, 0, :]
    return c, k_rope


def _mla_attention_train(lp: Block, x, cfg: LMConfig, positions):
    """Materialised MLA attention (the prefill path): returns the
    attention output and the latent cache entries (c, k_rope)."""
    B, S, d = x.shape
    H, nope, rope = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    q_nope, q_rope = _mla_q(lp, x, cfg, positions)
    c, k_rope = _mla_latent(lp, x, cfg, positions)
    k_nope = (c @ lp.wk_b).reshape(B, S, H, nope)
    v = (c @ lp.wv_b).reshape(B, S, H, cfg.v_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, rope)], dim=-1)
    out = run_attention(q, k, v, cfg, causal=True)
    return out @ lp.wo, (c, k_rope)


def _mla_attention_decode(lp: Block, x, cfg: LMConfig, c_cache, kr_cache, pos: int):
    """Absorbed MLA decode: scores and context in latent space, in f32;
    the cache stays (kv_lora + rope) a token, never expanded to H heads."""
    B = x.shape[0]
    H, nope, vd = cfg.n_heads, cfg.qk_nope_dim, cfg.v_head_dim
    kvr = cfg.kv_lora_rank
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _mla_q(lp, x, cfg, positions)  # (B,1,H,·)
    q_abs = torch.einsum("bqhn,rhn->bqhr", q_nope, lp.wk_b.reshape(kvr, H, nope))
    s = (torch.einsum("bqhr,bkr->bhqk", q_abs.float(), c_cache.float())
         + torch.einsum("bqhp,bkp->bhqk", q_rope.float(), kr_cache.float())
         ) / math.sqrt(nope + cfg.qk_rope_dim)
    valid = torch.arange(c_cache.shape[1], device=x.device) <= pos
    p = torch.softmax(torch.where(valid, s, NEG_INF), dim=-1)
    ctx = torch.einsum("bhqk,bkr->bqhr", p, c_cache.float())
    out = torch.einsum("bqhr,rhv->bqhv", ctx.to(x.dtype), lp.wv_b.reshape(kvr, H, vd))
    return out.reshape(B, 1, H * vd) @ lp.wo


def _layer(lp: Block, x, cfg: LMConfig, positions):
    """One prefill/teacher-forced layer; returns (x, its cache entries:
    {"k", "v"} or MLA's {"c", "kr"}, its f32 aux loss)."""
    h = rms_norm(x, lp.ln1, NORM_EPS)
    if cfg.attn_type == "gqa":
        q, k, v = _gqa_qkv(lp, h, cfg, positions)
        attn = run_attention(q, k, v, cfg, causal=True) @ lp.wo
        kv = {"k": k, "v": v}
    else:
        attn, (c, kr) = _mla_attention_train(lp, h, cfg, positions)
        kv = {"c": c, "kr": kr}
    x = x + attn
    h = rms_norm(x, lp.ln2, NORM_EPS)
    out, aux = _ffn(lp, h, cfg)
    return x + out, kv, aux


def lm_head_weight(params: LM, cfg: LMConfig):
    """The (d, V) head: the embedding's transpose where it is tied."""
    if cfg.tie_embeddings:
        return params.embed.T
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
# training: the parameter tree, the differentiable forward, the loss


def params_tree(params: LM) -> dict:
    """The model's weights as the JAX package's tree: ``embed``,
    ``layers`` (each weight stacked over a leading layer axis),
    ``final_norm`` and, unless tied, ``lm_head``.  New tensors: the
    stacks are copies."""
    tree = {
        "embed": params.embed.detach().clone(),
        "layers": {name: torch.stack([getattr(lp, name).detach() for lp in params.layers])
                   for name in layer_shapes(params.cfg)},
        "final_norm": params.final_norm.detach().clone(),
    }
    if params.lm_head is not None:
        tree["lm_head"] = params.lm_head.detach().clone()
    return tree


def init_tree(gen: torch.Generator, cfg: LMConfig) -> dict:
    """:func:`init_params`'s weights (the same draws) as a training
    tree."""
    return params_tree(init_params(gen, cfg))


def forward_train(tree: dict, tokens, cfg: LMConfig):
    """The JAX package's ``forward``: token ids (B, S) -> (final hidden
    states (B, S, d), the layers' summed f32 aux loss), differentiable in
    the tree.  Each layer reads its views of the stacked weights from one
    ``unbind`` a weight (whose backward is one ``stack``); under
    ``remat="full"`` a layer keeps only its input and runs again in the
    backward (``torch.utils.checkpoint``)."""
    B, S = tokens.shape
    x = tree["embed"][tokens.long()]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    names = list(tree["layers"])
    views = [t.unbind(0) for t in tree["layers"].values()]

    def layer(x, *weights):
        x, _, aux = _layer(SimpleNamespace(**dict(zip(names, weights))), x, cfg, positions)
        return x, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for li in range(cfg.n_layers):
        weights = [v[li] for v in views]
        if cfg.remat == "full":
            x, a = checkpoint(layer, x, *weights, use_reentrant=False)
        else:
            x, a = layer(x, *weights)
        aux = aux + a
    return rms_norm(x, tree["final_norm"], NORM_EPS), aux


def lm_loss(tree: dict, batch: dict, cfg: LMConfig):
    """Next-token CE with the vocab projection taken ``loss_chunk``
    positions at a time, in f32 logits, plus ``aux_loss_weight * aux /
    n_layers`` for MoE (the JAX package's ``lm_loss``).  batch:
    {'tokens': (B, S), 'labels': (B, S)}, labels < 0 masked; the mean
    is over the unmasked labels (at least 1).  S must be a multiple of
    the chunk: the JAX package visits only ``S // chunk`` chunks and so
    drops the labels past the last whole one; this one raises instead."""
    tokens, labels = batch["tokens"], batch["labels"]
    S = tokens.shape[1]
    x, aux = forward_train(tree, tokens, cfg)
    head = tree["embed"].T if cfg.tie_embeddings else tree["lm_head"]
    chunk = min(cfg.loss_chunk or S, S)
    if S % chunk:
        raise ValueError(f"lm_loss: sequence length {S} is not a multiple of the loss "
                         f"chunk {chunk}; the labels past the last whole chunk would be "
                         f"dropped")
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for ci in range(S // chunk):
        lc = labels[:, ci * chunk:(ci + 1) * chunk].long()
        logits = (x[:, ci * chunk:(ci + 1) * chunk] @ head).float()  # (B, c, V)
        logz = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, lc.clamp(min=0)[..., None])[..., 0]
        mask = (lc >= 0).float()
        tot = tot + torch.sum((logz - ll) * mask)
        cnt = cnt + torch.sum(mask)
    loss = tot / torch.clamp(cnt, min=1.0)
    if cfg.moe:
        loss = loss + cfg.moe.aux_loss_weight * aux / cfg.n_layers
    return loss


# ----------------------------------------------------------------- #
# serving: prefill + single-token decode with a static-size cache


def cache_shapes(cfg: LMConfig, batch: int, max_len: int) -> dict:
    """The cache's tensors as meta tensors (shape and dtype, no data):
    GQA's k and v, or MLA's latent c and rope key kr."""
    L = cfg.n_layers
    if cfg.attn_type == "mla":
        shapes = {"c": (L, batch, max_len, cfg.kv_lora_rank),
                  "kr": (L, batch, max_len, cfg.qk_rope_dim)}
    else:
        shape = (L, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        shapes = {"k": shape, "v": shape}
    return {name: torch.empty(s, dtype=cfg.dtype, device="meta")
            for name, s in shapes.items()}


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
        x, kv, _ = _layer(lp, x, cfg, positions)
        for name, t in kv.items():
            cache[name][li, :, :S] = t
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
    T = next(iter(cache.values())).shape[2]
    if not 0 <= pos < T:
        raise ValueError(f"position {pos} outside the cache's {T} slots")
    x = _embed(params, tokens)[:, None, :]  # (B,1,d)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    for li, lp in enumerate(params.layers):
        h = rms_norm(x, lp.ln1, NORM_EPS)
        if cfg.attn_type == "gqa":
            q, k, v = _gqa_qkv(lp, h, cfg, positions)
            cache["k"][li, :, pos] = k[:, 0]
            cache["v"][li, :, pos] = v[:, 0]
            attn = decode_attention(q, cache["k"][li], cache["v"][li], pos, scale) @ lp.wo
        else:
            c, kr = _mla_latent(lp, h, cfg, positions)
            cache["c"][li, :, pos] = c[:, 0]
            cache["kr"][li, :, pos] = kr[:, 0]
            attn = _mla_attention_decode(lp, h, cfg, cache["c"][li], cache["kr"][li], pos)
        x = x + attn
        h = rms_norm(x, lp.ln2, NORM_EPS)
        x = x + _ffn(lp, h, cfg)[0]
    x = rms_norm(x, params.final_norm, NORM_EPS)
    logits = (x[:, 0] @ lm_head_weight(params, cfg)).float()
    return logits, cache
