"""Decoder-only transformer LM: dense GQA (phi3-mini, minitron), MLA
(minicpm3) and GQA with MoE FFNs (phi3.5-moe, dbrx); prefill and greedy
decode for serving, and the training loss.

The port of the JAX package's ``models/lm.py``.  A model is an
:class:`LM` module: the embedding, an ``nn.ModuleList`` of
:class:`Block` (one per layer, each weight in the JAX package's
``(in, out)`` layout so ``x @ w`` reads the same) and the final norm
and head (none when the embedding is tied).  The public functions keep
the JAX package's names and its ``(B, S, H, dh)`` activation layout;
they take the module where the JAX package takes its parameter tree.
The serving functions take the JAX package's ``topo`` last, as
``topo=None``: one card, or a :class:`~repro_torch.models.common.Topology`
of one rank, runs the one-card code.

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

Serving across ranks (a topology of more than one rank, one process a
rank over ``torch.distributed``; the layouts of the JAX package's
:func:`param_specs` and :func:`cache_specs`): each rank holds its block
of every weight (:func:`init_params` with ``topo``, or
``convert.shard_tree``), laid out Megatron-style over ``tp`` (heads,
FFN, experts and vocab) and FSDP over ``dp`` (each weight's other dim,
all-gathered a layer at a time before use).  The embedding is a masked
lookup in the rank's vocab rows, summed over ``tp``; ``wq``/``wk``/
``wv``/``wg``/``wu`` are column-parallel, so a rank attends over its
Hq/tp and Hkv/tp heads through the kernel, and ``wo``/``wd`` are
row-parallel, summed over ``tp``; MoE layers hold E/tp experts a rank
(``moe_ffn``'s EP-as-TP).  The batch splits over ``dp`` where it
divides, else every ``dp`` rank runs all of it (the JAX package's
rule, which sets each MoE layer's capacity).  The head is vocab-split:
a rank's logits are its (rows, V/tp) block, and :func:`greedy_tokens`
takes the argmax over the blocks (ties to the lower vocab index).  The
KV cache splits its sequence over ``tp`` (``decode_*``) or over every
rank (``long=True``, the ``long_*`` cells; the batch whole): prefill
moves each rank's heads into the sequence chunks with one
``all_to_all`` a layer; a decode step all-gathers q and the new k and
v, the chunk's owner writes them, and each rank attends over its chunk
for every head, the chunks' partial outputs merged by their log-sum-exp.

Training across ranks (:func:`lm_loss` and :func:`forward_train` with a
``topo``) takes the rank's blocks of the training tree and the whole
batch, and keeps the same layouts: each rank trains on its dp rows;
with ``seq_shard_resid`` (the JAX package's default) a tp rank holds its
S/tp slice of the residual between products, the norm's output
all-gathered over tp before them and the row-parallel sums
reduce-scattered back, else the products' outputs are all-reduced; the
FSDP gathers' backward reduce-scatters the gradients over dp; the loss
is a vocab-parallel cross-entropy over the rank's V/tp columns, summed
over dp into the global mean.  The collectives are the autograd
functions of ``models/common.py``.
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
    Topology,
    apply_rope,
    copy_to,
    fan_in_init,
    gather_from,
    max_over,
    normal_init,
    reduce_from,
    reduce_scatter_to,
    relu2,
    rms_norm,
    rope_angles,
    shard_shape,
    sharded,
    shard_slices,
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
    seq_shard_resid: bool = True      # training across ranks: the residual split over tp along S

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
    None where the config ties the head to the embedding.  With a
    ``topo`` of more than one rank, each tensor is this rank's block of
    it (:func:`param_specs`)."""

    def __init__(self, cfg: LMConfig, embed, layers: list, final_norm,
                 lm_head=None, topo: Optional[Topology] = None):
        super().__init__()
        topo = sharded(topo)
        if len(layers) != cfg.n_layers:
            raise ValueError(f"{cfg.name}: {len(layers)} layers, config says {cfg.n_layers}")
        if (lm_head is None) != cfg.tie_embeddings:
            raise ValueError(f"{cfg.name}: tie_embeddings={cfg.tie_embeddings} but "
                             f"lm_head is {'absent' if lm_head is None else 'given'}")
        want = {k: s for k, (s, _) in layer_shapes(cfg).items()}
        if topo is not None:
            check_shardable(cfg, topo)
            want = {k: shard_shape(s, layer_specs(cfg, topo)[k], topo)
                    for k, s in want.items()}
        for li, tensors in enumerate(layers):
            got = {k: tuple(t.shape) for k, t in tensors.items()}
            if got != want:
                raise ValueError(f"{cfg.name}: layer {li} weights {got} do not match {want}")
        self.cfg = cfg
        self.topo = topo
        self.embed = _param(embed)
        self.layers = nn.ModuleList(Block(t) for t in layers)
        self.final_norm = _param(final_norm)
        self.lm_head = None if lm_head is None else _param(lm_head)


def init_params(gen: torch.Generator, cfg: LMConfig,
                topo: Optional[Topology] = None) -> LM:
    """Random weights drawn on ``gen``'s device (a full-size model is
    made on the card, one tensor at a time, never on the host).  With a
    ``topo`` of more than one rank, every tensor is drawn whole, as one
    card draws it, and only this rank's block kept: the ranks' blocks
    are the one-card model's, and no rank holds more than one whole
    tensor at a time."""
    dt = cfg.dtype
    dev = gen.device
    topo = sharded(topo)
    specs = None
    if topo is not None:
        check_shardable(cfg, topo)
        specs = param_specs(cfg, topo)

    def keep(t, spec):
        return t if specs is None else shard_block(t, spec, topo)

    def layer():
        return {
            name: keep(torch.ones(shape, dtype=dt, device=dev) if fan is None
                       else fan_in_init(gen, shape, fan, dt),
                       None if specs is None else specs["layers"][name][1:])
            for name, (shape, fan) in layer_shapes(cfg).items()
        }

    d, V = cfg.d_model, cfg.vocab
    embed = keep(normal_init(gen, (V, d), 0.02, dt), specs and specs["embed"])
    layers = [layer() for _ in range(cfg.n_layers)]
    head = None if cfg.tie_embeddings else keep(fan_in_init(gen, (d, V), d, dt),
                                                specs and specs["lm_head"])
    return LM(cfg, embed, layers, torch.ones((d,), dtype=dt, device=dev), head, topo=topo)


# ----------------------------------------------------------------- #
# layouts across ranks (the JAX package's specs)


def param_specs(cfg: LMConfig, topo: Topology) -> dict:
    """The JAX package's ``param_specs``: a spec a leaf of the parameter
    tree (:func:`params_tree`'s layout, layers stacked on a leading
    axis): TP on heads, FFN and vocab (``"tp"``), FSDP on the other dim
    (``"dp"``)."""
    s = topo.spec
    layers: dict = {"ln1": s(None, None), "ln2": s(None, None)}
    if cfg.attn_type == "gqa":
        layers.update(wq=s(None, "dp", "tp"), wk=s(None, "dp", "tp"),
                      wv=s(None, "dp", "tp"), wo=s(None, "tp", "dp"))
    else:
        # the reference keeps MLA's small lora projections replicated or
        # TP-only: FSDP on their contraction dims all-reduced activations
        layers.update(
            wq_a=s(None, None, None), q_norm=s(None, None), wq_b=s(None, None, "tp"),
            wkv_a=s(None, None, None), kv_norm=s(None, None), wk_b=s(None, None, "tp"),
            wv_b=s(None, None, "tp"), wo=s(None, "tp", "dp"),
        )
    if cfg.moe:
        layers.update(router=s(None, None, None), wg_e=s(None, "tp", "dp", None),
                      wu_e=s(None, "tp", "dp", None), wd_e=s(None, "tp", None, "dp"))
    else:
        layers.update(wg=s(None, "dp", "tp"), wd=s(None, "tp", "dp"))
        if cfg.mlp_type == "swiglu":
            layers.update(wu=s(None, "dp", "tp"))
    specs = {"embed": s("tp", "dp"), "layers": layers, "final_norm": s(None)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = s("dp", "tp")
    return specs


def layer_specs(cfg: LMConfig, topo: Topology) -> dict:
    """:func:`param_specs`' layer entries for one layer's weights (the
    stacked axis dropped)."""
    return {k: v[1:] for k, v in param_specs(cfg, topo)["layers"].items()}


def cache_specs(cfg: LMConfig, topo: Topology, *, long: bool) -> dict:
    """The JAX package's ``cache_specs``: the KV cache's sequence split
    over ``tp`` and its batch over ``dp`` (``decode_*``), or its sequence
    over every rank and its batch whole (``long_*``, B 1)."""
    s = topo.spec
    if long:
        seq, seq5 = s(None, None, "all", None), s(None, None, "all", None, None)
    else:
        seq, seq5 = s(None, "dp", "tp", None), s(None, "dp", "tp", None, None)
    if cfg.attn_type == "mla":
        return {"c": seq, "kr": seq}
    return {"k": seq5, "v": seq5}


def check_shardable(cfg: LMConfig, topo: Topology) -> None:
    """Refuse, before any work, a model the grid cannot split: heads,
    kv heads, experts, vocab or FFN width not a multiple of tp, or the
    FSDP dims (d_model, the dense FFN width) not of dp.  The production
    grid's tp 16 exceeds the GQA archs' 8 kv heads: such a layout only
    plans here (``launch/dryrun.py``)."""
    if cfg.attn_type == "mla":
        raise NotImplementedError(
            f"{cfg.name}: MLA across ranks is not ported yet (ROADMAP Queue 1, 5.6b); "
            f"its param_specs and cache_specs plan only")
    tp, dp = topo.tp_size, topo.dp_size
    split = {"q heads": cfg.n_heads, "kv heads": cfg.n_kv_heads, "vocab": cfg.vocab}
    split.update({"experts": cfg.moe.n_experts} if cfg.moe else {"d_ff": cfg.d_ff})
    for what, n in split.items():
        if n % tp:
            raise ValueError(f"{cfg.name}: {n} {what} do not split over tp {tp}; a grid "
                             f"of this tp only plans this model (launch/dryrun.py)")
    fsdp = {"d_model": cfg.d_model}
    if not cfg.moe:
        fsdp["d_ff"] = cfg.d_ff
    for what, n in fsdp.items():
        if n % dp:
            raise ValueError(f"{cfg.name}: {what} {n} does not split over dp {dp} (FSDP)")


def shard_block(t: torch.Tensor, spec, topo: Topology) -> torch.Tensor:
    """This rank's block of ``t`` laid out by ``spec``, a new contiguous
    tensor."""
    return t[shard_slices(t.shape, spec, topo)].clone(memory_format=torch.contiguous_format)


def shard_params(model: LM, topo: Topology) -> LM:
    """A one-card model's blocks for this rank of ``topo``."""
    cfg = model.cfg
    check_shardable(cfg, topo)
    specs = param_specs(cfg, topo)
    layers = [{name: shard_block(getattr(lp, name), specs["layers"][name][1:], topo)
               for name in layer_shapes(cfg)} for lp in model.layers]
    head = None if model.lm_head is None else shard_block(model.lm_head, specs["lm_head"], topo)
    return LM(cfg, shard_block(model.embed, specs["embed"], topo), layers,
              model.final_norm.detach().clone(), head, topo=topo)


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


def _enter_tp(h, topo: Optional[Topology], sp: bool = False):
    """A normed activation entering column-parallel products: as it is
    (its gradient summed over tp), or under the sequence-parallel
    residual (``sp``) its S/tp slices all-gathered over tp."""
    return gather_from(h, topo, 1, "tp") if sp else copy_to(h, topo, "tp")


def _leave_tp(y, topo: Optional[Topology], sp: bool = False):
    """A row-parallel product's partial sums summed over tp, or under
    ``sp`` reduce-scattered along S (each tp rank its slice)."""
    return reduce_scatter_to(y, topo, 1, "tp") if sp else reduce_from(y, topo, "tp")


def _norm_scale(w, topo: Optional[Topology], sp: bool = False):
    """A norm's scale: under ``sp`` each tp rank norms its S slice, so
    the scale's gradient is summed over tp."""
    return copy_to(w, topo, "tp") if sp else w


def _mlp(lp: Block, x, cfg: LMConfig, topo: Optional[Topology] = None, sp: bool = False):
    x = _enter_tp(x, topo, sp)
    if cfg.mlp_type == "swiglu":
        h = swiglu(x @ lp.wg, x @ lp.wu)
    else:
        h = relu2(x @ lp.wg)
    return _leave_tp(h @ lp.wd, topo, sp)


def _ffn(lp: Block, x, cfg: LMConfig, topo: Optional[Topology] = None,
         over_dp: bool = False, sp: bool = False):
    """The layer's FFN and its f32 aux loss: MoE's load-balance term
    where the config has it, else the dense MLP and 0.  Across ranks
    (``topo``) the rank's experts or FFN columns, summed over tp;
    ``over_dp``: the batch is split over dp; ``sp``: ``x`` is the rank's
    S/tp slice and so is the output."""
    if cfg.moe:
        return moe_ffn(x, lp.router, lp.wg_e, lp.wu_e, lp.wd_e, cfg.moe, topo,
                       batch_over_dp=over_dp, seq_shard=sp)
    return _mlp(lp, x, cfg, topo, sp), torch.zeros((), dtype=torch.float32, device=x.device)


def _gqa_qkv(lp: Block, x, cfg: LMConfig, positions):
    """q, k, v of the heads ``lp`` holds: all, or a rank's Hq/tp and
    Hkv/tp."""
    B, S, d = x.shape
    dh = cfg.head_dim
    H, KV = lp.wq.shape[-1] // dh, lp.wk.shape[-1] // dh
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


def _layer(lp: Block, x, cfg: LMConfig, positions, topo: Optional[Topology] = None,
           over_dp: bool = False, sp: bool = False):
    """One prefill/teacher-forced layer; returns (x, its cache entries:
    {"k", "v"} or MLA's {"c", "kr"}, its f32 aux loss).  Across ranks
    (``topo``; GQA only) ``lp`` is the rank's weights (:class:`_Shard`)
    and the cache entries are its heads'; under the sequence-parallel
    residual (``sp``, training) ``x`` is the rank's S/tp slice."""
    h = rms_norm(x, _norm_scale(lp.ln1, topo, sp), NORM_EPS)
    if cfg.attn_type == "gqa":
        q, k, v = _gqa_qkv(lp, _enter_tp(h, topo, sp), cfg, positions)
        attn = _leave_tp(run_attention(q, k, v, cfg, causal=True) @ lp.wo, topo, sp)
        kv = {"k": k, "v": v}
    else:
        attn, (c, kr) = _mla_attention_train(lp, h, cfg, positions)
        kv = {"c": c, "kr": kr}
    x = x + attn
    h = rms_norm(x, _norm_scale(lp.ln2, topo, sp), NORM_EPS)
    out, aux = _ffn(lp, h, cfg, topo, over_dp, sp)
    return x + out, kv, aux


def lm_head_weight(params: LM, cfg: LMConfig):
    """The (d, V) head: the embedding's transpose where it is tied."""
    if cfg.tie_embeddings:
        return params.embed.T
    return params.lm_head


def _embed(params: LM, tokens):
    return params.embed[tokens.long()]


@torch.inference_mode()
def forward(params: LM, tokens, cfg: LMConfig, topo: Optional[Topology] = None):
    """Token ids (B, S) -> final hidden states (B, S, d); across ranks,
    the rank's rows of them (:func:`batch_rows`)."""
    if sharded(topo) is not None:
        return _forward_sharded(params, tokens, cfg, topo)
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


def _seq_parallel(cfg: LMConfig, topo: Optional[Topology]) -> bool:
    """Whether a training run across ranks splits the residual over tp
    along S (``seq_shard_resid``; the one-card path ignores the field)."""
    return topo is not None and cfg.seq_shard_resid and topo.tp_size > 1


def check_trainable(cfg: LMConfig, topo: Topology, B: int, S: int) -> None:
    """Refuse, before any work, a training batch the grid cannot split:
    :func:`check_shardable`'s refusals, a batch that does not split over
    dp (each dp rank trains on its rows), and under ``seq_shard_resid`` a
    sequence that does not split over tp."""
    check_shardable(cfg, topo)
    if B % topo.dp_size:
        raise ValueError(f"{cfg.name}: a training batch of {B} rows does not split over "
                         f"dp {topo.dp_size}")
    if _seq_parallel(cfg, topo) and S % topo.tp_size:
        raise ValueError(f"{cfg.name}: sequence length {S} does not split over tp "
                         f"{topo.tp_size} (seq_shard_resid)")


def forward_train(tree: dict, tokens, cfg: LMConfig, topo: Optional[Topology] = None):
    """The JAX package's ``forward``: token ids (B, S) -> (final hidden
    states (B, S, d), the layers' summed f32 aux loss), differentiable in
    the tree.  Each layer reads its views of the stacked weights from one
    ``unbind`` a weight (whose backward is one ``stack``); under
    ``remat="full"`` a layer keeps only its input and runs again in the
    backward (``torch.utils.checkpoint``, which stops the run once the
    last tensor the backward needs is rebuilt).

    Across ranks (``topo`` of more than one rank) the tree is this
    rank's blocks by :func:`param_specs`, ``tokens`` the whole batch, and
    the hidden states this rank's: its dp rows, and under
    ``seq_shard_resid`` its S/tp slice of them.  Each layer all-gathers
    its FSDP blocks over dp (their gradient reduce-scattered back); a
    forward run again under remat tallies its collectives under
    ``"recompute "`` keys of ``topo.counts``."""
    topo = sharded(topo)
    sp = _seq_parallel(cfg, topo)
    if topo is None:
        x = tree["embed"][tokens.long()]
    else:
        check_trainable(cfg, topo, *tokens.shape)
        tokens = tokens[batch_rows(tokens.shape[0], topo)[0]]
        x = _embed_sharded(tree["embed"], tokens, cfg, topo, sp)
    B, S = tokens.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    names = list(tree["layers"])
    views = [t.unbind(0) for t in tree["layers"].values()]
    specs = None if topo is None else layer_specs(cfg, topo)
    ran = set()

    def layer(li, x, *weights):
        lp = SimpleNamespace(**dict(zip(names, weights)))
        if topo is None:
            x, _, aux = _layer(lp, x, cfg, positions)
            return x, aux
        again = li in ran  # remat runs the layer again in the backward
        ran.add(li)
        with topo.tagged("recompute " if again else ""):
            x, _, aux = _layer(_Shard(lp, specs, topo), x, cfg, positions, topo,
                               topo.dp_size > 1, sp)
        return x, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for li in range(cfg.n_layers):
        weights = [v[li] for v in views]
        if cfg.remat == "full":
            x, a = checkpoint(layer, li, x, *weights, use_reentrant=False)
        else:
            x, a = layer(li, x, *weights)
        aux = aux + a
    return rms_norm(x, _norm_scale(tree["final_norm"], topo, sp), NORM_EPS), aux


def _vocab_parallel_ce(logits, labels, topo: Topology) -> tuple:
    """(log-sum-exp, the label's logit) of a tp rank's f32 logits block
    (rows, c, V/tp): the max and the sum of exps combined over tp, the
    label's logit from the rank whose columns hold it."""
    Vl = logits.shape[-1]
    m = max_over(logits.amax(dim=-1), topo, "tp")
    part = torch.exp(logits - m[..., None]).sum(dim=-1)
    t = labels.clamp(min=0) - topo.tp_rank * Vl
    mine = (t >= 0) & (t < Vl)
    ll = torch.where(mine, torch.gather(logits, -1, t.clamp(0, Vl - 1)[..., None])[..., 0], 0.0)
    total, ll = reduce_from(torch.stack([part, ll]), topo, "tp").unbind(0)
    return m + torch.log(total), ll


def lm_loss(tree: dict, batch: dict, cfg: LMConfig, topo: Optional[Topology] = None):
    """Next-token CE with the vocab projection taken ``loss_chunk``
    positions at a time, in f32 logits, plus ``aux_loss_weight * aux /
    n_layers`` for MoE (the JAX package's ``lm_loss``).  batch:
    {'tokens': (B, S), 'labels': (B, S)}, labels < 0 masked; the mean
    is over the unmasked labels (at least 1).  S must be a multiple of
    the chunk: the JAX package visits only ``S // chunk`` chunks and so
    drops the labels past the last whole one; this one raises instead.

    Across ranks (``topo``) the tree is this rank's blocks, the batch the
    whole batch: each rank computes its dp rows' CE against its V/tp
    vocab columns (the vocab-parallel log-sum-exp), the sums and counts
    are summed over dp, and every rank returns the global mean, as the
    JAX package's GSPMD program does (a rank's gradients are then its
    rows' share: :func:`~repro_torch.train.train_step.build_train_step`
    sums the replicated leaves' over dp)."""
    tokens, labels = batch["tokens"], batch["labels"]
    S = tokens.shape[1]
    chunk = min(cfg.loss_chunk or S, S)
    if S % chunk:
        raise ValueError(f"lm_loss: sequence length {S} is not a multiple of the loss "
                         f"chunk {chunk}; the labels past the last whole chunk would be "
                         f"dropped")
    topo = sharded(topo)
    if topo is not None:
        check_trainable(cfg, topo, *tokens.shape)
        labels = labels[batch_rows(tokens.shape[0], topo)[0]]
    x, aux = forward_train(tree, tokens, cfg, topo)
    if topo is None:
        head = tree["embed"].T if cfg.tie_embeddings else tree["lm_head"]
    else:
        head = _head_block(tree["embed"] if cfg.tie_embeddings else tree["lm_head"], cfg, topo)
        x = _enter_tp(x, topo, _seq_parallel(cfg, topo))
    vocab_split = topo is not None and topo.tp_size > 1
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for ci in range(S // chunk):
        lc = labels[:, ci * chunk:(ci + 1) * chunk].long()
        logits = (x[:, ci * chunk:(ci + 1) * chunk] @ head).float()  # (B, c, V or V/tp)
        if vocab_split:
            logz, ll = _vocab_parallel_ce(logits, lc, topo)
        else:
            logz = torch.logsumexp(logits, dim=-1)
            ll = torch.gather(logits, -1, lc.clamp(min=0)[..., None])[..., 0]
        mask = (lc >= 0).float()
        tot = tot + torch.sum((logz - ll) * mask)
        cnt = cnt + torch.sum(mask)
    if topo is not None:
        tot, cnt = reduce_from(torch.stack([tot, cnt]), topo, "dp").unbind(0)
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
def prefill_step(params: LM, tokens, cfg: LMConfig, max_len: int,
                 topo: Optional[Topology] = None, *, long: bool = False):
    """Prompt (B, S) -> (cache dict, last-position logits (B, V) f32).
    The cache holds ``max_len`` positions, zero past the prompt.  Across
    ranks every rank is given the whole prompt and returns its block of
    the cache (:func:`cache_specs`, ``long`` picking the layout) and of
    the logits (its rows, its V/tp columns)."""
    if sharded(topo) is not None:
        return _prefill_sharded(params, tokens, cfg, max_len, topo, long)
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
def decode_step(params: LM, cache: dict, tokens, pos: int, cfg: LMConfig,
                topo: Optional[Topology] = None, *, long: bool = False):
    """One decode step: tokens (B,) at position ``pos`` against the
    cache.  Returns (logits (B, V) f32, cache).  The cache is updated
    in place (the JAX package returns a new one); the returned dict is
    the one given.  Across ranks every rank is given all B tokens, and
    the cache and logits are the rank's blocks, as from
    :func:`prefill_step` with the same ``long``."""
    if sharded(topo) is not None:
        return _decode_sharded(params, cache, tokens, pos, cfg, topo, long)
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


def greedy_tokens(logits, topo: Optional[Topology] = None, batch: Optional[int] = None):
    """The greedy next tokens (B,) int32 of ``logits``: the argmax over
    the vocab, ties to the lower index.  Across ranks ``logits`` is this
    rank's block from :func:`prefill_step` or :func:`decode_step` of a
    batch of ``batch`` rows: the argmax of each vocab block, then the
    largest over the ``tp`` blocks (ties to the lower rank, whose vocab
    indices are lower), then the rows of every ``dp`` rank; every rank
    returns all B tokens."""
    topo = sharded(topo)
    if topo is None:
        return logits.argmax(-1).to(torch.int32)
    if batch is None:
        raise ValueError("greedy_tokens across ranks needs the batch size")
    idx = logits.argmax(-1)
    val = logits.gather(-1, idx[:, None])[:, 0]
    vals = topo.all_gather(val[None], 0, "tp")
    idxs = topo.all_gather((idx + topo.tp_rank * logits.shape[-1])[None], 0, "tp")
    tok = idxs.gather(0, vals.argmax(0)[None])[0]
    if batch_rows(batch, topo)[1]:
        tok = topo.all_gather(tok, 0, "dp")
    return tok.to(torch.int32)


# ----------------------------------------------------------------- #
# serving across ranks


def batch_rows(B: int, topo: Topology) -> tuple:
    """(this rank's rows of a batch of B, whether the batch splits over
    dp): B / dp rows where dp divides B, else all B on every dp rank."""
    dp = topo.dp_size
    if dp > 1 and B % dp == 0:
        n = B // dp
        return slice(topo.dp_rank * n, (topo.dp_rank + 1) * n), True
    return slice(0, B), False


def _gathered(w, spec, topo: Topology):
    """``w`` all-gathered over dp along the dim its spec splits over dp
    (FSDP), its gradient reduce-scattered back; or ``w`` itself."""
    if topo.dp_size > 1:
        for dim, entry in enumerate(spec):
            if entry is not None and entry == topo.dp:
                return gather_from(w, topo, dim, "dp")
    return w


class _Shard:
    """A sharded layer's weights as used: each read all-gathers its
    block over dp (FSDP) and keeps the whole for the layer (the rank's
    tp block)."""

    def __init__(self, lp, specs: dict, topo: Topology):
        self._lp, self._specs, self._topo, self._full = lp, specs, topo, {}

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        if name not in self._full:
            self._full[name] = _gathered(getattr(self._lp, name), self._specs[name], self._topo)
        return self._full[name]


def _embed_sharded(embed, tokens, cfg: LMConfig, topo: Topology, sp: bool = False):
    """The rank's vocab rows of ``embed`` (its block, FSDP-gathered)
    looked up where a token falls among them, zero elsewhere, summed over
    tp (under ``sp`` reduce-scattered along S)."""
    table = _gathered(embed, param_specs(cfg, topo)["embed"], topo)
    t = tokens.long() - topo.tp_rank * table.shape[0]
    inside = (t >= 0) & (t < table.shape[0])
    x = torch.where(inside[..., None], table[t.clamp(0, table.shape[0] - 1)], 0)
    return _leave_tp(x, topo, sp)


def _head_block(w, cfg: LMConfig, topo: Topology):
    """The (d, V/tp) head of this rank's vocab columns from its block of
    ``lm_head`` (or of the tied embedding), FSDP-gathered."""
    specs = param_specs(cfg, topo)
    if cfg.tie_embeddings:
        return _gathered(w, specs["embed"], topo).T
    return _gathered(w, specs["lm_head"], topo)


def _head_sharded(params: LM, x, cfg: LMConfig, topo: Topology):
    """f32 logits of the rank's V/tp vocab columns."""
    w = params.embed if cfg.tie_embeddings else params.lm_head
    return (x @ _head_block(w, cfg, topo)).float()


def _check_topo(params: LM, topo: Topology) -> None:
    if params.topo is None or params.topo.grid != topo.grid or params.topo.rank != topo.rank:
        raise ValueError("the model's blocks were not cut for this rank of this topology "
                         "(init_params(topo=) or shard_params)")


def _forward_sharded(params: LM, tokens, cfg: LMConfig, topo: Topology):
    _check_topo(params, topo)
    rows, over_dp = batch_rows(tokens.shape[0], topo)
    tokens = tokens[rows]
    B, S = tokens.shape
    x = _embed_sharded(params.embed, tokens, cfg, topo)
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    specs = layer_specs(cfg, topo)
    for lp in params.layers:
        x, _, _ = _layer(_Shard(lp, specs, topo), x, cfg, positions, topo, over_dp)
    return rms_norm(x, params.final_norm, NORM_EPS)


def _layout_rows(B: int, topo: Topology, long: bool) -> tuple:
    """:func:`batch_rows`, refusing a batch the cache layout cannot hold:
    the decode layout splits the batch over dp, the long one keeps it
    whole."""
    rows, over_dp = batch_rows(B, topo)
    if long and over_dp:
        raise ValueError(f"the long layout keeps the batch whole on every rank; a batch "
                         f"of {B} splits over dp {topo.dp_size}")
    if not long and topo.dp_size > 1 and not over_dp:
        raise ValueError(f"the decode layout splits the batch over dp; a batch of {B} "
                         f"does not split over dp {topo.dp_size} (long=True keeps it whole)")
    return rows, over_dp


def _chunks(topo: Topology, long: bool) -> tuple:
    """(the sequence chunks of the cache, this rank's chunk, the group
    that holds every chunk of its rows): over tp, or over every rank."""
    if long:
        return topo.n_devices, topo.rank, "world"
    return topo.tp_size, topo.tp_rank, "tp"


def _cache_chunk(t, max_len: int, topo: Topology, long: bool):
    """The rank's heads' k or v (B, S, Hkv/tp, dh) at every prompt
    position -> the rank's sequence chunk of every head (B, max_len /
    chunks, Hkv, dh): one all_to_all over tp.  In the long layout the
    batch is whole on every dp rank, so a tp group trades the chunks of
    its dp index (the chunks of rank r are r's)."""
    n, _, _ = _chunks(topo, long)
    B, S, H, dh = t.shape
    full = t.new_zeros((B, max_len, H, dh))
    full[:, :S] = t
    pieces = list(full.split(max_len // n, dim=1))
    if long:
        T = topo.tp_size
        pieces = pieces[topo.dp_rank * T:(topo.dp_rank + 1) * T]
    return torch.cat(topo.all_to_all(pieces, "tp"), dim=2)


def _prefill_sharded(params: LM, tokens, cfg: LMConfig, max_len: int, topo: Topology,
                     long: bool):
    _check_topo(params, topo)
    B, S = tokens.shape
    if S > max_len:
        raise ValueError(f"prompt length {S} exceeds max_len {max_len}")
    n, _, _ = _chunks(topo, long)
    if max_len % n:
        raise ValueError(f"max_len {max_len} does not split into {n} sequence chunks")
    rows, over_dp = _layout_rows(B, topo, long)
    tokens = tokens[rows]
    Bl = tokens.shape[0]
    x = _embed_sharded(params.embed, tokens, cfg, topo)
    positions = torch.arange(S, device=x.device)[None].expand(Bl, S)
    shape = (cfg.n_layers, Bl, max_len // n, cfg.n_kv_heads, cfg.head_dim)
    cache = {name: torch.zeros(shape, dtype=cfg.dtype, device=x.device) for name in ("k", "v")}
    specs = layer_specs(cfg, topo)
    for li, lp in enumerate(params.layers):
        x, kv, _ = _layer(_Shard(lp, specs, topo), x, cfg, positions, topo, over_dp)
        for name, t in kv.items():
            cache[name][li] = _cache_chunk(t, max_len, topo, long)
    x = rms_norm(x, params.final_norm, NORM_EPS)
    return cache, _head_sharded(params, x[:, -1], cfg, topo)


def _chunk_attention(q, k_chunk, v_chunk, last: int, scale: float):
    """One position's attention over a cache chunk's positions up to
    ``last`` (a chunk past the position, last < 0, has none): the f32
    partial output (B, 1, H, dh) and its log-sum-exp (B, 1, H)."""
    s = _grouped_scores(q, k_chunk) * scale  # (B, KV, G, 1, Tc)
    valid = torch.arange(k_chunk.shape[1], device=q.device) <= last
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = _grouped_out(p / l, v_chunk)  # (B, 1, H, dh)
    B, KV, G = s.shape[:3]
    lse = (m + torch.log(l)).reshape(B, KV * G, 1).transpose(1, 2)
    return out, lse


def _merge_chunks(out, lse, topo: Topology, scope: str):
    """The group's partial outputs merged by their log-sum-exp, in rank
    order on every rank: exact but for the order of the sums."""
    outs = topo.all_gather(out[None], 0, scope)
    lses = topo.all_gather(lse[None], 0, scope)
    w = torch.exp(lses - lses.amax(dim=0, keepdim=True))
    return (w[..., None] * outs).sum(dim=0) / w.sum(dim=0)[..., None]


def _decode_sharded(params: LM, cache: dict, tokens, pos: int, cfg: LMConfig,
                    topo: Topology, long: bool):
    _check_topo(params, topo)
    n, chunk, scope = _chunks(topo, long)
    Tc = cache["k"].shape[2]
    if not 0 <= pos < n * Tc:
        raise ValueError(f"position {pos} outside the cache's {n * Tc} slots")
    rows, over_dp = _layout_rows(tokens.shape[0], topo, long)
    tokens = tokens[rows]
    Bl = tokens.shape[0]
    x = _embed_sharded(params.embed, tokens[:, None], cfg, topo)  # (Bl, 1, d)
    positions = torch.full((Bl, 1), pos, dtype=torch.int32, device=x.device)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    Hl, lo, m = cfg.n_heads // topo.tp_size, chunk * Tc, topo.tp_rank
    specs = layer_specs(cfg, topo)
    for li, lp in enumerate(params.layers):
        w = _Shard(lp, specs, topo)
        h = rms_norm(x, lp.ln1, NORM_EPS)
        q, k, v = (topo.all_gather(t, 2, "tp") for t in _gqa_qkv(w, h, cfg, positions))
        if lo <= pos < lo + Tc:  # this rank's chunk holds the position
            cache["k"][li, :, pos - lo] = k[:, 0]
            cache["v"][li, :, pos - lo] = v[:, 0]
        out, lse = _chunk_attention(q, cache["k"][li], cache["v"][li], pos - lo, scale)
        out = _merge_chunks(out, lse, topo, scope).to(q.dtype)
        mine = out[:, :, m * Hl:(m + 1) * Hl].reshape(Bl, 1, -1)
        x = x + _leave_tp(mine @ w.wo, topo)
        h = rms_norm(x, lp.ln2, NORM_EPS)
        x = x + _ffn(w, h, cfg, topo, over_dp)[0]
    x = rms_norm(x, params.final_norm, NORM_EPS)
    return _head_sharded(params, x[:, 0], cfg, topo), cache
