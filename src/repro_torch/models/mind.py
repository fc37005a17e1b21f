"""MIND — Multi-Interest Network with Dynamic routing (arXiv:1904.08030):
serving and training.

The port of the JAX package's ``models/mind.py`` for one card: item
and profile embedding tables, B2I dynamic-routing capsules over the
user's behaviour sequence, profile fields pooled through the
embedding-bag kernel, max-over-interests scoring of candidates as one
batched product, and (training) label-aware attention and a sampled-
softmax loss.

Serving takes the :class:`MIND` module; training differentiates the
JAX package's parameter tree (:func:`params_tree`), and
:func:`interests` reads either.  On the kernel route (``bag_impl`` not
``"ref"``) the profile bag is ``kernels.BagSum``: forward the bag
kernel, backward the ``spmm_ell`` vertex sum over the bag's segment
ELL, so the profile table's gradient repeats its bits.  The item
table's gathers (history, target, negatives) are plain indexing, as in
the JAX package: their backward adds by atomics on the card.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.kernels.embedding_bag import bag_pool
from repro_torch.kernels.embedding_bag.ops import IMPLS as BAG_IMPLS
from repro_torch.models.common import fan_in_init, normal_init
from repro_torch.models.gnn.layers import init_mlp, mlp_apply


@dataclasses.dataclass(frozen=True)
class MINDConfig:
    name: str = "mind"
    embed_dim: int = 64
    n_interests: int = 4
    capsule_iters: int = 3
    n_items: int = 1_000_000
    n_profile: int = 100_000
    hist_len: int = 50
    n_profile_fields: int = 4
    profile_multi: int = 4     # multi-hot ids per profile field
    n_negatives: int = 127
    power: float = 2.0         # label-aware attention sharpness
    bag_impl: str = "ref"      # 'ref' (plain) | 'pallas' | 'pallas_interpret' (kernel op)

    def __post_init__(self):
        if self.bag_impl not in BAG_IMPLS:
            raise ValueError(f"bag_impl must be one of {BAG_IMPLS}, got {self.bag_impl!r}")


class MIND(nn.Module):
    """The JAX package's MIND parameters, under the same names."""

    def __init__(self, cfg: MINDConfig, item_table, profile_table,
                 bilinear, routing_init, interest_mlp: dict):
        super().__init__()
        d = cfg.embed_dim
        want = {"item_table": (cfg.n_items, d), "profile_table": (cfg.n_profile, d),
                "bilinear": (d, d), "routing_init": (cfg.n_interests,)}
        got = {"item_table": item_table, "profile_table": profile_table,
               "bilinear": bilinear, "routing_init": routing_init}
        for name, shape in want.items():
            if tuple(got[name].shape) != shape:
                raise ValueError(f"{name} must be {shape}, got {tuple(got[name].shape)}")
            self.register_parameter(name, nn.Parameter(got[name], requires_grad=False))
        self.interest_mlp = nn.ParameterDict(
            {k: nn.Parameter(v, requires_grad=False) for k, v in interest_mlp.items()})


def init_params(gen: torch.Generator, cfg: MINDConfig) -> MIND:
    """Random weights drawn on ``gen``'s device."""
    d = cfg.embed_dim
    return MIND(
        cfg,
        item_table=normal_init(gen, (cfg.n_items, d), 0.02),
        profile_table=normal_init(gen, (cfg.n_profile, d), 0.02),
        bilinear=fan_in_init(gen, (d, d), d),
        routing_init=normal_init(gen, (cfg.n_interests,), 1.0),
        interest_mlp=init_mlp(gen, [2 * d, d, d]),
    )


def params_tree(params: MIND) -> dict:
    """The model's weights as the JAX package's tree (``item_table``,
    ``profile_table``, ``bilinear``, ``routing_init``,
    ``interest_mlp.{w0,b0,w1,b1}``), for training.  New tensors: copies."""
    names = ("item_table", "profile_table", "bilinear", "routing_init")
    tree = {k: getattr(params, k).detach().clone() for k in names}
    tree["interest_mlp"] = {k: v.detach().clone() for k, v in params.interest_mlp.items()}
    return tree


def init_tree(gen: torch.Generator, cfg: MINDConfig) -> dict:
    """:func:`init_params`'s weights (the same draws) as a training tree."""
    return params_tree(init_params(gen, cfg))


def _weight(params, name: str):
    """A weight of the :class:`MIND` module or of its tree."""
    return params[name] if isinstance(params, dict) else getattr(params, name)


def squash(x, dim=-1, eps=1e-9):
    n2 = torch.sum(x * x, dim=dim, keepdim=True)
    return (n2 / (1.0 + n2)) * x / torch.sqrt(n2 + eps)


def interests(params, hist, hist_mask, profile_ids, profile_mask,
              cfg: MINDConfig):
    """B2I dynamic routing.  ``params`` is the :class:`MIND` module or
    its tree; hist (B, L) item ids; profile_ids (B, F*M) multi-hot
    profile ids.  Returns (B, K, d)."""
    B, L = hist.shape
    K, d = cfg.n_interests, cfg.embed_dim
    e = _weight(params, "item_table")[hist.long()]              # (B, L, d)
    e = e * hist_mask[..., None].to(e.dtype)
    eh = e @ _weight(params, "bilinear")                        # (B, L, d)

    # routing logits: fixed (non-trainable in-iteration) init per paper
    b = _weight(params, "routing_init")[None, None, :].expand(B, L, K)
    mask3 = hist_mask[..., None]
    caps = None
    for _ in range(cfg.capsule_iters):
        w = torch.softmax(torch.where(mask3, b, -1e30), dim=1)  # over L
        caps = squash(torch.einsum("blk,bld->bkd", w, eh))      # (B, K, d)
        b = b + torch.einsum("bkd,bld->blk", caps, eh)

    # profile features pool through the embedding-bag op
    prof = bag_pool(_weight(params, "profile_table"), profile_ids, profile_mask,
                    mode="mean", impl=cfg.bag_impl)             # (B, d)
    prof = prof[:, None, :].expand(B, K, d)
    out = mlp_apply(_weight(params, "interest_mlp"), torch.cat([caps, prof], dim=-1))
    return squash(out)


def label_aware_attention(caps, target_e, power: float):
    """caps (B, K, d), target (B, d) -> user vector (B, d)."""
    att = torch.einsum("bkd,bd->bk", caps, target_e)
    att = torch.softmax(torch.abs(att) ** power * torch.sign(att), dim=-1)
    return torch.einsum("bk,bkd->bd", att, caps)


def sampled_softmax_loss(tree: dict, batch: dict, cfg: MINDConfig):
    """The JAX package's loss, in its order of operations: interests,
    label-aware attention on the target, the target's and the
    ``n_negatives`` sampled items' logits cast to f32, then the mean of
    ``logsumexp - logits[:, 0]``.  batch: hist (B, L), hist_mask,
    profile_ids, profile_mask, target (B,), negatives (B, n_neg), as
    tensors on the tree's device."""
    caps = interests(tree, batch["hist"], batch["hist_mask"],
                     batch["profile_ids"], batch["profile_mask"], cfg)
    items = tree["item_table"]
    tgt_e = items[batch["target"].long()]                       # (B, d)
    user = label_aware_attention(caps, tgt_e, cfg.power)        # (B, d)
    neg_e = items[batch["negatives"].long()]                    # (B, n, d)
    pos = torch.einsum("bd,bd->b", user, tgt_e)[:, None]        # (B, 1)
    negs = torch.einsum("bd,bnd->bn", user, neg_e)              # (B, n)
    logits = torch.cat([pos, negs], dim=1).to(torch.float32)
    return torch.mean(torch.logsumexp(logits, dim=1) - logits[:, 0])


@torch.inference_mode()
def serve_interests(params: MIND, batch: dict, cfg: MINDConfig):
    """Online inference (serve_p99 / serve_bulk): user interests
    (B, K, d).  ``batch`` holds tensors on the model's device."""
    return interests(
        params, batch["hist"], batch["hist_mask"],
        batch["profile_ids"], batch["profile_mask"], cfg,
    )


@torch.inference_mode()
def retrieval_scores(params: MIND, batch: dict, cand_ids, cfg: MINDConfig):
    """Score candidates against each user's interests: one batched
    product and a max over interests -> (B, Nc)."""
    caps = serve_interests(params, batch, cfg)                  # (B, K, d)
    cand = params.item_table[cand_ids.long()]                   # (Nc, d)
    scores = torch.einsum("bkd,nd->bkn", caps, cand)
    return scores.amax(dim=1)
