"""AdamW from scratch over trees of tensors (dicts and lists), with f32
master weights for low-precision params and global-norm clipping.

The state mirrors the JAX package's layout, ``{"m", "v", "step",
"master"}``, and every update takes its operations in the same order,
so in f32 the two agree to the last ulp or near it.  The reference's
``state_specs`` (PartitionSpecs that shard the state as the params
are) has no counterpart until the port shards models (ROADMAP.md
Queue 1 item 5.6).
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils._pytree import tree_flatten, tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4                  # peak LR (schedule scales it)
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    master_fp32: bool = True


def init_state(params, cfg: AdamWConfig) -> dict:
    """Zero moments in f32, step 0 (int32) and, with ``master_fp32``, an
    f32 copy of the params, on the params' devices."""
    def zeros32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    state = {
        "m": tree_map(zeros32, params),
        "v": tree_map(zeros32, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }
    if cfg.master_fp32:
        state["master"] = tree_map(lambda p: p.to(torch.float32, copy=True), params)
    return state


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to global norm <= max_norm, the norm before)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype), grads), norm


def apply_updates(params, grads, state, cfg: AdamWConfig, lr_scale):
    """One AdamW step.  Returns (params, state, metrics)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = state["step"] + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - cfg.b1 ** t
    bc2 = 1.0 - cfg.b2 ** t
    lr = cfg.lr * lr_scale

    masters = state.get("master", params)

    def upd(p_master, g, m, v):
        g32 = g.to(torch.float32)
        m = cfg.b1 * m + (1 - cfg.b1) * g32
        v = cfg.b2 * v + (1 - cfg.b2) * g32 * g32
        mhat = m / bc1
        vhat = v / bc2
        p32 = p_master.to(torch.float32)
        p32 = p32 - lr * (mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p32)
        return p32, m, v

    flat_p, spec = tree_flatten(masters)
    flat_g, flat_m, flat_v = (_leaves_like(tree, spec) for tree in
                              (grads, state["m"], state["v"]))
    out = [upd(*args) for args in zip(flat_p, flat_g, flat_m, flat_v)]
    new_master = tree_unflatten([o[0] for o in out], spec)
    new_m = tree_unflatten([o[1] for o in out], spec)
    new_v = tree_unflatten([o[2] for o in out], spec)

    new_params = tree_map(lambda p32, p: p32.to(p.dtype), new_master, params)
    new_state = {"m": new_m, "v": new_v, "step": step}
    if cfg.master_fp32:
        new_state["master"] = new_master
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}


def _leaves_like(tree, spec) -> list:
    leaves, got = tree_flatten(tree)
    if got != spec:
        raise ValueError(f"tree structure {got} differs from the params' {spec}")
    return leaves
