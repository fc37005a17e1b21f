"""AdamW from scratch over trees of tensors (dicts and lists), with f32
master weights for low-precision params and global-norm clipping.

The state mirrors the JAX package's layout, ``{"m", "v", "step",
"master"}``, and every update takes its operations in the same order,
so in f32 the two agree to the last ulp or near it.

``apply_updates(inplace=True)`` writes the new params, moments and
master weights into the tensors it is given, ``CHUNK`` elements at a
time, as the JAX package's train cells donate their params and state:
a full-width LM's state (f32 master, m and v) is 45.8 GB for phi3-mini,
and a functional update would hold the old and the new at once.  The
functional update (the default) runs the same body on copies.  The
global norm's f32 sum runs over the chunks of a leaf larger than
``CHUNK``, so there it may differ from :func:`global_norm` in the last
ulps.

Across ranks (a ``topo`` of more than one rank and the params' specs,
``models/lm.py::param_specs``) every rank holds its blocks of the params
and of the state, laid out by :func:`state_specs` (the JAX package's:
the moments and the master copy as the params, the step whole).  The
global norm is the sum of squares over each rank's blocks, summed over
every rank, a block that several ranks hold (a norm's scale, the
router, ``final_norm``) counted once; the clipped update then runs on
each rank's blocks.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils._pytree import tree_flatten, tree_leaves, tree_map

from repro_torch.models.common import sharded, spec_axes

#: elements of a chunk of the in-place update: 256 MB of f32
CHUNK = 1 << 26


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


def state_specs(param_specs, cfg: AdamWConfig) -> dict:
    """The optimizer state's specs given the params' (the JAX package's
    ``state_specs``): ``m``, ``v`` and ``master`` as the params, the step
    whole."""
    specs = {"m": param_specs, "v": param_specs, "step": ()}
    if cfg.master_fp32:
        specs["master"] = param_specs
    return specs


def leaf_specs(tree, specs) -> list:
    """``specs`` (a tree of ``tree``'s keys, a spec tuple a leaf) as a
    list in the order of ``tree_flatten(tree)``'s leaves."""
    if isinstance(tree, dict):
        return [sp for k, v in tree.items() for sp in leaf_specs(v, specs[k])]
    if isinstance(tree, (list, tuple)):
        return [sp for v, s in zip(tree, specs) for sp in leaf_specs(v, s)]
    return [specs]


def _owns(spec, topo) -> bool:
    """Whether this rank counts its block of a leaf laid out by ``spec``
    in a sum over every rank: the block's first holder, at coordinate 0
    on every axis the spec does not split over."""
    split = spec_axes(spec)
    return all(c == 0 for a, c in topo.coords.items() if a not in split)


def _sum_squares(leaves, specs=None, topo=None) -> torch.Tensor:
    """The f32 sum of squares of ``leaves`` (``CHUNK`` elements at a
    time); across ranks, of this rank's owned blocks, summed over every
    rank."""
    topo = sharded(topo)
    dev = leaves[0].device if leaves else None
    if topo is not None:
        leaves = [g for g, sp in zip(leaves, specs) if _owns(sp, topo)]
    total = sum(sum(torch.sum(torch.square(c.to(torch.float32)))
                    for c in _chunks(g, written=False)) for g in leaves)
    if topo is None:
        return total
    if not isinstance(total, torch.Tensor):  # no block of this rank counts
        total = torch.zeros((), dtype=torch.float32, device=dev)
    return topo.all_reduce(total, "world")


def global_norm(tree, topo=None, specs=None) -> torch.Tensor:
    """The tree's global norm; across ranks ``tree`` is this rank's
    blocks and ``specs`` their layout."""
    if sharded(topo) is None:
        return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                              for g in tree_leaves(tree)))
    return torch.sqrt(_sum_squares(tree_leaves(tree), leaf_specs(tree, specs), topo))


def clip_by_global_norm(grads, max_norm: float, topo=None, specs=None):
    """(grads scaled to global norm <= max_norm, the norm before)."""
    norm = global_norm(grads, topo, specs)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype), grads), norm


def apply_updates(params, grads, state, cfg: AdamWConfig, lr_scale, *,
                  inplace: bool = False, topo=None, specs=None):
    """One AdamW step.  Returns (params, state, metrics); with
    ``inplace`` the params and the state's tensors are overwritten, and
    the trees returned are the ones given, else the update writes into
    copies of them.  Across ranks (``topo``, the params' ``specs``) each
    tree is this rank's blocks and the clip reads the global norm."""
    if not inplace:
        params, state = tree_map(
            lambda t: t.clone(memory_format=torch.contiguous_format), (params, state))
    flat_p, spec = tree_flatten(params)
    flat_g, flat_m, flat_v = (_leaves_like(tree, spec) for tree in
                              (grads, state["m"], state["v"]))
    flat_w = _leaves_like(state["master"], spec) if cfg.master_fp32 else flat_p
    gnorm = torch.sqrt(_sum_squares(flat_g, None if sharded(topo) is None
                                    else leaf_specs(params, specs), topo))
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state["step"] + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - cfg.b1 ** t
    bc2 = 1.0 - cfg.b2 ** t
    lr = cfg.lr * lr_scale
    for p, w, g, m, v in zip(flat_p, flat_w, flat_g, flat_m, flat_v):
        master = w is not p
        for pc, wc, gc, mc, vc in zip(_chunks(p), _chunks(w), _chunks(g, written=False),
                                      _chunks(m), _chunks(v)):
            # clipped, and rounded to the grad's dtype, as clip_by_global_norm
            g32 = (gc.to(torch.float32) * scale).to(gc.dtype).to(torch.float32)
            mc.mul_(cfg.b1).add_((1 - cfg.b1) * g32)
            vc.mul_(cfg.b2).add_((1 - cfg.b2) * g32 * g32)
            p32 = wc.to(torch.float32)
            p32 = p32 - lr * (mc / bc1 / (torch.sqrt(vc / bc2) + cfg.eps)
                              + cfg.weight_decay * p32)
            wc.copy_(p32)
            if master:
                pc.copy_(p32)
    new_state = {"m": state["m"], "v": state["v"], "step": step}
    if cfg.master_fp32:
        new_state["master"] = state["master"]
    return params, new_state, {"grad_norm": gnorm, "lr": lr}


def _leaves_like(tree, spec) -> list:
    leaves, got = tree_flatten(tree)
    if got != spec:
        raise ValueError(f"tree structure {got} differs from the params' {spec}")
    return leaves


def _chunks(t: torch.Tensor, written: bool = True) -> tuple:
    """CHUNK elements of t at a time: views of a tensor written in place
    (``view`` raises unless it is contiguous); of a copy where a tensor
    that is only read (a gradient) is laid out otherwise."""
    return (t.view(-1) if written else t.reshape(-1)).split(CHUNK)
