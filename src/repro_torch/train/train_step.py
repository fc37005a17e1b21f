"""Generic train step: microbatch gradient accumulation, optional
int8+error-feedback accumulator compression, global-norm clip, AdamW,
LR schedule.

``build_train_step(loss_fn, cfg)`` returns a function
    (params, opt_state, batch, step) -> (params, opt_state, metrics)
over trees of tensors, as the JAX package's does; gradients come from
``torch.autograd.grad``.  Nothing is updated in place unless the step
is built with ``donate=True``, the counterpart of the JAX package's
``donate_argnums=(0, 1)`` on its train cells: then the params and the
optimizer state are overwritten (``optimizer.apply_updates(inplace=
True)``), which a model whose state fills the card needs.
``loss_fn(params, batch)`` must return a scalar loss (the model
closures carry their configs).

Across ranks (``topo`` of more than one rank, and ``specs`` the params'
layout, ``models/lm.py::param_specs``) the params and the state are this
rank's blocks and every rank is given the whole batch; ``loss_fn`` takes
the rank's share of each microbatch (the JAX package's microbatch m, then
this dp rank's rows of it, so a MoE layer's capacity counts the
reference's tokens) and returns the global loss.  A leaf split over dp
gets its whole gradient from autograd (the FSDP gather's backward is a
reduce-scatter); a leaf whose block is whole over dp gets only its rows'
share, so each microbatch's is summed over dp (one all_reduce a dtype).
The int8 accumulator's scale is then the whole leaf's, and the clip
reads the global norm over every rank's blocks.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from repro_torch.models.common import sharded, spec_axes
from repro_torch.train import compression
from repro_torch.train.optimizer import AdamWConfig, apply_updates, init_state, leaf_specs
from repro_torch.train.schedule import warmup_cosine


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    adamw: AdamWConfig = AdamWConfig()
    microbatches: int = 1          # grad-accumulation chunks per step
    compress_accum: bool = False   # int8+EF gradient accumulator
    warmup_steps: int = 100
    total_steps: int = 10_000


def _split_batch(batch, n: int) -> list:
    """Each leaf (B, ...) cut into n chunks (B/n, ...): the JAX
    package's reshape to (n, B/n, ...), as the list its scan walks.
    Defined for batches whose rows are independent (a flat graph
    batch's edges index nodes outside their chunk)."""
    def r(x):
        if x.shape[0] % n:
            raise ValueError(f"leading axis {tuple(x.shape)} does not split into {n}")
        return x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))

    leaves, spec = tree_flatten(tree_map(r, batch))
    return [tree_unflatten([x[i] for x in leaves], spec) for i in range(n)]


def value_and_grad(loss_fn: Callable) -> Callable:
    """``(params, batch) -> (loss, grads)``: the loss detached, the
    gradient of every param leaf (zeros where the loss does not reach
    it, as ``jax.grad`` gives)."""
    def grad_fn(params, batch):
        leaves, spec = tree_flatten(params)
        leaves = [p.detach().requires_grad_(True) for p in leaves]
        with torch.enable_grad():
            loss = loss_fn(tree_unflatten(leaves, spec), batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        return loss.detach(), tree_unflatten(grads, spec)

    return grad_fn


def _dp_summed(grad_fn: Callable, specs, topo) -> Callable:
    """``grad_fn`` with the gradients of the leaves whose blocks are whole
    over dp summed over dp (one all_reduce a dtype)."""
    dp_axes = set(topo.dp_axes)

    def summed(params, batch):
        loss, grads = grad_fn(params, batch)
        if topo.dp_size == 1:
            return loss, grads
        flat, tree = tree_flatten(grads)
        picked = [i for i, sp in enumerate(leaf_specs(params, specs))
                  if not spec_axes(sp) & dp_axes]
        for dtype in dict.fromkeys(flat[i].dtype for i in picked):  # one order on every rank
            idx = [i for i in picked if flat[i].dtype == dtype]
            total = topo.all_reduce(torch.cat([flat[i].reshape(-1) for i in idx]), "dp")
            for i, part in zip(idx, total.split([flat[i].numel() for i in idx])):
                flat[i] = part.view_as(flat[i])
        return loss, tree_unflatten(flat, tree)

    return summed


def build_train_step(loss_fn: Callable, cfg: TrainConfig, *,
                     donate: bool = False, topo=None, specs=None) -> Callable:
    """The train step; across ranks (``topo`` of more than one rank) with
    the params' ``specs`` (the module docstring)."""
    topo = sharded(topo)
    if topo is not None and specs is None:
        raise ValueError("a train step across ranks needs the params' specs")
    grad_fn = value_and_grad(loss_fn)
    if topo is not None:
        grad_fn = _dp_summed(grad_fn, specs, topo)

    def gradients(params, batch):
        """(the step's loss, the gradients its update reads)."""
        if cfg.microbatches <= 1:
            return grad_fn(params, batch)

        def zeros(dtype):
            return tree_map(lambda p: torch.zeros(p.shape, dtype=dtype, device=p.device),
                            params)

        if cfg.compress_accum:
            gacc = {"q": zeros(torch.int8),
                    "scale": tree_map(lambda p: torch.zeros((), device=p.device), params)}
            err = compression.init_error_tree(params)
        else:
            gacc = zeros(torch.float32)
        ltot = torch.zeros((), dtype=torch.float32)
        for mb in _split_batch(batch, cfg.microbatches):
            loss, grads = grad_fn(params, mb)
            if cfg.compress_accum:
                # int8 error-feedback accumulation
                summed = tree_map(lambda a, g: a + g.to(torch.float32),
                                  compression.dequantize_tree(gacc), grads)
                gacc, err = compression.ef_compress_tree(summed, err, topo)
            else:
                gacc = tree_map(lambda a, g: a + g.to(torch.float32), gacc, grads)
            ltot = ltot.to(loss.device) + loss
        grads = compression.dequantize_tree(gacc) if cfg.compress_accum else gacc
        return ltot / cfg.microbatches, tree_map(lambda g: g / cfg.microbatches, grads)

    def update(params, opt_state, grads, loss, step):
        """The clipped AdamW update from :func:`gradients`' output."""
        lr_scale = warmup_cosine(step, warmup_steps=cfg.warmup_steps,
                                 total_steps=cfg.total_steps).to(loss.device)
        params, opt_state, om = apply_updates(params, grads, opt_state, cfg.adamw, lr_scale,
                                              inplace=donate, topo=topo, specs=specs)
        return params, opt_state, {"loss": loss, **om}

    def train_step(params, opt_state, batch, step):
        loss, grads = gradients(params, batch)
        return update(params, opt_state, grads, loss, step)

    # its two halves, for a caller that reads the gradients before the
    # update (a check that the weights after an update cannot give)
    train_step.gradients, train_step.update = gradients, update
    return train_step


def init_train_state(params, cfg: TrainConfig) -> dict:
    return init_state(params, cfg.adamw)
