"""GNN building blocks.  Only the MLP is ported so far (MIND's interest
MLP uses it); the message-passing layers come with ``spmm_ell``."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import fan_in_init


def init_mlp(gen: torch.Generator, dims, dtype=torch.float32) -> dict:
    """Weights ``w{i}`` (dims[i], dims[i+1]), fan-in scaled, and zero
    biases ``b{i}``, on ``gen``'s device."""
    p = {f"w{i}": fan_in_init(gen, (dims[i], dims[i + 1]), dims[i], dtype)
         for i in range(len(dims) - 1)}
    p |= {f"b{i}": torch.zeros((dims[i + 1],), dtype=dtype, device=gen.device)
          for i in range(len(dims) - 1)}
    return p


def mlp_apply(p, x, act=F.silu, final_act: bool = False):
    n = len([k for k in p if k.startswith("w")])
    for i in range(n):
        x = x @ p[f"w{i}"] + p[f"b{i}"]
        if i < n - 1 or final_act:
            x = act(x)
    return x
