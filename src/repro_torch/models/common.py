"""Shared model building blocks: norms, RoPE, activations, init.

The JAX package's ``Topology``/``constrain`` (TP/DP sharding) are not
ported: the port runs a model on one card.  Initialisers draw from an
explicit ``torch.Generator``, whose device is where the tensor is made
(so a full-size model is initialised on the card, never on the host).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device


def generator(seed: int, device=None) -> torch.Generator:
    """A seeded generator on ``device`` (``None`` means the card)."""
    return torch.Generator(device=resolve_device(device)).manual_seed(seed)


# ----------------------------------------------------------------- #
# numerics


def rms_norm(x, scale, eps: float = 1e-5):
    """Computed in f32, cast back to x's dtype."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.float()).to(dtype)


def rope_angles(positions, dim: int, theta: float = 10000.0):
    """(..., dim/2) cos/sin tables for rotary embedding."""
    freqs = torch.exp(
        -math.log(theta)
        * torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device)
        / dim
    )
    ang = positions.float()[..., None] * freqs  # (..., dim/2)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (..., S, H, D); cos/sin: (S, D/2) or broadcastable.  Rotates
    the two halves (non-interleaved); a bf16 x times the f32 tables
    computes in f32 and casts back to x's dtype."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    while cos.dim() < x1.dim():  # broadcast over the head axis
        cos, sin = cos[..., None, :], sin[..., None, :]
    return torch.cat(
        [x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1
    ).to(x.dtype)


def swiglu(gate, up):
    return F.silu(gate) * up


def relu2(x):
    r = F.relu(x)
    return r * r


# ----------------------------------------------------------------- #
# initialization


def normal_init(gen: torch.Generator, shape, scale: float,
                dtype=torch.float32) -> torch.Tensor:
    """``scale`` times a standard normal draw in f32, cast to dtype."""
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return x.mul_(scale).to(dtype)


def fan_in_init(gen: torch.Generator, shape, fan_in: Optional[int] = None,
                dtype=torch.float32) -> torch.Tensor:
    fan = fan_in if fan_in is not None else shape[-2] if len(shape) > 1 else shape[-1]
    return normal_init(gen, shape, 1.0 / math.sqrt(fan), dtype)


def param_count(module: torch.nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
