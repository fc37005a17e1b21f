"""Float arithmetic that must round as the JAX package's compiled
programs do, shared by the engine's quantized exchange
(``core/frontier.py``) and the training package's int8 sums
(``train/compression.py``)."""

from __future__ import annotations

import torch


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a·b + c`` of float32 tensors rounded once to float32 (a fused
    multiply-add), the same on every device: the product is exact in
    float64, TwoSum gives the float64 sum ``s`` and its error ``e``
    exactly, and the one rounding of ``s`` to float32 that can differ
    from the exact sum's, a tie at the midpoint of two float32 values,
    is broken by the sign of ``e``."""
    p = a.double() * b.double()
    c = c.double()
    s = c + p
    bb = s - c
    e = (c - (s - bb)) + (p - bb)
    r = s.float()
    d = s - r.double()
    inf = torch.full((), float("inf"), dtype=torch.float32, device=r.device)
    other = torch.nextafter(r, torch.where(d > 0, inf, -inf))
    tie = (d != 0) & (s == (r.double() + other.double()) * 0.5) & (e != 0)
    return torch.where(tie & ((e > 0) == (d > 0)), other, r)
