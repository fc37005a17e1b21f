"""LR schedules (warmup + cosine decay), as pure functions of step."""

from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(step, *, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1) -> torch.Tensor:
    """Returns a multiplier in (0, 1] for the peak LR; ``step`` is an
    int or an integer tensor, the result an f32 tensor of its shape."""
    step = _f32(step)
    warm = torch.clamp((step + 1.0) / max(1, warmup_steps), max=1.0)
    prog = torch.clamp((step - warmup_steps) / max(1, total_steps - warmup_steps),
                       0.0, 1.0)
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos


def constant(step) -> torch.Tensor:
    return torch.ones_like(_f32(step))
