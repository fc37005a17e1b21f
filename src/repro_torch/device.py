"""Device choice for the port's entry points: ``None`` means the card.
Without CUDA, only an explicit ``device="cpu"`` runs (the plain torch
path); nothing falls back to the CPU on its own."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be a CUDA device or 'cpu', got {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "torch path on the CPU"
        )
    return dev
