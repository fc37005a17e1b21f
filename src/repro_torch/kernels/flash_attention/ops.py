"""Public op: multi-head (GQA) attention.  A CUDA tensor launches the
kernel; a CPU tensor takes the plain torch version."""

from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_ref


def mha(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D) -> (B, Hq, Sq, D)."""
    if q.device.type == "cpu":
        _lib.count_call("flash_attention", "ref")
        return attention_ref(q, k, v, causal=causal)
    _lib.count_call("flash_attention", "cuda")
    return flash_attention_cuda(q, k, v, causal=causal)
