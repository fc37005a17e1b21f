"""Public op: multi-head (GQA) attention, and ``FlashAttention``, its
autograd Function.  A CUDA tensor launches the kernels; a CPU tensor
takes the plain torch versions.

``mha`` sends a call that needs a gradient through ``FlashAttention``:
its forward keeps the output and each row's log-sum-exp, and its
backward is the backward kernel (``attention_bwd_ref`` on the CPU), so
no score matrix is kept between the two.  A call without a gradient
takes the forward kernel alone, as serving does."""

from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_bwd_cuda,
    flash_attention_cuda,
)
from repro_torch.kernels.flash_attention.ref import (
    attention_bwd_ref,
    attention_lse_ref,
    attention_ref,
)


class FlashAttention(torch.autograd.Function):
    """``FlashAttention.apply(q, k, v, causal)``: :func:`mha`'s output,
    differentiable in q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        if q.device.type == "cpu":
            out, lse = attention_lse_ref(q, k, v, causal=causal)
        else:
            B, Hq, Sq, _ = q.shape
            lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
            out = flash_attention_cuda(q, k, v, causal=causal, lse=lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        if q.device.type == "cpu":
            _lib.count_call("flash_attention_bwd", "ref")
            grads = attention_bwd_ref(q, k, v, out, lse, dout, causal=ctx.causal)
        else:
            _lib.count_call("flash_attention_bwd", "cuda")
            grads = flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal=ctx.causal)
        return *grads, None


def mha(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D) -> (B, Hq, Sq, D)."""
    cpu = q.device.type == "cpu"
    _lib.count_call("flash_attention", "ref" if cpu else "cuda")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal)
    if cpu:
        return attention_ref(q, k, v, causal=causal)
    return flash_attention_cuda(q, k, v, causal=causal)
