"""CUDA launch of streaming-softmax attention, which replaces the TPU
kernel ``repro/kernels/flash_attention/kernel.py::flash_attention``.
One entry point (``flash_attention_launch`` in ``csrc/flash_attention.cu``)
takes both dtypes.  bf16 goes to ``csrc/flash_attention_sm90.cu``: both
products on the tensor cores (``wgmma``, 989 TFLOP/s bf16 on an H100
SXM at its 700 W limit, data sheet), K/V tiles through a TMA ring, p
split into two bf16 terms so the result stays within one bf16 ulp of
the f32 reference.  f32 stays on the CUDA cores as fp32 FMAs (67
TFLOP/s), as the TPU kernel keeps q, k, v and p in fp32 and the f32
path is held to 2e-5."""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _lib

NAME = "flash_attention"
HEAD_DIMS = (64, 96, 128)
SEQ_MULTIPLE = 128  # the TPU kernel's block size; the CUDA tiles divide it


@functools.cache
def _launch():
    return _lib.entry(
        "flash_attention_launch",
        [_lib.ptr] * 4 + [_lib.c_int] * 8 + [_lib.c_float, _lib.ptr],
    )


def check_attention_args(q, k, v, causal: bool) -> None:
    """The kernel's contract (the TPU kernel's, plus its head dims):
    q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D) of one dtype, f32 or bf16,
    D in {64, 96, 128}, Sq and Sk multiples of 128, Hq % Hkv == 0, and
    no causal Sq > Sk."""
    _lib.require(q.dim() == 4 and k.dim() == 4 and v.dim() == 4, NAME,
                 f"q, k, v must be 4-D, got {tuple(q.shape)}, "
                 f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, Sq, D = q.shape
    Bk, Hkv, Sk, Dk = k.shape
    _lib.require(k.shape == v.shape and Bk == B and Dk == D, NAME,
                 f"k and v must be (B={B}, Hkv, Sk, D={D}), got "
                 f"{tuple(k.shape)} and {tuple(v.shape)}")
    _lib.require(q.dtype in (torch.float32, torch.bfloat16)
                 and k.dtype == q.dtype and v.dtype == q.dtype, NAME,
                 f"q, k, v must share one dtype, float32 or bfloat16, got "
                 f"{q.dtype}, {k.dtype}, {v.dtype}")
    _lib.require(D in HEAD_DIMS, NAME, f"head dim {D} is not one of {HEAD_DIMS}")
    _lib.require(Hkv > 0 and Hq % Hkv == 0, NAME,
                 f"Hq={Hq} must be a multiple of Hkv={Hkv}")
    _lib.require(Sq % SEQ_MULTIPLE == 0 and Sk % SEQ_MULTIPLE == 0, NAME,
                 f"Sq={Sq} and Sk={Sk} must be multiples of {SEQ_MULTIPLE}")
    _lib.require(not (causal and Sq > Sk), NAME,
                 f"causal attention needs Sq <= Sk, got Sq={Sq} Sk={Sk}")
    _lib.require(B * Hq * Sq * D < 2**31 and B * Hkv * Sk * D < 2**31, NAME,
                 "sizes exceed int32")


def flash_attention_cuda(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """Launch the kernel; returns (B, Hq, Sq, D) in q's dtype."""
    check_attention_args(q, k, v, causal)
    _lib.check_cuda_tensors(NAME, q=q, k=k, v=v)
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel():
        rc = _launch()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Hq, Hkv, Sq, Sk, D, int(q.dtype == torch.bfloat16),
            int(causal), 1.0 / D ** 0.5, _lib.stream_of(q),
        )
        _lib.check(rc, NAME)
        _lib.count_launch(NAME)
    return out
