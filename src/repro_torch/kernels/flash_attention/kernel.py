"""CUDA launch of streaming-softmax attention, which replaces the TPU
kernel ``repro/kernels/flash_attention/kernel.py::flash_attention``.
One entry point (``flash_attention_launch`` in ``csrc/flash_attention.cu``)
takes both dtypes.  bf16 goes to ``csrc/flash_attention_sm90.cu``: both
products on the tensor cores (``wgmma``, 989 TFLOP/s bf16 on an H100
SXM at its 700 W limit, data sheet), K/V tiles through a TMA ring, p
split into two bf16 terms so the result stays within one bf16 ulp of
the f32 reference.  f32 stays on the CUDA cores as fp32 FMAs (67
TFLOP/s), as the TPU kernel keeps q, k, v and p in fp32 and the f32
path is held to 2e-5.

The f32 kernel takes a 128-row q tile a block and 64-key tiles.  Where
those blocks leave the card's SMs short, :func:`split_plan` cuts the
key tiles a (head, q tile) visits into chunks, a block each, and a
second kernel folds their partials; ``ref.py`` has the same split in
plain torch.

Given ``lse``, either forward also writes each row's natural-log
log-sum-exp, which :func:`flash_attention_bwd_cuda` reads: the gradient
(``csrc/flash_attention_bwd.cu``: bf16 on Hopper's tensor cores,
``wgmma`` fed by TMA rings, a dK/dV pass and a dQ pass, P and dS as two
bf16 terms each; f32 as 3xTF32 ``mma.sync`` products fed by cp.async
rings, the same two passes), which the JAX package leaves
to XLA.  Neither launch is seen by
autograd, so both refuse, with grad mode on, an input that needs a
gradient: ``ops.FlashAttention`` is the way to train through them."""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _lib

NAME = "flash_attention"
NAME_BWD = "flash_attention_bwd"
HEAD_DIMS = (64, 96, 128)
SEQ_MULTIPLE = 128  # the TPU kernel's block size; the CUDA tiles divide it
BLOCK_Q, BLOCK_K = 128, 64  # the f32 kernel's q rows a block and keys a tile


@functools.cache
def _launch():
    return _lib.entry(
        "flash_attention_launch",
        [_lib.ptr] * 5 + [_lib.c_int] * 8 + [_lib.c_float, _lib.c_int]
        + [_lib.ptr] * 2,
    )


@functools.cache
def _launch_bwd():
    return _lib.entry(
        "flash_attention_bwd_launch",
        [_lib.ptr] * 10 + [_lib.c_int] * 8 + [_lib.c_float, _lib.ptr],
    )


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def key_tiles(q_tile: int, Sq: int, Sk: int, causal: bool) -> int:
    """Key tiles the f32 kernel visits for q tile ``q_tile``: all of
    them, or, causal, up to the one that holds the last key its last row
    sees (tiles wholly above the diagonal are never visited)."""
    n = Sk // BLOCK_K
    if causal:
        n = min(n, (q_tile * BLOCK_Q + BLOCK_Q - 1 + Sk - Sq) // BLOCK_K + 1)
    return n


def chunk_bounds(n_tiles: int, n_split: int, chunk: int) -> tuple[int, int]:
    """Key tiles [lo, hi) of chunk ``chunk`` of ``n_split``: contiguous,
    in order, every tile in exactly one chunk."""
    return chunk * n_tiles // n_split, (chunk + 1) * n_tiles // n_split


def split_plan(B: int, Hq: int, Sq: int, Sk: int, causal: bool, sms: int) -> int:
    """Key chunks a (head, q tile) of the f32 kernel: 1 where its
    B*Hq*Sq/128 blocks fill the card's ``sms`` SMs (one block an SM),
    else enough to fill them, at most the key tiles the lightest q tile
    visits, so that no chunk is empty."""
    grid = B * Hq * (-(-Sq // BLOCK_Q))
    if grid == 0 or grid >= sms:
        return 1
    fewest = key_tiles(0, Sq, Sk, causal)
    return max(1, min(fewest, -(-sms // grid)))


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


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise where grad mode is on and an input needs a gradient: the
    launch is not recorded by autograd, so its output would drop it."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{kernel}: an input needs a gradient, and the kernel's launch "
                           f"is not recorded by autograd; train through "
                           f"kernels.flash_attention.ops.FlashAttention")


def _check_rows(kernel: str, name: str, t, shape) -> None:
    """``t`` is f32 of ``shape`` (a row statistic: lse)."""
    _lib.require(t.dtype == torch.float32 and tuple(t.shape) == shape, kernel,
                 f"{name} must be float32 {shape}, got {t.dtype} {tuple(t.shape)}")


def flash_attention_cuda(q, k, v, *, causal: bool = True, lse=None) -> torch.Tensor:
    """Launch the kernel; returns (B, Hq, Sq, D) in q's dtype, and fills
    ``lse`` (f32 (B, Hq, Sq)) with each row's log-sum-exp if given."""
    refuse_grad(NAME, q, k, v)
    check_attention_args(q, k, v, causal)
    _lib.check_cuda_tensors(NAME, q=q, k=k, v=v)
    _lib.require(all(t.data_ptr() % 16 == 0 for t in (q, k, v)), NAME,
                 "q, k and v must start on 16 bytes (the kernels copy 16-byte chunks)")
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if lse is not None:
        _check_rows(NAME, "lse", lse, (B, Hq, Sq))
        _lib.check_cuda_tensors(NAME, lse=lse)
    out = torch.empty_like(q)
    if out.numel():
        bf16 = q.dtype == torch.bfloat16
        n_split = 1 if bf16 else split_plan(B, Hq, Sq, Sk, causal,
                                            _sms(q.device.index))
        part = None
        if n_split > 1:  # each chunk's m, l and acc
            part = torch.empty(n_split * B * Hq * Sq * (D + 2), dtype=torch.float32,
                               device=q.device)
        rc = _launch()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            B, Hq, Hkv, Sq, Sk, D, int(bf16), int(causal), 1.0 / D ** 0.5,
            n_split, None if part is None else part.data_ptr(), _lib.stream_of(q),
        )
        _lib.check(rc, NAME)
        _lib.count_launch(NAME)
    return out


def flash_attention_bwd_cuda(q, k, v, out, lse, dout, *, causal: bool = True):
    """Launch the backward: (dq, dk, dv) of the attention whose output
    ``out`` and row log-sum-exp ``lse`` the forward gave for q, k, v,
    from the output's gradient ``dout``, each in its input's dtype."""
    refuse_grad(NAME_BWD, q, k, v, out, dout)
    check_attention_args(q, k, v, causal)
    _lib.require(out.shape == q.shape and dout.shape == q.shape
                 and out.dtype == q.dtype and dout.dtype == q.dtype, NAME_BWD,
                 f"out and dout must be q's {tuple(q.shape)} {q.dtype}, got "
                 f"{tuple(out.shape)} {out.dtype} and {tuple(dout.shape)} {dout.dtype}")
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    _check_rows(NAME_BWD, "lse", lse, (B, Hq, Sq))
    _lib.check_cuda_tensors(NAME_BWD, q=q, k=k, v=v, out=out, lse=lse, dout=dout)
    _lib.require(all(t.data_ptr() % 16 == 0 for t in (q, k, v, out, dout, lse)), NAME_BWD,
                 "q, k, v, out, dout and lse must start on 16 bytes (the kernels copy "
                 "16-byte chunks)")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel():
        delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
        rc = _launch_bwd()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
            B, Hq, Hkv, Sq, Sk, D, int(q.dtype == torch.bfloat16), int(causal),
            1.0 / D ** 0.5, _lib.stream_of(q),
        )
        _lib.check(rc, NAME_BWD)
        _lib.count_launch(NAME_BWD)
    return dq, dk, dv
