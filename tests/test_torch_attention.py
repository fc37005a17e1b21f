"""The port's attention op against the JAX package's: on the CPU the
port's ``mha`` runs its plain version, which must agree with the
reference's jnp oracle and with its Pallas kernel in interpret mode
over the cases of the reference's own kernel sweep.  Tolerances are the
reference's: 2e-5 in f32, 2e-2 in bf16 (both sides round the output to
bf16; the sums run in another order).  The CUDA kernel is held against
the same plain version on the card in test_torch_cuda.py; here its bf16
arithmetic (p split into two bf16 terms) is emulated and held against
the reference."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import mha as ref_mha
from repro_torch.kernels import flash_attention_cuda, mha
from repro_torch.kernels.flash_attention.kernel import check_attention_args

CASES = [
    (1, 2, 1, 128, 128, 64, "float32"),
    (2, 4, 2, 256, 256, 64, "float32"),
    (1, 8, 2, 128, 256, 128, "float32"),   # cross (kv longer)
    (2, 4, 4, 128, 128, 64, "bfloat16"),   # MHA bf16
    (1, 4, 4, 128, 128, 96, "bfloat16"),   # phi3-mini head dim
]


def inputs(seed, B, Hq, Hkv, Sq, Sk, D):
    r = np.random.default_rng(seed)
    return (r.normal(size=(B, Hq, Sq, D)).astype(np.float32),
            r.normal(size=(B, Hkv, Sk, D)).astype(np.float32),
            r.normal(size=(B, Hkv, Sk, D)).astype(np.float32))


@pytest.mark.parametrize("impl", ["ref", "pallas_interpret"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,dtype", CASES)
def test_mha_plain_matches_reference(impl, causal, B, Hq, Hkv, Sq, Sk, D, dtype):
    q, k, v = inputs(Sq + Sk + D, B, Hq, Hkv, Sq, Sk, D)
    tdt = getattr(torch, dtype)
    port = mha(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)), causal=causal)
    assert port.dtype == tdt and port.shape == (B, Hq, Sq, D)
    ref = ref_mha(*(jnp.asarray(a, dtype) for a in (q, k, v)), causal=causal, impl=impl)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


def t(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("args,causal,match", [
    ((t(1, 2, 128, 80), t(1, 1, 128, 80), t(1, 1, 128, 80)), True, "head dim"),
    ((t(1, 2, 100, 64), t(1, 1, 128, 64), t(1, 1, 128, 64)), False, "multiples of 128"),
    ((t(1, 2, 128, 64), t(1, 1, 192, 64), t(1, 1, 192, 64)), False, "multiples of 128"),
    ((t(1, 2, 256, 64), t(1, 1, 128, 64), t(1, 1, 128, 64)), True, "Sq <= Sk"),
    ((t(1, 3, 128, 64), t(1, 2, 128, 64), t(1, 2, 128, 64)), True, "multiple of Hkv"),
    ((t(1, 2, 128, 64), t(1, 1, 128, 64, dtype=torch.bfloat16),
      t(1, 1, 128, 64)), True, "one dtype"),
    ((t(1, 2, 128, 64, dtype=torch.float16), t(1, 1, 128, 64, dtype=torch.float16),
      t(1, 1, 128, 64, dtype=torch.float16)), True, "one dtype"),
    ((t(2, 128, 64), t(1, 128, 64), t(1, 128, 64)), True, "4-D"),
    ((t(1, 2, 128, 64), t(1, 1, 128, 64), t(1, 1, 256, 64)), True, "k and v"),
])
def test_kernel_contract_raises(args, causal, match):
    with pytest.raises(ValueError, match=match):
        check_attention_args(*args, causal)
    with pytest.raises(ValueError, match=match):
        flash_attention_cuda(*args, causal=causal)


def test_kernel_wrapper_refuses_cpu_tensors():
    """A well-formed call on CPU tensors: the wrapper launches or
    raises, it never computes the plain version itself."""
    q, k, v = t(1, 2, 128, 64), t(1, 1, 128, 64), t(1, 1, 128, 64)
    check_attention_args(q, k, v, True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention_cuda(q, k, v, causal=True)


# ---- the bf16 kernel's rounding ------------------------------------------
# csrc/flash_attention_sm90.cu computes S = q k^T in f32 from bf16 q, k on
# the tensor cores, runs the online softmax in f32 over 128-key tiles (base
# 2, scale * log2 e folded in), and feeds p to the second product as two
# bf16 terms, p_hi = bf16(p) and p_lo = bf16(p - p_hi), with an f32
# accumulator and one bf16 rounding of the output.  The emulation below
# repeats that arithmetic in torch on the CPU.

ONE_ULP = dict(rtol=1e-2, atol=2e-3)  # one bf16 ulp (<= 2**-7 of the value)
KEY_TILE = 128


def kernel_bf16_emulation(q, k, v, *, causal: bool, split_p: bool = True):
    """bf16 q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D) -> bf16 (B, Hq, Sq, D)
    computed as the bf16 kernel does; ``split_p=False`` rounds p to bf16
    alone (one term)."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(Hq // Hkv, 1)
    vf = v.float().repeat_interleave(Hq // Hkv, 1)
    scale_log2 = torch.tensor((1.0 / D ** 0.5) * 1.4426950408889634, dtype=torch.float32)
    m = torch.full((B, Hq, Sq, 1), -1e30)
    l = torch.zeros((B, Hq, Sq, 1))
    acc = torch.zeros((B, Hq, Sq, D))
    last_key = torch.arange(Sq)[:, None] + (Sk - Sq)
    for k0 in range(0, Sk, KEY_TILE):
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf[:, :, k0:k0 + KEY_TILE]) * scale_log2
        if causal:
            keys = torch.arange(k0, k0 + KEY_TILE)[None, :]
            s = torch.where(keys > last_key, torch.tensor(-1e30), s)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        p_hi = p.to(torch.bfloat16).float()
        pv = p_hi @ vf[:, :, k0:k0 + KEY_TILE]
        if split_p:
            pv = pv + (p - p_hi).to(torch.bfloat16).float() @ vf[:, :, k0:k0 + KEY_TILE]
        acc = acc * alpha + pv
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(torch.bfloat16)


def seeded_bf16(seed, Hq, Hkv, S, D):
    """numpy draws q, k, v in that order from default_rng(seed*1000 + S + D)."""
    r = np.random.default_rng(seed * 1000 + S + D)
    return tuple(r.normal(size=(1, h, S, D)).astype(np.float32) for h in (Hq, Hkv, Hkv))


def reference_bf16(q, k, v):
    return torch.from_numpy(np.asarray(
        ref_mha(*(jnp.asarray(a, "bfloat16") for a in (q, k, v)), causal=True, impl="ref"),
        np.float32))


@pytest.mark.parametrize("S,D,Hq,Hkv,seed", [
    (128, 64, 2, 1, 0), (256, 96, 4, 2, 1), (384, 128, 4, 1, 1),
    (512, 64, 4, 1, 1), (512, 96, 2, 2, 0), (512, 128, 4, 1, 2),
])
def test_bf16_kernel_rounding_matches_reference(S, D, Hq, Hkv, seed):
    """The split-p arithmetic stays within the bf16 tolerance (2e-2) and
    within one bf16 ulp of the JAX reference on causal cases."""
    q, k, v = seeded_bf16(seed, Hq, Hkv, S, D)
    out = kernel_bf16_emulation(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
                                causal=True)
    ref = reference_bf16(q, k, v)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    torch.testing.assert_close(out.float(), ref, rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(out.float(), ref, **ONE_ULP)


def test_bf16_p_alone_misses_one_ulp():
    """Rounding p to bf16 alone, as a single-term P V would, leaves the
    one-ulp bound on a long causal row (seed 1 at S 384, D 128, G 4:
    1.04x the bound); the split keeps it.  So the p_lo term cannot be
    dropped unnoticed."""
    q, k, v = seeded_bf16(1, 4, 1, 384, 128)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    ref = reference_bf16(q, k, v)
    single = kernel_bf16_emulation(tq, tk, tv, causal=True, split_p=False)
    assert not torch.allclose(single.float(), ref, **ONE_ULP)
    split = kernel_bf16_emulation(tq, tk, tv, causal=True)
    assert torch.allclose(split.float(), ref, **ONE_ULP)
