"""The gradient of the port's attention against the JAX package's: the
plain backward (``attention_bwd_ref``, which the CPU route of
``FlashAttention`` runs and the backward kernel is held to on the card)
against ``jax.vjp`` of the reference's ``attention_ref``, at every head
dim the kernels take and groups of 1, 4 and 6 q heads a kv head, causal
and not; ``attention_lse_ref``'s row log-sum-exp against
``jax.nn.logsumexp`` of the reference's scores; the Function against
torch autograd of the plain forward, and ``gradcheck`` in f64.

Tolerances, as a share of each gradient's max |value|: 2e-5 in f32
(both sides sum in f32, in another order: the reference through
softmax's vjp, the port through lse and delta).  With bf16 inputs the
JAX package's own bf16 kernel-test tolerance, 2e-2: the port computes
in f32 and rounds each result once, the reference rounds in other places
too (its vjp rounds each q head's share of dk and dv to bf16 before the
group's sum, as it repeats k and v to the q heads in bf16); the worst
gaps over these cases are 0.0012 (out), 0.0052 (dq), 0.0067 (dk) and
0.0093 (dv).  The kernels themselves are held against the plain
backward in test_torch_cuda.py; here the f32 kernels' arithmetic, their
3xTF32 products emulated in numpy, is held against jax.vjp."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as ref_attention
from repro_torch import kernels as K
from repro_torch.kernels.flash_attention import (
    FlashAttention,
    attention_bwd_ref,
    attention_lse_ref,
    attention_ref,
    flash_attention_bwd_cuda,
    flash_attention_cuda,
    mha,
)

F32_TOL = 2e-5
BF16_TOL = 2e-2


def inputs(seed, B, Hq, Hkv, Sq, Sk, D):
    r = np.random.default_rng(seed)
    return tuple(r.normal(size=s).astype(np.float32) for s in
                 ((B, Hq, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D), (B, Hq, Sq, D)))


def assert_grad_close(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


@functools.partial(jax.jit, static_argnums=4)
def ref_vjp(q, k, v, do, causal):
    """The reference's output and its vjp at do, in one compiled call."""
    out, vjp = jax.vjp(lambda a, b, c: ref_attention(a, b, c, causal=causal), q, k, v)
    return out, vjp(do)


# (D, G, Sq, Sk): Sq <= Sk, so every case runs causal too
SHAPES = [(64, 1, 128, 128), (64, 4, 128, 256), (64, 6, 256, 256),
          (96, 1, 256, 256), (96, 4, 128, 128), (96, 6, 128, 256),
          (128, 1, 128, 256), (128, 4, 256, 256), (128, 6, 128, 128)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D,G,Sq,Sk", SHAPES)
def test_bwd_ref_matches_jax_vjp(D, G, Sq, Sk, causal, dtype):
    Hkv = 2 if G == 1 else 1
    q, k, v, do = inputs(D + G + Sq + Sk, 1, G * Hkv, Hkv, Sq, Sk, D)
    jq, jk, jv, jdo = (jnp.asarray(a, dtype) for a in (q, k, v, do))
    out, want = ref_vjp(jq, jk, jv, jdo, causal)
    tdt = getattr(torch, dtype)
    tq, tk, tv, tdo = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)
                       for a in (jq, jk, jv, jdo))
    tout, lse = attention_lse_ref(tq, tk, tv, causal=causal)
    assert_grad_close(tout, out, dtype)  # the forward, at the same tolerance
    got = attention_bwd_ref(tq, tk, tv, tout, lse, tdo, causal=causal)
    for g, w, t in zip(got, want, (tq, tk, tv)):
        assert g.dtype == tdt and g.shape == t.shape
        assert_grad_close(g, w, dtype)


@pytest.mark.parametrize("causal", [True, False])
def test_lse_matches_logsumexp_of_the_reference_scores(causal):
    B, Hq, Hkv, Sq, Sk, D = 2, 4, 2, 128, 256, 96
    q, k, _, _ = inputs(3, B, Hq, Hkv, Sq, Sk, D)
    kf = jnp.repeat(jnp.asarray(k), Hq // Hkv, axis=1)
    s = jnp.einsum("bhqd,bhkd->bhqk", jnp.asarray(q), kf) / (D ** 0.5)
    if causal:
        s = jnp.where(jnp.tril(jnp.ones((Sq, Sk), bool), k=Sk - Sq), s, -1e30)
    want = jax.nn.logsumexp(s, axis=-1)
    tq, tk = torch.from_numpy(q), torch.from_numpy(k)
    _, lse = attention_lse_ref(tq, tk, tk, causal=causal)
    assert lse.dtype == torch.float32 and lse.shape == (B, Hq, Sq)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (8, 2), (6, 1)])
def test_function_cpu_route_matches_autograd_of_the_plain_forward(Hq, Hkv, causal):
    q, k, v, do = (torch.from_numpy(a) for a in inputs(Hq + Hkv, 2, Hq, Hkv, 128, 256, 64))
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    K.reset_launch_counts()
    out = mha(*ins, causal=causal)
    got = torch.autograd.grad(out, ins, do)
    assert K.call_counts()["flash_attention_bwd"]["ref"] == 1
    assert not any(K.launch_counts().values())
    ins2 = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out2 = attention_ref(*ins2, causal=causal)
    assert torch.equal(out.detach(), out2.detach())
    want = torch.autograd.grad(out2, ins2, do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=F32_TOL * float(w.abs().max()))


@pytest.mark.parametrize("causal", [True, False])
def test_function_gradcheck_f64(causal):
    r = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(r.normal(size=s)).requires_grad_(True)
               for s in ((1, 4, 4, 8), (1, 2, 6, 8), (1, 2, 6, 8)))
    assert torch.autograd.gradcheck(lambda a, b, c: FlashAttention.apply(a, b, c, causal),
                                     (q, k, v))


def test_raw_wrappers_refuse_grad_requiring_inputs():
    """Outside FlashAttention the launches would drop the gradient: with
    grad mode on, an input that needs one is refused before anything
    else is checked; without it, a CPU tensor is refused as such."""
    q = torch.zeros((1, 2, 128, 64), requires_grad=True)
    k = torch.zeros((1, 2, 128, 64))
    lse = torch.zeros((1, 2, 128))
    with pytest.raises(RuntimeError, match="FlashAttention"):
        flash_attention_cuda(q, k, k, causal=True)
    with pytest.raises(RuntimeError, match="FlashAttention"):
        flash_attention_bwd_cuda(q, k, k, k, lse, k, causal=True)
    with torch.no_grad():
        with pytest.raises(ValueError, match="CUDA tensor"):
            flash_attention_cuda(q, k, k, causal=True)
    with pytest.raises(ValueError, match="float32"):
        flash_attention_bwd_cuda(k, k, k, k, lse.double(), k, causal=True)


def test_backward_traffic_at_the_train_shape():
    """The backward's bound at chip_smoke.py's case f (phi3-mini's train
    step: B 1, H 32, S 4096, D 96, bf16, causal): 10 D operations a
    visible pair, 257.8 GFLOP, 0.2606 ms at 989 TFLOP/s."""
    from repro_torch.roofline import BF16_OPS_PER_S, bound
    from repro_torch.roofline.kernels import flash_attention_bwd_traffic

    nbytes, flops = flash_attention_bwd_traffic(1, 32, 32, 4096, 4096, 96, True, 2)
    assert (nbytes, flops) == (201850880, 257760952320)
    ms, by = bound(nbytes, flops, BF16_OPS_PER_S)
    assert by == "operations" and round(ms, 4) == 0.2606


def test_backward_floor_at_the_fp32_twin_shape():
    """The f32 backward's bounds at chip_smoke.py's case i (the fp32
    twin's train step: B 1, H 32, S 2048, D 96, f32, causal): 64.5
    GFLOP; its kernels run on the tensor cores as 3xTF32, so the floor is
    3 x 64.5 GFLOP at 495 TFLOP/s, 0.3906 ms, against 0.9620 ms at the
    67 TFLOP/s of the CUDA cores."""
    from repro_torch.roofline import F32_OPS_PER_S, TF32X3_OPS_PER_S, bound
    from repro_torch.roofline.kernels import flash_attention_bwd_traffic

    nbytes, flops = flash_attention_bwd_traffic(1, 32, 32, 2048, 2048, 96, True, 4)
    assert (nbytes, flops) == (201588736, 64455966720)
    assert TF32X3_OPS_PER_S == 495e12 / 3
    ms, by = bound(nbytes, flops, TF32X3_OPS_PER_S)
    assert by == "operations" and round(ms, 4) == 0.3906
    assert round(3 * flops / 495e12 * 1e3, 4) == round(ms, 4)
    ms, by = bound(nbytes, flops, F32_OPS_PER_S)
    assert by == "operations" and round(ms, 4) == 0.9620


def tf32_rna(x):
    """x (f32) rounded to TF32 as ``cvt.rna.tf32.f32`` rounds: to
    nearest, ties away from zero, 10 of the 23 mantissa bits kept (the
    low 13 bits of the result 0)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def mm_tf32x3(a, b):
    """a @ b as the f32 kernels take it: each operand split once, hi =
    tf32(x) and lo = tf32(x - hi), and three TF32 products with f32 sums,
    the two small terms first."""
    ahi, bhi = tf32_rna(a), tf32_rna(b)
    alo, blo = tf32_rna(a - ahi), tf32_rna(b - bhi)
    return alo @ bhi + ahi @ blo + ahi @ bhi


def mm_tf32(a, b):
    """a @ b as one TF32 product with f32 sums."""
    return tf32_rna(a) @ tf32_rna(b)


def emulated_bwd(mm, q, k, v, out, lse, do):
    """The causal backward's products as ``csrc/flash_attention_bwd.cu``'s
    f32 passes take them, each through ``mm``, in numpy f32: S and dP,
    then dV and dK summed over each kv head's G q heads, and dQ."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    kf, vf = np.repeat(k, G, axis=1), np.repeat(v, G, axis=1)
    scale = np.float32(1 / np.sqrt(D))
    s = mm(q, kf.swapaxes(-1, -2))
    p = np.where(np.tril(np.ones((S, S), bool)), np.exp(s * scale - lse[..., None]),
                 np.float32(0)).astype(np.float32)
    dp = mm(do, vf.swapaxes(-1, -2))
    ds = p * (dp - (do * out).sum(-1, dtype=np.float32)[..., None])
    dq = mm(ds, kf) * scale
    dk = mm(ds.swapaxes(-1, -2), q).reshape(B, Hkv, G, S, D).sum(2) * scale
    dv = mm(p.swapaxes(-1, -2), do).reshape(B, Hkv, G, S, D).sum(2)
    return dq, dk, dv


@pytest.mark.parametrize("G,Hkv,S", [(1, 2, 512), (4, 1, 512), (4, 2, 256)])
def test_tf32x3_products_hold_the_kernel_tolerance(G, Hkv, S):
    """The arithmetic of the f32 kernels before the card: the 3xTF32
    products (each operand rounded by the cvt.rna rule) give dQ, dK and
    dV within 1e-4 of max |grad| of jax.vjp of the reference attention,
    the bound the kernels are held to on the card (D 96, causal); one
    TF32 product a product misses it, which is why the kernels take
    three."""
    q, k, v, do = inputs(G + Hkv + S, 1, G * Hkv, Hkv, S, S, 96)
    _, want = ref_vjp(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(do), True)
    out, lse = attention_lse_ref(*(torch.from_numpy(a) for a in (q, k, v)), causal=True)
    args = (q, k, v, out.numpy(), lse.numpy(), do)
    gaps = {}
    for name, mm in (("3x", mm_tf32x3), ("1x", mm_tf32)):
        got = emulated_bwd(mm, *args)
        gaps[name] = [float(np.abs(g - np.asarray(w)).max() / np.abs(np.asarray(w)).max())
                      for g, w in zip(got, want)]
    assert max(gaps["3x"]) < 1e-4, gaps
    assert min(gaps["1x"]) > 1e-4, gaps


def test_smoke_names_every_backward_kernel():
    """``chip_smoke.ATTN_BWD_KERNELS``, which phase 7 hands to
    ``kernel_alone_ms``, names every ``__global__`` of the backward's
    source, the one each call launches once (delta, for both dtypes)
    first: a kernel left out would drop from the "alone" time."""
    import pathlib
    import re
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    import chip_smoke

    src = (root / "src" / "repro_torch" / "csrc" / "flash_attention_bwd.cu").read_text()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(", src)
    assert len(names) == len(set(names)) >= 4
    assert sorted(names) == sorted(chip_smoke.ATTN_BWD_KERNELS)
    assert chip_smoke.ATTN_BWD_KERNELS[0] == "attention_delta_kernel"
    # the one mma.sync in the PTX is the f32 kernels' TF32 product (bf16
    # runs wgmma)
    assert re.findall(r'"(mma\.sync[\w.]*)', src) == [
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32"]

