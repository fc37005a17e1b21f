"""The port's CUDA kernels, its solve, its serving paths and GIN
inference and training on the card, held against the plain torch versions on the
same inputs: the min-plus kernels, the embedding bag and the spmm_ell
max bit-identical, attention within the reference's tolerances (2e-5
f32, 2e-2 bf16), the spmm_ell sum within 1e-5 of max |ref|.  Needs an NVIDIA GPU and
nvcc; skips elsewhere.  Imports no JAX, so it runs on a machine with
the card alone:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves

from repro_torch import kernels as K
from repro_torch.api import Problem, SingleSource, Solver, SolverConfig
from repro_torch.configs import get_arch
from repro_torch.core.selfstab import synchronous_sweep
from repro_torch.data import gnn_flat_batch, lm_batch, mind_batch
from repro_torch.graph import rmat1, small_world_graph
from repro_torch.models import lm, mind, moe
from repro_torch.models.gnn import gin
from repro_torch.models.common import generator

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    K.build()
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    return torch.device("cuda")


def on(dev, *arrays):
    return [torch.as_tensor(np.ascontiguousarray(a), device=dev) for a in arrays]


def frontier_case(seed, n_local, n_out, R, W, F, count=None, kind=""):
    """A frontier of F listed rows, ``count`` of them live (random if
    None; may exceed F).  kind "hub": every column on 4 destinations;
    "negative": negative distances (the uint branch of the atomic min);
    "real_tail": the rows listed past count are real rows, not fill."""
    r = np.random.default_rng(seed)
    dist = np.full(n_local + 1, np.inf, np.float32)
    hot = r.choice(n_local, max(1, n_local // 3), replace=False)
    lo, hi = (-100, 0) if kind == "negative" else (0, 50)
    dist[hot] = r.integers(lo, hi, hot.shape[0]).astype(np.float32)
    row_src = r.integers(0, n_local, R).astype(np.int32)
    if kind == "hub":
        col = r.choice(r.choice(n_out, 4, replace=False), (R, W)).astype(np.int32)
    else:
        col = r.integers(0, n_out + 1, (R, W)).astype(np.int32)
    pad = r.random((R, W)) < 0.3
    if kind == "hub":
        col[pad] = n_out
    wgt = np.where(pad, np.inf, r.integers(1, 100, (R, W))).astype(np.float32)
    k = int(r.integers(0, F + 1)) if count is None else count
    row_idx = (r.integers(0, R, F) if kind == "real_tail" else np.full(F, R)).astype(np.int32)
    row_idx[:min(k, F)] = r.integers(0, R, min(k, F))  # repeated rows allowed
    return dist, row_idx, k, row_src, col, wgt


# (seed, n_local, n_out, R, W, F, count, kind): W 3 and 5 take the scalar
# path, 33 a lane group of 32 with a second chunk, 64 and 128 16-byte
# strips; count 0, F and past F; a frontier larger than one sweep of the
# persistent grid (F 40,000)
CASES = [(0, 32, 48, 24, 4, 8, None, ""), (1, 128, 256, 96, 8, 32, None, ""),
         (2, 256, 512, 300, 16, 64, None, ""), (3, 1000, 1000, 1200, 64, 150, None, ""),
         (4, 5000, 5000, 6000, 128, 700, None, ""), (5, 64, 128, 40, 4, 64, None, ""),
         (6, 300, 400, 200, 3, 50, None, ""), (7, 300, 400, 200, 5, 50, None, "negative"),
         (8, 500, 600, 400, 33, 90, None, "real_tail"), (9, 1000, 1000, 1200, 64, 150, 0, ""),
         (10, 1000, 1000, 1200, 64, 150, 150, ""),
         (11, 1000, 1000, 1200, 64, 150, 400, "real_tail"),
         (12, 2000, 2000, 1500, 128, 300, None, "hub"), (13, 2000, 2000, 1500, 64, 300, 300, "hub"),
         (14, 1000, 1000, 800, 64, 200, None, "negative"), (15, 300, 400, 200, 5, 50, 50, "hub"),
         (16, 1000, 1000, 1200, 64, 150, 100, "real_tail"),
         (17, 50000, 50000, 60000, 64, 40000, 40000, ""),
         (18, 50000, 50000, 60000, 33, 40000, 39000, "real_tail")]


def check_frontier_kernels(dev, case, layout=lambda x: x):
    """Both frontier kernels against their plain versions on ``case``,
    col and wgt placed by ``layout``; returns their outputs."""
    n_out = case[2]
    dist, row_idx, k, row_src, col, wgt = frontier_case(*case)
    d, i, rs, c, w = on(dev, dist, row_idx, row_src, col, wgt)
    c, w = layout(c), layout(w)
    cnt = torch.tensor(k, dtype=torch.int32, device=dev)
    K.reset_launch_counts()
    fused = K.fused_superstep_cuda(d, i, cnt, rs, c, w, n_out)
    push = K.relax_push_gather_cuda(d, i, cnt, rs, c, w)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    assert counts["fused_superstep"] == 1 and counts["relax_push_gather"] == 1
    assert torch.equal(fused, K.fused_superstep_ref(d, i, cnt, rs, c, w, n_out))
    assert torch.equal(push, K.relax_push_gather_ref(d, i, cnt, rs, w))
    cpu = K.fused_superstep_ref(*on("cpu", dist, row_idx), k,
                                *on("cpu", row_src, col, wgt), n_out)
    assert torch.equal(fused.cpu(), cpu)
    return fused, push


@pytest.mark.parametrize("case", CASES)
def test_frontier_kernels_match_plain(dev, case):
    check_frontier_kernels(dev, case)


def unaligned(x):
    """A contiguous copy of x whose base is 4 bytes off 16."""
    buf = torch.empty(x.numel() + 4, dtype=x.dtype, device=x.device)
    off = next(j for j in range(1, 4) if (buf.data_ptr() + 4 * j) % 16 == 4)
    view = buf[off:off + x.numel()].view(x.shape)
    view.copy_(x)
    return view


@pytest.mark.parametrize("case", [CASES[3], CASES[4], CASES[8], CASES[13]])
def test_frontier_kernels_on_unaligned_strips(dev, case):
    """col and wgt views 4 bytes off 16-byte alignment take the scalar
    path and give the same bits as the aligned tensors."""
    probe = unaligned(torch.zeros((2, case[4]), device=dev))
    assert probe.data_ptr() % 16 == 4 and not K._lib.vector_strips(case[4], probe)
    fused, push = check_frontier_kernels(dev, case, unaligned)
    fused_a, push_a = check_frontier_kernels(dev, case)
    assert torch.equal(fused, fused_a) and torch.equal(push, push_a)


@pytest.mark.parametrize("n_pad,R,W", [
    (256, 128, 8), (512, 300, 16), (1024, 65, 32), (128, 1, 4),
    (4096, 5000, 64), (300, 777, 128), (50, 10, 33),
])
def test_relax_ell_matches_plain(dev, n_pad, R, W):
    r = np.random.default_rng(n_pad + R + W)
    dist = np.concatenate([r.exponential(10, n_pad), [np.inf]]).astype(np.float32)
    col = r.integers(0, n_pad + 1, (R, W)).astype(np.int32)
    wgt = np.where(col == n_pad, np.inf, r.uniform(1, 100, (R, W))).astype(np.float32)
    d, c, w = on(dev, dist, col, wgt)
    out = K.relax_ell_cuda(d, c, w)
    torch.cuda.synchronize()
    assert torch.equal(out, K.relax_ell_ref(d, c, w))
    assert torch.equal(out.cpu(), K.relax_ell_ref(*on("cpu", dist, col, wgt)))


def test_wrappers_reject_bad_inputs(dev):
    dist, row_idx, k, row_src, col, wgt = frontier_case(*CASES[1])
    d, i, rs, c, w = on(dev, dist, row_idx, row_src, col, wgt)
    with pytest.raises(ValueError, match="int32"):
        K.fused_superstep_cuda(d, i.long(), k, rs, c, w, 256)
    with pytest.raises(ValueError, match="contiguous"):
        K.relax_ell_cuda(d, c.t(), w.t())
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.relax_push_gather_cuda(d.cpu(), i, k, rs, c, w)


@pytest.mark.parametrize("spec,impl", [
    ("delta:5/sparse/fused", "fused"), ("delta:5/sparse", "push"),
    ("kla:2+threadq/sparse", "ref"), ("chaotic+nodeq/pmin", "ref"),
    ("delta:3+numaq/auto", "fused"), ("dijkstra/a2a", "ref"),
])
@pytest.mark.parametrize("n_parts", [1, 2])
def test_solve_on_card_matches_cpu(dev, spec, impl, n_parts):
    g = rmat1(10, seed=1)
    cfg = SolverConfig.from_spec(spec, relax_impl=impl)
    K.reset_launch_counts()
    card = Solver(cfg, n_parts=n_parts).solve(Problem(g, SingleSource(0)))
    launched = K.launch_counts()
    cpu = Solver(cfg, n_parts=n_parts, device="cpu").solve(
        Problem(g, SingleSource(0)))
    assert card.state.tobytes() == cpu.state.tobytes()
    assert card.metrics.as_dict() == cpu.metrics.as_dict()
    if impl == "fused" and "kla" not in spec:
        assert launched["fused_superstep"] > 0
    if impl == "push":
        assert launched["relax_push_gather"] > 0


def test_sweep_on_card_matches_cpu(dev):
    g = small_world_graph(3000, seed=2)
    d0 = np.random.default_rng(0).integers(0, 60, g.n).astype(np.float32)
    K.reset_launch_counts()
    card = synchronous_sweep(g, 0, d0, 2000)
    assert K.launch_counts()["relax_ell"] > 0
    cpu = synchronous_sweep(g, 0, d0, 2000, device="cpu")
    assert card.tobytes() == cpu.tobytes()


ATTN_CASES = [
    # B, Hq, Hkv, Sq, Sk, D, dtype
    (1, 2, 1, 128, 128, 64, torch.float32),
    (2, 4, 2, 256, 256, 64, torch.float32),
    (1, 8, 2, 128, 256, 128, torch.float32),
    (2, 4, 4, 128, 128, 64, torch.bfloat16),
    (1, 4, 4, 256, 256, 96, torch.bfloat16),
    (1, 4, 1, 128, 384, 96, torch.float32),
    (2, 8, 2, 384, 384, 128, torch.bfloat16),
    (1, 2, 2, 128, 1024, 128, torch.float32),
    # bf16 goes to the wgmma kernel: minitron's GQA at S 2048, phi3-mini's
    # D 96 (zero-padded 64-column chunks) with Hq = Hkv, D 64 (one chunk),
    # causal Sq < Sk (the q_offset on a diagonal tile), and 512 blocks of
    # 8 key tiles each, so the 2-stage K/V ring wraps again and again
    (1, 8, 2, 2048, 2048, 128, torch.bfloat16),
    (1, 4, 4, 2048, 2048, 96, torch.bfloat16),
    (1, 8, 2, 1024, 1024, 64, torch.bfloat16),
    (1, 8, 2, 128, 1024, 128, torch.bfloat16),
    (2, 32, 8, 1024, 1024, 128, torch.bfloat16),
    # dbrx's GQA: 6 q heads a kv head, at its prefill's S 1920
    (2, 48, 8, 1920, 1920, 128, torch.bfloat16),
]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", ATTN_CASES)
def test_flash_attention_matches_plain(dev, case, causal):
    B, Hq, Hkv, Sq, Sk, D, dtype = case
    r = np.random.default_rng(Sq + Sk + D)
    q, k, v = (torch.as_tensor(r.normal(size=shape).astype(np.float32), device=dev).to(dtype)
               for shape in ((B, Hq, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D)))
    K.reset_launch_counts()
    out = K.mha(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert K.launch_counts()["flash_attention"] == 1
    ref = K.attention_ref(q, k, v, causal=causal)
    assert out.dtype == dtype and out.shape == ref.shape
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        # both compute in f32 and round once to bf16, so they differ by at
        # most one bf16 ulp (<= 2**-7 of the value)
        torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2, atol=2e-3)


# The f32 kernel at Sq 128 over Sk 1024 to 4096 (2 to 16 blocks: its key
# split engages) and at the fp32 twin's prefill shapes of chip_smoke.py
# phase 8 (1,920 and 2,048 tokens, 960 and 1,024 blocks: no split); the
# split as planned, forced off, and forced to 3 chunks (or as many as the
# lightest q tile's key tiles)
F32_SPLIT_CASES = [
    (1, 8, 2, 128, 1024, 128), (1, 4, 1, 128, 2048, 96), (1, 2, 2, 128, 4096, 64),
    (1, 8, 2, 128, 4096, 128), (2, 32, 8, 1920, 1920, 128), (2, 32, 8, 2048, 2048, 128),
]


@pytest.mark.parametrize("n_split", ["plan", 1, 3])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", F32_SPLIT_CASES)
def test_flash_attention_f32_split_matches_plain(dev, case, causal, n_split, monkeypatch):
    from repro_torch.kernels.flash_attention import kernel as attn

    B, Hq, Hkv, Sq, Sk, D = case
    if n_split != "plan":
        monkeypatch.setattr(attn, "split_plan", lambda B, Hq, Sq, Sk, causal, sms: min(
            n_split, attn.key_tiles(0, Sq, Sk, causal)))
    r = np.random.default_rng(Sq + Sk + D + Hq)
    q, k, v = (torch.as_tensor(r.normal(size=shape).astype(np.float32), device=dev)
               for shape in ((B, Hq, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D)))
    K.reset_launch_counts()
    out = K.mha(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert K.launch_counts()["flash_attention"] == 1
    ref = K.attention_ref(q, k, v, causal=causal)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)


def test_flash_attention_rejects_unaligned_inputs(dev):
    q = torch.zeros(1 + 1 * 2 * 128 * 64, device=dev)[1:].view(1, 2, 128, 64)
    k = torch.zeros((1, 1, 128, 64), device=dev)
    with pytest.raises(ValueError, match="16 bytes"):
        K.flash_attention_cuda(q, k, k, causal=True)


def test_flash_attention_lse_keeps_the_output_bits(dev):
    """A forward asked for lse gives the bits of one that is not, and
    lse within f32 (bf16: its scores' wgmma sums) of the plain one's."""
    for B, Hq, Hkv, Sq, Sk, D, dtype in ATTN_CASES[:8]:
        r = np.random.default_rng(Sq + D)
        q, k, v = (torch.as_tensor(r.normal(size=shape).astype(np.float32),
                                   device=dev).to(dtype)
                   for shape in ((B, Hq, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D)))
        for causal in (True, False):
            lse = torch.empty((B, Hq, Sq), device=dev)
            out = K.flash_attention_cuda(q, k, v, causal=causal, lse=lse)
            assert torch.equal(out, K.flash_attention_cuda(q, k, v, causal=causal))
            _, ref = K.attention_lse_ref(q, k, v, causal=causal)
            tol = 2e-4 if dtype == torch.bfloat16 else 2e-5
            torch.testing.assert_close(lse, ref, rtol=0, atol=tol)


# the backward at every head dim and group the forward takes, odd and
# even counts of 128-row tiles (both dtypes' blocks) and of 32- and
# 64-row steps, Sq < Sk, and phi3-mini's and dbrx's heads
BWD_CASES = [
    # B, Hq, Hkv, Sq, Sk, D, dtype
    (1, 2, 2, 128, 128, 64, torch.float32),
    (1, 4, 1, 128, 384, 96, torch.float32),
    (2, 4, 2, 256, 256, 128, torch.float32),
    (1, 8, 2, 128, 1024, 128, torch.float32),
    (2, 4, 4, 384, 384, 64, torch.bfloat16),
    (1, 4, 4, 640, 640, 96, torch.bfloat16),
    (2, 12, 2, 256, 640, 128, torch.bfloat16),
    (1, 8, 2, 1024, 1024, 128, torch.bfloat16),
    # D 96 with Sq < Sk (its causal diagonal 384 keys in), G 4 at D 64
    (1, 4, 2, 256, 640, 96, torch.bfloat16),
    (1, 8, 2, 256, 256, 64, torch.bfloat16),
    # the f32 kernels' edges: D 96 at the fp32 twin's S 2048 with 4
    # heads (16 key tiles of 128, 64 q steps of 32), G 4 at D 64, D 96
    # with Sq < Sk
    (1, 4, 4, 2048, 2048, 96, torch.float32),
    (1, 8, 2, 256, 256, 64, torch.float32),
    (1, 4, 2, 256, 640, 96, torch.float32),
]


def attention_grads_case(dev, case, seed):
    B, Hq, Hkv, Sq, Sk, D, dtype = case
    r = np.random.default_rng(seed)
    q, k, v, dout = (torch.as_tensor(r.normal(size=shape).astype(np.float32),
                                     device=dev).to(dtype)
                     for shape in ((B, Hq, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D),
                                   (B, Hq, Sq, D)))
    return q, k, v, dout


def assert_grads_close(got, want, dtype):
    """Each gradient within f32 sums of up to Sk terms in another order
    (1e-4 of its max |value|); bf16 also within one bf16 ulp (both
    compute in f32 and round once)."""
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        scale = float(w.float().abs().max())
        rtol = 2 ** -7 if dtype == torch.bfloat16 else 0.0
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol, atol=1e-4 * scale)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", BWD_CASES)
def test_flash_attention_bwd_matches_plain(dev, case, causal):
    q, k, v, dout = attention_grads_case(dev, case, sum(case[:6]))
    B, Hq, Sq = q.shape[:3]
    lse = torch.empty((B, Hq, Sq), device=dev)
    out = K.flash_attention_cuda(q, k, v, causal=causal, lse=lse)
    K.reset_launch_counts()
    got = K.flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal=causal)
    torch.cuda.synchronize()
    assert K.launch_counts()["flash_attention_bwd"] == 1
    want = K.attention_bwd_ref(q, k, v, out, lse, dout, causal=causal)
    assert_grads_close(got, want, q.dtype)


# The f32 backward's worst gradient against the plain backward in f64,
# as a share of its max |value|, at the attention shape of
# test_lm_train_step_on_card_matches_cpu[gqa] (B 2, Hq 4, Hkv 2, S 128,
# D 64, causal), on these inputs.  With S = Q K^T on the tensor cores
# (3xTF32) it was 1.99e-6 (dq; dk 1.84e-6, dv 9.4e-7), and that test's
# AdamW step flipped a weight of wv; with S in f32 FMAs, 1.59e-6 (dq;
# dk 9.3e-7, dv 4.3e-7), the same bits each run (scripts/attn_probe.py
# --precision, on an H100)
F32_BWD_WORST_LEAF = 1.7e-6


def test_flash_attention_bwd_f32_worst_leaf(dev):
    q, k, v, dout = attention_grads_case(dev, (2, 4, 2, 128, 128, 64, torch.float32), 5)
    lse = torch.empty(q.shape[:3], device=dev)
    out = K.flash_attention_cuda(q, k, v, causal=True, lse=lse)
    got = K.flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal=True)
    q64, k64, v64, do64 = (t.double().cpu() for t in (q, k, v, dout))
    o64, lse64 = K.attention_lse_ref(q64, k64, v64, causal=True)
    want = K.attention_bwd_ref(q64, k64, v64, o64, lse64, do64, causal=True)
    gaps = [float((g.double().cpu() - w).abs().max() / w.abs().max())
            for g, w in zip(got, want)]
    assert max(gaps) <= F32_BWD_WORST_LEAF, f"dq, dk, dv: {gaps}"


@pytest.mark.parametrize("case", [BWD_CASES[7], BWD_CASES[8], BWD_CASES[5],
                                  BWD_CASES[10], BWD_CASES[11], BWD_CASES[12]])
def test_flash_attention_bwd_is_deterministic(dev, case):
    """Both dtypes' kernels take every sum in one block in a fixed
    order, never by atomics in arrival order: two launches on the same
    inputs give the same bits (bf16: a G 4 causal case, D 96 with Sq <
    Sk, D 96 at G 1; f32: D 96 at S 2048, G 4 at D 64, D 96 with Sq <
    Sk)."""
    q, k, v, dout = attention_grads_case(dev, case, 11)
    B, Hq, Sq = q.shape[:3]
    lse = torch.empty((B, Hq, Sq), device=dev)
    out = K.flash_attention_cuda(q, k, v, causal=True, lse=lse)
    first = K.flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal=True)
    second = K.flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal=True)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.parametrize("case", [BWD_CASES[1], BWD_CASES[6]])
def test_flash_attention_function_on_card_matches_cpu(dev, case):
    """FlashAttention on the card (forward and backward kernels) against
    its CPU route on the same inputs."""
    q, k, v, dout = attention_grads_case(dev, case, 7)
    grads = []
    for where in (dev, torch.device("cpu")):
        ins = [t.to(where).requires_grad_(True) for t in (q, k, v)]
        K.reset_launch_counts()
        out = K.mha(*ins, causal=True)
        grads.append(torch.autograd.grad(out, ins, dout.to(where)))
        if where == dev:
            assert K.launch_counts()["flash_attention"] == 1
            assert K.launch_counts()["flash_attention_bwd"] == 1
    assert_grads_close([g.cpu() for g in grads[0]], grads[1], q.dtype)


def test_flash_attention_wrappers_refuse_grad(dev):
    q = torch.zeros((1, 2, 128, 64), device=dev, requires_grad=True)
    k = torch.zeros((1, 2, 128, 64), device=dev)
    lse = torch.zeros((1, 2, 128), device=dev)
    with pytest.raises(RuntimeError, match="FlashAttention"):
        K.flash_attention_cuda(q, k, k, causal=True)
    with pytest.raises(RuntimeError, match="FlashAttention"):
        K.flash_attention_bwd_cuda(q, k, k, k[:, :2], lse, k, causal=True)
    with torch.no_grad():
        K.flash_attention_cuda(q, k, k, causal=True)


def bag_in_order(table, idx, w):
    """The TPU kernel's order: out += row * w for l = 0 .. L-1, each
    product and sum rounded (separate torch ops, so no FMA)."""
    out = torch.zeros((idx.shape[0], table.shape[1]), device=table.device)
    for l in range(idx.shape[1]):
        out = out + table[idx[:, l].long()] * w[:, l, None]
    return out


@pytest.mark.parametrize("weights", ["mask", "random"])
@pytest.mark.parametrize("V,d,B,L", [
    (100, 32, 8, 5), (1000, 64, 16, 10), (50, 128, 4, 20),
    (64, 30, 3, 7), (4096, 64, 1000, 13), (7, 4, 1, 1), (300, 64, 33, 0),
    (500, 64, 40, 37), (300, 64, 50, 19), (200, 30, 9, 11), (100, 200, 5, 13),
])
def test_embedding_bag_matches_plain(dev, V, d, B, L, weights):
    """w is the 0/1 mask, or f32 weights in (-2, 2) with the masked
    slots 0.  L = 37, 19, 13 and 11 end in a ragged chunk of the kernel's
    4 row loads (kChunk; L = 37 also past one batch of 32 slots); d = 30 takes
    the scalar path, d = 200 two column passes of 32 float4 lanes."""
    r = np.random.default_rng(V + d + B + L)
    table = torch.as_tensor(r.normal(size=(V, d)).astype(np.float32), device=dev)
    idx = torch.as_tensor(r.integers(0, V, (B, L)).astype(np.int32), device=dev)
    mask = torch.as_tensor(r.random((B, L)) > 0.3, device=dev)
    w = mask.float()
    if weights == "random":
        w *= torch.as_tensor(r.uniform(-2, 2, (B, L)).astype(np.float32), device=dev)
    K.reset_launch_counts()
    out = K.bag_sum(table, idx, w)
    torch.cuda.synchronize()
    assert K.launch_counts()["embedding_bag"] == 1
    assert torch.equal(out, bag_in_order(table, idx, w))
    if weights == "mask":
        torch.testing.assert_close(out, K.embedding_bag_ref(table, idx, w), rtol=1e-6, atol=1e-6)
    else:  # an f32 sum of L products is within (L+1) * 2**-24 * sum |w row| of exact
        exact = K.embedding_bag_ref(table.double(), idx, w.double())
        slack = (L + 1) * 2**-24 * K.embedding_bag_ref(table.abs().double(), idx,
                                                       w.abs().double())
        assert bool(((out.double() - exact).abs() <= slack).all())
    mean = K.bag_pool(table, idx, mask, mode="mean", impl="pallas")
    torch.testing.assert_close(mean, K.bag_pool(table, idx, mask, mode="mean"),
                               rtol=1e-6, atol=1e-6)
    if L:
        with pytest.raises(ValueError, match="lie in"):
            K.embedding_bag_cuda(table, torch.full_like(idx, V), w)


@pytest.mark.parametrize("d", [4, 8, 16, 1, 2, 3, 7, 13])
def test_embedding_bag_every_group_width(dev, d):
    """Every group width of lanes a bag, 1 to 16 (32 is in the grid
    above), on both paths: float4 columns (d = 4, 8, 16) and scalar ones
    (d % 4 != 0); L = 19 ends in a ragged chunk.  Bit for bit the
    in-order sum."""
    r = np.random.default_rng(d)
    table = torch.as_tensor(r.normal(size=(300, d)).astype(np.float32), device=dev)
    idx = torch.as_tensor(r.integers(0, 300, (45, 19)).astype(np.int32), device=dev)
    w = torch.as_tensor(r.uniform(-2, 2, (45, 19)).astype(np.float32), device=dev)
    out = K.embedding_bag_cuda(table, idx, w)
    torch.cuda.synchronize()
    assert torch.equal(out, bag_in_order(table, idx, w))


@pytest.mark.parametrize("mlp_type,kv", [("relu2", 2), ("swiglu", 4)])
def test_lm_serving_on_card_matches_cpu(dev, mlp_type, kv):
    """Prefill through the kernel (one launch per layer) and greedy
    decode on the card against the plain path on the CPU, in f32."""
    cfg = lm.LMConfig(name="t", n_layers=2, d_model=256, n_heads=4, n_kv_heads=kv,
                      d_ff=512, vocab=512, mlp_type=mlp_type,
                      param_dtype="float32", attn_impl="pallas")
    cpu_model = lm.init_params(generator(0, "cpu"), cfg)
    card_model = lm.init_params(generator(0, "cpu"), cfg).to(dev)
    toks = torch.as_tensor(lm_batch(0, 2, 128, cfg.vocab)["tokens"])
    K.reset_launch_counts()
    cache, logits = lm.prefill_step(card_model, toks.to(dev), cfg, 136)
    torch.cuda.synchronize()
    assert K.launch_counts()["flash_attention"] == cfg.n_layers
    c_cache, c_logits = lm.prefill_step(cpu_model, toks, cfg, 136)
    torch.testing.assert_close(logits.cpu(), c_logits, rtol=1e-4, atol=1e-5)
    for step in range(4):
        nxt = c_logits.argmax(-1).to(torch.int32)
        assert torch.equal(logits.argmax(-1).cpu().to(torch.int32), nxt)
        logits, cache = lm.decode_step(card_model, cache, nxt.to(dev), 128 + step, cfg)
        c_logits, c_cache = lm.decode_step(cpu_model, c_cache, nxt, 128 + step, cfg)
        torch.testing.assert_close(logits.cpu(), c_logits, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind", ["gqa", "mla", "moe"])
def test_lm_train_step_on_card_matches_cpu(dev, kind):
    """lm_loss, its gradient and one AdamW step on the card against the
    CPU in f32: gqa at D 64 through the attention kernels (a forward a
    layer, again under remat, and a backward a layer), MLA and MoE
    (reduced configs) through autograd of plain ops.  The loss within
    1e-5, each gradient within 1e-4 of its max |grad|, the params after
    the step within 1e-3 (as the CPU parity tests at lr 1e-2)."""
    from repro_torch import train as T
    from repro_torch.train.train_step import value_and_grad

    if kind == "gqa":
        cfg = lm.LMConfig(name="t", n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
                          d_ff=512, vocab=512, param_dtype="float32",
                          attn_impl="pallas", loss_chunk=64)
    else:
        cfg = get_arch({"mla": "minicpm3-4b", "moe": "phi3.5-moe-42b-a6.6b"}[kind]
                       ).make_config(reduced=True)
    tree = lm.init_tree(generator(0, "cpu"), cfg)
    batch = {k: torch.as_tensor(v) for k, v in lm_batch(0, 2, 128, cfg.vocab).items()}
    card_tree = {k: ({n: w.to(dev) for n, w in v.items()} if isinstance(v, dict) else
                     v.to(dev)) for k, v in tree.items()}
    card_batch = {k: v.to(dev) for k, v in batch.items()}
    loss_fn = value_and_grad(lambda p, b: lm.lm_loss(p, b, cfg))
    K.reset_launch_counts()
    loss, grads = loss_fn(card_tree, card_batch)
    torch.cuda.synchronize()
    if kind == "gqa":
        assert K.launch_counts()["flash_attention"] == 2 * cfg.n_layers
        assert K.launch_counts()["flash_attention_bwd"] == cfg.n_layers
    c_loss, c_grads = loss_fn(tree, batch)
    assert abs(float(loss) - float(c_loss)) <= 1e-5 * abs(float(c_loss))
    for g, c in zip(tree_leaves(grads), tree_leaves(c_grads)):
        torch.testing.assert_close(g.cpu(), c, rtol=0, atol=1e-4 * float(c.abs().max()))
    tc = T.TrainConfig(adamw=T.AdamWConfig(lr=1e-2), warmup_steps=2, total_steps=10)
    step = T.build_train_step(lambda p, b: lm.lm_loss(p, b, cfg), tc, donate=True)
    card_tree, _, _ = step(card_tree, T.init_train_state(card_tree, tc), card_batch,
                           torch.tensor(0, dtype=torch.int32, device=dev))
    tree, _, _ = step(tree, T.init_train_state(tree, tc), batch,
                      torch.tensor(0, dtype=torch.int32))
    for a, b in zip(tree_leaves(card_tree), tree_leaves(tree)):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-3)


@pytest.mark.parametrize("kind", ["mla", "moe"])
def test_mla_moe_serving_on_card_matches_cpu(dev, kind):
    """MLA (absorbed decode) and MoE layers on the card against the CPU
    in f32; the MoE prefill attends through the kernel, one launch a
    layer, at a capacity that drops nothing (decode steps of 2 tokens
    never drop, and routes must agree)."""
    base = dict(name="t", n_layers=2, d_model=256, n_heads=4, d_ff=512, vocab=512,
                param_dtype="float32", attn_impl="pallas")
    if kind == "mla":
        cfg = lm.LMConfig(**base, n_kv_heads=4, attn_type="mla", q_lora_rank=96,
                          kv_lora_rank=64, qk_nope_dim=32, qk_rope_dim=16, v_head_dim=32,
                          tie_embeddings=True)
    else:
        cfg = lm.LMConfig(**base, n_kv_heads=2, moe=moe.MoEConfig(
            n_experts=8, top_k=2, d_model=256, d_ff=384, capacity_factor=4.0))
    cpu_model = lm.init_params(generator(0, "cpu"), cfg)
    card_model = lm.init_params(generator(0, "cpu"), cfg).to(dev)
    toks = torch.as_tensor(lm_batch(0, 2, 128, cfg.vocab)["tokens"])
    K.reset_launch_counts()
    cache, logits = lm.prefill_step(card_model, toks.to(dev), cfg, 136)
    torch.cuda.synchronize()
    assert K.launch_counts()["flash_attention"] == (0 if kind == "mla" else cfg.n_layers)
    c_cache, c_logits = lm.prefill_step(cpu_model, toks, cfg, 136)
    torch.testing.assert_close(logits.cpu(), c_logits, rtol=1e-4, atol=1e-5)
    for step in range(4):
        nxt = c_logits.argmax(-1).to(torch.int32)
        assert torch.equal(logits.argmax(-1).cpu().to(torch.int32), nxt)
        logits, cache = lm.decode_step(card_model, cache, nxt.to(dev), 128 + step, cfg)
        c_logits, c_cache = lm.decode_step(cpu_model, c_cache, nxt, 128 + step, cfg)
        torch.testing.assert_close(logits.cpu(), c_logits, rtol=1e-4, atol=1e-5)
    for name in cache:
        torch.testing.assert_close(cache[name].cpu(), c_cache[name], rtol=1e-4, atol=1e-5)


def test_moe_ffn_on_card_matches_cpu_and_repeats(dev):
    """bf16 ``moe_ffn`` at a capacity that drops pairs: the same routes
    (experts, kept pairs) as on the CPU, the output within 2e-2 of its
    scale, and the card's bits equal over two runs (a sorted dispatch
    and a gathered combine, no atomics)."""
    cfg = moe.MoEConfig(n_experts=8, top_k=2, d_model=256, d_ff=384,
                        capacity_factor=1.0, min_capacity=4)
    r = np.random.default_rng(5)
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    arrays = [r.normal(size=(2, 128, d)), r.normal(size=(d, E)) / np.sqrt(d),
              r.normal(size=(E, d, f)) / np.sqrt(d), r.normal(size=(E, d, f)) / np.sqrt(d),
              r.normal(size=(E, f, d)) / np.sqrt(f)]
    cpu = [torch.as_tensor(a.astype(np.float32)).to(torch.bfloat16) for a in arrays]
    card = [t.to(dev) for t in cpu]
    out, aux = moe.moe_ffn(*card, cfg)
    out2, aux2 = moe.moe_ffn(*card, cfg)
    assert torch.equal(out, out2) and torch.equal(aux, aux2)
    c_out, c_aux = moe.moe_ffn(*cpu, cfg)
    N = 2 * 128
    C = moe.capacity(cfg, N)
    route = moe.route(card[0].reshape(N, d), card[1], cfg, C)
    c_route = moe.route(cpu[0].reshape(N, d), cpu[1], cfg, C)
    assert route.dropped > 0
    assert torch.equal(route.idx.cpu(), c_route.idx)
    assert torch.equal(route.keep.cpu(), c_route.keep)
    err = float((out.float().cpu() - c_out.float()).abs().max())
    assert err <= 2e-2 * float(c_out.float().abs().max()), err
    torch.testing.assert_close(aux.cpu(), c_aux, rtol=1e-5, atol=0)


def test_mind_serving_on_card_matches_cpu(dev):
    cfg = dataclasses.replace(get_arch("mind").make_config(reduced=True),
                              bag_impl="pallas")
    cpu_model = mind.init_params(generator(0, "cpu"), cfg)
    card_model = mind.init_params(generator(0, "cpu"), cfg).to(dev)
    batch = {k: torch.as_tensor(v) for k, v in mind_batch(0, 32, cfg).items()}
    cands = torch.arange(cfg.n_items)
    K.reset_launch_counts()
    scores = mind.retrieval_scores(card_model, {k: v.to(dev) for k, v in batch.items()},
                                   cands.to(dev), cfg)
    torch.cuda.synchronize()
    assert K.launch_counts()["embedding_bag"] == 1
    ref = mind.retrieval_scores(cpu_model, batch, cands, cfg)
    # scores are about 1e-6 (0.02-scale tables): hold them at ref's scale
    err = float((scores.cpu() - ref).abs().max())
    assert err <= 1e-5 * float(ref.abs().max()), err


def test_embedding_bag_refuses_grad(dev):
    """The kernel entry refuses a table or w that needs a gradient while
    grad mode is on; under no_grad it launches."""
    table = torch.ones((10, 8), device=dev, requires_grad=True)
    idx = torch.zeros((3, 4), dtype=torch.int32, device=dev)
    w = torch.ones((3, 4), device=dev)
    for t, ww in ((table, w), (table.detach(), w.clone().requires_grad_(True))):
        with pytest.raises(RuntimeError, match="BagSum"):
            K.embedding_bag_cuda(t, idx, ww)
        with pytest.raises(RuntimeError, match="BagSum"):
            K.bag_sum(t, idx, ww)
    K.reset_launch_counts()
    with torch.no_grad():
        K.embedding_bag_cuda(table, idx, w)
    assert K.launch_counts()["embedding_bag"] == 1


@pytest.mark.parametrize("V,d,B,L,hot", [(500, 64, 64, 16, 0), (3000, 64, 700, 16, 200),
                                         (200, 30, 40, 11, 70), (50, 128, 9, 5, 0)])
def test_bag_sum_backward_on_card_is_its_plain_version(dev, V, d, B, L, hot):
    """BagSum on the card: one bag launch forward, one vertex sum
    backward over the bag ELL; the gradient bit for bit the plain vertex
    sum over the same ELL on the card and BagSum's on the CPU, and within
    1e-5 of max |grad| of autograd of the plain bag.  A third of the
    slots masked; ``hot`` slots name row 1 (a segment of more than W
    slots, folded by the fat-vertex path); row 0 named by no slot."""
    from repro_torch.models.gnn.ell import build_bag_ell

    r = np.random.default_rng(V + B + hot)
    idx = r.integers(2, V, (B, L)).astype(np.int32)
    idx.reshape(-1)[r.choice(B * L, hot, replace=False)] = 1
    w = (r.random((B, L)) > 0.33).astype(np.float32)
    table, idx_t, w_t, g = on(dev, r.normal(size=(V, d)).astype(np.float32), idx, w,
                              r.normal(size=(B, d)).astype(np.float32))
    t = table.clone().requires_grad_(True)
    K.reset_launch_counts()
    (grad,) = torch.autograd.grad(K.BagSum.apply(t, idx_t, w_t), t, g)
    torch.cuda.synchronize()
    assert (K.launch_counts()["embedding_bag"], K.launch_counts()["spmm_ell"]) == (1, 1)
    ell = build_bag_ell(idx_t, w_t, V)
    assert bits_equal(grad, K.spmm_ell_vertex_ref(g, ell.col, ell.wgt, ell.row_ptr, ell.deg))
    assert bool((grad[0] == 0).all())
    tc = table.cpu().requires_grad_(True)
    (grad_cpu,) = torch.autograd.grad(K.BagSum.apply(tc, idx_t.cpu(), w_t.cpu()), tc, g.cpu())
    assert bits_equal(grad.cpu(), grad_cpu)
    tp = table.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(K.embedding_bag_ref(tp, idx_t, w_t), tp, g)
    assert float((grad - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_mind_train_step_on_card_matches_cpu(dev):
    """The reduced config through the kernels (bag_impl "pallas"): the
    loss and every gradient leaf at scale-1 tables on the card against
    the CPU's (the item table's gathers add by atomics on the card):
    loss within 1e-6 of it, each leaf within 2e-5 of its max |grad|,
    routing_init's (0 in exact arithmetic) below 1e-6 of the largest
    |grad|; then two steps of the train_batch cell's step on both devices
    at the scale-1 tables, lr 1e-2 through a 2-step warmup (as
    tests/test_torch_mind_train.py), each step launching the bag kernel
    and the vertex sum: the loss within 1e-5, the params and the master
    weights within 1e-3, below a fifth of one update (lr 5e-3, then
    1e-2, an element), and every leaf but routing_init moved by more
    than that, so a missing or wrong update shows.  routing_init's
    gradient is rounding noise on each device; Adam moves it by up to lr
    a step in its own direction, the bound each device is held to."""
    from torch.utils._pytree import tree_map

    from repro_torch.train import AdamWConfig, TrainConfig, build_train_step, init_train_state
    from repro_torch.train.checkpoint import _flatten_with_paths as by_path
    from repro_torch.train.train_step import value_and_grad

    mod = get_arch("mind")
    cfg = dataclasses.replace(mod.make_config(reduced=True), bag_impl="pallas")
    cpu_tree = mind.init_tree(generator(0, "cpu"), cfg)
    wide = {**cpu_tree, "item_table": cpu_tree["item_table"] * 50,
            "profile_table": cpu_tree["profile_table"] * 50}
    batch = {k: torch.as_tensor(v) for k, v in mind_batch(0, 64, cfg, seed=2).items()}
    card_batch = {k: v.to(dev) for k, v in batch.items()}
    fn = value_and_grad(lambda p, b: mind.sampled_softmax_loss(p, b, cfg))
    K.reset_launch_counts()
    loss, grads = fn(tree_map(lambda t: t.to(dev), wide), card_batch)
    torch.cuda.synchronize()
    assert (K.launch_counts()["embedding_bag"], K.launch_counts()["spmm_ell"]) == (1, 1)
    c_loss, c_grads = fn(wide, batch)
    assert float(loss) == pytest.approx(float(c_loss), rel=1e-6)
    got, want = by_path(grads), by_path(c_grads)
    top = max(float(v.abs().max()) for v in want.values())
    for k, w in want.items():
        gap = float((got[k].cpu() - w).abs().max())
        if k == "routing_init":
            assert max(float(got[k].abs().max()), float(w.abs().max())) <= 1e-6 * top
        else:
            assert gap <= 2e-5 * float(w.abs().max()), (k, gap)
    # the train_batch cell's step at this config (the reduced config's own
    # bag_impl is the plain "ref")
    tc = TrainConfig(adamw=AdamWConfig(lr=1e-2), warmup_steps=2, total_steps=10)
    step = build_train_step(lambda p, b: mind.sampled_softmax_loss(p, b, cfg), tc,
                            donate=True)
    start = by_path(wide)
    trees = {"card": tree_map(lambda t: t.to(dev), wide),
             "cpu": tree_map(lambda t: t.clone(), wide)}
    opts = {k: init_train_state(t, tc) for k, t in trees.items()}
    lrs = []
    for i in range(2):
        losses = {}
        for where, b in (("card", card_batch), ("cpu", batch)):
            K.reset_launch_counts()
            trees[where], opts[where], m = step(
                trees[where], opts[where], b,
                torch.tensor(i, dtype=torch.int32, device=b["hist"].device))
            losses[where] = float(m["loss"])
            lrs.append(float(m["lr"]))
            if where == "card":
                assert (K.launch_counts()["embedding_bag"], K.launch_counts()["spmm_ell"]) == \
                    (1, 1)
        assert losses["card"] == pytest.approx(losses["cpu"], rel=1e-5)
    assert lrs == pytest.approx([5e-3, 5e-3, 1e-2, 1e-2], rel=1e-6)
    moved = sum(lrs[::2]) * (1 + tc.adamw.weight_decay * (float(start["routing_init"].abs().max())
                                                           + 1))
    for card, cpu in ((trees["card"], trees["cpu"]), (opts["card"]["master"],
                                                      opts["cpu"]["master"])):
        card, cpu = by_path(card), by_path(cpu)
        assert sorted(card) == sorted(cpu) == sorted(start)
        for k, w in cpu.items():
            if k == "routing_init":
                for side in (card[k].cpu(), w):
                    assert float((side - start[k]).abs().max()) <= moved, k
                continue
            torch.testing.assert_close(card[k].cpu(), w, rtol=0, atol=1e-3, msg=k)
            assert float((w - start[k]).abs().max()) > 1e-2, k


def bits_equal(a, b):
    """Bit for bit, NaN where NaN."""
    nan = torch.isnan(b)
    return torch.equal(torch.isnan(a), nan) and torch.equal(
        torch.where(nan, 0.0, a).view(torch.int32), torch.where(nan, 0.0, b).view(torch.int32))


@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("n_x,R,W,d", [
    (100, 64, 4, 32), (257, 300, 12, 96), (64, 128, 8, 128), (5000, 3000, 64, 100),
    (5000, 3000, 64, 64), (3000, 500, 14, 1433), (50, 7, 33, 3), (40, 9, 70, 2),
    (30, 5, 0, 8), (1, 1, 1, 1), (400, 300, 20, 130), (300, 200, 40, 4100),
    (200, 150, 10, 97),
])
def test_spmm_ell_matches_plain(dev, op, n_x, R, W, d):
    """Vector widths 4 (d = 100, 96, 128, 4100), 2 (d = 64, 2, 130), 1
    (d = 97, 3, 1) and shifted float4 (d = 1433, odd rows at any
    alignment); W across several 32-slot chunks; W = 0.  d = 1433, 130,
    4100 and 97 span 12, 3, 33 and 4 feature chunks, split over warps,
    the last one partial.  NaNs in a fifth of x's rows' first column
    reach some rows; the max must carry them."""
    r = np.random.default_rng(n_x + R + W + d)
    x = r.normal(size=(n_x, d)).astype(np.float32)
    x[n_x - 1] = 0
    if op == "max" and n_x > 5:
        x[r.random(n_x) < 0.2, 0] = np.nan
    col = r.integers(0, n_x, (R, W)).astype(np.int32)
    wgt = ((r.random((R, W)) > 0.3) * r.random((R, W))).astype(np.float32)
    tx, tc, tw = on(dev, x, col, wgt)
    K.reset_launch_counts()
    out = K.aggregate_neighbors(tx, tc, tw, op=op, impl="pallas")
    torch.cuda.synchronize()
    assert K.launch_counts()["spmm_ell"] == 1
    ref = K.spmm_ell_ref(tx, tc, tw, op) if W else torch.full(
        (R, d), 0.0 if op == "sum" else float("-inf"), device=dev)
    assert out.shape == (R, d) and out.dtype == torch.float32
    if op == "max":
        assert bits_equal(out, ref)
        if W:
            assert bits_equal(out.cpu(), K.spmm_ell_ref(*on("cpu", x, col, wgt), op))
    else:
        scale = max(float(ref.abs().max()), 1e-30)
        assert float((out - ref).abs().max()) <= 1e-5 * scale
    # the slots are walked in order: the same bits every launch
    assert bits_equal(K.spmm_ell_cuda(tx, tc, tw, op), out)


@pytest.mark.parametrize("n_x,R,W,d", [
    (5000, 3000, 64, 100), (3000, 500, 14, 1433), (400, 300, 20, 130),
    (300, 200, 40, 4100), (40, 9, 70, 2), (200, 150, 10, 97), (2709, 2708, 14, 1433),
])
def test_spmm_ell_sum_is_slot_order(dev, n_x, R, W, d):
    """The sum bit for bit as out = out + x[col[:, s]] * wgt[:, s] for
    s = 0 .. W-1, each product and sum rounded (separate torch ops, so no
    FMA): the slot order holds in every feature chunk, however the
    features are split over warps."""
    r = np.random.default_rng(n_x + R + W + d + 1)
    x = r.normal(size=(n_x, d)).astype(np.float32)
    col = r.integers(0, n_x, (R, W)).astype(np.int32)
    wgt = ((r.random((R, W)) > 0.3) * r.normal(size=(R, W))).astype(np.float32)
    tx, tc, tw = on(dev, x, col, wgt)
    out = K.spmm_ell_cuda(tx, tc, tw, "sum")
    in_order = torch.zeros((R, d), device=dev)
    for s in range(W):
        in_order = in_order + tx[tc[:, s].long()] * tw[:, s, None]
    assert torch.equal(out, in_order)


def test_spmm_ell_rechecks_a_written_col(dev):
    """The index check is remembered for a col tensor only until the
    tensor is written: an index written in place after a checked call
    still raises."""
    r = np.random.default_rng(1)
    x, col, wgt = on(dev, r.normal(size=(50, 8)).astype(np.float32),
                     r.integers(0, 50, (20, 4)).astype(np.int32),
                     r.random((20, 4)).astype(np.float32))
    K.spmm_ell_cuda(x, col, wgt)
    col[3, 1] = 50
    with pytest.raises(ValueError, match="lie in"):
        K.spmm_ell_cuda(x, col, wgt)


def test_spmm_ell_wrapper_rejects_bad_inputs(dev):
    r = np.random.default_rng(0)
    x, col, wgt = on(dev, r.normal(size=(50, 8)).astype(np.float32),
                     r.integers(0, 50, (20, 4)).astype(np.int32),
                     r.random((20, 4)).astype(np.float32))
    with pytest.raises(ValueError, match="lie in"):
        K.spmm_ell_cuda(x, torch.full_like(col, 50), wgt)
    with pytest.raises(ValueError, match="lie in"):
        K.spmm_ell_cuda(x, torch.full_like(col, -1), wgt)
    with pytest.raises(ValueError, match="contiguous"):
        K.spmm_ell_cuda(x.t().contiguous().t(), col, wgt)
    with pytest.raises(ValueError, match="col must be 2-D int32"):
        K.spmm_ell_cuda(x, col.long(), wgt)
    with pytest.raises(ValueError, match="wgt must be float32"):
        K.spmm_ell_cuda(x, col, wgt.double())
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.spmm_ell_cuda(x, col.cpu(), wgt)
    with pytest.raises(ValueError, match="op"):
        K.spmm_ell_cuda(x, col, wgt, "mean")


def vertex_ell_case(dev, d, seed):
    """A neighbour ELL (W 64) over 3,000 vertices: 30,000 random edges,
    a hub of 3,000 in-edges (47 rows, above SPLIT_ROWS), a vertex of
    exactly SPLIT_ROWS full rows and one of one slot more, 12 of 2 to 6
    rows, 100 isolated vertices; non-integer weights on the live slots,
    a fifth of them 0 (masked edges); normal x."""
    from repro_torch.kernels.spmm_ell.kernel import SPLIT_ROWS
    from repro_torch.models.gnn import build_neighbor_ell

    r = np.random.default_rng(seed)
    n, hub, exact, over = 3000, 5, 6, 7
    dst = np.concatenate([r.integers(20, n - 100, 30000), np.full(3000, hub),
                          np.full(64 * SPLIT_ROWS, exact), np.full(64 * SPLIT_ROWS + 1, over),
                          *(np.full(20 * v - 95, v) for v in range(8, 20))])
    src = r.integers(0, n, dst.shape[0])
    perm = r.permutation(dst.shape[0])
    ell = build_neighbor_ell(*on(dev, src[perm], dst[perm], np.ones(dst.shape[0], bool)), n)
    rows = (ell.row_ptr[1:] - ell.row_ptr[:-1]).cpu()
    assert ell.col.shape[1] == 64 and int(rows[hub]) == 47
    assert int(rows[exact]) == SPLIT_ROWS and int(rows[over]) == SPLIT_ROWS + 1
    w = r.normal(size=ell.wgt.shape) * (r.random(ell.wgt.shape) > 0.2)
    wgt = torch.where(ell.wgt != 0, torch.as_tensor(w.astype(np.float32), device=dev), 0.0)
    x = torch.as_tensor(r.normal(size=(n, d)).astype(np.float32), device=dev)
    return x, ell.col, wgt, ell.row_ptr, ell.deg


@pytest.mark.parametrize("split_rows", [None, 1, 64])
@pytest.mark.parametrize("d", [100, 64, 97, 1433])
def test_spmm_ell_vertex_matches_plain(dev, d, split_rows, monkeypatch):
    """The vertex sum bit for bit against its plain in-order version, on
    the card and on the CPU, at float4 (d = 100), float2 (64), scalar
    (97) and shifted float4 rows (1433, 12 feature chunks); the hub's
    rows, and with split_rows = 1 every multi-row vertex's, go through
    the scratch rows and the fold; with 64 only the hub's, the others'
    rows fold within their warp's stream.  The same bits on a second
    launch."""
    from repro_torch.kernels.spmm_ell import kernel

    x, col, wgt, row_ptr, deg = vertex_ell_case(dev, d, seed=d)
    if split_rows is not None:
        monkeypatch.setattr(kernel, "SPLIT_ROWS", split_rows)
    K.reset_launch_counts()
    out = K.spmm_ell_vertex_cuda(x, col, wgt, row_ptr, deg)
    torch.cuda.synchronize()
    assert K.launch_counts()["spmm_ell"] == 1
    assert out.shape == (deg.shape[0], d) and out.dtype == torch.float32
    assert bits_equal(out, K.spmm_ell_vertex_ref(x, col, wgt, row_ptr, deg))
    cpu = K.spmm_ell_vertex_ref(*(t.cpu() for t in (x, col, wgt, row_ptr, deg)))
    assert bits_equal(out.cpu(), cpu)
    assert bits_equal(K.spmm_ell_vertex_cuda(x, col, wgt, row_ptr, deg), out)


def test_spmm_ell_vertex_wrapper_rejects_bad_inputs(dev):
    x, col, wgt, row_ptr, deg = vertex_ell_case(dev, 8, seed=1)
    bad = col.clone()
    bad[int(row_ptr[5]), 0] = x.shape[0]  # a live slot of the hub past x
    with pytest.raises(ValueError, match="live col must lie in"):
        K.spmm_ell_vertex_cuda(x, bad, wgt, row_ptr, deg)
    bad_deg = deg.clone()
    bad_deg[5] = 64 * 47 + 1
    with pytest.raises(ValueError, match="deg must lie in"):
        K.spmm_ell_vertex_cuda(x, col, wgt, row_ptr, bad_deg)
    with pytest.raises(ValueError, match="row_ptr must rise from 0"):
        K.spmm_ell_vertex_cuda(x, col, wgt, row_ptr.flip(0).contiguous(), deg)
    with pytest.raises(ValueError, match="deg must be int32"):
        K.spmm_ell_vertex_cuda(x, col, wgt, row_ptr, deg.long())
    with pytest.raises(ValueError, match="contiguous"):
        K.spmm_ell_vertex_cuda(x.t().contiguous().t(), col, wgt, row_ptr, deg)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.spmm_ell_vertex_cuda(x, col, wgt, row_ptr.cpu(), deg)


def empty_rows_case(dev, d, W=8, n=300, n_x=60, seed=0):
    """An ELL whose vertices own rows past their last live slot, as the C
    entry's contract allows (deg[v] <= rows x W): a vertex of 5 rows
    and 2W + 3 slots, one of 4 rows and none, one of 3 rows and W, one
    of 2 rows and 3 slots, one of 1 row and none, then random row counts
    0 .. 6 and live slots 0 .. rows x W.  Padding slots hold NaN
    weights: a kernel that reads one shows it."""
    r = np.random.default_rng(seed)
    rows = np.concatenate([[5, 4, 3, 2, 0, 1, 6, 1], r.integers(0, 7, n - 8)])
    deg = np.concatenate([[2 * W + 3, 0, W, 3, 0, W, 6 * W, 0],
                          [r.integers(0, k * W + 1) for k in rows[8:]]]).astype(np.int32)
    row_ptr = np.concatenate([[0], np.cumsum(rows)]).astype(np.int64)
    R = int(row_ptr[-1])
    live = np.clip(np.repeat(deg, rows) - (np.arange(R) - np.repeat(row_ptr[:-1], rows)) * W,
                   0, W)
    wgt = (r.normal(size=(R, W)) * (r.random((R, W)) > 0.2)).astype(np.float32)
    wgt[np.arange(W) >= live[:, None]] = np.nan
    col = r.integers(0, n_x, (R, W)).astype(np.int32)
    x = r.normal(size=(n_x, d)).astype(np.float32)
    return on(dev, x, col, wgt, row_ptr, deg)


@pytest.mark.parametrize("split_rows", [2, 1])
@pytest.mark.parametrize("d", [100, 64, 97, 1433])
def test_spmm_ell_vertex_empty_rows_match_plain(dev, d, split_rows):
    """Rows without a live slot, in vertices split over scratch rows and
    in those summed whole, give +0 row sums: the bare launch into NaN
    scratch and a NaN out is bit for bit the plain in-order version."""
    from repro_torch.kernels.spmm_ell import kernel

    x, col, wgt, row_ptr, deg = empty_rows_case(dev, d, seed=d + split_rows)
    plan = kernel.vertex_plan(x, col, row_ptr, deg, split_rows)
    assert int((plan.fat_live == 0).sum()) > 0
    n = deg.shape[0]
    scratch = torch.full((plan.fat_row.shape[0], d), float("nan"), device=dev)
    out = torch.full((n, d), float("nan"), device=dev)
    rc = kernel._vertex_launch()(*kernel.vertex_launch_args(x, col, wgt, row_ptr, deg, plan,
                                                           scratch, out))
    torch.cuda.synchronize()
    assert rc == 0
    ref = K.spmm_ell_vertex_ref(x, col, wgt, row_ptr, deg)
    assert not torch.isnan(ref).any()
    assert bits_equal(out, ref)
    assert bits_equal(K.spmm_ell_vertex_cuda(x, col, wgt, row_ptr, deg), ref)


@pytest.mark.parametrize("cell,scale", [("ogb_products", 12), ("full_graph_sm", 9)])
def test_gin_on_card_matches_cpu(dev, cell, scale):
    """GIN through the kernel (one launch a layer) on the card against
    the CPU, and against the plain segment-sum route on the card: node
    by node within 1e-5 of the node's max |logit|."""
    cfg = get_arch("gin-tu").make_config(False, cell)
    g = rmat1(scale, seed=0)
    batch = gnn_flat_batch(g, cfg.d_in, cfg.n_classes, seed=0)
    params = gin.init_params(generator(0, "cpu"), cfg)
    on_card = torch.utils._pytree.tree_map(lambda t: t.to(dev), params)
    args = [torch.as_tensor(batch[k]) for k in ("x", "edge_src", "edge_dst", "edge_mask")]
    K.reset_launch_counts()
    out = gin.forward(on_card, *(a.to(dev) for a in args), cfg)
    torch.cuda.synchronize()
    assert K.launch_counts()["spmm_ell"] == cfg.n_layers
    plain = gin.forward(on_card, *(a.to(dev) for a in args),
                        dataclasses.replace(cfg, agg_impl="segment_sum"))
    cpu = gin.forward(params, *args, cfg)
    for ref in (cpu, plain.cpu()):
        err = (out.cpu() - ref).abs().max(1).values
        assert bool((err <= 1e-5 * ref.abs().max(1).values).all())


def directed_ells(dev, seed, n=3000):
    """A directed graph (each edge one way) of 30,000 random edges, a
    hub of 3,000 in-edges and a source of 3,000 out-edges, a fifth of
    the edges masked: its neighbour ELL and transpose ELL on the card."""
    from repro_torch.models.gnn import build_neighbor_ell

    r = np.random.default_rng(seed)
    src = np.concatenate([r.integers(0, n, 30000), r.integers(0, n, 3000), np.full(3000, 9)])
    dst = np.concatenate([r.integers(0, n, 30000), np.full(3000, 5), r.integers(0, n, 3000)])
    edges = on(dev, src, dst, r.random(src.shape[0]) > 0.2)
    return (build_neighbor_ell(*edges, n),
            build_neighbor_ell(edges[1], edges[0], edges[2], n))


@pytest.mark.parametrize("split_rows", [None, 1])
@pytest.mark.parametrize("d", [64, 100])
def test_vertex_sum_backward_on_card_matches_plain(dev, d, split_rows, monkeypatch):
    """VertexSum's backward launches the kernel over the transpose ELL:
    one launch forward, one backward, the gradient bit for bit the plain
    Function's on the card and on the CPU."""
    from repro_torch.kernels.spmm_ell import kernel

    if split_rows is not None:
        monkeypatch.setattr(kernel, "SPLIT_ROWS", split_rows)
    fwd, bwd = directed_ells(dev, seed=d)
    lay = [(e.col, e.wgt, e.row_ptr, e.deg) for e in (fwd, bwd)]
    r = np.random.default_rng(d + 1)
    x, g = on(dev, r.normal(size=(fwd.n, d)).astype(np.float32),
              r.normal(size=(fwd.n, d)).astype(np.float32))
    xg = x.clone().requires_grad_(True)
    K.reset_launch_counts()
    out = K.VertexSum.apply(xg, lay[0], lambda: lay[1])
    (grad,) = torch.autograd.grad(out, xg, g)
    torch.cuda.synchronize()
    assert K.launch_counts()["spmm_ell"] == 2
    assert bits_equal(out.detach(), K.spmm_ell_vertex_ref(x, *lay[0]))
    assert bits_equal(grad, K.spmm_ell_vertex_ref(g, *lay[1]))
    cpu = [tuple(t.cpu() for t in e) for e in lay]
    xc = x.cpu().requires_grad_(True)
    (grad_cpu,) = torch.autograd.grad(K.VertexSum.apply(xc, cpu[0], lambda: cpu[1]), xc, g.cpu())
    assert bits_equal(grad.cpu(), grad_cpu)


@pytest.mark.parametrize("cell,scale", [("ogb_products", 12), ("full_graph_sm", 9),
                                        ("molecule", 0)])
def test_gin_train_step_on_card_matches_cpu(dev, cell, scale):
    """Two train steps of the cell's plan (AdamW, warmup-cosine, clip)
    through the kernel route on the card (9 launches a step: 5 forward,
    4 backward over the transpose ELL) against the same steps on the
    CPU and the segment-sum route on the card: loss within 1e-5 of
    |loss|, params within 1e-5 (both sum in another order; an update is
    about lr = 3e-4 in size)."""
    from repro_torch.data import molecule_batch
    from repro_torch.train import TrainConfig, build_train_step, init_train_state

    mod = get_arch("gin-tu")
    plan, cfg = mod.make_cell(cell), mod.make_config(False, cell)
    if cell == "molecule":
        batch = molecule_batch(0, 128, 30, 64, seed=0)
    else:
        batch = gnn_flat_batch(rmat1(scale, seed=0), cfg.d_in, cfg.n_classes, seed=0)
    params = gin.init_params(generator(0, "cpu"), cfg)
    loss = mod._molecule_loss if cell == "molecule" else gin.node_classification_loss
    tmap = torch.utils._pytree.tree_map

    def run(device, agg_impl):
        c = dataclasses.replace(cfg, agg_impl=agg_impl)
        step = plan.fn if agg_impl == "spmm_ell" else build_train_step(
            lambda p_, b_: loss(p_, b_, c), TrainConfig())
        p = tmap(lambda t: t.to(device), params)
        s = init_train_state(p, TrainConfig())
        b = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        losses = []
        for i in range(2):
            K.reset_launch_counts()
            p, s, m = step(p, s, b, i)
            if device.type == "cuda":
                torch.cuda.synchronize()
                assert K.launch_counts()["spmm_ell"] == (9 if agg_impl == "spmm_ell" else 0)
            losses.append(float(m["loss"]))
        return tmap(lambda t: t.cpu(), p), losses

    card, card_loss = run(dev, "spmm_ell")
    for p, losses in (run(torch.device("cpu"), "spmm_ell"), run(dev, "segment_sum")):
        for a, b in zip(card_loss, losses):
            assert np.isfinite(a) and abs(a - b) <= 1e-5 * abs(b)
        for a, b in zip(torch.utils._pytree.tree_leaves(card),
                        torch.utils._pytree.tree_leaves(p)):
            assert float((a - b).abs().max()) <= 1e-5


def batch_case(seed, lanes, P, n_local, R, W, F, kind="", world=None):
    """S = lanes·P lanes over a P-rank ELL with non-integer weights; lane
    counts cycle through 0, 1 and F and random ones.  kind "real_tail":
    the rows listed past a lane's count are real rows, not fill.
    ``world``: the ranks the destinations span (default P); a process of
    the process backend holds P = 1 rank of ``world``."""
    r = np.random.default_rng(seed)
    S, n_out = lanes * P, (world or P) * n_local
    dist = np.full((S, n_local + 1), np.inf, np.float32)
    hot = r.random((S, n_local)) < 0.4
    dist[:, :n_local][hot] = r.uniform(0, 50, int(hot.sum())).astype(np.float32)
    row_src = r.integers(0, n_local, (P, R)).astype(np.int32)
    col = r.integers(0, n_out + 1, (P, R, W)).astype(np.int32)
    wgt = np.where(col == n_out, np.inf,
                   r.uniform(0.1, 99.9, (P, R, W))).astype(np.float32)
    counts = np.asarray([(0, 1, F)[s % 3] if s < 3 else int(r.integers(0, F + 1))
                         for s in range(S)], np.int32)
    if kind == "real_tail":
        row_idx = r.integers(0, R, (S, F)).astype(np.int32)
    else:
        row_idx = np.full((S, F), R, np.int32)
        for s, k in enumerate(counts):
            row_idx[s, :k] = r.integers(0, R, k)
    return dist, row_idx, counts, row_src, col, wgt, n_out


# (seed, lanes a rank, P, n_local, R, W, F, kind): S = lanes·P in 1 .. 16;
# W 64 on 16-byte strips, 33 and 5 on the scalar path; F 20,000 spreads
# each lane over more than one sweep of its share of the grid
BATCH_CASES = [(lanes, P, W) for lanes in (1, 3, 8) for P in (1, 2)
               for W in (64, 33)]


@pytest.mark.parametrize("lanes,P,W", BATCH_CASES)
@pytest.mark.parametrize("kind", ["", "real_tail"])
def test_batched_frontier_kernels_match_plain(dev, lanes, P, W, kind):
    dist, row_idx, counts, row_src, col, wgt, n_out = batch_case(
        lanes * 10 + P + W, lanes, P, 700, 900, W, 120, kind)
    d, i, c, rs, cl, w = on(dev, dist, row_idx, counts, row_src, col, wgt)
    K.reset_launch_counts()
    fused = K.fused_superstep_batch_cuda(d, i, c, rs, cl, w, n_out)
    gather = K.relax_push_gather_batch_cuda(d, i, c, rs, cl, w)
    torch.cuda.synchronize()
    launched = K.launch_counts()
    assert launched["fused_superstep_batch"] == 1
    assert launched["relax_push_gather_batch"] == 1
    assert launched["fused_superstep"] == launched["relax_push_gather"] == 0
    assert torch.equal(fused, K.fused_superstep_batch_ref(d, i, c, rs, cl, w, n_out))
    assert torch.equal(gather, K.relax_push_gather_batch_ref(d, i, c, rs, w))
    rows = K.relax_push_rows_batch(d, i, c, rs, cl, w, n_out)
    assert torch.equal(rows, K.relax_push_rows_batch(*on("cpu", dist, row_idx, counts,
                                                          row_src, col, wgt), n_out).to(dev))
    for s in range(lanes * P):  # S single launches on the same lanes
        q = s % P
        args = (d[s], i[s], c[s:s + 1], rs[q], cl[q], w[q])
        assert torch.equal(fused[s], K.fused_superstep_cuda(*args, n_out))
        assert torch.equal(gather[s], K.relax_push_gather_cuda(*args))


@pytest.mark.parametrize("W", [64, 5])
def test_batched_frontier_kernels_on_a_large_frontier(dev, W):
    dist, row_idx, counts, row_src, col, wgt, n_out = batch_case(
        W, 8, 2, 30000, 40000, W, 20000)
    d, i, c, rs, cl, w = on(dev, dist, row_idx, counts, row_src, col, wgt)
    fused = K.fused_superstep_batch_cuda(d, i, c, rs, cl, w, n_out)
    gather = K.relax_push_gather_batch_cuda(d, i, c, rs, cl, w)
    torch.cuda.synchronize()
    assert torch.equal(fused, K.fused_superstep_batch_ref(d, i, c, rs, cl, w, n_out))
    assert torch.equal(gather, K.relax_push_gather_batch_ref(d, i, c, rs, w))
    # one 1-D grid for all 16 lanes, at most a block per 8 of their rows
    blocks = K.superstep_fused.kernel.batch_grid(20000, W, 16, W % 4 == 0)
    assert 1 <= blocks <= 16 * 20000 // 8


# (lanes a rank, P, W): S = lanes·P in 1 .. 40 (past one warp's 32 lanes
# of the grid's share scan); W 64 on 16-byte strips, 33 and 5 scalar
SKEWED_CASES = [(1, 1, 64), (2, 1, 64), (3, 1, 33), (8, 1, 64), (4, 2, 5),
                (8, 2, 64), (8, 2, 33), (20, 2, 64)]


@pytest.mark.parametrize("lanes,P,W", SKEWED_CASES)
def test_batched_frontier_kernels_on_skewed_lanes(dev, lanes, P, W):
    """Lanes at 0 and 1 beside one lane at F (and one at F - 1): the
    lane near F takes most of the grid; rows listed past a lane's count
    are real rows the kernels must not visit."""
    F = 5000
    dist, row_idx, _, row_src, col, wgt, n_out = batch_case(
        lanes * 100 + P * 10 + W, lanes, P, 3000, 4000, W, F, "real_tail")
    S = lanes * P
    counts = np.asarray([(0, 1, 0)[s % 3] for s in range(S)], np.int32)
    counts[S // 2] = F
    if S > 2:
        counts[-1] = F - 1
    d, i, c, rs, cl, w = on(dev, dist, row_idx, counts, row_src, col, wgt)
    K.reset_launch_counts()
    fused = K.fused_superstep_batch_cuda(d, i, c, rs, cl, w, n_out)
    gather = K.relax_push_gather_batch_cuda(d, i, c, rs, cl, w)
    torch.cuda.synchronize()
    assert K.launch_counts()["fused_superstep_batch"] == 1
    assert K.launch_counts()["relax_push_gather_batch"] == 1
    assert torch.equal(fused, K.fused_superstep_batch_ref(d, i, c, rs, cl, w, n_out))
    assert torch.equal(gather, K.relax_push_gather_batch_ref(d, i, c, rs, w))
    for s in range(S):  # S single launches on the same lanes
        q = s % P
        args = (d[s], i[s], c[s:s + 1], rs[q], cl[q], w[q])
        assert torch.equal(fused[s], K.fused_superstep_cuda(*args, n_out))
        assert torch.equal(gather[s], K.relax_push_gather_cuda(*args))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("lanes,W", [(1, 64), (8, 64), (8, 33), (3, 5)])
@pytest.mark.parametrize("kind", ["", "real_tail"])
def test_batched_entries_at_a_ranks_shape(dev, world, lanes, W, kind):
    """The batched entries as a rank process of the process backend
    launches them: one rank's ELL (P = 1), its destinations over all
    ``world`` ranks' slots, ``lanes`` lanes; against the plain versions
    and single launches on the same lanes."""
    dist, row_idx, counts, row_src, col, wgt, n_out = batch_case(
        world * 100 + lanes * 10 + W, lanes, 1, 900, 1200, W, 300, kind,
        world=world)
    assert n_out == world * 900 and int(col.max()) <= n_out
    d, i, c, rs, cl, w = on(dev, dist, row_idx, counts, row_src, col, wgt)
    K.reset_launch_counts()
    fused = K.fused_superstep_batch_cuda(d, i, c, rs, cl, w, n_out)
    gather = K.relax_push_gather_batch_cuda(d, i, c, rs, cl, w)
    torch.cuda.synchronize()
    assert K.launch_counts()["fused_superstep_batch"] == 1
    assert K.launch_counts()["relax_push_gather_batch"] == 1
    assert fused.shape == (lanes, n_out + 1)
    assert torch.equal(fused, K.fused_superstep_batch_ref(d, i, c, rs, cl, w, n_out))
    assert torch.equal(gather, K.relax_push_gather_batch_ref(d, i, c, rs, w))
    for s in range(lanes):
        args = (d[s], i[s], c[s:s + 1], rs[0], cl[0], w[0])
        assert torch.equal(fused[s], K.fused_superstep_cuda(*args, n_out))
        assert torch.equal(gather[s], K.relax_push_gather_cuda(*args))


def test_batched_wrappers_reject_bad_inputs(dev):
    dist, row_idx, counts, row_src, col, wgt, n_out = batch_case(0, 3, 2, 50, 60, 8, 10)
    d, i, c, rs, cl, w = on(dev, dist, row_idx, counts, row_src, col, wgt)
    with pytest.raises(ValueError, match="count"):
        K.fused_superstep_batch_cuda(d, i, c[:-1], rs, cl, w, n_out)
    with pytest.raises(ValueError, match="evenly"):
        K.relax_push_gather_batch_cuda(d[:5], i[:5], c[:5], rs, cl, w)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.fused_superstep_batch_cuda(d.cpu(), i, c, rs, cl, w, n_out)


@pytest.mark.parametrize("spec,impl", [
    ("delta:5/sparse/fused", "fused"), ("delta:5/sparse", "push"),
    ("kla:2+threadq/sparse", "ref"), ("delta:5+threadq/a2a", "ref"),
])
@pytest.mark.parametrize("n_parts", [1, 2])
def test_solve_batch_on_card_matches_cpu(dev, spec, impl, n_parts):
    """Lanes on the card equal lanes on the CPU; the sparse route
    launches the batched entry, never the single one, in a batch."""
    from repro_torch.api import ExplicitSources, MultiSource

    g = rmat1(10, seed=1)
    cfg = SolverConfig.from_spec(spec, relax_impl=impl)
    problems = [Problem(g, SingleSource(v)) for v in (0, 7, 99, 500, 1000)]
    K.reset_launch_counts()
    card = Solver(cfg, n_parts=n_parts).solve_batch(problems)
    launched = K.launch_counts()
    cpu = Solver(cfg, n_parts=n_parts, device="cpu").solve_batch(problems)
    for a, b in zip(card, cpu):
        assert a.state.tobytes() == b.state.tobytes()
        assert a.metrics.as_dict() == b.metrics.as_dict()
    assert launched["fused_superstep"] == launched["relax_push_gather"] == 0
    if impl == "fused":
        assert launched["fused_superstep_batch"] > 0
    if impl == "push":
        assert launched["relax_push_gather_batch"] > 0
    # a warm restart on the card after an improving drop and new sources
    solver = Solver(cfg, n_parts=n_parts)
    g.weight[::97] *= np.float32(0.5)
    warm = solver.resolve(card[0], graph=g, new_sources=MultiSource((3, 4)))
    cold = solver.solve(Problem(g, MultiSource((0, 3, 4))))
    assert warm.state.tobytes() == cold.state.tobytes()
    again = Solver(cfg, n_parts=n_parts, device="cpu").resolve(
        cpu[0], graph=g, new_sources=ExplicitSources(((3, 0.0, 0), (4, 0.0, 0))))
    assert again.state.tobytes() == warm.state.tobytes()
    assert again.metrics.as_dict() == warm.metrics.as_dict()


# ---------------------------------------------- adaptive, traced, quantized


def frontier_launches(trace, n_parts):
    """Launches of a frontier kernel a traced single-rank solve makes: one
    a superstep whose eligible rows fit its segment's frontier cap."""
    assert n_parts == 1
    steps, out = 0, 0
    for seg in trace.segments:
        rows = trace.rows[steps:steps + seg["supersteps"]]
        out += sum(r <= seg["frontier_cap"] for r in rows)
        steps += seg["supersteps"]
    return out


@pytest.mark.parametrize("spec,impl", [
    ("delta:5/sparse/trace", "fused"), ("delta:5/sparse/trace", "push"),
    ("delta:5/auto/trace", "fused"), ("delta:5/sparse/adapt:rho/trace", "fused"),
    ("delta:5/sparse/adapt:rho", "push"), ("kla:2+threadq/sparse/adapt", "ref"),
])
@pytest.mark.parametrize("n_parts", [1, 2])
def test_segment_solves_on_card_match_cpu(dev, spec, impl, n_parts):
    """Traced and adaptive solves on the card equal the CPU port's bit
    for bit (state, metrics, trace less its clocks), launching the
    frontier kernel on every superstep the trace says the push relax
    ran."""
    g = rmat1(10, seed=1)
    cfg = SolverConfig.from_spec(spec, relax_impl=impl, frontier_cap=32)
    K.reset_launch_counts()
    card = Solver(cfg, n_parts=n_parts).solve(Problem(g, SingleSource(0)))
    launched = K.launch_counts()
    cpu = Solver(cfg, n_parts=n_parts, device="cpu").solve(
        Problem(g, SingleSource(0)))
    assert card.state.tobytes() == cpu.state.tobytes()
    assert card.metrics.as_dict() == cpu.metrics.as_dict()
    if cfg.trace:
        a, b = card.trace.as_dict(), cpu.trace.as_dict()
        for d in (a, b):
            for seg in d["segments"]:
                del seg["t0"], seg["t1"]
        assert a == b
        card.trace.reconcile(card.metrics)
    name = {"fused": "fused_superstep", "push": "relax_push_gather"}.get(impl)
    if name is not None:
        assert launched[name] > 0
        if cfg.trace and n_parts == 1:
            assert launched[name] == frontier_launches(card.trace, 1)


@pytest.mark.parametrize("payload", ["bf16", "u16"])
@pytest.mark.parametrize("n_parts", [1, 2])
def test_quantized_solves_on_card_match_cpu(dev, payload, n_parts):
    g = rmat1(10, seed=1)
    g.weight[:] = np.random.default_rng(0).uniform(0.5, 60, g.m).astype(np.float32)
    cfg = SolverConfig.from_spec(f"delta:5/sparse/fused/q:{payload}",
                                 frontier_cap=64)
    K.reset_launch_counts()
    card = Solver(cfg, n_parts=n_parts).solve(Problem(g, SingleSource(0)))
    assert K.launch_counts()["fused_superstep"] > 0
    cpu = Solver(cfg, n_parts=n_parts, device="cpu").solve(
        Problem(g, SingleSource(0)))
    assert card.state.tobytes() == cpu.state.tobytes()
    assert card.metrics.as_dict() == cpu.metrics.as_dict()
    exact = Solver("delta:5/sparse/fused", n_parts=n_parts).solve(
        Problem(g, SingleSource(0)))
    assert card.state.tobytes() == exact.state.tobytes()


@pytest.mark.parametrize("seed", range(3))
def test_quantized_codes_on_card_match_cpu(dev, seed):
    """The u16 and bf16 encoders, the pair packing and the owner-side
    decode give the same bits on the card as on the CPU."""
    from repro_torch.core import frontier as F

    rng = np.random.default_rng(seed)
    P, S = 4, int(rng.integers(1, 300))
    v = rng.uniform(0, 1000, (P, S)).astype(np.float32)
    v[rng.random((P, S)) < 0.2] = np.inf
    lo = v.min(axis=1)
    v = np.where(rng.random((P, S)) < 0.1, lo[:, None], v).astype(np.float32)
    v[0] = np.inf
    lo = v.min(axis=1)
    lo = np.where(np.isfinite(lo), lo, 0).astype(np.float32)
    vc, lc = on(dev, v, lo)
    vh, lh = torch.as_tensor(v), torch.as_tensor(lo)
    assert torch.equal(F._quantize_bf16(vc, lc).cpu(), F._quantize_bf16(vh, lh))
    qc, sc = F._quantize_u16(vc, lc)
    qh, sh = F._quantize_u16(vh, lh)
    assert torch.equal(qc.cpu(), qh) and torch.equal(sc.cpu(), sh)
    assert torch.equal(F._decode_u16(qc, lc, sc).cpu(), F._decode_u16(qh, lh, sh))
    assert torch.equal(F._pack_u16_pairs(qc, S).cpu(), F._pack_u16_pairs(qh, S))
    C = np.where(rng.random(2 * 64) < 0.5, np.inf,
                 rng.uniform(0, 100, 2 * 64)).astype(np.float32)
    for payload in ("bf16", "u16"):
        pc, _ = F.sparse_payload(on(dev, C)[0][None], [], 2, 16, float("inf"), payload)
        ph, _ = F.sparse_payload(torch.as_tensor(C)[None], [], 2, 16, float("inf"),
                                 payload)
        assert torch.equal(pc.cpu(), ph)
        mc, _ = F.unpack_combine(pc, 64, 16, True, float("inf"), False, payload)
        mh, _ = F.unpack_combine(ph, 64, 16, True, float("inf"), False, payload)
        assert torch.equal(mc.cpu(), mh)


# ---------------------------------------- the process backend on the card

GLOO_SPECS = [("delta:5/sparse/fused", "fused"), ("delta:5/sparse", "push"),
              ("delta:5+threadq/a2a", "ref"), ("kla:2 > pod:dijkstra /pmin", "ref"),
              ("delta:5/sparse/q:u16", "fused")]


def gloo_rank(rank, world, url, out_dir):
    """A rank process on cuda:0: solve GLOO_SPECS over gloo, write the
    solutions and this rank's kernel launches."""
    from repro_torch.launch.mesh import init_ranks, make_rank_mesh

    torch.cuda.set_device(0)
    ranks = init_ranks("gloo", rank, world, make_rank_mesh(world), url)
    g = rmat1(12, seed=1)
    out = {}
    for spec, impl in GLOO_SPECS:
        K.reset_launch_counts()
        sol = Solver(SolverConfig.from_spec(spec, relax_impl=impl), n_parts=world,
                     device="cuda:0", ranks=ranks).solve(Problem(g, SingleSource(0)))
        torch.cuda.synchronize()
        out[spec] = (sol.state, sol.padded, sol.metrics.as_dict(),
                     dict(K.launch_counts()))
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


def test_gloo_ranks_on_card_match_stacked(dev, tmp_path):
    """Two gloo processes sharing cuda:0, one rank each, against the
    stacked solve at P = 2 on the card: the same state, padded state and
    metrics on both processes, each launching its frontier kernel."""
    from repro_torch.launch.mesh import spawn_ranks

    spawn_ranks(gloo_rank, 2, ("file://" + str(tmp_path / "store"), str(tmp_path)),
                timeout=600)
    runs = []
    for r in range(2):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            runs.append(pickle.load(f))
    g = rmat1(12, seed=1)
    for spec, impl in GLOO_SPECS:
        want = Solver(SolverConfig.from_spec(spec, relax_impl=impl), n_parts=2,
                      device="cuda").solve(Problem(g, SingleSource(0)))
        for r in range(2):
            state, padded, metrics, launches = runs[r][spec]
            assert state.tobytes() == want.state.tobytes(), (spec, r)
            assert padded.tobytes() == want.padded.tobytes(), (spec, r)
            assert metrics == want.metrics.as_dict(), (spec, r)
            if impl == "fused":
                assert launches["fused_superstep"] > 0, (spec, r)
            if impl == "push":
                assert launches["relax_push_gather"] > 0, (spec, r)


# ------------------------------------------- analyze and roofline on the card


@pytest.mark.parametrize("n_parts", [1, 4])
@pytest.mark.parametrize("spec,impl,processing", [
    ("delta:5/sparse/fused", "fused", "sssp"), ("delta:5/sparse", "push", "sssp"),
    ("delta:5/a2a", "ref", "sssp"), ("delta:5/pmin", "ref", "sssp"),
    ("kla:2+buffer/sparse/fused", "fused", "sssp"),
    ("delta:5/sparse/fused", "fused", "bfs"),
    ("delta:5/sparse/fused/q:u16", "fused", "sssp"),
])
def test_engine_lint_on_card_matches_cpu(dev, spec, impl, processing, n_parts):
    """The engine lint's run on the card: the same supersteps, host
    reads, collectives, charged bytes and findings as on the CPU; a
    kernel spec's kernel launched on the card exactly where the CPU run
    called its op."""
    from repro_torch.analyze import engine_lint
    from repro_torch.analyze.findings import fingerprint
    from repro_torch.api import get_processing

    cfg = SolverConfig.from_spec(spec, relax_impl=impl).engine_config(
        get_processing(processing))
    shape = engine_lint.StepShape()
    runs = {}
    for d in ("cuda", "cpu"):
        K.reset_launch_counts()
        runs[d] = engine_lint.run_step(cfg, shape, n_parts, d)
    card, cpu = runs["cuda"], runs["cpu"]
    assert card.error is None and cpu.error is None
    for field in ("supersteps", "host_reads", "collectives", "payloads", "f64_ops",
                  "hbm_bytes"):
        assert getattr(card, field) == getattr(cpu, field), field
    assert (card.kernel_calls > 0) == (cpu.kernel_calls > 0)
    assert card.kernel_calls == cpu.kernel_calls
    sh = dataclasses.replace(shape, n_parts=n_parts)
    assert sorted(map(fingerprint, engine_lint.lint_run(cfg, card, sh))) == \
        sorted(map(fingerprint, engine_lint.lint_run(cfg, cpu, sh)))


@pytest.mark.parametrize("spec,impl", [("delta:5/sparse/fused", "fused"),
                                       ("delta:5/sparse", "push"),
                                       ("delta:5/a2a", "ref")])
def test_superstep_profile_on_card(dev, spec, impl):
    """Charged bytes on the card equal the CPU's; the card adds device
    time, the bound and its share, and the kernel's launches."""
    from repro_torch.api import get_processing
    from repro_torch.roofline import superstep_profile

    cfg = SolverConfig.from_spec(spec, relax_impl=impl).engine_config(
        get_processing("sssp"))
    shape = {"n_local": 256, "width": 16, "n_parts": 2}
    card = superstep_profile(cfg, shape, "cuda")
    cpu = superstep_profile(cfg, shape, "cpu")
    for key in ("supersteps", "hbm_bytes_total", "hbm_by_op",
                "collective_counts", "exchange_payload_bytes_per_superstep"):
        assert card[key] == cpu[key], key
    assert card["device_ms"] > 0 and card["wall_s"] > 0
    assert card["bound_ms"] == max(card["t_memory_ms"], card["t_collective_ms"])
    assert 0 < card["bound_share"] == card["bound_ms"] / card["device_ms"]
    kernel = {"fused": "fused_superstep", "push": "relax_push_gather"}.get(impl)
    if kernel:
        assert card["launches"][kernel] == card["kernel_calls"][f"{kernel}/cuda"]
        assert cpu["kernel_calls"][f"{kernel}/ref"] == card["launches"][kernel]
    else:
        assert not card["launches"]


def test_recorder_counts_host_reads_and_routes_on_card(dev):
    from repro_torch.roofline import OpRecorder

    x = torch.arange(16, dtype=torch.float32, device=dev)
    with OpRecorder() as rec:
        vals = (x * 2).tolist()
        flag = bool(x.sum() > 0)
    assert len(vals) == 16 and flag
    assert rec.host_reads == ["tolist", "__bool__"]
    g = rmat1(10, seed=3)
    K.reset_launch_counts()
    Solver("delta:5/sparse/fused", device="cuda").solve(Problem(g, SingleSource(0)))
    calls = K.call_counts()["fused_superstep"]
    assert calls["ref"] == 0 and calls["cuda"] == K.launch_counts()["fused_superstep"] > 0


@pytest.mark.parametrize("n_parts", [1, 4])
def test_cell_plan_bytes_equal_the_resident_partition_on_card(dev, n_parts):
    """The SSSP plan at a real partition's shape: its argument bytes equal
    the ELL and state a solve holds on the card, row_deg the rest of the
    resident plan (rmat1 scale 12, the reduced cells' W 8)."""
    from repro_torch.configs.cells import sssp_plan
    from repro_torch.core.engine import initial_state, sssp_sources
    from repro_torch.core.processing import SSSP
    from repro_torch.graph import partition_graph
    from repro_torch.launch.dryrun import superstep_peak

    pg = partition_graph(rmat1(12, seed=0), n_parts, width=8)
    cfg = SolverConfig.from_spec("delta:5/sparse/fused")
    plan = sssp_plan("sssp", "rmat1_s12", cfg, n_parts=n_parts, n_local=pg.n_local,
                     rows=pg.rows_per_rank, width=pg.width)
    ell = pg.to(dev)
    state = on(dev, *initial_state(pg, SSSP, sssp_sources(0)))
    size = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    assert all(t.is_cuda for t in list(ell) + state)
    assert size([ell.row_src, ell.col, ell.wgt] + state) == plan.arg_bytes
    assert size(list(ell) + state) == n_parts * superstep_peak(plan)["resident"]
    sol = Solver(cfg, n_parts=n_parts, device="cuda").solve(Problem(pg, SingleSource(0)))
    assert sol.metrics.converged


# ---------------------------------------------------------------- #
# EGNN, MACE and DimeNet: the vertex sum over segment ELLs


def segment_ells(dev, T, n, seed, padding=False):
    """A segment index of T rows into n segments, a third masked, one
    segment of T // 4 rows (several ELL rows: the split path), some
    segments empty; with ``padding`` the masked rows all in segment 0,
    as a sampled block's padding: its segment ELL (live rows only) and
    W = 1 transpose on the card."""
    from repro_torch.models.gnn import build_segment_ell, build_segment_transpose

    r = np.random.default_rng(seed)
    index = r.integers(0, n, T)
    index[: T // 4] = n // 3
    mask = r.random(T) > 0.33
    if padding:
        index[~mask] = 0
    index, mask = on(dev, index.astype(np.int32), mask)
    return (index, mask, build_segment_ell(index, mask, n),
            build_segment_transpose(index, mask, n))


# the d of each new shape (EGNN messages 64, coordinates 3, MACE's 9 x 128
# density, DimeNet's 128), over edges into nodes (T < n) and triplets
# into edges (T = 2n)
@pytest.mark.parametrize("d", [64, 3, 1152, 128])
@pytest.mark.parametrize("T,n", [(6000, 7000), (8000, 4000)])
@pytest.mark.parametrize("split_rows", [None, 1])
@pytest.mark.parametrize("padding", [False, True])
def test_segment_vertex_sum_bit_identical(dev, d, T, n, split_rows, padding, monkeypatch):
    from repro_torch.kernels.spmm_ell import kernel

    if split_rows is not None:
        monkeypatch.setattr(kernel, "SPLIT_ROWS", split_rows)
    index, mask, fwd, tr = segment_ells(dev, T, n, seed=d + T, padding=padding)
    assert int(fwd.deg.sum()) == int(mask.sum())  # no slot for a masked row
    r = np.random.default_rng(d)
    (x,) = on(dev, r.normal(size=(T, d)).astype(np.float32))
    x = x * mask[:, None]
    K.reset_launch_counts()
    out = K.spmm_ell_vertex_cuda(x, fwd.col, fwd.wgt, fwd.row_ptr, fwd.deg)
    torch.cuda.synchronize()
    assert K.launch_counts()["spmm_ell"] == 1 and out.shape == (n, d)
    assert K.launch_shapes()["spmm_ell"] == {(T, n, fwd.col.shape[1], d): 1}
    assert bits_equal(out, K.spmm_ell_vertex_ref(x, fwd.col, fwd.wgt, fwd.row_ptr, fwd.deg))
    torch.testing.assert_close(out, torch.zeros_like(out).index_add_(0, index, x),
                               rtol=0, atol=1e-5 * float(out.abs().max()))
    # the W = 1 transpose: the masked gather, +0 where the product is -0
    (g,) = on(dev, r.normal(size=(n, d)).astype(np.float32))
    back = K.spmm_ell_vertex_cuda(g, tr.col, tr.wgt, tr.row_ptr, tr.deg)
    assert bits_equal(back, g.index_select(0, index) * mask[:, None].float() + 0.0)


@pytest.mark.parametrize("d", [64, 3, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("padding", [False, True])
def test_gather_rows_backward_on_card(dev, d, dtype, padding):
    """``gather_rows`` on the kernel route: the forward is index_select
    and launches nothing; the backward, for a gradient that is 0 at the
    masked rows, is one vertex-sum launch over the segment ELL, bit for
    bit the plain version's on the CPU, the same bits twice, and within
    1e-5 of ``index_select``'s own (f32) gradient."""
    from repro_torch.models.gnn import gather_rows

    index, mask, fwd, _ = segment_ells(dev, 8000, 4000, seed=d, padding=padding)
    r = np.random.default_rng(d + 1)
    x0, g0 = on(dev, r.normal(size=(4000, d)).astype(np.float32),
                r.normal(size=(8000, d)).astype(np.float32))
    x0, g0 = x0.to(dtype), (g0 * mask[:, None]).to(dtype)
    grads = []
    for device in (dev, dev, torch.device("cpu")):
        x = x0.to(device).requires_grad_(True)
        ix, mk = index.to(device), mask.to(device)
        K.reset_launch_counts()
        out = gather_rows(x, ix, mk)
        assert torch.equal(out, x.detach().index_select(0, ix))
        (grad,) = torch.autograd.grad(out, x, g0.to(device))
        if device.type == "cuda":
            torch.cuda.synchronize()
            assert K.launch_counts()["spmm_ell"] == 1
        assert grad.dtype == dtype
        grads.append(grad.float().cpu())
    assert bits_equal(grads[0], grads[1]) and bits_equal(grads[0], grads[2])
    if dtype == torch.float32:
        x = x0.clone().requires_grad_(True)
        (want,) = torch.autograd.grad(x.index_select(0, index), x, g0)
        torch.testing.assert_close(grads[0], want.cpu(), rtol=0,
                                   atol=1e-5 * float(want.abs().max()))


def test_dimenet_bf16_backward_repeats_on_card(dev):
    """DimeNet at full width with bf16 messages (the minibatch_lg
    config) on a padded graph (masked edges 0 -> 0 and triplets of them,
    masked triplet slots): the kernel route's gradients bit for bit over
    two backward passes from the same params (its gathers' backward is
    the vertex sum, no atomics)."""
    from repro_torch.graph import Graph
    from repro_torch.models.gnn import dimenet
    from repro_torch.train.train_step import value_and_grad

    cfg = get_arch("dimenet").make_config(False, "minibatch_lg")
    g = rmat1(11, seed=3)
    pad = np.zeros(4096, np.int32)
    padded = Graph(g.n, np.concatenate([g.src, pad]), np.concatenate([g.dst, pad]),
                   np.ones(g.m + pad.size, np.float32))
    batch = gnn_flat_batch(padded, cfg.d_in, cfg.n_classes, coords=True, triplets=True,
                           triplet_cap=2, seed=4)
    batch["edge_mask"][g.m:] = False
    for k in ("tri_kj", "tri_ji", "tri_mask"):
        batch[k] = np.concatenate([batch[k], np.zeros(4096, batch[k].dtype)])
    b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    params = dimenet.init_params(generator(0, dev), cfg)
    grad = value_and_grad(lambda p, bb: dimenet.node_classification_loss(p, bb, cfg))
    (l1, g1), (l2, g2) = grad(params, b), grad(params, b)
    assert float(l1) == float(l2) and np.isfinite(float(l1))
    for a, c in zip(torch.utils._pytree.tree_leaves(g1), torch.utils._pytree.tree_leaves(g2)):
        assert bits_equal(a.float(), c.float())


@pytest.mark.parametrize("name", ["egnn", "mace", "dimenet"])
def test_zoo_molecule_step_on_card_matches_cpu(dev, name):
    """One step of the full-width molecule cell's plan (128 graphs as one
    block-diagonal graph) on the card through the kernel route against
    the same step on the CPU: spmm_ell launches 8L - 5 (EGNN), 3L (MACE)
    or 5B + 2 (DimeNet), the sums forward and backward and the gathers'
    backward; loss within 1e-5 of |loss|, params within 1e-5 (an update
    is about lr = 3e-4; both sum in another order)."""
    from repro_torch.data import molecule_batch
    from repro_torch.models import gnn
    from repro_torch.train import TrainConfig, init_train_state

    arch, model = get_arch(name), getattr(gnn, name)
    plan, cfg = arch.make_cell("molecule"), arch.make_config(False, "molecule")
    batch = molecule_batch(0, 128, 30, 64, triplets=name == "dimenet", seed=1)
    params = model.init_params(generator(0, "cpu"), cfg)
    L = cfg.n_blocks if name == "dimenet" else cfg.n_layers
    want = {"egnn": 8 * L - 5, "mace": 3 * L, "dimenet": 5 * L + 2}[name]
    tmap = torch.utils._pytree.tree_map
    out = {}
    for device in (dev, torch.device("cpu")):
        p = tmap(lambda t: t.to(device), params)
        b = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        K.reset_launch_counts()
        p, _, m = plan.fn(p, init_train_state(p, TrainConfig()), b, 0)
        if device.type == "cuda":
            torch.cuda.synchronize()
            assert K.launch_counts()["spmm_ell"] == want
        out[device.type] = (float(m["loss"]), tmap(lambda t: t.cpu(), p))
    (lc, pc), (lh, ph) = out["cuda"], out["cpu"]
    assert np.isfinite(lc) and abs(lc - lh) <= 1e-5 * abs(lh)
    for a, b in zip(torch.utils._pytree.tree_leaves(pc), torch.utils._pytree.tree_leaves(ph)):
        assert float((a - b).abs().max()) <= 1e-5


def test_segment_sum_refuses_the_raw_kernel_under_autograd(dev):
    """Outside VertexSum a grad-requiring input still raises on the card;
    through segment_sum it differentiates (the backward launches the
    kernel over the transpose)."""
    from repro_torch.models.gnn import segment_sum

    index, mask, fwd, _ = segment_ells(dev, 500, 200, seed=3)
    x = torch.randn((500, 8), device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="VertexSum"):
        K.vertex_sum(x, fwd.col, fwd.wgt, fwd.row_ptr, fwd.deg)
    K.reset_launch_counts()
    (grad,) = torch.autograd.grad(segment_sum(x, index, mask, 200).sum(), x)
    torch.cuda.synchronize()
    assert K.launch_counts()["spmm_ell"] == 2
    assert bits_equal(grad, mask[:, None].float().expand(500, 8) + 0.0)
