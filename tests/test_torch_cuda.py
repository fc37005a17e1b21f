"""The port's CUDA kernels, its solve, its serving paths and GIN
inference on the card, held against the plain torch versions on the
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

from repro_torch import kernels as K
from repro_torch.api import Problem, SingleSource, Solver, SolverConfig
from repro_torch.configs import get_arch
from repro_torch.core.selfstab import synchronous_sweep
from repro_torch.data import gnn_flat_batch, lm_batch, mind_batch
from repro_torch.graph import rmat1, small_world_graph
from repro_torch.models import lm, mind
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
