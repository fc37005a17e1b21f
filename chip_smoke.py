#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU, at the sizes its users run on one card: SSSP on rmat1
(Graph500 R-MAT, weights 1..100) at scale 20, seed 0, one rank; LM
serving of minitron-8b at full width (32 layers, 7.73 B parameters,
random weights from the seed); MIND serving at full width (2^20 items,
2^17 profile ids); GIN inference (gin-tu at full width) on rmat1 at
scale 21, the size of ogb-products.

    python3 chip_smoke.py
    python3 chip_smoke.py --trace-spread 3   # phase 12(a)'s timing alone

Phases (any failure exits non-zero):

  1. card name and power limit; build the CUDA kernels from csrc/
  2. generate and partition the graph, copy it to the card, and solve
     the Dijkstra oracle (scipy) for source 0
  3. each min-plus kernel against its plain torch version on the card
     at the main path's shapes: bit-identical, timed with CUDA events;
     the two frontier kernels at two frontiers of the main path (the
     delta class with the most live rows, and the median one)
  4. the main path: Solver("delta:5/sparse/fused").solve(...) equals
     the oracle, converges, and launches fused_superstep; one warm
     solve under torch.profiler (device time by kernel, busy share)
  5. the push path (relax_impl="push"): same state and metrics as 4,
     launches relax_push_gather; one warm solve profiled as in 4
  6. the self-stabilizing sweep from a corrupted state (made from the
     seed) stabilizes to the oracle, launching relax_ell
  7. flash_attention and embedding_bag against their plain versions on
     the card at the serving paths' shapes, timed with CUDA events
     beside one PyTorch call computing the same function; attention
     also as achieved TFLOP/s and share of its bound, and the kernels
     that sdpa ran (its backend), at the bf16 prefill shapes, the f32
     case c (the f32 kernel's key split) and case d (the fp32 twin's
     prefill of phase 8); the bag also as a bare launch, alone under
     torch.profiler and its index check apart
  8. LM serving, minitron-8b in bf16: prefill of 4 x 1920 tokens
     through the attention kernel (32 launches), 128 greedy decode
     steps; logits against the plain attention; then in fp32, the last
     decode step against a teacher-forced prefill of the grown sequence
  9. MIND serving: serve_interests at B=512 and B=262,144 and
     retrieval_scores over all 2^20 items, through the embedding-bag
     kernel, against the plain bag; each call's bag of profiles bit for
     bit against the in-order sum
 10. GIN inference: spmm_ell's row entry against its plain version (in
     row chunks) at the layer shapes (d = 100 and 64) and at the Cora
     shape (d = 1433), timed beside torch.sparse.mm, and as a bare
     launch beside the wrapper and its index check; its vertex sum, the
     forward's, bit for bit against its plain in-order version (in
     vertex chunks) at d = 100 and 64, timed through the wrapper, bare,
     alone under the profiler and beside torch.sparse.mm on the (n, n)
     CSR; gin-tu forwards through the vertex sum (5 launches each, no
     index_add_) on rmat1 scale 21 with 100 features; logits against
     the plain segment-sum route
 11. the SSSP query service on a copy of phase 2's graph
     (``delta:5/sparse/fused``): a landmark tier of 8 hubs (one
     solve_batch, each lane against Dijkstra), 200 Zipf-skewed queries
     through the Router (batches of misses through solve_batch, the
     batched fused_superstep entry once a superstep for all lanes),
     8 sampled answers against Dijkstra, a warm batch of 8 against 8
     warm single solves, the push batch against the fused lanes, then 4
     improving edge updates refreshed by warm restarts (resolve), 3
     refreshed entries and a landmark against cold solves and Dijkstra
 12. adaptive execution on phase 2's graph: (a) the flight recorder
     (``/trace``) on the main and push paths, state and metrics equal to
     phases 4 and 5, the trace reconciling, one launch a push superstep,
     warm wall within 1.15x of the untraced solve's (the median of the
     per-pair ratios of 9 back-to-back untraced and traced warm solves),
     host reads at most the untraced solve's plus one a segment
     (torch.cuda.set_sync_debug_mode); (b) ``/adapt:rho`` from
     frontier_cap 1024 (equals Dijkstra, grows the cap) and
     ``/adapt:static`` (equals phase 4); (c) ``/q:bf16`` and ``/q:u16``
     (equal Dijkstra after the repair loop); (d) the auto-tuner
     (objective wall, default grid) and 50 Zipf queries through
     ``Router(tuned=...)``, 8 sampled answers against Dijkstra
 13. the engine across processes on phase 2's graph: (a) stacked ranks,
     P = 4 on a flat mesh and on a (2, 2) pod mesh, main spec and
     ``delta:5 > pod:dijkstra /a2a``, each equal to Dijkstra; (b) gloo,
     2 and 4 rank processes sharing the card, each holding only its
     rank's ELL: /sparse/fused, /sparse (push), /a2a, /pmin and /q:u16
     bit-identical to the stacked solve at the same P (state, padded
     state, metrics) and to Dijkstra, every process returning the same
     solution, each rank launching its frontier kernel once a superstep
     whose frontier fits its cap; warm walls (gloo through host memory
     on one card, not a scaling figure); (c) NCCL, one process, equal
     to phase 4
 14. resolve and the query service across processes on phase 2's
     graph, gloo processes sharing the card: (a) at P = 2 and 4,
     ``resolve`` after phase 11's first improving update and after
     adding a source, bit-identical to the stacked resolve at the same
     P (state, padded state, metrics) and to a cold solve's state, warm
     walls beside the stacked ones; (b) at P = 2 the query service at
     the reference service CLI's defaults (phase 11's mix, landmarks,
     cache and 4 improving updates), rank 0 serving and the other rank
     following: every answer equal to the stacked service's on the same
     mix, the cache, router, landmark and feed counters equal on every
     rank, refreshed entries equal to cold solves; q/s, p50/p99, flush
     and update walls, broadcasts a flush and each rank's peak card
     memory; then rank 0 holds the batched fused and push entries at
     its largest superstep (its share of the ELL) against their plain
     versions and times them (wrapper, bare, alone, bound); (c)
     ``launch.sssp --root delta:5 --variant buffer --exchange sparse
     --partition ebal --verify`` on phase 2's graph equals Dijkstra and
     prints its load-balance lines
 15. the port's static-analysis gate and the superstep roofline on
     phase 2's graph: (a) ``run_report`` on the quick grid at 4 stacked
     ranks on the card with the repository's baseline: the gate passes,
     its fingerprints and host reads equal the same report's on the CPU,
     every /fused point that names no fused-kernel escape launched its
     kernel; the engine lint reports the escapes of
     ``kla:2+buffer/sparse/fused`` and of bfs at the main spec, not the
     main spec; ``python -m repro_torch.launch.analyze --quick --ranks 4``
     exits 0; (b) ``superstep_profile`` at the superstep with the largest
     frontier for the main spec, push and ``delta:5/a2a`` (charged bytes
     by op, the kernel's closed form, device time, the memory bound and
     its share), then over one whole warm main solve
 16. the cells, the dry-run and the paper's experiment drivers: (a)
     ``python -m repro_torch.launch.dryrun --all --ranks 1 4``, one line
     a cell (argument bytes, peak plan, fits one card or not); (b) the
     SSSP plan at phase 2's partition shape: its argument bytes equal
     the resident ELL and state, its superstep peak within 15% of
     ``torch.cuda.max_memory_allocated()`` over a warm solve of the main
     spec and of ``delta:5/a2a``; (c) ``bench.variants --quick --scale
     20 --source hub`` (rmat1, seed 7, 27 points on 8 stacked ranks,
     from the vertex of most out-edges: vertex 0, the JAX package's
     source, is isolated in that graph); (d)
     ``bench.table1`` and ``bench.scaling`` at the JAX package's sizes;
     every row equal to Dijkstra

Phase 3 also holds the two frontier kernels' batched entries against
their plain versions and against 8 single launches at two supersteps of
a real batched solve (8 lanes): the balanced one (every lane near F)
and the skewed one (lanes at 0 beside a lane near F), and times the
fused entry beside its atomics floor (``scripts/frontier_variants.cu``).

It prints one JSON line of per-kernel numbers and, last, the device
line ``{"ok": true, "device": {...}}``.  Without a card, or without the
repository beside it, it fails before printing any result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SCALE = 20
SEED = 0
SOURCE = 0
SPEC = "delta:5/sparse/fused"
TIMING_REPS = 20
# LM serving (phase 8): minitron-8b, prompts from lm_batch
LM_ARCH = "minitron-8b"
LM_BATCH, LM_PROMPT, LM_MAX_LEN, LM_DECODE = 4, 1920, 2048, 128
LM_F32_BATCH = 2
LM_PROFILED_STEPS = 8
# kernel path vs plain attention in bf16, as a share of max |logit|:
# the plain path rounds p to bf16 before p @ v, the kernel keeps p in
# f32, so the two differ about as much as a bf16 model from its f32
# twin (1.4% and 1.8% of max |logit| at 8 and 16 layers of a d=512
# model on the CPU); the bound leaves room for 32 layers
LM_BF16_TOL = 5e-2
LM_F32_RTOL, LM_F32_ATOL = 2e-3, 5e-4   # the JAX package's decode test
# flash_attention vs its plain version: the JAX package's kernel-test
# tolerances, and in bf16 also one bf16 ulp (<= 2**-7 of the value):
# both compute in f32 and round once
ATTN_TOL = {"bfloat16": 2e-2, "float32": 2e-5}
ATTN_BF16_RTOL, ATTN_BF16_ATOL = 1e-2, 2e-3
# MIND serving (phase 9)
MIND_SERVE = (("serve_p99", 512), ("serve_bulk", 262_144))
# kernel-path vs plain-bag outputs, as a share of the plain one's max
# |value|: the 0.02-scale tables make interests ~1e-5 and scores ~1e-6
MIND_REQUESTS, MIND_TOPK, MIND_REL_TOL = 32, 5, 1e-5
# GIN inference (phase 10): gin-tu at ogb_products widths on rmat1 at
# scale 21 (n 2,097,152, m 63,538,872; ogb-products: 2,449,029 and
# 61,859,140); the Cora-sized full_graph_sm graph for the d = 1433 shape
GIN_SCALE, GIN_CELL, GIN_WARM = 21, "ogb_products", 3
CORA_N, CORA_AVG_DEGREE = 2708, 2.0
# rows a step of the plain spmm_ell takes: it gathers (rows, W, d); and
# vertices a step of the plain vertex sum takes
SPMM_CHUNK_ROWS = 1 << 16
SPMM_CHUNK_VERTICES = 1 << 18
# kernel vs plain sum, as a share of max |out|: f32 sums of W <= 64
# products in another order (the kernel in slot order, torch.sum by its
# tree) differ by at most (W - 1) 2^-24 of the sum of |terms|
SPMM_SUM_TOL = 1e-5
# kernel-route logits vs the plain segment-sum route, node by node, as a
# share of the node's max |logit|: both sum f32 messages in another order
# (64-slot rows then their sum; atomic adds).  A sum of k terms taken in
# another order differs by about sqrt(k) 2^-24 of its size: 1.9e-5 at
# the largest in-degree, 102,632; the bound leaves 5x for the 5 layers
GIN_LOGIT_TOL = 1e-4
# the query service (phase 11): the reference service CLI's defaults
SERVE_QUERIES, SERVE_ZIPF, SERVE_LANDMARKS = 200, 1.3, 8
SERVE_MAX_BATCH, SERVE_MAX_WAIT_S, SERVE_CACHE_MB = 8, 0.010, 256
SERVE_UPDATES = 4
SERVE_SAMPLED = 8   # single-source answers held against Dijkstra
SERVE_FRESH = 3     # refreshed cache entries held against cold solves
# adaptive execution, the flight recorder, quantized exchange and the
# auto-tuner (phase 12): the reference's `launch/obs.py record` gate
TRACE_GATE = 1.15
TRACE_PAIRS = 9     # back-to-back (untraced, traced) pairs; the gate reads their median
TRACE_REPEATS = 3   # warm solves in turns (min) beside the other adaptive paths
ADAPT_CAP0 = 1024   # /adapt:rho starts here and grows the cap
TUNED_QUERIES = 50
TUNED_SAMPLED = 8
# the engine across processes (phase 13)
DIST_PROCESSES = (2, 4)
DIST_SPECS = ((SPEC, "fused"), ("delta:5/sparse", "push"), ("delta:5/a2a", "ref"),
              ("delta:5/pmin", "ref"), (SPEC + "/q:u16", "fused"))
POD_SPEC = "delta:5 > pod:dijkstra /a2a"
DIST_TIMEOUT_S = 300
NCCL_BACKEND = "nccl"
# resolve and the query service across processes (phase 14): (a) at
# RESOLVE_PROCESSES, (b) the service at SERVICE_PROCESSES
RESOLVE_PROCESSES = (2, 4)
SERVICE_PROCESSES = 2
SERVICE_TIMEOUT_S = 900
# the static-analysis gate and the superstep profile (phase 15)
GATE_RANKS = 4
GATE_ESCAPES = (("kla:2+buffer/sparse/fused", "sssp"), (SPEC, "bfs"))
GATE_TIMEOUT_S = 300
PROFILE_SPECS = ((SPEC, "fused"), ("delta:5/sparse", "push"), ("delta:5/a2a", "ref"))
# the cells, the dry-run and the experiment drivers (phase 16)
DRYRUN_RANKS = (1, 4)
PEAK_SPECS = (SPEC, "delta:5/a2a")
PEAK_BAND = 0.15    # the superstep peak plan against the card's peak
BENCH_SCALE = 20
DRIVERS_TIMEOUT_S = 300


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"[smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, flush, reps: int = TIMING_REPS) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, each after an
    untimed write that evicts the 50 MB L2 (the engine calls these
    kernels once per superstep, between other passes)."""
    import torch

    fn()  # warm-up
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def kernel_alone_ms(fn, flush, names: tuple[str, ...]) -> float:
    """The kernels' own device time per call of ``fn`` under
    torch.profiler, TIMING_REPS calls each after a write that evicts L2:
    the time of every kernel whose name holds one of ``names``, over the
    launches of the first (a window can lose its first kernels, so the
    window opens with untimed writes and counts what it recorded; one
    that lost them all is opened again, three windows at most)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(8):
                flush.zero_()
            for _ in range(TIMING_REPS):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        calls = sum(e.count for e in events if names[0] in e.key)
        if calls:
            mine = [e for e in events if any(name in e.key for name in names)]
            return sum(e.self_device_time_total for e in mine) / 1e3 / calls
    fail(f"three profiler windows recorded no launch of {names[0]}")


def max_abs_err(a, b) -> float:
    """0.0 when bit-identical; else the largest difference (inf where
    only one side is infinite)."""
    import torch

    if torch.equal(a, b):
        return 0.0
    fin = torch.isfinite(a) & torch.isfinite(b)
    if not torch.equal(torch.isfinite(a), torch.isfinite(b)):
        return float("inf")
    return float((a[fin] - b[fin]).abs().max())


@contextlib.contextmanager
def device_profile(label: str, top: int = 6, kernel: str | None = None):
    """Log device time by kernel over the block (torch.profiler): the
    total, its share of the block's wall time, the top kernels and, if
    ``kernel`` is given, the total over the launches of the kernels
    whose name holds it.  Yields a list that holds, after the block, the
    names of every operator and kernel the profiler recorded."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    seen: list[str] = []
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield seen
    wall_ms = (time.perf_counter() - t0) * 1e3
    seen += [e.key for e in prof.key_averages()]
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"profile, {label}: {total:.3f} ms of device time in {wall_ms:.3f} ms "
        f"profiled wall (busy share {total / wall_ms:.3f})")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        ms = e.self_device_time_total / 1e3
        log(f"  {ms:10.3f} ms {ms / max(total, 1e-9):6.1%} x{e.count:<5} {e.key[:90]}")
    if kernel is not None:
        mine = [e for e in kernels if kernel in e.key]
        ms = sum(e.self_device_time_total for e in mine) / 1e3
        n = sum(e.count for e in mine)
        log(f"  {kernel}: {ms:.3f} ms over {n} launches "
            f"({ms / max(n, 1):.4f} ms each, {ms / max(total, 1e-9):.1%} of device time)")


def rel_err(a, b) -> float:
    """Largest difference as a share of b's largest magnitude."""
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


ATTN_CASES = (
    # label, B, Hq, Hkv, Sq, Sk, D, dtype name, causal
    ("a minitron prefill", 4, 32, 8, 2048, 2048, 128, "bfloat16", True),
    ("a' minitron prefill, smoke prompt", 4, 32, 8, 1920, 1920, 128, "bfloat16", True),
    ("b phi3-mini prefill", 1, 32, 32, 2048, 2048, 96, "bfloat16", True),
    ("c bf16 causal, Sq < Sk", 1, 8, 2, 128, 1024, 128, "bfloat16", True),
    ("c f32 causal, Sq < Sk", 1, 8, 2, 128, 1024, 128, "float32", True),
    ("c f32 non-causal, Sq < Sk", 1, 8, 2, 128, 1024, 128, "float32", False),
    # the fp32 twin's prefill of phase 8 at S 2048; (c) engages the f32
    # kernel's key split
    ("d fp32 twin prefill", 2, 32, 8, 2048, 2048, 128, "float32", True),
)
# the cases whose numbers stand in the kernels line, with the row's name
# and source: the path's shapes, minitron's prefill at max_len (bf16)
# and its fp32 twin's (f32)
ATTN_ROWS = {
    "a minitron prefill": ("flash_attention", "src/repro_torch/csrc/flash_attention_sm90.cu"),
    "d fp32 twin prefill": ("flash_attention f32", "src/repro_torch/csrc/flash_attention.cu"),
}


def profiled_solve(solver, problem, kernel: str) -> None:
    """One warm solve timed alone, then one under torch.profiler: device
    time by kernel, the busy share and ``kernel``'s total."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver.solve(problem)
    torch.cuda.synchronize()
    log(f"warm solve, {solver.config.name}: wall {time.perf_counter() - t0:.4f} s")
    with device_profile(f"one warm solve, {solver.config.name}", top=10, kernel=kernel):
        solver.solve(problem)
        torch.cuda.synchronize()


def sssp_frontiers(g, pg, ell, truth_t, row_cap: int) -> list[dict]:
    """Two real frontiers of the main path, each with the state committed
    up to its class (the exact order the delta-stepping root runs): the
    delta=5 class with the most virtual rows that still fits row_cap,
    and the class with the median row count among those that fit."""
    import torch

    from repro_torch.core import DeltaStepping
    from repro_torch.core.frontier import compact_rows

    dev = truth_t.device
    cls = DeltaStepping(5.0).class_key(truth_t, None)
    rs = ell.row_src[0]
    row_cls = cls[rs.long().clamp(max=g.n - 1)]
    row_cls[rs.long() >= g.n] = float("inf")
    counts = torch.bincount(row_cls[torch.isfinite(row_cls)].long())
    fits = torch.nonzero((counts > 0) & (counts <= row_cap)).flatten()
    by_size = fits[torch.argsort(counts[fits], stable=True)]
    out = []
    for label, c in (("largest", int(by_size[-1])),
                     ("median", int(by_size[(len(by_size) - 1) // 2]))):
        dist = torch.where(cls <= c, truth_t, float("inf"))
        dist = torch.cat([dist, torch.full((1,), float("inf"), device=dev)])
        f_idx, f_cnt, over = compact_rows((row_cls == c)[None], row_cap)
        if bool(over.any()):
            fail(f"frontier selection overflowed row_cap ({label})")
        live = int(f_cnt[0])
        n_src = int(torch.unique(rs[f_idx[0, :live].long()]).numel())
        out.append(dict(label=label, cls=c, dist=dist, f_idx=f_idx[0].contiguous(),
                        f_cnt=f_cnt[0], live=live, n_src=n_src))
    return out


def library_kernels(fn) -> str:
    """The names of the kernels one call of ``fn`` launched, under
    torch.profiler: which backend a PyTorch call took."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA}
    return "; ".join(sorted(name[:100] for name in names)) or "none recorded"


def serving_kernels(dev, flush) -> tuple[dict, dict, dict]:
    """Phase 7: flash_attention and embedding_bag against their plain
    versions at the serving paths' shapes.  Returns their rows of the
    kernels line, attention's bf16 kernel at case (a) and its f32 kernel
    at case (d) (launches filled in by phases 8 and 9)."""
    import torch
    import torch.nn.functional as F

    from repro_torch import kernels as K
    from repro_torch.configs import get_arch
    from repro_torch.data import mind_batch
    from repro_torch.roofline import BF16_OPS_PER_S, F32_OPS_PER_S, bound
    from repro_torch.roofline.kernels import (
        embedding_bag_traffic,
        flash_attention_traffic,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    attn_rows = {}
    for label, B, Hq, Hkv, Sq, Sk, D, dtype_name, causal in ATTN_CASES:
        dtype = getattr(torch, dtype_name)
        q = randn((B, Hq, Sq, D), dtype)
        k, v = randn((B, Hkv, Sk, D), dtype), randn((B, Hkv, Sk, D), dtype)
        K.reset_launch_counts()
        out = K.flash_attention_cuda(q, k, v, causal=causal)
        torch.cuda.synchronize()
        if K.launch_counts()["flash_attention"] != 1:
            fail(f"flash_attention ({label}): the wrapper did not launch its kernel")
        ref = K.attention_ref(q, k, v, causal=causal)
        tol = ATTN_TOL[dtype_name]
        err = float((out.float() - ref.float()).abs().max())
        if out.dtype != dtype or not torch.allclose(out.float(), ref.float(),
                                                    rtol=tol, atol=tol):
            fail(f"flash_attention ({label}): kernel differs from its plain "
                 f"version (max abs err {err}, tolerance {tol})")
        if dtype == torch.bfloat16 and not torch.allclose(
                out.float(), ref.float(), rtol=ATTN_BF16_RTOL, atol=ATTN_BF16_ATOL):
            fail(f"flash_attention ({label}): kernel more than one bf16 ulp from "
                 f"its plain version (max abs err {err}, rtol {ATTN_BF16_RTOL}, "
                 f"atol {ATTN_BF16_ATOL})")
        mask = None
        if causal and Sq != Sk:  # torch aligns a causal mask top-left
            mask = torch.ones((Sq, Sk), dtype=torch.bool, device=dev).tril(Sk - Sq)

        def library():
            return F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=causal and mask is None,
                enable_gqa=True)

        lib_err = float((library().float() - ref.float()).abs().max())
        backend = library_kernels(library)
        ms = time_ms(lambda: K.flash_attention_cuda(q, k, v, causal=causal), flush)
        plain_ms = time_ms(lambda: K.attention_ref(q, k, v, causal=causal), flush)
        library_ms = time_ms(library, flush)
        nbytes, flops = flash_attention_traffic(B, Hq, Hkv, Sq, Sk, D, causal,
                                                q.element_size())
        peak = BF16_OPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S
        bound_ms, bound_by = bound(nbytes, flops, peak)
        log(f"flash_attention ({label}: B={B} Hq={Hq} Hkv={Hkv} Sq={Sq} Sk={Sk} "
            f"D={D} {dtype_name} causal={causal}): max abs err {err:.3g} "
            f"(tol {tol}{'; bf16 ulp check passed' if dtype == torch.bfloat16 else ''}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"sdpa {library_ms:.4f} ms (max abs err {lib_err:.3g}); "
            f"{flops} flop, {nbytes} bytes, bound {bound_ms:.4f} ms "
            f"({bound_by}, {peak / 1e12:g} TFLOP/s); kernel at "
            f"{flops / ms / 1e9:.1f} TFLOP/s, {bound_ms / ms:.3f} of its bound "
            f"(sdpa {flops / library_ms / 1e9:.1f} TFLOP/s; the kernel "
            f"{'faster' if ms < library_ms else 'slower'} than sdpa; sdpa's "
            f"kernels: {backend})")
        if label in ATTN_ROWS:
            name, source = ATTN_ROWS[label]
            attn_rows[label] = dict(
                name=name, route="cuda", source=source,
                replaces="src/repro/kernels/flash_attention/kernel.py:84",
                launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
        del q, k, v, out, ref

    # embedding_bag at MIND serve_bulk widths: the profile table and the
    # profile ids as mind_batch makes them; its mask is all ones, so the
    # weights here are f32 in [0, 1) with about a fifth of the slots 0
    mcfg = get_arch("mind").make_config()
    B = dict(MIND_SERVE)["serve_bulk"]
    batch = mind_batch(0, B, mcfg, seed=SEED)
    table = randn((mcfg.n_profile, mcfg.embed_dim), torch.float32) * 0.02
    idx = torch.as_tensor(batch["profile_ids"], device=dev)
    u = torch.rand(idx.shape, generator=gen, device=dev)
    w = torch.where(u > 0.2, torch.rand(idx.shape, generator=gen, device=dev), 0.0)
    L, d = idx.shape[1], table.shape[1]
    K.reset_launch_counts()
    out = K.embedding_bag_cuda(table, idx, w)
    torch.cuda.synchronize()
    if K.launch_counts()["embedding_bag"] != 1:
        fail("embedding_bag: the wrapper did not launch its kernel")
    plain = K.embedding_bag_ref(table, idx, w)
    err, rel = float((out - plain).abs().max()), rel_err(out, plain)
    if rel > 1e-6:
        fail(f"embedding_bag: kernel differs from its plain version "
             f"(max abs err {err}, {rel:.3g} of max |out|)")
    in_order = torch.zeros_like(out)  # the TPU kernel's order of sums
    for l in range(L):
        in_order = in_order + table[idx[:, l].long()] * w[:, l, None]
    if not torch.equal(out, in_order):
        fail("embedding_bag: kernel is not bit-identical to the in-order sum")

    def library():
        return F.embedding_bag(idx, table, mode="sum", per_sample_weights=w)

    # the bare launch, without the wrapper's Python and its index check
    # (one host read of idx's min and max, timed apart)
    from repro_torch.kernels.embedding_bag.kernel import _launch as bag_launch

    bare_out = torch.empty_like(out)
    bare_args = (table.data_ptr(), idx.data_ptr(), w.data_ptr(), bare_out.data_ptr(),
                 B, L, d, torch.cuda.current_stream().cuda_stream)
    launch = bag_launch()
    if launch(*bare_args) != 0:
        fail("embedding_bag: the bare launch failed")
    torch.cuda.synchronize()
    if not torch.equal(bare_out, out):
        fail("embedding_bag: the bare launch differs from the wrapper's")
    ms = time_ms(lambda: K.embedding_bag_cuda(table, idx, w), flush)
    bare_ms = time_ms(lambda: launch(*bare_args), flush)
    check_ms = time_ms(lambda: torch.stack(torch.aminmax(idx)).tolist(), flush)
    alone_ms = kernel_alone_ms(lambda: launch(*bare_args), flush, ("embedding_bag",))
    plain_ms = time_ms(lambda: K.embedding_bag_ref(table, idx, w), flush)
    library_ms = time_ms(library, flush)
    rows_touched = int(torch.unique(idx[w != 0]).numel())  # rows a 0 weight skips
    nbytes, ops = embedding_bag_traffic(rows_touched, B, L, d)
    bound_ms, bound_by = bound(nbytes, ops)
    log(f"embedding_bag (table {tuple(table.shape)}, B={B} L={L}, f32 weights, "
        f"{float((w == 0).float().mean()):.3f} of them 0): max abs err {err:.3g} "
        f"({rel:.3g} of max |out|, tol 1e-6); bit-identical to the in-order sum; kernel {ms:.4f} ms "
        f"(bare launch {bare_ms:.4f} ms, alone under the profiler {alone_ms:.4f} ms; the "
        f"index check, one host read, {check_ms:.4f} ms), plain "
        f"{plain_ms:.4f} ms, F.embedding_bag {library_ms:.4f} ms (max abs err "
        f"{float((library() - plain).abs().max()):.3g}); {rows_touched} rows "
        f"touched, {nbytes} bytes, bound {bound_ms:.4f} ms ({bound_by}; "
        f"{bound_ms / alone_ms:.3f} of it alone)")
    bag_row = dict(name="embedding_bag", route="cuda",
                   source="src/repro_torch/csrc/embedding_bag.cu",
                   replaces="src/repro/kernels/embedding_bag/kernel.py:39",
                   launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
    return *(attn_rows[label] for label in ATTN_ROWS), bag_row


def lm_serving(dev) -> tuple[int, int]:
    """Phase 8: minitron-8b at full width.  Returns the flash_attention
    launches of the bf16 prefill and decode, and of the fp32 twin's
    prefill, decode and teacher-forced prefill."""
    import dataclasses
    import gc

    import torch

    from repro_torch import kernels as K
    from repro_torch.configs import get_arch
    from repro_torch.data import lm_batch
    from repro_torch.models import lm
    from repro_torch.models.common import param_count

    cfg = get_arch(LM_ARCH).make_config()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = lm.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg)
    torch.cuda.synchronize()
    n_params = param_count(model)
    log(f"{cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, {n_params} parameters "
        f"({cfg.param_dtype}, attn_impl={cfg.attn_impl}) initialised on the card "
        f"in {time.perf_counter() - t0:.2f} s")
    toks = torch.as_tensor(
        lm_batch(0, LM_BATCH, LM_PROMPT, cfg.vocab, seed=SEED)["tokens"], device=dev)

    K.reset_launch_counts()
    t0 = time.perf_counter()
    cache, logits = lm.prefill_step(model, toks, cfg, LM_MAX_LEN)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = K.launch_counts()["flash_attention"]
    first_logits = logits
    t0 = time.perf_counter()
    for step in range(LM_DECODE):
        nxt = logits.argmax(-1).to(torch.int32)
        logits, cache = lm.decode_step(model, cache, nxt, LM_PROMPT + step, cfg)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = K.launch_counts()["flash_attention"]
    if not bool(torch.isfinite(logits).all()) or logits.shape != (LM_BATCH, cfg.vocab):
        fail(f"decode logits are not finite of shape {(LM_BATCH, cfg.vocab)}")
    # warm prefill (kernels and cuBLAS heuristics loaded); then one more
    # and a few decode steps on its cache, each under the profiler
    t0 = time.perf_counter()
    lm.prefill_step(model, toks, cfg, LM_MAX_LEN)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    with device_profile("profiler start-up (empty window)", top=0):
        pass
    with device_profile("prefill"):
        warm_cache, warm_logits = lm.prefill_step(model, toks, cfg, LM_MAX_LEN)
        torch.cuda.synchronize()
    with device_profile(f"{LM_PROFILED_STEPS} decode steps"):
        for step in range(LM_PROFILED_STEPS):
            nxt = warm_logits.argmax(-1).to(torch.int32)
            warm_logits, warm_cache = lm.decode_step(model, warm_cache, nxt,
                                                     LM_PROMPT + step, cfg)
        torch.cuda.synchronize()
    del warm_cache, warm_logits
    log(f"LM serving: prefill {LM_BATCH} x {LM_PROMPT} tokens {prefill_s:.3f} s "
        f"(warm {warm_s:.3f} s, {LM_BATCH * LM_PROMPT / warm_s:.0f} tokens/s); "
        f"{LM_DECODE} greedy decode steps {decode_s:.3f} s = "
        f"{decode_s / LM_DECODE * 1e3:.2f} ms/token, "
        f"{LM_BATCH * LM_DECODE / decode_s:.1f} tokens/s at batch {LM_BATCH}; peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"flash_attention launches: {prefill_launches} in the prefill, "
        f"{launches - prefill_launches} in decode")
    if prefill_launches != cfg.n_layers:
        fail(f"prefill launched flash_attention {prefill_launches} times, "
             f"not once per layer ({cfg.n_layers})")

    # (i) the same weights with the plain attention
    K.reset_launch_counts()
    _, plain_logits = lm.prefill_step(model, toks,
                                      dataclasses.replace(cfg, attn_impl="xla"),
                                      LM_MAX_LEN)
    if K.launch_counts()["flash_attention"]:
        fail("the plain-attention prefill launched the kernel")
    rel = rel_err(first_logits, plain_logits)
    agree = float((first_logits.argmax(-1) == plain_logits.argmax(-1)).float().mean())
    log(f"check (i) bf16 prefill logits, kernel vs plain attention: max abs "
        f"diff {rel * float(plain_logits.abs().max()):.4g} = {rel:.4g} of max "
        f"|logit| {float(plain_logits.abs().max()):.4g} (tol {LM_BF16_TOL}); "
        f"argmax agreement {agree:.2f}")
    if rel > LM_BF16_TOL:
        fail(f"bf16 prefill logits: kernel path differs from plain attention by "
             f"{rel:.4g} of max |logit| (tolerance {LM_BF16_TOL})")
    del model, cache, logits, first_logits, plain_logits
    gc.collect()
    torch.cuda.empty_cache()

    # (ii) fp32: the last decode step against a teacher-forced prefill
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    t0 = time.perf_counter()
    model = lm.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg32)
    torch.cuda.synchronize()
    log(f"fp32 twin initialised in {time.perf_counter() - t0:.2f} s "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card)")
    seq = toks[:LM_F32_BATCH]
    t0 = time.perf_counter()
    K.reset_launch_counts()
    cache, logits = lm.prefill_step(model, seq, cfg32, LM_MAX_LEN)
    for step in range(LM_DECODE):
        nxt = logits.argmax(-1).to(torch.int32)
        seq = torch.cat([seq, nxt[:, None]], dim=1)
        logits, cache = lm.decode_step(model, cache, nxt, LM_PROMPT + step, cfg32)
    f32_launches = K.launch_counts()["flash_attention"] + cfg.n_layers
    K.reset_launch_counts()
    _, forced = lm.prefill_step(model, seq, cfg32, LM_MAX_LEN)
    torch.cuda.synchronize()
    if K.launch_counts()["flash_attention"] != cfg.n_layers:
        fail("the teacher-forced prefill did not attend through the kernel")
    diff = float((logits - forced).abs().max())
    ok = torch.allclose(logits, forced, rtol=LM_F32_RTOL, atol=LM_F32_ATOL)
    log(f"check (ii) fp32, {LM_F32_BATCH} x {LM_PROMPT} prompt + {LM_DECODE} decode "
        f"steps vs teacher-forced prefill of {seq.shape[1]} tokens: max abs diff "
        f"{diff:.4g} (max |logit| {float(forced.abs().max()):.4g}; rtol "
        f"{LM_F32_RTOL}, atol {LM_F32_ATOL}); {time.perf_counter() - t0:.2f} s; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not ok:
        fail(f"fp32 decode differs from the teacher-forced prefill (max abs diff {diff})")
    del model, cache, logits, forced
    gc.collect()
    torch.cuda.empty_cache()
    return launches, f32_launches


def mind_serving(dev) -> int:
    """Phase 9: MIND at full width.  Returns the embedding_bag launches
    of the kernel-path serving calls."""
    import dataclasses

    import torch

    from repro_torch import kernels as K
    from repro_torch.configs import get_arch
    from repro_torch.data import mind_batch
    from repro_torch.models import mind

    cfg = get_arch("mind").make_config()
    plain = dataclasses.replace(cfg, bag_impl="ref")
    model = mind.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg)
    keys = ("hist", "hist_mask", "profile_ids", "profile_mask")

    def on_card(batch):
        return {k: torch.as_tensor(batch[k], device=dev) for k in keys}

    launches = 0
    for label, B in MIND_SERVE:
        batch = on_card(mind_batch(1, B, cfg, seed=SEED))
        walls, counts = [], []
        for _ in range(2):  # cold, warm
            K.reset_launch_counts()
            t0 = time.perf_counter()
            caps = mind.serve_interests(model, batch, cfg)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            counts.append(K.launch_counts()["embedding_bag"])
            if counts[-1] < 1:
                fail(f"MIND {label}: serve_interests never launched embedding_bag")
            launches += counts[-1]
        ref = mind.serve_interests(model, batch, plain)
        err, scale = float((caps - ref).abs().max()), float(ref.abs().max())
        log(f"MIND {label} B={B}: serve_interests {walls[0] * 1e3:.2f} ms cold, "
            f"{walls[1] * 1e3:.2f} ms warm, {B / walls[1]:.0f} users/s; "
            f"embedding_bag launches per call {counts}; interests "
            f"{tuple(caps.shape)} vs plain bag: max abs diff {err:.3g}, max |ref| "
            f"{scale:.3g} (tol {MIND_REL_TOL} of max |ref|)")
        if caps.shape != (B, cfg.n_interests, cfg.embed_dim) or \
                not bool(torch.isfinite(caps).all()) or not err <= MIND_REL_TOL * scale:
            fail(f"MIND {label}: interests differ from the plain bag's (max abs diff "
                 f"{err}, max |ref| {scale})")
        # the bag of this call's profiles, bit for bit the TPU kernel's order
        ids, wts = batch["profile_ids"].to(torch.int32), batch["profile_mask"].float()
        bag = K.embedding_bag_cuda(model.profile_table, ids, wts)
        in_order = torch.zeros_like(bag)
        for l in range(ids.shape[1]):
            in_order = in_order + model.profile_table[ids[:, l].long()] * wts[:, l, None]
        if not torch.equal(bag, in_order):
            fail(f"MIND {label}: embedding_bag is not bit-identical to the in-order sum")
        log(f"MIND {label}: embedding_bag of the profiles bit-identical to the in-order sum")

    batch = on_card(mind_batch(2, MIND_REQUESTS, cfg, seed=SEED))
    cands = torch.arange(cfg.n_items, dtype=torch.int32, device=dev)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    scores = mind.retrieval_scores(model, batch, cands, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = K.launch_counts()["embedding_bag"]
    if n < 1:
        fail("MIND retrieval_scores never launched embedding_bag")
    launches += n
    ref = mind.retrieval_scores(model, batch, cands, plain)
    top, top_ref = scores.topk(MIND_TOPK).indices, ref.topk(MIND_TOPK).indices
    err, scale = float((scores - ref).abs().max()), float(ref.abs().max())
    log(f"MIND retrieval: {MIND_REQUESTS} requests x {cfg.n_items} candidates in "
        f"{wall * 1e3:.2f} ms, {n} embedding_bag launch(es); scores vs plain bag: "
        f"max abs diff {err:.3g}, max |ref| {scale:.3g} (tol {MIND_REL_TOL} of max "
        f"|ref|); top-{MIND_TOPK} equal for {int((top == top_ref).all(1).sum())} of "
        f"{MIND_REQUESTS} requests")
    if not err <= MIND_REL_TOL * scale or not torch.equal(top, top_ref):
        fail("MIND retrieval: scores or top items differ from the plain bag's")
    return launches


def bits_equal(a, b) -> bool:
    """Bit for bit, NaN where NaN."""
    import torch

    nan = torch.isnan(b)
    return torch.equal(torch.isnan(a), nan) and torch.equal(
        torch.where(nan, 0.0, a).view(torch.int32),
        torch.where(nan, 0.0, b).view(torch.int32))


def spmm_check(label, x_pad, col, wgt, flush) -> list[dict]:
    """Phase 10, step 3: spmm_ell against its plain version over all R
    rows (in chunks of SPMM_CHUNK_ROWS: the plain version gathers
    (rows, W, d)), both ops, timed; the sum also beside torch.sparse.mm
    on the same (R, n_x) matrix as CSR.  Returns one row per op."""
    import torch

    from repro_torch import kernels as K
    from repro_torch.kernels.spmm_ell.kernel import _launch as spmm_launch
    from repro_torch.roofline import bound
    from repro_torch.roofline.kernels import spmm_ell_traffic

    (n_x, d), (R, W) = x_pad.shape, col.shape
    chunks = [(lo, min(R, lo + SPMM_CHUNK_ROWS)) for lo in range(0, R, SPMM_CHUNK_ROWS)]
    nnz = int((wgt != 0).sum())
    out_rows = []
    for op in ("sum", "max"):
        K.reset_launch_counts()
        out = K.spmm_ell_cuda(x_pad, col, wgt, op)
        torch.cuda.synchronize()
        if K.launch_counts()["spmm_ell"] != 1:
            fail(f"spmm_ell ({label}, {op}): the wrapper did not launch its kernel")
        err, scale, same = 0.0, 0.0, True
        for lo, hi in chunks:
            ref = K.spmm_ell_ref(x_pad, col[lo:hi], wgt[lo:hi], op)
            if op == "sum":
                err = max(err, float((out[lo:hi] - ref).abs().max()))
                scale = max(scale, float(ref.abs().max()))
            else:
                same &= bits_equal(out[lo:hi], ref)
        if op == "sum" and not err <= SPMM_SUM_TOL * scale:
            fail(f"spmm_ell ({label}, sum): kernel differs from its plain version by "
                 f"{err} (max |out| {scale}, tolerance {SPMM_SUM_TOL} of it)")
        if op == "max" and not same:
            fail(f"spmm_ell ({label}, max): kernel is not bit-identical to its plain version")
        plain_out = torch.empty_like(out)

        def plain():
            for lo, hi in chunks:
                plain_out[lo:hi] = K.spmm_ell_ref(x_pad, col[lo:hi], wgt[lo:hi], op)

        ms = time_ms(lambda: K.spmm_ell_cuda(x_pad, col, wgt, op), flush)
        # the bare launch, without the wrapper's Python (argument checks,
        # output allocation): the checked call above vouches for the inputs
        bare_out = torch.empty_like(out)
        bare_args = (x_pad.data_ptr(), col.data_ptr(), wgt.data_ptr(), bare_out.data_ptr(),
                     R, W, d, ("sum", "max").index(op),
                     torch.cuda.current_stream().cuda_stream)
        launch = spmm_launch()
        if launch(*bare_args) != 0:
            fail(f"spmm_ell ({label}, {op}): the bare launch failed")
        torch.cuda.synchronize()
        if not bits_equal(bare_out, out):
            fail(f"spmm_ell ({label}, {op}): the bare launch differs from the wrapper's")
        bare_ms = time_ms(lambda: launch(*bare_args), flush)
        # the wrapper's index check: one host read of col's (min, max),
        # made once for an ELL tensor (the GIN forward launches 5 times on one)
        check_ms = time_ms(lambda: torch.stack(torch.aminmax(col)).tolist(), flush)
        plain_ms = time_ms(plain, flush)
        library_ms, lib_note = None, "none: no PyTorch call takes a masked max over ELL slots"
        if op == "sum":
            A = torch.sparse_csr_tensor(
                torch.arange(0, R * W + 1, W, dtype=torch.int64, device=col.device),
                col.reshape(-1).long(), wgt.reshape(-1), size=(R, n_x), check_invariants=False)
            lib_err = float((torch.sparse.mm(A, x_pad) - out).abs().max())
            library_ms = time_ms(lambda: torch.sparse.mm(A, x_pad), flush)
            lib_note = f"torch.sparse.mm (CSR) {library_ms:.4f} ms (max abs diff {lib_err:.3g})"
            del A
        used = col if op == "sum" else col[wgt > 0]  # rows of x the op reads
        rows_read = int(torch.unique(used).numel())
        nbytes, ops = spmm_ell_traffic(R, W, rows_read, d, nnz, op)
        bound_ms, bound_by = bound(nbytes, ops)
        check = (f"max abs err {err:.3g} ({err / scale:.3g} of max |out|, tol {SPMM_SUM_TOL})"
                 if op == "sum" else "bit-identical")
        log(f"spmm_ell ({label}: x {tuple(x_pad.shape)}, ELL R={R} W={W}, {nnz} weights "
            f"!= 0, op {op}): {check}; kernel {ms:.4f} ms (bare launch {bare_ms:.4f} ms; "
            f"the index check, once an ELL, {check_ms:.4f} ms), plain {plain_ms:.4f} ms "
            f"({len(chunks)} chunks), {lib_note}; {rows_read} rows of x read, {nbytes} "
            f"bytes, bound {bound_ms:.4f} ms ({bound_by})")
        out_rows.append(dict(name="spmm_ell", route="cuda",
                             source="src/repro_torch/csrc/spmm_ell.cu",
                             replaces="src/repro/kernels/spmm_ell/kernel.py:47",
                             launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms))
        del out, plain_out, bare_out
    return out_rows


def vertex_check(label, x, ell, graph, flush) -> dict:
    """Phase 10, step 3b: the vertex sum (spmm_ell_vertex_cuda, GIN's
    neighbour sum) bit for bit against its plain in-order version over
    all n vertices (in chunks of SPMM_CHUNK_VERTICES), timed through the
    wrapper, as a bare launch and alone under the profiler, beside
    torch.sparse.mm on the (n, n) CSR of the same edges.  ``graph``:
    (live col, m, rows of x the live slots read, the CSR).  Returns its
    row of the kernels line."""
    import torch

    from repro_torch import kernels as K
    from repro_torch.kernels.spmm_ell.kernel import (
        SPLIT_ROWS,
        _vertex_launch,
        vertex_launch_args,
        vertex_plan,
    )
    from repro_torch.roofline import MEM_BYTES_PER_S, bound
    from repro_torch.roofline.kernels import spmm_ell_vertex_traffic

    col, wgt, row_ptr, deg = ell.col, ell.wgt, ell.row_ptr, ell.deg
    (n, d), (R, W) = x.shape, col.shape
    m, rows_read, csr = graph
    K.reset_launch_counts()
    out = K.spmm_ell_vertex_cuda(x, col, wgt, row_ptr, deg)
    torch.cuda.synchronize()
    if K.launch_counts()["spmm_ell"] != 1:
        fail(f"spmm_ell vertex sum ({label}): the wrapper did not launch its kernel")
    starts = row_ptr.tolist()
    chunks = [(v0, min(n, v0 + SPMM_CHUNK_VERTICES))
              for v0 in range(0, n, SPMM_CHUNK_VERTICES)]

    def plain_chunk(v0, v1):
        r0, r1 = starts[v0], starts[v1]
        return K.spmm_ell_vertex_ref(x, col[r0:r1], wgt[r0:r1],
                                     row_ptr[v0:v1 + 1] - r0, deg[v0:v1])

    for v0, v1 in chunks:
        if not bits_equal(out[v0:v1], plain_chunk(v0, v1)):
            fail(f"spmm_ell vertex sum ({label}): not bit-identical to its plain "
                 f"in-order version on vertices [{v0}, {v1})")
    if not bits_equal(K.spmm_ell_vertex_cuda(x, col, wgt, row_ptr, deg), out):
        fail(f"spmm_ell vertex sum ({label}): a second launch gave other bits")
    plan = vertex_plan(x, col, row_ptr, deg, SPLIT_ROWS)
    scratch = torch.empty((plan.fat_row.shape[0], d), device=x.device)
    bare_out = torch.empty_like(out)
    bare_args = vertex_launch_args(x, col, wgt, row_ptr, deg, plan, scratch, bare_out)
    launch = _vertex_launch()
    if launch(*bare_args) != 0:
        fail(f"spmm_ell vertex sum ({label}): the bare launch failed")
    torch.cuda.synchronize()
    if not bits_equal(bare_out, out):
        fail(f"spmm_ell vertex sum ({label}): the bare launch differs from the wrapper's")
    ms = time_ms(lambda: K.spmm_ell_vertex_cuda(x, col, wgt, row_ptr, deg), flush)
    bare_ms = time_ms(lambda: launch(*bare_args), flush)
    alone_ms = kernel_alone_ms(lambda: launch(*bare_args), flush,
                               ("vertex_sum_kernel", "vertex_fold_kernel"))
    plain_out = torch.empty_like(out)

    def plain():
        for v0, v1 in chunks:
            plain_out[v0:v1] = plain_chunk(v0, v1)

    plain_ms = time_ms(plain, flush, reps=3)
    lib_err = float((torch.sparse.mm(csr, x) - out).abs().max())
    library_ms = time_ms(lambda: torch.sparse.mm(csr, x), flush)
    # live col and wgt, the rows of x they name, once each, row_ptr, deg, out
    nbytes, ops = spmm_ell_vertex_traffic(m, rows_read, n, d)
    bound_ms, bound_by = bound(nbytes, ops)
    gather_ms = 4 * m * d / MEM_BYTES_PER_S * 1e3
    log(f"spmm_ell vertex sum ({label}: x {tuple(x.shape)}, ELL R={R} W={W}, {m} live "
        f"slots, {plan.fat_vertex.shape[0]} vertices of more than {plan.split_rows} "
        f"rows in {plan.fat_row.shape[0]} scratch rows): bit-identical to the plain "
        f"in-order version ({len(chunks)} chunks) and launch to launch; kernel "
        f"{ms:.4f} ms (bare launch {bare_ms:.4f} ms, alone under the profiler "
        f"{alone_ms:.4f} ms), plain {plain_ms:.4f} ms, torch.sparse.mm (CSR, n x n) "
        f"{library_ms:.4f} ms (max abs diff {lib_err:.3g}); {rows_read} rows of x read, "
        f"{nbytes} bytes, bound {bound_ms:.4f} ms ({bound_by}; {bound_ms / alone_ms:.3f} "
        f"of it alone); every live slot's row from memory, no reuse, {4 * m * d} bytes: "
        f"{gather_ms:.4f} ms")
    del out, bare_out, plain_out, scratch
    return dict(name="spmm_ell", route="cuda", source="src/repro_torch/csrc/spmm_ell.cu",
                replaces="src/repro/kernels/spmm_ell/kernel.py:47",
                entry="spmm_ell_vertex_launch", launches=0, max_abs_err=0.0, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


def gin_inference(dev) -> dict:
    """Phase 10: GIN inference at full width on rmat1 scale 21.  Returns
    the spmm_ell row of the kernels line (layer 1, the sum)."""
    import dataclasses
    import gc

    import torch

    from repro_torch import kernels as K
    from repro_torch.configs import get_arch
    from repro_torch.data import gnn_flat_batch
    from repro_torch.graph import erdos_renyi_graph, rmat1
    from repro_torch.models.gnn import build_neighbor_ell, gin, neighbor_ell

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"TF32: torch.backends.cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}, torch.backends.cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32}")
    cfg = get_arch("gin-tu").make_config(False, GIN_CELL)
    t0 = time.perf_counter()
    g = rmat1(GIN_SCALE, seed=SEED)
    t1 = time.perf_counter()
    batch = gnn_flat_batch(g, cfg.d_in, cfg.n_classes, seed=SEED)
    t2 = time.perf_counter()
    b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    ell = neighbor_ell(b["edge_src"], b["edge_dst"], b["edge_mask"], g.n)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    R, W = ell.col.shape
    deg = torch.bincount(b["edge_dst"].long(), minlength=g.n)
    log(f"graph {g.name}: n={g.n} m={g.m}, in-degree median "
        f"{float(deg.float().median()):g}, max {int(deg.max())}, "
        f"{int((deg == 0).sum())} isolated; generated in {t1 - t0:.1f} s, features "
        f"{tuple(batch['x'].shape)} in {t2 - t1:.1f} s, copied in {t3 - t2:.1f} s; "
        f"neighbour ELL built on the card in {t4 - t3:.3f} s: R={R} W={W}, "
        f"{float((ell.wgt != 0).float().mean()):.3f} of the slots filled, "
        f"{(ell.col.nbytes + ell.wgt.nbytes) / 1e9:.3f} GB")
    del deg

    # ---- step 3: the kernel against its plain version -----------------
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    # the row entry, the TPU function's own (R, d) rows: x with the zero row
    x_pad = torch.cat([b["x"], b["x"].new_zeros((1, cfg.d_in))])
    spmm_check(f"layer 1, d={cfg.d_in}", x_pad, ell.col, ell.wgt, flush)
    h = torch.randn((g.n + 1, cfg.d_hidden), generator=gen, device=dev)
    h[g.n] = 0
    spmm_check(f"layers 2-5, d={cfg.d_hidden}", h, ell.col, ell.wgt, flush)
    # the vertex sum, the forward's: no zero row
    from repro_torch.kernels.spmm_ell.ref import live_slots

    live = torch.arange(W, device=dev) < live_slots(ell.row_ptr, ell.deg, W)[:, None]
    live_col = ell.col[live]
    m = int(live_col.numel())
    rows_read = int(torch.unique(live_col).numel())
    csr = torch.sparse_csr_tensor(
        torch.cat([ell.row_ptr.new_zeros(1), torch.cumsum(ell.deg.long(), 0)]),
        live_col.long(), ell.wgt[live], size=(g.n, g.n), check_invariants=False)
    del live, live_col
    graph = (m, rows_read, csr)
    row = vertex_check(f"layer 1, d={cfg.d_in}", b["x"], ell, graph, flush)
    vertex_check(f"layers 2-5, d={cfg.d_hidden}", h[:g.n].contiguous(), ell, graph, flush)
    del x_pad, h, csr, graph
    cora = erdos_renyi_graph(CORA_N, CORA_AVG_DEGREE, seed=SEED)
    cfg_sm = get_arch("gin-tu").make_config(False, "full_graph_sm")
    cb = {k: torch.as_tensor(v, device=dev)
          for k, v in gnn_flat_batch(cora, cfg_sm.d_in, cfg_sm.n_classes, seed=SEED).items()}
    # built without the memo, which keeps the large graph's ELL for the forward
    cell = build_neighbor_ell(cb["edge_src"], cb["edge_dst"], cb["edge_mask"], cora.n)
    spmm_check(f"full_graph_sm, d={cfg_sm.d_in}",
               torch.cat([cb["x"], cb["x"].new_zeros((1, cfg_sm.d_in))]),
               cell.col, cell.wgt, flush)
    del cb, cell, flush
    gc.collect()
    torch.cuda.empty_cache()

    # ---- step 4: the forward through the kernel -----------------------
    params = gin.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg)
    args = (b["x"], b["edge_src"], b["edge_dst"], b["edge_mask"])
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    walls = []
    for _ in range(1 + GIN_WARM):  # cold, then warm
        t0 = time.perf_counter()
        logits = gin.forward(params, *args, cfg)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = K.launch_counts()["spmm_ell"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    warm = min(walls[1:])
    log(f"GIN forward ({cfg.name}: {cfg.n_layers} layers, d_in {cfg.d_in}, hidden "
        f"{cfg.d_hidden}, {cfg.n_classes} classes) over {g.n} nodes: cold "
        f"{walls[0] * 1e3:.2f} ms, warm {', '.join(f'{w * 1e3:.2f}' for w in walls[1:])} "
        f"ms ({g.n / warm:.4g} nodes/s); peak memory {peak:.2f} GiB; spmm_ell "
        f"launches {launches} in {1 + GIN_WARM} forwards")
    if launches != cfg.n_layers * (1 + GIN_WARM):
        fail(f"GIN forward launched spmm_ell {launches} times in {1 + GIN_WARM} "
             f"forwards, not once per layer ({cfg.n_layers})")
    with device_profile("two warm GIN forwards", top=10) as seen:
        for _ in range(2):
            gin.forward(params, *args, cfg)
        torch.cuda.synchronize()
    if any("index_add" in key for key in seen):
        fail("the GIN forward ran index_add_: the neighbour sum must not combine rows "
             "outside the kernel")

    # ---- step 5: against the plain segment-sum route ------------------
    if logits.shape != (g.n, cfg.n_classes) or not bool(torch.isfinite(logits).all()):
        fail(f"GIN logits are not finite of shape {(g.n, cfg.n_classes)}")
    K.reset_launch_counts()
    t0 = time.perf_counter()
    ref = gin.forward(params, *args, dataclasses.replace(cfg, agg_impl="segment_sum"))
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    if K.launch_counts()["spmm_ell"]:
        fail("the segment-sum route launched spmm_ell")
    err = (logits - ref).abs().max(1).values
    node_scale = ref.abs().max(1).values
    worst = float((err / node_scale).max())
    rel = float(err.max() / node_scale.max())
    agree = float((logits.argmax(1) == ref.argmax(1)).float().mean())
    loss = float(gin.node_classification_loss(params, b, cfg))
    log(f"GIN logits, kernel route vs segment-sum route ({plain_s * 1e3:.1f} ms, "
        f"edges in chunks of {gin.EDGE_CHUNK}): max |diff| {float(err.max()):.4g} = "
        f"{rel:.3g} of max |logit| {float(node_scale.max()):.4g}; node by node at most "
        f"{worst:.3g} of the node's max |logit| (tol {GIN_LOGIT_TOL}); argmax agrees "
        f"on {agree:.6f} of the nodes; eval loss {loss:.6g}")
    if not worst <= GIN_LOGIT_TOL:
        fail(f"GIN logits: kernel route differs from the segment-sum route by {worst:.3g} "
             f"of a node's max |logit| (tolerance {GIN_LOGIT_TOL})")
    row["launches"] = launches
    return row


def dijkstra_rows(g, sources) -> "np.ndarray":
    """scipy's Dijkstra distances from each source as float32 rows, the
    matrix built once (the graph holds no duplicate edges)."""
    import numpy as np
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra

    a = csr_matrix((g.weight.astype(np.float64), (g.src, g.dst)),
                   shape=(g.n, g.n))
    out = dijkstra(a, directed=True, indices=list(sources))
    return out.astype(np.float32).reshape(len(sources), g.n)


def batched_supersteps(g, pg, dev) -> dict:
    """Supersteps of a batched solve of the 8 landmark sources of phase
    11, each as (dist, row_idx, count) at the batched fused entry:
    "balanced", the one with the most live rows (every lane near F);
    "spread", the one whose lane counts differ most (then the most lanes
    at 0); and "skewed", the balanced one with every lane but its
    largest cut to 0 or 1 live rows, as lanes look once they converge
    at different supersteps: lanes at 0 beside a lane near F (the
    landmarks' hubs converge together, so their solve has no such
    superstep)."""
    import torch

    from repro_torch.api import Problem, SingleSource, Solver
    from repro_torch.core import engine as E
    from repro_torch.serve import pick_landmarks

    sources = pick_landmarks(g, SERVE_LANDMARKS)
    best: dict = {}
    real = E.fused_superstep_batch

    def capture(dist, row_idx, count, *rest):
        c = count.tolist()
        keys = {"balanced": (sum(c),),
                "spread": (max(c) - min(c), c.count(0), sum(c))}
        for name, key in keys.items():
            if name not in best or key > best[name]["key"]:
                best[name] = dict(key=key, dist=dist.clone(), row_idx=row_idx.clone(),
                                  count=count.clone())
        return real(dist, row_idx, count, *rest)

    E.fused_superstep_batch = capture
    try:
        Solver(SPEC, device=dev).solve_batch(
            [Problem(pg, SingleSource(v)) for v in sources])
    finally:
        E.fused_superstep_batch = real
    if not best:
        fail("the batched solve never launched fused_superstep_batch")
    bal = best["balanced"]
    big = int(bal["count"].argmax())
    skewed = torch.tensor([int(bal["count"][s]) if s == big else s % 2
                           for s in range(bal["count"].numel())],
                          dtype=torch.int32, device=bal["count"].device)
    best["skewed"] = dict(key=None, dist=bal["dist"], row_idx=bal["row_idx"], count=skewed)
    log(f"batched supersteps of the landmark sources {sources}: counts "
        + ", ".join(f"{k} {v['count'].tolist()}" for k, v in best.items()))
    return best


def atomic_floor_call(lib, dist, idx, cnt, rs, col, wgt, n_out):
    """The batched fused entry's atomics floor (scripts/frontier_variants.cu,
    atomic_floor_kernel): the same pre-checked atomic mins on every
    lane's finite (lane, column, value) triples, listed flat, into the
    (S, n_out+1) buffer; no strip loads.  Returns the call and the number
    of triples."""
    import torch

    from repro_torch import kernels as K

    S, P, R = idx.shape[0], col.shape[0], col.shape[1]
    cols, vals = [], []
    for s, k in enumerate(cnt.tolist()):
        k = max(0, min(k, idx.shape[1]))
        q = s % P
        r = idx[s, :k].long().clamp(0, R - 1)
        v = dist[s][rs[q][r].long()][:, None] + wgt[q][r]
        keep = v != float("inf")
        cols.append(col[q][r][keep].long() + s * (n_out + 1))
        vals.append(v[keep])
    cols = torch.cat(cols).to(torch.int32).contiguous()
    vals = torch.cat(vals).contiguous()
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        out = torch.full((S, n_out + 1), float("inf"), device=dist.device)
        K._lib.check(lib.atomic_floor_launch(cols.data_ptr(), vals.data_ptr(),
                                             out.data_ptr(), cols.numel(), stream),
                     "atomic floor")
        return out
    return call, cols.numel()


def batched_frontier_rows(g, pg, ell, dev, flush, floor_lib) -> list[dict]:
    """Phase 3, the batched entries, at the balanced and the skewed
    superstep of a batched solve of the 8 landmark sources of phase 11
    (``batched_supersteps``): each entry against its plain version and
    against 8 single launches on the same lanes, bit for bit; timed
    through the wrapper, bare, alone under the profiler (over wrapper
    calls: a fresh output, so every atomic runs), as 8 single launches,
    and against its byte bound; the fused entry also beside its atomics
    floor.  Returns their rows of the kernels line at the balanced
    superstep (launches filled in by phase 11)."""
    rows = []
    for label, step in batched_supersteps(g, pg, dev).items():
        entries = batched_entry_rows(label, step["dist"], step["row_idx"],
                                     step["count"], ell, pg.n_pad, flush, floor_lib)
        if label == "balanced":
            rows += entries
    return rows


def batched_entry_rows(label, dist, idx, cnt, ell, n_out, flush, floor_lib) -> list[dict]:
    """One batched superstep (``dist``, ``idx``, ``cnt`` at the batched
    fused entry over ``ell``'s P ranks): each batched entry against its
    plain version and S single launches, bit for bit; timed through the
    wrapper, bare, alone under the profiler, as S single launches, and
    against its byte bound; the fused entry also beside its atomics
    floor when ``floor_lib`` is given.  Returns their rows of the
    kernels line."""
    import torch

    from repro_torch import kernels as K
    from repro_torch.kernels.relax_push import kernel as push_kernel
    from repro_torch.kernels.superstep_fused import kernel as fused_kernel
    from repro_torch.roofline import bound
    from repro_torch.roofline.kernels import (
        fused_superstep_batch_traffic,
        relax_push_gather_batch_traffic,
    )

    rs, col, wgt = ell.row_src, ell.col, ell.wgt
    P, R, W = col.shape
    rows = []
    S, F = idx.shape
    counts = cnt.tolist()
    n_src = [int(torch.unique(rs[s % P][idx[s, :k].long()]).numel())
             for s, k in enumerate(counts)]
    live = sum(counts)
    # the lanes of a rank share its ELL: a row two lanes list is read once
    rows_read = int(torch.unique(torch.cat([
        (s % P) * R + idx[s, :k].long() for s, k in enumerate(counts)])).numel())
    vec = bool(K._lib.vector_strips(W, col, wgt))
    log(f"batched frontier, {label} ({S} lanes): per-lane counts {counts} of "
        f"F={F} ({live} rows, {rows_read} distinct, {sum(n_src)} source "
        f"vertices); 1-D grids: fused {fused_kernel.batch_grid(F, W, S, vec)} "
        f"blocks, push {push_kernel.batch_grid(F, W, S, True)}")
    stream = torch.cuda.current_stream().cuda_stream
    fused_out = torch.full((S, n_out + 1), float("inf"), device=dist.device)
    push_out = torch.empty((S, F, W), device=dist.device)
    fused_launch = fused_kernel._batch_launch()
    fused_args = (dist.data_ptr(), idx.data_ptr(), cnt.data_ptr(), rs.data_ptr(),
                  col.data_ptr(), wgt.data_ptr(), fused_out.data_ptr(), F, R, W, P,
                  dist.shape[1], n_out + 1, S, int(vec), stream)

    def fused_bare():  # into a fresh +inf output, as the wrapper does
        fused_out.fill_(float("inf"))
        return fused_launch(*fused_args)

    push_launch = push_kernel._batch_launch()
    push_args = (dist.data_ptr(), idx.data_ptr(), cnt.data_ptr(), rs.data_ptr(),
                 wgt.data_ptr(), push_out.data_ptr(), F, R, W, P, dist.shape[1], S,
                 int(K._lib.vector_strips(W, wgt, push_out)), stream)
    entries = (
        dict(name="fused_superstep_batch", kernel="fused_superstep_batch_kernel",
             source="src/repro_torch/csrc/fused_superstep.cu",
             replaces="src/repro/kernels/superstep_fused/kernel.py:72",
             wrapper=lambda: K.fused_superstep_batch_cuda(
                 dist, idx, cnt, rs, col, wgt, n_out),
             plain=lambda: K.fused_superstep_batch_ref(
                 dist, idx, cnt, rs, col, wgt, n_out),
             single=lambda: [K.fused_superstep_cuda(
                 dist[s], idx[s], cnt[s:s + 1], rs[s % P], col[s % P],
                 wgt[s % P], n_out) for s in range(S)],
             bare=(fused_bare, fused_out),
             traffic=fused_superstep_batch_traffic(live, rows_read, W,
                                                   sum(n_src), S, n_out)),
        dict(name="relax_push_gather_batch", kernel="relax_push_gather_batch_kernel",
             source="src/repro_torch/csrc/relax_push.cu",
             replaces="src/repro/kernels/relax_push/kernel.py:42",
             wrapper=lambda: K.relax_push_gather_batch_cuda(
                 dist, idx, cnt, rs, col, wgt),
             plain=lambda: K.relax_push_gather_batch_ref(dist, idx, cnt, rs, wgt),
             single=lambda: [K.relax_push_gather_cuda(
                 dist[s], idx[s], cnt[s:s + 1], rs[s % P], col[s % P],
                 wgt[s % P]) for s in range(S)],
             bare=(lambda: push_launch(*push_args), push_out),
             traffic=relax_push_gather_batch_traffic(live, rows_read, W,
                                                     sum(n_src), S, F)),
    )
    for e in entries:
        name = e["name"]
        K.reset_launch_counts()
        out_k = e["wrapper"]()
        torch.cuda.synchronize()
        if K.launch_counts()[name] != 1:
            fail(f"{name} ({label}): the wrapper did not launch its kernel once")
        out_p = e["plain"]()
        err = max_abs_err(out_k, out_p)
        if err != 0.0 or out_k.shape != out_p.shape:
            fail(f"{name} ({label}): kernel differs from its plain version "
                 f"(max abs err {err})")
        singles = torch.stack(e["single"]())
        if not torch.equal(singles, out_k):
            fail(f"{name} ({label}): differs from {S} single launches on the "
                 f"same lanes")
        bare, out_b = e["bare"]
        if bare() != 0:
            fail(f"{name} ({label}): the bare launch failed")
        torch.cuda.synchronize()
        if not torch.equal(out_b, out_k):
            fail(f"{name} ({label}): the bare launch differs from the wrapper's")
        ms = time_ms(e["wrapper"], flush)
        bare_ms = time_ms(bare, flush)
        alone_ms = kernel_alone_ms(e["wrapper"], flush, (e["kernel"],))
        single_ms = time_ms(e["single"], flush)
        plain_ms = time_ms(e["plain"], flush)
        nbytes, ops = e["traffic"]
        bound_ms, bound_by = bound(nbytes, ops)
        floor = ""
        if name == "fused_superstep_batch" and floor_lib is not None:
            call, n_triples = atomic_floor_call(floor_lib, dist, idx, cnt, rs, col,
                                                wgt, n_out)
            if not torch.equal(call(), out_k):
                fail(f"atomic floor ({label}): differs from the fused entry")
            floor_ms = kernel_alone_ms(call, flush, ("atomic_floor_kernel",))
            floor = (f"; atomics floor {floor_ms:.4f} ms alone over {n_triples} "
                     f"finite triples (the kernel at {alone_ms / floor_ms:.2f}x it)")
            del call
        log(f"{name} ({label}, {S} lanes): bit-identical to its plain version "
            f"and to {S} single launches; wrapper {ms:.4f} ms, bare {bare_ms:.4f} ms, "
            f"alone under the profiler {alone_ms:.4f} ms; {S} single launches "
            f"{single_ms:.4f} ms; plain {plain_ms:.4f} ms; {nbytes} bytes, "
            f"bound {bound_ms:.4f} ms at 3.35 TB/s ({bound_ms / alone_ms:.3f} of "
            f"it alone){floor}")
        rows.append(dict(name=name, route="cuda", source=e["source"],
                         replaces=e["replaces"], launches=0, max_abs_err=err,
                         ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=None))
    del fused_out, push_out, entries
    return rows


def query_service(g, dev) -> tuple[int, int]:
    """Phase 11: the SSSP query service at scale 20 on a copy of ``g``
    (the update feed mutates it).  Returns the launches of the batched
    fused_superstep entry on the serving path (landmark build, query
    mix, updates) and of the batched push gather in the push batch."""
    import gc

    import numpy as np
    import torch

    from repro_torch import kernels as K
    from repro_torch.api import Problem, SingleSource, Solver, SolverConfig
    from repro_torch.api.solver import _bootstrap_candidates
    from repro_torch.core import SSSP
    from repro_torch.core import engine as E
    from repro_torch.graph import Graph, graph_fingerprint
    from repro_torch.launch.serve import build_query_mix, improving_updates
    from repro_torch.obs import trace as obs
    from repro_torch.serve import (
        LandmarkIndex,
        Router,
        SolutionCache,
        UpdateFeed,
        serve_latency_stats,
    )

    gs = Graph(g.n, g.src.copy(), g.dst.copy(), g.weight.copy(), name=g.name)
    solver = Solver(SPEC, device=dev)
    coo_bytes = gs.src.nbytes + gs.dst.nbytes + gs.weight.nbytes
    t0 = time.perf_counter()
    graph_fingerprint(gs)
    fp_s = time.perf_counter() - t0
    log(f"fingerprint: CRC over {coo_bytes} bytes of COO arrays {fp_s:.3f} s "
        "(every Router flush and every partition lookup pays it until an "
        "update installs the hash chain)")
    # each multi-query solve_batch: its single and batched launches
    batched_calls = []
    solve_batch = solver.solve_batch

    def counted_solve_batch(problems):
        before = K.launch_counts()
        out = solve_batch(problems)
        after = K.launch_counts()
        if len(problems) > 1:
            batched_calls.append(tuple(
                after[k] - before[k] for k in ("fused_superstep",
                                               "fused_superstep_batch")))
        return out

    solver.solve_batch = counted_solve_batch
    tracer = obs.Tracer()
    torch.cuda.reset_peak_memory_stats()
    held_gib = torch.cuda.memory_allocated() / 2**30

    K.reset_launch_counts()  # the serving path from here to the updates' end
    with obs.use_tracer(tracer):
        t0 = time.perf_counter()
        lm = LandmarkIndex(solver, gs, k=SERVE_LANDMARKS, symmetric=True)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        part_s = sum(sp.duration_s for sp in tracer.find("solver.partition"))
        log(f"landmark tier: K={lm.k} {lm.landmarks} built in {build_s:.3f} s "
            f"(partition {part_s:.3f} s of it); supersteps "
            f"{[s.metrics.supersteps for s in lm.solutions]}")
        cache = SolutionCache(byte_budget=SERVE_CACHE_MB << 20)
        router = Router(solver, gs, cache=cache, landmarks=lm,
                        max_batch=SERVE_MAX_BATCH, max_wait_s=SERVE_MAX_WAIT_S)
        queries = build_query_mix(gs, SERVE_QUERIES, SERVE_ZIPF, SEED)
        router.serve(queries[:SERVE_MAX_BATCH])  # warm-up, outside the window
        cache.clear()
        cache.stats.hits = cache.stats.misses = 0
        tracer.clear()
        t0 = time.perf_counter()
        tickets = []
        for q in queries:
            tickets.append(router.submit(q))
            router.pump()
        router.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        answers = [t.result() for t in tickets]
        lat = serve_latency_stats(answers)
        flushes = tracer.find("router.flush")
        batches = [sp.attrs.get("solved", 0) for sp in flushes]
        solved = [b for b in batches if b]
        log(f"query mix: {len(answers)} queries in {wall:.3f} s = "
            f"{len(answers) / wall:.1f} q/s; latency {lat}; cache {cache.stats} "
            f"(hit rate {cache.stats.hit_rate():.3f}); router "
            f"{router.stats.as_dict()}; {len(flushes)} flushes, {len(solved)} "
            f"solved a batch of mean size {np.mean(solved) if solved else 0:.2f} "
            f"(sizes {solved}); flush wall mean "
            f"{np.mean([sp.duration_s for sp in flushes]):.3f} s; solver "
            f"{solver.stats()}")
    serve_batch_launches = K.launch_counts()["fused_superstep_batch"]

    # ---- checks of the served answers ---------------------------------
    truth_lm = dijkstra_rows(gs, lm.landmarks)
    for v, sol, row in zip(lm.landmarks, lm.solutions, truth_lm):
        if not np.array_equal(sol.state, row):
            fail(f"landmark {v}: lane state differs from Dijkstra at "
                 f"{int((sol.state != row).sum())} vertices")
    sampled = []
    for a in answers:
        if a.query.target is None and a.query.source not in sampled:
            sampled.append(a.query.source)
    sampled = sampled[:SERVE_SAMPLED]
    by_source = {a.query.source: a for a in answers if a.query.target is None}
    for v, row in zip(sampled, dijkstra_rows(gs, sampled)):
        if not np.array_equal(by_source[v].solution.state, row):
            fail(f"served single-source answer from {v} differs from Dijkstra")
    for a in answers:
        if a.served_by != "landmark" and a.query.target is not None:
            if a.distance != a.solution.distance_to(a.query.target):
                fail(f"point-to-point answer {a.query} differs from its solution")
    log(f"checks: {lm.k} landmark lanes and {len(sampled)} sampled single-source "
        f"answers {sampled} equal scipy's Dijkstra")

    # ---- a warm batch of 8 against 8 warm single solves --------------
    pg = solver.partition(gs)
    problems = [Problem(pg, SingleSource(v)) for v in sampled]
    solver.solve_batch(problems)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch = solver.solve_batch(problems)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    singles = [solver.solve(pb) for pb in problems]
    torch.cuda.synchronize()
    singles_s = time.perf_counter() - t0
    for a, b in zip(batch, singles):
        if a.state.tobytes() != b.state.tobytes() or \
                a.metrics.as_dict() != b.metrics.as_dict():
            fail("a batched lane differs from the single solve of its source")
    log(f"warm solve_batch of {len(problems)}: {batch_s:.4f} s; {len(problems)} "
        f"warm single solves {singles_s:.4f} s ({singles_s / batch_s:.2f}x); "
        f"lane supersteps {[s.metrics.supersteps for s in batch]}")
    with device_profile(f"one warm solve_batch of {len(problems)}", top=10,
                        kernel="fused_superstep_batch"):
        solver.solve_batch(problems)
        torch.cuda.synchronize()

    # ---- one launch a batched superstep, none of the single entry -----
    overflowed = [0]
    compact_rows = E.compact_rows

    def counting_compact(mask, cap):
        out = compact_rows(mask, cap)
        overflowed[0] += bool(out[2].any())
        return out

    E.compact_rows = counting_compact
    K.reset_launch_counts()  # (the serving counts resume below)
    try:
        fused_lanes = solver.solve_batch(problems)
    finally:
        E.compact_rows = compact_rows
    n = K.launch_counts()
    steps = max(s.metrics.supersteps for s in fused_lanes)
    if n["fused_superstep"] or n["fused_superstep_batch"] != steps - overflowed[0]:
        fail(f"a batched solve of {len(problems)} launched fused_superstep_batch "
             f"{n['fused_superstep_batch']} times and the single entry "
             f"{n['fused_superstep']} times in {steps} supersteps "
             f"({overflowed[0]} dense sweeps after a frontier overflow)")
    log(f"batched solve: fused_superstep_batch launched {n['fused_superstep_batch']} "
        f"times in {steps} supersteps ({overflowed[0]} dense sweeps after a "
        "frontier overflow), the single entry never")
    push = Solver(SolverConfig.from_spec("delta:5/sparse", relax_impl="push"),
                  device=dev)
    K.reset_launch_counts()
    push_lanes = push.solve_batch(problems)
    push_launches = K.launch_counts()["relax_push_gather_batch"]
    if K.launch_counts()["relax_push_gather"] or push_launches == 0:
        fail("the push batch did not go through relax_push_gather_batch alone")
    for a, b in zip(push_lanes, fused_lanes):
        if a.state.tobytes() != b.state.tobytes() or \
                a.metrics.as_dict() != b.metrics.as_dict():
            fail("a push lane differs from the fused lane")
    log(f"push solve_batch of {len(problems)}: lanes equal the fused lanes, "
        f"{push_launches} relax_push_gather_batch launches")
    # drop every reference to the pre-update partition but the service's
    del batch, singles, fused_lanes, push_lanes, push, answers, tickets, by_source
    del problems, pg, a, b, sol  # (the checks' loop variables hold lanes too)
    gc.collect()

    # ---- improving updates, refreshed by warm restarts ----------------
    K.reset_launch_counts()
    feed = UpdateFeed(gs, solver, cache=cache, landmarks=lm)
    with obs.use_tracer(tracer):
        for i, upd in enumerate(improving_updates(gs, SERVE_UPDATES, SEED + 1)):
            tracer.clear()
            t0 = time.perf_counter()
            res = feed.apply(upd)
            torch.cuda.synchronize()
            apply_s = time.perf_counter() - t0
            part_s = sum(sp.duration_s for sp in tracer.find("solver.partition"))
            resolves = tracer.find("solver.resolve")
            t1 = time.perf_counter()
            graph_fingerprint(gs)
            chain_s = time.perf_counter() - t1
            t1 = time.perf_counter()
            graph_fingerprint(gs, full=True)
            full_s = time.perf_counter() - t1
            key, warm = cache.entries_for(res.fingerprint)[0]
            t1 = time.perf_counter()
            cold = solver.solve(Problem(gs, SingleSource(key[1])))
            torch.cuda.synchronize()
            cold_s = time.perf_counter() - t1
            warm_steps = [sp.attrs["supersteps"] for sp in resolves]
            walls = sorted(sp.duration_s for sp in resolves)
            log(f"update {i}: {upd} improving={res.improving} applied in "
                f"{apply_s:.3f} s: re-partition {part_s:.3f} s (in the first "
                f"resolve), fingerprint {chain_s * 1e6:.1f} us chained "
                f"({full_s:.3f} s as a full rehash); {res.warm_refreshes} warm "
                f"cache refreshes + {lm.k} landmarks = {len(resolves)} resolves, "
                f"supersteps mean {np.mean(warm_steps):.2f} max {max(warm_steps)} "
                f"(bootstrap sweep included) against {cold.metrics.supersteps} "
                f"cold; resolve wall median {walls[len(walls) // 2]:.4f} s, max "
                f"{walls[-1]:.4f} s, against a cold solve's {cold_s:.4f} s")
            if warm.state.tobytes() != cold.state.tobytes():
                fail(f"update {i}: the refreshed entry of {key[1]} differs from "
                     "a cold solve")
    torch.cuda.synchronize()
    fused_batch = K.launch_counts()["fused_superstep_batch"]
    parts = {id(sol.pg): sol.pg for _, sol in cache.entries_for(graph_fingerprint(gs))}
    parts.update({id(sol.pg): sol.pg for sol in lm.solutions})
    log(f"updates: {feed.stats.as_dict()}; card memory {held_gib:.2f} GiB held "
        f"when phase 11 began, peak since {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB, {torch.cuda.memory_allocated() / 2**30:.2f} GiB held now; the "
        f"cache's and landmarks' solutions reference {len(parts)} partition(s), "
        f"{sum(bool(pg._device) for pg in parts.values())} with an ELL on the card")
    fp = graph_fingerprint(gs)
    fresh = cache.entries_for(fp)[:SERVE_FRESH]
    if len(fresh) < SERVE_FRESH:
        fail(f"only {len(fresh)} refreshed cache entries after the updates")
    for key, sol in fresh:
        cold = solver.solve(Problem(gs, SingleSource(key[1])))
        if sol.state.tobytes() != cold.state.tobytes():
            fail(f"refreshed entry of {key[1]} differs from a cold solve")
    cold = solver.solve(Problem(gs, SingleSource(lm.landmarks[0])))
    if lm.solutions[0].state.tobytes() != cold.state.tobytes():
        fail(f"refreshed landmark {lm.landmarks[0]} differs from a cold solve")
    if not np.array_equal(fresh[0][1].state, dijkstra_rows(gs, [fresh[0][0][1]])[0]):
        fail("a refreshed entry differs from Dijkstra on the updated graph")
    pg = solver.partition(gs)
    committed = torch.as_tensor(lm.solutions[0].padded, device=dev)
    sweep_ms = time_ms(lambda: _bootstrap_candidates(
        pg.to(dev), pg.n_local, SSSP, committed),
        torch.empty(64 << 20, dtype=torch.uint8, device=dev))
    t0 = time.perf_counter()
    solver.resolve(lm.solutions[0])
    torch.cuda.synchronize()
    log(f"bootstrap sweep over the {pg.col.size} ELL slots: {sweep_ms:.4f} ms "
        f"(CUDA events); one warm resolve with no perturbation (the sweep and "
        f"one superstep) {time.perf_counter() - t0:.4f} s")
    with device_profile("one warm resolve (no perturbation)", top=8):
        solver.resolve(lm.solutions[0])
        torch.cuda.synchronize()
    log(f"checks: {SERVE_FRESH} refreshed entries {[k[1] for k, _ in fresh]} and "
        f"landmark {lm.landmarks[0]} equal cold solves on the updated graph; "
        f"the first equals Dijkstra on it")
    if batched_calls and any(single for single, _ in batched_calls):
        fail(f"a batched solve launched the single fused_superstep: {batched_calls}")
    if not batched_calls or not all(b for _, b in batched_calls):
        fail(f"a batched solve did not launch fused_superstep_batch: {batched_calls}")
    log(f"{len(batched_calls)} batched solves on the serving path, each through "
        "fused_superstep_batch and never the single entry")
    return serve_batch_launches + fused_batch, push_launches


def push_supersteps(trace) -> int:
    """Supersteps of a traced one-rank solve that ran the push relax (a
    frontier kernel's launch): those whose eligible rows fit the cap of
    their segment."""
    steps = out = 0
    for seg in trace.segments:
        rows = trace.rows[steps:steps + seg["supersteps"]]
        out += sum(r <= seg["frontier_cap"] for r in rows)
        steps += seg["supersteps"]
    return out


def host_reads(fn) -> int:
    """Synchronizing CUDA operations (host reads and pageable copies)
    while ``fn`` runs, as torch.cuda.set_sync_debug_mode("warn") reports
    them."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchronizing" in str(w.message) for w in caught)


def warm_walls(solvers, problem) -> list[float]:
    """Min over TRACE_REPEATS warm solves of each solver, taken in turns."""
    import torch

    best = [float("inf")] * len(solvers)
    for _ in range(TRACE_REPEATS):
        for i, s in enumerate(solvers):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.solve(problem)
            torch.cuda.synchronize()
            best[i] = min(best[i], time.perf_counter() - t0)
    return best


def paired_walls(base, traced, problem, pairs: int = TRACE_PAIRS) -> tuple[list, list]:
    """Walls of ``pairs`` back-to-back (untraced, traced) warm solves."""
    import torch

    walls = ([], [])
    for _ in range(pairs):
        for w, s in zip(walls, (base, traced)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.solve(problem)
            torch.cuda.synchronize()
            w.append(time.perf_counter() - t0)
    return walls


def paired_median(walls_u, walls_t) -> tuple[float, list[float]]:
    """The median of the per-pair ratios traced / untraced, and the
    ratios: each ratio compares two solves a few milliseconds apart, so a
    slow spell of the host moves a pair, not the median."""
    import statistics

    if len(walls_u) != len(walls_t) or not walls_u:
        raise ValueError(f"need as many untraced as traced walls, at least one: "
                         f"{len(walls_u)} and {len(walls_t)}")
    ratios = [t / u for u, t in zip(walls_u, walls_t)]
    return statistics.median(ratios), ratios


def turns_min_ratio(walls_u, walls_t, n: int = TRACE_REPEATS) -> float:
    """The gate's former statistic: min of the first ``n`` traced walls
    over min of the first ``n`` untraced ones (logged beside the
    median)."""
    return min(walls_t[:n]) / min(walls_u[:n])


def trace_spread(pg, runs: int, card_line: str) -> None:
    """Phase 12(a)'s timing alone, ``runs`` times on phase 2's graph: both
    statistics of each run, main and push specs."""
    import torch

    from repro_torch.api import Problem, SingleSource, Solver, SolverConfig

    problem = Problem(pg, SingleSource(SOURCE))
    out = {}
    for label, cfg in (("fused", SolverConfig.from_spec(SPEC)),
                       ("push", SolverConfig.from_spec("delta:5/sparse",
                                                       relax_impl="push"))):
        base = Solver(cfg, device="cuda")
        traced = Solver(dataclasses.replace(cfg, trace=True), device="cuda")
        base.solve(problem)
        traced.solve(problem)
        torch.cuda.synchronize()
        for run in range(runs):
            walls_u, walls_t = paired_walls(base, traced, problem)
            med, ratios = paired_median(walls_u, walls_t)
            old = turns_min_ratio(walls_u, walls_t)
            out.setdefault(label, []).append(dict(median=med, turns_min=old,
                                                  ratios=ratios))
            log(f"trace spread ({label}) run {run + 1}/{runs}: median of "
                f"{TRACE_PAIRS} pairs {med:.4f}x, min of {TRACE_REPEATS} in turns "
                f"{old:.4f}x; ratios {' '.join(f'{r:.4f}' for r in ratios)}; "
                f"untraced walls {min(walls_u):.4f}-{max(walls_u):.4f} s on {card_line}")
    print(json.dumps({"trace_spread": out, "card": card_line}), flush=True)


def adaptive_paths(g, pg, truth, base_sol, base_push, card_line) -> tuple[int, int]:
    """Phase 12: the flight recorder (/trace) on the main and push paths,
    the adaptive controller (/adapt:rho from a small cap, /adapt:static),
    the quantized exchange (/q:bf16, /q:u16) and the spec auto-tuner
    behind the Router, on phase 2's graph.  Returns the launches of
    fused_superstep and relax_push_gather on these paths."""
    import numpy as np
    import torch

    from repro_torch import kernels as K
    from repro_torch.api import Problem, SingleSource, Solver, SolverConfig
    from repro_torch.launch.serve import build_query_mix
    from repro_torch.obs import MetricsRegistry, Tracer, use_tracer
    from repro_torch.serve import Router
    from repro_torch.tune import AutoTuner

    problem = Problem(pg, SingleSource(SOURCE))
    fused_total = push_total = 0

    # ---- (a) the flight recorder, fused and push --------------------------
    for label, kernel, untraced_sol, cfg in (
        ("fused", "fused_superstep", base_sol, SolverConfig.from_spec(SPEC)),
        ("push", "relax_push_gather", base_push,
         SolverConfig.from_spec("delta:5/sparse", relax_impl="push")),
    ):
        base = Solver(cfg, device="cuda")
        traced = Solver(dataclasses.replace(cfg, trace=True), device="cuda")
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol = traced.solve(problem)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = K.launch_counts()[kernel]
        tr, m = sol.trace, sol.metrics
        if sol.state.tobytes() != untraced_sol.state.tobytes():
            fail(f"traced {label} solve: state differs from the untraced solve")
        if m.as_dict() != untraced_sol.metrics.as_dict():
            fail(f"traced {label} solve: metrics differ: {m} vs {untraced_sol.metrics}")
        tr.reconcile(m)
        if tr.supersteps != m.supersteps or tr.host_sweeps:
            fail(f"traced {label} solve: {tr.supersteps} records for "
                 f"{m.supersteps} supersteps")
        push_steps = push_supersteps(tr)
        if launches != push_steps or launches == 0:
            fail(f"traced {label} solve: {launches} {kernel} launches, "
                 f"{push_steps} push supersteps")
        walls_u, walls_t = paired_walls(base, traced, problem)
        ratio, ratios = paired_median(walls_u, walls_t)
        wall_u = min(walls_u)
        reads_u = host_reads(lambda: base.solve(problem))
        reads_t = host_reads(lambda: traced.solve(problem))
        log(f"trace ({label}) {traced.config.name}: {m.supersteps} supersteps in "
            f"{len(tr.segments)} segments, {sum(tr.sparse_used)} sparse exchanges, "
            f"{push_steps} push supersteps = {launches} {kernel} launches; "
            f"state and metrics equal the untraced solve, the trace reconciles; "
            f"cold traced wall {wall:.4f} s; warm, {TRACE_PAIRS} back-to-back "
            f"pairs: untraced {wall_u:.4f}-{max(walls_u):.4f} s, traced "
            f"{min(walls_t):.4f}-{max(walls_t):.4f} s, ratios "
            f"{' '.join(f'{r:.3f}' for r in ratios)}, median {ratio:.3f}x (gate "
            f"{TRACE_GATE}x; min of the first {TRACE_REPEATS} in turns "
            f"{turns_min_ratio(walls_u, walls_t):.3f}x); host reads untraced "
            f"{reads_u}, traced {reads_t} (+{reads_t - reads_u} for "
            f"{len(tr.segments)} segments) on {card_line}")
        if ratio > TRACE_GATE:
            fail(f"traced {label} solve: median per-pair ratio {ratio:.3f} exceeds "
                 f"{TRACE_GATE}x the untraced solve")
        if reads_t > reads_u + len(tr.segments):
            fail(f"traced {label} solve made {reads_t} host reads, more than "
                 f"the untraced {reads_u} plus one a segment")
        if label == "fused":
            fused_total += launches
            # the untraced solve's host reads beyond three a superstep
            fixed_reads = reads_u - 3 * m.supersteps
            untraced_wall = wall_u
            main = base
            with device_profile(f"one warm traced solve, {traced.config.name}",
                                top=4, kernel=kernel):
                traced.solve(problem)
                torch.cuda.synchronize()
        else:
            push_total += launches

    # ---- (b) the adaptive controller ---------------------------------------
    rho = Solver(SolverConfig.from_spec(SPEC + "/adapt:rho",
                                        frontier_cap=ADAPT_CAP0), device="cuda")
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = rho.solve(problem)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.launch_counts()["fused_superstep"]
    st = rho.stats()["adapt"]
    m = sol.metrics
    if not np.array_equal(sol.state, truth) or not m.converged:
        fail(f"/adapt:rho: state differs from Dijkstra at "
             f"{int((sol.state != truth).sum())} vertices (converged {m.converged})")
    if m.retraces < 1 or st["cap_growths"] < 1 or launches == 0:
        fail(f"/adapt:rho from cap {ADAPT_CAP0}: retraces {m.retraces}, "
             f"cap growths {st['cap_growths']}, {launches} fused launches")
    fused_total += launches
    # the same run recorded: the tunables of its last segment
    rec = Solver(SolverConfig.from_spec(SPEC + "/adapt:rho/trace",
                                        frontier_cap=ADAPT_CAP0), device="cuda")
    last = rec.solve(problem).trace.segments[-1]
    (wall_rho,) = warm_walls([rho], problem)
    reads_a = host_reads(lambda: rho.solve(problem))
    log(f"adapt {rho.config.name} from frontier_cap {ADAPT_CAP0}: equals "
        f"Dijkstra, converged; {m.supersteps} supersteps (main path "
        f"{base_sol.metrics.supersteps}) in {st['segments']} segments, "
        f"retraces {m.retraces}, cap growths {st['cap_growths']}, final cap "
        f"{last['frontier_cap']}, final delta {last['delta']}, "
        f"{launches} fused_superstep launches; sparse fallbacks "
        f"{m.sparse_fallbacks} (main path {base_sol.metrics.sparse_fallbacks}); "
        f"cold wall {wall:.4f} s, warm {wall_rho:.4f} s beside the main path's "
        f"warm {untraced_wall:.4f} s; host reads {reads_a} (3 a superstep "
        f"+ {reads_a - 3 * m.supersteps} against the untraced solve's "
        f"{fixed_reads} + segments {st['segments']}) on {card_line}")
    if reads_a - 3 * m.supersteps > fixed_reads + st["segments"]:
        fail(f"/adapt:rho made {reads_a} host reads, more than three a "
             f"superstep plus one a segment")
    static = Solver(SPEC + "/adapt:static", device="cuda")
    K.reset_launch_counts()
    sol = static.solve(problem)
    launches = K.launch_counts()["fused_superstep"]
    fused_total += launches
    if sol.state.tobytes() != base_sol.state.tobytes() or \
            sol.metrics.as_dict() != base_sol.metrics.as_dict() or sol.metrics.retraces:
        fail(f"/adapt:static differs from the main path: {sol.metrics} vs "
             f"{base_sol.metrics}")
    wall_u, wall_static = warm_walls([main, static], problem)
    log(f"adapt {static.config.name}: state and metrics equal the main path's, "
        f"retraces 0, {launches} fused_superstep launches; warm wall (min of "
        f"{TRACE_REPEATS}, in turns) {wall_static:.4f} s beside the main "
        f"path's {wall_u:.4f} s on {card_line}")

    # ---- (c) the quantized exchange ------------------------------------------
    bm = base_sol.metrics
    for payload in ("bf16", "u16"):
        q = Solver(f"{SPEC}/q:{payload}", device="cuda")
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol = q.solve(problem)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = K.launch_counts()["fused_superstep"]
        fused_total += launches
        m = sol.metrics
        if not np.array_equal(sol.state, truth) or not m.converged:
            fail(f"/q:{payload}: state differs from Dijkstra at "
                 f"{int((sol.state != truth).sum())} vertices")
        if launches == 0:
            fail(f"/q:{payload} never launched fused_superstep")
        (wall_q,) = warm_walls([q], problem)
        log(f"quantized {q.config.name}: equals Dijkstra, converged; "
            f"repair_sweeps {m.repair_sweeps}, supersteps {m.supersteps} (main "
            f"path {bm.supersteps}), exchange_bytes {m.exchange_bytes} (main path "
            f"{bm.exchange_bytes}; one rank moves none), {launches} "
            f"fused_superstep launches; cold wall {wall:.4f} s, warm "
            f"{wall_q:.4f} s beside {untraced_wall:.4f} s on {card_line}")

    # ---- (d) the auto-tuner behind the Router --------------------------------
    t0 = time.perf_counter()
    tuner = AutoTuner(objective="wall", device="cuda")
    rec = tuner.search(g)
    tune_s = time.perf_counter() - t0
    log(f"auto-tuner (objective wall, {tuner.pilots_run} pilots, grid "
        f"{len(tuner.orderings)}x{len(tuner.exchanges)}x{len(tuner.partitions)}) "
        f"in {tune_s:.1f} s: winner {rec.spec!r}, score {rec.score:.4f} s")
    for row in rec.leaderboard:
        log(f"  {row['spec']:24s} score {row['score']:.4f} s, supersteps "
            f"{row['supersteps']}, converged {row['converged']}")
    registry = MetricsRegistry()
    router = Router(Solver(SPEC, device="cuda"), g, tuned=tuner.cache,
                    max_batch=SERVE_MAX_BATCH, max_wait_s=SERVE_MAX_WAIT_S)
    queries = build_query_mix(g, TUNED_QUERIES, SERVE_ZIPF, SEED)
    with use_tracer(Tracer(registry=registry)):
        t0 = time.perf_counter()
        answers = router.serve(queries)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if router.stats.tuned_batches == 0:
        fail(f"the Router served no flush through the tuned spec: "
             f"{router.stats.as_dict()}")
    full = [a for a in answers if a.query.target is None]
    picked = full[:: max(1, len(full) // TUNED_SAMPLED)][:TUNED_SAMPLED]
    rows_ = dijkstra_rows(g, [a.query.source for a in picked])
    for a, row in zip(picked, rows_):
        if not np.array_equal(a.solution.state, row):
            fail(f"tuned answer for source {a.query.source} differs from Dijkstra")
    lines = registry.expose().count("\n")
    log(f"tuned router: {len(answers)} queries in {wall:.3f} s through "
        f"{router.stats.tuned_batches} tuned flushes of {router.stats.batches} "
        f"(spec {rec.spec!r}); {len(picked)} sampled answers equal Dijkstra; "
        f"MetricsRegistry.expose() {lines} lines on {card_line}")
    return fused_total, push_total


def dist_rank(rank: int, world: int, url: str, data_dir: str, device: str) -> None:
    """Phase 13's rank process: join the gloo group, read the graph the
    parent wrote (memory-mapped), partition it, and solve each of
    DIST_SPECS once counted (launches, collectives, the supersteps whose
    frontier fit this rank's cap) and once warm (timed).  Writes its
    results to ``data_dir/rank{rank}.pkl``."""
    import hashlib
    import os
    import pickle

    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    from repro_torch import kernels as K
    from repro_torch.api import Problem, SingleSource, Solver, SolverConfig
    from repro_torch.core import engine
    from repro_torch.graph import Graph
    from repro_torch.launch.mesh import init_ranks, make_rank_mesh

    t_start = time.perf_counter()
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    ranks = init_ranks("gloo", rank, world, make_rank_mesh(world), url)
    meta = json.loads((Path(data_dir) / "graph.json").read_text())
    g = Graph(meta["n"], *(np.load(os.path.join(data_dir, f"{k}.npy"), mmap_mode="r")
                           for k in ("src", "dst", "weight")), name=meta["name"])
    t0 = time.perf_counter()
    first = Solver(DIST_SPECS[0][0], n_parts=world, device=dev, ranks=ranks)
    pg = first.partition(g)
    ell = first.device_ell(pg)
    sync()
    out = dict(partition_s=time.perf_counter() - t0,
               ell_bytes=sum(t.numel() * t.element_size() for t in (ell.col, ell.wgt)),
               ell_shape=tuple(ell.col.shape),
               card_bytes=torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0,
               start_s=t0 - t_start, solves={})
    problem = Problem(pg, SingleSource(SOURCE))
    compact = engine.compact_rows
    for spec, impl in DIST_SPECS:
        solver = Solver(SolverConfig.from_spec(spec, relax_impl=impl),
                        n_parts=world, device=dev, ranks=ranks)
        fits = []

        def counted(mask, cap):
            idx, cnt, over = compact(mask, cap)
            fits.append(not bool(over.any()))
            return idx, cnt, over

        engine.compact_rows = counted
        try:
            K.reset_launch_counts()
            ranks.counts.clear()
            sync()
            t0 = time.perf_counter()
            sol = solver.solve(problem)
            sync()
            cold = time.perf_counter() - t0
        finally:
            engine.compact_rows = compact
        launches = dict(K.launch_counts())
        collectives = dict(ranks.counts)
        torch.distributed.barrier()
        sync()
        t0 = time.perf_counter()
        solver.solve(problem)
        sync()
        warm = time.perf_counter() - t0
        out["solves"][spec] = dict(
            state=sol.state if rank == 0 else None,
            padded=sol.padded if rank == 0 else None,
            digest=hashlib.sha256(sol.state.tobytes() + sol.padded.tobytes()).hexdigest(),
            metrics=sol.metrics.as_dict(), launches=launches, fits=sum(fits),
            collectives=collectives, cold_s=cold, warm_s=warm)
    with open(os.path.join(data_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


def distributed_paths(g, pg, truth, base_sol, card_line, dev) -> int:
    """Phase 13: stacked ranks on flat and pod meshes, gloo rank
    processes sharing the card against the stacked solve at the same P,
    and NCCL at one process against phase 4.  Returns the
    fused_superstep launches of rank 0 on the gloo paths."""
    import pickle
    import tempfile

    import numpy as np
    import torch

    from repro_torch import kernels as K
    from repro_torch.api import Problem, SingleSource, Solver, SolverConfig
    from repro_torch.graph import partition_graph
    from repro_torch.launch.mesh import (
        RankMesh,
        check_backend,
        init_ranks,
        make_rank_mesh,
        spawn_ranks,
    )

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

    def equal_dijkstra(sol, label):
        if not np.array_equal(sol.state, truth) or not sol.metrics.converged:
            fail(f"{label}: state differs from Dijkstra at "
                 f"{int((sol.state != truth).sum())} vertices")

    # ---- (a) stacked ranks on the card, flat and pod meshes ----------------
    t0 = time.perf_counter()
    pgs = {P: partition_graph(g, P) for P in DIST_PROCESSES}
    log(f"partitioned for P = {DIST_PROCESSES} in {time.perf_counter() - t0:.1f} s")
    problems = {P: Problem(pgs[P], SingleSource(SOURCE)) for P in DIST_PROCESSES}
    pods = RankMesh((2, 2), ("pod", "data"))
    for spec in (POD_SPEC, SPEC):
        row = []
        for mesh in (make_rank_mesh(4), pods):
            sol = Solver(spec, n_parts=4, device=dev, mesh=mesh).solve(problems[4])
            equal_dijkstra(sol, f"stacked P=4 {spec} on {mesh.axis_names}")
            row.append(sol.metrics)
        log(f"stacked P=4 {spec}: flat mesh classes={row[0].classes} "
            f"supersteps={row[0].supersteps}; pod mesh (2, 2) classes="
            f"{row[1].classes} supersteps={row[1].supersteps}; both equal Dijkstra")

    # ---- (b) gloo, P processes sharing the card -----------------------------
    stacked, stacked_warm = {}, {}
    for P in DIST_PROCESSES:
        for spec, impl in DIST_SPECS:
            solver = Solver(SolverConfig.from_spec(spec, relax_impl=impl),
                            n_parts=P, device=dev)
            stacked[P, spec] = solver.solve(problems[P])
            sync()
            t0 = time.perf_counter()
            solver.solve(problems[P])
            sync()
            stacked_warm[P, spec] = time.perf_counter() - t0
    fused_total = 0
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        for k in ("src", "dst", "weight"):
            np.save(Path(tmp) / f"{k}.npy", getattr(g, k))
        (Path(tmp) / "graph.json").write_text(json.dumps({"n": g.n, "name": g.name}))
        for P in DIST_PROCESSES:
            run_dir = Path(tmp) / f"gloo{P}"
            run_dir.mkdir()
            t0 = time.perf_counter()
            spawn_ranks(dist_rank, P, ("file://" + str(run_dir / "store"), str(tmp),
                                       str(dev) if dev.type == "cpu" else "cuda:0"),
                        timeout=DIST_TIMEOUT_S)
            # the rank files sit beside the graph: one run at a time
            runs = []
            for r in range(P):
                with open(Path(tmp) / f"rank{r}.pkl", "rb") as f:
                    runs.append(pickle.load(f))
            log(f"gloo P={P}: {P} processes on {card} ran in "
                f"{time.perf_counter() - t0:.1f} s; each partitioned the graph in "
                f"{max(r['partition_s'] for r in runs):.1f} s at most and holds "
                f"its rank's ELL {runs[0]['ell_shape']} on the device: col and "
                f"wgt {[r['ell_bytes'] for r in runs]} bytes (the whole ELL "
                f"{(pg.col.nbytes + pg.wgt.nbytes) / 1e6:.0f} MB); device memory "
                f"allocated {[r['card_bytes'] for r in runs]}")
            for spec, impl in DIST_SPECS:
                want = stacked[P, spec]
                got = runs[0]["solves"][spec]
                label = f"gloo P={P} {spec} ({impl})"
                if got["state"].tobytes() != want.state.tobytes() or \
                        got["padded"].tobytes() != want.padded.tobytes():
                    fail(f"{label}: state differs from the stacked solve")
                if got["metrics"] != want.metrics.as_dict():
                    fail(f"{label}: metrics differ: {got['metrics']} vs "
                         f"{want.metrics.as_dict()}")
                equal_dijkstra(want, label)
                for r in range(1, P):
                    other = runs[r]["solves"][spec]
                    if other["digest"] != got["digest"] or other["metrics"] != got["metrics"]:
                        fail(f"{label}: rank {r} returned another solution")
                kernel = {"fused": "fused_superstep", "push": "relax_push_gather"}.get(impl)
                per_rank = [run["solves"][spec]["launches"].get(kernel, 0) if kernel else 0
                            for run in runs]
                fits = [run["solves"][spec]["fits"] for run in runs]
                if kernel and (per_rank != fits or per_rank[0] == 0):
                    fail(f"{label}: {kernel} launches a rank {per_rank}, supersteps "
                         f"whose frontier fit the rank's cap {fits}")
                if kernel == "fused_superstep":
                    fused_total += per_rank[0]
                coll = got["collectives"]
                m = got["metrics"]
                steps = max(1, m["supersteps"])
                log(f"{label}: equals the stacked solve and Dijkstra on every rank; "
                    f"supersteps={m['supersteps']} sparse_fallbacks={m['sparse_fallbacks']} "
                    f"repair_sweeps={m['repair_sweeps']} exchange_bytes="
                    f"{m['exchange_bytes']}; {kernel or 'no frontier kernel'} launches "
                    f"a rank {per_rank} (frontier fit {fits}); rank 0 collectives "
                    f"{ {k: v for k, v in coll.items() if k != 'bytes'} } = "
                    f"{sum(v for k, v in coll.items() if k != 'bytes') / steps:.2f} a "
                    f"superstep, {coll.get('bytes', 0)} bytes sent "
                    f"({coll.get('bytes', 0) / steps:.0f} a superstep); wall cold "
                    f"{got['cold_s']:.4f} s, warm {got['warm_s']:.4f} s; the stacked "
                    f"P={P} solve warm {stacked_warm[P, spec]:.4f} s - gloo through "
                    f"host memory on one card, not a scaling figure; {card_line}")
            exact = runs[0]["solves"][SPEC]["metrics"]["exchange_bytes"]
            quant = runs[0]["solves"][SPEC + "/q:u16"]["metrics"]["exchange_bytes"]
            log(f"gloo P={P}: /q:u16 exchange_bytes {quant} against the exact "
                f"spec's {exact} ({quant / max(1, exact):.3f}x)")
            for r in range(P):
                (Path(tmp) / f"rank{r}.pkl").unlink()

    # ---- (c) NCCL, one process ------------------------------------------
    check_backend(NCCL_BACKEND, 1, dev)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        ranks = init_ranks(NCCL_BACKEND, 0, 1, make_rank_mesh(1),
                           "file://" + str(Path(tmp) / "store"))
        try:
            solver = Solver(SPEC, device=dev, ranks=ranks)
            problem = Problem(pg, SingleSource(SOURCE))
            K.reset_launch_counts()
            sync()
            t0 = time.perf_counter()
            sol = solver.solve(problem)
            sync()
            cold = time.perf_counter() - t0
            launches = K.launch_counts()["fused_superstep"]
            t0 = time.perf_counter()
            solver.solve(problem)
            sync()
            warm = time.perf_counter() - t0
        finally:
            torch.distributed.destroy_process_group()
    if sol.state.tobytes() != base_sol.state.tobytes() or \
            sol.metrics.as_dict() != base_sol.metrics.as_dict():
        fail(f"{NCCL_BACKEND} P=1: differs from phase 4: {sol.metrics} vs "
             f"{base_sol.metrics}")
    if launches == 0:
        fail(f"{NCCL_BACKEND} P=1 never launched fused_superstep")
    fused_total += launches
    log(f"{NCCL_BACKEND} P=1 {solver.config.name}: state and metrics equal phase 4's; "
        f"{launches} fused_superstep launches; wall cold {cold:.4f} s, warm "
        f"{warm:.4f} s; {card_line}")
    return fused_total


def phase14_inputs(g):
    """Phase 11's first improving update applied to a copy of ``g``, and
    the vertex (a)'s source addition adds (the top landmark hub)."""
    import numpy as np

    from repro_torch.graph import Graph
    from repro_torch.launch.serve import improving_updates
    from repro_torch.serve import pick_landmarks

    upd = next(improving_updates(g, SERVE_UPDATES, SEED + 1))
    weight = np.array(g.weight)
    weight[(g.src == upd.src) & (g.dst == upd.dst)] = np.float32(upd.weight)
    g2 = Graph(g.n, g.src, g.dst, weight, name=g.name)
    return upd, g2, pick_landmarks(g, 1)[0]


def digest(sol) -> str:
    import hashlib

    return hashlib.sha256(sol.state.tobytes() + sol.padded.tobytes()).hexdigest()


def answer_record(a) -> tuple:
    """An answer as comparable values: the query, its bounds or distance,
    and its solution's digest and metrics (``served_by`` and the latency
    depend on the flush boundaries, which the wall clock sets)."""
    sol = a.solution
    return ((a.query.source, a.query.target, a.query.exact), a.served_by == "landmark",
            a.distance, a.lower, a.upper,
            None if sol is None else (digest(sol), sol.metrics.as_dict()))


def resolve_cases(solver, g, g2, v, sync):
    """(a): a solve of SOURCE on ``g``, then resolve after the improving
    update (``g2``) and after adding source ``v``: each case's solution
    (first call) and warm wall (a second call)."""
    from repro_torch.api import Problem, SingleSource

    prev = solver.solve(Problem(g, SingleSource(SOURCE)))
    out = {}
    for kind, call in (("update", lambda: solver.resolve(prev, graph=g2)),
                       ("source", lambda: solver.resolve(prev, [v]))):
        sol = call()
        sync()
        t0 = time.perf_counter()
        call()
        sync()
        out[kind] = (sol, time.perf_counter() - t0)
    return out


def service_rank(rank: int, world: int, url: str, data_dir: str, device: str,
                 serve: bool) -> None:
    """Phase 14's rank process: join the gloo group, read the graph the
    parent wrote, run (a) resolve after the improving update and after
    the source addition, and with ``serve`` (b) the query service at the
    reference service CLI's defaults: rank 0 serves, the others follow;
    then the batched fused entry at its largest superstep in this rank,
    checked and timed on rank 0.  Writes ``data_dir/rank{rank}.pkl``."""
    import gc
    import os
    import pickle

    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    from repro_torch import kernels as K
    from repro_torch.api import Problem, SingleSource, Solver
    from repro_torch.core import engine as E
    from repro_torch.graph import Graph, graph_fingerprint
    from repro_torch.launch.mesh import init_ranks, make_rank_mesh
    from repro_torch.launch.serve import build_query_mix, improving_updates
    from repro_torch.obs import trace as obs
    from repro_torch.serve import (
        LandmarkIndex,
        Router,
        SolutionCache,
        UpdateFeed,
        serve_latency_stats,
    )
    from repro_torch.serve.stream import stream_for

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.set_device(dev)
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    ranks = init_ranks("gloo", rank, world, make_rank_mesh(world), url)
    meta = json.loads((Path(data_dir) / "graph.json").read_text())
    g = Graph(meta["n"], *(np.load(os.path.join(data_dir, f"{k}.npy"), mmap_mode="r")
                           for k in ("src", "dst", "weight")), name=meta["name"])
    upd, g2, v = phase14_inputs(g)
    leader = rank == 0
    out = dict(resolve={})

    # ---- (a) resolve after the update and after the source addition ---
    solver = Solver(SPEC, n_parts=world, device=dev, ranks=ranks)
    K.reset_launch_counts()
    for kind, (sol, wall) in resolve_cases(solver, g, g2, v, sync).items():
        out["resolve"][kind] = dict(
            state=sol.state if leader else None, padded=sol.padded if leader else None,
            digest=digest(sol), metrics=sol.metrics.as_dict(), warm_s=wall)
    out["resolve_launches"] = dict(K.launch_counts())
    del solver, sol
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    if not serve:
        with open(os.path.join(data_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        torch.distributed.destroy_process_group()
        return

    # ---- (b) the query service: rank 0 serves, the others follow ----
    gs = Graph(g.n, np.array(g.src), np.array(g.dst), np.array(g.weight), name=g.name)
    solver = Solver(SPEC, n_parts=world, device=dev, ranks=ranks)
    stream = stream_for(solver)
    tracer = obs.Tracer()
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    mem0 = torch.cuda.memory_allocated(dev) if on_card else 0

    def round_of(drive):
        if leader:
            res = drive()
            router.close()
            return res
        return router.follow()

    with obs.use_tracer(tracer):
        t0 = time.perf_counter()
        lm = LandmarkIndex(solver, gs, k=SERVE_LANDMARKS, symmetric=True)
        sync()
        build_s = time.perf_counter() - t0
        cache = SolutionCache(byte_budget=SERVE_CACHE_MB << 20)
        router = Router(solver, gs, cache=cache, landmarks=lm,
                        max_batch=SERVE_MAX_BATCH, max_wait_s=SERVE_MAX_WAIT_S)
        feed = UpdateFeed(gs, solver, cache=cache, landmarks=lm)
        queries = build_query_mix(gs, SERVE_QUERIES, SERVE_ZIPF, SEED)
        round_of(lambda: router.serve(queries[:SERVE_MAX_BATCH]))  # warm-up
        cache.clear()
        cache.stats.hits = cache.stats.misses = 0
        tracer.clear()
        sent = stream.broadcasts

        def mix():
            tickets = []
            for q in queries:
                tickets.append(router.submit(q))
                router.pump()
            router.flush()
            return tickets

        K.reset_launch_counts()  # the main path's run: the mix
        ranks.counts.clear()
        sync()
        t0 = time.perf_counter()
        tickets = round_of(mix)
        sync()
        wall = time.perf_counter() - t0
        launches = dict(K.launch_counts())
        collectives = dict(ranks.counts)
        broadcasts = stream.broadcasts - sent
        answers = [t.answer for t in tickets]
        lm_mix = array_digest(lm.dist)  # the matrix the mix was served from
        flushes = [sp.duration_s for sp in tracer.find("router.flush")]
        lat = serve_latency_stats(answers)

        # the 4 improving updates, each timed on rank 0
        def updates():
            walls = []
            for u in improving_updates(gs, SERVE_UPDATES, SEED + 1):
                t1 = time.perf_counter()
                feed.apply(u)
                sync()
                walls.append(time.perf_counter() - t1)
            return walls

        tracer.clear()
        apply_s = round_of(updates)  # (a follower's: the tickets it replayed, none)
        repart_s = sum(sp.duration_s for sp in tracer.find("solver.partition"))
    fp = graph_fingerprint(gs)
    # freshness, on every rank (the caches agree; the solves are collective)
    fresh = cache.entries_for(fp)[:SERVE_FRESH]
    stale = [key[1] for key, sol in fresh if sol.state.tobytes() != solver.solve(
        Problem(gs, SingleSource(key[1]))).state.tobytes()]
    cold_lm = solver.solve(Problem(gs, SingleSource(lm.landmarks[0])))
    gc.collect()
    parts = {id(sol.pg): sol.pg for _, sol in cache.entries_for(fp)}
    parts.update({id(sol.pg): sol.pg for sol in lm.solutions})
    out.update(
        answers=[answer_record(a) for a in answers],
        latencies=[a.latency_s for a in answers],
        cache=cache.stats.as_dict(), keys=list(cache.keys()),
        router=router.stats.as_dict(), feed=feed.stats.as_dict(),
        landmarks=array_digest(lm.dist), landmarks_mix=lm_mix, landmark_s=build_s,
        fingerprint=fp,
        wall_s=wall, p50_s=lat.p50_s, p99_s=lat.p99_s, flushes=flushes,
        apply_s=apply_s, repartition_s=repart_s, launches=launches,
        collectives=collectives, broadcasts=broadcasts, fresh=len(fresh), stale=stale,
        landmark_fresh=cold_lm.state.tobytes() == lm.solutions[0].state.tobytes(),
        mem_start=mem0,
        mem_peak=torch.cuda.max_memory_allocated(dev) if on_card else 0,
        mem_now=torch.cuda.memory_allocated(dev) if on_card else 0,
        partitions=len(parts),
        partitions_on_card=sum(bool(pg._device) for pg in parts.values()),
        memo=solver.stats()["partition_memo_size"])
    # the mix's answers hold the partition they were solved on; drop them
    del parts, fresh, cold_lm, answers, tickets
    gc.collect()
    out["mem_dropped"] = torch.cuda.memory_allocated(dev) if on_card else 0

    # ---- the batched fused entry in this rank, at its largest superstep
    best = {}
    real = E.fused_superstep_batch

    def capture(dist, row_idx, count, *rest):
        live = int(count.sum())
        if live > best.get("live", -1):
            best.update(live=live, dist=dist.clone(), row_idx=row_idx.clone(),
                        count=count.clone())
        return real(dist, row_idx, count, *rest)

    E.fused_superstep_batch = capture
    try:
        solver.solve_batch([Problem(gs, SingleSource(u)) for u in lm.landmarks])
    finally:
        E.fused_superstep_batch = real
    if leader:
        flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
        pg = solver.partition(gs)
        out["batch_rows"] = batched_entry_rows(
            f"rank 0 of P={world}, its largest superstep of a batch of the "
            f"{len(lm.landmarks)} landmarks", best["dist"], best["row_idx"],
            best["count"], solver.device_ell(pg), pg.n_pad, flush, None)
        out["batch_shape"] = (tuple(solver.device_ell(pg).col.shape), pg.n_pad)
    torch.distributed.barrier()
    with open(os.path.join(data_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


def array_digest(a) -> str:
    import hashlib

    return hashlib.sha256(a.tobytes()).hexdigest()


def spawn_phase14(world: int, tmp: Path, dev, serve: bool, timeout: float) -> list:
    """Run ``service_rank`` in ``world`` gloo processes sharing the card;
    returns each rank's results."""
    import pickle

    from repro_torch.launch.mesh import spawn_ranks

    run_dir = tmp / f"gloo{world}"
    run_dir.mkdir()
    t0 = time.perf_counter()
    try:
        spawn_ranks(service_rank, world, ("file://" + str(run_dir / "store"), str(tmp),
                                          "cuda:0" if dev.type == "cuda" else "cpu",
                                          serve), timeout=timeout)
    except (RuntimeError, TimeoutError) as e:
        fail(f"phase 14 at P={world}: {e}")
    runs = []
    for r in range(world):
        path = tmp / f"rank{r}.pkl"
        with open(path, "rb") as f:
            runs.append(pickle.load(f))
        path.unlink()
    log(f"gloo P={world}: {world} processes ran in {time.perf_counter() - t0:.1f} s")
    return runs


def stacked_service(solver, g, queries, sync):
    """(b)'s reference: the same landmarks and query mix through the
    stacked service at the same P (a warm-up batch first, as the rank
    processes serve)."""
    from repro_torch.serve import LandmarkIndex, Router, SolutionCache

    lm = LandmarkIndex(solver, g, k=SERVE_LANDMARKS, symmetric=True)
    cache = SolutionCache(byte_budget=SERVE_CACHE_MB << 20)
    router = Router(solver, g, cache=cache, landmarks=lm,
                    max_batch=SERVE_MAX_BATCH, max_wait_s=SERVE_MAX_WAIT_S)
    router.serve(queries[:SERVE_MAX_BATCH])
    cache.clear()
    sync()
    t0 = time.perf_counter()
    tickets = []
    for q in queries:
        tickets.append(router.submit(q))
        router.pump()
    router.flush()
    sync()
    wall = time.perf_counter() - t0
    return [answer_record(t.answer) for t in tickets], wall, lm.dist


def process_service(g, dev, card_line) -> tuple[int, dict]:
    """Phase 14: (a) resolve over gloo at P 2 and 4 against the stacked
    resolve and a cold solve; (b) the query service over gloo at P 2
    against the stacked service, answer for answer, every rank's
    counters equal; the batched fused entry at a rank's shape against
    its plain version; (c) the SSSP CLI's reference flags.  Returns the
    fused_superstep_batch launches of rank 0 in (b)'s mix, and that
    entry's row of the kernels line (at the rank's shape)."""
    import contextlib
    import gc
    import io
    import tempfile

    import numpy as np
    import torch

    from repro_torch.api import MultiSource, Problem, SingleSource, Solver
    from repro_torch.launch import sssp as sssp_cli
    from repro_torch.launch.serve import build_query_mix

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    upd, g2, v = phase14_inputs(g)
    log(f"phase 11's first improving update {upd}; the source addition adds {v}")

    # ---- the stacked references at the same P ---------------------------
    stacked, solvers = {}, {}
    for P in RESOLVE_PROCESSES:
        solver = solvers[P] = Solver(SPEC, n_parts=P, device=dev)
        cases = resolve_cases(solver, g, g2, v, sync)
        cold = {"update": solver.solve(Problem(g2, SingleSource(SOURCE))),
                "source": solver.solve(Problem(g, MultiSource((SOURCE, v))))}
        for kind, (sol, wall) in cases.items():
            if sol.state.tobytes() != cold[kind].state.tobytes():
                fail(f"stacked P={P} resolve ({kind}) differs from a cold solve")
            stacked[P, kind] = (sol, wall)
    queries = build_query_mix(g, SERVE_QUERIES, SERVE_ZIPF, SEED)
    want_answers, stacked_wall, want_lm = stacked_service(
        solvers[SERVICE_PROCESSES], g, queries, sync)
    log(f"stacked P={SERVICE_PROCESSES} service: {len(queries)} queries in "
        f"{stacked_wall:.3f} s = {len(queries) / stacked_wall:.1f} q/s")
    del solvers, solver, cases, cold
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # ---- gloo processes sharing the card --------------------------------
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        tmp = Path(tmp)
        for k in ("src", "dst", "weight"):
            np.save(tmp / f"{k}.npy", getattr(g, k))
        (tmp / "graph.json").write_text(json.dumps({"n": g.n, "name": g.name}))
        runs = {P: spawn_phase14(P, tmp, dev, P == SERVICE_PROCESSES,
                                 SERVICE_TIMEOUT_S if P == SERVICE_PROCESSES
                                 else DIST_TIMEOUT_S)
                for P in sorted(RESOLVE_PROCESSES, reverse=True)}

    # ---- (a) resolve -----------------------------------------------------
    for P in RESOLVE_PROCESSES:
        for kind in ("update", "source"):
            want, want_wall = stacked[P, kind]
            got = runs[P][0]["resolve"][kind]
            label = f"gloo P={P} resolve after the {kind}"
            if got["state"].tobytes() != want.state.tobytes() or \
                    got["padded"].tobytes() != want.padded.tobytes():
                fail(f"{label}: differs from the stacked resolve")
            if got["metrics"] != want.metrics.as_dict():
                fail(f"{label}: metrics differ: {got['metrics']} vs "
                     f"{want.metrics.as_dict()}")
            for r in range(1, P):
                other = runs[P][r]["resolve"][kind]
                if other["digest"] != got["digest"] or other["metrics"] != got["metrics"]:
                    fail(f"{label}: rank {r} returned another solution")
            log(f"{label}: equals the stacked resolve (state, padded state, "
                f"metrics) on every rank and a cold solve's state; supersteps "
                f"{got['metrics']['supersteps']}; warm wall {got['warm_s']:.4f} s "
                f"(ranks {[run['resolve'][kind]['warm_s'] for run in runs[P]]}), the "
                f"stacked P={P} resolve's {want_wall:.4f} s; {card_line}")
        log(f"gloo P={P} resolves: rank 0 launches "
            f"{ {k: n for k, n in runs[P][0]['resolve_launches'].items() if n} }")

    # ---- (b) the query service -------------------------------------------
    P = SERVICE_PROCESSES
    svc = runs[P]
    lead = svc[0]
    if len(lead["answers"]) != len(want_answers):
        fail(f"gloo P={P} service: {len(lead['answers'])} answers, the stacked "
             f"service {len(want_answers)}")
    for i, (got, want) in enumerate(zip(lead["answers"], want_answers)):
        if got != want:
            fail(f"gloo P={P} service: answer {i} ({got[0]}) differs from the "
                 f"stacked service's")
    if lead["landmarks_mix"] != array_digest(want_lm):
        fail(f"gloo P={P} service: the landmark matrix differs from the stacked one's")
    for r in range(1, P):
        for key in ("answers", "cache", "keys", "router", "feed", "landmarks",
                    "landmarks_mix", "fingerprint", "fresh", "stale", "landmark_fresh"):
            if svc[r][key] != lead[key]:
                fail(f"gloo P={P} service: rank {r}'s {key} differs from rank 0's")
    if lead["stale"] or not lead["landmark_fresh"] or lead["fresh"] < SERVE_FRESH:
        fail(f"gloo P={P} service: refreshed entries {lead['stale']} or the "
             f"landmark differ from cold solves ({lead['fresh']} checked)")
    # each rank launches the batched entry on the supersteps whose
    # frontier fits its own cap
    batch_launches = lead["launches"].get("fused_superstep_batch", 0)
    if not all(run["launches"].get("fused_superstep_batch", 0) for run in svc):
        fail(f"gloo P={P} service: fused_superstep_batch launches a rank "
             f"{[run['launches'] for run in svc]}")
    flushes = len(lead["flushes"])
    wall = lead["wall_s"]
    log(f"gloo P={P} service: {SERVE_QUERIES} queries in {wall:.3f} s = "
        f"{SERVE_QUERIES / wall:.1f} q/s (stacked P={P}: "
        f"{SERVE_QUERIES / stacked_wall:.1f} q/s), p50 {lead['p50_s'] * 1e3:.1f} ms, "
        f"p99 {lead['p99_s'] * 1e3:.1f} ms; every answer equals the stacked "
        f"service's; {flushes} flushes, flush wall mean "
        f"{np.mean(lead['flushes']):.3f} s; {lead['broadcasts']} broadcasts "
        f"({lead['broadcasts'] / max(1, flushes):.2f} a flush, the close's "
        f"included); rank 0 collectives "
        f"{ {k: n for k, n in lead['collectives'].items() if k != 'bytes'} }; "
        f"fused_superstep_batch launches a rank "
        f"{[run['launches'].get('fused_superstep_batch', 0) for run in svc]}, "
        f"fused_superstep {[run['launches'].get('fused_superstep', 0) for run in svc]}; "
        f"landmarks built in {lead['landmark_s']:.3f} s; {card_line}")
    log(f"gloo P={P} service: cache {lead['cache']}, router {lead['router']}, "
        f"feed {lead['feed']} - equal on every rank")
    log(f"gloo P={P} updates: apply {[round(x, 3) for x in lead['apply_s']]} s "
        f"(re-partitions {lead['repartition_s']:.3f} s in all on rank 0); "
        f"{lead['fresh']} refreshed entries and a landmark equal cold solves")
    for r, run in enumerate(svc):
        log(f"gloo P={P} rank {r} card memory: {run['mem_start'] / 2**30:.2f} GiB "
            f"when (b) began, peak {run['mem_peak'] / 2**30:.2f} GiB, "
            f"{run['mem_now'] / 2**30:.2f} GiB after the updates with the mix's "
            f"answers held, {run['mem_dropped'] / 2**30:.2f} GiB once they are "
            f"dropped; the cache's and landmarks' solutions reference "
            f"{run['partitions']} partition(s), {run['partitions_on_card']} with an "
            f"ELL on the card; the solver's memo holds {run['memo']}")
    row = dict(lead["batch_rows"][0])
    row["name"] = f"fused_superstep_batch (a rank of P {P})"
    row["launches"] = batch_launches
    (ell_shape, n_out) = lead["batch_shape"]
    log(f"the batched entries at a rank's shape (ELL {ell_shape}, n_out {n_out}): "
        f"bit-identical to their plain versions in rank 0")

    # ---- (c) the SSSP CLI's reference flags -------------------------------
    argv = ["--device", dev.type, "--scale", str(SCALE), "--seed", str(SEED),
            "--root", "delta:5", "--variant", "buffer", "--exchange", "sparse",
            "--partition", "ebal", "--verify"]
    real_graph = sssp_cli.build_graph
    # phase 2's graph is the one the CLI would generate: skip the 25 s
    sssp_cli.build_graph = (lambda kind, scale, seed: g
                            if (kind, scale, seed) == ("rmat1", SCALE, SEED)
                            else real_graph(kind, scale, seed))
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = sssp_cli.main(argv)
    finally:
        sssp_cli.build_graph = real_graph
    out = buf.getvalue()
    for line in out.splitlines():
        log(f"cli: {line}")
    if rc != 0 or "verify vs Dijkstra: OK" not in out or \
            "load balance (ebal)" not in out or "straggler ratio" not in out:
        fail(f"launch.sssp {' '.join(argv)}: exit {rc}, no verified state or no "
             "load-balance lines")
    log(f"launch.sssp {' '.join(argv)}: equals Dijkstra in "
        f"{time.perf_counter() - t0:.1f} s (phase 2's graph)")
    return batch_launches, row


def analysis_gate(card_line) -> int:
    """Phase 15 (a): the port's static-analysis gate on the card, the
    quick grid at GATE_RANKS stacked ranks with the repository's
    baseline: gate ok; fingerprints and host reads equal to the same
    report on the CPU; every /fused point that no fused-kernel-escape
    names launched its kernel; the escape cases reported and the main
    spec not; the CLI exits 0.  Returns the kernel launches of the
    report's /fused points."""
    from repro_torch import kernels as K
    from repro_torch.analyze.engine_lint import StepShape, lint_engine
    from repro_torch.analyze.report import render_report, run_report
    from repro_torch.api import SolverConfig, get_processing

    baseline = str(ROOT / "analyze_baseline_torch.json")
    # the CLI in a process of its own, beside the reports below
    tmp = tempfile.TemporaryDirectory()
    t_cli = time.perf_counter()
    cli = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.analyze", "--quick",
         "--ranks", str(GATE_RANKS), "--json", str(Path(tmp.name) / "report.json")],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    reports = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        K.reset_launch_counts()
        reports[device] = rep = run_report(quick=True, device=device,
                                           n_parts=GATE_RANKS,
                                           baseline_path=baseline)
        log(f"analyze gate on {device} (quick grid, {GATE_RANKS} stacked ranks): "
            f"{rep['points']} points, {rep['traced_engines']} engines run, "
            f"{rep['counts']} findings ({len(rep['baselined'])} baselined), "
            f"gate {'OK' if rep['ok'] else 'FAIL'} in "
            f"{time.perf_counter() - t0:.1f} s on {card_line}")
    card, cpu = reports["cuda"], reports["cpu"]
    if not card["ok"]:
        fail(f"the analyze gate failed on the card:\n{render_report(card)}")

    def fingerprints(r):
        return sorted(f["fp"] for f in r["findings"] + r["baselined"])

    def syncs(r):
        return {s: e["host_syncs"] for s, e in r["engine"].items()}

    if fingerprints(card) != fingerprints(cpu):
        fail("the analyze findings differ between the card and the CPU")
    if syncs(card) != syncs(cpu):
        fail(f"host reads differ between the card and the CPU: {syncs(card)} "
             f"against {syncs(cpu)}")
    escaped = {f["subject"] for f in card["findings"] + card["baselined"]
               if f["rule"] == "fused-kernel-escape"}
    fused = {s: e for s, e in card["engine"].items()
             if e["kernel"] == "fused_superstep"}
    for s, e in fused.items():
        if s not in escaped and e["kernel_calls"] == 0:
            fail(f"analyze gate: {s} names no escape but launched no fused_superstep")
    launches = sum(e["kernel_calls"] for e in fused.values())
    per_step = {s: f"{e['host_syncs']}/{e['supersteps']}" for s, e in card["engine"].items()}
    fused_launches = {s: e["kernel_calls"] for s, e in fused.items()}
    log(f"analyze gate: fingerprints and host reads equal on the card and the CPU; "
        f"fused_superstep launches of the /fused points {fused_launches}; "
        f"host reads / supersteps by engine: {per_step}; {card_line}")
    for spec, proc in GATE_ESCAPES + ((SPEC, "sssp"),):
        cfg = SolverConfig.from_spec(spec).engine_config(get_processing(proc))
        K.reset_launch_counts()
        found = lint_engine(cfg, StepShape(), GATE_RANKS, "cuda")
        escape = [f for f in found if f.rule == "fused-kernel-escape"]
        stats = [f.message for f in found if f.rule == "engine-stats"]
        want = (spec, proc) != (SPEC, "sssp")
        if bool(escape) != want:
            fail(f"analyze: {spec} ({proc}) {'not ' if want else ''}reported as "
                 f"a fused-kernel escape: {[str(f) for f in found]}")
        log(f"analyze {spec} ({proc}): {'fused-kernel-escape reported' if want else 'no escape'}"
            f", fused_superstep launches {K.launch_counts()['fused_superstep']}; {stats[0]}; "
            f"{card_line}")
    try:
        out, err = cli.communicate(timeout=GATE_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        cli.kill()
        cli.communicate()
        fail(f"python -m repro_torch.launch.analyze did not end in {GATE_TIMEOUT_S} s")
    finally:
        tmp.cleanup()
    if cli.returncode != 0:
        fail(f"python -m repro_torch.launch.analyze --quick --ranks {GATE_RANKS} "
             f"exited {cli.returncode}:\n{out[-3000:]}{err[-3000:]}")
    log(f"python -m repro_torch.launch.analyze --quick --ranks {GATE_RANKS}: exit 0 "
        f"in {time.perf_counter() - t_cli:.1f} s (beside the reports); "
        f"{out.strip().splitlines()[-2]}; {card_line}")
    return launches


def largest_class_state(g, pg, truth):
    """The engine state at the main path's superstep with the largest
    frontier that fits its row capacity (phase 3's largest frontier):
    D holds the classes below it, T those up to it, so the class is
    exactly what is pending.  Returns ((D, T, L) of (1, n_local+1), the
    class, its rows)."""
    import numpy as np
    import torch

    from repro_torch.core import DeltaStepping
    from repro_torch.core.frontier import frontier_caps

    row_cap, _ = frontier_caps(pg.rows_per_rank, pg.width, pg.n_local, 1)
    cls = DeltaStepping(5.0).class_key(torch.as_tensor(truth), None).numpy()
    rs = pg.row_src[0]
    real = rs < g.n
    row_cls = cls[rs[real]]
    fin = np.isfinite(row_cls)
    counts = np.bincount(row_cls[fin].astype(np.int64))
    fits = np.flatnonzero((counts > 0) & (counts <= row_cap))
    c = int(fits[np.argmax(counts[fits])])
    pad = np.full(pg.n_local + 1, np.inf, dtype=np.float32)
    D, T = pad.copy(), pad.copy()
    D[:g.n] = np.where(cls < c, truth, np.inf)
    T[:g.n] = np.where(cls <= c, truth, np.inf)
    return (D[None], T[None], pad[None].copy()), c, int(counts[c]), row_cap


def superstep_profiles(g, pg, truth, supersteps, card_line) -> None:
    """Phase 15 (b): the superstep profile at full width (rmat1 scale 20,
    one rank) at the superstep with the largest frontier, for the main
    spec, push and a2a: charged bytes by op, the kernel's closed form,
    device time, the memory bound and its share; then one whole warm
    main solve."""
    from repro_torch.api import SolverConfig, get_processing
    from repro_torch.roofline import superstep_profile

    sssp = get_processing("sssp")
    state, c, rows, row_cap = largest_class_state(g, pg, truth)
    log(f"superstep profile: delta class {c}, {rows} of F={row_cap} rows pending "
        f"(rmat1 scale {SCALE}, one rank, ELL W {pg.width}); {card_line}")
    for spec, impl in PROFILE_SPECS:
        ecfg = SolverConfig.from_spec(spec, relax_impl=impl).engine_config(sssp)
        pr = superstep_profile(ecfg, pg, "cuda", state=state)
        if pr["supersteps"] != 1:
            fail(f"superstep profile {spec} ({impl}) ran {pr['supersteps']} supersteps")
        want = {"fused": "fused_superstep", "push": "relax_push_gather"}.get(impl)
        if want is not None and pr["launches"].get(want, 0) != 1:
            fail(f"superstep profile {spec} ({impl}): launches {pr['launches']}, "
                 f"not one {want}")
        kernel = ""
        if "kernel_bytes" in pr:
            kernel = (f"; {pr['kernel']} closed form {pr['kernel_bytes']} bytes "
                      f"({pr['kernel_bytes'] / pr['hbm_bytes_per_superstep']:.3f} of "
                      f"the charge), the plain relax's superstep {pr['hbm_bytes_unfused']} "
                      f"bytes, its relax region {pr['relax_region_bytes']}")
        log(f"superstep profile {spec} (relax {impl}): {pr['hbm_bytes_per_superstep']} "
            f"bytes charged; by op {pr['hbm_by_op']}{kernel}; device "
            f"{pr['device_ms']:.4f} ms, memory bound {pr['bound_ms']:.4f} ms "
            f"({pr['bound_share']:.3f} of it), launches {pr['launches']}; {card_line}")
    ecfg = SolverConfig.from_spec(SPEC).engine_config(sssp)
    pr = superstep_profile(ecfg, pg, "cuda", source=SOURCE)
    if pr["supersteps"] != supersteps:
        fail(f"profiled main solve ran {pr['supersteps']} supersteps, not {supersteps}")
    log(f"whole warm main solve {SPEC}: {pr['supersteps']} supersteps, "
        f"{pr['hbm_bytes_total']} bytes charged ({pr['hbm_bytes_per_superstep']} a "
        f"superstep; by op {pr['hbm_by_op']}), memory term {pr['t_memory_ms']:.3f} ms; "
        f"device {pr['device_ms']:.3f} ms ({pr['bound_share']:.3f} of it), warm wall "
        f"{pr['wall_s']:.4f} s; launches {pr['launches']}; {card_line}")


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def dryrun_cells(card_line) -> None:
    """Phase 16(a): the dry-run CLI over every planned cell at 1 and 4
    ranks (meta tensors, no card), one line a cell."""
    ranks = [str(r) for r in DRYRUN_RANKS]
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--all", "--ranks",
             *ranks, "--out", tmp], env=env, capture_output=True, text=True,
            timeout=DRIVERS_TIMEOUT_S)
        wall = time.perf_counter() - t0
        if out.returncode != 0:
            fail(f"launch.dryrun --all exited {out.returncode}: {out.stderr[-2000:]}")
        recs = [json.loads(p.read_text()) for p in sorted(Path(tmp).glob("*.json"))]
    from repro_torch.configs import all_cells

    want = len(all_cells()) * len(DRYRUN_RANKS)
    if len(recs) != want or not all(r["ok"] for r in recs):
        fail(f"dry-run: {len(recs)} records, {sum(r['ok'] for r in recs)} ok, "
             f"want {want} ok")
    for r in sorted(recs, key=lambda r: (r["ranks"], r["arch"], r["cell"])):
        peak = r["peak_bytes_per_card"]
        log(f"dryrun {r['arch']} {r['cell']} P{r['ranks']}: args "
            f"{r['arg_bytes_per_card']} bytes a card, peak plan "
            f"{'-' if peak is None else f'{peak} bytes'} a card, "
            f"{'fits' if r['fits_one_card'] else 'does not fit'} one H100 80 GB"
            + ("" if peak is not None else " (arguments alone)"))
    log(f"dry-run of {len(all_cells())} cells at ranks {list(DRYRUN_RANKS)}: "
        f"{len(recs)} records ok in {wall:.1f} s")


def plan_against_card(pg, truth, dev, card_line) -> None:
    """Phase 16(b): the SSSP plan at phase 2's partition shape against the
    card: argument and resident bytes equal, the superstep peak plan
    within PEAK_BAND of the peak a warm solve allocates."""
    import numpy as np
    import torch

    from repro_torch.api import Problem, SingleSource, Solver, SolverConfig
    from repro_torch.configs.cells import sssp_plan
    from repro_torch.core.engine import initial_state, sssp_sources
    from repro_torch.core.processing import SSSP
    from repro_torch.launch.dryrun import superstep_peak

    ell = pg.to(dev)
    state = [torch.as_tensor(a, device=dev)
             for a in initial_state(pg, SSSP, sssp_sources(SOURCE))]
    args_bytes = nbytes([ell.row_src, ell.col, ell.wgt] + state)
    resident_bytes = nbytes(list(ell) + state)
    del state
    problem = Problem(pg, SingleSource(SOURCE))
    for spec in PEAK_SPECS:
        cfg = SolverConfig.from_spec(spec)
        plan = sssp_plan("sssp", f"rmat1_s{SCALE}", cfg, n_parts=1,
                         n_local=pg.n_local, rows=pg.rows_per_rank, width=pg.width)
        est = superstep_peak(plan)
        if plan.arg_bytes != args_bytes or est["resident"] != resident_bytes:
            fail(f"{spec}: plan's argument bytes {plan.arg_bytes} and resident "
                 f"{est['resident']} differ from the card's {args_bytes} and "
                 f"{resident_bytes}")
        solver = Solver(cfg, device="cuda")
        solver.solve(problem)
        torch.cuda.synchronize()
        # everything else on the card (earlier phases' tensors) comes off
        other = torch.cuda.memory_allocated() - nbytes(list(ell))
        torch.cuda.reset_peak_memory_stats()
        sol = solver.solve(problem)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - other
        ratio = est["peak"] / peak
        log(f"plan {cfg.name} at R={pg.rows_per_rank} W={pg.width} n_local="
            f"{pg.n_local}: arguments {args_bytes} bytes and resident "
            f"{resident_bytes} (with row_deg) equal the card's; peak plan "
            f"{est['peak']} bytes (resident {est['resident']}, run {est['run']}, "
            f"{est['branch']} temporaries {est['temporaries']}) against "
            f"{peak} allocated at the peak of a warm solve = {ratio:.4f} "
            f"(band {1 - PEAK_BAND:.2f}-{1 + PEAK_BAND:.2f}) on {card_line}")
        if not np.array_equal(sol.state, truth):
            fail(f"{spec}: state differs from Dijkstra")
        if abs(ratio - 1) > PEAK_BAND:
            fail(f"{spec}: peak plan {est['peak']} is {ratio:.3f}x the card's "
                 f"peak {peak}, outside the {PEAK_BAND} band")
        del sol, solver


def paper_drivers(card_line) -> None:
    """Phase 16(c, d): the variants quick grid at BENCH_SCALE, Table I and
    weak scaling through their entry points on the card; every row equal
    to Dijkstra."""
    from repro_torch.bench import scaling, table1, variants

    with tempfile.TemporaryDirectory() as tmp:
        for name, main_fn, argv, want in (
            ("variants", variants.main, ["--quick", "--scale", str(BENCH_SCALE),
                                         "--source", "hub"], 27),
            ("table1", table1.main, [], 48),
            ("scaling", scaling.main, [], 16),
        ):
            t0 = time.perf_counter()
            rc = main_fn(argv + ["--json", "--out", tmp])
            wall = time.perf_counter() - t0
            rows = json.loads((Path(tmp) / f"{name}.json").read_text())
            bad = [r for r in rows if not r["ok"]]
            steps = sum(r["supersteps"] for r in rows)
            extra = ""
            if name == "variants":
                walls = [r["wall_s"] for r in rows]
                extra = (f" from hub {rows[0]['source']}; warm walls "
                         f"{min(walls):.4f}-{max(walls):.4f} s, sum {sum(walls):.3f} s")
            log(f"bench.{name}: {len(rows)} rows, {len(rows) - len(bad)} ok, "
                f"{steps} supersteps in all{extra}; {wall:.1f} s on {card_line}")
            if rc != 0 or bad or len(rows) != want:
                fail(f"bench.{name}: exit {rc}, {len(rows)} rows (want {want}), "
                     f"{len(bad)} differ from Dijkstra")


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description="smoke run of the port on one card")
    ap.add_argument("--trace-spread", type=int, default=0, metavar="RUNS",
                    help="run only phase 12(a)'s timing RUNS times after "
                         "phases 1-2, and print both statistics of each run")
    opts = ap.parse_args()
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("CUDA is not available: this smoke run needs an NVIDIA GPU")
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail(f"the port's sources are not beside this script ({ROOT / 'src'})")
    sys.path.insert(0, str(ROOT / "src"))

    import numpy as np

    from repro_torch import kernels as K
    from repro_torch.api import Problem, SingleSource, Solver, SolverConfig
    from repro_torch.core import DeltaStepping
    from repro_torch.core.frontier import frontier_caps
    from repro_torch.core.selfstab import in_ell, synchronous_sweep
    from repro_torch.graph import partition_graph, rmat1
    from repro_torch.launch.sssp import oracle
    from repro_torch.roofline import bound
    from repro_torch.roofline.kernels import (
        fused_superstep_traffic,
        relax_ell_traffic,
        relax_push_gather_traffic,
    )

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # ---- 1. card and build -------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card_line = smi.stdout.strip().splitlines()[0]
    print(card_line, flush=True)
    # the atomics floor of phase 3 (scripts/frontier_variants.cu), built
    # beside the library
    sys.path.insert(0, str(ROOT / "scripts"))
    import frontier_ab

    pool = ThreadPoolExecutor(1)
    floor_build = pool.submit(frontier_ab.variants_library)
    built = K.build()
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("---"):
            log(f"nvcc: {line.strip()}")
    log(f"kernels built in {built.seconds:.2f} s -> {built.path}")
    K.library()

    # ---- 2. graph, partition, oracle ---------------------------------
    t0 = time.perf_counter()
    g = rmat1(SCALE, seed=SEED)
    t1 = time.perf_counter()
    pg = partition_graph(g, 1)
    t2 = time.perf_counter()
    ell = pg.to(dev)
    torch.cuda.synchronize()
    log(f"graph {g.name}: n={g.n} m={g.m} generated in {t1 - t0:.1f} s, "
        f"partitioned in {t2 - t1:.1f} s; R={pg.rows_per_rank} W={pg.width} "
        f"ELL on the card: {(pg.col.nbytes + pg.wgt.nbytes) / 1e6:.0f} MB")
    truth = oracle(g, SOURCE)
    finite = np.isfinite(truth)
    log(f"oracle: scipy Dijkstra, {int(finite.sum())} reachable, "
        f"max distance {truth[finite].max():g}")
    if opts.trace_spread:
        floor_build.result()
        pool.shutdown()
        trace_spread(pg, opts.trace_spread, card_line)
        return

    # ---- 3. kernels against their plain versions ---------------------
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    truth_t = torch.as_tensor(truth, device=dev)
    # the Δ class key in torch, bit-equal on the card and on the CPU
    key = DeltaStepping(5.0)
    if not torch.equal(key.class_key(truth_t, None).cpu(),
                       key.class_key(truth_t.cpu(), None)):
        fail("delta class keys differ between the card and the CPU")
    R, W = pg.rows_per_rank, pg.width
    row_cap, _ = frontier_caps(R, W, pg.n_local, 1)
    rs, col, wgt = ell.row_src[0], ell.col[0], ell.wgt[0]
    n_out = pg.n_pad
    rows = []

    def compare(name, kernel_fn, plain_fn, traffic, source, replaces,
                label=""):
        nbytes, ops = traffic
        K.reset_launch_counts()
        out_k = kernel_fn()
        torch.cuda.synchronize()
        if K.launch_counts()[name] != 1:
            fail(f"{name}{label}: the wrapper did not launch its kernel")
        out_p = plain_fn()
        err = max_abs_err(out_k, out_p)
        if err != 0.0 or out_k.dtype != out_p.dtype or out_k.shape != out_p.shape:
            fail(f"{name}{label}: kernel differs from its plain version "
                 f"(max abs err {err})")
        ms = time_ms(kernel_fn, flush)
        plain_ms = time_ms(plain_fn, flush)
        bound_ms, bound_by = bound(nbytes, ops)
        log(f"{name}{label}: bit-identical; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"{nbytes} bytes, bound {bound_ms:.4f} ms at 3.35 TB/s "
            f"({bound_ms / ms:.3f} of it)")
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=0, max_abs_err=err,
                    ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by, library_ms=None)

    # the kernels line keeps the largest frontier's numbers
    for fr in sssp_frontiers(g, pg, ell, truth_t, row_cap):
        dist, f_idx, f_cnt, live, n_src = (fr[k] for k in
                                           ("dist", "f_idx", "f_cnt", "live", "n_src"))
        label = f" ({fr['label']} frontier)"
        log(f"frontier, {fr['label']}: delta class {fr['cls']}, {live} live rows "
            f"of F={row_cap}, {n_src} source vertices")
        fused_row = compare(
            "fused_superstep",
            lambda: K.fused_superstep_cuda(dist, f_idx, f_cnt, rs, col, wgt, n_out),
            lambda: K.fused_superstep_ref(dist, f_idx, f_cnt, rs, col, wgt, n_out),
            fused_superstep_traffic(live, W, n_src, n_out),
            "src/repro_torch/csrc/fused_superstep.cu",
            "src/repro/kernels/superstep_fused/kernel.py:72",
            label,
        )
        push_row = compare(
            "relax_push_gather",
            lambda: K.relax_push_gather_cuda(dist, f_idx, f_cnt, rs, col, wgt),
            lambda: K.relax_push_gather_ref(dist, f_idx, f_cnt, rs, wgt),
            relax_push_gather_traffic(live, W, n_src, row_cap),
            "src/repro_torch/csrc/relax_push.cu",
            "src/repro/kernels/relax_push/kernel.py:42",
            label,
        )
        if not rows:
            rows += [fused_row, push_row]
    del dist, f_idx, f_cnt
    t0 = time.perf_counter()
    row_dst, in_col, in_wgt = in_ell(g)
    log(f"in-ELL built in {time.perf_counter() - t0:.1f} s: "
        f"R={in_col.shape[0]} W={in_col.shape[1]}")
    in_col_t = torch.as_tensor(in_col, device=dev)
    in_wgt_t = torch.as_tensor(in_wgt, device=dev)
    d_ext = torch.cat([truth_t, torch.full((1,), float("inf"), device=dev)])
    R_in, W_in = in_col.shape
    rows.append(compare(
        "relax_ell",
        lambda: K.relax_ell_cuda(d_ext, in_col_t, in_wgt_t),
        lambda: K.relax_ell_ref(d_ext, in_col_t, in_wgt_t),
        relax_ell_traffic(R_in, W_in, g.n),
        "src/repro_torch/csrc/relax_ell.cu",
        "src/repro/kernels/relax_ell/kernel.py:45",
    ))
    batch_rows = batched_frontier_rows(g, pg, ell, dev, flush, floor_build.result())
    pool.shutdown()
    del flush

    # ---- 4. main path ------------------------------------------------
    solver = Solver(SPEC, device="cuda")
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = solver.solve(Problem(pg, SingleSource(SOURCE)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fused_launches = K.launch_counts()["fused_superstep"]
    m = sol.metrics
    log(f"main path {solver.config.name}: supersteps={m.supersteps} "
        f"sparse_fallbacks={m.sparse_fallbacks} classes={m.classes} "
        f"relaxations={m.relaxations} wall={wall:.3f} s "
        f"fused_superstep launches={fused_launches}")
    if not np.array_equal(sol.state, truth):
        fail(f"main path state differs from Dijkstra at "
             f"{int((sol.state != truth).sum())} vertices")
    if not m.converged:
        fail("main path did not converge")
    if fused_launches == 0:
        fail("main path never launched fused_superstep")
    rows[0]["launches"] = fused_launches
    with device_profile("profiler start-up (empty window)", top=0):
        pass
    profiled_solve(solver, Problem(pg, SingleSource(SOURCE)), "fused_superstep")

    # ---- 5. push path ------------------------------------------------
    push = Solver(SolverConfig.from_spec("delta:5/sparse", relax_impl="push"),
                  device="cuda")
    K.reset_launch_counts()
    t0 = time.perf_counter()
    sol_p = push.solve(Problem(pg, SingleSource(SOURCE)))
    torch.cuda.synchronize()
    wall_p = time.perf_counter() - t0
    push_launches = K.launch_counts()["relax_push_gather"]
    log(f"push path: supersteps={sol_p.metrics.supersteps} wall={wall_p:.3f} s "
        f"relax_push_gather launches={push_launches}")
    if not np.array_equal(sol_p.state, sol.state):
        fail("push path state differs from the main path")
    if sol_p.metrics.as_dict() != m.as_dict():
        fail(f"push path metrics differ: {sol_p.metrics} vs {m}")
    if push_launches == 0:
        fail("push path never launched relax_push_gather")
    rows[1]["launches"] = push_launches
    profiled_solve(push, Problem(pg, SingleSource(SOURCE)), "relax_push_gather")

    # ---- 6. self-stabilizing sweep from a corrupted state ------------
    # vertices cut off from the source keep +inf: R1 lifts a finite
    # corrupted value there only step by step and never reaches +inf
    rng = np.random.default_rng(SEED)
    top = int(2 * truth[finite].max()) + 1
    d0 = np.where(finite, rng.integers(0, top, g.n), np.inf).astype(np.float32)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    d = synchronous_sweep(g, SOURCE, d0, iters=10 * top + 1000, device="cuda")
    wall_s = time.perf_counter() - t0
    sweeps = K.launch_counts()["relax_ell"]
    log(f"self-stabilizing sweep: {sweeps} relax_ell launches "
        f"(synchronous rounds), wall={wall_s:.3f} s")
    if not np.array_equal(d, truth):
        fail(f"sweep did not stabilize to the fixpoint "
             f"({int((d != truth).sum())} vertices differ)")
    if sweeps == 0:
        fail("sweep never launched relax_ell")
    rows[2]["launches"] = sweeps

    # ---- 7. serving kernels against their plain versions -------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off for matmuls and cuDNN: plain versions and the fp32 "
        "checks compute in full f32")
    t0 = time.perf_counter()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    attn_row, attn32_row, bag_row = serving_kernels(dev, flush)
    del flush
    rows += [attn_row, attn32_row, bag_row]
    log(f"phase 7 took {time.perf_counter() - t0:.1f} s")

    # ---- 8. LM serving, minitron-8b at full width ---------------------
    t0 = time.perf_counter()
    attn_row["launches"], attn32_row["launches"] = lm_serving(dev)
    log(f"phase 8 took {time.perf_counter() - t0:.1f} s")

    # ---- 9. MIND serving at full width --------------------------------
    t0 = time.perf_counter()
    bag_row["launches"] = mind_serving(dev)
    log(f"phase 9 took {time.perf_counter() - t0:.1f} s")

    # ---- 10. GIN inference at full width, ogb-products scale -----------
    t0 = time.perf_counter()
    rows.append(gin_inference(dev))
    log(f"phase 10 took {time.perf_counter() - t0:.1f} s")

    # ---- 11. the SSSP query service on a copy of phase 2's graph -------
    t0 = time.perf_counter()
    batch_rows[0]["launches"], batch_rows[1]["launches"] = query_service(g, dev)
    rows += batch_rows
    log(f"phase 11 took {time.perf_counter() - t0:.1f} s")

    # ---- 12. adaptive execution, the recorder, /q and the tuner ----------
    t0 = time.perf_counter()
    fused12, push12 = adaptive_paths(g, pg, truth, sol, sol_p, card_line)
    log(f"phase 12 took {time.perf_counter() - t0:.1f} s: {fused12} "
        f"fused_superstep and {push12} relax_push_gather launches on its paths")

    # ---- 13. the engine across processes --------------------------------
    t0 = time.perf_counter()
    fused13 = distributed_paths(g, pg, truth, sol, card_line, dev)
    log(f"phase 13 took {time.perf_counter() - t0:.1f} s: {fused13} "
        f"fused_superstep launches on rank 0 of its paths")

    # ---- 14. resolve and the query service across processes -------------
    t0 = time.perf_counter()
    batch14, rank_row = process_service(g, dev, card_line)
    rows.append(rank_row)
    log(f"phase 14 took {time.perf_counter() - t0:.1f} s: {batch14} "
        f"fused_superstep_batch launches on rank 0 of the service's mix")

    # ---- 15. the static-analysis gate and the superstep profile ---------
    t0 = time.perf_counter()
    gate15 = analysis_gate(card_line)
    superstep_profiles(g, pg, truth, m.supersteps, card_line)
    log(f"phase 15 took {time.perf_counter() - t0:.1f} s: {gate15} "
        f"fused_superstep launches on the gate's /fused points; {card_line}")

    # ---- 16. the cells, the dry-run and the paper's experiment drivers ---
    t0 = time.perf_counter()
    dryrun_cells(card_line)
    plan_against_card(pg, truth, dev, card_line)
    paper_drivers(card_line)
    log(f"phase 16 took {time.perf_counter() - t0:.1f} s on {card_line}")

    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s on {card_line}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
