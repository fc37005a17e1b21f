#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU, at the sizes its users run on one card: SSSP on rmat1
(Graph500 R-MAT, weights 1..100) at scale 20, seed 0, one rank; LM
serving of minitron-8b at full width (32 layers, 7.73 B parameters,
random weights from the seed), of minicpm3-4b (MLA, 62 layers, 4.07 B)
and of phi3.5-moe and dbrx at published widths and the depth one card
holds (8 and 4 layers); MIND serving and training at full width (2^20
items, 2^17 profile ids; training at its cell's B 65,536); GIN
inference and training (gin-tu at full width) on rmat1 at scale 21, the
size of ogb-products; EGNN, MACE and DimeNet
training at full width on a fanout block of that graph; and LM
training of phi3-mini-3.8b at full width (32 layers, 3.82 B parameters,
B 1 x S 4096, and at 4 layers, B 2 x S 4096, across gloo processes
sharing the card at tp 2 and dp 2 x tp 2), its attention through the
forward and backward kernels.

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
     case c (the f32 kernel's key split), case d (the fp32 twin's
     prefill of phase 8) and case e (dbrx's prefill of phase 8b: Hq 48,
     Hkv 8, 6 q heads a kv head), case e' (a tp 2 rank's heads of
     phi3.5-moe's prefill in phase 8d: Hq 16, Hkv 4) and the train steps' forwards of phase
     8c (b': bf16, B 1, H 32, S 4096, D 96; d': f32, S 2048, D 96) and
     a tp 2 rank's of phase 8e (j, j': bf16, H 16, S 4096, D 96 at B 2
     and B 1; k, k': f32, S 2048; these also alone under the profiler); the
     bag also as a bare launch, alone under torch.profiler and its index
     check apart; the attention
     backward (flash_attention_bwd) against its plain version at phi3-
     mini's train shape (bf16, B 1, H 32, S 4096, D 96), at G 4 and G 6
     with D 128 (bf16, B 2, S 2048) and at the fp32 twin's (f32, S 2048,
     D 96) and at a tp 2 rank's of phase 8e (l, l', m, m': H 16, B 2 and
     B 1), timed through the wrapper, alone under the profiler, beside
     the plain version and beside the backward of sdpa
  8. LM serving, minitron-8b in bf16: prefill of 4 x 1920 tokens
     through the attention kernel (32 launches), 32 greedy decode
     steps; logits against the plain attention; then in fp32, the last
     decode step against a teacher-forced prefill of the grown sequence
 8b. MLA and MoE serving on phase 8's prompt, 32 greedy decode steps, in
     bf16 (prefill s, ms/token, peak memory, busy share of a profiled
     prefill and 2 decode steps): minicpm3-4b whole (its prefill by the
     plain path: MLA's q/k and v head dims differ), then its fp32 twin's
     absorbed decode against a teacher-forced prefill; phi3.5-moe at 8
     and dbrx at 4 of their layers at published widths (their whole
     weights, 83.7 and 263 GB, do not fit one card), each prefill through
     the attention kernel (one launch a layer), the dropped (token,
     choice) pairs a layer; then fp32 twins of 2 layers: the kernel route
     against plain attention, and decode against a teacher-forced prefill
     (plain attention) at a capacity that drops nothing
 8d. LM serving across ranks: phi3.5-moe at full width and 8b's 8 layers
     (the weights of 8b's seed, each rank drawing every tensor and keeping
     its block), 8b's prompt, across gloo processes sharing the card: (a)
     tp 2, 32 decode steps; (b) dp 2 x tp 2, 1 (its FSDP gathers pass
     through the host).  Against one process on each dp rank's rows (at
     dp 1 phase 8b's run, bit for bit), fed its tokens: bf16 within the
     bf16 check (5% of max |logit|) for every row whose token routed as
     there (the same experts and kept pairs in every layer), at the
     published capacity and at one that drops nothing; a bf16 rounding
     flips routes, so each other row must owe its flip to a near tie (at
     its first flip one process's router margin within 32 bf16 ulps);
     an fp32 twin of 2
     layers at the published capacity everywhere (1e-4, equal tokens
     and routes); each rank's attention launches and dropped pairs a
     layer against the per-dp-rank capacity rule; prefill s, ms/token,
     peak memory and collectives a rank (gloo on one card stages through
     the host: not scaling figures)
 8c. LM training, phi3-mini-3.8b in bf16 at full width, all 32 layers
     (the step's peak must leave 8 GiB of the card free), B 1 x S 4096
     from lm_batch: (c) the first loss through the kernels at 2 layers of
     the run's weights against the plain route (1e-2); (a) a cold and 3
     warm steps of build_train_step(lm_loss) with the params and AdamW
     state updated in place (ms, tokens/s, peak memory, losses finite),
     64 forward and 32 backward attention launches a step (remat runs
     each layer's forward again), then one step under the profiler
     (busy share); (b) the fp32 twin at 2 layers, S 2048: loss and every
     gradient leaf through the kernels against the plain route (1e-5,
     1e-4 of a leaf's max |grad|)
  8e. LM training across ranks: phi3-mini-3.8b at full width and 4
     layers in bf16, B 2 x S 4096 from lm_batch, across gloo processes
     sharing the card (every rank drawing every tensor of the seed's
     weights and keeping its blocks): (b) dp 2 x tp 2, then (a) tp 2,
     with the sequence-parallel residual; a cold and 2 warm steps a grid
     (ms, tokens/s, peak memory, collectives and bytes a step, the
     attention kernels' launches a step a rank: 8 forward and 4
     backward); then the fp32 twin at 2 layers, B 2 x S 2048, with the
     sequence-parallel residual and without, grid (b)'s train state
     checkpointed after step 1 and resumed on grid (a); against one
     process on the card, run after the worlds: the first step's loss
     (1e-3) and every gradient leaf, put back together by the specs
     (5e-2 of a leaf's max |grad|), the twin's (1e-5, 1e-4), and the
     twin's step 2 resumed on grid (a) and in one process against the
     one process's uninterrupted step 2 (gloo stages a card's tensors
     through the host: not scaling figures)
  9. MIND serving: serve_interests at B=512 and B=262,144 and
     retrieval_scores over all 2^20 items, through the embedding-bag
     kernel, against the plain bag; each call's bag of profiles bit for
     bit against the in-order sum
 9b. MIND training at full width, the train_batch cell's step at B
     65,536 from mind_batch: the loss and every gradient leaf through the
     kernels (the bag kernel forward, the spmm_ell vertex sum over the bag
     ELL backward) against the plain bag at the 0.02-scale init and at
     scale-1 tables (1e-5 of the loss, 1e-4 of a leaf's max |grad|); the
     bag's backward alone bit for bit against its plain version over the
     same ELL and within 1e-5 of autograd of the plain bag, timed beside
     index_add_, its ELL's build timed; the bag forward at this shape as
     in phase 7; a cold and 3 warm steps (ms, users/s, peak memory,
     losses, launches of both kernels every step), one more profiled
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
 10b. GIN training on phase 10's graph and batch: the vertex sum over the
     transpose ELL (the backward's) bit for bit against its plain version,
     timed as in 10; one loss and backward at full width through both
     routes (each backward vertex sum bit for bit against the plain
     Function's; gradients leaf by leaf within 1e-3 of the leaf's max
     |grad|); train steps of the ogb_products plan (AdamW, warmup-cosine,
     clip; 9 spmm_ell launches a step, 4 over the transpose ELL, no
     index_add/scatter/index_put; ms/step, nodes/s, peak memory, busy
     share) beside the segment-sum route's step; a resume through a
     checkpoint bit-identical to a straight run; then a few steps of
     gin-tu's full_graph_sm (a Cora-sized graph, d 1433), molecule (128
     graphs of 30 atoms as one block-diagonal graph, against a loop over
     the graphs) and minibatch_lg (one fanout block of 1024 seeds) cells
 10c. EGNN, MACE and DimeNet at full width on phase 10b's molecule,
     full_graph_sm and minibatch_lg inputs (DimeNet's triplets capped at
     2 and padded to the plan's T): 2 train steps of each cell's plan,
     every segment sum and every gather's backward through the spmm_ell
     vertex sum over a segment ELL of the live rows (27, 6 and 32
     launches a step), no segment ELL built and no vertex plan made after
     the first step, the first loss against the segment-sum route's
     (1e-5), gradients on the molecule cells (1e-3 of a leaf's max
     |grad|) and on DimeNet's minibatch_lg cell (bf16 messages: two
     backward passes bit for bit, then against the segment-sum route
     under deterministic algorithms), ms, nodes/s, peak memory, one
     profiled minibatch_lg step each (EGNN's and DimeNet's without
     index_add_); then each vertex-sum shape of the
     minibatch_lg steps (edges into nodes at d 64, 3, 1152 and 128,
     triplets into edges at d 128, their W = 1 transposes, and the
     gathers' backward over edge_src at d 64, 3 and 128 and over tri_kj
     at d 128) bit for bit against its plain version, timed beside
     index_add_
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
     the reference service CLI's defaults (landmarks, cache and phase
     11's improving updates; 50 queries from phase 11's mix generator,
     cut from 200 for phase 8e's time), rank 0 serving and the other rank
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
LM_BATCH, LM_PROMPT, LM_MAX_LEN, LM_DECODE = 4, 1920, 2048, 32
# the fp32 twin's steps: its teacher-forced prefill of 1920 + 128 tokens
# attends through the kernel, which takes multiples of 128
LM_F32_DECODE = 128
LM_F32_BATCH = 2
LM_PROFILED_STEPS = 8
# kernel path vs plain attention in bf16, as a share of max |logit|:
# the plain path rounds p to bf16 before p @ v, the kernel keeps p in
# f32, so the two differ about as much as a bf16 model from its f32
# twin (1.4% and 1.8% of max |logit| at 8 and 16 layers of a d=512
# model on the CPU); the bound leaves room for 32 layers
LM_BF16_TOL = 5e-2
LM_F32_RTOL, LM_F32_ATOL = 2e-3, 5e-4   # the JAX package's decode test
# MLA and MoE serving (phase 8b): phase 8's prompt and decode steps.  minicpm3-4b runs whole; the MoE archs at published widths and
# the depth one card holds (phi3.5-moe's 32 layers of bf16 weights take
# 83.7 GB, dbrx's 40 take 263 GB), their fp32 twins at 2 layers
MLA_ARCH = "minicpm3-4b"
MOE_ARCHS = (("phi3.5-moe-42b-a6.6b", 8), ("dbrx-132b", 4))
MOE_F32_LAYERS = 2
# LM serving across ranks (phase 8d): phi3.5-moe at 8b's depth across gloo
# processes sharing the card, (label, ranks, tp, decode steps of the bf16
# runs at the published capacity, at one that drops nothing, and of the
# fp32 twin) a grid; the twin at MOE_F32_LAYERS against one process on
# each dp rank's rows within SHARD_F32_TOL of max |logit|.  Grid (b)
# all-gathers every layer's expert blocks over dp (FSDP, 630 MB a rank a
# layer in bf16) at every step, through the host (gloo): 18.0 s a bf16
# prefill and 10.8 s a decode step on one card (PERF.md), so its
# published-capacity run prefills only (its drops and wall) and the
# others decode 1 step of 8b's 32 (2 before phase 8e took their time)
SHARD_ARCH, SHARD_LAYERS = "phi3.5-moe-42b-a6.6b", dict(MOE_ARCHS)["phi3.5-moe-42b-a6.6b"]
SHARD_GRIDS = (("a", 2, 2, LM_DECODE, LM_DECODE, 8), ("b", 4, 2, 0, 1, 1))
SHARD_F32_TOL = 1e-4
# a bf16 row is excused from LM_BF16_TOL only when its token took other
# experts than in one process, and only for a near tie: at the first MoE
# layer where it did, one process's router margin between its k-th and
# (k+1)-th probability within SHARD_FLIP_ULPS bf16 ulps of the k-th (the
# excused rows' margins were at most 18.6 on an H100; a fault that moves
# the hidden state flips tokens whatever their margin)
SHARD_FLIP_ULPS = 32.0
SHARD_TIMEOUT = 600.0
# decode steps profiled a model: minicpm3's 62 layers launch some 6,000
# ops a step, and the profiler's post-processing grows with them
MLA_MOE_PROFILED_STEPS = 2
# flash_attention vs its plain version: the JAX package's kernel-test
# tolerances, and in bf16 also one bf16 ulp (<= 2**-7 of the value):
# both compute in f32 and round once
ATTN_TOL = {"bfloat16": 2e-2, "float32": 2e-5}
ATTN_BF16_RTOL, ATTN_BF16_ATOL = 1e-2, 2e-3
# the attention backward against its plain version (phase 7): the f32
# sums of up to Sk terms in another order, as a share of a gradient's
# max |value|; bf16 also within one bf16 ulp (both compute in f32 and
# round once)
ATTN_BWD_TOL, ATTN_BWD_BF16_RTOL = 1e-4, 2 ** -7
# the forward's lse against the plain one's, absolute (lse ~ ln Sk): f32
# sums in another order; bf16 also the scores' wgmma sums and the
# kernel's exp2 and log2 (the card test's tolerances)
ATTN_LSE_TOL = {"bfloat16": 2e-4, "float32": 2e-5}
# LM training (phase 8c): phi3-mini-3.8b at full width in bf16, B 1 x S
# 4096 from lm_batch, at the depth that leaves TRAIN_FREE_GIB of the card
# free at the step's peak; a cold step, then TRAIN_WARM warm ones
TRAIN_ARCH = "phi3-mini-3.8b"
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_WARM = 32, 1, 4096, 3
TRAIN_FREE_GIB = 8.0
# (b) its fp32 twin at full width and 2 layers, B 1 x S 2048: the kernel
# route's loss and gradients against the plain route's (attn_impl
# "xla"), each leaf as a share of its max |grad|.  On the CPU the two
# routes (the plain backward through lse against autograd of the plain
# attention) differ by 1.5e-6 at D 96, S 512; the card sums 2048 keys
# in the kernels' order: 1e-4 leaves 65x
TRAIN_F32_LAYERS, TRAIN_F32_SEQ = 2, 2048
TRAIN_F32_LOSS_RTOL, TRAIN_F32_GRAD_TOL = 1e-5, 1e-4
# (c) the bf16 run's weights at 2 layers, S 4096: the loss and each
# gradient leaf through the kernels against the plain route's, the leaf
# as a share of its max |grad|.  Set from readings (scripts/
# train_bf16_gaps.py on an H100, 4 batches): the sound routes differ by
# 1.2e-6 to 1.4e-5 of the loss and by up to 0.0253 in a leaf (bf16
# rounding); a mask one key late moves the loss by 2.3e-5, inside the
# sound spread, but a leaf by 0.83, and lse in base 2 a leaf by 0.97.
# An lse off by 1e-2 (0.021) stays inside the sound spread: phase 7
# holds lse within ATTN_LSE_TOL at this shape
TRAIN_BF16_LOSS_RTOL, TRAIN_BF16_GRAD_TOL = 1e-4, 5e-2
# LM training across ranks (phase 8e): phi3-mini at full width and
# TRAIN_SHARD_LAYERS layers in bf16, B 2 x S TRAIN_SEQ from lm_batch,
# across gloo processes sharing the card, on each grid of
# TRAIN_SHARD_GRIDS (label, ranks, tp; (b) first: (a) resumes its
# checkpoint) with seq_shard_resid; a cold and TRAIN_SHARD_WARM warm
# steps a grid.  Held against one process on the same layers and batches,
# run after the worlds, before any update: the loss within
# TRAIN_SHARD_BF16_LOSS_RTOL (the tp ranks' partial sums are rounded to
# bf16 before they are summed; 7.0e-5 on the CPU at d 768, 4 layers,
# scripts/train_shard_gaps.py) and every gradient leaf within
# TRAIN_BF16_GRAD_TOL of its max |grad| (0.026 there).  The fp32 twin at
# TRAIN_F32_LAYERS layers, B 2 x S TRAIN_SHARD_F32_SEQ, seq_shard_resid
# True and False, at TRAIN_F32_LOSS_RTOL and TRAIN_F32_GRAD_TOL; its
# state checkpointed on grid (b) after step 1, restored on grid (a) and
# in one process: step 2 against the one process's uninterrupted run.
# The twin's steps run at lr TRAIN_SHARD_LR from the first (warmup 1): an
# update moves a weight by about that, which the next loss sees, and a
# gradient under Adam's eps moves one by at most about that between two
# summation orders
TRAIN_SHARD_LAYERS, TRAIN_SHARD_BATCH, TRAIN_SHARD_WARM = 4, 2, 2
TRAIN_SHARD_GRIDS = (("b", 4, 2), ("a", 2, 2))
TRAIN_SHARD_F32_SEQ = 2048
TRAIN_SHARD_BF16_LOSS_RTOL = 1e-3
TRAIN_SHARD_LR = 1e-4
TRAIN_SHARD_TIMEOUT = 900.0
# MIND serving (phase 9)
MIND_SERVE = (("serve_p99", 512), ("serve_bulk", 262_144))
# kernel-path vs plain-bag outputs, as a share of the plain one's max
# |value|: the 0.02-scale tables make interests ~1e-5 and scores ~1e-6
MIND_REQUESTS, MIND_TOPK, MIND_REL_TOL = 32, 5, 1e-5
# MIND training (phase 9b): the train_batch cell's step at full width and
# its B 65,536 from mind_batch, a cold step and MIND_TRAIN_WARM warm ones
MIND_TRAIN_WARM = 3
# the kernel route (BagSum: the bag kernel forward, the vertex sum over
# the bag ELL backward) against the plain bag (bag_impl "ref") on one
# batch and the same weights, at the 0.02-scale init and at tables drawn
# at scale 1: the loss as a share of it, each gradient leaf's largest gap
# as a share of its max |grad|.  The routes differ by f32 sums taken in
# another order: a bag's 16 slots (the kernel in slot order, torch.sum by
# its tree) and a profile row's segment of about 25 slots at most (slot
# order against index_put's atomic adds), each within k 2^-24 (1.5e-6 at
# k 25) of its sum of |terms|; the item table's gradients add by atomics
# on both routes.  On the CPU the port and the reference differ by 3.8e-6
# of a leaf's max |grad| at most (tests/test_torch_mind_train.py); 1e-4
# leaves 25x for what the MLP, squash and attention carry from the bag
MIND_TRAIN_LOSS_RTOL = 1e-5
MIND_TRAIN_GRAD_TOL = 1e-4
# routing_init's gradient is 0 in exact arithmetic (its softmax over the
# history is shift-invariant in it), rounding noise on both routes: each
# must stay below this share of the largest |grad| of any leaf
MIND_ZERO_LEAF, MIND_ZERO_GRAD_TOL = "routing_init", 1e-6
# one step's update (AdamW in place, inside the warmup) against a plain
# AdamW written out here from a gradient recomputed on the same batch
# and weights.  Only the item table's gradient can differ between the
# two backward passes (index_put adds by atomics; the bag's backward and
# the dense ops repeat their bits), by about 1e-6 of its max |grad|; at
# the 0.02-scale tables its entries lie below Adam's eps (1e-8), where
# the normalised step moves by at most that gap over eps.  Each element
# within MIND_STEP_TOL of the step's lr, plus 2^-23 of its value for the
# rounding of the last subtraction.  Every leaf but MIND_ZERO_LEAF must
# also move by MIND_STEP_MOVE = 10 MIND_STEP_TOL of lr somewhere, so a
# step that skips its update, or any part of it, fails the gap check
# with a margin.  Adam's term is far below lr here: at B 65,536 the
# tables' gradients lie below eps, and a leaf moves by 0.043-0.95 of lr
# (the card, step 5; 0.54-0.96 on the CPU at the reduced config).
# MIND_ZERO_LEAF is reported, not held: Adam normalises its gradient,
# which is rounding noise, to steps of about lr in its own direction
MIND_STEP_TOL = 1e-3
MIND_STEP_MOVE = 10 * MIND_STEP_TOL
# the bag's backward alone against autograd of the plain bag, whose
# index_put adds the same terms in another order: a segment of k slots
# within 2 k 2^-24 of its sum of |terms|; as a share of max |grad|
BAG_BWD_TOL = 1e-5
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
# GIN training (phase 10b) on phase 10's graph and batch: warm steps
# after the cold one, and the steps of the resume check (straight, and
# half, a checkpoint, a restore and the other half)
GIN_TRAIN_WARM, GIN_RESUME_STEPS = 3, 4
# kernel-route gradients vs the segment-sum route's, leaf by leaf, as a
# share of the leaf's max |grad|: the logits already differ by up to
# GIN_LOGIT_TOL of a node's scale, the backward carries that through 5
# more layers of f32 sums in another order (the transpose ELL's rows
# against atomic adds), and each weight's gradient is one sum over 2M
# nodes.  At rmat1 scale 15 on the CPU the worst leaf was 7.0e-6; the
# bound is 10x GIN_LOGIT_TOL
GIN_GRAD_TOL = 1e-3
# the other three cells (phase 10b(e)): steps each, and the kernel
# route's first loss against the plain route's, as a share of it (a mean
# of f32 log-likelihoods or squared errors summed in another order; 1e-7
# on the CPU); the minibatch block's seeds and fanouts are the cell's
CELL_STEPS = 2
CELL_LOSS_TOL = 1e-5
# the rest of the GNN zoo (phase 10c): egnn, mace and dimenet on these
# cells, the minibatch_lg one drawn in phase 10b from phase 10's graph,
# each cell's first loss within CELL_LOSS_TOL of the plain route's
# (DimeNet's bf16 cells too: at TRIPLET_CAP 2 a segment sums at most 2
# live bf16 messages, which round alike in f32 and in bf16); gradients
# leaf by leaf on every molecule cell (f32, GIN_GRAD_TOL) and on
# ZOO_FLAT_GRADS, whose bf16 messages take segment_sum's upcast and
# cast-back.  There the kernel route's gradients must repeat bit for bit
# (its gathers' backward is the vertex sum, not atomics), and they are
# held within ZOO_BF16_GRAD_TOL of the plain route's run under
# deterministic algorithms: the routes differ where an f32 sum's order,
# or the plain gathers' bf16 sums against the kernel route's f32 ones,
# flips a bf16 rounding downstream.  On an H100 (scripts/zoo_bf16_grads.py
# at scale 21, both routes repeating bit for bit) the gap was 0.00444 of
# a leaf's max |grad| on minibatch_lg and 0.00676 on full_graph_sm's
# graph; 1e-2 is 2.25x the first and 1.48x the second
ZOO_MODELS = ("egnn", "mace", "dimenet")
ZOO_CELLS = ("molecule", "full_graph_sm", "minibatch_lg")
ZOO_FLAT_GRADS = ("dimenet", "minibatch_lg")
ZOO_BF16_GRAD_TOL = 1e-2
# the models whose every row gather takes its backward through the
# vertex sum: their profiled minibatch_lg step runs no index_add_ (MACE's
# gather along the l axis of its radial weights keeps index_select's)
ZOO_NO_INDEX_ADD = ("egnn", "dimenet")
# spmm_ell launches a train step at L layers (blocks), forward +
# backward: the segment sums, their transposes, and the backward of each
# gather whose input needs a gradient (EGNN: h and the coordinates at
# both ends of the edges from its second layer on; MACE: W h at edge_src
# a layer; DimeNet: h at both ends once, the messages at tri_kj a
# block); EGNN's last coordinate update reaches no loss
ZOO_LAUNCHES = {"egnn": lambda L: 2 * L + (2 * L - 1) + 4 * (L - 1),
                "mace": lambda L: 2 * L + L, "dimenet": lambda L: 4 * L + 2 + L}
# the query service (phase 11): the reference service CLI's defaults
SERVE_QUERIES, SERVE_ZIPF, SERVE_LANDMARKS = 200, 1.3, 8
SERVE_MAX_BATCH, SERVE_MAX_WAIT_S, SERVE_CACHE_MB = 8, 0.010, 256
SERVE_UPDATES = 4
SERVE_SAMPLED = 8   # single-source answers held against Dijkstra
SERVE_FRESH = 3     # refreshed cache entries held against cold solves
# adaptive execution, the flight recorder, quantized exchange and the
# auto-tuner (phase 12): the reference's `launch/obs.py record` gate
TRACE_GATE = 1.15
TRACE_PAIRS = 21    # back-to-back pairs, the order alternating; the gate reads their median
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
# the service's mix across processes, cut for phase 8e's time:
# SERVICE_QUERIES from phase 11's generator (build_query_mix, its Zipf
# exponent and seed; 200 before, at some 3 q/s through gloo)
SERVICE_QUERIES = 50
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
    # dbrx's prefill in phase 8b: 6 q heads a kv head
    ("e dbrx prefill", 4, 48, 8, 1920, 1920, 128, "bfloat16", True),
    # the forwards of phase 8c's train steps: phi3-mini's (64 a step) and
    # its fp32 twin's
    ("b' phi3-mini train", 1, 32, 32, 4096, 4096, 96, "bfloat16", True),
    ("d' fp32 twin train", 1, 32, 32, 2048, 2048, 96, "float32", True),
    # a tp 2 rank's heads of phi3.5-moe's prefill in phase 8d
    ("e' phi3.5-moe prefill, a tp 2 rank", 4, 16, 4, 1920, 1920, 128, "bfloat16", True),
    # a tp 2 rank's heads of phase 8e's train steps: grid (a) (B 2) and
    # grid (b) (dp 2: B 1), phi3-mini's and its fp32 twin's
    ("j phi3-mini train, a tp 2 rank of grid (a)", 2, 16, 16, 4096, 4096, 96, "bfloat16", True),
    ("j' phi3-mini train, a tp 2 rank of grid (b)", 1, 16, 16, 4096, 4096, 96, "bfloat16", True),
    ("k fp32 twin train, a tp 2 rank of grid (a)", 2, 16, 16, 2048, 2048, 96, "float32", True),
    ("k' fp32 twin train, a tp 2 rank of grid (b)", 1, 16, 16, 2048, 2048, 96, "float32", True),
)
ATTN_BWD_CASES = (
    # label, B, Hq, Hkv, S, D, dtype name, causal
    ("f phi3-mini train", 1, 32, 32, 4096, 96, "bfloat16", True),
    ("g G 4 (minitron, phi3.5-moe)", 2, 32, 8, 2048, 128, "bfloat16", True),
    ("h G 6 (dbrx)", 2, 48, 8, 2048, 128, "bfloat16", True),
    ("i fp32 twin train", 1, 32, 32, 2048, 96, "float32", True),
    # a tp 2 rank's heads of phase 8e's train steps, as ATTN_CASES' j-k'
    ("l phi3-mini train, a tp 2 rank of grid (a)", 2, 16, 16, 4096, 96, "bfloat16", True),
    ("l' phi3-mini train, a tp 2 rank of grid (b)", 1, 16, 16, 4096, 96, "bfloat16", True),
    ("m fp32 twin train, a tp 2 rank of grid (a)", 2, 16, 16, 2048, 96, "float32", True),
    ("m' fp32 twin train, a tp 2 rank of grid (b)", 1, 16, 16, 2048, 96, "float32", True),
)
# every __global__ of csrc/flash_attention_bwd.cu, the one launched once
# a call (of either dtype) first: kernel_alone_ms counts calls by it and
# sums the device time of every kernel named here
ATTN_BWD_KERNELS = ("attention_delta_kernel", "attention_dkdv_sm90_kernel",
                    "attention_dq_sm90_kernel", "attention_dkdv_tf32_kernel",
                    "attention_dq_tf32_kernel")
# the cases whose gradients two launches must give in the same bits
ATTN_BWD_REPEAT = ("f phi3-mini train", "h G 6 (dbrx)", "i fp32 twin train")
ATTN_BWD_ROWS = {
    "f phi3-mini train": "flash_attention_bwd",
    "i fp32 twin train": "flash_attention_bwd f32",
    "l phi3-mini train, a tp 2 rank of grid (a)": "flash_attention_bwd train tp rank B 2",
    "l' phi3-mini train, a tp 2 rank of grid (b)": "flash_attention_bwd train tp rank B 1",
    "m fp32 twin train, a tp 2 rank of grid (a)": "flash_attention_bwd f32 train tp rank B 2",
    "m' fp32 twin train, a tp 2 rank of grid (b)": "flash_attention_bwd f32 train tp rank B 1",
}
# the cases whose numbers stand in the kernels line, with the row's name
# and source: the path's shapes, minitron's prefill at max_len (bf16)
# and its fp32 twin's (f32)
ATTN_ROWS = {
    "a minitron prefill": ("flash_attention", "src/repro_torch/csrc/flash_attention_sm90.cu"),
    "d fp32 twin prefill": ("flash_attention f32", "src/repro_torch/csrc/flash_attention.cu"),
    "e dbrx prefill": ("flash_attention dbrx", "src/repro_torch/csrc/flash_attention_sm90.cu"),
    "e' phi3.5-moe prefill, a tp 2 rank": ("flash_attention tp rank",
                                            "src/repro_torch/csrc/flash_attention_sm90.cu"),
    "j phi3-mini train, a tp 2 rank of grid (a)": ("flash_attention train tp rank B 2",
            "src/repro_torch/csrc/flash_attention_sm90.cu"),
    "j' phi3-mini train, a tp 2 rank of grid (b)": ("flash_attention train tp rank B 1",
             "src/repro_torch/csrc/flash_attention_sm90.cu"),
    "k fp32 twin train, a tp 2 rank of grid (a)": ("flash_attention f32 train tp rank B 2", "src/repro_torch/csrc/flash_attention.cu"),
    "k' fp32 twin train, a tp 2 rank of grid (b)": ("flash_attention f32 train tp rank B 1", "src/repro_torch/csrc/flash_attention.cu"),
}
# the forward cases also timed alone under the profiler (the kernels of
# their dtype's source): phase 8e's
ATTN_ALONE = {"bfloat16": ("flash_attention_sm90_kernel",),
              "float32": ("flash_attention_kernel", "flash_merge_kernel")}
ATTN_ALONE_CASES = ("j phi3-mini train, a tp 2 rank of grid (a)", "j' phi3-mini train, a tp 2 rank of grid (b)", "k fp32 twin train, a tp 2 rank of grid (a)", "k' fp32 twin train, a tp 2 rank of grid (b)")
# phase 8e's rows of the kernels line by (dtype, grid): the forward's and
# the backward's labels
TRAIN_SHARD_ROWS = {("bfloat16", "a"): ("j phi3-mini train, a tp 2 rank of grid (a)", "l phi3-mini train, a tp 2 rank of grid (a)"), ("bfloat16", "b"): ("j' phi3-mini train, a tp 2 rank of grid (b)", "l' phi3-mini train, a tp 2 rank of grid (b)"),
                    ("float32", "a"): ("k fp32 twin train, a tp 2 rank of grid (a)", "m fp32 twin train, a tp 2 rank of grid (a)"), ("float32", "b"): ("k' fp32 twin train, a tp 2 rank of grid (b)", "m' fp32 twin train, a tp 2 rank of grid (b)")}


def tf32x3_share(nbytes: int, flops: int, ms: float, alone_ms: float | None = None) -> str:
    """An f32 attention case's tensor floor (3 TF32 products a product
    at 495 TFLOP/s) and a time's share of it, beside the CUDA-core bound
    the log line gives first."""
    from repro_torch.roofline import TF32X3_OPS_PER_S, bound

    floor_ms, _ = bound(nbytes, flops, TF32X3_OPS_PER_S)
    alone = "" if alone_ms is None else f", alone {floor_ms / alone_ms:.3f}"
    return (f" (67 TFLOP/s); 3xTF32 floor {floor_ms:.4f} ms (165 TFLOP/s), "
            f"{floor_ms / ms:.3f} of it{alone}")


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


def serving_kernels(dev, flush) -> tuple:
    """Phase 7: flash_attention and embedding_bag against their plain
    versions at the serving paths' shapes.  Returns their rows of the
    kernels line: attention's by the label of its case in ATTN_ROWS (the
    bf16 kernel at case (a), the f32 kernel at case (d), the bf16 kernel
    at dbrx's case (e), at a tp rank's heads (e') and at phase 8e's train
    shapes (j-k')), and the bag's (launches filled in by phases 8, 8b,
    8d, 8e and 9)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data import mind_batch

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    attn_rows = attention_cases(ATTN_CASES, randn, dev, flush)

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
    bag_row = bag_check("serve_bulk", table, idx, w, flush)
    return attn_rows, bag_row


def attention_cases(cases, randn, dev, flush) -> dict:
    """flash_attention against its plain version at each of ``cases``
    (ATTN_CASES' layout; inputs from ``randn(shape, dtype)``), timed
    beside sdpa; returns the rows of the kernels line of the cases in
    ATTN_ROWS, by label."""
    import torch
    import torch.nn.functional as F

    from repro_torch import kernels as K
    from repro_torch.roofline import BF16_OPS_PER_S, F32_OPS_PER_S, bound
    from repro_torch.roofline.kernels import flash_attention_traffic

    attn_rows = {}
    for label, B, Hq, Hkv, Sq, Sk, D, dtype_name, causal in cases:
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
        alone_ms = None
        if label in ATTN_ALONE_CASES:
            alone_ms = kernel_alone_ms(lambda: K.flash_attention_cuda(q, k, v, causal=causal),
                                       flush, ATTN_ALONE[dtype_name])
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
            f"{flops / ms / 1e9:.1f} TFLOP/s, {bound_ms / ms:.3f} of its bound"
            + ("" if alone_ms is None else f"; alone under the profiler {alone_ms:.4f} ms "
               f"({bound_ms / alone_ms:.3f} of its bound)")
            + f"{tf32x3_share(nbytes, flops, ms, alone_ms) if dtype == torch.float32 else ''} "
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
    return attn_rows


def bag_check(label, table, idx, w, flush) -> dict:
    """embedding_bag against its plain version and bit for bit against
    the in-order sum (the TPU kernel's order), timed through the wrapper,
    as a bare launch, alone under the profiler and beside F.embedding_bag
    (phase 7 at serve_bulk, phase 9b at train_batch).  Returns its row of
    the kernels line."""
    import torch
    import torch.nn.functional as F

    from repro_torch import kernels as K
    from repro_torch.roofline import bound
    from repro_torch.roofline.kernels import embedding_bag_traffic

    (B, L), d = idx.shape, table.shape[1]
    K.reset_launch_counts()
    out = K.embedding_bag_cuda(table, idx, w)
    torch.cuda.synchronize()
    if K.launch_counts()["embedding_bag"] != 1:
        fail(f"embedding_bag ({label}): the wrapper did not launch its kernel")
    plain = K.embedding_bag_ref(table, idx, w)
    err, rel = float((out - plain).abs().max()), rel_err(out, plain)
    if rel > 1e-6:
        fail(f"embedding_bag ({label}): kernel differs from its plain version "
             f"(max abs err {err}, {rel:.3g} of max |out|)")
    in_order = torch.zeros_like(out)  # the TPU kernel's order of sums
    for l in range(L):
        in_order = in_order + table[idx[:, l].long()] * w[:, l, None]
    if not torch.equal(out, in_order):
        fail(f"embedding_bag ({label}): kernel is not bit-identical to the in-order sum")

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
        fail(f"embedding_bag ({label}): the bare launch failed")
    torch.cuda.synchronize()
    if not torch.equal(bare_out, out):
        fail(f"embedding_bag ({label}): the bare launch differs from the wrapper's")
    ms = time_ms(lambda: K.embedding_bag_cuda(table, idx, w), flush)
    bare_ms = time_ms(lambda: launch(*bare_args), flush)
    check_ms = time_ms(lambda: torch.stack(torch.aminmax(idx)).tolist(), flush)
    alone_ms = kernel_alone_ms(lambda: launch(*bare_args), flush, ("embedding_bag",))
    plain_ms = time_ms(lambda: K.embedding_bag_ref(table, idx, w), flush)
    library_ms = time_ms(library, flush)
    rows_touched = int(torch.unique(idx[w != 0]).numel())  # rows a 0 weight skips
    nbytes, ops = embedding_bag_traffic(rows_touched, B, L, d)
    bound_ms, bound_by = bound(nbytes, ops)
    log(f"embedding_bag ({label}: table {tuple(table.shape)}, B={B} L={L}, f32 weights, "
        f"{float((w == 0).float().mean()):.3f} of them 0): max abs err {err:.3g} "
        f"({rel:.3g} of max |out|, tol 1e-6); bit-identical to the in-order sum; kernel {ms:.4f} ms "
        f"(bare launch {bare_ms:.4f} ms, alone under the profiler {alone_ms:.4f} ms; the "
        f"index check, one host read, {check_ms:.4f} ms), plain "
        f"{plain_ms:.4f} ms, F.embedding_bag {library_ms:.4f} ms (max abs err "
        f"{float((library() - plain).abs().max()):.3g}); {rows_touched} rows "
        f"touched, {nbytes} bytes, bound {bound_ms:.4f} ms ({bound_by}; "
        f"{bound_ms / alone_ms:.3f} of it alone)")
    return dict(name="embedding_bag", route="cuda",
                source="src/repro_torch/csrc/embedding_bag.cu",
                replaces="src/repro/kernels/embedding_bag/kernel.py:39",
                launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def attention_bwd_kernels(dev, flush) -> dict:
    """Phase 7's backward cases: flash_attention_bwd against its plain
    version on the card (and, at ATTN_BWD_REPEAT, against itself: two
    launches, the same bits), timed through the wrapper and alone (every
    kernel of ATTN_BWD_KERNELS) beside the plain version and beside
    torch.autograd.grad of scaled_dot_product_attention (its backward
    alone, the forward's graph kept).  Returns the rows of the kernels
    line by the label of their case in ATTN_BWD_ROWS (launches filled in
    by phases 8c and 8e)."""
    import torch
    import torch.nn.functional as F

    from repro_torch import kernels as K
    from repro_torch.roofline import BF16_OPS_PER_S, F32_OPS_PER_S, TF32X3_OPS_PER_S, bound
    from repro_torch.roofline.kernels import flash_attention_bwd_traffic

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    rows = {}
    for label, B, Hq, Hkv, S, D, dtype_name, causal in ATTN_BWD_CASES:
        dtype = getattr(torch, dtype_name)
        q, dout = (torch.randn((B, Hq, S, D), generator=gen, device=dev).to(dtype)
                   for _ in range(2))
        k, v = (torch.randn((B, Hkv, S, D), generator=gen, device=dev).to(dtype)
                for _ in range(2))
        lse = torch.empty((B, Hq, S), device=dev)
        out = K.flash_attention_cuda(q, k, v, causal=causal, lse=lse)
        # the forward's out and lse against the plain forward's, so that
        # the reference below shares no number the kernels made but the
        # out that the backward takes by its contract (delta), held here
        out_ref, lse_ref = K.attention_lse_ref(q, k, v, causal=causal)
        lse_err = float((lse - lse_ref).abs().max())
        out_err = float((out.float() - out_ref.float()).abs().max())
        tol = ATTN_TOL[dtype_name]
        rtol, atol = ((ATTN_BF16_RTOL, ATTN_BF16_ATOL) if dtype == torch.bfloat16
                      else (tol, tol))
        if not lse_err <= ATTN_LSE_TOL[dtype_name] or not torch.allclose(
                out.float(), out_ref.float(), rtol=rtol, atol=atol):
            fail(f"flash_attention ({label}, the backward's forward): lse differs from the "
                 f"plain one's by {lse_err} (tol {ATTN_LSE_TOL[dtype_name]}), out by "
                 f"{out_err} (rtol {rtol}, atol {atol})")
        del out_ref
        K.reset_launch_counts()
        got = K.flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal=causal)
        torch.cuda.synchronize()
        if K.launch_counts()["flash_attention_bwd"] != 1:
            fail(f"flash_attention_bwd ({label}): the wrapper did not launch its kernel")
        want = K.attention_bwd_ref(q, k, v, out, lse_ref, dout, causal=causal)
        err = 0.0
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            scale = float(w.float().abs().max())
            gap = (g.float() - w.float()).abs()
            err = max(err, float(gap.max()))
            rtol = ATTN_BWD_BF16_RTOL if dtype == torch.bfloat16 else 0.0
            if g.dtype != dtype or bool((gap > ATTN_BWD_TOL * scale
                                         + rtol * w.float().abs()).any()):
                fail(f"flash_attention_bwd ({label}): {name} differs from the plain "
                     f"version (max abs err {float(gap.max())}, max |{name}| {scale})")
        if label in ATTN_BWD_REPEAT:
            again = K.flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal=causal)
            torch.cuda.synchronize()
            for name, g, h in zip(("dq", "dk", "dv"), got, again):
                if not torch.equal(g.view(torch.uint8), h.view(torch.uint8)):
                    fail(f"flash_attention_bwd ({label}): two launches on the same inputs "
                         f"gave different bits in {name} (max abs err "
                         f"{max_abs_err(g, h)})")
            del again
            log(f"flash_attention_bwd ({label}): two launches gave the same bits in dq, "
                f"dk and dv")
        del got, want
        ins = [t.detach().requires_grad_(True) for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*ins, is_causal=causal, enable_gqa=True)

        def library():
            return torch.autograd.grad(lib_out, ins, dout, retain_graph=True)

        backend = library_kernels(library)
        ms = time_ms(lambda: K.flash_attention_bwd_cuda(q, k, v, out, lse, dout,
                                                        causal=causal), flush)
        alone_ms = kernel_alone_ms(
            lambda: K.flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal=causal),
            flush, ATTN_BWD_KERNELS)
        plain_ms = time_ms(lambda: K.attention_bwd_ref(q, k, v, out, lse, dout,
                                                       causal=causal), flush, reps=5)
        library_ms = time_ms(library, flush)
        nbytes, flops = flash_attention_bwd_traffic(B, Hq, Hkv, S, S, D, causal,
                                                    q.element_size())
        peak = BF16_OPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S
        bound_ms, bound_by = bound(nbytes, flops, peak)
        log(f"flash_attention_bwd ({label}: B={B} Hq={Hq} Hkv={Hkv} S={S} D={D} "
            f"{dtype_name} causal={causal}): the forward's lse within {lse_err:.3g} of the "
            f"plain lse (tol {ATTN_LSE_TOL[dtype_name]}), out within {out_err:.3g}; "
            f"gradients against the plain backward from the plain lse: "
            f"max abs err {err:.3g} (tol {ATTN_BWD_TOL} "
            f"of max |grad|{', rtol 2^-7' if dtype == torch.bfloat16 else ''}); "
            f"wrapper {ms:.4f} ms, kernels alone {alone_ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"sdpa backward {library_ms:.4f} ms ({ms / library_ms:.2f}x it); {flops} flop, "
            f"{nbytes} bytes, bound {bound_ms:.4f} ms ({bound_by}, {peak / 1e12:g} "
            f"TFLOP/s); kernel at {flops / ms / 1e9:.1f} TFLOP/s, {bound_ms / ms:.3f} "
            f"of its bound"
            f"{tf32x3_share(nbytes, flops, ms, alone_ms) if dtype == torch.float32 else ''}"
            f"; sdpa's backward kernels: {backend}")
        if dtype == torch.float32:  # the f32 kernels run on the tensor cores
            bound_ms, bound_by = bound(nbytes, flops, TF32X3_OPS_PER_S)
        if label in ATTN_BWD_ROWS:
            rows[label] = dict(
                name=ATTN_BWD_ROWS[label], route="cuda",
                source="src/repro_torch/csrc/flash_attention_bwd.cu",
                replaces="src/repro/kernels/flash_attention/kernel.py:84",
                launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
        del q, k, v, dout, out, lse, lse_ref, ins, lib_out
        free_card()
    return rows


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
    for step in range(LM_F32_DECODE):
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
    log(f"check (ii) fp32, {LM_F32_BATCH} x {LM_PROMPT} prompt + {LM_F32_DECODE} decode "
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


@contextlib.contextmanager
def counted_drops():
    """Yields a list that gets, for each MoE layer run in the block, its
    (tokens, capacity, dropped (token, choice) pairs), read from the
    route ``moe_ffn`` computes (one host read a layer)."""
    from repro_torch.models import moe

    real = moe.route
    seen: list = []

    def route(x, router_w, cfg, C):
        r = real(x, router_w, cfg, C)
        seen.append((x.shape[0], C, r.dropped))
        return r

    moe.route = route
    try:
        yield seen
    finally:
        moe.route = real


def free_card() -> None:
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def serve_bf16(cfg, toks, dev, label: str, keep: dict | None = None) -> int:
    """Phase 8b's bf16 run of one model: prefill of phase 8's prompt and
    LM_DECODE greedy steps, timed; a warm prefill (its MoE drops
    counted a layer), then a profiled prefill and MLA_MOE_PROFILED_STEPS
    profiled decode steps.  Returns the flash_attention launches of the
    first prefill.  ``keep`` gets the prompt, the first prefill's logits,
    each decode step's logits and the tokens fed to it, on the host
    (phase 8d's reference)."""
    import torch

    from repro_torch import kernels as K
    from repro_torch.models import lm
    from repro_torch.models.common import param_count

    t_run = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = lm.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg)
    torch.cuda.synchronize()
    log(f"{label}: {cfg.n_layers} layers, d={cfg.d_model}, {param_count(model)} "
        f"parameters ({cfg.param_dtype}, attn_type={cfg.attn_type}, attn_impl="
        f"{cfg.attn_impl}, moe={cfg.moe}) initialised on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    B, S = toks.shape
    K.reset_launch_counts()
    t0 = time.perf_counter()
    cache, logits = lm.prefill_step(model, toks, cfg, LM_MAX_LEN)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches = K.launch_counts()["flash_attention"]
    kept = [] if keep is None else [logits.clone()]
    fed = []
    t0 = time.perf_counter()
    for step in range(LM_DECODE):
        nxt = logits.argmax(-1).to(torch.int32)
        logits, cache = lm.decode_step(model, cache, nxt, S + step, cfg)
        if keep is not None:
            fed.append(nxt)
            kept.append(logits.clone())
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    if keep is not None:
        keep.update(prompt=toks.cpu().numpy(), prefill=kept[0].cpu().numpy(),
                    steps=[t.cpu().numpy() for t in kept[1:]],
                    tokens=torch.stack(fed).cpu().numpy())
    del kept, fed
    if not bool(torch.isfinite(logits).all()) or logits.shape != (B, cfg.vocab):
        fail(f"{label}: decode logits are not finite of shape {(B, cfg.vocab)}")
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    with counted_drops() as drops:
        lm.prefill_step(model, toks, cfg, LM_MAX_LEN)
        torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with device_profile(f"{label} prefill"):
        warm_cache, warm_logits = lm.prefill_step(model, toks, cfg, LM_MAX_LEN)
        torch.cuda.synchronize()
    with device_profile(f"{label} {MLA_MOE_PROFILED_STEPS} decode steps"):
        for step in range(MLA_MOE_PROFILED_STEPS):
            nxt = warm_logits.argmax(-1).to(torch.int32)
            warm_logits, warm_cache = lm.decode_step(model, warm_cache, nxt, S + step, cfg)
        torch.cuda.synchronize()
    log(f"{label}: the two profiled windows took {time.perf_counter() - t0:.1f} s")
    log(f"{label}: prefill {B} x {S} tokens {prefill_s:.3f} s (warm {warm_s:.3f} s "
        f"with the drops counted, {B * S / warm_s:.0f} tokens/s); {LM_DECODE} "
        f"greedy decode steps {decode_s:.3f} s = {decode_s / LM_DECODE * 1e3:.2f} "
        f"ms/token, {B * LM_DECODE / decode_s:.1f} tokens/s at batch {B}; peak "
        f"memory {peak / 2**30:.2f} GiB; flash_attention launches in the prefill: "
        f"{launches}")
    if cfg.moe:
        log(f"{label}: dropped (token, choice) pairs a layer of the prefill, of "
            f"{B * S * cfg.moe.top_k} at capacity {drops[0][1]} an expert: "
            f"{[d for _, _, d in drops]}")
    del model, cache, logits, warm_cache, warm_logits
    free_card()
    log(f"{label}: the bf16 run took {time.perf_counter() - t_run:.1f} s")
    return launches


def mla_moe_serving(dev) -> tuple[int, int, dict]:
    """Phase 8b: minicpm3-4b whole, phi3.5-moe and dbrx at published
    widths and the depth one card holds, each in bf16 and then as an
    fp32 twin held against a teacher-forced prefill.  Returns the
    flash_attention launches of phi3.5-moe's bf16 prefill (phase 8's
    shape) and of dbrx's, and phi3.5-moe's run kept for phase 8d."""
    import dataclasses

    import torch

    from repro_torch import kernels as K
    from repro_torch.configs import get_arch
    from repro_torch.data import lm_batch
    from repro_torch.models import lm

    def decode_vs_forced(model, cfg, seq, label):
        """fp32: LM_DECODE greedy steps from the prompt's prefill,
        the last one's logits against a teacher-forced prefill of the
        grown sequence."""
        S = seq.shape[1]
        cache, logits = lm.prefill_step(model, seq, cfg, LM_MAX_LEN)
        for step in range(LM_DECODE):
            nxt = logits.argmax(-1).to(torch.int32)
            seq = torch.cat([seq, nxt[:, None]], dim=1)
            logits, cache = lm.decode_step(model, cache, nxt, S + step, cfg)
        _, forced = lm.prefill_step(model, seq, cfg, LM_MAX_LEN)
        torch.cuda.synchronize()
        diff = float((logits - forced).abs().max())
        log(f"{label}: fp32, {seq.shape[0]} x {S} prompt + {LM_DECODE} decode steps "
            f"vs a teacher-forced prefill of {seq.shape[1]} tokens: max abs diff "
            f"{diff:.4g} (max |logit| {float(forced.abs().max()):.4g}; rtol "
            f"{LM_F32_RTOL}, atol {LM_F32_ATOL})")
        if not torch.allclose(logits, forced, rtol=LM_F32_RTOL, atol=LM_F32_ATOL):
            fail(f"{label}: fp32 decode differs from the teacher-forced prefill "
                 f"(max abs diff {diff})")

    toks = torch.as_tensor(
        lm_batch(0, LM_BATCH, LM_PROMPT, get_arch(MLA_ARCH).make_config().vocab,
                 seed=SEED)["tokens"], device=dev)
    shard_ref: dict = {}

    # (a) minicpm3-4b, 62 layers: its prefill attends by the plain
    # blockwise path (MLA's q/k and v head dims differ)
    cfg = get_arch(MLA_ARCH).make_config()
    if serve_bf16(cfg, toks, dev, MLA_ARCH):
        fail(f"{MLA_ARCH}: the MLA prefill launched flash_attention")
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = lm.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg32)
    decode_vs_forced(model, cfg32, toks[:LM_F32_BATCH],
                     f"{MLA_ARCH} (absorbed decode vs materialised prefill)")
    log(f"{MLA_ARCH} fp32 twin: {time.perf_counter() - t0:.2f} s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del model
    free_card()

    launches = []
    for arch, layers in MOE_ARCHS:
        full = get_arch(arch).make_config()
        log(f"{arch}: depth cut to {layers} of {full.n_layers} layers (published "
            f"widths): its {full.n_layers} layers of bf16 weights, "
            f"{full.n_params() * 2 / 1e9:.1f} GB, do not fit one 80 GB card")
        toks_a = torch.as_tensor(
            lm_batch(0, LM_BATCH, LM_PROMPT, full.vocab, seed=SEED)["tokens"], device=dev)
        cfg = dataclasses.replace(full, n_layers=layers)
        n = serve_bf16(cfg, toks_a, dev, f"{arch} ({layers} layers)",
                       keep=shard_ref if arch == SHARD_ARCH else None)
        if n != layers:
            fail(f"{arch}: the prefill launched flash_attention {n} times, not "
                 f"once a layer ({layers})")
        launches.append(n)

        # fp32 twin at MOE_F32_LAYERS layers
        cfg32 = dataclasses.replace(full, n_layers=MOE_F32_LAYERS, param_dtype="float32")
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        model = lm.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg32)
        seq = toks_a[:LM_F32_BATCH]
        # (i) the kernel route against plain attention, the same prompt
        K.reset_launch_counts()
        with counted_drops() as drops:
            _, kernel_logits = lm.prefill_step(model, seq, cfg32, LM_MAX_LEN)
            torch.cuda.synchronize()
        if K.launch_counts()["flash_attention"] != MOE_F32_LAYERS:
            fail(f"{arch}: the fp32 prefill did not attend through the kernel")
        _, plain_logits = lm.prefill_step(
            model, seq, dataclasses.replace(cfg32, attn_impl="xla"), LM_MAX_LEN)
        diff = float((kernel_logits - plain_logits).abs().max())
        log(f"{arch} fp32 ({MOE_F32_LAYERS} layers): prefill logits, kernel vs plain "
            f"attention: max abs diff {diff:.4g} (max |logit| "
            f"{float(plain_logits.abs().max()):.4g}; rtol {LM_F32_RTOL}, atol "
            f"{LM_F32_ATOL}); dropped pairs a layer at capacity {drops[0][1]}: "
            f"{[d for _, _, d in drops]}")
        if not torch.allclose(kernel_logits, plain_logits, rtol=LM_F32_RTOL,
                              atol=LM_F32_ATOL):
            fail(f"{arch}: fp32 prefill through the kernel differs from plain "
                 f"attention (max abs diff {diff})")
        # (ii) decode against teacher-forced prefill, at a capacity that
        # drops nothing (C = N): a prefill of N tokens drops what a
        # decode step of 2 never does, so the published capacity would
        # route the two differently.  Plain attention: the grown
        # sequence (1952 tokens) is no multiple of the kernel's 128, and
        # (i) held the kernel route against it
        moe = full.moe
        nodrop = dataclasses.replace(
            cfg32, attn_impl="xla",
            moe=dataclasses.replace(moe, capacity_factor=moe.n_experts / moe.top_k))
        with counted_drops() as drops:
            decode_vs_forced(model, nodrop, seq,
                             f"{arch} (capacity factor {moe.n_experts / moe.top_k:g}, "
                             f"no drop)")
        if any(d for _, _, d in drops):
            fail(f"{arch}: the no-drop twin dropped pairs: {drops}")
        log(f"{arch} fp32 twin: {time.perf_counter() - t0:.2f} s; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del model, kernel_logits, plain_logits
        free_card()
    return launches[0], launches[1], shard_ref


def shard_drops(routes: list, tp: int, tp_rank: int, n_experts: int) -> list:
    """Each MoE route's dropped pairs: (all, the rank's own experts'),
    after checking them against the per-dp-rank rule, sum over experts
    of max(0, pairs - C) from the rank's own tokens."""
    import numpy as np

    out = []
    for r in routes:
        counts = np.bincount(r["idx"].reshape(-1), minlength=n_experts)
        over = np.maximum(counts - r["C"], 0)
        dropped = int((~r["keep"]).sum())
        if dropped != int(over.sum()):
            fail(f"phase 8d: {dropped} dropped pairs where the capacity {r['C']} drops "
                 f"{int(over.sum())}")
        el = n_experts // tp
        out.append((dropped, int(over[tp_rank * el:(tp_rank + 1) * el].sum())))
    return out


def one_process_runs(cfg, toks, row_sets, steps: int, dev) -> dict:
    """Phase 8d's references: one process's prefill of each row set of
    ``toks`` alone and ``steps`` greedy decode steps, on the host by
    (first row, last row + 1): the prefill's and each step's logits and
    MoE routes, and the greedy tokens (each fed to the next step)."""
    import numpy as np
    import torch

    from repro_torch.launch.lm_shard import recorded_routes
    from repro_torch.models import lm

    model = lm.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg)
    out = {}
    for lo, hi in row_sets:
        with recorded_routes() as routes:
            cache, logits = lm.prefill_step(model, torch.as_tensor(toks[lo:hi], device=dev),
                                            cfg, LM_MAX_LEN)
        got = dict(prefill=logits.cpu().numpy(), prefill_routes=routes, steps=[],
                   step_routes=[], tokens=[])
        for step in range(steps):
            nxt = lm.greedy_tokens(logits)
            got["tokens"].append(nxt.cpu().numpy())
            with recorded_routes() as routes:
                logits, cache = lm.decode_step(model, cache, nxt, toks.shape[1] + step, cfg)
            got["steps"].append(logits.cpu().numpy())
            got["step_routes"].append(routes)
        got["tokens"] = np.stack(got["tokens"])
        out[(lo, hi)] = got
    del model, cache, logits
    free_card()
    return out


def dp_row_sets(B: int, topo) -> list:
    """The (first, last + 1) rows of each dp rank of ``topo``."""
    from repro_torch.models import lm

    if not lm.batch_rows(B, topo)[1]:
        return [(0, B)]
    n = B // topo.dp_size
    return [(i * n, (i + 1) * n) for i in range(topo.dp_size)]


def last_token_route(rec: dict, rows: int) -> tuple:
    """One MoE route's experts and kept flags (rows, k) of each row's
    last token, in ascending expert order: the order of the combine, so
    two near-equal gates that trade places change nothing."""
    import numpy as np

    k = rec["idx"].shape[-1]
    idx, keep = (rec[key].reshape(rows, -1, k)[:, -1] for key in ("idx", "keep"))
    order = np.argsort(idx, axis=1)
    return np.take_along_axis(idx, order, 1), np.take_along_axis(keep, order, 1)


def routed_alike(a: list, b: list, rows: int):
    """Per row of one call's batch, whether the token whose logits the
    call returns (a row's last) took the same experts and kept the same
    pairs in every MoE layer in two runs' routes."""
    import numpy as np

    same = np.ones(rows, dtype=bool)
    for x, y in zip(a, b, strict=True):
        (ix, kx), (iy, ky) = last_token_route(x, rows), last_token_route(y, rows)
        same &= (ix == iy).all(axis=1) & (kx == ky).all(axis=1)
    return same


def first_flips(a: list, b: list, rows: int) -> list:
    """For each row whose token (a row's last) routed otherwise in two
    runs' routes of one call (a: the sharded rank's, b: one process's):
    (row, the first MoE layer where it did, "experts" or "kept", and the
    router's margin there between its k-th and (k+1)-th probability in
    one process and in the sharded run, in bf16 ulps of the k-th: (p_k -
    p_k+1) / (p_k 2^-8))."""
    import numpy as np

    out, seen = [], np.zeros(rows, dtype=bool)
    for layer, (x, y) in enumerate(zip(a, b, strict=True)):
        k = x["idx"].shape[-1]
        (ix, kx), (iy, ky) = last_token_route(x, rows), last_token_route(y, rows)
        experts = (ix != iy).any(axis=1)
        kept = (kx != ky).any(axis=1)
        tops = [t["top"].reshape(rows, -1, k + 1)[:, -1] for t in (y, x)]
        for row in np.flatnonzero((experts | kept) & ~seen):
            margins = [float((t[row, k - 1] - t[row, k]) / (t[row, k - 1] * 2.0 ** -8))
                       for t in tops]
            out.append((int(row), layer, "experts" if experts[row] else "kept", *margins))
        seen |= experts | kept
    return out


def held_to(got_prefill, got_steps, ranks: list, refs: dict):
    """A sharded run's logits (its whole batch) against the one-process
    runs of its row sets: each row's gap in the prefill and in each step
    as a share of its set's max |prefill logit|, (calls, B), whether
    that row's token routed as in the one process (tp rank 0 of the
    set's dp rank), and each row that did not: (call, row, its
    :func:`first_flips` entry)."""
    import numpy as np

    calls = [got_prefill] + list(got_steps)
    gaps = np.zeros((len(calls), got_prefill.shape[0]))
    alike = np.zeros(gaps.shape, dtype=bool)
    flips = []
    for i, ((lo, hi), want) in enumerate(sorted(refs.items())):
        r = next(r for r in ranks
                 if r["coords"]["data"] == i and r["coords"].get("model", 0) == 0)
        scale = float(np.abs(want["prefill"]).max())
        for c, (got, w, rg, rw) in enumerate(zip(
                calls, [want["prefill"]] + want["steps"],
                [r["prefill_routes"]] + r["step_routes"],
                [want["prefill_routes"]] + want["step_routes"], strict=True)):
            gaps[c, lo:hi] = np.abs(got[lo:hi] - w).max(axis=-1) / scale
            alike[c, lo:hi] = routed_alike(rg, rw, hi - lo)
            flips += [(c, lo + row, *rest) for row, *rest in first_flips(rg, rw, hi - lo)]
    return gaps, alike, flips


def sharded_serving(dev, ref: dict, card_line: str) -> int:
    """Phase 8d: phi3.5-moe at full width and SHARD_LAYERS layers across
    gloo processes sharing the card, each grid of SHARD_GRIDS, a bf16
    run, the same at a capacity that drops nothing, and the fp32 twin,
    each against one process on each dp rank's rows (a MoE layer's
    capacity is its dp rank's token count, so at dp 2 the rows run in
    pairs; at dp 1 that process is phase 8b's run, ``ref``, bit for bit),
    the bf16 runs fed the one process's tokens, the twin greedy.  A bf16
    rounding can flip a token's top-2 experts (or, at the published
    capacity, which pairs drop) and move its logits by far more than the
    rounding: bf16 logits are held where the row's token routed as one
    process's did, each other row only where its first flip was a near
    tie (SHARD_FLIP_ULPS), the twin everywhere; one process on the whole batch must
    repeat phase 8b's bits.  Returns rank 0's
    flash_attention launches in grid (a)'s prefill."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.launch import lm_shard
    from repro_torch.launch.mesh import make_cpu_topology
    from repro_torch.models import lm
    from repro_torch.models.convert import unshard_tree

    full = get_arch(SHARD_ARCH).make_config()
    toks = ref["prompt"]
    B = toks.shape[0]
    over = {"n_layers": SHARD_LAYERS}
    # a capacity that drops nothing (C = N): the routes' ties and drops
    # then turn on no bf16 rounding
    nodrop = {**over, "moe": {"capacity_factor": full.moe.n_experts / full.moe.top_k}}
    over32 = {"n_layers": MOE_F32_LAYERS, "param_dtype": "float32"}
    toks32 = toks[:LM_F32_BATCH]
    grids = [(label, make_cpu_topology(world, tp), steps)
             for label, world, tp, *steps in SHARD_GRIDS]

    def cut(run: dict, n: int) -> dict:
        """A reference run's first n decode steps."""
        return {**run, "steps": run["steps"][:n], "step_routes": run["step_routes"][:n],
                "tokens": run["tokens"][:n]}

    # the one-process references of every grid's dp ranks
    t0 = time.perf_counter()
    sets = sorted({rs for _, topo, *_ in grids for rs in dp_row_sets(B, topo)} | {(0, B)})
    refs = one_process_runs(lm_shard.job_config(dict(arch=SHARD_ARCH, over=over)), toks,
                            sets, LM_DECODE, dev)
    same = (np.array_equal(refs[(0, B)]["prefill"], ref["prefill"])
            and all(np.array_equal(a, b) for a, b in zip(refs[(0, B)]["steps"], ref["steps"])))
    log(f"phase 8d: one process on the whole batch repeats phase 8b's logits bit for bit: "
        f"{same}")
    if not same:
        fail("phase 8d: one process on the whole batch does not repeat phase 8b's logits "
             "bit for bit")
    refs_nd = one_process_runs(lm_shard.job_config(dict(arch=SHARD_ARCH, over=nodrop)), toks,
                               sets, LM_DECODE, dev)
    sets32 = sorted({rs for _, topo, *_ in grids for rs in dp_row_sets(LM_F32_BATCH, topo)})
    refs32 = one_process_runs(lm_shard.job_config(dict(arch=SHARD_ARCH, over=over32)), toks32,
                              sets32, max(g[2][2] for g in grids), dev)
    log(f"phase 8d: one process on each grid's dp rows, bf16 rows {sets} (at the published "
        f"capacity and at one that drops nothing) and fp32 twin rows {sets32}: "
        f"{time.perf_counter() - t0:.1f} s")

    launches0 = None
    for label, topo, (steps, steps_nd, steps32) in grids:
        world, tp = topo.n_devices, topo.tp_size
        rows = dp_row_sets(B, topo)
        mine = {rs: cut(refs[rs], steps) for rs in rows}
        mine_nd = {rs: cut(refs_nd[rs], steps_nd) for rs in rows}
        mine32 = {rs: cut(refs32[rs], steps32) for rs in dp_row_sets(LM_F32_BATCH, topo)}

        def fed(refs_of):
            return np.concatenate([refs_of[rs]["tokens"] for rs in rows], axis=1)

        jobs = [dict(arch=SHARD_ARCH, over=over, tp=tp, tokens=toks, max_len=LM_MAX_LEN,
                     steps=steps, forced=fed(mine), seed=SEED, routes=True),
                dict(arch=SHARD_ARCH, over=nodrop, tp=tp, tokens=toks, max_len=LM_MAX_LEN,
                     steps=steps_nd, forced=fed(mine_nd), seed=SEED, routes=True),
                dict(arch=SHARD_ARCH, over=over32, tp=tp, tokens=toks32, max_len=LM_MAX_LEN,
                     steps=steps32, seed=SEED, routes=True)]
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            res = lm_shard.run_world(world, jobs, tmp, backend="gloo", device="cuda",
                                     timeout=SHARD_TIMEOUT)
        name = f"({label}) {world} ranks, dp {topo.dp_size} x tp {tp}"
        log(f"phase 8d {name}: the ranks ran in {time.perf_counter() - t0:.1f} s "
            f"(processes started, models drawn, both jobs)")
        for r, nd in ((r[0], r[1]) for r in res):
            n_attn = r["prefill_launches"]["flash_attention"]
            drops = shard_drops(r["prefill_routes"], tp, r["coords"].get("model", 0),
                                full.moe.n_experts)
            log(f"phase 8d {name} rank {r['rank']} {r['coords']}: bf16 prefill "
                f"{r['prefill_s']:.3f} s; {steps_nd} decode steps (the no-drop run; a step "
                f"drops nothing at either capacity) {nd['decode_s']:.3f} s = "
                f"{nd['decode_s'] / steps_nd * 1e3:.2f} ms/token; peak memory "
                f"{r.get('peak_bytes', 0) / 2**30:.2f} GiB; model drawn in {r['init_s']:.2f} s; "
                f"flash_attention launches in the prefill {n_attn}; dropped pairs a layer "
                f"(all, the rank's experts) {drops} at capacity {r['prefill_routes'][0]['C']}; "
                f"collectives a prefill {r['prefill_counts']}, a decode step "
                f"{nd['step_counts'][-1]} (gloo stages a card's tensors through the host: "
                f"not scaling figures)")
            if n_attn != SHARD_LAYERS:
                fail(f"phase 8d {name}: rank {r['rank']} launched flash_attention {n_attn} "
                     f"times in the prefill, not once a layer ({SHARD_LAYERS})")
        faults = []
        for job, (B_job, n_steps, want, tol, what) in enumerate((
                (B, steps, mine, LM_BF16_TOL, "bf16 at the published capacity"),
                (B, steps_nd, mine_nd, LM_BF16_TOL, "bf16 at a capacity that drops nothing"),
                (LM_F32_BATCH, steps32, mine32, SHARD_F32_TOL, "fp32 twin"))):
            runs = [r[job] for r in res]
            lspec = topo.spec("dp" if lm.batch_rows(B_job, topo)[1] else None, "tp")
            prefill = unshard_tree([r["prefill_logits"] for r in runs], lspec, topo)
            steps_got = [unshard_tree([r["step_logits"][s] for r in runs], lspec, topo)
                         for s in range(n_steps)]
            if not all(np.isfinite(x).all() for x in [prefill] + steps_got):
                fail(f"phase 8d {name}: {what} logits are not finite")
            gaps, alike, flips = held_to(prefill, steps_got, runs, want)
            agree = float(np.mean([np.array_equal(runs[0]["tokens"][:, lo:hi], w["tokens"])
                                   for (lo, hi), w in want.items()]))
            held = float(gaps[alike].max()) if alike.any() else 0.0
            log(f"phase 8d {name}: {what} logits against one process on each dp rank's "
                f"rows {sorted(want)}, a row's gap as a share of max |logit| (bound {tol} "
                f"where the row's token routed alike in every layer): routed alike in "
                f"{int(alike.sum())} of {alike.size} (row, call) pairs, the worst of them "
                f"{held:.4g}, of all {float(gaps.max()):.4g}; prefill rows "
                f"{[round(float(g), 5) for g in gaps[0]]}, each step's worst "
                f"{[round(float(g), 5) for g in gaps[1:].max(axis=1)]}; greedy tokens equal "
                f"on {agree:.3f} of the row sets"
                + (" (the reference's fed)" if job < 2 else ""))
            if flips:
                by_experts = [f for f in flips if f[3] == "experts"]
                ulps = np.array([f[4] for f in by_experts])
                log(f"phase 8d {name}: {what}: the (row, call) pairs that did not route "
                    f"alike, at the first MoE layer where each did not: {len(by_experts)} "
                    f"took other experts, the one process's router margin there between "
                    f"its k-th and (k+1)-th probability "
                    + (f"{float(ulps.min()):.3g}-{float(ulps.max()):.3g} (median "
                       f"{float(np.median(ulps)):.3g}) bf16 ulps of the k-th"
                       if by_experts else "-")
                    + f"; {len(flips) - len(by_experts)} kept other pairs (an earlier "
                    f"token's other route took their capacity); each (call, row, layer, "
                    f"what, margin in one process, margin across ranks): "
                    f"{[(c, r, l, w, round(m0, 2), round(m1, 2)) for c, r, l, w, m0, m1 in flips]}")
            if held > tol:
                faults.append(f"{what} logits differ from one process by {held:.4g} of max "
                              f"|logit| where the rows routed alike")
            wide = [f for f in flips if f[3] == "experts" and f[4] > SHARD_FLIP_ULPS]
            if wide:
                faults.append(f"{what}: {len(wide)} rows took other experts than one "
                              f"process's where its router margin exceeds "
                              f"{SHARD_FLIP_ULPS} bf16 ulps: {wide}")
            if job == 1 and alike.mean() < 0.5:
                faults.append(f"{what}: fewer than half the (row, call) pairs routed alike")
            if job == 2 and (agree < 1.0 or not alike.all() or float(gaps.max()) > tol):
                faults.append("the fp32 twin's logits, greedy tokens or routes differ from "
                              "one process's")
        if faults:
            fail(f"phase 8d {name}: " + "; ".join(faults))
        if launches0 is None:
            launches0 = res[0][0]["prefill_launches"]["flash_attention"]
    return launches0


def spec_paths(specs, prefix: str = "") -> dict:
    """A tree of specs (dicts of spec tuples) by leaf path, as
    ``train.checkpoint._flatten_with_paths`` keys a tree of tensors."""
    if isinstance(specs, dict):
        return {k: v for key in sorted(specs)
                for k, v in spec_paths(specs[key], f"{prefix}{key}/").items()}
    return {prefix[:-1]: specs}


def block_gaps(runs: list, step: int, specs: dict, topo, want: dict) -> dict:
    """Each leaf's largest gap between a rank's gradient block (every
    rank of ``runs``, saved by ``launch/train.py::run_job``) and that
    block of ``want`` (one process's whole gradients by path, on the
    card; a run's blocks are a tree or the file it saved), as a share of the leaf's max |grad| in ``want``: the whole
    leaves put back together and compared, every replica of a block held
    besides."""
    import torch

    from repro_torch.models.common import Topology, shard_slices
    from repro_torch.train.checkpoint import _flatten_with_paths as by_path

    gap = dict.fromkeys(want, 0.0)
    for r in runs:
        at = Topology(grid=topo.grid, dp_axes=topo.dp_axes, tp_axis=topo.tp_axis,
                      rank=r["rank"])
        blocks = r["grads"][step]
        for k, b in by_path(torch.load(blocks) if isinstance(blocks, str) else blocks).items():
            w = want[k][shard_slices(want[k].shape, specs[k], at)]
            gap[k] = max(gap[k], float((b.to(w.device).float() - w.float()).abs().max()))
    return {k: g / max(float(want[k].float().abs().max()), 1e-30) for k, g in gap.items()}


def sharded_training(dev, card_line) -> dict:
    """Phase 8e: phi3-mini trains at full width and TRAIN_SHARD_LAYERS
    layers across gloo processes sharing the card, on each grid of
    TRAIN_SHARD_GRIDS with seq_shard_resid (launch/train.py::run_job in
    launch/lm_shard.py's worlds): a cold and TRAIN_SHARD_WARM warm steps,
    every rank launching the forward kernel twice a layer (remat) and the
    backward once, every step; then the fp32 twin with seq_shard_resid
    True and False, grid (b)'s state checkpointed after step 1 and grid
    (a) resuming it.  Then one process on the card: the bf16 run's first
    step, the twin's two steps and its resume; the sharded losses and
    every gradient leaf (put back together by the specs) against it.
    Returns rank 0's (flash_attention, flash_attention_bwd) launches of
    each run by (dtype, grid label)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data import lm_batch
    from repro_torch.launch import lm_shard
    from repro_torch.launch import train as train_launch
    from repro_torch.launch.mesh import make_cpu_topology
    from repro_torch.models import lm
    from repro_torch.train.checkpoint import _flatten_with_paths as by_path

    full = get_arch(TRAIN_ARCH).make_config()
    V, L = full.vocab, TRAIN_SHARD_LAYERS
    over16 = {"n_layers": L, "seq_shard_resid": True}
    over32 = {"n_layers": TRAIN_F32_LAYERS, "param_dtype": "float32"}
    b16 = [lm_batch(s, TRAIN_SHARD_BATCH, TRAIN_SEQ, V, seed=SEED)
           for s in range(1 + TRAIN_SHARD_WARM)]
    b32 = [lm_batch(s, TRAIN_SHARD_BATCH, TRAIN_SHARD_F32_SEQ, V, seed=SEED) for s in range(2)]
    twin = dict(train={"warmup_steps": 1}, adamw={"lr": TRAIN_SHARD_LR})

    def job(over, batches, **kw):
        return dict(kind="train", arch=TRAIN_ARCH, over=over, batches=batches, seed=SEED, **kw)

    def launches_ok(run, what, layers):
        want = (2 * layers, layers)  # remat runs each layer's forward again
        got = [(c.get("flash_attention", 0), c.get("flash_attention_bwd", 0))
               for c in run["launches"]]
        if any(g != want for g in got):
            fail(f"phase 8e {what}: rank {run['rank']} launched (flash_attention, "
                 f"flash_attention_bwd) {got} a step, want {want}")
        return tuple(map(sum, zip(*got)))

    def on_card(tree):
        return {k: v.to(dev) for k, v in by_path(tree).items()}

    out, results = {}, {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        ckpt = os.path.join(tmp, "ckpt")
        for label, world, tp in TRAIN_SHARD_GRIDS:
            files = os.path.join(tmp, f"{label}-{{rank}}-{{step}}")
            jobs = [job(over16, b16, grads=(0,), grads_file=files + "-bf16.pt"),
                    job({**over32, "seq_shard_resid": True}, b32[:1], grads=(0,),
                        grads_file=files + "-sp.pt", **twin,
                        **({"save": (ckpt, 1)} if label == "b" else {})),
                    job({**over32, "seq_shard_resid": False}, b32[:1], grads=(0,),
                        grads_file=files + "-ar.pt", **twin)]
            if label == "a":
                jobs.append(job({**over32, "seq_shard_resid": True}, b32[1:], grads=(0,),
                                grads_file=files + "-resume.pt", restore=ckpt, **twin))
            free_card()
            t0 = time.perf_counter()
            for j in jobs:
                j["tp"] = tp
            res = lm_shard.run_world(world, jobs, os.path.join(tmp, f"w{label}"),
                                     backend="gloo", device="cuda",
                                     timeout=TRAIN_SHARD_TIMEOUT)
            topo = make_cpu_topology(world, tp)
            name = f"({label}) {world} ranks, dp {topo.dp_size} x tp {tp}"
            log(f"phase 8e {name}: the ranks ran in {time.perf_counter() - t0:.1f} s "
                f"(processes started, models drawn, {len(jobs)} jobs)")
            for r in res:
                bf16 = r[0]
                warm = bf16["walls"][1:]
                med = sorted(warm)[len(warm) // 2]
                n = launches_ok(bf16, f"{name} bf16", L)
                for j, what in ((1, "twin, seq_shard_resid"), (2, "twin, all_reduce form")):
                    launches_ok(r[j], f"{name} {what}", TRAIN_F32_LAYERS)
                log(f"phase 8e {name} rank {bf16['rank']} {bf16['coords']}: bf16 cold step "
                    f"{bf16['walls'][0] * 1e3:.1f} ms, warm "
                    f"{', '.join(f'{w * 1e3:.1f}' for w in warm)} ms (median "
                    f"{med * 1e3:.1f} ms, {TRAIN_SHARD_BATCH * TRAIN_SEQ / med:.0f} tokens/s "
                    f"of the world); losses {[round(x, 5) for x in bf16['losses']]}; peak "
                    f"{bf16.get('peak_bytes', 0) / 2**30:.2f} GiB; (flash_attention, "
                    f"flash_attention_bwd) launches a step {bf16['launches'][-1].get('flash_attention')}"
                    f", {bf16['launches'][-1].get('flash_attention_bwd')}; collectives a warm "
                    f"step {bf16['counts'][-1]}; the twin's steps "
                    f"{[round(w * 1e3, 1) for w in r[1]['walls']]} ms (seq_shard_resid), "
                    f"{[round(w * 1e3, 1) for w in r[2]['walls']]} ms (all_reduce form), "
                    f"collectives a step {r[1]['counts'][0]} and {r[2]['counts'][0]} (gloo "
                    f"stages a card's tensors through the host: not scaling figures); set-up "
                    f"(draw or restore) of the jobs {[round(j['setup_s'], 2) for j in r]} s, "
                    f"gradient files {[round(j['files_s'], 2) for j in r]} s, checkpoint "
                    f"{[round(j['save_s'], 2) for j in r]} s")
                if not all(np.isfinite(x) for j in r for x in j["losses"]):
                    fail(f"phase 8e {name}: rank {bf16['rank']}: a loss is not finite")
                if bf16["losses"] != res[0][0]["losses"]:
                    fail(f"phase 8e {name}: the ranks' bf16 losses differ")
            out[("bfloat16", label)] = launches_ok(res[0][0], name, L)
            out[("float32", label)] = tuple(
                a + b for a, b in zip(launches_ok(res[0][1], name, TRAIN_F32_LAYERS),
                                      launches_ok(res[0][2], name, TRAIN_F32_LAYERS)))
            results[label] = (topo, res)

        # one process on the card, after the worlds
        free_card()
        t0 = time.perf_counter()
        cfg16 = lm_shard.job_config(job(over16, b16))
        one16 = train_launch.run_job(job(over16, b16[:1], grads=(0,)), None, dev)
        want16 = on_card(one16.pop("grads")[0])
        cfg32 = lm_shard.job_config(job(over32, b32))
        one32 = train_launch.run_job(job(over32, b32, grads=(0, 1), **twin), None, dev)
        want32 = [on_card(g) for g in one32.pop("grads").values()]
        resumed = train_launch.run_job(job(over32, b32[1:], grads=(0,), restore=ckpt, **twin),
                                       None, dev)
        log(f"phase 8e: one process: bf16 loss {one16['losses'][0]:.6f} (step "
            f"{one16['walls'][0] * 1e3:.1f} ms, peak {one16.get('peak_bytes', 0) / 2**30:.2f} "
            f"GiB), the twin's losses {one32['losses']}, resumed from grid (b)'s step 1 "
            f"{resumed['losses']}: {time.perf_counter() - t0:.1f} s")
        faults = []

        def held(what, loss, want_loss, gaps, rtol, tol):
            rel = abs(loss - want_loss) / abs(want_loss)
            worst = max(gaps, key=gaps.get)
            log(f"phase 8e {what}: loss {loss:.6f} against one process's {want_loss:.6f} "
                f"({rel:.3g} of it, tol {rtol}); gradients, worst leaf {worst} "
                f"{gaps[worst]:.3g} of its max |grad| (tol {tol}); "
                f"{', '.join(f'{k} {v:.3g}' for k, v in gaps.items())}")
            if not (rel <= rtol and gaps[worst] <= tol):
                faults.append(f"{what}: loss {rel:.3g}, leaf {worst} {gaps[worst]:.3g}")

        one_rank = make_cpu_topology(1, 1)
        held("one process resumed from grid (b)'s step 1, step 2", resumed["losses"][0],
             one32["losses"][1], block_gaps([resumed], 0, spec_paths(lm.param_specs(
                 cfg32, one_rank)), one_rank, want32[1]),
             TRAIN_F32_LOSS_RTOL, TRAIN_F32_GRAD_TOL)
        for label, (topo, res) in results.items():
            name = f"({label})"
            s16 = spec_paths(lm.param_specs(cfg16, topo))
            s32 = spec_paths(lm.param_specs(cfg32, topo))
            held(f"{name} bf16, step 1", res[0][0]["losses"][0], one16["losses"][0],
                 block_gaps([r[0] for r in res], 0, s16, topo, want16),
                 TRAIN_SHARD_BF16_LOSS_RTOL, TRAIN_BF16_GRAD_TOL)
            held(f"{name} fp32 twin, seq_shard_resid, step 1", res[0][1]["losses"][0],
                 one32["losses"][0], block_gaps([r[1] for r in res], 0, s32, topo, want32[0]),
                 TRAIN_F32_LOSS_RTOL, TRAIN_F32_GRAD_TOL)
            held(f"{name} fp32 twin, the all_reduce form, step 1", res[0][2]["losses"][0],
                 one32["losses"][0], block_gaps([r[2] for r in res], 0, s32, topo, want32[0]),
                 TRAIN_F32_LOSS_RTOL, TRAIN_F32_GRAD_TOL)
            if label == "a":
                held(f"{name} fp32 twin resumed from grid (b)'s step 1, step 2",
                     res[0][3]["losses"][0], one32["losses"][1],
                     block_gaps([r[3] for r in res], 0, s32, topo, want32[1]),
                     TRAIN_F32_LOSS_RTOL, TRAIN_F32_GRAD_TOL)
        del want16, want32
        if faults:
            fail("phase 8e: " + "; ".join(faults))
    return out


def route_gaps(params, batch, cfg, check: str) -> tuple[float, dict]:
    """Phase 8c's (b) and (c): lm_loss and its gradient on ``params``
    through the kernels (cfg's attn_impl) and on the plain route
    (attn_impl "xla").  Fails unless the kernel route launched the
    forward kernel twice a layer (once more under remat) and the
    backward once.  Returns the loss difference as a share of the plain
    loss, and each leaf's max gap as a share of its plain max |grad|."""
    from repro_torch import kernels as K
    from repro_torch.models import lm
    from repro_torch.train.train_step import value_and_grad
    from torch.utils._pytree import keystr, tree_flatten_with_path, tree_leaves

    def run(c):
        return value_and_grad(lambda p, b: lm.lm_loss(p, b, c))(params, batch)

    before = K.launch_counts()
    loss_k, grads_k = run(cfg)
    counts = K.launch_counts()
    got = tuple(counts[n] - before.get(n, 0) for n in ("flash_attention", "flash_attention_bwd"))
    want = ((2 if cfg.remat == "full" else 1) * cfg.n_layers, cfg.n_layers)
    if got != want:
        fail(f"phase 8c {check}: the kernel route launched (flash_attention, "
             f"flash_attention_bwd) {got} times, want {want}")
    loss_p, grads_p = run(dataclasses.replace(cfg, attn_impl="xla"))
    rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    gaps = {keystr(path).strip("[]'").replace("']['", "."):
            float((a.float() - c.float()).abs().max() / c.float().abs().max().clamp_min(1e-30))
            for (path, a), c in zip(tree_flatten_with_path(grads_k)[0],
                                    tree_leaves(grads_p))}
    return rel, gaps


def lm_training(dev, card_line) -> tuple[int, int]:
    """Phase 8c: phi3-mini-3.8b trains at full width in bf16 on the card,
    its attention through the forward kernel and the backward kernel, at
    TRAIN_LAYERS layers (all 32: the step's peak leaves TRAIN_FREE_GIB of
    the card free, which is checked).  (c) first, on the run's weights at
    2 layers: the loss and every gradient leaf through the kernels against
    the plain route (route_gaps).  (a) a cold step and TRAIN_WARM warm ones of build_train_step(lm_loss)
    with the params and AdamW state updated in place, one more under the
    profiler.  (b) the fp32 twin at 2 layers: loss and gradients, kernel
    route against the plain route.  Returns the backward kernel's
    launches in (a) and in (b)."""
    import dataclasses

    import torch

    from repro_torch import kernels as K
    from repro_torch.configs import get_arch
    from repro_torch.data import lm_batch
    from repro_torch.models import lm
    from repro_torch.train import TrainConfig, build_train_step, init_train_state
    from torch.utils._pytree import tree_leaves

    full = get_arch(TRAIN_ARCH).make_config()
    cfg = dataclasses.replace(full, n_layers=TRAIN_LAYERS)

    def batch(step, seq, vocab):
        return {k: torch.as_tensor(v, device=dev)
                for k, v in lm_batch(step, TRAIN_BATCH, seq, vocab, seed=SEED).items()}

    free_card()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_tree(torch.Generator(device=dev).manual_seed(SEED), cfg)
    tc = TrainConfig()
    opt = init_train_state(params, tc)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"{cfg.name}: {cfg.n_layers} of {full.n_layers} layers, d={cfg.d_model}, "
        f"{n_params} parameters ({cfg.param_dtype}, attn_impl={cfg.attn_impl}, remat="
        f"{cfg.remat}, loss_chunk={cfg.loss_chunk}) and AdamW state (f32 master, m, v) "
        f"made on the card in {time.perf_counter() - t0:.2f} s: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    # (c) the loss and the gradients at 2 layers of these weights,
    # kernels vs plain
    two = {**params, "layers": {k: v[:TRAIN_F32_LAYERS] for k, v in params["layers"].items()}}
    cfg2 = dataclasses.replace(cfg, n_layers=TRAIN_F32_LAYERS)
    rel, gaps = route_gaps(two, batch(0, TRAIN_SEQ, cfg.vocab), cfg2, "(c)")
    worst = max(gaps, key=gaps.get)
    log(f"check (c) bf16, {TRAIN_F32_LAYERS} layers, S {TRAIN_SEQ}, through the kernels vs "
        f"the plain route: loss {rel:.3g} of it (tol {TRAIN_BF16_LOSS_RTOL}); gradients, "
        f"worst leaf {worst} {gaps[worst]:.3g} of its max |grad| (tol "
        f"{TRAIN_BF16_GRAD_TOL}); {', '.join(f'{k} {g:.3g}' for k, g in gaps.items())}")
    if not (rel <= TRAIN_BF16_LOSS_RTOL and gaps[worst] <= TRAIN_BF16_GRAD_TOL):
        fail(f"phase 8c (c): the bf16 kernel route differs from the plain route "
             f"(loss {rel:.3g}, leaf {worst} {gaps[worst]:.3g})")
    del two
    free_card()
    torch.cuda.reset_peak_memory_stats()

    # (a) the steps
    step_fn = build_train_step(lambda p, b: lm.lm_loss(p, b, cfg), tc, donate=True)
    losses, walls, per_step = [], [], []
    for step in range(1 + TRAIN_WARM):
        b = batch(step, TRAIN_SEQ, cfg.vocab)
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, b, torch.tensor(step, dtype=torch.int32,
                                                               device=dev))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts = K.launch_counts()
        per_step.append((counts["flash_attention"], counts["flash_attention_bwd"]))
        losses.append(float(m["loss"]))
        log(f"train step {step} ({'cold' if step == 0 else 'warm'}): {walls[-1] * 1e3:.1f} ms, "
            f"loss {losses[-1]:.5f}, grad norm {float(m['grad_norm']):.4f}, lr "
            f"{float(m['lr']):.3g}; flash_attention launches {per_step[-1][0]}, "
            f"flash_attention_bwd launches {per_step[-1][1]}")
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    with device_profile("one warm train step", top=8, kernel="attention_"):
        params, opt, m = step_fn(params, opt, batch(1 + TRAIN_WARM, TRAIN_SEQ, cfg.vocab),
                                 torch.tensor(1 + TRAIN_WARM, dtype=torch.int32, device=dev))
        torch.cuda.synchronize()
    losses.append(float(m["loss"]))
    warm = walls[1:]
    med = sorted(warm)[len(warm) // 2]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f"LM training, {cfg.name} at {cfg.n_layers} layers, B {TRAIN_BATCH} x S {TRAIN_SEQ}: "
        f"cold step {walls[0] * 1e3:.1f} ms, warm steps "
        f"{', '.join(f'{w * 1e3:.1f}' for w in warm)} ms (median {med * 1e3:.1f} ms, "
        f"{tokens / med:.0f} tokens/s); peak {peak / 2**30:.2f} GiB of the card's "
        f"{total / 2**30:.2f} GiB ({(total - peak) / 2**30:.2f} GiB free); losses "
        f"{[round(x, 5) for x in losses]}; on {card_line}")
    if not all(map(lambda x: x == x and abs(x) != float("inf"), losses)):
        fail(f"phase 8c: a loss is not finite: {losses}")
    want = (2 * cfg.n_layers if cfg.remat == "full" else cfg.n_layers, cfg.n_layers)
    if any(c != want for c in per_step):
        fail(f"phase 8c: (flash_attention, flash_attention_bwd) launches a step {per_step}, "
             f"want {want}: one backward a layer, the forward again under remat")
    if (total - peak) / 2**30 < TRAIN_FREE_GIB:
        fail(f"phase 8c: the step's peak {peak / 2**30:.2f} GiB leaves less than "
             f"{TRAIN_FREE_GIB} GiB of the card free: cut TRAIN_LAYERS")
    bf16_launches = sum(c[1] for c in per_step)
    del params, opt, m, step_fn
    free_card()

    # (b) the fp32 twin: kernel route vs plain route, loss and gradients
    cfg32 = dataclasses.replace(full, n_layers=TRAIN_F32_LAYERS, param_dtype="float32")
    params = lm.init_tree(torch.Generator(device=dev).manual_seed(SEED), cfg32)
    K.reset_launch_counts()
    rel, gaps = route_gaps(params, batch(0, TRAIN_F32_SEQ, cfg32.vocab), cfg32, "(b)")
    f32_launches = K.launch_counts()["flash_attention_bwd"]
    worst = max(gaps, key=gaps.get)
    log(f"check (b) fp32 twin, {TRAIN_F32_LAYERS} layers, S {TRAIN_F32_SEQ}, through the "
        f"kernels vs the plain route: loss {rel:.3g} of it (tol {TRAIN_F32_LOSS_RTOL}); "
        f"gradients, worst leaf {worst} {gaps[worst]:.3g} of its max |grad| (tol "
        f"{TRAIN_F32_GRAD_TOL}) over {len(gaps)} leaves")
    if not (rel <= TRAIN_F32_LOSS_RTOL and gaps[worst] <= TRAIN_F32_GRAD_TOL):
        fail(f"phase 8c (b): the fp32 twin's kernel route differs from the plain route "
             f"(loss {rel:.3g}, leaf {worst} {gaps[worst]:.3g})")
    del params
    free_card()
    return bf16_launches, f32_launches


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


def mind_route_gaps(params, batch, cfg) -> tuple[float, dict, float]:
    """Phase 9b's check: sampled_softmax_loss and its gradient on
    ``params`` through the kernels (cfg's bag_impl) and through the plain
    bag (bag_impl "ref").  Fails unless the kernel route launched the bag
    kernel once and the vertex sum once.  Returns the loss difference as
    a share of the plain loss, each leaf's max gap as a share of its
    plain max |grad| (MIND_ZERO_LEAF apart), and MIND_ZERO_LEAF's largest
    |grad| on either route as a share of the largest |grad| of any leaf."""
    from repro_torch import kernels as K
    from repro_torch.models import mind
    from repro_torch.train.train_step import value_and_grad
    from torch.utils._pytree import keystr, tree_flatten_with_path, tree_leaves

    def run(c):
        return value_and_grad(lambda p, b: mind.sampled_softmax_loss(p, b, c))(params, batch)

    K.reset_launch_counts()
    loss_k, grads_k = run(cfg)
    got = tuple(K.launch_counts()[n] for n in ("embedding_bag", "spmm_ell"))
    if got != (1, 1):
        fail(f"phase 9b: the kernel route launched (embedding_bag, spmm_ell) {got} times, "
             f"want (1, 1)")
    loss_p, grads_p = run(dataclasses.replace(cfg, bag_impl="ref"))
    rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    names = [keystr(path).strip("[]'").replace("']['", ".")
             for path, _ in tree_flatten_with_path(grads_p)[0]]
    pairs = dict(zip(names, zip(tree_leaves(grads_k), tree_leaves(grads_p))))
    top = max(float(c.abs().max()) for _, c in pairs.values())
    zero = max(float(t.abs().max()) for t in pairs.pop(MIND_ZERO_LEAF)) / top
    gaps = {k: float((a - c).abs().max() / c.abs().max().clamp_min(1e-30))
            for k, (a, c) in pairs.items()}
    return rel, gaps, zero


def mind_update_gaps(step_fn, cfg, tree, opt, batch, step: int) -> tuple[dict, dict, dict]:
    """Phase 9b's check of the update: one step of the train cell's
    ``step_fn`` (in place) against plain AdamW (clip, bias correction,
    decoupled weight decay, the warmup's lr) applied here to a gradient
    of sampled_softmax_loss recomputed on the same batch and weights.
    Returns each leaf's largest gap and its largest move, both as shares
    of the step's lr, and the step's metrics."""
    import torch
    from torch.utils._pytree import keystr, tree_flatten_with_path

    from repro_torch.models import mind
    from repro_torch.train import TrainConfig
    from repro_torch.train.train_step import value_and_grad

    tc = TrainConfig()
    a = tc.adamw
    if step >= tc.warmup_steps:
        fail(f"phase 9b: the update check's step {step} is past the warmup")
    lr = a.lr * (step + 1) / tc.warmup_steps

    def flat(t):
        return {keystr(path).strip("[]'").replace("']['", "."): x
                for path, x in tree_flatten_with_path(t)[0]}

    _, grads = value_and_grad(lambda p, b: mind.sampled_softmax_loss(p, b, cfg))(tree, batch)
    g_all, m_all, v_all, w_all = (flat(x) for x in (grads, opt["m"], opt["v"], opt["master"]))
    norm = float(torch.sqrt(sum(torch.sum(g.double() ** 2) for g in g_all.values())))
    clip = min(1.0, a.clip_norm / max(norm, 1e-9))
    t = int(opt["step"]) + 1
    start, want = {}, {}
    for k, g in g_all.items():
        g = g * clip
        m = a.b1 * m_all[k] + (1 - a.b1) * g
        v = a.b2 * v_all[k] + (1 - a.b2) * g * g
        w = w_all[k]
        start[k] = w.clone()
        want[k] = w - lr * (m / (1 - a.b1 ** t) / (torch.sqrt(v / (1 - a.b2 ** t)) + a.eps)
                            + a.weight_decay * w)
    del grads, g_all, g, m, v
    tree, opt, metrics = step_fn(tree, opt, batch, torch.tensor(step, dtype=torch.int32,
                                                                device=batch["hist"].device))
    got = flat(tree)
    gaps, moved = {}, {}
    for k, w in want.items():
        over = (got[k] - w).abs() - 2.0 ** -23 * w.abs()
        gaps[k] = float(over.max()) / lr
        moved[k] = float((got[k] - start[k]).abs().max()) / lr
    if abs(float(metrics["lr"]) - lr) > 1e-6 * lr:
        fail(f"phase 9b: the step's lr {float(metrics['lr'])} is not the warmup's {lr}")
    return gaps, moved, metrics


def mind_training(dev, flush, card_line) -> tuple[dict, dict]:
    """Phase 9b: MIND trains at full width on the card, the train_batch
    cell's step (``sampled_softmax_loss``, AdamW in place) at its B 65,536
    from mind_batch, random tables from the seed.  (a) On one batch: the
    loss and every gradient leaf through the kernels against the plain
    bag, at the 0.02-scale init and at tables drawn at scale 1
    (mind_route_gaps).  (b) The bag's backward alone at this shape:
    BagSum's gradient bit for bit against spmm_ell_vertex_ref over the
    same bag ELL and within BAG_BWD_TOL of autograd of the plain bag; the
    ELL's build timed; the vertex sum timed (vertex_check, beside
    index_add_).  (c) The bag forward at this shape (bag_check).  (d) A
    cold step and MIND_TRAIN_WARM warm ones (ms, users/s, peak memory,
    losses, launches a step), one more under the profiler.  (e) One more
    step's updated leaves against plain AdamW (mind_update_gaps).  Returns the
    kernels line's rows of the bag forward and the bag backward at this
    shape, their launches those of (d)'s timed steps."""
    import torch

    from repro_torch import kernels as K
    from repro_torch.configs import get_arch
    from repro_torch.configs.cells import RECSYS_SHAPES
    from repro_torch.data import mind_batch
    from repro_torch.models import mind
    from repro_torch.models.common import normal_init
    from repro_torch.models.gnn.ell import build_bag_ell
    from repro_torch.train import TrainConfig, init_train_state

    arch = get_arch("mind")
    cfg, plan = arch.make_config(), arch.make_cell("train_batch")
    B, V, d = RECSYS_SHAPES["train_batch"]["B"], cfg.n_profile, cfg.embed_dim
    free_card()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    tree = mind.init_tree(gen, cfg)

    def batch(step):
        return {k: torch.as_tensor(v, device=dev)
                for k, v in mind_batch(step, B, cfg, seed=SEED).items()}

    batches = [batch(step) for step in range(2 + MIND_TRAIN_WARM)]
    log(f"MIND training: {cfg.name}, {cfg.n_items} items, {V} profile rows, d {d}, "
        f"K {cfg.n_interests}, L {cfg.hist_len}, F*M "
        f"{cfg.n_profile_fields * cfg.profile_multi}, {cfg.n_negatives} negatives, B {B}, "
        f"bag_impl {cfg.bag_impl}")

    # (a) the kernel route against the plain bag, loss and gradients
    scale1 = {**tree, "item_table": normal_init(gen, tuple(tree["item_table"].shape), 1.0),
              "profile_table": normal_init(gen, (V, d), 1.0)}
    for label, params in (("0.02-scale init", tree), ("scale-1 tables", scale1)):
        rel, gaps, zero = mind_route_gaps(params, batches[0], cfg)
        worst = max(gaps, key=gaps.get)
        log(f"MIND train check ({label}), kernel route vs plain bag: loss {rel:.3g} of it "
            f"(tol {MIND_TRAIN_LOSS_RTOL}); worst leaf {worst} {gaps[worst]:.3g} of its max "
            f"|grad| (tol {MIND_TRAIN_GRAD_TOL}); {MIND_ZERO_LEAF} {zero:.3g} of the largest "
            f"|grad| (tol {MIND_ZERO_GRAD_TOL}); "
            f"{', '.join(f'{k} {g:.3g}' for k, g in gaps.items())}")
        if not (rel <= MIND_TRAIN_LOSS_RTOL and gaps[worst] <= MIND_TRAIN_GRAD_TOL
                and zero <= MIND_ZERO_GRAD_TOL):
            fail(f"phase 9b ({label}): the kernel route differs from the plain bag (loss "
                 f"{rel:.3g}, leaf {worst} {gaps[worst]:.3g}, {MIND_ZERO_LEAF} {zero:.3g})")
    del scale1
    free_card()

    # (b) the bag's backward alone at the train shape
    b0 = batches[0]
    idx, mask = b0["profile_ids"], b0["profile_mask"]
    w = mask.to(torch.float32)
    table = tree["profile_table"]
    g = torch.randn((B, d), generator=gen, device=dev)
    builds = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        build_bag_ell(idx, w, V)
        torch.cuda.synchronize()
        builds.append((time.perf_counter() - t0) * 1e3)
    # the layout BagSum's backward builds: the build is deterministic
    ell = build_bag_ell(idx, w, V)
    t = table.detach().requires_grad_(True)
    K.reset_launch_counts()
    (grad,) = torch.autograd.grad(K.BagSum.apply(t, idx, w), t, g)
    torch.cuda.synchronize()
    if tuple(K.launch_counts()[n] for n in ("embedding_bag", "spmm_ell")) != (1, 1):
        fail("phase 9b: BagSum did not launch the bag kernel and the vertex sum once each")
    if not bits_equal(grad, K.spmm_ell_vertex_ref(g, ell.col, ell.wgt, ell.row_ptr, ell.deg)):
        fail("phase 9b: the bag's backward is not bit-identical to spmm_ell_vertex_ref "
             "over the same bag ELL")
    tp = table.detach().requires_grad_(True)
    (want,) = torch.autograd.grad(K.embedding_bag_ref(tp, idx, w), tp, g)
    bwd_gap = rel_err(grad, want)
    if bwd_gap > BAG_BWD_TOL:
        fail(f"phase 9b: the bag's backward differs from autograd of the plain bag by "
             f"{bwd_gap:.3g} of max |grad| (tol {BAG_BWD_TOL})")
    log(f"MIND bag backward (B {B}, L {idx.shape[1]}, V {V}, d {d}): bag ELL R "
        f"{ell.col.shape[0]}, W {ell.col.shape[1]}, {int(ell.deg.sum())} live slots, longest "
        f"segment {int(ell.deg.max())}, built in {sorted(builds)[2]:.3f} ms (median of 5, "
        f"host and card); BagSum's gradient bit-identical to spmm_ell_vertex_ref over it, "
        f"{bwd_gap:.3g} of max |grad| from autograd of the plain bag (tol {BAG_BWD_TOL})")
    src = (g[:, None, :] * w[..., None]).reshape(-1, d)
    flat = idx.reshape(-1).long()
    library = (f"index_add_ of the ({B * idx.shape[1]}, {d}) weighted rows",
               lambda: torch.zeros((V, d), device=dev).index_add_(0, flat, src))
    bwd_row = vertex_check("the bag's backward, MIND train_batch", g, ell,
                           ell_graph(ell, n_cols=B), flush, library)
    bwd_row.update(name="embedding_bag_bwd")
    del t, tp, grad, want, src, flat, g

    # (c) the bag forward at the train shape: the batch's ids and mask
    fwd_row = bag_check("MIND train_batch", table.detach(), idx, w, flush)
    fwd_row.update(name="embedding_bag train")
    free_card()

    # (d) the steps
    opt = init_train_state(tree, TrainConfig())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, losses, per_step = [], [], []
    for step in range(1 + MIND_TRAIN_WARM):
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree, opt, m = plan.fn(tree, opt, batches[step],
                               torch.tensor(step, dtype=torch.int32, device=dev))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts = K.launch_counts()
        per_step.append((counts["embedding_bag"], counts["spmm_ell"]))
        losses.append(float(m["loss"]))
        log(f"MIND train step {step} ({'cold' if step == 0 else 'warm'}): "
            f"{walls[-1] * 1e3:.1f} ms, loss {losses[-1]:.6f}, grad norm "
            f"{float(m['grad_norm']):.4g}; embedding_bag launches {per_step[-1][0]}, "
            f"vertex-sum (spmm_ell) launches {per_step[-1][1]}")
    peak = torch.cuda.max_memory_allocated()
    with device_profile("one warm MIND train step", top=10, kernel="vertex_sum_kernel"):
        tree, opt, m = plan.fn(tree, opt, batches[-1],
                               torch.tensor(1 + MIND_TRAIN_WARM, dtype=torch.int32,
                                            device=dev))
        torch.cuda.synchronize()
    losses.append(float(m["loss"]))
    # (e) one more step's update against plain AdamW
    gaps, moved, m = mind_update_gaps(plan.fn, cfg, tree, opt, batches[0], 2 + MIND_TRAIN_WARM)
    held = [k for k in gaps if k != MIND_ZERO_LEAF]
    worst, least = max(held, key=gaps.get), min(held, key=moved.get)
    log(f"MIND train step {2 + MIND_TRAIN_WARM}, update against plain AdamW from a recomputed "
        f"gradient: worst leaf {worst} {gaps[worst]:.3g} of lr past the rounding (tol "
        f"{MIND_STEP_TOL}); least moved {least} {moved[least]:.3g} of lr (at least "
        f"{MIND_STEP_MOVE}); {MIND_ZERO_LEAF} {gaps[MIND_ZERO_LEAF]:.3g} of lr off (not "
        f"held); lr {float(m['lr']):.6g}, loss {float(m['loss']):.6f}; "
        f"{', '.join(f'{k} {moved[k]:.3g}' for k in moved)} of lr moved")
    if gaps[worst] > MIND_STEP_TOL or moved[least] < MIND_STEP_MOVE:
        fail(f"phase 9b: the step's update differs from plain AdamW (leaf {worst} "
             f"{gaps[worst]:.3g} of lr) or leaves {least} unmoved ({moved[least]:.3g} of lr)")
    warm = walls[1:]
    med = sorted(warm)[len(warm) // 2]
    log(f"MIND training, train_batch at B {B}: cold step {walls[0] * 1e3:.1f} ms, warm "
        f"steps {', '.join(f'{x * 1e3:.1f}' for x in warm)} ms (median {med * 1e3:.1f} ms, "
        f"{B / med:.0f} users/s); peak {peak / 2**30:.2f} GiB; losses "
        f"{[round(x, 6) for x in losses]}; (embedding_bag, vertex sum) launches a step "
        f"{per_step}; on {card_line}")
    if not all(x == x and abs(x) != float("inf") for x in losses):
        fail(f"phase 9b: a loss is not finite: {losses}")
    if any(a == 0 or b == 0 for a, b in per_step):
        fail(f"phase 9b: a step launched no embedding_bag or no vertex sum: {per_step}")
    fwd_row["launches"] = sum(a for a, _ in per_step)
    bwd_row["launches"] = sum(b for _, b in per_step)
    del tree, opt, m, batches
    free_card()
    return fwd_row, bwd_row


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


def ell_graph(ell, n_cols: int | None = None) -> tuple:
    """What vertex_check needs of a neighbour ELL beside it: (live
    slots m, those of nonzero weight, the rows of x these read, the
    (n, n_cols) CSR of its live slots; n_cols, the rows of x, defaults
    to n)."""
    import torch

    from repro_torch.kernels.spmm_ell.ref import live_slots

    W = ell.col.shape[1]
    live = torch.arange(W, device=ell.col.device) < live_slots(ell.row_ptr, ell.deg, W)[:, None]
    live_col, live_wgt = ell.col[live], ell.wgt[live]
    csr = torch.sparse_csr_tensor(
        torch.cat([ell.row_ptr.new_zeros(1), torch.cumsum(ell.deg.long(), 0)]),
        live_col.long(), live_wgt, size=(ell.n, n_cols or ell.n), check_invariants=False)
    nz_col = live_col[live_wgt != 0]
    return int(live_col.numel()), int(nz_col.numel()), int(torch.unique(nz_col).numel()), csr


def vertex_chunks(n: int) -> list:
    return [(v0, min(n, v0 + SPMM_CHUNK_VERTICES)) for v0 in range(0, n, SPMM_CHUNK_VERTICES)]


def plain_vertex_chunk(x, ell, starts, v0, v1):
    """The plain in-order vertex sum of x over vertices [v0, v1) of the
    ELL (``starts``: its row_ptr on the host)."""
    from repro_torch import kernels as K

    r0, r1 = starts[v0], starts[v1]
    return K.spmm_ell_vertex_ref(x, ell.col[r0:r1], ell.wgt[r0:r1],
                                 ell.row_ptr[v0:v1 + 1] - r0, ell.deg[v0:v1])


def vertex_check(label, x, ell, graph, flush, library=None) -> dict:
    """Phase 10, step 3b: the vertex sum (spmm_ell_vertex_cuda, GIN's
    neighbour sum) bit for bit against its plain in-order version over
    all n vertices (in chunks of SPMM_CHUNK_VERTICES), timed through the
    wrapper, as a bare launch and alone under the profiler, beside
    torch.sparse.mm on the (n, n_x) CSR of the same edges, or beside
    ``library`` (a (name, call) pair: one PyTorch call computing the same
    sums).  ``graph``: ell_graph's (m, nnz, rows of x, the CSR).
    Returns its row of the kernels line."""
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
    n, d, (R, W) = ell.n, x.shape[1], col.shape
    m, nnz, rows_read, csr = graph
    lib_name, lib_call = library or (f"torch.sparse.mm (CSR, {n} x {x.shape[0]})",
                                      lambda: torch.sparse.mm(csr, x))
    K.reset_launch_counts()
    out = K.spmm_ell_vertex_cuda(x, col, wgt, row_ptr, deg)
    torch.cuda.synchronize()
    if K.launch_counts()["spmm_ell"] != 1:
        fail(f"spmm_ell vertex sum ({label}): the wrapper did not launch its kernel")
    starts = row_ptr.tolist()
    chunks = vertex_chunks(n)

    def plain_chunk(v0, v1):
        return plain_vertex_chunk(x, ell, starts, v0, v1)

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
    lib_err = float((lib_call() - out).abs().max())
    library_ms = time_ms(lib_call, flush)
    # live wgt, the col of the nonzero ones and the rows of x these name,
    # once each, row_ptr, deg, out
    nbytes, ops = spmm_ell_vertex_traffic(m, rows_read, n, d, nnz)
    bound_ms, bound_by = bound(nbytes, ops)
    gather_ms = 4 * m * d / MEM_BYTES_PER_S * 1e3
    log(f"spmm_ell vertex sum ({label}: x {tuple(x.shape)}, ELL R={R} W={W}, {m} live "
        f"slots, {nnz} of nonzero weight, {plan.fat_vertex.shape[0]} vertices of more than {plan.split_rows} "
        f"rows in {plan.fat_row.shape[0]} scratch rows): bit-identical to the plain "
        f"in-order version ({len(chunks)} chunks) and launch to launch; kernel "
        f"{ms:.4f} ms (bare launch {bare_ms:.4f} ms, alone under the profiler "
        f"{alone_ms:.4f} ms), plain {plain_ms:.4f} ms, {lib_name} "
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
    graph = ell_graph(ell)
    row = vertex_check(f"layer 1, d={cfg.d_in}", b["x"], ell, graph, flush)
    vertex_check(f"layers 2-5, d={cfg.d_hidden}", h[:g.n].contiguous(), ell, graph, flush)
    del x_pad, h, graph
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
    return row, g, b


def finite_tree(tree) -> bool:
    import torch
    from torch.utils._pytree import tree_leaves

    return all(bool(torch.isfinite(t).all()) for t in tree_leaves(tree))


def leaf_gaps(a, b) -> list:
    """(max |a - b| / max |b|, leaf path) of every leaf of two trees."""
    from torch.utils._pytree import keystr, tree_flatten_with_path

    fa, fb = tree_flatten_with_path(a)[0], tree_flatten_with_path(b)[0]
    return [(float((x - y).abs().max() / y.abs().max().clamp(min=1e-30)), keystr(path))
            for (path, x), (_, y) in zip(fa, fb)]


@contextlib.contextmanager
def launches_by_ell(transpose_col):
    """Count the vertex-sum launches over the transpose ELL (whose col
    tensor is ``transpose_col``) and over any other ELL, by the wrapper
    the op calls; yields the dict of counts."""
    from repro_torch.kernels.spmm_ell import ops

    counts = {"forward": 0, "transpose": 0}
    real = ops.spmm_ell_vertex_cuda

    def counted(x, col, wgt, row_ptr, deg):
        counts["transpose" if col is transpose_col else "forward"] += 1
        return real(x, col, wgt, row_ptr, deg)

    ops.spmm_ell_vertex_cuda = counted
    try:
        yield counts
    finally:
        ops.spmm_ell_vertex_cuda = real


def train_steps(step, params, opt, batch, first, last, n_layers, label) -> tuple:
    """Steps ``first`` .. ``last - 1`` of a train step on the kernel
    route, each with exactly 2 n_layers - 1 spmm_ell launches (every
    layer forward, all but the first backward) and a finite loss, grad
    norm and params.  Returns (params, opt, losses, walls in s)."""
    import torch

    from repro_torch import kernels as K

    walls, losses = [], []
    for i in range(first, last):
        K.reset_launch_counts()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch, i)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches = K.launch_counts()["spmm_ell"]
        if launches != 2 * n_layers - 1:
            fail(f"{label}: step {i} launched spmm_ell {launches} times, not "
                 f"{2 * n_layers - 1} ({n_layers} forward, {n_layers - 1} backward)")
        if not (finite_tree(m) and finite_tree(params)):
            fail(f"{label}: step {i} gave a non-finite loss, grad norm or param "
                 f"({ {k: float(v) for k, v in m.items()} })")
        losses.append(float(m["loss"]))
    return params, opt, losses, walls


def cell_train(name, dev, batch, plain_loss, card_line) -> None:
    """Phase 10b(e): CELL_STEPS steps of gin-tu's ``name`` cell through
    its plan's step (the kernel route); the first step's loss against
    ``plain_loss(params, cfg)``, the same loss by a plain route."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models.gnn import gin
    from repro_torch.train import TrainConfig, init_train_state

    mod = get_arch("gin-tu")
    plan, cfg = mod.make_cell(name), mod.make_config(False, name)
    params = gin.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg)
    with torch.no_grad():
        ref = float(plain_loss(params, cfg))
    torch.cuda.reset_peak_memory_stats()
    _, _, losses, walls = train_steps(plan.fn, params, init_train_state(params, TrainConfig()),
                                      batch, 0, CELL_STEPS, cfg.n_layers,
                                      f"{name} train step")
    gap = abs(losses[0] - ref) / abs(ref)
    shapes = {k: tuple(v.shape) for k, v in batch.items()}
    log(f"gin-tu {name} {shapes}: {CELL_STEPS} train steps through the cell's plan, "
        f"{2 * cfg.n_layers - 1} spmm_ell launches each, cold {walls[0] * 1e3:.2f} ms, "
        f"then {', '.join(f'{w * 1e3:.2f}' for w in walls[1:])} ms; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; losses "
        f"{', '.join(f'{v:.6g}' for v in losses)}, the first against the plain route's "
        f"{ref:.6g}: {gap:.3g} of it (tol {CELL_LOSS_TOL}); {card_line}")
    if not gap <= CELL_LOSS_TOL:
        fail(f"{name}: the kernel route's loss differs from the plain route's by "
             f"{gap:.3g} of it (tolerance {CELL_LOSS_TOL})")


def gin_training(dev, g, b, card_line) -> tuple:
    """Phase 10b: GIN training on phase 10's graph and batch (gin-tu at
    ogb_products widths on rmat1 scale 21), then gin-tu's other three
    cells.  Returns the kernels-line row of the vertex sum over the
    transpose ELL, the backward's, and the minibatch_lg block (phase
    10c trains the rest of the zoo on it)."""
    import gc

    import numpy as np
    import torch
    from torch.utils._pytree import tree_leaves

    from repro_torch import kernels as K
    from repro_torch.configs import get_arch
    from repro_torch.configs.cells import GNN_SHAPES
    from repro_torch.data import gnn_flat_batch, molecule_batch
    from repro_torch.graph import FanoutSampler, erdos_renyi_graph
    from repro_torch.kernels.spmm_ell import ops as spmm_ops
    from repro_torch.models.gnn import gin, neighbor_ell, transpose_ell
    from repro_torch.train import Checkpointer, TrainConfig, build_train_step, init_train_state
    from repro_torch.train.train_step import value_and_grad

    mod = get_arch("gin-tu")
    cfg = mod.make_config(False, GIN_CELL)
    seg = dataclasses.replace(cfg, agg_impl="segment_sum")
    L = cfg.n_layers
    edges = (b["edge_src"], b["edge_dst"], b["edge_mask"])
    fwd = neighbor_ell(*edges, g.n)  # phase 10's, from the memo

    # ---- (a) the transpose ELL's vertex sum against its plain version --
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tell = transpose_ell(*edges, g.n)
    torch.cuda.synchronize()
    log(f"transpose ELL (the reversed edges' neighbour ELL) built on the card in "
        f"{time.perf_counter() - t0:.3f} s: R={tell.col.shape[0]} W={tell.col.shape[1]}, "
        f"{(tell.col.nbytes + tell.wgt.nbytes) / 1e9:.3f} GB beside the forward ELL's "
        f"{(fwd.col.nbytes + fwd.wgt.nbytes) / 1e9:.3f} GB")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    upstream = torch.randn((g.n, cfg.d_hidden), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    row = vertex_check(f"backward over the transpose ELL, d={cfg.d_hidden}", upstream, tell,
                       ell_graph(tell), flush)
    row["ell"] = "transpose (the GIN backward)"
    del flush, upstream
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (b) one loss and backward through both routes ---------------
    params = gin.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg)
    seen = []  # (incoming gradient, its sum over the transpose ELL)
    real = spmm_ops.vertex_sum

    def recording(x, col, wgt, row_ptr, deg):
        out = real(x, col, wgt, row_ptr, deg)
        if col is tell.col:
            seen.append((x, out))
        return out

    spmm_ops.vertex_sum = recording
    try:
        K.reset_launch_counts()
        t0 = time.perf_counter()
        loss_k, grads_k = value_and_grad(
            lambda p, bb: gin.node_classification_loss(p, bb, cfg))(params, b)
        torch.cuda.synchronize()
        kernel_s = time.perf_counter() - t0
    finally:
        spmm_ops.vertex_sum = real
    launches = K.launch_counts()["spmm_ell"]
    if launches != 2 * L - 1 or len(seen) != L - 1:
        fail(f"loss and backward: {launches} spmm_ell launches, {len(seen)} over the "
             f"transpose ELL (want {2 * L - 1} and {L - 1})")
    starts = tell.row_ptr.tolist()
    for i, (up, out) in enumerate(seen):
        for v0, v1 in vertex_chunks(g.n):
            if not bits_equal(out[v0:v1], plain_vertex_chunk(up, tell, starts, v0, v1)):
                fail(f"backward vertex sum {i + 1} of {L - 1}: the kernel's gradient is not "
                     f"bit-identical to the plain Function's on vertices [{v0}, {v1})")
    del seen
    K.reset_launch_counts()
    t0 = time.perf_counter()
    loss_s, grads_s = value_and_grad(
        lambda p, bb: gin.node_classification_loss(p, bb, seg))(params, b)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    if K.launch_counts()["spmm_ell"]:
        fail("the segment-sum route launched spmm_ell")
    if not (finite_tree(grads_k) and finite_tree(grads_s)
            and np.isfinite([float(loss_k), float(loss_s)]).all()):
        fail("loss and backward: a loss or a gradient is not finite")
    gaps = sorted(leaf_gaps(grads_k, grads_s), reverse=True)
    log(f"GIN loss and backward at full width over {g.n} nodes: kernel route "
        f"{kernel_s * 1e3:.2f} ms cold ({launches} spmm_ell launches: {L} forward, {L - 1} "
        f"backward over the transpose ELL, each bit-identical to the plain Function's), "
        f"segment-sum route {plain_s * 1e3:.2f} ms; loss {float(loss_k):.6g} against "
        f"{float(loss_s):.6g}; gradients leaf by leaf at most {gaps[0][0]:.3g} of the "
        f"leaf's max |grad| ({gaps[0][1]}; tol {GIN_GRAD_TOL}), next "
        f"{', '.join(f'{v:.3g} {k}' for v, k in gaps[1:4])}")
    if not gaps[0][0] <= GIN_GRAD_TOL:
        fail(f"gradients: the kernel route differs from the segment-sum route by "
             f"{gaps[0][0]:.3g} of {gaps[0][1]}'s max |grad| (tolerance {GIN_GRAD_TOL})")
    del grads_k, grads_s
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (c) train steps through the cell's plan -----------------------
    step = mod.make_cell(GIN_CELL).fn  # AdamW, warmup-cosine, clip 1.0
    tc = TrainConfig()
    opt = init_train_state(params, tc)
    torch.cuda.reset_peak_memory_stats()
    with launches_by_ell(tell.col) as by_ell:
        p, o, losses, walls = train_steps(step, params, opt, b, 0, 1 + GIN_TRAIN_WARM, L,
                                          "GIN train step")
        peak = torch.cuda.max_memory_allocated() / 2**30
        with device_profile("one warm GIN train step, kernel route", top=10) as ops_seen:
            p, o, more, _ = train_steps(step, p, o, b, 1 + GIN_TRAIN_WARM,
                                        2 + GIN_TRAIN_WARM, L, "GIN train step")
    steps = 2 + GIN_TRAIN_WARM
    if by_ell != {"forward": L * steps, "transpose": (L - 1) * steps}:
        fail(f"train steps: vertex-sum launches by ELL {by_ell}, want {L * steps} forward "
             f"and {(L - 1) * steps} over the transpose ELL")
    scatters = sorted({k for k in ops_seen
                       if any(w in k for w in ("index_add", "scatter", "index_put"))})
    if scatters:
        fail(f"the kernel route's train step ran {scatters}: no sum may combine rows "
             f"outside the kernel")
    warm = min(walls[1:])
    seg_step = build_train_step(lambda pp, bb: gin.node_classification_loss(pp, bb, seg), tc)
    seg_walls = []
    sp, so = params, init_train_state(params, tc)
    torch.cuda.reset_peak_memory_stats()
    for i in range(2):
        t0 = time.perf_counter()
        sp, so, sm = seg_step(sp, so, b, i)
        torch.cuda.synchronize()
        seg_walls.append(time.perf_counter() - t0)
    seg_peak = torch.cuda.max_memory_allocated() / 2**30
    del sp, so
    log(f"GIN train steps ({cfg.name} {GIN_CELL} plan: AdamW, warmup-cosine, clip "
        f"{tc.adamw.clip_norm}) over {g.n} nodes: cold {walls[0] * 1e3:.2f} ms (builds the "
        f"transpose plan), warm {', '.join(f'{w * 1e3:.2f}' for w in walls[1:])} ms "
        f"({g.n / warm:.4g} nodes/s); peak memory {peak:.2f} GiB; spmm_ell launches "
        f"{2 * L - 1} a step ({by_ell['forward']} forward and {by_ell['transpose']} over "
        f"the transpose ELL in {steps} steps); losses "
        f"{', '.join(f'{v:.6g}' for v in losses + more)}; no index_add, scatter or "
        f"index_put; segment-sum route's step cold {seg_walls[0] * 1e3:.2f} ms, warm "
        f"{seg_walls[1] * 1e3:.2f} ms ({seg_walls[1] / warm:.2f}x), peak memory "
        f"{seg_peak:.2f} GiB; {card_line}")
    row["launches"] = by_ell["transpose"]
    del p, o

    # ---- (d) resume from a checkpoint, bit for bit ---------------------
    half = GIN_RESUME_STEPS // 2
    straight = train_steps(step, params, init_train_state(params, tc), b, 0,
                           GIN_RESUME_STEPS, L, "resume check")[:2]
    first = train_steps(step, params, init_train_state(params, tc), b, 0, half, L,
                        "resume check")[:2]
    with tempfile.TemporaryDirectory() as tmp:
        ck = Checkpointer(tmp)
        t0 = time.perf_counter()
        ck.save(half, {"params": first[0], "opt": first[1]})
        tree, manifest = ck.restore(device=dev)
        ck_s = time.perf_counter() - t0
    resumed = train_steps(step, tree["params"], tree["opt"], b, manifest["step"],
                          GIN_RESUME_STEPS, L, "resume check")[:2]
    pairs = list(zip(tree_leaves(resumed), tree_leaves(straight)))
    differ = sum(not (x.dtype == y.dtype and torch.equal(x, y)) for x, y in pairs)
    if differ:
        fail(f"resume: {differ} of {len(pairs)} leaves of the params and optimizer state "
             f"after {half} steps, a checkpoint and {half} more differ from "
             f"{GIN_RESUME_STEPS} steps straight")
    log(f"resume: {GIN_RESUME_STEPS} steps straight and {half} steps, save + restore "
        f"({ck_s:.3f} s), {half} more: params and optimizer state bit-identical "
        f"({len(pairs)} leaves)")
    del straight, first, resumed, tree, params
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (e) gin-tu's other three cells -------------------------------
    cora = erdos_renyi_graph(CORA_N, CORA_AVG_DEGREE, seed=SEED)
    cfg_sm = mod.make_config(False, "full_graph_sm")
    cb = {k: torch.as_tensor(v, device=dev)
          for k, v in gnn_flat_batch(cora, cfg_sm.d_in, cfg_sm.n_classes, seed=SEED).items()}
    cell_train("full_graph_sm", dev, cb, lambda pp, c: gin.node_classification_loss(
        pp, cb, dataclasses.replace(c, agg_impl="segment_sum")), card_line)
    sh = GNN_SHAPES["molecule"]
    mb = {k: torch.as_tensor(v, device=dev)
          for k, v in molecule_batch(0, sh["batch"], sh["n"], sh["e"], seed=SEED).items()}

    def per_graph(pp, c):  # the reference's map over the graphs, one plain forward each
        c = dataclasses.replace(c, agg_impl="segment_sum")
        pred = torch.stack([gin.forward(pp, mb["x"][i], mb["edge_src"][i], mb["edge_dst"][i],
                                        mb["edge_mask"][i], c).mean()
                            for i in range(sh["batch"])])
        return torch.mean((pred - mb["y"]) ** 2)

    cell_train("molecule", dev, mb, per_graph, card_line)
    sh = GNN_SHAPES["minibatch_lg"]
    cfg_mb = mod.make_config(False, "minibatch_lg")
    t0 = time.perf_counter()
    sampler = FanoutSampler(g, sh["fanouts"], seed=SEED)
    pool = np.flatnonzero(np.diff(sampler.csr.row_ptr))  # vertices with out-edges
    seeds = np.random.default_rng(SEED).choice(pool, sh["seeds"], replace=False)
    blk = sampler.sample(seeds)
    t1 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n_pad = blk.nodes.shape[0]
    xb = {"x": torch.randn((n_pad, cfg_mb.d_in), generator=gen, device=dev),
          "labels": torch.randint(0, cfg_mb.n_classes, (n_pad,), generator=gen, device=dev,
                                  dtype=torch.int32)}
    xb |= {k: torch.as_tensor(getattr(blk, k), device=dev)
           for k in ("edge_src", "edge_dst", "edge_mask")}
    log(f"minibatch_lg block from phase 10's graph: {sh['seeds']} seeds among {pool.size} "
        f"vertices with out-edges, fanouts {sh['fanouts']}: {blk.n_nodes} nodes and "
        f"{blk.n_edges} edges of {n_pad} and {blk.edge_src.shape[0]} padded, sampled in "
        f"{t1 - t0:.1f} s; features drawn on the card for the block only")
    cell_train("minibatch_lg", dev, xb, lambda pp, c: gin.node_classification_loss(
        pp, xb, dataclasses.replace(c, agg_impl="segment_sum")), card_line)
    return row, blk


def zoo_batches(dev, blk) -> dict:
    """Phase 10c's batch of each cell on the card, with coordinates and
    DimeNet's triplets (the other models read neither list): the
    molecule batch (128 graphs of 30 atoms, 64 edge slots, 512 triplet
    slots), phase 10b's Cora-sized ER graph (d 1433) and the
    minibatch_lg block of phase 10b with features, labels and
    coordinates drawn on the card, its triplets capped at 2 an edge and
    padded with (0, 0, masked) to the plan's T."""
    import numpy as np
    import torch

    from repro_torch.configs.cells import GNN_SHAPES
    from repro_torch.configs.dimenet_cfg import TRIPLET_CAP, make_cell
    from repro_torch.data import gnn_flat_batch, molecule_batch
    from repro_torch.graph import erdos_renyi_graph
    from repro_torch.models.gnn import build_triplets

    def on_card(batch):
        return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}

    sh = GNN_SHAPES["molecule"]
    out = {"molecule": on_card(molecule_batch(0, sh["batch"], sh["n"], sh["e"], triplets=True,
                                              triplet_pad=sh["triplet_pad"], seed=SEED))}
    sh = GNN_SHAPES["full_graph_sm"]
    cora = erdos_renyi_graph(CORA_N, CORA_AVG_DEGREE, seed=SEED)
    out["full_graph_sm"] = on_card(gnn_flat_batch(cora, sh["d_feat"], sh["classes"],
                                                  coords=True, triplets=True,
                                                  triplet_cap=TRIPLET_CAP, seed=SEED))
    sh = GNN_SHAPES["minibatch_lg"]
    n_pad, e_pad = blk.nodes.shape[0], blk.edge_src.shape[0]
    t0 = time.perf_counter()
    kj, ji = build_triplets(blk.edge_src, blk.edge_dst, n_pad, TRIPLET_CAP, seed=SEED)
    t_tri = time.perf_counter() - t0
    T = make_cell("minibatch_lg").args[2]["tri_kj"].shape[0]
    if kj.shape[0] > T:
        fail(f"minibatch_lg: {kj.shape[0]} triplets do not fit the plan's {T}")
    tri = {"tri_kj": np.zeros(T, np.int32), "tri_ji": np.zeros(T, np.int32),
           "tri_mask": np.zeros(T, bool)}
    tri["tri_kj"][:kj.shape[0]], tri["tri_ji"][:kj.shape[0]] = kj, ji
    tri["tri_mask"][:kj.shape[0]] = True
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    mb = {"x": torch.randn((n_pad, sh["d_feat"]), generator=gen, device=dev),
          "coords": torch.randn((n_pad, 3), generator=gen, device=dev),
          "labels": torch.randint(0, sh["classes"], (n_pad,), generator=gen, device=dev,
                                  dtype=torch.int32)}
    mb |= {k: torch.as_tensor(getattr(blk, k), device=dev)
           for k in ("edge_src", "edge_dst", "edge_mask")}
    out["minibatch_lg"] = mb | on_card(tri)
    log(f"phase 10c batches: molecule {tuple(out['molecule']['x'].shape)}, "
        f"{int(out['molecule']['tri_mask'].sum())} live triplets of "
        f"{out['molecule']['tri_mask'].numel()}; full_graph_sm {cora.n} nodes, {cora.m} "
        f"edges, {int(out['full_graph_sm']['tri_kj'].shape[0])} triplets; minibatch_lg "
        f"{n_pad} / {e_pad} padded, {kj.shape[0]} triplets (cap {TRIPLET_CAP}) of T={T}, "
        f"built on the host in {t_tri:.2f} s")
    return out


@contextlib.contextmanager
def deterministic_algorithms():
    """``torch.use_deterministic_algorithms(True, warn_only=True)`` over
    the block, then the setting as it was."""
    import torch

    was, warn = (torch.are_deterministic_algorithms_enabled(),
                 torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)


@contextlib.contextmanager
def zoo_work():
    """Count, over the block, the segment ELLs built and the vertex plans
    the wrapper takes (each object, in order), through the functions the
    kernel route calls; yields the dict of them."""
    from repro_torch.kernels.spmm_ell import kernel
    from repro_torch.models.gnn import ell

    work = {"builds": 0, "plans": []}
    real = {(m, f): getattr(m, f) for m, f in (
        (ell, "build_segment_ell"), (ell, "build_segment_transpose"), (kernel, "vertex_plan"))}

    def built(f):
        def build(*args):
            work["builds"] += 1
            return f(*args)
        return build

    def planned(*args):
        plan = real[(kernel, "vertex_plan")](*args)
        work["plans"].append(plan)
        return plan

    ell.build_segment_ell = built(ell.build_segment_ell)
    ell.build_segment_transpose = built(ell.build_segment_transpose)
    kernel.vertex_plan = planned
    try:
        yield work
    finally:
        for (m, f), fn in real.items():
            setattr(m, f, fn)


def zoo_cell(name, cell, dev, batch, card_line, grads: bool) -> dict:
    """Phase 10c(a): CELL_STEPS train steps of ``name``'s ``cell`` through
    its plan's step (the kernel route), each with ZOO_LAUNCHES spmm_ell
    launches and finite, each after the first building no segment ELL and
    taking no new vertex plan (on minibatch_lg one more under the
    profiler); the first loss against the segment-sum route's from the
    same params, within CELL_LOSS_TOL; with ``grads``, one loss and
    backward on both routes, leaf by leaf within GIN_GRAD_TOL, or, for
    bf16 messages, the kernel route's twice, bit for bit, then within
    ZOO_BF16_GRAD_TOL of the segment-sum route's under deterministic
    algorithms; on minibatch_lg, the profiled step of a model of
    ZOO_NO_INDEX_ADD runs no index_add_.  Returns the vertex-sum launches
    of the steps by the shape the wrapper counts them at (rows of x, n,
    W, d)."""
    import torch
    from torch.utils._pytree import tree_leaves

    from repro_torch import kernels as K
    from repro_torch.configs import get_arch
    from repro_torch.models import gnn
    from repro_torch.train import TrainConfig, init_train_state
    from repro_torch.train.train_step import value_and_grad

    arch, model = get_arch(name), getattr(gnn, name)
    plan, cfg = arch.make_cell(cell), arch.make_config(False, cell)
    seg = dataclasses.replace(cfg, agg_impl="segment_sum")
    loss = model.regression_loss if cell == "molecule" else model.node_classification_loss
    L = getattr(cfg, "n_blocks", None) or cfg.n_layers
    bf16 = getattr(cfg, "msg_dtype", "float32") != "float32"
    params = model.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg)
    with torch.no_grad():
        ref = float(loss(params, batch, seg))
    grad_note = ""
    if grads:
        _, gk = value_and_grad(lambda p, b: loss(p, b, cfg))(params, batch)
        if bf16:
            _, again = value_and_grad(lambda p, b: loss(p, b, cfg))(params, batch)
            if not all(bits_equal(a.float(), b.float())
                       for a, b in zip(tree_leaves(gk), tree_leaves(again))):
                fail(f"{name} {cell}: two backward passes of the kernel route from the same "
                     "params gave other gradients")
            del again
            grad_note = "; the kernel route's gradients bit for bit over two backward passes"
        with deterministic_algorithms() if bf16 else contextlib.nullcontext():
            _, gs = value_and_grad(lambda p, b: loss(p, b, seg))(params, batch)
        gaps = sorted(leaf_gaps(gk, gs), reverse=True)
        grad_tol = ZOO_BF16_GRAD_TOL if bf16 else GIN_GRAD_TOL
        if not (finite_tree(gk) and gaps[0][0] <= grad_tol):
            fail(f"{name} {cell}: gradients of the kernel route differ from the segment-sum "
                 f"route's by {gaps[0][0]:.3g} of {gaps[0][1]}'s max |grad| (tolerance "
                 f"{grad_tol}), or are not finite")
        grad_note += (f"; gradients against the segment-sum route's"
                      f"{' (deterministic algorithms)' if bf16 else ''} at most "
                      f"{gaps[0][0]:.3g} of a leaf's max |grad| ({gaps[0][1]}; tol {grad_tol}; "
                      f"next {', '.join(f'{v:.3g} {k}' for v, k in gaps[1:3])})")
        del gk, gs
    opt = init_train_state(params, TrainConfig())
    want = ZOO_LAUNCHES[name](L)
    walls, losses, by_shape = [], [], {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # on minibatch_lg one more step under the profiler, its wall not kept
    profiled = CELL_STEPS if cell == "minibatch_lg" else None
    with zoo_work() as work:
        for i in range(CELL_STEPS + (profiled is not None)):
            K.reset_launch_counts()
            builds, plans = work["builds"], len(work["plans"])
            with (device_profile(f"{name} {cell}, one warm train step", top=8,
                                 kernel="vertex_") if i == profiled
                  else contextlib.nullcontext()) as seen:
                t0 = time.perf_counter()
                params, opt, m = plan.fn(params, opt, batch, i)
                torch.cuda.synchronize()
            if i != profiled:
                walls.append(time.perf_counter() - t0)
            elif name in ZOO_NO_INDEX_ADD:
                atomics = sorted({k for k in seen if "index_add" in k or "indexFunc" in k})
                if atomics:
                    fail(f"{name} {cell}: the profiled step ran {atomics}; every gather's "
                         "backward should be the vertex sum")
            launches = K.launch_counts()["spmm_ell"]
            if launches != want:
                fail(f"{name} {cell}: step {i} launched spmm_ell {launches} times, not {want}")
            for shape, count in K.launch_shapes()["spmm_ell"].items():
                by_shape[shape] = by_shape.get(shape, 0) + count
            new_plans = [q for q in work["plans"][plans:]
                         if not any(q is o for o in work["plans"][:plans])]
            if i and (work["builds"] != builds or new_plans):
                fail(f"{name} {cell}: step {i} built {work['builds'] - builds} segment ELLs "
                     f"and made {len(new_plans)} vertex plans; after the first, a step "
                     "builds and plans nothing")
            if not (finite_tree(m) and finite_tree(params)):
                fail(f"{name} {cell}: step {i} gave a non-finite loss, grad norm or param")
            losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated() / 2**30
    gap = abs(losses[0] - ref) / abs(ref)
    nodes = batch["x"].shape[0] * (batch["x"].shape[1] if cell == "molecule" else 1)
    log(f"{name} {cell} (full width: {L} {'blocks' if name == 'dimenet' else 'layers'}, "
        f"d {cfg.d_hidden}{', bf16 messages' if bf16 else ''}; {nodes} nodes): "
        f"{len(losses)} steps through the plan, {want} spmm_ell launches each, no ELL built "
        f"and no plan made after the first, cold "
        f"{walls[0] * 1e3:.2f} ms, warm {', '.join(f'{w * 1e3:.2f}' for w in walls[1:])} ms "
        f"({nodes / min(walls[1:] or walls):.4g} nodes/s); peak memory {peak:.3f} GiB; losses "
        f"{', '.join(f'{v:.6g}' for v in losses)}, the first against the segment-sum "
        f"route's {ref:.6g}: {gap:.3g} of it (tol {CELL_LOSS_TOL}){grad_note}; {card_line}")
    if not gap <= CELL_LOSS_TOL:
        fail(f"{name} {cell}: the kernel route's loss differs from the segment-sum route's by "
             f"{gap:.3g} of it (tolerance {CELL_LOSS_TOL})")
    return by_shape


def gnn_zoo(dev, blk, card_line) -> list[dict]:
    """Phase 10c: (a) every cell of ZOO_CELLS for egnn, mace and dimenet
    at full width (zoo_cell; gradients on the molecule cells and
    ZOO_FLAT_GRADS); (b) each vertex-sum shape of the minibatch_lg steps
    bit for bit against its plain version and timed (vertex_check): the
    segment sums, each with its W = 1 transpose (the sum's backward,
    beside ``F.embedding_bag`` with per-sample weights, one call for
    ``g[index] * mask``), and the gathers' backward over the other ELLs,
    the sums and the gathers beside ``index_add_`` of every row by the
    index, masked or not (what the segment-sum route runs: its sums, and
    ``index_select``'s backward); each with the launches the steps made
    at its shape as the wrapper counts them (rows of x, n, W, d), every
    launch of the steps at some row.  The ogb_products cells plan in
    phase 16a and wait for sharding across cards.  Returns the new rows
    of the kernels line."""
    import gc

    import torch
    import torch.nn.functional as F

    from repro_torch import kernels as K
    from repro_torch.configs import get_arch
    from repro_torch.models.gnn import segment_ell, segment_transpose

    batches = zoo_batches(dev, blk)
    mb_counts = {}
    for name in ZOO_MODELS:
        for cell in ZOO_CELLS:
            counts = zoo_cell(name, cell, dev, batches[cell], card_line,
                              grads=cell == "molecule" or (name, cell) == ZOO_FLAT_GRADS)
            if cell == "minibatch_lg":
                mb_counts[name] = counts
            gc.collect()
            torch.cuda.empty_cache()
    mb = batches["minibatch_lg"]
    n, E = mb["x"].shape[0], mb["edge_src"].shape[0]

    def mask_of(key):
        return mb["edge_mask" if key.startswith("edge") else "tri_mask"]

    def rows_of(key):  # the rows of the table the index names
        return n if key.startswith("edge") else E

    d_egnn, d_mace, d_dime = (get_arch(a).make_config(False, "minibatch_lg").d_hidden
                              for a in ("egnn", "mace", "dimenet"))
    sums = (  # label, model, index key, d: a segment sum and, over the same ELL, gathers
        ("EGNN messages, edges -> nodes", "egnn", "edge_dst", d_egnn),
        ("EGNN coordinate update, edges -> nodes", "egnn", "edge_dst", 3),
        ("MACE density A, edges -> nodes", "mace", "edge_dst", 9 * d_mace),
        ("DimeNet triplets -> edges", "dimenet", "tri_ji", d_dime),
        ("DimeNet edges -> nodes", "dimenet", "edge_dst", d_dime),
    )
    # the segment ELLs a step can launch over, by the wrapper's launch
    # shape less d (rows of x, n, W): each index's forward (its sums and
    # its gathers' backward) and each summed index's transpose (the sums'
    # backward), from the memo the steps filled
    where = {}  # (index key, way) -> (rows of x, n, W)
    for key in ("edge_src", "edge_dst", "tri_kj", "tri_ji"):
        t, n_out = mb[key].shape[0], rows_of(key)
        where[(key, "forward")] = (t, n_out, segment_ell(mb[key], mask_of(key), n_out).col.shape[1])
        if any(key == k for _, _, k, _ in sums):
            tell = segment_transpose(mb[key], mask_of(key), n_out)
            where[(key, "transpose")] = (n_out, t, tell.col.shape[1])
    ell_at = {shape: ways for ways, shape in where.items()}
    if len(ell_at) != len(where):
        fail(f"minibatch_lg: two segment ELLs share a launch shape, so the counts cannot tell "
             f"them apart: {where}")
    for m, counts in mb_counts.items():
        stray = [shape for shape in counts if shape[:3] not in ell_at]
        if stray:
            fail(f"{m} minibatch_lg launched the vertex sum at (rows of x, n, W, d) {stray}, "
                 f"the shape of no segment ELL of the block ({where})")

    def at(key, way, d):
        return (*where[(key, way)], d)

    shapes = []  # label, models, index key, d, with its transpose
    for label, model, key, d in sums:  # the launches of gathers at the same (ELL, d) too
        also = [m for m in ZOO_MODELS if m != model and at(key, "forward", d) in mb_counts[m]]
        shapes.append((label, (model, *also), key, d, True))
    done = {(key, d) for _, _, key, d, _ in shapes}
    gathers = {(ell_at[shape[:3]][0], shape[3]) for c in mb_counts.values() for shape in c
               if ell_at[shape[:3]][1] == "forward"}
    for key, d in sorted(gathers - done):
        models = tuple(m for m in ZOO_MODELS if at(key, "forward", d) in mb_counts[m])
        shapes.append((f"gathers' backward over {key} ({', '.join(models)})", models, key, d,
                       False))
    checked = {(m, at(key, way, d)) for _, models, key, d, tr in shapes for m in models
               for way in ("forward", "transpose")[:1 + tr]}
    for m, counts in mb_counts.items():
        missed = [shape for shape in counts if (m, shape) not in checked]
        if missed:
            fail(f"{m} minibatch_lg launched the vertex sum at (rows of x, n, W, d) {missed}, "
                 "which no row checks")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    rows = []

    def counted(row, label, models, shape):
        row |= {"launches": sum(mb_counts[m].get(shape, 0) for m in models), "shape": label}
        if not row["launches"]:
            fail(f"{label}: the minibatch_lg steps never launched the vertex sum at this shape")
        rows.append(row)

    for label, models, key, d, with_transpose in shapes:
        index, mask = mb[key], mask_of(key)
        n_out, t = rows_of(key), index.shape[0]
        ell = segment_ell(index, mask, n_out)
        # a gradient is 0 at a masked row, as the values of a sum are
        values = torch.randn((t, d), generator=gen, device=dev) * mask[:, None]

        def index_add(index=index, values=values, n_out=n_out, d=d):
            return torch.zeros((n_out, d), device=dev).index_add_(0, index, values)

        row = vertex_check(f"{label}, ({t}, {d}) -> ({n_out}, {d}), minibatch_lg", values, ell,
                           ell_graph(ell, t), flush, library=("index_add_", index_add))
        counted(row, label, models, at(key, "forward", d))
        del values
        if not with_transpose:
            continue
        # the sum's backward: the W = 1 transpose, a masked gather
        tell = segment_transpose(index, mask, n_out)
        g = torch.randn((n_out, d), generator=gen, device=dev)
        weights = mask.to(torch.float32)[:, None]

        def bag(index=index, g=g, weights=weights):
            return F.embedding_bag(index[:, None], g, per_sample_weights=weights, mode="sum")

        gathered = K.spmm_ell_vertex_cuda(g, tell.col, tell.wgt, tell.row_ptr, tell.deg)
        # + 0.0: the kernel's sum starts at +0, so a -0 product comes out +0
        if not bits_equal(gathered, g.index_select(0, index) * weights + 0.0):
            fail(f"{label}: the W = 1 transpose's vertex sum is not index_select(g) * mask "
                 "bit for bit")
        del gathered
        row = vertex_check(f"{label}, backward: the W = 1 transpose, ({n_out}, {d}) -> ({t}, "
                           f"{d}), minibatch_lg", g, tell, ell_graph(tell, n_out), flush,
                           library=("F.embedding_bag (per-sample weights)", bag))
        counted(row, f"{label}, backward (W = 1 transpose)", models, at(key, "transpose", d))
        del g
    del batches, mb, flush
    gc.collect()
    torch.cuda.empty_cache()
    return rows


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
    """Walls of ``pairs`` back-to-back warm solves, one untraced and one
    traced, the untraced first in even pairs and second in odd ones, so
    that neither side always runs on a host that the other warmed or
    slowed: (untraced walls, traced walls), pair by pair."""
    import torch

    walls = ([], [])
    for i in range(pairs):
        order = (0, 1) if i % 2 == 0 else (1, 0)
        for side in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (base, traced)[side].solve(problem)
            torch.cuda.synchronize()
            walls[side].append(time.perf_counter() - t0)
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
        queries = build_query_mix(gs, SERVICE_QUERIES, SERVE_ZIPF, SEED)
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

        # the SERVE_UPDATES improving updates, each timed on rank 0
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
    queries = build_query_mix(g, SERVICE_QUERIES, SERVE_ZIPF, SEED)
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
    log(f"gloo P={P} service: {SERVICE_QUERIES} queries in {wall:.3f} s = "
        f"{SERVICE_QUERIES / wall:.1f} q/s (stacked P={P}: "
        f"{SERVICE_QUERIES / stacked_wall:.1f} q/s), p50 {lead['p50_s'] * 1e3:.1f} ms, "
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
    attn_rows, bag_row = serving_kernels(dev, flush)
    bwd_rows = attention_bwd_kernels(dev, flush)
    del flush
    attn_row, attn32_row, attn_dbrx_row, attn_tp_row = (
        attn_rows[label] for label in ("a minitron prefill", "d fp32 twin prefill",
                                       "e dbrx prefill", "e' phi3.5-moe prefill, a tp 2 rank"))
    bwd_row, bwd32_row = bwd_rows["f phi3-mini train"], bwd_rows["i fp32 twin train"]
    rows += list(attn_rows.values()) + list(bwd_rows.values()) + [bag_row]
    log(f"phase 7 took {time.perf_counter() - t0:.1f} s")

    # ---- 8. LM serving, minitron-8b at full width ---------------------
    t0 = time.perf_counter()
    attn_row["launches"], attn32_row["launches"] = lm_serving(dev)
    log(f"phase 8 took {time.perf_counter() - t0:.1f} s")

    # ---- 8b. MLA and MoE serving: minicpm3, phi3.5-moe, dbrx -----------
    t0 = time.perf_counter()
    phi_launches, attn_dbrx_row["launches"], shard_ref = mla_moe_serving(dev)
    attn_row["launches"] += phi_launches
    log(f"phase 8b took {time.perf_counter() - t0:.1f} s")

    # ---- 8d. LM serving across ranks: phi3.5-moe, tp 2 and dp 2 x tp 2 --
    t0 = time.perf_counter()
    attn_tp_row["launches"] = sharded_serving(dev, shard_ref, card_line)
    del shard_ref
    log(f"phase 8d took {time.perf_counter() - t0:.1f} s")

    # ---- 8c. LM training, phi3-mini-3.8b at full width ------------------
    t0 = time.perf_counter()
    bwd_row["launches"], bwd32_row["launches"] = lm_training(dev, card_line)
    log(f"phase 8c took {time.perf_counter() - t0:.1f} s")

    # ---- 8e. LM training across ranks: phi3-mini, dp 2 x tp 2 and tp 2 --
    t0 = time.perf_counter()
    for key, (fwd, bwd) in sharded_training(dev, card_line).items():
        fwd_label, bwd_label = TRAIN_SHARD_ROWS[key]
        attn_rows[fwd_label]["launches"], bwd_rows[bwd_label]["launches"] = fwd, bwd
    log(f"phase 8e took {time.perf_counter() - t0:.1f} s")

    # ---- 9. MIND serving at full width --------------------------------
    t0 = time.perf_counter()
    bag_row["launches"] = mind_serving(dev)
    log(f"phase 9 took {time.perf_counter() - t0:.1f} s")

    # ---- 9b. MIND training at full width, the train_batch cell ---------
    t0 = time.perf_counter()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rows += mind_training(dev, flush, card_line)
    del flush
    log(f"phase 9b took {time.perf_counter() - t0:.1f} s")

    # ---- 10. GIN inference at full width, ogb-products scale -----------
    t0 = time.perf_counter()
    gin_row, gin_graph, gin_batch = gin_inference(dev)
    rows.append(gin_row)
    log(f"phase 10 took {time.perf_counter() - t0:.1f} s")

    # ---- 10b. GIN training on phase 10's graph; gin-tu's other cells ---
    t0 = time.perf_counter()
    gin_row, zoo_block = gin_training(dev, gin_graph, gin_batch, card_line)
    rows.append(gin_row)
    log(f"phase 10b took {time.perf_counter() - t0:.1f} s")

    # ---- 10c. EGNN, MACE and DimeNet: their train cells, new kernel rows --
    t0 = time.perf_counter()
    rows += gnn_zoo(dev, zoo_block, card_line)
    del gin_graph, gin_batch, zoo_block
    log(f"phase 10c took {time.perf_counter() - t0:.1f} s")

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
