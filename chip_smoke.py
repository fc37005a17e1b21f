#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU, at the size its users run on one card: rmat1 (Graph500
R-MAT, weights 1..100) at scale 20, seed 0, one rank.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

  1. card name and power limit; build the CUDA kernels from csrc/
  2. generate and partition the graph, copy it to the card, and solve
     the Dijkstra oracle (scipy) for source 0
  3. each kernel against its plain torch version on the card at the
     main path's shapes: bit-identical, timed with CUDA events
  4. the main path: Solver("delta:5/sparse/fused").solve(...) equals
     the oracle, converges, and launches fused_superstep
  5. the push path (relax_impl="push"): same state and metrics as 4,
     launches relax_push_gather
  6. the self-stabilizing sweep from a corrupted state (made from the
     seed) stabilizes to the oracle, launching relax_ell

It prints one JSON line of per-kernel numbers and, last, the device
line ``{"ok": true, "device": {...}}``.  Without a card, or without the
repository beside it, it fails before printing any result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SCALE = 20
SEED = 0
SOURCE = 0
SPEC = "delta:5/sparse/fused"
MEM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
TIMING_REPS = 20


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"[smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, flush) -> float:
    """Mean device time of ``fn`` over TIMING_REPS calls, each after an
    untimed write that evicts the 50 MB L2 (the engine calls these
    kernels once per superstep, between other passes)."""
    import torch

    fn()  # warm-up
    total = 0.0
    for _ in range(TIMING_REPS):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / TIMING_REPS


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


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> None:
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
    from repro_torch.core.frontier import compact_rows, frontier_caps
    from repro_torch.core.selfstab import in_ell, synchronous_sweep
    from repro_torch.graph import partition_graph, rmat1
    from repro_torch.launch.sssp import oracle

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

    # ---- 3. kernels against their plain versions ---------------------
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    truth_t = torch.as_tensor(truth, device=dev)
    # the Δ class key in torch, bit-equal on the card and on the CPU
    key = DeltaStepping(5.0)
    if not torch.equal(key.class_key(truth_t, None).cpu(),
                       key.class_key(truth_t.cpu(), None)):
        fail("delta class keys differ between the card and the CPU")
    # a real frontier of the main path: the Δ=5 class with the most
    # virtual rows that still fits row_cap, with the state committed up
    # to that class (the exact order the Δ-stepping root runs)
    R, W = pg.rows_per_rank, pg.width
    row_cap, _ = frontier_caps(R, W, pg.n_local, 1)
    cls = key.class_key(truth_t, None)
    row_cls = cls[ell.row_src[0].long().clamp(max=g.n - 1)]
    row_cls[ell.row_src[0].long() >= g.n] = float("inf")
    counts = torch.bincount(row_cls[torch.isfinite(row_cls)].long())
    fits = torch.nonzero(counts <= row_cap).flatten()
    c = int(fits[counts[fits].argmax()])
    dist = torch.where(cls <= c, truth_t, float("inf"))
    dist = torch.cat([dist, torch.full((1,), float("inf"), device=dev)])
    f_idx, f_cnt, over = compact_rows((row_cls == c)[None], row_cap)
    if bool(over.any()):
        fail("frontier selection overflowed row_cap")
    f_idx, f_cnt = f_idx[0].contiguous(), f_cnt[0]
    live = int(f_cnt)
    rs, col, wgt = ell.row_src[0], ell.col[0], ell.wgt[0]
    n_src = int(torch.unique(rs[f_idx[:live].long()]).numel())
    log(f"frontier: delta class {c}, {live} live rows of F={row_cap}, "
        f"{n_src} source vertices")

    rows = []

    def compare(name, kernel_fn, plain_fn, nbytes, ops, source, replaces):
        K.reset_launch_counts()
        out_k = kernel_fn()
        torch.cuda.synchronize()
        if K.launch_counts()[name] != 1:
            fail(f"{name}: the wrapper did not launch its kernel")
        out_p = plain_fn()
        err = max_abs_err(out_k, out_p)
        if err != 0.0 or out_k.dtype != out_p.dtype or out_k.shape != out_p.shape:
            fail(f"{name}: kernel differs from its plain version "
                 f"(max abs err {err})")
        ms = time_ms(kernel_fn, flush)
        plain_ms = time_ms(plain_fn, flush)
        bound_ms, bound_by = bound(nbytes, ops)
        log(f"{name}: bit-identical; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"{nbytes} bytes, bound {bound_ms:.4f} ms at 3.35 TB/s")
        rows.append(dict(name=name, route="cuda", source=source,
                         replaces=replaces, launches=0, max_abs_err=err,
                         ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=None))

    n_out = pg.n_pad
    compare(
        "fused_superstep",
        lambda: K.fused_superstep_cuda(dist, f_idx, f_cnt, rs, col, wgt, n_out),
        lambda: K.fused_superstep_ref(dist, f_idx, f_cnt, rs, col, wgt, n_out),
        # listed row ids and sources, col+wgt strips, source distances,
        # one write of the output
        4 * (2 * live + 2 * live * W + n_src + n_out + 1) + 4,
        live * W,
        "src/repro_torch/csrc/fused_superstep.cu",
        "src/repro/kernels/superstep_fused/kernel.py:72",
    )
    compare(
        "relax_push_gather",
        lambda: K.relax_push_gather_cuda(dist, f_idx, f_cnt, rs, col, wgt),
        lambda: K.relax_push_gather_ref(dist, f_idx, f_cnt, rs, wgt),
        4 * (2 * live + live * W + n_src + row_cap * W) + 4,
        live * W,
        "src/repro_torch/csrc/relax_push.cu",
        "src/repro/kernels/relax_push/kernel.py:42",
    )
    t0 = time.perf_counter()
    row_dst, in_col, in_wgt = in_ell(g)
    log(f"in-ELL built in {time.perf_counter() - t0:.1f} s: "
        f"R={in_col.shape[0]} W={in_col.shape[1]}")
    in_col_t = torch.as_tensor(in_col, device=dev)
    in_wgt_t = torch.as_tensor(in_wgt, device=dev)
    d_ext = torch.cat([truth_t, torch.full((1,), float("inf"), device=dev)])
    R_in, W_in = in_col.shape
    compare(
        "relax_ell",
        lambda: K.relax_ell_cuda(d_ext, in_col_t, in_wgt_t),
        lambda: K.relax_ell_ref(d_ext, in_col_t, in_wgt_t),
        4 * (2 * R_in * W_in + g.n + 1 + R_in),
        R_in * W_in * 2,
        "src/repro_torch/csrc/relax_ell.cu",
        "src/repro/kernels/relax_ell/kernel.py:45",
    )
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

    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s on {card_line}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
