#!/usr/bin/env python3
"""Time the port's two SSSP frontier kernels, and the solves that launch
them, in several source trees on one NVIDIA GPU, one process a tree, in
the order given: the way to hold a change of
``src/repro_torch/csrc/{fused_superstep,relax_push}.cu`` or of the
solve around them against its parent on the same card.

    python3 scripts/frontier_ab.py PARENT . . PARENT

Each tree is a checkout whose ``src/repro_torch`` is imported and built.
The graph is ``chip_smoke.py``'s: rmat1 at scale 20, seed 0, one rank
(generated once and kept in ``build/frontier_ab/``), and the frontiers
are phase 3's two (``chip_smoke.sssp_frontiers``: the delta class with
the most live rows, and the median one).  For each tree, three times
over:

* ``fused_superstep`` and ``relax_push_gather`` through their wrappers,
  held bit for bit against the plain versions first: the CUDA-event
  time of ``chip_smoke.time_ms`` (each launch after a write that
  evicts L2, the wrapper included) and the kernel's own device time
  under ``torch.profiler`` over the same launches;
* one warm solve of the main path (``delta:5/sparse/fused``) and of the
  push path, wall time, and the solve's device time by kernel under
  ``torch.profiler`` (the first round only);
* the batched entries (``fused_superstep_batch``, ``relax_push_gather_batch``)
  through their wrappers at the two supersteps of phase 3's batched
  solve of the 8 landmark sources (``chip_smoke.batched_supersteps``:
  the balanced one, every lane near F, and the skewed one, lanes at 0
  beside a lane near F), held bit for bit against the plain versions
  first, timed the same two ways (each wrapper call fills a fresh
  output, so every atomic runs).

In this script's own tree it also builds ``scripts/frontier_variants.cu``
and times, in turns with the library's kernels and checked bit for bit
the same way, the bulk-copy ring design of both kernels, the warp
combine of the fused one, and the floor the fused kernel's atomics set:
the same pre-checked atomic mins on the same (column, value) pairs,
listed flat, for the single entry at both frontiers and for the batched
one at both supersteps ((lane, column, value) triples).  Prints the
card line (``nvidia-smi``), one JSON line a tree, and the profiles as
text.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "frontier_ab"
VARIANTS = ROOT / "scripts" / "frontier_variants.cu"
ROUNDS = 3


def load_graph():
    """rmat1 scale 20 and its Dijkstra distances from source 0, made by
    the first tree's process and read back by the others."""
    import numpy as np

    import chip_smoke
    from repro_torch.graph import Graph, rmat1
    from repro_torch.launch.sssp import oracle

    path = CACHE / f"rmat1_s{chip_smoke.SCALE}_seed{chip_smoke.SEED}.npz"
    if not path.exists():
        g = rmat1(chip_smoke.SCALE, seed=chip_smoke.SEED)
        CACHE.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp.npz")
        np.savez(tmp, n=g.n, src=g.src, dst=g.dst, weight=g.weight, name=g.name,
                 truth=oracle(g, chip_smoke.SOURCE))
        tmp.replace(path)
    z = np.load(path)
    g = Graph(int(z["n"]), z["src"], z["dst"], z["weight"], name=str(z["name"]))
    return g, z["truth"]


def variants_library():
    """scripts/frontier_variants.cu built with the library's flags."""
    from repro_torch.kernels import _lib

    out = CACHE / "libfrontier_variants.so"
    CACHE.mkdir(parents=True, exist_ok=True)
    cmd = [_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared", "-I", str(_lib.CSRC),
           str(VARIANTS), "-o", str(out)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        sys.exit(f"nvcc failed on {VARIANTS.name}:\n{done.stdout}{done.stderr}")
    for line in (done.stdout + done.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"[variants] {line.strip()}", flush=True)
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, args in (("fused_superstep_bulk_launch", [P] * 7 + [I] * 3 + [P]),
                       ("fused_superstep_combine_launch", [P] * 7 + [I] * 3 + [P]),
                       ("relax_push_gather_bulk_launch", [P] * 6 + [I] * 3 + [P]),
                       ("atomic_floor_launch", [P] * 3 + [ctypes.c_longlong, P])):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = I
    return lib


def kernel_ms(calls: dict, flush) -> dict:
    """Mean device time of each kernel over chip_smoke.TIMING_REPS calls
    of its function (``calls``: name in the profile -> function), each
    after a write that evicts L2, from one torch.profiler window.  The
    window starts with untimed writes and a mean is over the launches
    it recorded: a window can lose its first kernels, and one that lost
    every launch of a kernel is opened again, three windows at most."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke

    for fn in calls.values():
        fn()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(8):
                flush.zero_()
            for fn in calls.values():
                for _ in range(chip_smoke.TIMING_REPS):
                    flush.zero_()
                    fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        out = {}
        for name in calls:
            mine = [e for e in events if name in e.key]
            n = sum(e.count for e in mine)
            if n:
                out[name] = sum(e.self_device_time_total for e in mine) / 1e3 / n
        if len(out) == len(calls):
            return out
    sys.exit(f"three profiler windows recorded no launch of "
             f"{sorted(set(calls) - set(out))}")


def time_tree(tree: Path) -> None:
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke
    from repro_torch import kernels as K
    from repro_torch.api import Problem, SingleSource, Solver, SolverConfig
    from repro_torch.core.frontier import frontier_caps
    from repro_torch.graph import partition_graph

    dev = torch.device("cuda")
    K.build()
    g, truth = load_graph()
    pg = partition_graph(g, 1)
    ell = pg.to(dev)
    truth_t = torch.as_tensor(truth, device=dev)
    R, W = pg.rows_per_rank, pg.width
    row_cap, _ = frontier_caps(R, W, pg.n_local, 1)
    rs, col, wgt = ell.row_src[0], ell.col[0], ell.wgt[0]
    n_out = pg.n_pad
    frontiers = chip_smoke.sssp_frontiers(g, pg, ell, truth_t, row_cap)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def fused(fr, col, wgt):
        return lambda: K.fused_superstep_cuda(fr["dist"], fr["f_idx"], fr["f_cnt"],
                                              rs, col, wgt, n_out)

    def push(fr, col, wgt):
        return lambda: K.relax_push_gather_cuda(fr["dist"], fr["f_idx"], fr["f_cnt"],
                                                rs, col, wgt)

    # design name -> (kernel, name in the profile, (frontier, col, wgt) -> call)
    designs = {"fused_superstep": ("fused_superstep", "fused_superstep_kernel", fused),
               "relax_push_gather": ("relax_push_gather", "relax_push_gather_kernel", push)}
    if tree.resolve() == ROOT:
        lib = variants_library()

        def bulk_fused(fr, col, wgt):
            def call():
                out = torch.full((n_out + 1,), float("inf"), device=dev)
                K._lib.check(lib.fused_superstep_bulk_launch(
                    fr["dist"].data_ptr(), fr["f_idx"].data_ptr(), fr["f_cnt"].data_ptr(),
                    rs.data_ptr(), col.data_ptr(), wgt.data_ptr(), out.data_ptr(),
                    row_cap, R, W, stream), "fused_superstep bulk")
                return out
            return call

        def combine_fused(fr, col, wgt):
            def call():
                out = torch.full((n_out + 1,), float("inf"), device=dev)
                K._lib.check(lib.fused_superstep_combine_launch(
                    fr["dist"].data_ptr(), fr["f_idx"].data_ptr(), fr["f_cnt"].data_ptr(),
                    rs.data_ptr(), col.data_ptr(), wgt.data_ptr(), out.data_ptr(),
                    row_cap, R, W, stream), "fused_superstep combine")
                return out
            return call

        def bulk_push(fr, col, wgt):
            def call():
                out = torch.empty((row_cap, W), device=dev)
                K._lib.check(lib.relax_push_gather_bulk_launch(
                    fr["dist"].data_ptr(), fr["f_idx"].data_ptr(), fr["f_cnt"].data_ptr(),
                    rs.data_ptr(), wgt.data_ptr(), out.data_ptr(), row_cap, R, W,
                    stream), "relax_push_gather bulk")
                return out
            return call

        def floor(fr, col, wgt):
            # the (column, value) pairs the fused kernel's atomics take
            live = fr["live"]
            r = fr["f_idx"][:live].long().clamp(0, R - 1)
            v = fr["dist"][rs[r].long()][:, None] + wgt[r]
            keep = v != float("inf")
            cols, vals = col[r][keep].contiguous(), v[keep].contiguous()

            def call():
                out = torch.full((n_out + 1,), float("inf"), device=dev)
                K._lib.check(lib.atomic_floor_launch(
                    cols.data_ptr(), vals.data_ptr(), out.data_ptr(), cols.numel(), stream),
                    "atomic floor")
                return out
            return call

        designs.update({
            "fused_superstep bulk": ("fused_superstep", "frontier_bulk_kernel<true>", bulk_fused),
            "fused_superstep combine": ("fused_superstep", "combine_kernel", combine_fused),
            "relax_push_gather bulk": ("relax_push_gather", "frontier_bulk_kernel<false>",
                                       bulk_push),
            "atomics floor": ("fused_superstep", "atomic_floor_kernel", floor),
        })

    plain = {
        "fused_superstep": lambda fr, col, wgt: K.fused_superstep_ref(
            fr["dist"], fr["f_idx"], fr["f_cnt"], rs, col, wgt, n_out),
        "relax_push_gather": lambda fr, col, wgt: K.relax_push_gather_ref(
            fr["dist"], fr["f_idx"], fr["f_cnt"], rs, wgt),
    }
    # the frontiers as they are, and the largest with every column moved
    # onto 4 destinations (a warp then holds many equal ones) and weights
    # off the integers (so each destination's least candidate is unique)
    hub = torch.where(col == n_out, col, col % 4)
    hub_wgt = wgt + torch.rand(wgt.shape, generator=torch.Generator(dev).manual_seed(0),
                               device=dev)
    for fr, c, w, label in [(fr, col, wgt, fr["label"]) for fr in frontiers] + [
            (frontiers[0], hub, hub_wgt, "largest, on 4 destinations")]:
        want = {k: fn(fr, c, w) for k, fn in plain.items()}
        for name, (kernel, _, make) in designs.items():
            got = make(fr, c, w)()
            torch.cuda.synchronize()
            if not torch.equal(got, want[kernel]):
                sys.exit(f"{tree}: {name} differs from the plain {kernel} at the "
                         f"{label} frontier")
        del want
    del hub, hub_wgt

    # the batched entries at phase 3's two batched supersteps
    batched, batched_counts = {}, {}
    for label, st in chip_smoke.batched_supersteps(g, pg, dev).items():
        bd, bi, bc = st["dist"], st["row_idx"], st["count"]
        batched_counts[label] = bc.tolist()
        calls = {
            "fused_superstep_batch_kernel": lambda bd=bd, bi=bi, bc=bc:
                K.fused_superstep_batch_cuda(bd, bi, bc, ell.row_src, ell.col, ell.wgt,
                                             n_out),
            "relax_push_gather_batch_kernel": lambda bd=bd, bi=bi, bc=bc:
                K.relax_push_gather_batch_cuda(bd, bi, bc, ell.row_src, ell.col, ell.wgt),
        }
        want = {"fused_superstep_batch_kernel": K.fused_superstep_batch_ref(
                    bd, bi, bc, ell.row_src, ell.col, ell.wgt, n_out),
                "relax_push_gather_batch_kernel": K.relax_push_gather_batch_ref(
                    bd, bi, bc, ell.row_src, ell.wgt)}
        if tree.resolve() == ROOT:
            calls["atomic_floor_kernel"], _ = chip_smoke.atomic_floor_call(
                lib, bd, bi, bc, ell.row_src, ell.col, ell.wgt, n_out)
            want["atomic_floor_kernel"] = want["fused_superstep_batch_kernel"]
        for key, call in calls.items():
            got = call()
            torch.cuda.synchronize()
            if not torch.equal(got, want[key]):
                sys.exit(f"{tree}: {key} differs from the plain version at the "
                         f"{label} batched superstep")
        del want
        batched[label] = calls

    main = Solver(chip_smoke.SPEC, device="cuda")
    push_solver = Solver(SolverConfig.from_spec("delta:5/sparse", relax_impl="push"),
                         device="cuda")
    problem = Problem(pg, SingleSource(chip_smoke.SOURCE))
    for s in (main, push_solver):  # cold solves: builds, caches
        s.solve(problem)
    result: dict = {"tree": str(tree), "frontiers": {
        fr["label"]: {"class": fr["cls"], "live": fr["live"], "rows": row_cap}
        for fr in frontiers}}
    result["batched counts"] = batched_counts
    for rnd in range(ROUNDS):
        for fr in frontiers:
            calls = {key: make(fr, col, wgt) for _, key, make in designs.values()}
            alone = kernel_ms(calls, flush)
            for name, (_, key, _) in designs.items():
                rec = result.setdefault(f"{name} @ {fr['label']}", {"ms": [], "kernel_ms": []})
                rec["ms"].append(round(chip_smoke.time_ms(calls[key], flush), 4))
                rec["kernel_ms"].append(round(alone[key], 4))
        for label, calls in batched.items():
            alone = kernel_ms(calls, flush)
            for key, call in calls.items():
                rec = result.setdefault(f"{key} @ batched {label}", {"ms": [], "kernel_ms": []})
                rec["ms"].append(round(chip_smoke.time_ms(call, flush), 4))
                rec["kernel_ms"].append(round(alone[key], 4))
        for label, s in (("main solve", main), ("push solve", push_solver)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.solve(problem)
            torch.cuda.synchronize()
            result.setdefault(f"{label} s", []).append(round(time.perf_counter() - t0, 4))
            if rnd == 0:
                with chip_smoke.device_profile(f"{tree}: one warm {label}", top=8):
                    s.solve(problem)
                    torch.cuda.synchronize()
    print(json.dumps(result), flush=True)


def main() -> None:
    if len(sys.argv) >= 3 and sys.argv[1] == "--tree":
        time_tree(Path(sys.argv[2]).resolve())
        return
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip(), flush=True)
    for tree in sys.argv[1:]:
        subprocess.run([sys.executable, __file__, "--tree", tree], check=True)


if __name__ == "__main__":
    main()
