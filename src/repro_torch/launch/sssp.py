"""SSSP driver on the port's facade: one solve on a generated graph
with any (ordering × EAGM variant × exchange) family member, on the
card unless ``--device cpu`` is given, optionally verified against
Dijkstra.  Several ``--sources`` solve as one batch (``solve_batch``).

    PYTHONPATH=src python -m repro_torch.launch.sssp --scale 20 \
        --spec delta:5/sparse/fused --verify
    PYTHONPATH=src python -m repro_torch.launch.sssp --scale 20 \
        --sources 0 17 90 --verify
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.api import Problem, SingleSource, Solver
from repro_torch.core import dijkstra_reference
from repro_torch.graph import grid_road_graph, rmat1, rmat2, small_world_graph


def build_graph(kind: str, scale: int, seed: int):
    if kind == "rmat1":
        return rmat1(scale, seed)
    if kind == "rmat2":
        return rmat2(scale, seed)
    if kind == "road":
        return grid_road_graph(int(2 ** (scale / 2)), seed)
    if kind == "smallworld":
        return small_world_graph(1 << scale, seed=seed)
    raise SystemExit(f"unknown graph kind {kind}")


def oracle(g, source: int) -> np.ndarray:
    """Dijkstra distances as float32: scipy's when installed (fast at
    scale 20), else the port's heapq oracle."""
    try:
        from scipy.sparse import csr_matrix
        from scipy.sparse.csgraph import dijkstra
    except ImportError:
        return dijkstra_reference(g, source).astype(np.float32)
    a = csr_matrix((g.weight.astype(np.float64), (g.src, g.dst)),
                   shape=(g.n, g.n))
    return dijkstra(a, directed=True, indices=source).astype(np.float32)


def profile_solve(solver: Solver, problem: Problem, top: int = 15) -> None:
    """One warm solve under torch.profiler: device (or, on the CPU, host)
    time by operator, and the share of the solve's wall time the device
    was busy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    on_card = solver.device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        solver.solve(problem)
        sync()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    attr = "self_device_time_total" if on_card else "self_cpu_time_total"
    # device time is reported both on an operator and on its kernels;
    # count the kernel rows only
    busy_us = sum(e.self_device_time_total for e in events
                  if e.device_type == DeviceType.CUDA)
    print(events.table(sort_by=attr, row_limit=top))
    print(f"[profile] wall={wall * 1e3:.3f} ms "
          f"device_busy={busy_us / 1e3:.3f} ms "
          f"busy_share={busy_us / 1e6 / wall:.3f}"
          + ("" if on_card else " (no device: host run)"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--graph", default="rmat1",
                    choices=["rmat1", "rmat2", "road", "smallworld"])
    ap.add_argument("--scale", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--spec", default="delta:5/sparse/fused",
                    help="solver spec, e.g. delta:5+threadq/a2a or "
                         "'delta:5 > pod:dijkstra /sparse'")
    ap.add_argument("--sources", type=int, nargs="+", default=[0],
                    help="source vertices; more than one solve as one batch")
    ap.add_argument("--device", default=None,
                    help="'cuda' (default) or 'cpu' for the plain torch path")
    ap.add_argument("--verify", action="store_true")
    ap.add_argument("--profile", action="store_true",
                    help="solve once more under torch.profiler and print "
                         "device time by operator and the device busy share")
    args = ap.parse_args(argv)

    solver = Solver(args.spec, device=args.device)
    g = build_graph(args.graph, args.scale, args.seed)
    pg = solver.partition(g)
    print(f"[sssp] {pg.describe()}")
    where = (torch.cuda.get_device_name(solver.device)
             if solver.device.type == "cuda" else "cpu")
    problems = [Problem(g, SingleSource(v)) for v in args.sources]
    t0 = time.perf_counter()
    sols = solver.solve_batch(problems)
    wall = time.perf_counter() - t0
    print(f"[sssp] spec={solver.config.name} device={where} "
          f"batch={len(problems)}")
    for v, sol in zip(args.sources, sols):
        print(f"[sssp] source={v} {sol.metrics}")
        print(f"[sssp] source={v} reached="
              f"{int(np.isfinite(sol.state).sum())}/{g.n}")
    print(f"[sssp] wall={wall:.3f}s (first solve: includes the copy to the "
          "device and any kernel build)")
    if args.profile:
        profile_solve(solver, problems[0])
    if args.verify:
        bad = 0
        for v, sol in zip(args.sources, sols):
            ok = np.array_equal(sol.state, oracle(g, v))
            print(f"[sssp] source={v} verify vs Dijkstra: "
                  f"{'OK' if ok else 'MISMATCH'}")
            bad += not ok
        if bad:
            return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
