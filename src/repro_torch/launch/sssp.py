"""SSSP driver on the port's facade: one solve on a generated graph
with any (ordering × EAGM variant × exchange) family member, on the
card unless ``--device cpu`` is given, optionally verified against
Dijkstra.  Several ``--sources`` solve as one batch (``solve_batch``).

    PYTHONPATH=src python -m repro_torch.launch.sssp --scale 20 \
        --spec delta:5/sparse/fused --verify
    PYTHONPATH=src python -m repro_torch.launch.sssp --scale 20 \
        --sources 0 17 90 --verify

``--ranks P`` partitions over P ranks and ``--pods K`` splits them into
K pods (the ``pod`` scope of a hierarchy spec).  ``--backend stacked``
(the default) runs every rank in this process; ``gloo`` or ``nccl`` run
one rank a process of a ``torch.distributed`` group.  Without
``RANK``/``WORLD_SIZE`` in the environment the CLI starts the P
processes itself (a ``file://`` rendezvous in a temporary directory);
under ``torchrun`` each process joins as its ``RANK``.  Process r runs
on ``cuda:{r % device_count}`` (or the CPU under ``--device cpu``);
rank 0 prints and verifies.  NCCL needs one card a process.

    PYTHONPATH=src python -m repro_torch.launch.sssp --device cpu \
        --backend gloo --ranks 4 --pods 2 --scale 10 --verify
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.sssp \
        --backend nccl --scale 20 --verify
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.api import (
    EveryVertex,
    Problem,
    SingleSource,
    Solver,
    processing_names,
)
from repro_torch.core import dijkstra_reference
from repro_torch.device import resolve_device
from repro_torch.graph import grid_road_graph, rmat1, rmat2, small_world_graph
from repro_torch.launch import mesh
from repro_torch.launch.mesh import (
    check_backend,
    init_ranks,
    make_rank_mesh,
    spawn_ranks,
)

BACKENDS = ("stacked",) + mesh.BACKENDS
# seconds the rank processes may run before the CLI stops them all
RANK_TIMEOUT_S = 3600.0


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


def profile_solve(solver: Solver, problem: Problem, top: int = 15,
                  show: bool = True) -> None:
    """One warm solve under torch.profiler: device (or, on the CPU, host)
    time by operator, and the share of the solve's wall time the device
    was busy.  Every process of a process backend solves (the solve is
    collective); ``show`` prints."""
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
    if not show:
        return
    print(events.table(sort_by=attr, row_limit=top))
    print(f"[profile] wall={wall * 1e3:.3f} ms "
          f"device_busy={busy_us / 1e3:.3f} ms "
          f"busy_share={busy_us / 1e6 / wall:.3f}"
          + ("" if on_card else " (no device: host run)"))


def solve_and_report(args, solver: Solver, show: bool) -> int:
    """Partition, solve and (with ``show``) print and verify; returns
    the exit code.  Every process of a process backend runs it."""
    g = build_graph(args.graph, args.scale, args.seed)
    pg = solver.partition(g)
    ell = solver.device_ell(pg)
    ell_bytes = sum(t.numel() * t.element_size() for t in ell)
    where = (torch.cuda.get_device_name(solver.device)
             if solver.device.type == "cuda" else "cpu")
    if args.problem == "cc":
        labels = ["all-vertices"]
        problems = [Problem(g, EveryVertex(), processing="cc")]
    else:
        labels = [f"source={v}" for v in args.sources]
        problems = [Problem(g, SingleSource(v), processing=args.problem)
                    for v in args.sources]
    t0 = time.perf_counter()
    if solver.config.adapt is not None and len(problems) > 1:
        sols = [solver.solve(pb) for pb in problems]  # batches refuse /adapt
    else:
        sols = solver.solve_batch(problems)
    wall = time.perf_counter() - t0
    if args.profile:
        profile_solve(solver, problems[0], show=show)
    if not show:
        return 0
    print(f"[sssp] {pg.describe()}")
    print(f"[sssp] backend={args.backend} ranks={solver.n_parts} "
          f"mesh={solver.mesh.shape}{solver.mesh.axis_names} "
          f"ELL on the device of rank 0: {ell_bytes} bytes")
    print(f"[sssp] spec={solver.config.name} device={where} "
          f"batch={len(problems)}")
    for label, sol in zip(labels, sols):
        print(f"[sssp] {label} {sol.metrics}")
        print(f"[sssp] {label} reached="
              f"{int(np.isfinite(sol.state).sum())}/{g.n}")
    print(f"[sssp] wall={wall:.3f}s (first solve: includes the copy to the "
          "device and any kernel build)")
    if args.verify and args.problem == "sssp":
        bad = 0
        for v, sol in zip(args.sources, sols):
            ok = np.array_equal(sol.state, oracle(g, v))
            print(f"[sssp] source={v} verify vs Dijkstra: "
                  f"{'OK' if ok else 'MISMATCH'}")
            bad += not ok
        if bad:
            return 1
    elif args.verify:
        print("[sssp] --verify oracle only wired for --problem sssp")
    return 0


def rank_main(rank: int, world: int, args, init_method: str) -> None:
    """One rank process: join the group, solve, and exit non-zero on a
    failed check (rank 0's)."""
    if args.device == "cpu":
        device = torch.device("cpu")
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    else:
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    ranks = init_ranks(args.backend, rank, world,
                       make_rank_mesh(world, args.pods), init_method)
    try:
        solver = Solver(args.spec, n_parts=world, device=device, ranks=ranks)
        rc = solve_and_report(args, solver, show=rank == 0)
    finally:
        torch.distributed.destroy_process_group()
    if rc:
        raise SystemExit(rc)


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
    ap.add_argument("--problem", default="sssp", choices=processing_names(),
                    help="processing function (all share the engine)")
    ap.add_argument("--device", default=None,
                    help="'cuda' (default) or 'cpu' for the plain torch path")
    ap.add_argument("--ranks", type=int, default=None,
                    help="rank count P (default 1, or WORLD_SIZE under "
                         "torchrun)")
    ap.add_argument("--pods", type=int, default=1,
                    help="pods the ranks split into (the 'pod' scope)")
    ap.add_argument("--backend", default="stacked", choices=BACKENDS,
                    help="stacked: every rank in this process; gloo or "
                         "nccl: one rank a process")
    ap.add_argument("--verify", action="store_true")
    ap.add_argument("--profile", action="store_true",
                    help="solve once more under torch.profiler and print "
                         "device time by operator and the device busy share")
    args = ap.parse_args(argv)

    torchrun = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if args.ranks is None:
        args.ranks = int(os.environ["WORLD_SIZE"]) if torchrun else 1
    if args.backend == "stacked":
        mesh = make_rank_mesh(args.ranks, args.pods)
        solver = Solver(args.spec, n_parts=args.ranks, device=args.device,
                        mesh=mesh)
        return solve_and_report(args, solver, show=True)

    # refuse what cannot run before any process group starts
    check_backend(args.backend, args.ranks,
                  torch.device(args.device or "cuda"))
    make_rank_mesh(args.ranks, args.pods)
    device = resolve_device(args.device)
    args.device = device.type
    if torchrun:
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        if world != args.ranks:
            raise ValueError(f"--ranks {args.ranks} but torchrun started "
                             f"{world} processes")
        rank_main(rank, world, args, "env://")
        return 0
    if device.type == "cuda":
        from repro_torch.kernels import build

        build()  # once, before the rank processes would each compile it
    with tempfile.TemporaryDirectory() as tmp:
        spawn_ranks(rank_main, args.ranks,
                    (args, "file://" + os.path.join(tmp, "store")),
                    timeout=RANK_TIMEOUT_S)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
