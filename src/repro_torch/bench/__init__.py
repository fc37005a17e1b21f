"""The paper's experiment drivers on the port: the EAGM family grid of
Figs 5–7 (:mod:`~repro_torch.bench.variants`), the Table I stand-ins
(:mod:`~repro_torch.bench.table1`) and weak scaling
(:mod:`~repro_torch.bench.scaling`), with :mod:`~repro_torch.bench.run`
running them all.

They are the counterparts of the JAX package's
``benchmarks/bench_{variants,table1,scaling}.py`` and
``benchmarks/run.py``: the same graphs, seeds, specs and meshes, and
rows with the same names and fields.  The JAX package runs its ranks
on 8 forced host devices in a subprocess; these run in-process, on
ranks stacked on one device over a
:class:`~repro_torch.launch.mesh.RankMesh` of the same axes, on the card
unless ``device="cpu"``.  ``model_ms`` is
:func:`repro_torch.core.metrics.model_time_s`, the H100 cost model
unless ``cost`` gives other figures; ``wall_s`` is one warm solve.
JSON output goes under ``experiments/bench_torch/``.

    python -m repro_torch.bench.run --fast --device cpu
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from repro_torch.launch.mesh import RankMesh

#: the JAX package's production-shaped mesh of 8 ranks
MESH8 = RankMesh((2, 2, 2), ("pod", "data", "model"))

#: where the experiments' JSON goes
OUT_DIR = os.path.join("experiments", "bench_torch")


def same_state(truth: np.ndarray, state: np.ndarray) -> bool:
    """The state equals the Dijkstra distances (unreachable: +inf)."""
    return bool(np.array_equal(np.where(np.isinf(truth), -1, truth),
                               np.where(np.isinf(state), -1, state)))


def timed_solve(solver, problem):
    """One solve, timed: (solution, wall s).  The port compiles nothing,
    so a solve is warm once its partition's ELL is on the device: the
    drivers partition each graph once and solve it once untimed first
    (the JAX package solves every point twice, the first compiling)."""
    dev = solver.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    sol = solver.solve(problem)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return sol, time.perf_counter() - t0


def write_json(rows, name: str, out_dir: str = OUT_DIR) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    with open(path, "w") as f:
        json.dump(rows, f, indent=1, sort_keys=True)
    return path
