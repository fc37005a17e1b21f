"""Solver facade: one (config, rank count, device), many problems.

    solver = Solver("delta:5/sparse/fused")          # on the card
    sol = solver.solve(Problem(g, SingleSource(0)))

Raw :class:`Graph` inputs are partitioned over ``n_parts`` ranks once
and memoized; the ELL buffers are copied to the device once per
partition.  ``device=None`` means the card, and raises without CUDA;
``device="cpu"`` runs the plain torch path.  Batched sources, warm
restarts and the quantized/adaptive solves are not yet ported.
"""

from __future__ import annotations

import dataclasses
import warnings
from collections import OrderedDict
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.api.config import SolverConfig, as_config
from repro_torch.api.problem import Problem
from repro_torch.core.engine import EngineConfig, initial_state, run_engine
from repro_torch.core.frontier import (
    frontier_caps,
    grow_frontier_cap,
    payload_plane_words,
)
from repro_torch.core.metrics import WorkMetrics
from repro_torch.device import resolve_device
from repro_torch.graph.formats import Graph, graph_fingerprint
from repro_torch.graph.partition import PartitionedGraph, partition_graph

# consecutive sparse-overflow supersteps before the frontier_cap warning
OVERFLOW_WARN_STREAK = 3


def exchange_words(
    pg: PartitionedGraph, ecfg: EngineConfig, it: int, fallbacks: int
) -> int:
    """Exact exchange word count per rank for ``it`` supersteps of which
    ``fallbacks`` took the dense path.  Per rank per superstep: a2a
    moves (P-1)·n_local·planes words, pmin twice that, sparse
    (P-1)·payload_plane_words(S) on sparse supersteps and the a2a count
    on dense ones."""
    use_level = ecfg.hierarchy.needs_level
    nplanes = 2 if use_level else 1
    P_, nl = pg.n_parts, pg.n_local
    dense_words = (P_ - 1) * nl * nplanes
    if ecfg.exchange == "pmin":
        return it * 2 * dense_words
    if ecfg.exchange == "a2a":
        return it * dense_words
    _, slot_cap = frontier_caps(
        pg.rows_per_rank, pg.width, nl, P_, ecfg.frontier_cap
    )
    sparse_words = (P_ - 1) * payload_plane_words(
        slot_cap, use_level, ecfg.payload
    )
    return (it - fallbacks) * sparse_words + fallbacks * dense_words


def _warn_metrics(m: WorkMetrics, ecfg: EngineConfig, pg: PartitionedGraph,
                  active: int) -> None:
    """RuntimeWarnings for truncation at max_iters and for a long run of
    consecutive sparse-capacity overflows."""
    if not m.converged:
        warnings.warn(
            f"engine hit max_iters={ecfg.max_iters} with {int(active)} "
            "pending workitems left — the returned state is truncated "
            "(monotone but not yet the fixpoint); raise max_iters or "
            "check Solution.metrics.converged",
            RuntimeWarning,
            stacklevel=4,
        )
    if (
        ecfg.exchange in ("sparse", "auto")
        and m.overflow_streak >= OVERFLOW_WARN_STREAK
    ):
        row_cap, slot_cap = frontier_caps(
            pg.rows_per_rank, pg.width, pg.n_local, pg.n_parts,
            ecfg.frontier_cap,
        )
        spec = f"{ecfg.hierarchy.name}/{ecfg.exchange}"
        warnings.warn(
            f"sparse exchange capacity overflowed on "
            f"{m.overflow_streak} consecutive supersteps (spec "
            f"{spec!r}: row_cap={row_cap}, slot_cap={slot_cap}), each "
            "falling back to the dense exchange; raise frontier_cap "
            f"(try {grow_frontier_cap(pg.rows_per_rank, row_cap)})",
            RuntimeWarning,
            stacklevel=4,
        )


def _finish_metrics(pg: PartitionedGraph, ecfg: EngineConfig, it: int,
                    commits: int, relax: int, classes: int, active: int,
                    fallbacks: int, overflow_streak: int) -> WorkMetrics:
    m = WorkMetrics(
        classes=classes,
        commits=commits,
        relaxations=relax,
        supersteps=it,
        workitems=commits,
        converged=active == 0,
        sparse_fallbacks=fallbacks,
        overflow_streak=overflow_streak,
    )
    m.exchange_bytes = exchange_words(pg, ecfg, it, fallbacks) * 4 * pg.n_parts
    m.collective_rounds = it * (
        (3 if ecfg.collect_metrics else 2)
        + (1 if ecfg.exchange in ("sparse", "auto") else 0)
    )
    _warn_metrics(m, ecfg, pg, active)
    return m


@dataclasses.dataclass(eq=False)
class Solution:
    """Result of one query: the committed state in original vertex ids,
    its metrics, and the padded state with the partition it lives in."""

    state: np.ndarray          # (n,) committed per-vertex state
    metrics: WorkMetrics
    problem: Problem
    config: SolverConfig
    padded: np.ndarray         # (P, n_local) committed state, padded
    pg: Optional[PartitionedGraph] = None


class Solver:
    """One (SolverConfig, rank count, device); problems supply graph +
    sources + processing.  The ``n_parts`` ranks are stacked on the one
    device."""

    def __init__(
        self,
        config: Union[str, SolverConfig, None] = None,
        *,
        n_parts: int = 1,
        device=None,
    ):
        self.config = as_config(config)
        if n_parts < 1:
            raise ValueError(f"n_parts must be positive: {n_parts}")
        self.n_parts = int(n_parts)
        self.device = resolve_device(device)
        # id(graph) -> (graph, fingerprint, PartitionedGraph); bounded LRU
        self._pg_cache: "OrderedDict[int, tuple]" = OrderedDict()
        self._pg_cache_size = 8

    def partition(self, graph: Union[Graph, PartitionedGraph]) -> PartitionedGraph:
        if isinstance(graph, PartitionedGraph):
            if graph.n_parts != self.n_parts:
                raise ValueError(
                    f"graph partitioned for {graph.n_parts} parts but the "
                    f"solver runs {self.n_parts} ranks"
                )
            if graph.partitioner != self.config.partition:
                raise ValueError(
                    f"graph pre-partitioned with {graph.partitioner!r} but "
                    f"config requests {self.config.partition!r}; "
                    "re-partition or pass the raw Graph"
                )
            return graph
        fp = graph_fingerprint(graph)
        hit = self._pg_cache.get(id(graph))
        if hit is not None and hit[0] is graph and hit[1] == fp:
            self._pg_cache.move_to_end(id(graph))
            return hit[2]
        pg = partition_graph(graph, self.n_parts,
                             partitioner=self.config.partition)
        self._pg_cache[id(graph)] = (graph, fp, pg)
        if len(self._pg_cache) > self._pg_cache_size:
            self._pg_cache.popitem(last=False)
        return pg

    def solve(self, problem: Problem) -> Solution:
        pg = self.partition(problem.graph)
        p = problem.processing_fn
        ecfg = self.config.engine_config(p)
        D0, T0, L0 = (
            torch.as_tensor(a, device=self.device)
            for a in initial_state(pg, p, problem.source_items())
        )
        res = run_engine(ecfg, pg.to(self.device), pg.n_local, D0, T0, L0)
        padded = res.D.cpu().numpy()
        m = _finish_metrics(
            pg, ecfg, res.supersteps, res.commits, res.relaxations,
            res.classes, res.active, res.fallbacks, res.max_streak,
        )
        return Solution(
            state=pg.unpermute(padded.reshape(-1)),
            metrics=m,
            problem=problem,
            config=self.config,
            padded=padded,
            pg=pg,
        )
