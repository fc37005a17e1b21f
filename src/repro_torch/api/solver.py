"""Solver facade: one (config, rank count, device), many problems.

    solver = Solver("delta:5/sparse/fused")          # on the card
    sol = solver.solve(Problem(g, SingleSource(0)))
    sols = solver.solve_batch([Problem(g, SingleSource(v)) for v in vs])
    sol2 = solver.resolve(sol, graph=g_cheaper)       # warm restart

Raw :class:`Graph` inputs are partitioned over ``n_parts`` ranks once
and memoized; the ELL buffers are copied to the device once per
partition.  ``device=None`` means the card, and raises without CUDA;
``device="cpu"`` runs the plain torch path.

By default the ranks are stacked on the one device.  ``mesh`` (a
:class:`~repro_torch.launch.mesh.RankMesh`) names their axes, which
gives the ordering hierarchy's ``pod`` scope; ``ranks``, the result of
:func:`~repro_torch.launch.mesh.init_ranks`, runs one rank in each
process of a ``torch.distributed`` group instead:

    ranks = init_ranks("gloo", rank, 4, make_rank_mesh(4, pods=2), url)
    sol = Solver(spec, n_parts=4, ranks=ranks).solve(problem)

Each process then holds only its rank's share of the ELL on its
device, launches the frontier kernels for that rank, and returns the
same :class:`Solution` as every other process (the full state,
gathered).  ``solve``, ``solve_batch``, ``/adapt``, ``/trace`` and
``/q`` run on either; ``resolve`` and ``serve/`` run stacked only.

``solve_batch`` runs B queries as B lanes of one engine run (the JAX
package vmaps its loop); ``resolve`` is the self-stabilization
dividend (paper §II): after a perturbation that only improves
candidate states (weight drops, new edges, added sources) the previous
fixpoint is a valid start, and one bootstrap sweep over every edge
regenerates the candidates the perturbation improved.

``/adapt[:policy]`` and ``/trace`` specs solve in segments
(:func:`repro_torch.tune.run_adaptive`): a policy retunes Δ, the
frontier cap and the exchange between segments, and the flight
recorder keeps every superstep's window (``Solution.trace``).
``/q:{bf16,u16}`` specs exchange round-up quantized values, and a
repair loop of re-verification sweeps and exact warm restarts makes
their final state exact.  ``solve_batch`` refuses all three.
"""

from __future__ import annotations

import contextlib
import dataclasses
import warnings
from collections import OrderedDict
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.api.config import SolverConfig, as_config
from repro_torch.api.problem import ExplicitSources, Problem, as_source_spec
from repro_torch.core.engine import (
    EngineConfig,
    initial_state,
    initial_state_batch,
    run_engine,
)
from repro_torch.core.frontier import (
    frontier_caps,
    grow_frontier_cap,
    payload_plane_words,
)
from repro_torch.core.metrics import WorkMetrics
from repro_torch.core.processing import ProcessingFn
from repro_torch.core.ranks import StackedRanks
from repro_torch.device import resolve_device
from repro_torch.graph.formats import Graph, graph_fingerprint
from repro_torch.graph.partition import DeviceELL, PartitionedGraph, partition_graph
from repro_torch.launch.mesh import RankMesh, make_rank_mesh
from repro_torch.obs import trace as obs
from repro_torch.obs.recorder import FlightRecorder, SolveTrace
from repro_torch.tune.controller import run_adaptive
from repro_torch.tune.policies import StaticPolicy, make_tune_policy

# consecutive sparse-overflow supersteps before the frontier_cap warning
OVERFLOW_WARN_STREAK = 3

# hard cap on quantized-payload repair restarts (each restart strictly
# lowers some committed value, so this is a safety net, not a knob)
QUANT_REPAIR_MAX_SWEEPS = 25


def batch_bucket(b: int) -> int:
    """Round a batch size up to the next power of two: ``solve_batch``
    pads to these buckets, as the JAX package does to reuse its
    compiled engines."""
    if b < 1:
        raise ValueError(f"batch size must be positive: {b}")
    return 1 << (b - 1).bit_length()


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
            f"(try {grow_frontier_cap(pg.rows_per_rank, row_cap)}) or "
            "solve with /adapt:rho for automatic cap growth",
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
    its metrics, and the padded state with the partition it lives in
    (what ``resolve`` warm-restarts from)."""

    state: np.ndarray          # (n,) committed per-vertex state
    metrics: WorkMetrics
    problem: Problem
    config: SolverConfig
    padded: np.ndarray         # (P, n_local) committed state, padded
    pg: Optional[PartitionedGraph] = None
    # per-superstep flight record ('/trace' specs only)
    trace: Optional[SolveTrace] = None

    @property
    def graph(self):
        return self.problem.graph

    @property
    def source(self) -> Optional[int]:
        """The single source vertex, if there is exactly one."""
        items = self.problem.source_items()
        if len(items) == 1:
            return int(items[0][0])
        return None

    @property
    def nbytes(self) -> int:
        """Resident bytes of the state arrays (the serving cache's unit)."""
        return int(self.state.nbytes) + int(self.padded.nbytes)

    def distance_to(self, v: int) -> float:
        """Committed state at vertex ``v`` (for SSSP the distance)."""
        if not 0 <= int(v) < self.state.shape[0]:
            raise ValueError(
                f"vertex {v} outside [0, {self.state.shape[0]})"
            )
        return float(self.state[int(v)])


class Solver:
    """One (SolverConfig, rank count, device); problems supply graph +
    sources + processing.  The ``n_parts`` ranks are stacked on the one
    device, over ``mesh`` (default: one flat axis), unless ``ranks``
    puts one rank in each process (the module docstring)."""

    def __init__(
        self,
        config: Union[str, SolverConfig, None] = None,
        *,
        n_parts: int = 1,
        device=None,
        mesh: Optional[RankMesh] = None,
        ranks=None,
    ):
        self.config = as_config(config)
        if n_parts < 1:
            raise ValueError(f"n_parts must be positive: {n_parts}")
        self.n_parts = int(n_parts)
        if ranks is not None:
            if mesh is not None and mesh != ranks.mesh:
                raise ValueError(f"mesh {mesh} differs from the process "
                                 f"group's {ranks.mesh}")
            mesh = ranks.mesh
        mesh = make_rank_mesh(self.n_parts) if mesh is None else mesh
        if mesh.size != self.n_parts:
            raise ValueError(f"mesh {mesh.shape} holds {mesh.size} ranks, "
                             f"the solver runs {self.n_parts}")
        self.mesh = mesh
        self.ranks = StackedRanks(mesh) if ranks is None else ranks
        self.device = resolve_device(device)
        # id(graph) -> (graph, fingerprint, PartitionedGraph); bounded LRU
        self._pg_cache: "OrderedDict[int, tuple]" = OrderedDict()
        self._pg_cache_size = 8
        # adaptive-solve counters ('/adapt' specs only)
        self._adapt_stats = dict(
            solves=0, segments=0, retraces=0, cap_growths=0
        )

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
            obs.event("partition_memo_hit", n=graph.n)
            return hit[2]
        with obs.span("solver.partition", n=graph.n, m=graph.m,
                      partitioner=self.config.partition,
                      n_parts=self.n_parts):
            pg = partition_graph(graph, self.n_parts,
                                 partitioner=self.config.partition)
        self._pg_cache[id(graph)] = (graph, fp, pg)
        if len(self._pg_cache) > self._pg_cache_size:
            self._pg_cache.popitem(last=False)
        return pg

    def stats(self) -> dict:
        """The partition memo's occupancy and the adaptive solves'
        counters.  The port runs its engine eagerly and keeps no
        compiled-engine cache, so there are no engine-cache counters."""
        return dict(
            partition_memo_size=len(self._pg_cache),
            partition_memo_capacity=self._pg_cache_size,
            adapt=dict(self._adapt_stats),
        )

    @property
    def stacked(self) -> bool:
        """True iff every rank runs in this process."""
        return self.ranks.rank is None

    def require_stacked(self, what: str) -> None:
        """Refuse ``what`` on a process backend, which it does not run."""
        if not self.stacked:
            raise ValueError(
                f"{what} runs on stacked ranks only: over a process "
                "backend it waits for ROADMAP.md Queue 1 item 1 (resolve "
                "and serve/ over ProcessRanks); use a Solver without "
                "ranks=")

    def device_ell(self, pg: PartitionedGraph) -> DeviceELL:
        """The ELL of the ranks this process runs, on its device."""
        return pg.to(self.device, rank=self.ranks.rank)

    def _state(self, planes):
        return tuple(torch.as_tensor(self.ranks.local_ranks(a),
                                     device=self.device) for a in planes)

    def _gather(self, D: torch.Tensor, dim: int = 0) -> np.ndarray:
        """The committed state of every rank, on the host."""
        return self.ranks.gather(D, dim).cpu().numpy()

    def solve(self, problem: Problem) -> Solution:
        with obs.span("solver.solve", spec=self.config.name) as sp:
            pg = self.partition(problem.graph)
            p = problem.processing_fn
            ecfg = self.config.engine_config(p)
            D0, T0, L0 = self._state(
                initial_state(pg, p, problem.source_items()))
            sol = self._run(problem, pg, ecfg, D0, T0, L0, engine_span=True)
            sp.set(supersteps=sol.metrics.supersteps,
                   converged=sol.metrics.converged)
            return sol

    def solve_batch(self, problems: Sequence[Problem]) -> list[Solution]:
        """Solve B queries on one graph as B lanes of one engine run: the
        graph is resident once and each superstep launches its frontier
        kernel once for every lane.  All problems must share the graph
        and the processing function.  Each lane's state and metrics are
        those of the JAX package's vmapped engine: a converged lane
        stops counting while the others run.

        The batch is padded to the next power of two (duplicating the
        last problem); the padding lanes are solved and dropped."""
        if not problems:
            return []
        if len(problems) == 1:
            return [self.solve(problems[0])]
        if self.config.adapt is not None:
            raise ValueError(
                "solve_batch does not support adaptive specs (/adapt): "
                "the controller would steer every lane with one "
                "shared schedule; use a static spec for batches or "
                "solve adaptive queries one at a time"
            )
        if self.config.payload != "exact":
            raise ValueError(
                "solve_batch does not support quantized payloads "
                "(/q:...): the exact repair loop re-verifies and "
                "restarts per query; use an exact payload for batches "
                "or solve quantized queries one at a time"
            )
        if self.config.trace:
            raise ValueError(
                "solve_batch does not support the flight recorder "
                "(/trace): the batched engine publishes no per-lane "
                "superstep windows; trace queries one at a time"
            )
        g0 = problems[0].graph
        p = problems[0].processing_fn
        for q in problems[1:]:
            if q.graph is not g0:
                raise ValueError("solve_batch: all problems must share a graph")
            if q.processing_fn is not p:
                raise ValueError(
                    "solve_batch: all problems must share a processing fn"
                )
        pg = self.partition(g0)
        B = len(problems)
        Bpad = batch_bucket(B)
        items = [q.source_items() for q in problems]
        items += [items[-1]] * (Bpad - B)
        ecfg = self.config.engine_config(p)
        D0, T0, L0 = self._state(initial_state_batch(pg, p, items))
        with obs.span("solver.solve_batch", spec=self.config.name,
                      batch=B, batch_padded=Bpad):
            res = run_engine(ecfg, self.device_ell(pg), pg.n_local, D0, T0, L0,
                             self.ranks)
        D = self._gather(res.D, 1)  # (Bpad, P, n_local)
        return [
            self._pack(problems[b], pg, ecfg, D[b], *(c[b] for c in res[1:]))
            for b in range(B)
        ]

    def resolve(
        self,
        prev: Solution,
        new_sources=None,
        *,
        graph: Union[Graph, PartitionedGraph, None] = None,
    ) -> Solution:
        """Warm restart from a prior solution (paper §II: the kernel is
        self-stabilizing, so any state pointwise no better than the new
        fixpoint is a correct start).  ``graph`` supplies the perturbed
        graph (default: the previous one); ``new_sources`` adds initial
        workitems.

        One bootstrap sweep, Algorithm 1's re-verification step,
        relaxes every out-edge of the committed prior state on the
        solver's device; the engine then drains only the candidates the
        perturbation improved.  Correct whenever the prior state
        dominates the new fixpoint (weight decreases, edge or source
        additions); cold-solve after weight increases or deletions."""
        self.require_stacked("resolve")
        with obs.span("solver.resolve", spec=self.config.name) as sp:
            return self._resolve(prev, new_sources, graph, sp)

    def _resolve(self, prev, new_sources, graph, sp) -> Solution:
        graph = prev.problem.graph if graph is None else graph
        p = prev.problem.processing_fn
        spec = (
            as_source_spec(new_sources)
            if new_sources is not None
            else ExplicitSources(())
        )
        problem = Problem(
            graph=graph, sources=spec, processing=prev.problem.processing
        )
        pg = self.partition(graph)
        if prev.padded.shape != (pg.n_parts, pg.n_local):
            raise ValueError(
                "resolve: previous solution was computed on a different "
                f"partition shape {prev.padded.shape} != "
                f"{(pg.n_parts, pg.n_local)}"
            )
        if prev.pg is not None and not prev.pg.same_layout(pg):
            # `padded` is in the relabeled slot space: a changed
            # ownership map would seed the wrong vertices
            raise ValueError(
                "resolve: the partition layout changed between the "
                f"previous solution ({prev.pg.partitioner}) and the "
                f"new graph ({pg.partitioner}); cold-solve instead"
            )
        ecfg = self.config.engine_config(p)
        ell = self.device_ell(pg)
        committed = torch.as_tensor(prev.padded, dtype=torch.float32,
                                    device=self.device)
        # the committed prior state, with the per-rank dummy slot restored
        worst_col = torch.full((pg.n_parts, 1), float(p.worst),
                               dtype=torch.float32, device=self.device)
        D0 = torch.cat([committed, worst_col], dim=1)
        with obs.span("solver.bootstrap_sweep", m=pg.m):
            T_full = _bootstrap_candidates(ell, pg.n_local, p, committed,
                                           self.ranks).reshape(-1)
        for v, s, _ in problem.source_items():
            pid = int(pg.padded_id(int(v)))  # owner map: original -> slot
            T_full[pid] = p.reduce(T_full[pid],
                                   torch.tensor(s, dtype=torch.float32))
        T0 = torch.cat([T_full.reshape(pg.n_parts, pg.n_local), worst_col],
                       dim=1)
        # warm items restart the KLA level attribute at 0 (a fresh wave)
        L0 = torch.where(p.better(T0, D0), 0.0, float("inf"))
        sol = self._run(problem, pg, ecfg, D0, T0, L0, engine_span=False)
        # the bootstrap sweep: one superstep's worth of full-graph
        # relaxation, outside the engine
        sol.metrics.relaxations += pg.m
        sol.metrics.supersteps += 1
        if sol.trace is not None:
            # the sweep has no engine superstep window; count it so
            # SolveTrace.reconcile still balances against the metrics
            sol.trace.host_sweeps += 1
        sp.set(supersteps=sol.metrics.supersteps,
               converged=sol.metrics.converged)
        return sol

    def _run(self, problem, pg, ecfg, D0, T0, L0, engine_span) -> Solution:
        """Solve from the (P, n_local+1) state on the solver's device:
        the segment engine for ``/adapt`` and ``/trace``, the repair
        loop for ``/q``, else one engine run (in a ``solver.engine``
        span if ``engine_span``, as the JAX package's ``solve`` has)."""
        if ecfg.adapt_window > 0:
            return self._solve_adaptive(problem, pg, ecfg, D0, T0, L0)
        if ecfg.payload != "exact":
            return self._solve_quantized(problem, pg, ecfg, D0, T0, L0)
        with obs.span("solver.engine") if engine_span else contextlib.nullcontext():
            res = run_engine(ecfg, self.device_ell(pg), pg.n_local, D0, T0, L0,
                             self.ranks)
        return self._pack(problem, pg, ecfg, self._gather(res.D), *res[1:])

    def _solve_adaptive(self, problem, pg, ecfg, D0, T0, L0) -> Solution:
        """Segmented solve: ``/adapt`` (a fresh policy instance a solve
        retunes the tunables between segments), ``/trace`` (the static
        policy, only to publish the superstep windows the flight
        recorder gathers into ``Solution.trace``), or both."""
        if self.config.adapt is not None:
            policy = make_tune_policy(self.config.adapt)
        else:  # pure /trace: observe without intervening
            policy = StaticPolicy()
        recorder = (
            FlightRecorder(self.config.name) if self.config.trace else None
        )
        D, m, report = run_adaptive(
            ecfg, pg, self.device_ell(pg), policy, D0, T0, L0,
            on_window=recorder.on_window if recorder is not None else None,
            ranks=self.ranks,
        )
        if self.config.adapt is not None:
            st = self._adapt_stats
            st["solves"] += 1
            st["segments"] += report.segments
            st["retraces"] += report.retraces
            st["cap_growths"] += report.cap_growths
        padded = self._gather(D)
        return Solution(
            state=pg.unpermute(padded.reshape(-1)),
            metrics=m,
            problem=problem,
            config=self.config,
            padded=padded,
            pg=pg,
            trace=recorder.finish(m) if recorder is not None else None,
        )

    def _solve_quantized(self, problem, pg, ecfg, D0, T0, L0) -> Solution:
        """Quantized-payload (``/q:...``) solve and its exact repair loop.

        The quantized exchange only inflates candidates (round-up codes;
        a code that fails its sender's check decodes to +inf), so the
        engine converges to a state pointwise >= the exact fixpoint,
        with the initial workitems committed exactly.  A
        re-verification sweep (``_bootstrap_candidates``, on the
        device) then either certifies it (no edge improves a committed
        value, which with exact initial commits pins the least
        fixpoint) or seeds an exact warm restart from the improving
        candidates.  Each restart strictly lowers some committed value,
        so the loop ends; the final state equals an exact solve's.
        Each sweep counts as one superstep of ``m`` relaxations that
        moves no exchange bytes (the word model's; a process backend
        moves its candidates to their owners in one all-to-all)."""
        p = problem.processing_fn
        ell = self.device_ell(pg)
        nl = pg.n_local
        ranks = self.ranks
        res = run_engine(ecfg, ell, nl, D0, T0, L0, ranks)
        D, active = res.D, res.active
        it_t, commits_t, relax_t, classes_t = res[1:5]
        fallbacks_t, streak_max = res.fallbacks, res.max_streak
        worst_col = torch.full((ranks.local, 1), float(p.worst),
                               dtype=torch.float32, device=self.device)
        sweeps = verifies = 0
        while active == 0:  # a truncated run skips the repair (warned)
            T_full = _bootstrap_candidates(ell, nl, p, D, ranks)
            verifies += 1
            improving = ranks.sum(p.better(T_full, D).sum().reshape(1))
            if not int(improving):
                break  # certified: the exact least fixpoint
            if sweeps >= QUANT_REPAIR_MAX_SWEEPS:
                warnings.warn(
                    f"quantized repair loop hit {QUANT_REPAIR_MAX_SWEEPS} "
                    "restarts without certifying the exact fixpoint; the "
                    "returned state may retain inflated values",
                    RuntimeWarning,
                    stacklevel=3,
                )
                break
            sweeps += 1
            obs.event("repair_sweep", sweep=sweeps)
            D0r = torch.cat([D, worst_col], dim=1)
            T0r = torch.cat([T_full, worst_col], dim=1)
            L0r = torch.where(p.better(T0r, D0r), 0.0, float("inf"))
            res = run_engine(ecfg, ell, nl, D0r, T0r, L0r, ranks)
            D, active = res.D, res.active
            it_t += res.supersteps
            commits_t += res.commits
            relax_t += res.relaxations
            classes_t += res.classes
            fallbacks_t += res.fallbacks
            streak_max = max(streak_max, res.max_streak)
        m = _finish_metrics(pg, ecfg, it_t, commits_t, relax_t, classes_t,
                            active, fallbacks_t, streak_max)
        m.relaxations += pg.m * verifies
        m.supersteps += verifies
        m.repair_sweeps = sweeps
        padded = self._gather(D)
        return Solution(
            state=pg.unpermute(padded.reshape(-1)),
            metrics=m,
            problem=problem,
            config=self.config,
            padded=padded,
            pg=pg,
        )

    def _pack(self, problem, pg, ecfg, padded, it, commits, relax, classes,
              active, fallbacks, overflow_streak) -> Solution:
        m = _finish_metrics(
            pg, ecfg, it, commits, relax, classes, active, fallbacks,
            overflow_streak,
        )
        return Solution(
            state=pg.unpermute(padded.reshape(-1)),
            metrics=m,
            problem=problem,
            config=self.config,
            padded=padded,
            pg=pg,
        )


def _bootstrap_candidates(ell: DeviceELL, n_local: int, p: ProcessingFn,
                          committed: torch.Tensor,
                          ranks=None) -> torch.Tensor:
    """One synchronous relaxation of every out-edge of ``committed``
    (the local ranks' (P_loc, n_local) state, on the ELL's device): the
    self-stabilizing kernel's re-verification sweep.  Each local rank
    scatters its candidates over all n_pad vertices, and one all-to-all
    with a combine brings them to their owners.  Returns the local
    ranks' (P_loc, n_local) candidates to seed T with.  A min or max
    does not depend on order, so this equals the JAX package's host
    sweep bit for bit.  ``ranks`` as the engine's (None: stacked)."""
    row_src, col, wgt, _ = ell
    P_loc, R, _ = col.shape
    if ranks is None:
        ranks = StackedRanks(P_loc)
    n_pad = ranks.world * n_local
    dev = committed.device
    worst_col = torch.full((P_loc, 1), float(p.worst), dtype=torch.float32,
                           device=dev)
    state_ext = torch.cat([committed, worst_col], dim=1)  # dummy slot n_local
    src_state = torch.gather(state_ext, 1, row_src.to(torch.int64))  # (P, R)
    cand = p.edge_update(src_state[..., None], wgt).expand(col.shape)
    # the padding of row r goes to a spill column of its own, n_pad + r,
    # dropped after (core/frontier.py)
    spill = torch.arange(n_pad, n_pad + R, device=dev).reshape(R, 1)
    idx = torch.where(col == n_pad, spill, col)
    buf = torch.full((P_loc, n_pad + R), float(p.worst),
                     dtype=torch.float32, device=dev)
    buf.scatter_reduce_(1, idx.reshape(P_loc, -1), cand.reshape(P_loc, -1),
                        p.scatter_op)
    X = ranks.all_to_all(
        buf[None, :, :n_pad].reshape(1, P_loc, ranks.world, n_local))
    return p.reduce_array(X, 2)[0]
