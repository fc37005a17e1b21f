"""Streaming graph updates with self-stabilizing freshness.

The paper's self-stabilization guarantee is a *serving* primitive:
after a perturbation that only improves candidate states — an edge
insertion or a weight drop — the previous fixpoint is a valid warm
start, and ``Solver.resolve`` re-converges in a few supersteps.  The
feed exploits exactly that dichotomy:

* **improving** updates (insert edge, lower a weight): apply to the
  live graph, advance the hash-chained fingerprint in O(1) (no full
  edge-list rehash), and refresh every cached solution (and the
  landmark tier) via warm restarts — *exact*, not approximate, by
  self-stabilization.
* **non-improving** updates (raise a weight, delete an edge): the
  cached states may sit above the new fixpoint, which the monotone
  engine cannot correct — stale entries are invalidated and refreshed
  by cold solves (eagerly, or lazily on the next query miss).

Either way, the fingerprint advance makes stale cache entries
unreachable *before* any refresh runs, so correctness never depends
on the refresh policy.  A layout change under a data-dependent
partitioner (``ebal`` boundaries moving) downgrades warm refreshes to
cold solves automatically (``resolve`` raises, the feed catches).

Over a process backend an update goes out from rank 0 in stream order
(:mod:`repro_torch.serve.stream`); every rank applies it to its own
copy of the graph, re-partitions it and takes its own share of the ELL
(``Solver.device_ell``) in the refreshes' solves.

Edge deletion is implemented as weight := +inf (min-plus identity):
the ELL shape is untouched and the edge stops contributing to any
path, which is equivalent to removal for every registered semiring.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Optional

import numpy as np

from repro_torch.api import Problem, SingleSource, Solver
from repro_torch.graph.formats import Graph, chain_fingerprint, graph_fingerprint
from repro_torch.obs import trace as obs
from repro_torch.serve.cache import SolutionCache
from repro_torch.serve.landmarks import LandmarkIndex
from repro_torch.serve.stream import recorded, stream_for

INF = float("inf")


@dataclasses.dataclass(frozen=True)
class EdgeUpdate:
    """One streamed mutation: set the weight of edge (src, dst) to
    ``weight`` (inserting it if absent), or delete it
    (``delete=True``)."""

    src: int
    dst: int
    weight: float = 1.0
    delete: bool = False

    def record(self) -> bytes:
        """Canonical byte encoding for the fingerprint hash-chain."""
        return struct.pack(
            "<cqqd", b"D" if self.delete else b"U",
            int(self.src), int(self.dst), float(self.weight),
        )


@dataclasses.dataclass
class UpdateResult:
    update: EdgeUpdate
    improving: bool
    inserted: bool              # the edge did not exist before
    fingerprint: tuple          # the graph's fingerprint after the update
    warm_refreshes: int = 0
    cold_refreshes: int = 0
    invalidated: int = 0
    warm_supersteps: int = 0    # summed over warm refreshes
    cold_supersteps: int = 0    # summed over cold refreshes


@dataclasses.dataclass
class FeedStats:
    updates: int = 0
    improving: int = 0
    non_improving: int = 0
    insertions: int = 0
    warm_refreshes: int = 0
    cold_refreshes: int = 0
    invalidated: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class UpdateFeed:
    """Applies :class:`EdgeUpdate` records to a live graph and keeps
    the serving caches fresh.

    ``refresh='eager'`` re-converges every cached entry immediately
    (warm for improving updates, cold otherwise); ``refresh='lazy'``
    only invalidates — the next query on each source cold-solves via
    the normal miss path.  Both are exact; eager trades update latency
    for query latency.
    """

    def __init__(
        self,
        graph: Graph,
        solver: Solver,
        *,
        cache: Optional[SolutionCache] = None,
        landmarks: Optional[LandmarkIndex] = None,
        refresh: str = "eager",
    ):
        if refresh not in ("eager", "lazy"):
            raise ValueError(
                f"refresh must be 'eager' or 'lazy', got {refresh!r}"
            )
        self.graph = graph
        self.solver = solver
        self.cache = cache
        self.landmarks = landmarks
        self.refresh = refresh
        self.stats = FeedStats()
        self._stream = stream_for(solver)
        self._oid = self._stream.register(self)

    # -- the one entry point ------------------------------------------

    @recorded
    def apply(self, upd: EdgeUpdate) -> UpdateResult:
        self._stream.sync()  # every rank applies it, in stream order
        with obs.span("feed.apply", src=upd.src, dst=upd.dst,
                      delete=upd.delete) as sp:
            res = self._apply(upd)
            sp.set(improving=res.improving, inserted=res.inserted,
                   warm_refreshes=res.warm_refreshes,
                   cold_refreshes=res.cold_refreshes,
                   invalidated=res.invalidated)
            return res

    def _apply(self, upd: EdgeUpdate) -> UpdateResult:
        g = self.graph
        fp_old = graph_fingerprint(g)
        u, v, w = int(upd.src), int(upd.dst), float(upd.weight)
        if not (0 <= u < g.n and 0 <= v < g.n):
            raise ValueError(
                f"edge ({u}, {v}) outside vertex range [0, {g.n})"
            )
        slots = np.flatnonzero((g.src == u) & (g.dst == v))
        inserted = slots.size == 0

        if upd.delete:
            if inserted:  # deleting a non-edge: no-op, fingerprint still
                pass      # advances (the record happened)
            else:
                g.weight[slots] = np.float32(INF)
            improving = False
        elif inserted:
            if w < 0:
                raise ValueError(f"negative edge weight {w}")
            g.src = np.append(g.src, np.int32(u))
            g.dst = np.append(g.dst, np.int32(v))
            g.weight = np.append(g.weight, np.float32(w))
            improving = True
        else:
            if w < 0:
                raise ValueError(f"negative edge weight {w}")
            old_min = float(g.weight[slots].min())
            g.weight[slots] = np.float32(w)
            # a weight drop only improves path candidates; equality is
            # a no-op but safe to treat as improving (resolve of an
            # unperturbed graph converges immediately)
            improving = w <= old_min

        fp_new = chain_fingerprint(g, upd.record())
        res = UpdateResult(
            update=upd, improving=improving, inserted=inserted,
            fingerprint=fp_new,
        )
        self.stats.updates += 1
        self.stats.improving += int(improving)
        self.stats.non_improving += int(not improving)
        self.stats.insertions += int(inserted)
        self._refresh_cache(fp_old, fp_new, improving, res)
        self._refresh_landmarks(improving)
        return res

    # -- refresh policies ---------------------------------------------

    def _refresh_cache(self, fp_old, fp_new, improving, res: UpdateResult):
        if self.cache is None:
            return
        entries = self.cache.entries_for(fp_old)
        if not entries:
            return
        with obs.span("feed.refresh_cache", entries=len(entries),
                      improving=improving, policy=self.refresh):
            self._refresh_cache_entries(
                fp_old, fp_new, improving, res, entries
            )

    def _refresh_cache_entries(self, fp_old, fp_new, improving,
                               res: UpdateResult, entries):
        if self.refresh == "lazy" or not improving:
            res.invalidated = self.cache.invalidate_graph(fp_old)
            self.stats.invalidated += res.invalidated
            if self.refresh == "lazy":
                return
            if not improving:
                # eager cold refresh: re-solve each previously cached
                # source from scratch (bit-identical to a fresh solve —
                # it IS a fresh solve)
                for key, _ in entries:
                    sol = self.solver.solve(Problem(
                        self.graph, SingleSource(key[1]),
                        processing=key[3],
                    ))
                    self.cache.put(
                        SolutionCache.key_for(fp_new, key[1], key[2],
                                              key[3]),
                        sol,
                    )
                    res.cold_refreshes += 1
                    res.cold_supersteps += sol.metrics.supersteps
                self.stats.cold_refreshes += res.cold_refreshes
            return
        # improving: warm-restart every cached entry — exact by
        # self-stabilization, a few supersteps each
        for key, prev in entries:
            self.cache.pop(key)
            try:
                sol = self.solver.resolve(prev, graph=self.graph)
                res.warm_refreshes += 1
                res.warm_supersteps += sol.metrics.supersteps
            except ValueError:
                # partition layout changed (data-dependent partitioner
                # moved its boundaries) — warm start is unsound, fall
                # back to a cold solve
                obs.event("feed.warm_fallback", source=key[1])
                sol = self.solver.solve(Problem(
                    self.graph, SingleSource(key[1]), processing=key[3],
                ))
                res.cold_refreshes += 1
                res.cold_supersteps += sol.metrics.supersteps
            self.cache.put(
                SolutionCache.key_for(fp_new, key[1], key[2], key[3]),
                sol,
            )
        self.stats.warm_refreshes += res.warm_refreshes
        self.stats.cold_refreshes += res.cold_refreshes

    def _refresh_landmarks(self, improving: bool):
        if self.landmarks is not None:
            self.landmarks.refresh(warm=improving)
