"""Landmark (hub) tier: cheap point-to-point estimates by triangle
inequality.

At startup, one ``solve_batch`` over K hub sources (highest out-degree
by default — RMAT hubs cover most shortest paths) materializes the
K×n distance matrix.  A point-to-point query (s, t) is then answered
in O(K) without touching the engine:

    lower = max_k ( d(L_k, t) - d(L_k, s) )      valid on any digraph
    upper = min_k ( d(L_k, s) + d(L_k, t) )      valid when the graph
                                                 is weight-symmetric
                                                 (rmat1/rmat2/road are)

The upper bound is the classic landmark estimate d(s,t) ≤ d(s,L)+d(L,t)
with d(s,L) read as d(L,s) — exact only under symmetry, so the index
must be built with ``symmetric=True`` to serve it; on directed graphs
only the lower bound is offered and the router escalates to an exact
solve.  ``exact=`` escalation is always available: the router routes
the query through the full single-source path (cached, batched).

Over a process backend every rank builds the index (one collective
``solve_batch``) at the same point, and its refreshes go through the
service's command stream (:mod:`repro_torch.serve.stream`), so every
rank holds the same matrix.

The landmark solutions are ordinary :class:`Solution` objects, so the
streaming-update feed refreshes them with the same self-stabilizing
warm restarts as any cached answer.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.api import Problem, SingleSource, Solver
from repro_torch.api.solver import Solution
from repro_torch.graph.formats import Graph, graph_fingerprint
from repro_torch.obs import trace as obs
from repro_torch.serve.stream import recorded, stream_for


@dataclasses.dataclass
class Estimate:
    """Point-to-point bounds from the landmark tier.  ``upper`` is the
    served estimate; ``exact`` is True when the bounds pinch (e.g. s
    or t is itself a landmark), in which case the estimate IS the
    distance."""

    source: int
    target: int
    lower: float
    upper: float

    @property
    def exact(self) -> bool:
        return self.lower == self.upper

    @property
    def servable(self) -> bool:
        """A finite upper bound serves as the estimate; lower == +inf
        proves unreachability, which serves as distance +inf."""
        return bool(np.isfinite(self.upper)) or bool(np.isinf(self.lower))


def pick_landmarks(g: Graph, k: int) -> list[int]:
    """Top-k vertices by out-degree (ties to smaller id, so the pick
    is deterministic across processes)."""
    k = min(int(k), g.n)
    deg = np.bincount(g.src, minlength=g.n)
    order = np.lexsort((np.arange(g.n), -deg))
    return [int(v) for v in order[:k]]


class LandmarkIndex:
    """K hub single-source solutions + the triangle-inequality reads.

    Build cost is one batched solve (the K sources share one engine
    invocation); serving cost is O(K) numpy per query.
    """

    def __init__(
        self,
        solver: Solver,
        graph: Graph,
        k: int = 8,
        *,
        landmarks: Optional[Sequence[int]] = None,
        symmetric: bool = False,
        processing: str = "sssp",
    ):
        self.solver = solver
        self._stream = stream_for(solver)
        self._oid = self._stream.register(self)
        self.graph = graph
        self.symmetric = bool(symmetric)
        self.processing = processing
        self.landmarks = (
            [int(v) for v in landmarks]
            if landmarks is not None
            else pick_landmarks(graph, k)
        )
        with obs.span("landmarks.build", k=len(self.landmarks)):
            self.solutions: list[Solution] = solver.solve_batch(
                [Problem(graph, SingleSource(v), processing=processing)
                 for v in self.landmarks]
            )
        self._rebuild_matrix()

    def _rebuild_matrix(self):
        self.dist = np.stack([s.state for s in self.solutions])  # (K, n)
        self.fingerprint = graph_fingerprint(self.graph)

    @property
    def k(self) -> int:
        return len(self.landmarks)

    @property
    def nbytes(self) -> int:
        return int(self.dist.nbytes)

    def estimate(self, source: int, target: int) -> Estimate:
        s, t = int(source), int(target)
        ds, dt = self.dist[:, s], self.dist[:, t]
        # d(L,t) <= d(L,s) + d(s,t)  =>  d(s,t) >= d(L,t) - d(L,s);
        # only landmarks that reach s give information
        reach = np.isfinite(ds)
        lower = 0.0
        if reach.any():
            lower = float(np.max((dt - ds)[reach], initial=0.0))
        if np.isinf(dt).all() and reach.any() and self.symmetric:
            # no landmark reaches t but one reaches s: in a symmetric
            # graph s and t are then in different components
            lower = float("inf")
        upper = float("inf")
        if self.symmetric:
            both = reach & np.isfinite(dt)
            if both.any():
                upper = float(np.min((ds + dt)[both]))
        if s == t:
            lower = upper = 0.0
        return Estimate(source=s, target=t, lower=max(lower, 0.0),
                        upper=upper)

    # -- streaming updates --------------------------------------------

    @recorded
    def refresh(self, *, warm: bool = True) -> "LandmarkIndex":
        """Re-converge every landmark solution against the (perturbed)
        graph.  ``warm=True`` uses self-stabilizing warm restarts
        (exact after improving updates); ``warm=False`` cold-solves
        (required after non-improving updates).  Falls back to cold
        per-landmark when the partition layout changed."""
        self._stream.sync()
        with obs.span("landmarks.refresh", k=self.k, warm=warm) as sp:
            if warm:
                fresh = []
                for sol in self.solutions:
                    try:
                        fresh.append(
                            self.solver.resolve(sol, graph=self.graph)
                        )
                    except ValueError:  # partition layout changed
                        warm = False
                        break
                if warm:
                    self.solutions = fresh
            if not warm:
                self.solutions = self.solver.solve_batch(
                    [Problem(self.graph, SingleSource(v),
                             processing=self.processing)
                     for v in self.landmarks]
                )
            sp.set(warm_used=warm)
        self._rebuild_matrix()
        return self
