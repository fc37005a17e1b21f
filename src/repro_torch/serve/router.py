"""Request router: admission batching over the solver.

One batched solve answers B queries with one engine run, whose frontier
kernel launches once a superstep for all B lanes, so the router turns
an irregular query stream into batches.  Admission is pad/timeout
batching:

* queries accumulate in an admission queue;
* a flush fires when ``max_batch`` distinct uncached sources are
  pending (size trigger) or the oldest pending query has waited
  ``max_wait_s`` (latency trigger, checked by :meth:`pump`);
* the flush dedupes sources, serves cache hits, batch-solves the
  misses (``Solver.solve_batch`` pads to a power-of-two bucket), and
  resolves every waiting ticket.

Query kinds:

* single-source (``target=None``): the full distance vector.
* point-to-point exact: the source's single-source solution (cached,
  batched) read at ``target``.
* point-to-point ``exact=False``: answered from the landmark tier in
  O(K) with triangle-inequality bounds, no engine invocation; if the
  index can't bound it (no index, directed graph, unreachable hubs)
  the query silently escalates to the exact path.

When constructed with a ``tuned`` :class:`repro_torch.tune.TunedSpecCache`,
admission consults it per flush: if the current graph's fingerprint
has a tuned record whose spec differs from the default solver's, the
flush solves with a memoized solver built from the tuned spec (same
rank count and device) and keys the solution cache under the tuned
config's name, so tuned and default answers never alias.
Fingerprints are hash-chain aware, so a streamed update falls back to
the default solver until the mutated graph is re-tuned.

Over a process backend (``Solver(..., ranks=)``) rank 0 admits, batches
and times the queries and every other rank replays its calls
(:mod:`repro_torch.serve.stream`): rank 0 calls :meth:`Router.close`
when done, the others :meth:`Router.follow`.

The router is synchronous and single-threaded by design — the engine
itself is the concurrency (one batched solve serves B queries); an
injectable ``clock`` makes the timeout trigger testable without
sleeping.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import TYPE_CHECKING, Callable, Optional, Sequence

from repro_torch.api import Problem, SingleSource, Solver
from repro_torch.api.solver import Solution
from repro_torch.core.metrics import LatencyStats
from repro_torch.graph.formats import Graph, graph_fingerprint
from repro_torch.obs import trace as obs
from repro_torch.serve.cache import SolutionCache
from repro_torch.serve.landmarks import LandmarkIndex
from repro_torch.serve.stream import recorded, stream_for

if TYPE_CHECKING:  # pragma: no cover - import cycle guard
    from repro_torch.tune.autotune import TunedSpecCache


@dataclasses.dataclass(frozen=True)
class Query:
    """One serving request.  ``target=None`` asks for the full
    single-source state; otherwise a point-to-point distance, exact
    (engine) or estimated (landmark tier) per ``exact``."""

    source: int
    target: Optional[int] = None
    exact: bool = True
    processing: str = "sssp"


@dataclasses.dataclass
class Answer:
    query: Query
    distance: Optional[float]       # point-to-point result (or estimate)
    solution: Optional[Solution]    # full solution (single-source/exact)
    served_by: str                  # 'cache' | 'batch' | 'landmark'
    latency_s: float = 0.0
    lower: Optional[float] = None   # landmark bounds, when estimated
    upper: Optional[float] = None

    @property
    def estimated(self) -> bool:
        return self.served_by == "landmark"


class Ticket:
    """Handle for a submitted query; resolved at flush time.  Calling
    :meth:`result` before the batch filled forces a flush (a caller
    blocking on its answer is the ultimate latency trigger).  ``qid``
    is the router-assigned correlation key: the submit event, the
    flush span that served the ticket, and the solve spans under it
    all carry it, so a p99 outlier can be traced to its batch and
    spec."""

    def __init__(self, router: "Router", query: Query, t_submit: float,
                 qid: int = 0):
        self._router = router
        self.query = query
        self.t_submit = t_submit
        self.qid = qid
        self.answer: Optional[Answer] = None

    @property
    def done(self) -> bool:
        return self.answer is not None

    def result(self) -> Answer:
        if self.answer is None:
            self._router.flush()
        assert self.answer is not None
        return self.answer


@dataclasses.dataclass
class RouterStats:
    queries: int = 0
    batches: int = 0
    batched_solves: int = 0     # uncached sources actually solved
    landmark_served: int = 0
    escalations: int = 0        # estimate queries the index couldn't bound
    tuned_batches: int = 0      # flushes served by a tuned-spec solver
    latency_evictions: int = 0  # samples aged out of the latency ring

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class Router:
    def __init__(
        self,
        solver: Solver,
        graph: Graph,
        *,
        cache: Optional[SolutionCache] = None,
        landmarks: Optional[LandmarkIndex] = None,
        tuned: Optional["TunedSpecCache"] = None,
        max_batch: int = 8,
        max_wait_s: float = 0.01,
        clock: Callable[[], float] = time.monotonic,
        latency_window: int = 1024,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be positive: {max_batch}")
        if latency_window < 1:
            raise ValueError(
                f"latency_window must be positive: {latency_window}"
            )
        self.solver = solver
        self.graph = graph
        self.cache = cache if cache is not None else SolutionCache()
        self.landmarks = landmarks
        self.tuned = tuned
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_s)
        self.clock = clock
        self.stats = RouterStats()
        self._pending: list[Ticket] = []
        # bounded ring of recent per-answer latencies: stats() summaries
        # stay O(window) however long the router lives; ring overflow is
        # counted, not silent
        self._latency: deque = deque(maxlen=int(latency_window))
        self._qids = 0
        self._tuned_solvers: dict = {}  # tuned spec -> memoized Solver
        self._stream = stream_for(solver)
        self._oid = self._stream.register(self)

    # -- the process backend's command stream -------------------------

    def follow(self) -> list:
        """On a rank other than 0 of a process backend: replay rank 0's
        service calls until it closes; returns the tickets of the
        replayed submits, in order."""
        return [r for name, r in self._stream.follow() if name == "submit"]

    def close(self) -> None:
        """On rank 0 of a process backend: end the other ranks'
        :meth:`follow` (a no-op on stacked ranks)."""
        self._stream.close()

    # -- admission ----------------------------------------------------

    @recorded
    def submit(self, query: Query) -> Ticket:
        self._qids += 1
        ticket = Ticket(self, query, self.clock(), qid=self._qids)
        self.stats.queries += 1
        obs.event("router.submit", qid=ticket.qid, source=query.source,
                  exact=query.exact)
        if self._try_landmark(ticket):
            return ticket
        self._pending.append(ticket)
        if self._distinct_misses() >= self.max_batch:
            self.flush()
        return ticket

    def _record_latency(self, latency_s: float) -> None:
        if len(self._latency) == self._latency.maxlen:
            self.stats.latency_evictions += 1
        self._latency.append(float(latency_s))

    def latency_stats(self) -> LatencyStats:
        """Order statistics over the retained latency ring (at most
        ``latency_window`` recent answers; older samples are evicted
        and counted in ``stats.latency_evictions``)."""
        return LatencyStats.from_samples(self._latency)

    def pump(self) -> bool:
        """The latency trigger: flush if the oldest pending query has
        waited past ``max_wait_s``.  Returns True if a flush fired.
        Call from the serving loop between arrivals."""
        if self._pending and (
            self.clock() - self._pending[0].t_submit >= self.max_wait_s
        ):
            self.flush()
            return True
        return False

    def serve(self, queries: Sequence[Query]) -> list[Answer]:
        """Convenience batch entry: submit everything, flush, return
        answers in submission order."""
        tickets = [self.submit(q) for q in queries]
        self.flush()
        return [t.result() for t in tickets]

    # -- flush --------------------------------------------------------

    @recorded
    def flush(self) -> int:
        """Serve every pending ticket now.  Returns how many were
        answered."""
        tickets, self._pending = self._pending, []
        if not tickets:
            return 0
        self._stream.sync()  # the other ranks solve this flush with us
        self.stats.batches += 1
        with obs.span("router.flush", batch=len(tickets),
                      qids=[t.qid for t in tickets]) as sp:
            fp = graph_fingerprint(self.graph)
            solver = self._solver_for(fp)
            if solver is not self.solver:
                self.stats.tuned_batches += 1
            cfg_name = solver.config.name
            sp.set(spec=cfg_name, tuned=solver is not self.solver)

            # one solution per distinct (source, processing); cache first
            need: dict = {}
            sols: dict = {}
            hit: dict = {}
            for t in tickets:
                q = t.query
                skey = (q.source, q.processing)
                if skey in sols or skey in need:
                    continue
                ckey = SolutionCache.key_for(fp, q.source, cfg_name,
                                             q.processing)
                cached = self.cache.get(ckey)
                if cached is not None:
                    sols[skey] = cached
                    hit[skey] = True
                else:
                    need[skey] = ckey
            for group in self._by_processing(need):
                problems = [
                    Problem(self.graph, SingleSource(src), processing=proc)
                    for (src, proc) in group
                ]
                if solver.config.adapt is not None and len(problems) > 1:
                    # adaptive solves do not batch (segment engine): serve
                    # the flush one query at a time
                    solved = [solver.solve(pb) for pb in problems]
                else:
                    solved = solver.solve_batch(problems)
                self.stats.batched_solves += len(solved)
                for (skey, sol) in zip(group, solved):
                    self.cache.put(need[skey], sol)
                    sols[skey] = sol
                    hit[skey] = False
                    obs.event("router.cache_fill", source=skey[0],
                              bytes=sol.nbytes)
            sp.set(cache_hits=sum(1 for h in hit.values() if h),
                   solved=len(need))

            now = self.clock()
            for t in tickets:
                q = t.query
                sol = sols[(q.source, q.processing)]
                t.answer = Answer(
                    query=q,
                    distance=(sol.distance_to(q.target)
                              if q.target is not None else None),
                    solution=sol,
                    served_by=("cache" if hit[(q.source, q.processing)]
                               else "batch"),
                    latency_s=now - t.t_submit,
                )
                self._record_latency(t.answer.latency_s)
            return len(tickets)

    # -- internals ----------------------------------------------------

    def _solver_for(self, fp) -> Solver:
        """The solver this flush uses: the tuned-spec solver when the
        tuned cache has a record for the graph's current fingerprint
        whose spec differs from the default's, else the default.  Tuned
        solvers are memoized per spec (their partition memos live on
        the Solver)."""
        if self.tuned is None:
            return self.solver
        rec = self.tuned.get(fp)
        if rec is None or rec.spec == self.solver.config.name:
            return self.solver
        s = self._tuned_solvers.get(rec.spec)
        if s is None:
            base = self.solver
            s = Solver(rec.spec, n_parts=base.n_parts, device=base.device,
                       mesh=base.mesh,
                       ranks=None if base.stacked else base.ranks)
            self._tuned_solvers[rec.spec] = s
        return s

    def _try_landmark(self, ticket: Ticket) -> bool:
        q = ticket.query
        if (q.exact or q.target is None or self.landmarks is None
                or q.processing != self.landmarks.processing):
            return False
        est = self.landmarks.estimate(q.source, q.target)
        if not est.servable:
            self.stats.escalations += 1
            obs.event("router.landmark_escalation", qid=ticket.qid,
                      source=q.source, target=q.target)
            return False  # escalate to the exact path
        self.stats.landmark_served += 1
        obs.event("router.landmark_served", qid=ticket.qid,
                  source=q.source, target=q.target)
        ticket.answer = Answer(
            query=q,
            distance=est.upper,
            solution=None,
            served_by="landmark",
            latency_s=self.clock() - ticket.t_submit,
            lower=est.lower,
            upper=est.upper,
        )
        self._record_latency(ticket.answer.latency_s)
        return True

    def _distinct_misses(self) -> int:
        seen = set()
        for t in self._pending:
            seen.add((t.query.source, t.query.processing))
        return len(seen)

    @staticmethod
    def _by_processing(need: dict) -> list:
        """Group distinct miss keys by processing fn (solve_batch
        requires one π per batch), preserving admission order."""
        groups: dict = {}
        for skey in need:
            groups.setdefault(skey[1], []).append(skey)
        return list(groups.values())


def serve_latency_stats(answers: Sequence[Answer]) -> LatencyStats:
    """Order statistics over a batch of served answers."""
    return LatencyStats.from_samples([a.latency_s for a in answers])
