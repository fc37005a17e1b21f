"""Offline spec auto-tuner: search the grammar, cache the winner.

The paper's §VII promise — *generate the algorithm for the target
architecture* — as a search: :class:`AutoTuner` walks the spec
grammar (ordering × exchange × partitioner) by coordinate descent,
scores each candidate with a pilot solve on the actual graph, and
records the winner in a :class:`TunedSpecCache` keyed by graph
fingerprint.  ``graph_fingerprint`` returns the hash-chain token when
the graph came through ``chain_fingerprint`` streamed updates, so a
mutated graph misses the cache and re-tunes instead of serving a
stale spec.

``repro_torch.serve.Router`` consults the cache on admission (tuned
spec wins over the router's default config); ``launch/tune.py`` drives
search / inspect / export from the command line.

The ``model`` objective is :func:`repro_torch.core.metrics.model_time_s`,
the JAX package's linear cost model with per-unit costs measured on an
H100 (``cost=`` takes others, the JAX package's for one); ``wall`` is
the objective that measures this machine (a warm pilot solve, on the
card by default).
The cache's JSON is the JAX package's: either package loads the
other's file.
"""

from __future__ import annotations

import dataclasses
import json
import time
import warnings
from typing import Iterable, Optional

import numpy as np

from repro_torch.core.metrics import model_time_s
from repro_torch.core.ordering import suggest

#: scoring objectives: cost-model seconds (default), raw superstep
#: count, exchanged bytes, or measured wall seconds of a warm solve
OBJECTIVES = ("model", "supersteps", "bytes", "wall")

_FULL_ORDERINGS = ("delta:3", "delta:5", "delta:10", "dijkstra")
_FULL_EXCHANGES = ("a2a", "sparse")
_FULL_PARTITIONS = ("block", "ebal")
_QUICK_ORDERINGS = ("delta:5", "dijkstra")


@dataclasses.dataclass
class TunedRecord:
    """One graph's tuning result: the winning spec plus the scored
    leaderboard it beat (for ``launch/tune --inspect``)."""

    spec: str
    objective: str
    score: float
    fingerprint: tuple
    leaderboard: list = dataclasses.field(default_factory=list)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["fingerprint"] = list(self.fingerprint)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "TunedRecord":
        return cls(
            spec=str(d["spec"]),
            objective=str(d["objective"]),
            score=float(d["score"]),
            fingerprint=tuple(d["fingerprint"]),
            leaderboard=list(d.get("leaderboard", [])),
        )


def _fp_key(fp) -> tuple:
    return tuple(fp)


class TunedSpecCache:
    """fingerprint -> :class:`TunedRecord`, JSON-persistable.

    Keys are whatever :func:`repro_torch.graph.formats.graph_fingerprint`
    returns — the CRC tuple for plain graphs, the hash-chain token for
    graphs advanced through ``chain_fingerprint`` — so streamed
    updates invalidate by construction: the mutated graph's
    fingerprint simply never matches a stale record."""

    def __init__(self) -> None:
        self._records: dict = {}

    def get(self, fingerprint) -> Optional[TunedRecord]:
        return self._records.get(_fp_key(fingerprint))

    def put(self, record: TunedRecord) -> None:
        self._records[_fp_key(record.fingerprint)] = record

    def invalidate(self, fingerprint) -> bool:
        return self._records.pop(_fp_key(fingerprint), None) is not None

    def records(self) -> list:
        return list(self._records.values())

    def __len__(self) -> int:
        return len(self._records)

    def __contains__(self, fingerprint) -> bool:
        return _fp_key(fingerprint) in self._records

    def to_json(self) -> list:
        return [r.as_dict() for r in self._records.values()]

    @classmethod
    def from_json(cls, rows: Iterable[dict]) -> "TunedSpecCache":
        cache = cls()
        for row in rows:
            cache.put(TunedRecord.from_dict(row))
        return cache

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1)

    @classmethod
    def load(cls, path: str) -> "TunedSpecCache":
        with open(path) as f:
            return cls.from_json(json.load(f))


class AutoTuner:
    """Coordinate-descent search over the spec grammar.

    Stages: (1) orderings at the default exchange/partition, (2)
    exchanges at the best ordering, (3) partitioners at the best of
    both — ``len(orderings) + len(exchanges) + len(partitions) - 2``
    pilot solves instead of the full cross product.  Pilot solves run
    on the *actual* graph capped at ``pilot_iters`` supersteps; a
    truncated pilot's score is inflated by its inverse progress so an
    unfinished cheap-looking candidate cannot win.

    Pilots run on ``n_parts`` ranks stacked on ``device`` (None: the
    card).  The graph is partitioned once per partitioner of the
    search, and every pilot with that partitioner solves on it."""

    def __init__(
        self,
        *,
        n_parts: int = 1,
        device=None,
        objective: str = "model",
        cache: Optional[TunedSpecCache] = None,
        quick: bool = False,
        pilot_iters: int = 2000,
        pilot_source: int = 0,
        orderings: Optional[tuple] = None,
        exchanges: Optional[tuple] = None,
        partitions: Optional[tuple] = None,
        cost=None,
    ) -> None:
        from repro_torch.device import resolve_device

        if objective not in OBJECTIVES:
            raise ValueError(
                f"objective must be one of {OBJECTIVES}, got "
                f"{objective!r}{suggest(str(objective), OBJECTIVES)}"
            )
        self.n_parts = int(n_parts)
        self.device = resolve_device(device)
        self.objective = objective
        self.cache = cache if cache is not None else TunedSpecCache()
        self.pilot_iters = int(pilot_iters)
        self.pilot_source = int(pilot_source)
        self.orderings = tuple(
            orderings
            if orderings is not None
            else (_QUICK_ORDERINGS if quick else _FULL_ORDERINGS)
        )
        self.exchanges = tuple(
            exchanges if exchanges is not None else _FULL_EXCHANGES
        )
        self.partitions = tuple(
            partitions
            if partitions is not None
            else (("block",) if quick else _FULL_PARTITIONS)
        )
        self.cost = cost
        self.pilots_run = 0
        self._partitions: dict = {}  # (id(graph), partitioner) -> (graph, pg)

    # -- scoring -------------------------------------------------------

    def _partitioned(self, graph, partitioner: str):
        """``graph`` partitioned for ``partitioner``, once per search."""
        from repro_torch.graph.partition import partition_graph

        key = (id(graph), partitioner)
        hit = self._partitions.get(key)
        if hit is None or hit[0] is not graph:
            hit = (graph, partition_graph(graph, self.n_parts,
                                          partitioner=partitioner))
            self._partitions[key] = hit
        return hit[1]

    def _pilot(self, graph, spec: str) -> dict:
        from repro_torch.api import Problem, SingleSource, Solver, SolverConfig

        cfg = SolverConfig.from_spec(spec, max_iters=self.pilot_iters)
        solver = Solver(cfg, n_parts=self.n_parts, device=self.device)
        pg = self._partitioned(graph, cfg.partition)
        problem = Problem(pg, SingleSource(self.pilot_source))
        with warnings.catch_warnings():
            # pilot truncation is by design; don't spam the caller
            warnings.simplefilter("ignore", RuntimeWarning)
            sol = solver.solve(problem)
            wall = 0.0
            if self.objective == "wall":
                t0 = time.perf_counter()
                sol = solver.solve(problem)
                wall = time.perf_counter() - t0
        m = sol.metrics
        n_chips = sol.pg.n_parts if sol.pg is not None else 1
        if self.objective == "supersteps":
            score = float(m.supersteps)
        elif self.objective == "bytes":
            score = float(m.exchange_bytes)
        elif self.objective == "wall":
            score = float(wall)
        else:
            score = model_time_s(m, n_chips=n_chips, cost=self.cost)
        if not m.converged:
            # inflate by inverse progress: committed / n vertices
            n = int(np.asarray(sol.state).shape[0])
            done = int(np.sum(np.isfinite(np.asarray(sol.state))))
            score *= n / max(1, done)
        self.pilots_run += 1
        return dict(
            spec=spec,
            score=float(score),
            supersteps=int(m.supersteps),
            exchange_bytes=int(m.exchange_bytes),
            bytes_per_superstep=(
                int(m.exchange_bytes // max(1, m.supersteps))
            ),
            sparse_fallbacks=int(m.sparse_fallbacks),
            converged=bool(m.converged),
        )

    # -- search --------------------------------------------------------

    @staticmethod
    def _spec(ordering: str, exchange: str, partition: str) -> str:
        s = f"{ordering}/{exchange}"
        if partition != "block":
            s += f"@{partition}"
        return s

    def search(self, graph) -> TunedRecord:
        """Run the coordinate-descent search and cache the winner."""
        from repro_torch.graph.formats import graph_fingerprint

        board: list = []

        def best(specs):
            rows = [self._pilot(graph, s) for s in specs]
            board.extend(rows)
            return min(rows, key=lambda r: r["score"])

        ex0, part0 = self.exchanges[0], self.partitions[0]
        w = best([self._spec(o, ex0, part0) for o in self.orderings])
        ordering = w["spec"].split("/", 1)[0]
        if len(self.exchanges) > 1:
            w2 = best([
                self._spec(ordering, ex, part0)
                for ex in self.exchanges[1:]
            ])
            if w2["score"] < w["score"]:
                w = w2
        exchange = w["spec"].split("/", 1)[1].split("@", 1)[0]
        if len(self.partitions) > 1:
            w3 = best([
                self._spec(ordering, exchange, pt)
                for pt in self.partitions[1:]
            ])
            if w3["score"] < w["score"]:
                w = w3
        self._partitions.clear()
        board.sort(key=lambda r: r["score"])
        record = TunedRecord(
            spec=w["spec"],
            objective=self.objective,
            score=w["score"],
            fingerprint=_fp_key(graph_fingerprint(graph)),
            leaderboard=board,
        )
        self.cache.put(record)
        return record

    def tune(self, graph):
        """The tuned :class:`SolverConfig` for ``graph`` — cache hit
        if its fingerprint was searched before, one search otherwise.
        The returned config carries production ``max_iters``, not the
        pilot cap."""
        from repro_torch.api import SolverConfig
        from repro_torch.graph.formats import graph_fingerprint

        rec = self.cache.get(graph_fingerprint(graph))
        if rec is None:
            rec = self.search(graph)
        return SolverConfig.from_spec(rec.spec)
