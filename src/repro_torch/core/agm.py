"""The Abstract Graph Machine (paper §III, Definition 3), its logical
execution engine, and the ground-truth Dijkstra oracle.

The logical engine is the executable form of the paper's semantics:
pending workitems are bucketed by the ordering's class key, the
smallest class runs to its end (new workitems may land in it), then
the next; the machine stops when no class is left.  Because the state
combine is monotone (min or max), running the workitems of one class
in any sequential order equals the distributed engine's parallel
execution, so this engine is the semantic oracle the superstep engine
(:mod:`repro_torch.core.engine`) is held against, and its metrics
(classes, workitems, relaxations, commits) are the paper's work and
ordering quantities.

It runs on the host in float64, as the JAX package's does, on Python
scalars: the processing functions of :mod:`repro_torch.core.processing`
are written for tensors, so the built-in ones have scalar twins here
(``min(s, w)`` for SSWP gives the float64 value the JAX package gets
from ``float(jnp.minimum(s, w))`` on float32-exact weights).
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from collections import defaultdict

import numpy as np
import torch

from repro_torch.core.metrics import WorkMetrics
from repro_torch.core.ordering import KLA, Chaotic, DeltaStepping, Dijkstra, Ordering
from repro_torch.core.processing import PROCESSING_FNS, SSSP, ProcessingFn
from repro_torch.graph.formats import CSR, Graph, coo_to_csr

# name -> (edge_update, better) on Python floats, for the built-in π
_SCALAR_FNS = {
    "sssp": (lambda s, w: s + w, lambda a, b: a < b),
    "bfs": (lambda s, w: s + 1.0, lambda a, b: a < b),
    "cc": (lambda s, w: s, lambda a, b: a < b),
    "sswp": (lambda s, w: min(s, w), lambda a, b: a > b),
}


def _scalar_fns(p: ProcessingFn):
    """``(edge_update, better)`` of ``p`` on Python floats: the built-in
    twins, or ``p``'s own functions on float64 scalar tensors for a
    registered processing function."""
    if PROCESSING_FNS.get(p.name) is p:
        return _SCALAR_FNS[p.name]

    def edge_update(s, w):
        return float(p.edge_update(torch.tensor(s, dtype=torch.float64),
                                   torch.tensor(w, dtype=torch.float64)))

    def better(a, b):
        return bool(p.better(torch.tensor(a, dtype=torch.float64),
                             torch.tensor(float(b), dtype=torch.float64)))

    return edge_update, better


def _class_key_scalar(ordering: Ordering, dist: float, level: int) -> float:
    if isinstance(ordering, Chaotic):
        return 0.0
    if isinstance(ordering, Dijkstra):
        return dist
    if isinstance(ordering, DeltaStepping):
        return math.floor(dist / ordering.delta)
    if isinstance(ordering, KLA):
        return math.floor(level / ordering.k)
    raise TypeError(ordering)


@dataclasses.dataclass
class AGM:
    """The 6-tuple (G, WorkItem, Q, π, <_wis, S) of Definition 3.

    ``WorkItem`` is implicit in (π, ordering): ⟨v, state⟩ plus a level
    attribute when the ordering reads one (KLA, Definition 8).
    """

    graph: Graph
    processing: ProcessingFn
    ordering: Ordering
    initial_workitems: list  # [(v, state, level)]

    def run(self, max_classes: int = 10**9) -> tuple[np.ndarray, WorkMetrics]:
        return run_logical(self, max_classes=max_classes)


def sssp_agm(graph: Graph, source: int, ordering: Ordering) -> AGM:
    """Propositions 1-3: the SSSP AGM with S = {⟨source, 0⟩} (rule R0 of
    Algorithm 1, d(r) := 0, is the initial workitem set)."""
    return AGM(graph, SSSP, ordering, [(int(source), 0.0, 0)])


def run_logical(
    agm: AGM, max_classes: int = 10**9
) -> tuple[np.ndarray, WorkMetrics]:
    """Execute the AGM under Definition 3's semantics: the (n,) float64
    state and the work metrics.  An ordering without a scalar class key
    (TopK) raises ``TypeError``."""
    csr: CSR = coo_to_csr(agm.graph)
    p = agm.processing
    edge_update, better = _scalar_fns(p)
    state = np.full(agm.graph.n + 1, p.worst, dtype=np.float64)
    m = WorkMetrics()

    # pending workitems bucketed by equivalence-class key
    buckets: dict[float, list] = defaultdict(list)
    for (v, s, l) in agm.initial_workitems:
        buckets[_class_key_scalar(agm.ordering, s, l)].append((v, s, l))

    while buckets and m.classes < max_classes:
        kmin = min(buckets.keys())
        batch = buckets.pop(kmin)
        m.classes += 1
        # new workitems may land in the running class (buckets[kmin])
        for (v, s, l) in batch:
            m.workitems += 1
            if better(s, state[v]):  # condition C
                state[v] = s  # update U
                m.commits += 1
                nbrs, ws = csr.neighbors(v)
                for u, w in zip(nbrs, ws):  # construct N(w)
                    m.relaxations += 1
                    cand = float(edge_update(s, float(w)))
                    key = _class_key_scalar(agm.ordering, cand, l + 1)
                    assert key >= kmin - 1e-9, (
                        "AGM invariant violated: generated workitem in an "
                        "already-executed equivalence class"
                    )
                    buckets[key].append((int(u), cand, l + 1))
    return state[: agm.graph.n], m


def dijkstra_reference(graph: Graph, source: int) -> np.ndarray:
    """Independent textbook Dijkstra (heapq): (n,) float64 distances."""
    csr = coo_to_csr(graph)
    dist = np.full(graph.n, np.inf, dtype=np.float64)
    dist[source] = 0.0
    heap = [(0.0, source)]
    while heap:
        d, v = heapq.heappop(heap)
        if d > dist[v]:
            continue
        nbrs, ws = csr.neighbors(v)
        for u, w in zip(nbrs, ws):
            nd = d + float(w)
            if nd < dist[u]:
                dist[u] = nd
                heapq.heappush(heap, (nd, u))
    return dist
