"""The ground-truth oracle of the paper's AGM semantics: a textbook
Dijkstra over the host-side graph."""

from __future__ import annotations

import heapq

import numpy as np

from repro_torch.graph.formats import Graph, coo_to_csr


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
