"""Host-side graph storage: COO edge lists and CSR.

The engine consumes padded ELL rows built by
:mod:`repro_torch.graph.partition`.  Padding sentinels: column index
``n`` (one past the last vertex; targets index into a length ``n+1``
scratch array whose last slot is discarded) and weight ``+inf``, so
min-plus relaxation through a padded slot is a no-op.
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np

# Edge weights are float32 everywhere; +inf is the "unreachable" value.
INF = np.float32(np.inf)


@dataclasses.dataclass
class Graph:
    """A weighted directed graph in COO (edge-list) form, host-side.

    ``src``/``dst`` are int32 arrays of shape (m,), ``weight`` float32
    of shape (m,).  Vertices are 0..n-1.
    """

    n: int
    src: np.ndarray
    dst: np.ndarray
    weight: np.ndarray
    name: str = "graph"

    @property
    def m(self) -> int:
        return int(self.src.shape[0])

    def __post_init__(self):
        self.src = np.asarray(self.src, dtype=np.int32)
        self.dst = np.asarray(self.dst, dtype=np.int32)
        self.weight = np.asarray(self.weight, dtype=np.float32)
        if not self.src.shape == self.dst.shape == self.weight.shape:
            raise ValueError(
                f"edge arrays differ in shape: src {self.src.shape}, "
                f"dst {self.dst.shape}, weight {self.weight.shape}"
            )

    def symmetrized(self) -> "Graph":
        """Add reverse edges (Graph500 graphs are treated as undirected)."""
        src = np.concatenate([self.src, self.dst])
        dst = np.concatenate([self.dst, self.src])
        w = np.concatenate([self.weight, self.weight])
        return Graph(self.n, src, dst, w, name=self.name + "+sym")

    def deduplicated(self) -> "Graph":
        """Keep the minimum-weight edge per (src, dst) pair, drop self loops.
        The edges come out sorted by (src, dst), as the JAX package's
        two-key sort leaves them; one sort of the pair keys and a
        segment minimum of the weights (``fmin``: a NaN only where a
        pair has nothing else, as it sorts last there) give the same
        arrays in a fraction of that sort's time at Graph500 scales."""
        keep = self.src != self.dst
        key = (self.src[keep].astype(np.int64) * np.int64(self.n)
               + self.dst[keep].astype(np.int64))
        order = np.argsort(key)
        key = key[order]
        first = np.ones(key.shape[0], dtype=bool)
        first[1:] = key[1:] != key[:-1]
        starts = np.flatnonzero(first)
        w = self.weight[keep][order]
        w = np.fmin.reduceat(w, starts) if starts.size else w
        key = key[starts]
        return Graph(self.n, key // self.n, key % self.n, w, name=self.name)


@dataclasses.dataclass
class CSR:
    """Compressed sparse row adjacency: out-edges of each vertex."""

    n: int
    row_ptr: np.ndarray  # (n+1,) int64
    col_idx: np.ndarray  # (m,) int32
    weight: np.ndarray  # (m,) float32

    @property
    def m(self) -> int:
        return int(self.col_idx.shape[0])

    def neighbors(self, v: int):
        lo, hi = self.row_ptr[v], self.row_ptr[v + 1]
        return self.col_idx[lo:hi], self.weight[lo:hi]

    def max_degree(self) -> int:
        return int(np.max(self.row_ptr[1:] - self.row_ptr[:-1], initial=0))


def graph_fingerprint(g: Graph, *, full: bool = False) -> tuple:
    """Content token so in-place edge mutation invalidates derived-buffer
    memos (partitions, transpose ELLs).  CRC over the COO arrays: one
    pass, no copy.

    A graph that carries a hash-chain token (installed by
    :func:`chain_fingerprint`, the streaming-update path) returns it
    without rehashing; ``full=True`` forces the rehash.  The chain holds
    only while every mutation goes through :func:`chain_fingerprint`:
    code that mutates the edge arrays directly calls
    :func:`clear_fingerprint_chain` first."""
    if not full:
        chain = getattr(g, "_fp_chain", None)
        if chain is not None:
            return chain
    crc = 0
    for arr in (g.src, g.dst, g.weight):
        crc = zlib.crc32(memoryview(np.ascontiguousarray(arr)), crc)
    return (g.n, g.m, crc)


def chain_fingerprint(g: Graph, record: bytes) -> tuple:
    """Extend ``g``'s fingerprint by one update record: a CRC chained
    over (previous token, record), installed on ``g`` and returned.
    Call after applying the mutation the record describes.  Chained
    tokens carry a ``"chain"`` tag, so they never equal a full
    rehash's."""
    prev = graph_fingerprint(g)  # the chain if present, else a full rehash
    crc = zlib.crc32(repr(prev).encode(), 0)
    crc = zlib.crc32(record, crc)
    token = (g.n, g.m, crc, "chain")
    g._fp_chain = token
    return token


def clear_fingerprint_chain(g: Graph) -> None:
    """Drop a chained fingerprint (the next lookup rehashes): required
    before mutating edge arrays outside the update-record path."""
    if hasattr(g, "_fp_chain"):
        del g._fp_chain


def coo_to_csr(g: Graph) -> CSR:
    order = np.argsort(g.src, kind="stable")
    src, dst, w = g.src[order], g.dst[order], g.weight[order]
    counts = np.bincount(src, minlength=g.n)
    row_ptr = np.zeros(g.n + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    return CSR(g.n, row_ptr, dst.astype(np.int32), w.astype(np.float32))
