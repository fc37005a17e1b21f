"""1D vertex partitioning for the rank-stacked EAGM engine.

Each rank stores the out-edges of its owned vertices, contiguously in a
padded per-rank slot space (the paper's §V distribution).  A relabeling
partitioner computes a permutation ``perm`` of vertex ids into the
padded slot space ``[0, P·n_local)``; the engine runs unchanged on the
relabeled graph and the facade un-permutes the final state.

Strategies: ``block`` (identity), ``shuffle:<seed>`` (random
relabeling), ``ebal`` (contiguous boundaries balancing virtual-row
counts) and ``degree`` (descending-degree striping).

Fixed shapes: rows are padded to a width W, and a vertex of degree
> W is split into ceil(deg/W) *virtual rows* sharing one source
(``row_src``).  Per-rank buffers are padded to the max over ranks and
stacked along a leading rank axis.  Padding sentinels: ``col = n_pad``
and ``weight = +inf``; padded virtual rows point at the local dummy
slot ``n_local``.

The arrays are byte-identical to the JAX package's
``repro.graph.partition`` for the same graph and strategy.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.graph.formats import CSR, INF, Graph, coo_to_csr


def default_ell_width(avg_degree: float) -> int:
    """Power-of-two ELL width near 2x the average degree, in [4, 128]."""
    w = 1 << max(2, math.ceil(math.log2(max(1.0, 2.0 * avg_degree))))
    return int(min(128, w))


def chunk_fat_rows(
    csr: CSR, width: int, pad_col: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Split rows of ``csr`` into virtual rows of at most ``width``
    entries.  Returns (row_src, col, wgt) with shapes (R,), (R, width),
    (R, width)."""
    deg = (csr.row_ptr[1:] - csr.row_ptr[:-1]).astype(np.int64)
    chunks = np.maximum(1, -(-deg // width))  # ceil, >=1 so empty rows exist
    R = int(chunks.sum())
    row_src = np.repeat(np.arange(csr.n, dtype=np.int32), chunks)
    col = np.full((R, width), pad_col, dtype=np.int32)
    wgt = np.full((R, width), INF, dtype=np.float32)
    # each edge's (virtual_row, slot) position
    row_start = np.zeros(csr.n + 1, dtype=np.int64)
    np.cumsum(chunks, out=row_start[1:])
    edge_row = np.repeat(np.arange(csr.n, dtype=np.int64), deg)
    edge_off = np.arange(csr.m, dtype=np.int64) - np.repeat(
        csr.row_ptr[:-1], deg
    )
    vrow = row_start[edge_row] + edge_off // width
    slot = edge_off % width
    col[vrow, slot] = csr.col_idx
    wgt[vrow, slot] = csr.weight
    return row_src, col, wgt


PARTITIONER_KINDS = ("block", "shuffle", "ebal", "degree")


def canonical_partitioner(spec: str) -> str:
    """Validate and canonicalize ``block`` | ``shuffle[:seed]`` |
    ``ebal`` | ``degree``; ``shuffle`` normalizes to ``shuffle:0``."""
    from repro_torch.core.ordering import suggest  # graph loads before core

    s = str(spec).strip().lower()
    if not s:
        raise ValueError(f"empty partitioner spec {spec!r}")
    kind, sep, arg = s.partition(":")
    kind = kind.strip()
    if kind not in PARTITIONER_KINDS:
        raise ValueError(
            f"unknown partitioner {spec!r}; valid kinds "
            f"{PARTITIONER_KINDS}{suggest(kind, PARTITIONER_KINDS)}"
        )
    if kind == "shuffle":
        arg = arg.strip() or "0"
        try:
            seed = int(arg)
        except ValueError:
            raise ValueError(
                f"shuffle seed must be an integer: {spec!r}"
            ) from None
        if seed < 0:
            raise ValueError(f"shuffle seed must be non-negative: {spec!r}")
        return f"shuffle:{seed}"
    if sep:
        raise ValueError(
            f"partitioner {kind!r} takes no argument (got {spec!r})"
        )
    return kind


@dataclasses.dataclass(frozen=True)
class Assignment:
    """A vertex→(rank, slot) map as a permutation into the padded slot
    space: vertex ``v`` lives at padded id ``perm[v]`` =
    ``rank · n_local + slot``."""

    n: int
    n_parts: int
    n_local: int
    perm: np.ndarray  # (n,) int64
    spec: str

    @property
    def n_pad(self) -> int:
        return self.n_parts * self.n_local


def _positions(order: np.ndarray) -> np.ndarray:
    """Invert ``order``: position of each vertex in the sorted order."""
    pos = np.empty(order.shape[0], dtype=np.int64)
    pos[order] = np.arange(order.shape[0], dtype=np.int64)
    return pos


def assign_vertices(
    g: Graph, n_parts: int, spec: str, width: int
) -> Assignment:
    """The ownership permutation for partitioner ``spec``."""
    spec = canonical_partitioner(spec)
    kind, _, arg = spec.partition(":")
    n = g.n
    even_local = -(-n // n_parts)  # ceil

    if kind == "block":
        return Assignment(n, n_parts, even_local,
                          np.arange(n, dtype=np.int64), spec)

    if kind == "shuffle":
        order = np.random.default_rng(int(arg)).permutation(n)
        return Assignment(n, n_parts, even_local, _positions(order), spec)

    deg = np.bincount(g.src, minlength=n).astype(np.int64)

    if kind == "degree":
        # sorted position i -> rank i % P, slot i // P
        pos = _positions(np.lexsort((np.arange(n), -deg)))
        perm = (pos % n_parts) * even_local + pos // n_parts
        return Assignment(n, n_parts, even_local, perm, spec)

    # ebal: rank p owns the id range whose cumulative virtual-row count
    # first reaches p/P of the total
    rows = np.maximum(1, -(-deg // width))
    cum = np.cumsum(rows)
    total = int(cum[-1])
    targets = np.arange(1, n_parts) * (total / n_parts)
    bounds = np.searchsorted(cum, targets, side="left")
    bounds = np.concatenate([[0], bounds, [n]]).astype(np.int64)
    n_local = int(np.diff(bounds).max(initial=1))
    perm = np.empty(n, dtype=np.int64)
    for p in range(n_parts):
        lo, hi = int(bounds[p]), int(bounds[p + 1])
        perm[lo:hi] = p * n_local + np.arange(hi - lo, dtype=np.int64)
    return Assignment(n, n_parts, n_local, perm, spec)


class DeviceELL(NamedTuple):
    """The stacked ELL buffers on one device, plus the real-edge count
    of every virtual row (the relaxation metric reads it)."""

    row_src: torch.Tensor  # (P, R) int32
    col: torch.Tensor      # (P, R, W) int32
    wgt: torch.Tensor      # (P, R, W) float32
    row_deg: torch.Tensor  # (P, R) int64


@dataclasses.dataclass
class PartitionedGraph:
    """1D-partitioned graph with stacked per-rank ELL buffers (host
    numpy; :meth:`to` copies them to a device once).

    Shapes: ``row_src`` (P, R); ``col``/``wgt`` (P, R, W).  ``col``
    holds padded global destination ids (padding = n_pad); ``row_src``
    holds local source slots (padded rows -> dummy slot n_local).
    """

    n: int
    m: int
    n_parts: int
    n_local: int
    width: int
    row_src: np.ndarray
    col: np.ndarray
    wgt: np.ndarray
    name: str = "pgraph"
    partitioner: str = "block"
    # original id -> padded global id; None = identity (block)
    perm: Optional[np.ndarray] = None
    _device: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False
    )

    @property
    def n_pad(self) -> int:
        return self.n_parts * self.n_local

    @property
    def rows_per_rank(self) -> int:
        return int(self.row_src.shape[1])

    def to(self, device, rank: Optional[int] = None) -> DeviceELL:
        """The ELL buffers on ``device``, copied there on first use and
        kept for later solves: every rank's, or with ``rank=r`` only rank
        r's, as a (1, R, W) stack (a process of the process backend
        holds its own rank's share alone)."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if rank is not None and not 0 <= rank < self.n_parts:
            raise ValueError(f"rank {rank} outside [0, {self.n_parts})")
        key = (str(device), rank)
        buf = self._device.get(key)
        if buf is None:
            part = slice(None) if rank is None else slice(rank, rank + 1)
            col = torch.as_tensor(self.col[part], device=device)
            wgt = torch.as_tensor(self.wgt[part], device=device)
            buf = DeviceELL(
                row_src=torch.as_tensor(self.row_src[part], device=device),
                col=col,
                wgt=wgt,
                row_deg=(wgt < float("inf")).sum(dim=2),
            )
            self._device[key] = buf
        return buf

    def padded_id(self, v):
        """Original vertex id(s) -> padded global id(s)."""
        v = np.asarray(v)
        return v if self.perm is None else self.perm[v]

    def owner_slot(self, v):
        """Original vertex id(s) -> (rank, slot)."""
        pid = self.padded_id(v)
        return pid // self.n_local, pid % self.n_local

    def unpermute(self, padded_state: np.ndarray) -> np.ndarray:
        """(..., n_pad) padded-space state -> (..., n) original ids."""
        padded_state = np.asarray(padded_state)
        if self.perm is None:
            return padded_state[..., : self.n]
        return padded_state[..., self.perm]

    def same_layout(self, other: "PartitionedGraph") -> bool:
        """True iff states padded under ``self`` are valid under
        ``other``: the same shape and the same vertex-to-slot map (the
        warm-restart check)."""
        if (self.n, self.n_parts, self.n_local) != (
            other.n, other.n_parts, other.n_local
        ):
            return False
        if (self.perm is None) != (other.perm is None):
            return False
        return self.perm is None or bool(np.array_equal(self.perm, other.perm))

    # -- load-balance statistics --------------------------------------

    def load_stats(self) -> dict:
        """Per-rank load balance: real edges and virtual rows per rank,
        ELL occupancy, and straggler ratios (max/mean, 1.0 is perfect
        balance; the dense relax costs every rank the padded max, so
        ``straggler_rows`` is the stacked ELL's padding overhead)."""
        edges = np.sum(self.col != self.n_pad, axis=(1, 2))
        rows = np.sum(self.row_src != self.n_local, axis=1)

        def _straggler(x):
            mean = float(np.mean(x))
            return float(np.max(x)) / mean if mean > 0 else 1.0

        return dict(
            edges_per_rank=[int(e) for e in edges],
            rows_per_rank=[int(r) for r in rows],
            max_rows=self.rows_per_rank,
            ell_occupancy=float(edges.sum()) / max(1, self.col.size),
            straggler_rows=_straggler(rows),
            straggler_edges=_straggler(edges),
        )

    def describe(self, stats: Optional[dict] = None) -> str:
        """One line: shape, ELL density, partitioner and the row
        straggler ratio (``stats``: a :meth:`load_stats` already taken)."""
        st = stats if stats is not None else self.load_stats()
        return (
            f"{self.name}: n={self.n} m={self.m} P={self.n_parts} "
            f"n_local={self.n_local} rows/rank={self.rows_per_rank} "
            f"W={self.width} ell_density={st['ell_occupancy']:.3f} "
            f"partition={self.partitioner} "
            f"straggler={st['straggler_rows']:.2f}"
        )


def partition_graph(
    g: Graph,
    n_parts: int,
    width: Optional[int] = None,
    partitioner: str = "block",
    name: Optional[str] = None,
) -> PartitionedGraph:
    """Partition ``g`` over ``n_parts`` ranks under a relabeling
    strategy; buffers are in the padded relabeled space."""
    spec = canonical_partitioner(partitioner)
    if width is None:
        width = default_ell_width(g.m / max(1, g.n))
    asn = assign_vertices(g, n_parts, spec, width)
    n_local, n_pad = asn.n_local, asn.n_pad

    # relabeled graph over the padded id space: dummy slots are
    # degree-0 vertices, so per-rank CSR slicing is uniform
    perm32 = asn.perm.astype(np.int32)
    csr_all = coo_to_csr(
        Graph(n_pad, perm32[g.src], perm32[g.dst], g.weight, name=g.name)
    )
    # real vertices occupy a contiguous slot prefix on every rank;
    # dummy tail slots get no virtual rows
    counts = np.bincount(asn.perm // n_local, minlength=n_parts)

    per_rank = []
    for p in range(n_parts):
        lo, hi = p * n_local, p * n_local + int(counts[p])
        row_ptr = csr_all.row_ptr[lo : hi + 1] - csr_all.row_ptr[lo]
        sl = slice(csr_all.row_ptr[lo], csr_all.row_ptr[hi])
        local = CSR(hi - lo, row_ptr, csr_all.col_idx[sl], csr_all.weight[sl])
        per_rank.append(chunk_fat_rows(local, width, pad_col=n_pad))

    R = max(rs.shape[0] for rs, _, _ in per_rank)
    P = n_parts
    row_src = np.full((P, R), n_local, dtype=np.int32)  # pad -> dummy slot
    col = np.full((P, R, width), n_pad, dtype=np.int32)
    wgt = np.full((P, R, width), INF, dtype=np.float32)
    for p, (rs, c, w) in enumerate(per_rank):
        row_src[p, : rs.shape[0]] = rs
        col[p, : c.shape[0]] = c
        wgt[p, : w.shape[0]] = w

    return PartitionedGraph(
        n=g.n, m=g.m, n_parts=P, n_local=n_local, width=width,
        row_src=row_src, col=col, wgt=wgt, name=name or g.name,
        partitioner=spec, perm=None if spec == "block" else asn.perm,
    )


def from_arrays(
    *,
    n: int,
    m: int,
    n_parts: int,
    n_local: int,
    width: int,
    row_src: np.ndarray,
    col: np.ndarray,
    wgt: np.ndarray,
    perm: Optional[np.ndarray] = None,
    partitioner: str = "block",
    name: str = "pgraph",
) -> PartitionedGraph:
    """A :class:`PartitionedGraph` from another partition's arrays (the
    JAX package's, for instance), validated for shape and dtype."""
    row_src = np.ascontiguousarray(row_src, dtype=np.int32)
    col = np.ascontiguousarray(col, dtype=np.int32)
    wgt = np.ascontiguousarray(wgt, dtype=np.float32)
    if row_src.ndim != 2 or row_src.shape[0] != n_parts:
        raise ValueError(f"row_src must be (P={n_parts}, R), got {row_src.shape}")
    expect = row_src.shape + (width,)
    if col.shape != expect or wgt.shape != expect:
        raise ValueError(
            f"col/wgt must be {expect}, got {col.shape} and {wgt.shape}"
        )
    if perm is not None:
        perm = np.asarray(perm, dtype=np.int64)
        if perm.shape != (n,):
            raise ValueError(f"perm must be ({n},), got {perm.shape}")
    return PartitionedGraph(
        n=int(n), m=int(m), n_parts=int(n_parts), n_local=int(n_local),
        width=int(width), row_src=row_src, col=col, wgt=wgt, name=name,
        partitioner=canonical_partitioner(partitioner), perm=perm,
    )
