"""Host-side builders of the GNN batches (numpy), the same bytes as the
JAX package's ``models/gnn/batch.py`` for the same arguments:

* flat: one graph with x (N, d), edge_src/dst (E,);
* packed: B small graphs (the molecule cell), (B, n, d) features and
  (B, e) edges.

DimeNet also takes triplet index lists: the edge pairs (k -> j, j -> i)
that share the middle vertex, capped per edge by a random draw on the
large graphs (:func:`build_triplets`)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.graph.formats import Graph


@dataclasses.dataclass
class FlatGraphBatch:
    """Flat single-graph batch (numpy)."""

    x: np.ndarray          # (N, d) node features
    edge_src: np.ndarray   # (E,)
    edge_dst: np.ndarray   # (E,)
    edge_mask: np.ndarray  # (E,) bool
    labels: np.ndarray     # (N,) int labels
    coords: Optional[np.ndarray] = None  # (N, 3)
    # triplets: for edge e2 = (j -> i), the edges e1 = (k -> j)
    tri_kj: Optional[np.ndarray] = None  # (T,) edge ids k -> j
    tri_ji: Optional[np.ndarray] = None  # (T,) edge ids j -> i
    tri_mask: Optional[np.ndarray] = None

    @property
    def n(self) -> int:
        return self.x.shape[0]

    @property
    def e(self) -> int:
        return self.edge_src.shape[0]


def build_triplets(
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    n: int,
    cap_per_edge: Optional[int] = None,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """For each edge e2 = (j -> i), its incoming edges e1 = (k -> j),
    k != i, in the order of a stable sort by destination: the int32
    (tri_kj, tri_ji) edge-id lists, grouped by e2 in edge order.  An edge
    of more than ``cap_per_edge`` such pairs keeps ``rng.choice(pairs,
    cap, replace=False)``.

    The JAX package loops over the edges; this finds the candidates of
    each distinct (j, i) once, vectorised, and draws for the capped
    edges in edge order: the same rng calls on the same arrays, so the
    same bytes.  (A sampled block's masked padding edges, all 0 -> 0,
    share one candidate list.)"""
    rng = np.random.default_rng(seed)
    E = edge_src.shape[0]
    if E == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    src, dst = edge_src.astype(np.int64), edge_dst.astype(np.int64)
    order = np.argsort(edge_dst, kind="stable")  # incoming edge ids by vertex
    starts = np.searchsorted(dst[order], np.arange(n), side="left")
    ends = np.searchsorted(dst[order], np.arange(n), side="right")
    pairs, pair_of = np.unique(src * n + dst, return_inverse=True)
    pj, pi = pairs // n, pairs % n
    # every pair's candidates: the in-edges of j, less those from i
    cnt = ends[pj] - starts[pj]
    owner = np.repeat(np.arange(pairs.shape[0]), cnt)
    first = np.cumsum(cnt) - cnt
    cand = order[starts[pj][owner] + np.arange(owner.shape[0]) - first[owner]]
    keep = src[cand] != pi[owner]
    cand, owner = cand[keep], owner[keep]
    k_pair = np.bincount(owner, minlength=pairs.shape[0])
    lo_pair = np.cumsum(k_pair) - k_pair
    k = k_pair[pair_of]  # pairs of each edge
    capped = (np.zeros(E, bool) if cap_per_edge is None else k > cap_per_edge)
    out_k = np.where(capped, cap_per_edge or 0, k)
    out_lo = np.cumsum(out_k) - out_k
    tri_kj = np.empty(int(out_k.sum()), np.int64)
    whole = np.flatnonzero(~capped)
    e = np.repeat(whole, k[whole])
    rank = np.arange(e.shape[0]) - np.repeat(np.cumsum(k[whole]) - k[whole], k[whole])
    tri_kj[out_lo[e] + rank] = cand[lo_pair[pair_of[e]] + rank]
    for e2 in np.flatnonzero(capped):
        lo = lo_pair[pair_of[e2]]
        tri_kj[out_lo[e2]:out_lo[e2] + cap_per_edge] = rng.choice(
            cand[lo:lo + k[e2]], size=cap_per_edge, replace=False)
    return tri_kj.astype(np.int32), np.repeat(np.arange(E), out_k).astype(np.int32)


def flat_batch_from_graph(
    g: Graph,
    d_feat: int,
    n_classes: int,
    *,
    with_coords: bool = False,
    with_triplets: bool = False,
    triplet_cap: Optional[int] = 4,
    seed: int = 0,
) -> FlatGraphBatch:
    """Synthetic features/labels over a real topology (no dataset
    downloads; shapes and sparsity patterns are what matter)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(g.n, d_feat)).astype(np.float32)
    labels = rng.integers(0, n_classes, size=g.n).astype(np.int32)
    coords = (
        rng.normal(size=(g.n, 3)).astype(np.float32)
        if with_coords else None
    )
    tri_kj = tri_ji = tri_mask = None
    if with_triplets:
        tri_kj, tri_ji = build_triplets(g.src, g.dst, g.n, cap_per_edge=triplet_cap,
                                        seed=seed)
        tri_mask = np.ones(tri_kj.shape[0], dtype=bool)
    return FlatGraphBatch(
        x=x, edge_src=g.src, edge_dst=g.dst,
        edge_mask=np.ones(g.m, dtype=bool), labels=labels, coords=coords,
        tri_kj=tri_kj, tri_ji=tri_ji, tri_mask=tri_mask,
    )


@dataclasses.dataclass
class PackedGraphBatch:
    """Batched small graphs (molecule cell), numpy."""

    x: np.ndarray          # (B, n, d)
    edge_src: np.ndarray   # (B, e)
    edge_dst: np.ndarray   # (B, e)
    edge_mask: np.ndarray  # (B, e)
    coords: np.ndarray     # (B, n, 3)
    y: np.ndarray          # (B,) regression target (energy)
    tri_kj: Optional[np.ndarray] = None  # (B, T)
    tri_ji: Optional[np.ndarray] = None
    tri_mask: Optional[np.ndarray] = None


def random_molecule_batch(
    batch: int, n_atoms: int, n_edges: int, n_species: int = 10,
    seed: int = 0, with_triplets: bool = False, triplet_pad: int = 512,
) -> PackedGraphBatch:
    """Random molecular graphs: each atom's nearest neighbours over
    random coords, one-hot species features; graphs of fewer than
    ``n_edges`` edges padded with masked edges 0 -> 0.  Triplets: every
    graph's (uncapped) list cut or padded to ``triplet_pad`` slots, the
    padding (0, 0) and masked."""
    rng = np.random.default_rng(seed)
    coords = rng.normal(size=(batch, n_atoms, 3)).astype(np.float32) * 2.0
    species = rng.integers(0, n_species, size=(batch, n_atoms))
    x = np.eye(n_species, dtype=np.float32)[species]
    es = np.zeros((batch, n_edges), dtype=np.int32)
    ed = np.zeros((batch, n_edges), dtype=np.int32)
    em = np.ones((batch, n_edges), dtype=bool)
    for b in range(batch):
        d = np.linalg.norm(
            coords[b][:, None] - coords[b][None, :], axis=-1
        ) + np.eye(n_atoms) * 1e9
        k = max(1, n_edges // n_atoms)
        nbr = np.argsort(d, axis=1)[:, :k]
        src = np.repeat(np.arange(n_atoms), k)
        dst = nbr.reshape(-1)
        m = src.shape[0]
        if m >= n_edges:
            es[b], ed[b] = src[:n_edges], dst[:n_edges]
        else:
            es[b, :m], ed[b, :m] = src, dst
            em[b, m:] = False
    y = rng.normal(size=(batch,)).astype(np.float32)
    tk = tj = tm = None
    if with_triplets:
        tk = np.zeros((batch, triplet_pad), dtype=np.int32)
        tj = np.zeros((batch, triplet_pad), dtype=np.int32)
        tm = np.zeros((batch, triplet_pad), dtype=bool)
        for b in range(batch):
            kj, ji = build_triplets(es[b], ed[b], n_atoms, seed=seed)
            t = min(triplet_pad, kj.shape[0])
            tk[b, :t], tj[b, :t], tm[b, :t] = kj[:t], ji[:t], True
    return PackedGraphBatch(x=x, edge_src=es, edge_dst=ed, edge_mask=em,
                            coords=coords, y=y, tri_kj=tk, tri_ji=tj, tri_mask=tm)
