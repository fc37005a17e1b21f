"""Host-side builders of the GNN batches (numpy), the same bytes as the
JAX package's ``models/gnn/batch.py`` for the same arguments:

* flat: one graph with x (N, d), edge_src/dst (E,);
* packed: B small graphs (the molecule cell), (B, n, d) features and
  (B, e) edges.

Triplet index lists (DimeNet's kj -> ji edge pairs) come with the
DimeNet port (ROADMAP.md Queue 1 item 5.2) and raise until then."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.graph.formats import Graph


def _no_triplets(with_triplets: bool) -> None:
    if with_triplets:
        raise NotImplementedError(
            "triplet index lists come with the DimeNet port (ROADMAP.md)")


@dataclasses.dataclass
class FlatGraphBatch:
    """Flat single-graph batch (numpy)."""

    x: np.ndarray          # (N, d) node features
    edge_src: np.ndarray   # (E,)
    edge_dst: np.ndarray   # (E,)
    edge_mask: np.ndarray  # (E,) bool
    labels: np.ndarray     # (N,) int labels
    coords: Optional[np.ndarray] = None  # (N, 3)

    @property
    def n(self) -> int:
        return self.x.shape[0]

    @property
    def e(self) -> int:
        return self.edge_src.shape[0]


def flat_batch_from_graph(
    g: Graph,
    d_feat: int,
    n_classes: int,
    *,
    with_coords: bool = False,
    with_triplets: bool = False,
    seed: int = 0,
) -> FlatGraphBatch:
    """Synthetic features/labels over a real topology (no dataset
    downloads; shapes and sparsity patterns are what matter)."""
    _no_triplets(with_triplets)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(g.n, d_feat)).astype(np.float32)
    labels = rng.integers(0, n_classes, size=g.n).astype(np.int32)
    coords = (
        rng.normal(size=(g.n, 3)).astype(np.float32)
        if with_coords else None
    )
    return FlatGraphBatch(
        x=x, edge_src=g.src, edge_dst=g.dst,
        edge_mask=np.ones(g.m, dtype=bool), labels=labels, coords=coords,
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


def random_molecule_batch(
    batch: int, n_atoms: int, n_edges: int, n_species: int = 10,
    seed: int = 0, with_triplets: bool = False,
) -> PackedGraphBatch:
    """Random molecular graphs: each atom's nearest neighbours over
    random coords, one-hot species features; graphs of fewer than
    ``n_edges`` edges padded with masked edges 0 -> 0."""
    _no_triplets(with_triplets)
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
    return PackedGraphBatch(x=x, edge_src=es, edge_dst=ed, edge_mask=em,
                            coords=coords, y=y)
