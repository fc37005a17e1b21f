"""Host-side builder of the flat single-graph batch (numpy): one graph
with x (N, d), edge_src/dst (E,), the same bytes as the JAX package's
``models/gnn/batch.py`` for the same arguments.  Triplet index lists
(DimeNet) and the packed molecule batch are not ported yet."""

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
    if with_triplets:
        raise NotImplementedError(
            "triplet index lists come with the DimeNet port (ROADMAP.md)")
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
