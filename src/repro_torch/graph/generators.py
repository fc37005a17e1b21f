"""Synthetic graph generators of the paper's evaluation (host-side
numpy).  The same seed gives byte-identical edge arrays to the JAX
package's ``repro.graph.generators``, so both packages solve the same
graphs.

RMAT1: Graph500 BFS-benchmark R-MAT (A=0.57, B=C=0.19, D=0.05),
       uniform random integer weights in [1, 100].
RMAT2: proposed Graph500 SSSP-benchmark R-MAT (A=0.50, B=C=0.10,
       D=0.30), weights in [1, 255].

Plus stand-ins for the paper's SNAP graphs: a 2D grid with random
weights (road network: high diameter) and a Watts-Strogatz small-world
graph (social network: low diameter); and an Erdos-Renyi graph for the
GNN cells.
"""

from __future__ import annotations

import numpy as np

from repro_torch.graph.formats import Graph


def _rmat_edges(
    scale: int,
    m: int,
    a: float,
    b: float,
    c: float,
    rng: np.random.Generator,
) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized R-MAT: decide one bit of (src, dst) per level."""
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    ab = a + b
    abc = a + b + c
    for _ in range(scale):
        r = rng.random(m)
        src_bit = r >= ab
        dst_bit = (r >= a) & (r < ab) | (r >= abc)
        src = (src << 1) | src_bit
        dst = (dst << 1) | dst_bit
    return src.astype(np.int32), dst.astype(np.int32)


def rmat_graph(
    scale: int,
    edge_factor: int = 16,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    max_weight: int = 100,
    seed: int = 0,
    symmetrize: bool = True,
    name: str = "rmat",
) -> Graph:
    n = 1 << scale
    m = n * edge_factor
    rng = np.random.default_rng(seed)
    src, dst = _rmat_edges(scale, m, a, b, c, rng)
    # Graph500 permutes vertex labels so locality is not an artifact of
    # the generator's bit recursion.
    perm = rng.permutation(n).astype(np.int32)
    src, dst = perm[src], perm[dst]
    w = rng.integers(1, max_weight + 1, size=m).astype(np.float32)
    g = Graph(n, src, dst, w, name=f"{name}_s{scale}")
    if symmetrize:
        g = g.symmetrized()
    return g.deduplicated()


def rmat1(scale: int, seed: int = 0, edge_factor: int = 16) -> Graph:
    """Graph500 BFS-spec R-MAT, weights 1..100 (paper's RMAT1)."""
    return rmat_graph(
        scale, edge_factor, a=0.57, b=0.19, c=0.19, max_weight=100,
        seed=seed, name="rmat1",
    )


def rmat2(scale: int, seed: int = 0, edge_factor: int = 16) -> Graph:
    """Graph500 SSSP-spec R-MAT, weights 1..255 (paper's RMAT2)."""
    return rmat_graph(
        scale, edge_factor, a=0.50, b=0.10, c=0.10, max_weight=255,
        seed=seed, name="rmat2",
    )


def grid_road_graph(side: int, seed: int = 0, max_weight: int = 100) -> Graph:
    """2D grid with random weights — a high-diameter road-network proxy."""
    n = side * side
    rng = np.random.default_rng(seed)
    idx = np.arange(n, dtype=np.int32).reshape(side, side)
    src = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
    dst = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
    w = rng.integers(1, max_weight + 1, size=src.shape[0]).astype(np.float32)
    return Graph(n, src, dst, w, name=f"grid_{side}x{side}").symmetrized()


def small_world_graph(
    n: int, k: int = 8, p: float = 0.1, seed: int = 0, max_weight: int = 100
) -> Graph:
    """Watts-Strogatz ring rewiring — low-diameter social-network proxy."""
    rng = np.random.default_rng(seed)
    base = np.arange(n, dtype=np.int64)
    src = np.concatenate([base] * (k // 2))
    dst = np.concatenate([(base + off) % n for off in range(1, k // 2 + 1)])
    rewire = rng.random(src.shape[0]) < p
    dst = np.where(rewire, rng.integers(0, n, size=src.shape[0]), dst)
    w = rng.integers(1, max_weight + 1, size=src.shape[0]).astype(np.float32)
    g = Graph(n, src.astype(np.int32), dst.astype(np.int32), w,
              name=f"smallworld_{n}")
    return g.symmetrized().deduplicated()


def erdos_renyi_graph(
    n: int, avg_degree: float = 8.0, seed: int = 0, max_weight: int = 100
) -> Graph:
    """G(n, m) with m = n * avg_degree uniform random edges, symmetrized
    and deduplicated (the Cora-sized ``full_graph_sm`` test graph)."""
    rng = np.random.default_rng(seed)
    m = int(n * avg_degree)
    src = rng.integers(0, n, size=m).astype(np.int32)
    dst = rng.integers(0, n, size=m).astype(np.int32)
    w = rng.integers(1, max_weight + 1, size=m).astype(np.float32)
    return Graph(n, src, dst, w, name=f"er_{n}").symmetrized().deduplicated()
