"""Host-side fanout neighbor sampler (GraphSAGE-style) for the GNN
``minibatch_lg`` shape cells.

Given seed nodes and per-layer fanouts (e.g. [15, 10]), builds a
layered block: layer l samples up to ``fanout[l]`` neighbors of every
frontier node.  The device step consumes *padded, fixed-shape* arrays
(src/dst indices into the block's node list plus a validity mask), so
the same GNN step serves every minibatch.  The same blocks, byte for
byte, as the JAX package's sampler for the same graph, fanouts and seed.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.graph.formats import CSR, Graph, coo_to_csr


@dataclasses.dataclass
class SampledBlock:
    """A layered minibatch block.

    nodes:      (n_nodes_pad,) int32 global ids of all block nodes
                (seeds first), padded with 0 beyond ``n_nodes``.
    node_mask:  (n_nodes_pad,) bool validity.
    edge_src/edge_dst: (n_edges_pad,) int32 *block-local* indices.
    edge_mask:  (n_edges_pad,) bool validity.
    edge_layer: (n_edges_pad,) int8 which hop the edge belongs to.
    n_seeds:    number of seed (output) nodes = first n_seeds of nodes.
    """

    nodes: np.ndarray
    node_mask: np.ndarray
    edge_src: np.ndarray
    edge_dst: np.ndarray
    edge_mask: np.ndarray
    edge_layer: np.ndarray
    n_seeds: int
    n_nodes: int
    n_edges: int


class FanoutSampler:
    """Uniform without-replacement fanout sampling over a CSR graph."""

    def __init__(self, graph: Graph, fanouts: Sequence[int], seed: int = 0):
        self.csr: CSR = coo_to_csr(graph)
        self.fanouts = list(fanouts)
        self.rng = np.random.default_rng(seed)

    def padded_sizes(self, batch_nodes: int) -> tuple[int, int]:
        """Static (n_nodes_pad, n_edges_pad) for a given seed count."""
        n_nodes = batch_nodes
        n_edges = 0
        frontier = batch_nodes
        for f in self.fanouts:
            n_edges += frontier * f
            frontier = frontier * f
            n_nodes += frontier
        return n_nodes, n_edges

    def sample(self, seeds: np.ndarray) -> SampledBlock:
        seeds = np.asarray(seeds, dtype=np.int32)
        n_nodes_pad, n_edges_pad = self.padded_sizes(seeds.shape[0])

        # block-local node table: seeds first, then per-layer samples
        nodes = [seeds]
        local_of = {int(v): i for i, v in enumerate(seeds)}
        e_src, e_dst, e_layer = [], [], []
        frontier_local = np.arange(seeds.shape[0], dtype=np.int32)
        frontier_global = seeds

        for layer, fan in enumerate(self.fanouts):
            new_src, new_dst_global = [], []
            for lidx, v in zip(frontier_local, frontier_global):
                lo, hi = self.csr.row_ptr[v], self.csr.row_ptr[v + 1]
                deg = int(hi - lo)
                if deg == 0:
                    continue
                take = min(fan, deg)
                pick = self.rng.choice(deg, size=take, replace=False)
                nbrs = self.csr.col_idx[lo + pick]
                new_src.extend([int(lidx)] * take)
                new_dst_global.extend(int(u) for u in nbrs)
            # register new nodes
            dst_local = []
            next_frontier_local, next_frontier_global = [], []
            for u in new_dst_global:
                if u not in local_of:
                    local_of[u] = sum(len(a) for a in nodes) + len(
                        next_frontier_global
                    )
                    next_frontier_global.append(u)
                    next_frontier_local.append(local_of[u])
                dst_local.append(local_of[u])
            if next_frontier_global:
                nodes.append(np.asarray(next_frontier_global, dtype=np.int32))
            e_src.extend(new_src)
            e_dst.extend(dst_local)
            e_layer.extend([layer] * len(new_src))
            frontier_local = np.asarray(next_frontier_local, dtype=np.int32)
            frontier_global = np.asarray(next_frontier_global, dtype=np.int32)
            if frontier_global.size == 0:
                break

        all_nodes = np.concatenate(nodes) if nodes else seeds
        n_nodes = int(all_nodes.shape[0])
        n_edges = len(e_src)

        out_nodes = np.zeros(n_nodes_pad, dtype=np.int32)
        out_nodes[:n_nodes] = all_nodes
        node_mask = np.zeros(n_nodes_pad, dtype=bool)
        node_mask[:n_nodes] = True
        edge_src = np.zeros(n_edges_pad, dtype=np.int32)
        edge_dst = np.zeros(n_edges_pad, dtype=np.int32)
        edge_mask = np.zeros(n_edges_pad, dtype=bool)
        edge_layer = np.zeros(n_edges_pad, dtype=np.int8)
        edge_src[:n_edges] = e_src
        edge_dst[:n_edges] = e_dst
        edge_mask[:n_edges] = True
        edge_layer[:n_edges] = e_layer

        return SampledBlock(
            nodes=out_nodes, node_mask=node_mask, edge_src=edge_src,
            edge_dst=edge_dst, edge_mask=edge_mask, edge_layer=edge_layer,
            n_seeds=int(seeds.shape[0]), n_nodes=n_nodes, n_edges=n_edges,
        )
