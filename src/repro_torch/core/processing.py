"""Processing functions π (paper §III, Definition 4 and variants) as
torch ops.

* ``edge_update(s, w)`` — the candidate state a workitem ⟨u, s⟩ sends
  across an edge of weight w (SSSP ``s + w``; BFS ``s + 1``; CC ``s``;
  SSWP ``min(s, w)``).
* ``better(a, b)`` — does candidate a improve b.
* ``reduce`` / ``worst`` — the monotone combine and its identity.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch


@dataclasses.dataclass(frozen=True)
class ProcessingFn:
    name: str
    edge_update: Callable  # (src_state, edge_weight) -> candidate
    better: Callable       # (a, b) -> bool, True iff a strictly improves b
    reduce: Callable       # torch.minimum or torch.maximum
    worst: float           # identity of `reduce` (= "no candidate")
    # initial workitem state for a source vertex; None means 0.0
    source_init: Optional[Callable] = None

    @property
    def is_min(self) -> bool:
        return self.reduce is torch.minimum

    @property
    def scatter_op(self) -> str:
        """The ``scatter_reduce`` name of ``reduce``."""
        return "amin" if self.is_min else "amax"

    def initial_value(self, vertex: int) -> float:
        if self.source_init is None:
            return 0.0
        return float(self.source_init(vertex))

    def reduce_array(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return x.amin(dim) if self.is_min else x.amax(dim)


SSSP = ProcessingFn(
    name="sssp",
    edge_update=lambda s, w: s + w,
    better=lambda a, b: a < b,
    reduce=torch.minimum,
    worst=float("inf"),
)

BFS = ProcessingFn(
    name="bfs",
    edge_update=lambda s, w: s + 1.0,
    better=lambda a, b: a < b,
    reduce=torch.minimum,
    worst=float("inf"),
)

# Connected components by min-label propagation: every vertex starts
# pending with its own id.
CC = ProcessingFn(
    name="cc",
    edge_update=lambda s, w: s,
    better=lambda a, b: a < b,
    reduce=torch.minimum,
    worst=float("inf"),
    source_init=lambda v: float(v),
)

# Single-source widest path: maximize the bottleneck capacity.
SSWP = ProcessingFn(
    name="sswp",
    edge_update=lambda s, w: torch.minimum(s, w),
    better=lambda a, b: a > b,
    reduce=torch.maximum,
    worst=float("-inf"),
    source_init=lambda v: float("inf"),
)

PROCESSING_FNS = {p.name: p for p in (SSSP, BFS, CC, SSWP)}
