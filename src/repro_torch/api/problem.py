"""Problem statements for the solver facade: the graph, the processing
function π and the initial workitem set S of one query.

    Problem(g, SingleSource(0))                  # SSSP/BFS from 0
    Problem(g, EveryVertex(), processing="cc")   # CC label propagation
    Problem(g, SingleSource(0), processing="sswp")  # widest path
    Problem(g, MultiSource([0, 9]))              # several sources
    Problem(g, ExplicitSources([(3, 1.5, 0)]))   # raw (vertex, state, level)
"""

from __future__ import annotations

import dataclasses
import numbers
from typing import Sequence, Tuple, Union

import numpy as np

from repro_torch.core.ordering import suggest
from repro_torch.core.processing import PROCESSING_FNS, ProcessingFn
from repro_torch.graph.formats import Graph
from repro_torch.graph.partition import PartitionedGraph


def get_processing(p: Union[str, ProcessingFn]) -> ProcessingFn:
    if isinstance(p, ProcessingFn):
        return p
    try:
        return PROCESSING_FNS[p]
    except KeyError:
        raise ValueError(
            f"unknown processing {p!r}; registered: {sorted(PROCESSING_FNS)}"
            f"{suggest(str(p), PROCESSING_FNS)}"
        ) from None


@dataclasses.dataclass(frozen=True)
class SingleSource:
    """One initial workitem; ``value=None`` means the processing
    function's natural source state (0 for SSSP/BFS, +inf for SSWP)."""

    vertex: int
    value: float | None = None
    level: int = 0

    def items(self, processing: ProcessingFn, n: int) -> list[tuple]:
        v = int(self.vertex)
        if not 0 <= v < n:
            raise ValueError(f"source vertex {v} outside [0, {n})")
        val = (
            processing.initial_value(v)
            if self.value is None
            else float(self.value)
        )
        return [(v, val, int(self.level))]


@dataclasses.dataclass(frozen=True)
class MultiSource:
    """Several sources, each at its natural initial state."""

    vertices: Tuple[int, ...]

    def __post_init__(self):
        object.__setattr__(self, "vertices", tuple(int(v) for v in self.vertices))

    def items(self, processing: ProcessingFn, n: int) -> list[tuple]:
        out = []
        for v in self.vertices:
            out.extend(SingleSource(v).items(processing, n))
        return out


@dataclasses.dataclass(frozen=True)
class EveryVertex:
    """One initial workitem per vertex (CC's S = {⟨v, v⟩ : v ∈ V})."""

    def items(self, processing: ProcessingFn, n: int) -> list[tuple]:
        return [(v, processing.initial_value(v), 0) for v in range(n)]


@dataclasses.dataclass(frozen=True)
class ExplicitSources:
    """Raw ``(vertex, state, level)`` triples."""

    triples: Tuple[Tuple[int, float, int], ...]

    def __post_init__(self):
        object.__setattr__(
            self,
            "triples",
            tuple((int(v), float(s), int(l)) for v, s, l in self.triples),
        )

    def items(self, processing: ProcessingFn, n: int) -> list[tuple]:
        for v, _, _ in self.triples:
            if not 0 <= v < n:
                raise ValueError(f"source vertex {v} outside [0, {n})")
        return list(self.triples)


SourceSpec = Union[SingleSource, MultiSource, EveryVertex, ExplicitSources]


def as_source_spec(x) -> SourceSpec:
    """An integer (incl. numpy) is a SingleSource, a sequence of integers
    a MultiSource, a sequence of triples ExplicitSources."""
    if isinstance(x, (SingleSource, MultiSource, EveryVertex, ExplicitSources)):
        return x
    if isinstance(x, numbers.Integral):
        return SingleSource(int(x))
    if isinstance(x, (Sequence, np.ndarray)):
        if all(isinstance(v, numbers.Integral) for v in x):
            return MultiSource(tuple(int(v) for v in x))
        return ExplicitSources(tuple(x))
    raise TypeError(f"cannot interpret {x!r} as a source spec")


@dataclasses.dataclass(frozen=True, eq=False)
class Problem:
    """One query: graph + initial workitems + processing function."""

    graph: Union[Graph, PartitionedGraph]
    sources: SourceSpec
    processing: Union[str, ProcessingFn] = "sssp"

    def __post_init__(self):
        object.__setattr__(self, "sources", as_source_spec(self.sources))
        get_processing(self.processing)  # validate early

    @property
    def processing_fn(self) -> ProcessingFn:
        return get_processing(self.processing)

    @property
    def n(self) -> int:
        return self.graph.n

    def source_items(self) -> list[tuple]:
        return self.sources.items(self.processing_fn, self.n)
