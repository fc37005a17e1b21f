"""Byte-budgeted LRU solution cache for the serving tier (the JAX
package's ``repro.serve.cache`` over the port's solutions).

One entry = one committed :class:`repro_torch.api.Solution`, keyed by
``(graph_fingerprint, source, config_name, processing)`` — exactly the
inputs that determine the fixpoint, so a hit is always servable as-is.
The fingerprint component is what makes streaming updates safe by
construction: every applied edge update advances the graph's
(hash-chained) fingerprint, so stale entries become unreachable the
moment the graph changes, whether or not the feed refreshes them.

Eviction is by resident bytes, not entry count: solutions on a
scale-24 graph are ~128 MB each while scale-9 test solutions are KBs,
so a count-bounded cache would be either useless or unbounded.  LRU
order; hit/miss/eviction counters feed the serving SLO report.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Iterator, Optional, Tuple

from repro_torch.api.solver import Solution

#: (graph_fingerprint, source_vertex, config_name, processing_name)
CacheKey = Tuple[tuple, int, str, str]


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    invalidations: int = 0
    bytes: int = 0        # currently resident
    peak_bytes: int = 0

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["hit_rate"] = self.hit_rate()
        return d

    def __str__(self) -> str:
        return (
            f"hits={self.hits} misses={self.misses} "
            f"rate={self.hit_rate():.3f} evictions={self.evictions} "
            f"bytes={self.bytes}"
        )


class SolutionCache:
    """LRU over solutions with a byte budget.

    ``get``/``put`` are the serving hot path; ``entries_for`` /
    ``invalidate_graph`` are the streaming-update seams (refresh every
    cached answer for a perturbed graph via warm restarts, or drop
    them when the perturbation was non-improving).
    """

    def __init__(self, byte_budget: int = 64 << 20):
        if byte_budget <= 0:
            raise ValueError(f"byte_budget must be positive: {byte_budget}")
        self.byte_budget = int(byte_budget)
        self._d: "OrderedDict[CacheKey, Solution]" = OrderedDict()
        self.stats = CacheStats()

    def __len__(self) -> int:
        return len(self._d)

    @staticmethod
    def key_for(
        fingerprint: tuple, source: int, config_name: str,
        processing: str = "sssp",
    ) -> CacheKey:
        return (tuple(fingerprint), int(source), str(config_name),
                str(processing))

    def get(self, key: CacheKey) -> Optional[Solution]:
        sol = self._d.get(key)
        if sol is None:
            self.stats.misses += 1
            return None
        self._d.move_to_end(key)
        self.stats.hits += 1
        return sol

    def peek(self, key: CacheKey) -> Optional[Solution]:
        """Lookup without touching LRU order or counters (the update
        feed inspecting entries must not skew the serving hit rate)."""
        return self._d.get(key)

    def put(self, key: CacheKey, sol: Solution) -> None:
        old = self._d.pop(key, None)
        if old is not None:
            self.stats.bytes -= old.nbytes
        self._d[key] = sol
        self.stats.bytes += sol.nbytes
        self.stats.peak_bytes = max(self.stats.peak_bytes, self.stats.bytes)
        # evict least-recently-used until under budget; a single entry
        # larger than the whole budget stays resident alone (evicting
        # it would make the cache never admit large-graph solutions)
        while self.stats.bytes > self.byte_budget and len(self._d) > 1:
            _, victim = self._d.popitem(last=False)
            self.stats.bytes -= victim.nbytes
            self.stats.evictions += 1

    def pop(self, key: CacheKey) -> Optional[Solution]:
        sol = self._d.pop(key, None)
        if sol is not None:
            self.stats.bytes -= sol.nbytes
        return sol

    # -- streaming-update seams ---------------------------------------

    def entries_for(self, fingerprint: tuple) -> list:
        """[(key, solution)] currently cached for one graph version —
        snapshot list, safe to mutate the cache while iterating."""
        fingerprint = tuple(fingerprint)
        return [(k, s) for k, s in self._d.items() if k[0] == fingerprint]

    def invalidate_graph(self, fingerprint: tuple) -> int:
        """Drop every entry for one graph version (non-improving
        perturbation: the cached states may exceed the new fixpoint,
        which the monotone engine cannot correct).  Returns the number
        dropped."""
        dropped = 0
        for key, _ in self.entries_for(fingerprint):
            self.pop(key)
            dropped += 1
        self.stats.invalidations += dropped
        return dropped

    def clear(self) -> None:
        self._d.clear()
        self.stats.bytes = 0

    def keys(self) -> Iterator[CacheKey]:
        return iter(self._d.keys())
