"""Per-superstep flight recorder: `SolveTrace` + the controller tap.

The ``/adapt`` seam (``EngineConfig.adapt_window > 0``) already makes
the engine publish per-superstep metrics windows so a policy can
retune between segments.  The flight recorder generalizes that seam to
*observation without intervention*: a ``/trace`` solve runs through
the same segment engine under the no-op ``StaticPolicy`` — by the
self-stabilization argument, segmenting the schedule cannot move the
fixpoint, so the traced solve is bit-identical
(state **and** WorkMetrics) to the untraced one — and a
:class:`FlightRecorder` collects every segment's
:class:`~repro_torch.core.metrics.SuperstepWindow` into a :class:`SolveTrace`
attached to ``Solution.trace``.

The trace is exact, not sampled: Σ ``bytes_moved`` equals the
aggregate ``WorkMetrics.exchange_bytes`` (each superstep's bytes are
derived from its sparse/dense choice and its segment's static
capacities — the same arithmetic ``api.solver.exchange_words`` uses
for the aggregate), Σ ``eligible`` equals ``commits``, and the last
``pending`` entry is 0 iff the solve converged.
:meth:`SolveTrace.reconcile` machine-checks all of this against a
``WorkMetrics``.

Over a process backend (``core/ranks.py::ProcessRanks``) every
window is global, so every process records the same trace; only the
segments' wall timestamps are each process's own, and rank 0's trace is
the one a caller reports.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.core.metrics import SuperstepWindow, WorkMetrics
from repro_torch.obs import trace as obs_trace

__all__ = ["FlightRecorder", "SolveTrace"]


@dataclasses.dataclass
class SolveTrace:
    """Per-superstep record of one solve.

    The five per-superstep lists are indexed by superstep (0-based,
    concatenated across segments, length == engine supersteps).
    ``segments`` holds one dict per segment-engine invocation:
    ``{"segment", "supersteps", "t0", "t1", "frontier_cap", "delta",
    "force", "fallbacks", "retraced"}`` — wall timestamps come from
    the active tracer's clock, so exporters can place superstep
    counter samples inside the segment spans that produced them.

    ``host_sweeps`` counts supersteps performed host-side *outside*
    the segment engine (the ``resolve`` bootstrap sweep); they appear
    in the aggregate ``WorkMetrics.supersteps`` but have no
    per-superstep window.
    """

    config_name: str = ""
    n: int = 0                       # global padded vertex count
    rows_per_rank: int = 0
    sparse_capable: bool = False
    pending: list = dataclasses.field(default_factory=list)
    eligible: list = dataclasses.field(default_factory=list)
    rows: list = dataclasses.field(default_factory=list)
    sparse_used: list = dataclasses.field(default_factory=list)
    bytes_moved: list = dataclasses.field(default_factory=list)
    segments: list = dataclasses.field(default_factory=list)
    host_sweeps: int = 0
    repair_sweeps: int = 0

    @property
    def supersteps(self) -> int:
        return len(self.pending)

    def total_bytes(self) -> int:
        return int(sum(self.bytes_moved))

    def reconcile(self, m: WorkMetrics) -> None:
        """Assert this trace sums exactly to the aggregate metrics.
        Raises ``AssertionError`` naming the first mismatched quantity."""
        assert self.supersteps + self.host_sweeps == m.supersteps, (
            f"supersteps: trace {self.supersteps} + host {self.host_sweeps} "
            f"!= aggregate {m.supersteps}")
        assert self.total_bytes() == m.exchange_bytes, (
            f"bytes: trace Σ{self.total_bytes()} != "
            f"aggregate {m.exchange_bytes}")
        assert sum(self.eligible) == m.commits, (
            f"commits: trace Σeligible {sum(self.eligible)} != "
            f"aggregate {m.commits}")
        n_fallback = sum(
            1 for s in self.sparse_used if not s
        ) if self.sparse_capable else 0
        assert n_fallback == m.sparse_fallbacks, (
            f"sparse_fallbacks: trace {n_fallback} != "
            f"aggregate {m.sparse_fallbacks}")
        if m.converged and self.pending:
            assert self.pending[-1] == 0, (
                f"converged solve ended with pending={self.pending[-1]}")
        assert self.repair_sweeps == m.repair_sweeps, (
            f"repair_sweeps: trace {self.repair_sweeps} != "
            f"aggregate {m.repair_sweeps}")

    def table(self) -> str:
        """Fixed-width per-superstep convergence table — the paper's
        work-vs-ordering narrative, one row per superstep."""
        head = (f"{'step':>5} {'pending':>10} {'eligible':>10} "
                f"{'rows':>8} {'exch':>7} {'bytes':>12}")
        lines = [head, "-" * len(head)]
        for i in range(self.supersteps):
            exch = ("sparse" if self.sparse_used[i] else "dense") \
                if self.sparse_capable else "dense"
            lines.append(
                f"{i:>5} {self.pending[i]:>10} {self.eligible[i]:>10} "
                f"{self.rows[i]:>8} {exch:>7} {self.bytes_moved[i]:>12}")
        lines.append(
            f"total supersteps={self.supersteps} (+{self.host_sweeps} host) "
            f"bytes={self.total_bytes()} segments={len(self.segments)}")
        return "\n".join(lines)

    def as_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def superstep_records(self) -> list[dict[str, Any]]:
        """One flat dict per superstep (JSONL flight-record rows)."""
        return [
            {
                "step": i,
                "pending": self.pending[i],
                "eligible": self.eligible[i],
                "rows": self.rows[i],
                "sparse_used": int(self.sparse_used[i]),
                "bytes_moved": self.bytes_moved[i],
                "config": self.config_name,
            }
            for i in range(self.supersteps)
        ]


class FlightRecorder:
    """Collects segment windows into a :class:`SolveTrace`.

    An instance's :meth:`on_window` is handed to
    :func:`repro_torch.tune.controller.run_adaptive` as its ``on_window``
    callback; the controller invokes it once per segment (including
    the final one) *before* consulting the policy, so recording works
    both for pure ``/trace`` solves (StaticPolicy — no intervention)
    and for ``/trace``-composed ``/adapt`` solves (the record then
    reflects the retuned schedule, not the static spec).
    """

    def __init__(self, config_name: str = ""):
        self.trace = SolveTrace(config_name=config_name)
        self._n_segments = 0

    def on_window(self, window: SuperstepWindow,
                  seg: Optional[dict[str, Any]] = None) -> None:
        tr = self.trace
        if self._n_segments == 0:
            tr.n = window.n
            tr.rows_per_rank = window.rows_per_rank
            tr.sparse_capable = window.sparse_capable
        tr.pending.extend(window.pending)
        tr.eligible.extend(window.eligible)
        tr.rows.extend(window.rows)
        tr.sparse_used.extend(window.sparse_used)
        tr.bytes_moved.extend(window.bytes_moved)
        rec = {"segment": self._n_segments,
               "supersteps": len(window.pending)}
        if seg:
            rec.update(seg)
        rec.setdefault("t0", obs_trace.now())
        rec.setdefault("t1", rec["t0"])
        tr.segments.append(rec)
        self._n_segments += 1

    def finish(self, m: WorkMetrics) -> SolveTrace:
        """Seal the trace against the solve's aggregate metrics."""
        self.trace.repair_sweeps = m.repair_sweeps
        return self.trace
