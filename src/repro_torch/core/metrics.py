"""Work / synchronization metrics of one solve.

The counts are the paper's work terms (relaxations, commits, workitems)
and synchronization terms (classes, supersteps, collective rounds),
plus exchanged bytes; they are identical to the JAX package's for the
same graph, spec and rank count.  :class:`SuperstepWindow` is one
adaptive segment's per-superstep record, :class:`LatencyStats` the
serving tier's latency order statistics.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass
class WorkMetrics:
    classes: int = 0        # equivalence classes executed (root supersteps)
    workitems: int = 0      # workitems fed to the processing function
    commits: int = 0        # U evaluations that changed state (useful work)
    relaxations: int = 0    # edge relaxations (candidate generations)
    supersteps: int = 0     # engine loop iterations
    exchange_bytes: int = 0  # bytes moved by candidate exchange collectives
    collective_rounds: int = 0
    converged: bool = True  # False iff the loop hit max_iters with work left
    sparse_fallbacks: int = 0  # sparse-capable supersteps that went dense
    overflow_streak: int = 0  # longest run of consecutive capacity overflows
    # frontier caps an adaptive solve first used after its first cap
    # (the JAX package compiles an engine for each; the port compiles
    # nothing and keeps the count for equal metrics)
    retraces: int = 0
    # exact warm restarts the quantized-payload repair loop needed to
    # certify the fixpoint (0 for exact payloads)
    repair_sweeps: int = 0

    def waste_ratio(self) -> float:
        """Relaxations per useful commit — the paper's redundant-work axis."""
        return self.relaxations / max(1, self.commits)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        s = (
            f"classes={self.classes} supersteps={self.supersteps} "
            f"workitems={self.workitems} commits={self.commits} "
            f"relax={self.relaxations} waste={self.waste_ratio():.2f} "
            f"xbytes={self.exchange_bytes}"
        )
        if self.sparse_fallbacks:
            s += f" sparse_fallbacks={self.sparse_fallbacks}"
        if self.retraces:
            s += f" retraces={self.retraces}"
        if self.repair_sweeps:
            s += f" repair_sweeps={self.repair_sweeps}"
        if self.overflow_streak:
            s += f" overflow_streak={self.overflow_streak}"
        return s + ("" if self.converged else " TRUNCATED")


@dataclasses.dataclass
class SuperstepWindow:
    """Per-superstep metrics of one adaptive segment: what a
    :mod:`repro_torch.tune` policy maps to the next segment's tunables
    and what the flight recorder (``/trace``) collects.  Lists hold one
    entry per superstep the segment ran, all summed over ranks; bytes
    are derived on the host from the sparse/dense choice and the
    segment's capacities."""

    pending: list          # pending workitems after each superstep
    eligible: list         # eligible-class size per superstep
    rows: list             # eligible ELL rows per superstep
    sparse_used: list      # 1 iff the sparse exchange ran that superstep
    bytes_moved: list      # exchange bytes per superstep
    overflow_streak: int   # consecutive-overflow run live at segment end
    supersteps_total: int  # supersteps since the solve began
    n: int                 # padded vertex count (P * n_local)
    rows_per_rank: int     # ELL rows per rank (the frontier_cap ceiling)
    sparse_capable: bool   # exchange mode is 'sparse' or 'auto'

    def last_pending(self) -> int:
        return int(self.pending[-1]) if self.pending else 0

    def mean_eligible(self) -> float:
        if not self.eligible:
            return 0.0
        return sum(self.eligible) / len(self.eligible)


@dataclasses.dataclass
class LatencyStats:
    """Order statistics over latency samples (p50/p99 per query).
    Percentiles are nearest-rank, so a reported p99 is an observed
    sample."""

    count: int = 0
    total_s: float = 0.0
    mean_s: float = 0.0
    min_s: float = 0.0
    p50_s: float = 0.0
    p90_s: float = 0.0
    p99_s: float = 0.0
    max_s: float = 0.0

    @classmethod
    def from_samples(cls, samples: Sequence[float]) -> "LatencyStats":
        xs = sorted(float(s) for s in samples)
        if not xs:
            return cls()

        def rank(pct: int) -> float:
            # nearest rank: the smallest sample with cumulative share >= pct%
            i = (pct * len(xs) + 99) // 100
            return xs[min(max(i - 1, 0), len(xs) - 1)]

        return cls(
            count=len(xs),
            total_s=sum(xs),
            mean_s=sum(xs) / len(xs),
            min_s=xs[0],
            p50_s=rank(50),
            p90_s=rank(90),
            p99_s=rank(99),
            max_s=xs[-1],
        )

    def merge(self, other: "LatencyStats") -> "LatencyStats":
        """Combine two windows: count, total, mean, min and max exactly;
        each percentile as the count-weighted mean of the windows' (order
        statistics alone do not merge)."""
        if self.count == 0:
            return dataclasses.replace(other)
        if other.count == 0:
            return dataclasses.replace(self)
        total_n = self.count + other.count

        def wmean(a: float, b: float) -> float:
            return (a * self.count + b * other.count) / total_n

        return LatencyStats(
            count=total_n,
            total_s=self.total_s + other.total_s,
            mean_s=(self.total_s + other.total_s) / total_n,
            min_s=min(self.min_s, other.min_s),
            p50_s=wmean(self.p50_s, other.p50_s),
            p90_s=wmean(self.p90_s, other.p90_s),
            p99_s=wmean(self.p99_s, other.p99_s),
            max_s=max(self.max_s, other.max_s),
        )

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        return (
            f"n={self.count} p50={self.p50_s*1e3:.2f}ms "
            f"p90={self.p90_s*1e3:.2f}ms p99={self.p99_s*1e3:.2f}ms "
            f"max={self.max_s*1e3:.2f}ms"
        )


# The linear cost model of the JAX package, with per-unit costs for one
# NVIDIA H100 80GB HBM3 at its 700.00 W limit, derived from a
# chip_smoke.py run on that card (PERF.md §5): the main solve
# (delta:5/sparse/fused, rmat1 scale 20, one rank) took 28.460 ms of
# device time for 33,117,948 relaxations in a 0.1180 s warm wall over
# 66 supersteps, and the a2a solve over gloo at 2 processes on the card
# took 0.5657 s warm against the stacked solve's 0.2823 s while each
# rank sent 138,412,032 exchange bytes.
COST_RELAX_S = 8.59e-10      # 28.460 ms / 33,117,948 relaxations
COST_SUPERSTEP_S = 1.36e-3   # (0.1180 s - 28.460 ms) / 66: the host's share
COST_BYTE_S = 2.05e-9        # (0.5657 - 0.2823) s / 138,412,032 bytes


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Per-unit costs of :func:`model_time_s`, in seconds."""

    relax_s: float = COST_RELAX_S
    superstep_s: float = COST_SUPERSTEP_S
    byte_s: float = COST_BYTE_S


def model_time_s(m: WorkMetrics, n_chips: int = 1,
                 cost: "CostModel | tuple | None" = None) -> float:
    """Cost-model seconds for one solve on ``n_chips`` cards (work terms
    divide across cards; superstep latency does not).  ``cost`` is a
    :class:`CostModel` or a (relax, superstep, byte) tuple of seconds;
    None takes the H100 figures above."""
    relax_s, superstep_s, byte_s = (
        dataclasses.astuple(CostModel()) if cost is None
        else dataclasses.astuple(cost) if isinstance(cost, CostModel)
        else tuple(cost)
    )
    return (
        relax_s * m.relaxations / n_chips
        + superstep_s * m.supersteps
        + byte_s * m.exchange_bytes / n_chips
    )
