"""Work / synchronization metrics of one solve.

The counts are the paper's work terms (relaxations, commits, workitems)
and synchronization terms (classes, supersteps, collective rounds),
plus exchanged bytes; they are identical to the JAX package's for the
same graph, spec and rank count.
"""

from __future__ import annotations

import dataclasses


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
    retraces: int = 0       # adaptive engine rebuilds (not ported: always 0)
    repair_sweeps: int = 0  # quantized-payload repairs (not ported: always 0)

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
        if self.overflow_streak:
            s += f" overflow_streak={self.overflow_streak}"
        return s + ("" if self.converged else " TRUNCATED")


# The JAX package's linear cost model, with its per-unit costs
# calibrated for a TPU v5e pod (relaxation throughput, small-collective
# latency, interconnect bandwidth).  They are that target's constants,
# kept so both packages report the same modelled time; nothing here is
# a GPU measurement.
COST_RELAX_S = 2.0e-9
COST_SUPERSTEP_S = 15e-6
COST_BYTE_S = 1.0 / 45e9


def model_time_s(m: WorkMetrics, n_chips: int = 1) -> float:
    """Cost-model seconds for one solve on ``n_chips`` of the modelled
    TPU pod (work terms divide across chips; superstep latency does
    not)."""
    return (
        COST_RELAX_S * m.relaxations / n_chips
        + COST_SUPERSTEP_S * m.supersteps
        + COST_BYTE_S * m.exchange_bytes / n_chips
    )
