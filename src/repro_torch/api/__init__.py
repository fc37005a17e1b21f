"""The port's solver facade: ``Solver(spec).solve(Problem(g, SingleSource(s)))``,
``solve_batch`` and ``resolve``."""

from repro_torch.api.config import SolverConfig, as_config
from repro_torch.api.problem import (
    EveryVertex,
    ExplicitSources,
    MultiSource,
    Problem,
    SingleSource,
    as_source_spec,
)
from repro_torch.api.solver import Solution, Solver, batch_bucket, exchange_words

__all__ = [
    "SolverConfig", "as_config", "EveryVertex", "ExplicitSources",
    "MultiSource", "Problem", "SingleSource", "as_source_spec",
    "Solution", "Solver", "batch_bucket", "exchange_words",
]
