"""The port's solver facade: ``Solver(spec).solve(Problem(g, SingleSource(s)))``."""

from repro_torch.api.config import SolverConfig, as_config
from repro_torch.api.problem import EveryVertex, Problem, SingleSource
from repro_torch.api.solver import Solution, Solver, exchange_words

__all__ = [
    "SolverConfig", "as_config", "EveryVertex", "Problem", "SingleSource",
    "Solution", "Solver", "exchange_words",
]
