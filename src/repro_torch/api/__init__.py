"""The port's solver facade: ``Solver(spec).solve(Problem(g, SingleSource(s)))``,
``solve_batch``, ``resolve`` and the one-shot ``solve``."""

from repro_torch.core.eagm import Hierarchy, make_hierarchy
from repro_torch.api.config import SolverConfig, as_config
from repro_torch.api.problem import (
    EveryVertex,
    ExplicitSources,
    MultiSource,
    Problem,
    SingleSource,
    as_source_spec,
    get_processing,
    processing_names,
    register_processing,
    registered_processing,
)
from repro_torch.api.solver import (
    Solution,
    Solver,
    batch_bucket,
    exchange_words,
    solve,
)

__all__ = [
    "SolverConfig", "as_config", "Hierarchy", "make_hierarchy", "EveryVertex", "ExplicitSources",
    "MultiSource", "Problem", "SingleSource", "as_source_spec",
    "get_processing", "processing_names", "register_processing",
    "registered_processing",
    "Solution", "Solver", "batch_bucket", "exchange_words", "solve",
]
