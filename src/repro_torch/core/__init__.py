"""AGM/EAGM core of the port — the paper's primary contribution in torch.

  ordering.py    strict weak orderings (chaotic/dijkstra/Δ/KLA/topk)
  processing.py  processing functions π (SSSP/BFS/CC/SSWP)
  eagm.py        per-level ordering hierarchies and the paper presets
  frontier.py    frontier compaction + sparse candidate exchange
  engine.py      rank-stacked superstep engine
  selfstab.py    the self-stabilizing sweep (Algorithm 1)
  agm.py         the logical AGM (Definition 3) and the Dijkstra oracle
  metrics.py     work/sync metrics
"""

from repro_torch.core.agm import AGM, dijkstra_reference, run_logical, sssp_agm
from repro_torch.core.eagm import (
    LEVELS,
    Hierarchy,
    as_hierarchy,
    make_hierarchy,
    paper_variant_grid,
    paper_variant_specs,
)
from repro_torch.core.engine import (
    EXCHANGE_MODES,
    RELAX_IMPLS,
    EngineConfig,
    EngineResult,
    Segment,
    SegmentResult,
    cc_sources,
    initial_state,
    initial_state_batch,
    run_engine,
    run_segment,
    sssp_sources,
)
from repro_torch.core.metrics import (
    LatencyStats,
    SuperstepWindow,
    WorkMetrics,
    model_time_s,
)
from repro_torch.core.ordering import (
    KLA,
    Chaotic,
    DeltaStepping,
    Dijkstra,
    Ordering,
    TopK,
    make_ordering,
    ordering_kinds,
    register_ordering,
)
from repro_torch.core.processing import BFS, CC, SSSP, SSWP, ProcessingFn

__all__ = [
    "AGM", "dijkstra_reference", "run_logical", "sssp_agm",
    "LEVELS", "Hierarchy", "as_hierarchy", "make_hierarchy",
    "paper_variant_grid", "paper_variant_specs",
    "EXCHANGE_MODES", "RELAX_IMPLS", "EngineConfig", "EngineResult",
    "Segment", "SegmentResult", "cc_sources", "initial_state",
    "initial_state_batch", "run_engine", "run_segment", "sssp_sources",
    "LatencyStats", "SuperstepWindow", "WorkMetrics", "model_time_s",
    "KLA", "Chaotic", "DeltaStepping", "Dijkstra", "Ordering", "TopK",
    "make_ordering", "ordering_kinds", "register_ordering",
    "BFS", "CC", "SSSP", "SSWP", "ProcessingFn",
]
