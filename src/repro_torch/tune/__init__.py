"""repro_torch.tune — adaptive execution controller and offline spec
auto-tuner: the runtime and offline halves of the paper's "generate the
algorithm for the target architecture" (arXiv 1706.05760 §VII), made
safe by self-stabilization: retuning the ordering mid-solve reorders
the schedule but cannot move the kernel's fixpoint.

* **Runtime controller** (``/adapt[:policy]`` in the spec grammar):
  the engine runs in segments of ``EngineConfig.adapt_window``
  supersteps and publishes a per-superstep window; a
  :mod:`policy <repro_torch.tune.policies>` maps the window to the
  next segment's Δ, frontier capacity (rho-stepping growth on
  overflow) and sparse/dense exchange choice.  A frontier cap the
  solve has not used before counts in ``Solution.metrics.retraces``,
  the JAX package's count of engines it compiles (the port compiles
  none).

* **Offline auto-tuner** (:class:`AutoTuner`): coordinate-descent
  search over ordering x exchange x partitioner scored by pilot
  solves, winner cached in a :class:`TunedSpecCache` keyed by graph
  fingerprint (hash-chain aware, so streamed updates re-tune).
  ``repro_torch.serve.Router`` consults the cache on admission;
  ``launch/tune.py`` is the CLI.
"""

from repro_torch.tune.policies import (
    Decision,
    RhoPolicy,
    ScheduledPolicy,
    StaticPolicy,
    Tunables,
    TunePolicy,
    canonical_policy,
    make_tune_policy,
    policy_traits,
    register_tune_policy,
)
from repro_torch.tune.controller import AdaptReport, run_adaptive
from repro_torch.tune.autotune import (
    OBJECTIVES,
    AutoTuner,
    TunedRecord,
    TunedSpecCache,
)

__all__ = [
    "Decision", "RhoPolicy", "ScheduledPolicy", "StaticPolicy",
    "Tunables", "TunePolicy", "canonical_policy", "make_tune_policy",
    "policy_traits", "register_tune_policy",
    "AdaptReport", "run_adaptive",
    "OBJECTIVES", "AutoTuner", "TunedRecord", "TunedSpecCache",
]
