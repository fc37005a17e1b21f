"""repro_torch.analyze — the static-analysis gate of the port: checks of
the engine and its processing functions.

The paper's guarantee (any self-stabilizing kernel wrapped by any
AGM/EAGM ordering converges) only holds when the processing function
really is a self-stabilizing kernel and the engine's hot loop really is
the monotone dataflow the proofs assume.  This package checks both:

  contract.py     self-stabilization contract verifier: every
                  registered ProcessingFn is checked against the
                  algebraic laws (idempotent/commutative/selective
                  reduce, inflationary monotone relaxation, top-element
                  identity) by exhaustive small-domain evaluation plus
                  inspection by op recording; violations name the law
                  and carry a witness input.
  engine_lint.py  the engine run for a few supersteps on a seeded graph
                  over the spec grid, its ops, host reads and
                  collectives recorded: host syncs, float64, payload
                  dtype and layout, a kernel spec that escapes its
                  kernel, the collective plan (the counterpart of the
                  JAX package's jaxpr and HLO lints).
  spec_check.py   parse-time cross-checks of exchange mode ×
                  frontier_cap × partitioner × hierarchy compatibility,
                  plus ``explain_config`` — the collective plan per
                  spec, running nothing.
  report.py       runs all passes over the spec grid, applies the
                  baseline, emits ``ANALYZE_report_torch.json``.

CLI: ``python -m repro_torch.launch.analyze`` (see README, "PyTorch/CUDA
port").
"""

from repro_torch.analyze.findings import (
    Finding,
    fingerprint,
    load_baseline,
    split_baselined,
)
from repro_torch.analyze.contract import (
    ContractViolation,
    verify_processing,
    verify_registered,
)
from repro_torch.analyze.engine_lint import (
    StepShape,
    lint_engine,
    lint_grid,
    payload_capacity,
)
from repro_torch.analyze.spec_check import check_config, explain_config
from repro_torch.analyze.report import run_report

__all__ = [
    "Finding", "fingerprint", "load_baseline", "split_baselined",
    "ContractViolation", "verify_processing", "verify_registered",
    "StepShape", "lint_engine", "lint_grid", "payload_capacity",
    "check_config", "explain_config",
    "run_report",
]
