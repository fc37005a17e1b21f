"""Run every analyze pass over the spec grid and gate.

The grid is the paper's family grid crossed with every exchange mode
and every partitioner — the same space the JAX package's gate sweeps
(:func:`grid_specs` gives its list).  The engine pass runs one engine a
distinct program (a partitioner relabels data, not code); the spec pass
runs per point; the contract pass runs per registered processing
function.

``run_report`` returns the JSON-serializable report (the CLI writes it
to ``ANALYZE_report_torch.json``) and gates on it: any finding of
gating severity (error/warn) that is not in the baseline fails.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.analyze import contract as _contract
from repro_torch.analyze import spec_check as _spec
from repro_torch.analyze.engine_lint import StepShape, lint_grid
from repro_torch.analyze.findings import (
    gate_failures,
    load_baseline,
    split_baselined,
)
from repro_torch.api.config import SolverConfig
from repro_torch.api.problem import get_processing
from repro_torch.core.eagm import paper_variant_specs

#: exchanges × partitioners spanning the grid
ALL_EXCHANGES = ("a2a", "pmin", "sparse", "auto")
ALL_PARTITIONERS = ("block", "shuffle", "ebal", "degree")

#: fused-kernel and quantized-payload points that ride along, so the
#: gate covers the '/fused' and '/q:*' spec surface too
EXTRA_SPECS = (
    "delta:5/sparse/fused",
    "delta:5/sparse/q:bf16",
    "delta:5/sparse/fused/q:u16",
)


def grid_specs(
    exchanges: Sequence[str] = ALL_EXCHANGES,
    partitioners: Sequence[str] = ALL_PARTITIONERS,
    quick: bool = False,
) -> list:
    """The full spec grid as spec strings (hierarchy × exchange ×
    partitioner).  ``quick`` trims to one delta/k per root kind."""
    roots = paper_variant_specs()
    if quick:
        roots = [
            s for s in roots
            if s.split("+")[0] in ("delta:5", "kla:2", "chaotic",
                                   "dijkstra")
        ]
    specs = []
    for root in roots:
        for ex in exchanges:
            for part in partitioners:
                s = f"{root}/{ex}"
                if part != "block":
                    s += f"@{part}"
                specs.append(s)
    return specs


def run_report(
    *,
    baseline_path: Optional[str] = None,
    shape: StepShape = StepShape(),
    n_parts: Optional[int] = None,
    device=None,
    mesh_axes: Sequence[str] = ("data",),
    quick: bool = False,
    exchanges: Sequence[str] = ALL_EXCHANGES,
    partitioners: Sequence[str] = ALL_PARTITIONERS,
) -> dict:
    """All passes; returns the report dict (key ``ok`` is the gate
    verdict).  The engine pass runs ``n_parts`` stacked ranks (default
    ``shape.n_parts``) on ``device`` (None: the card)."""
    if n_parts is not None:
        shape = dataclasses.replace(shape, n_parts=int(n_parts))
    findings: list = []

    # -- contract pass over every registered processing fn -------------
    results = _contract.verify_registered()
    findings += _contract.contract_findings(results)
    contract_summary = {
        name: [str(v) for v in vs] for name, vs in results.items()
    }

    # -- spec + engine passes over the grid -----------------------------
    specs = grid_specs(exchanges, partitioners, quick=quick) + list(EXTRA_SPECS)
    shape_dict = dict(
        n_local=shape.n_local, rows=shape.rows, width=shape.width,
        n_parts=shape.n_parts,
    )
    sssp = get_processing("sssp")
    engine_cfgs = []
    for s in specs:
        cfg = SolverConfig.from_spec(s)
        findings += _spec.check_config(
            cfg, shape=shape_dict, mesh_axes=mesh_axes
        )
        engine_cfgs.append(cfg.engine_config(sssp))
    engine_stats: dict = {}
    engine_results = lint_grid(engine_cfgs, shape, device=device,
                               stats=engine_stats)
    for fs in engine_results.values():
        findings += fs

    # -- gate ------------------------------------------------------------
    baseline = load_baseline(baseline_path)
    fresh, baselined = split_baselined(findings, baseline)
    failures = gate_failures(fresh)
    counts = {"error": 0, "warn": 0, "info": 0}
    for f in findings:
        counts[f.severity] += 1
    return {
        "ok": not failures,
        "points": len(specs),
        "traced_engines": len(engine_results),
        "processing_checked": sorted(results),
        "contract": contract_summary,
        "engine": engine_stats,
        "counts": counts,
        "findings": [f.to_dict() for f in fresh],
        "baselined": [f.to_dict() for f in baselined],
        "shape": shape_dict,
    }


def render_report(report: dict) -> str:
    """Human summary for the CLI."""
    lines = [
        f"analyze: {report['points']} spec-grid points "
        f"({report['traced_engines']} distinct engines run), "
        f"processing={','.join(report['processing_checked'])}",
        f"findings: {report['counts']['error']} error / "
        f"{report['counts']['warn']} warn / "
        f"{report['counts']['info']} info "
        f"({len(report['baselined'])} baselined)",
    ]
    shown = 0
    for f in report["findings"]:
        if f["severity"] == "info":
            continue
        lines.append(
            f"  {f['severity'].upper():5s} {f['pass_name']}/{f['rule']}"
            f" ({f['subject']}) {f['message']}"
            + (f" witness: {f['witness']}" if f.get("witness") else "")
        )
        shown += 1
        if shown >= 40:
            lines.append("  ... (truncated)")
            break
    lines.append("GATE: " + ("OK" if report["ok"] else "FAIL"))
    return "\n".join(lines)
