"""Static-analysis gate of the port: contract verifier, spec checks and
the engine lint.

    PYTHONPATH=src python -m repro_torch.launch.analyze
    PYTHONPATH=src python -m repro_torch.launch.analyze --quick --device cpu
    PYTHONPATH=src python -m repro_torch.launch.analyze \\
        --explain "delta:5 > chunk:delta:1 /sparse"
    PYTHONPATH=src python -m repro_torch.launch.analyze --quick --ranks 4 \\
        --baseline analyze_baseline_torch.json --json ANALYZE_report_torch.json

Runs every ``repro_torch.analyze`` pass over the paper's spec grid
(hierarchy × exchange × partitioner): the self-stabilization contract
verifier over every registered processing function, the spec checks per
grid point, and the engine lint per distinct engine: a few supersteps
on a seeded R-MAT with ``--ranks`` ranks stacked on ``--device`` (the
card by default; ``cpu`` only when asked).

Exit status is the gate: 0 iff every finding of gating severity
(error/warn) is in the baseline (``--baseline``; a missing file is an
empty baseline); info findings never gate.  ``--write-baseline``
rewrites the baseline file to accept the current findings (review the
diff before committing it).
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="static-analysis gate for the port's AGM engine"
    )
    ap.add_argument(
        "--explain", metavar="SPEC", nargs="+",
        help="print the per-superstep collective plan for SPEC(s) "
             "and exit (runs nothing)",
    )
    ap.add_argument(
        "--quick", action="store_true",
        help="trim the grid to one delta/k per root kind",
    )
    ap.add_argument(
        "--json", metavar="PATH", default="ANALYZE_report_torch.json",
        help="where to write the report (default %(default)s; "
             "'-' to skip)",
    )
    ap.add_argument(
        "--baseline", metavar="PATH", default="analyze_baseline_torch.json",
        help="accepted-findings baseline (default %(default)s; "
             "missing file = empty baseline)",
    )
    ap.add_argument(
        "--write-baseline", action="store_true",
        help="rewrite --baseline to accept the current findings",
    )
    ap.add_argument(
        "--ranks", type=int, default=None, metavar="N",
        help="stacked ranks of the engine lint (default 1; the "
             "collective plan is checked at N > 1; --explain's shape "
             "default 4)",
    )
    ap.add_argument(
        "--device", default=None,
        help="device of the engine lint (default: the card; 'cpu' runs "
             "it on the CPU)",
    )
    ap.add_argument(
        "--min-points", type=int, default=0, metavar="N",
        help="fail unless the grid covered at least N spec points",
    )
    args = ap.parse_args(argv)
    if args.ranks is not None and args.ranks < 1:
        ap.error(f"--ranks must be >= 1, got {args.ranks}")

    from repro_torch.analyze.findings import Finding, baseline_records
    from repro_torch.analyze.report import render_report, run_report
    from repro_torch.analyze.spec_check import explain_config

    if args.explain:
        shape = dict(n_local=64, rows=80, width=8, n_parts=args.ranks or 4)
        for i, spec in enumerate(args.explain):
            if i:
                print()
            print(explain_config(spec, shape=shape))
        return

    report = run_report(
        baseline_path=args.baseline,
        quick=args.quick,
        n_parts=args.ranks or 1,
        device=args.device,
    )
    if args.json and args.json != "-":
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
        print(f"[analyze] report -> {args.json}")
    print(render_report(report))

    if args.write_baseline:
        gating = [
            Finding(**{k: v for k, v in f.items() if k != "fp"})
            for f in report["findings"] + report["baselined"]
        ]
        records = baseline_records(gating)
        with open(args.baseline, "w") as f:
            json.dump(records, f, indent=1)
        print(f"[analyze] baseline rewritten -> {args.baseline} "
              f"({len(records)} entries)")
        return

    if args.min_points and report["points"] < args.min_points:
        sys.exit(
            f"coverage floor: linted {report['points']} spec points "
            f"< required {args.min_points}"
        )
    if not report["ok"]:
        sys.exit("analyze gate FAILED: unbaselined findings above")


if __name__ == "__main__":
    main()
