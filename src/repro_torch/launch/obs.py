"""Observability CLI of the port: record a traced solve, export
flight records, summarize convergence.  Solves run on the card unless
``--device cpu`` is given.

    # record: traced vs untraced solve, bit-identity + overhead gate,
    # Perfetto + JSONL + Prometheus files
    PYTHONPATH=src python -m repro_torch.launch.obs record \
        --graph rmat1 --scale 20 --spec "delta:5/sparse/fused" \
        --trace-json TRACE_solve.json --jsonl FLIGHT_solve.jsonl \
        --metrics OBS_metrics.txt --gate 1.15

    # export: JSONL flight record -> Chrome-trace/Perfetto JSON
    PYTHONPATH=src python -m repro_torch.launch.obs export \
        FLIGHT_solve.jsonl --out TRACE_solve.json

    # summarize: per-superstep convergence table from a flight record
    PYTHONPATH=src python -m repro_torch.launch.obs summarize FLIGHT_solve.jsonl

``record`` solves the same problem twice, once untraced and once with
``/trace``, and checks: final state and ``WorkMetrics`` bit-identical,
per-superstep sums reconciling exactly with the aggregate metrics, and
the traced wall time within ``--gate`` (default 1.15x) of the untraced
one (min over ``--repeats`` warm solves of each; exit 1 past it).  The
files load in Perfetto (https://ui.perfetto.dev) or chrome://tracing.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from repro_torch.api import Problem, SingleSource, Solver
from repro_torch.launch.sssp import build_graph
from repro_torch.obs import (
    MetricsRegistry,
    SolveTrace,
    Tracer,
    use_tracer,
    write_chrome_trace,
    write_flight_jsonl,
)
from repro_torch.obs.trace import Event, Span


def _load_flight(path: str):
    """Rebuild (Tracer, [SolveTrace]) from a JSONL flight record."""
    tracer = Tracer()
    traces: dict[str, SolveTrace] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            kind = rec.pop("kind")
            if kind == "span":
                tracer.spans.append(Span(**rec))
            elif kind == "event":
                tracer.events.append(Event(**rec))
            elif kind == "solve":
                tr = SolveTrace(**rec)
                traces[tr.config_name] = tr
            # superstep rows repeat the solve header (they exist for
            # line-oriented tools); skip them on reload
    return tracer, list(traces.values())


def cmd_record(args) -> int:
    base = Solver(args.spec, n_parts=args.devices, device=args.device)
    if base.config.trace:
        print("error: pass the UNTRACED spec; record adds /trace itself",
              file=sys.stderr)
        return 2
    traced_cfg = dataclasses.replace(
        base.config, trace=True, adapt_window=args.window
    )
    traced = Solver(traced_cfg, n_parts=args.devices, device=base.device)
    g = build_graph(args.graph, args.scale, args.seed)
    pg = base.partition(g)
    prob = Problem(pg, SingleSource(args.source))
    on_card = base.device.type == "cuda"
    where = torch.cuda.get_device_name(base.device) if on_card else "cpu"
    print(f"[obs] {g.name}: n={g.n} m={g.m} spec={base.config.name} "
          f"ranks={base.n_parts} device={where} window={args.window}")

    def timed(solver):
        best, sol = float("inf"), None
        for _ in range(max(1, args.repeats)):
            if on_card:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            sol = solver.solve(prob)  # ends in a copy of the state to the host
            best = min(best, time.perf_counter() - t0)
        return best, sol

    # warm both solvers (ELL copy, kernel build) outside the timed window
    base.solve(prob)
    traced.solve(prob)

    wall_base, sol_base = timed(base)
    registry = MetricsRegistry()
    tracer = Tracer(registry=registry)
    with use_tracer(tracer):
        wall_traced, sol_traced = timed(traced)

    if not np.array_equal(sol_base.state, sol_traced.state):
        print("[obs] FAIL: the traced solve's state differs from the "
              "untraced one", file=sys.stderr)
        return 1
    if sol_base.metrics != sol_traced.metrics:
        print(f"[obs] FAIL: traced metrics differ:\n  untraced "
              f"{sol_base.metrics}\n  traced   {sol_traced.metrics}",
              file=sys.stderr)
        return 1
    tr = sol_traced.trace
    tr.reconcile(sol_traced.metrics)
    print("[obs] bit-identity: state EQUAL, metrics EQUAL, "
          "trace sums reconcile")
    print(f"[obs] untraced {sol_base.metrics}")

    ratio = wall_traced / wall_base if wall_base > 0 else 1.0
    print(f"[obs] wall: untraced {wall_base*1e3:.1f}ms, traced "
          f"{wall_traced*1e3:.1f}ms ({ratio:.2f}x, gate {args.gate}x, "
          f"min of {args.repeats}) on {where}")

    if args.table:
        print(tr.table())
    if args.trace_json:
        write_chrome_trace(args.trace_json, tracer, [tr])
        print(f"[obs] wrote Perfetto trace: {args.trace_json} "
              f"({len(tracer.spans)} spans, {len(tracer.events)} events)")
    if args.jsonl:
        write_flight_jsonl(args.jsonl, tracer, [tr])
        print(f"[obs] wrote flight record: {args.jsonl}")
    if args.metrics:
        with open(args.metrics, "w") as f:
            f.write(registry.expose())
        print(f"[obs] wrote exposition: {args.metrics}")

    if args.gate and ratio > args.gate:
        print(f"[obs] FAIL: traced/untraced {ratio:.2f}x exceeds the "
              f"{args.gate}x overhead gate", file=sys.stderr)
        return 1
    return 0


def cmd_export(args) -> int:
    tracer, traces = _load_flight(args.record)
    write_chrome_trace(args.out, tracer, traces)
    print(f"[obs] {args.record} -> {args.out} ({len(tracer.spans)} "
          f"spans, {len(tracer.events)} events, {len(traces)} solves)")
    return 0


def cmd_summarize(args) -> int:
    _, traces = _load_flight(args.record)
    if not traces:
        print("no solve traces in record", file=sys.stderr)
        return 1
    for tr in traces:
        print(f"[obs] {tr.config_name}: n={tr.n}")
        print(tr.table())
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    rec = sub.add_parser("record", help="traced vs untraced solve with "
                         "bit-identity checks and overhead gate")
    rec.add_argument("--graph", default="rmat1",
                     choices=["rmat1", "rmat2", "road", "smallworld"])
    rec.add_argument("--scale", type=int, default=9)
    rec.add_argument("--spec", default="delta:5/sparse")
    rec.add_argument("--source", type=int, default=0)
    rec.add_argument("--seed", type=int, default=0)
    rec.add_argument("--devices", type=int, default=1, metavar="N",
                     help="ranks, stacked on --device")
    rec.add_argument("--device", default=None,
                     help="'cuda' (default) or 'cpu' for the plain torch path")
    rec.add_argument("--window", type=int, default=8,
                     help="supersteps per recorder segment (larger = "
                          "fewer host reads)")
    rec.add_argument("--repeats", type=int, default=3,
                     help="timing repeats; the gate compares minima")
    rec.add_argument("--gate", type=float, default=1.15,
                     help="max traced/untraced wall ratio (0 disables)")
    rec.add_argument("--trace-json", default=None,
                     help="write Chrome-trace/Perfetto JSON here")
    rec.add_argument("--jsonl", default=None,
                     help="write the JSONL flight record here")
    rec.add_argument("--metrics", default=None,
                     help="write Prometheus text exposition here")
    rec.add_argument("--table", action="store_true",
                     help="print the per-superstep convergence table")
    rec.set_defaults(fn=cmd_record)

    exp = sub.add_parser("export", help="JSONL flight record -> "
                         "Chrome-trace/Perfetto JSON")
    exp.add_argument("record", help="JSONL flight record path")
    exp.add_argument("--out", default="TRACE_solve.json")
    exp.set_defaults(fn=cmd_export)

    summ = sub.add_parser("summarize", help="per-superstep table from "
                          "a JSONL flight record")
    summ.add_argument("record", help="JSONL flight record path")
    summ.set_defaults(fn=cmd_summarize)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
