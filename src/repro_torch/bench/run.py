"""Benchmark entry point of the port: one suite per paper table or
figure, as the JAX package's ``benchmarks/run.py``.

    python -m repro_torch.bench.run [--fast] [--device cpu] [--json]

Prints ``name,us_per_call,derived`` lines (``us_per_call``: the warm
wall for fig5-7/ and family/, the cost model for table1/ and
weakscale/).  The suites:

  fig5-7/, family/  Δ/KLA/Chaotic × EAGM variants × exchange, RMAT1+RMAT2
  table1/           real-world-shaped graphs × variants        (Table I)
  weakscale/        per-rank-constant scaling P = 1..8          (§VI-A)

``--fast`` runs the variants grid at scale 9 and skips Table I and
weak scaling.  The JAX package's ``kernel/`` suite (its XLA reference
timings) is not ported: the card's kernel times come from
``chip_smoke.py`` (``ROADMAP.md``).
"""

from __future__ import annotations

import argparse

from repro_torch.bench import OUT_DIR, scaling, table1, variants, write_json


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--json", action="store_true",
                    help="write each suite's rows under <out>")
    ap.add_argument("--out", default=OUT_DIR)
    a = ap.parse_args(argv)
    suites = [("variants", lambda: variants.run(9 if a.fast else 10, device=a.device),
               variants.lines)]
    if not a.fast:
        suites += [("table1", lambda: table1.run(device=a.device), table1.lines),
                   ("scaling", lambda: scaling.run(device=a.device), scaling.lines)]
    print("name,us_per_call,derived", flush=True)
    bad = 0
    for name, run, fmt in suites:
        rows = run()
        for line in fmt(rows):
            print(line, flush=True)
        if a.json:
            write_json(rows, f"{name}.json", a.out)
        bad += sum(not r["ok"] for r in rows)
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
