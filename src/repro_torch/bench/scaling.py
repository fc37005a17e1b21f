"""Paper §VI-A weak scaling on the port: the same per-rank problem size
(rmat2, seed 11, scale 8 a rank) at P = 1, 2, 4, 8 ranks, stacked on
one device over the JAX package's meshes (``benchmarks/
bench_scaling.py``): how supersteps and exchanged bytes grow with P per
EAGM variant, the quantities whose balance makes the paper's
weak-scaling curves.  ``model_ms`` over P cards; ``ok`` (which the JAX
package's rows lack) means the state equals Dijkstra's.  Ranks stacked
on one device give the counts, not a scaling of wall time.

    python -m repro_torch.bench.scaling [--device cpu] [--json]
"""

from __future__ import annotations

import argparse

from repro_torch.api import Problem, SingleSource, Solver, SolverConfig
from repro_torch.bench import OUT_DIR, same_state, write_json
from repro_torch.core.metrics import model_time_s
from repro_torch.graph import rmat2
from repro_torch.launch.mesh import RankMesh
from repro_torch.launch.sssp import oracle

#: (P, scale, mesh): scale 8 a rank
MESHES = [
    (1, 8, RankMesh((1,), ("data",))),
    (2, 9, RankMesh((2,), ("data",))),
    (4, 10, RankMesh((2, 2), ("data", "model"))),
    (8, 11, RankMesh((2, 2, 2), ("pod", "data", "model"))),
]

SPECS = [("delta:5", "buffer"), ("delta:5", "threadq"), ("chaotic", "threadq"),
         ("kla:1", "nodeq")]


def run(device=None, cost=None) -> list:
    rows = []
    for P, scale, mesh in MESHES:
        g = rmat2(scale, seed=11)
        truth = oracle(g, 0)
        for root, variant in SPECS:
            solver = Solver(
                SolverConfig(root=root, variant=variant, exchange="a2a",
                             chunk_size=256),
                n_parts=P, device=device, mesh=mesh)
            sol = solver.solve(Problem(g, SingleSource(0)))
            rows.append(dict(P=P, scale=scale, root=root, variant=variant,
                             ok=same_state(truth, sol.state),
                             model_ms=model_time_s(sol.metrics, P, cost) * 1e3,
                             **sol.metrics.as_dict()))
    return rows


def lines(rows) -> list[str]:
    out = []
    for r in rows:
        name = f"weakscale/P{r['P']}_s{r['scale']}/{r['root']}+{r['variant']}"
        derived = (f"relax={r['relaxations']};steps={r['supersteps']};"
                   f"xbytes={r['exchange_bytes']};ok={int(r['ok'])}")
        out.append(f"{name},{r['model_ms'] * 1e3:.1f},{derived}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--json", action="store_true",
                    help="write the rows to <out>/scaling.json")
    ap.add_argument("--out", default=OUT_DIR)
    a = ap.parse_args(argv)
    rows = run(device=a.device)
    for line in lines(rows):
        print(line, flush=True)
    if a.json:
        write_json(rows, "scaling.json", a.out)
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    raise SystemExit(main())
