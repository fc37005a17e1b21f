"""Paper Table I on the port: real-world graphs × (Δ-stepping, KLA,
Chaotic) × (buffer, threadq, nodeq, numaq), with the JAX package's
stand-ins (``benchmarks/bench_table1.py``): social graphs as a
small-world graph and R-MATs (low diameter, skewed degrees),
roadNet-CA as a 2D grid (high diameter), and the paper's per-graph
parameters (Δ = 1200 and KLA K = 10 on the road network).  8 ranks
stacked on one device over the (2, 2, 2) ``(pod, data, model)`` mesh,
the a2a exchange; ``model_ms`` over 64 cards, as the JAX package
counts them; ``ok`` means the state equals Dijkstra's.

    python -m repro_torch.bench.table1 [--device cpu] [--json]
"""

from __future__ import annotations

import argparse

from repro_torch.api import Problem, SingleSource, Solver, SolverConfig
from repro_torch.bench import MESH8, OUT_DIR, same_state, write_json
from repro_torch.core.metrics import model_time_s
from repro_torch.graph import grid_road_graph, rmat1, small_world_graph
from repro_torch.launch.sssp import oracle

VARIANTS = ["buffer", "threadq", "nodeq", "numaq"]


def graphs() -> list:
    """(table-I stand-in, graph, AGM roots)."""
    return [
        ("soc-live-proxy", small_world_graph(1 << 12, k=16, p=0.05, seed=1),
         ["delta:3", "kla:1", "chaotic"]),
        ("wiki-talk-proxy", rmat1(11, seed=3), ["delta:3", "kla:1", "chaotic"]),
        ("roadnet-proxy", grid_road_graph(64, seed=2),
         ["delta:1200", "kla:10", "chaotic"]),
        ("orkut-proxy", rmat1(11, seed=9, edge_factor=32),
         ["delta:10", "kla:5", "chaotic"]),
    ]


def run(device=None, cost=None) -> list:
    rows = []
    for gname, g, roots in graphs():
        truth = oracle(g, 0)
        for root in roots:
            for variant in VARIANTS:
                solver = Solver(
                    SolverConfig(root=root, variant=variant, exchange="a2a",
                                 chunk_size=256),
                    n_parts=MESH8.size, device=device, mesh=MESH8)
                sol = solver.solve(Problem(g, SingleSource(0)))
                m = sol.metrics
                rows.append(dict(graph=gname, n=g.n, m=g.m, root=root,
                                 variant=variant,
                                 ok=same_state(truth, sol.state),
                                 model_ms=model_time_s(m, 64, cost) * 1e3,
                                 **m.as_dict()))
    return rows


def lines(rows) -> list[str]:
    out = []
    for r in rows:
        name = f"table1/{r['graph']}/{r['root']}+{r['variant']}"
        derived = (
            f"relax={r['relaxations']};steps={r['supersteps']};"
            f"commits={r['commits']};"
            f"waste={r['relaxations'] / max(1, r['commits']):.1f};ok={int(r['ok'])}"
        )
        out.append(f"{name},{r['model_ms'] * 1e3:.1f},{derived}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--json", action="store_true",
                    help="write the rows to <out>/table1.json")
    ap.add_argument("--out", default=OUT_DIR)
    a = ap.parse_args(argv)
    rows = run(device=a.device)
    for line in lines(rows):
        print(line, flush=True)
    if a.json:
        write_json(rows, "table1.json", a.out)
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    raise SystemExit(main())
