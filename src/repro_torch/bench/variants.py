"""Paper Figures 5-7 on the port: Δ-stepping / KLA / Chaotic AGMs ×
EAGM variants (buffer, threadq, nodeq, numaq) × candidate exchange
(dense a2a, frontier-sparse, auto) on RMAT1 and RMAT2, plus composed
multi-level hierarchies (grammar v2), and the partition dimension.

Each point reports the work and synchronization terms its wall time
decomposes into (relaxations, commits, supersteps, exchanged bytes),
the cost model's time (``model_ms``, 256 cards, as the JAX package's
``benchmarks/bench_variants.py`` counts them) and the wall of one warm
solve (``bench.timed_solve``), on 8 ranks stacked on one device over
the ``(pod, data, model)`` mesh of (2, 2, 2), so that pod-, rank- and
chunk-scoped orderings are distinct.  ``ok`` means the state equals
Dijkstra's.

    python -m repro_torch.bench.variants --quick --scale 20 --source hub
    python -m repro_torch.bench.variants --quick --scale 8 --device cpu --json

``--quick``: rmat1 only, 4 roots × 2 variants + the hierarchy = 27
points.  ``--source`` takes a vertex or ``hub`` (the vertex of most
out-edges); the default, 0, is the JAX package's source, which has no
out-edge in rmat1 seed 7 at scale 20.  Rows carry the source.
``--json`` writes the rows to ``experiments/bench_torch/variants.json``;
``--json-partition`` also runs the partition cell (relabeling
partitioners on one skewed RMAT at W 8) into ``partition.json``.  The
JAX package's ``--adaptive`` and ``--roofline`` cells are not ported
(``ROADMAP.md``).
"""

from __future__ import annotations

import argparse
import functools
import warnings

import numpy as np

from repro_torch.api import Problem, SingleSource, Solver, SolverConfig
from repro_torch.bench import MESH8, OUT_DIR, same_state, timed_solve, write_json
from repro_torch.core.metrics import model_time_s
from repro_torch.graph import partition_graph, rmat1, rmat2
from repro_torch.launch.sssp import oracle

EXCHANGES = ["a2a", "sparse", "auto"]

#: beyond-paper multi-level hierarchy family points (grammar v2)
HIERARCHY_SPECS = [
    "delta:5 > pod:dijkstra > chunk:delta:1",
]

#: the partition dimension: relabeling partitioners on one skewed RMAT
PARTITIONS = ["block", "shuffle:7", "ebal", "degree"]

SEED = 7


def pick_source(g, source) -> int:
    """``source``: a vertex id, or ``"hub"``, the vertex of most out-edges.
    The JAX package solves from vertex 0, which the generator's vertex
    permutation can leave without an out-edge (rmat1 seed 7 at scales
    14, 18 and 20: every point is then one superstep)."""
    if source == "hub":
        return int(np.bincount(g.src, minlength=g.n).argmax())
    return int(source)


def grid(quick: bool):
    """(graphs, points): the generators and the (root, variant) points,
    hierarchy specs last with variant 'hierarchy'."""
    graphs = [("rmat1", rmat1)] if quick else [("rmat1", rmat1), ("rmat2", rmat2)]
    if quick:
        roots = ["delta:5", "kla:2", "dijkstra", "chaotic"]
        variants = ["buffer", "threadq"]
    else:
        roots = ["delta:3", "delta:5", "delta:7", "kla:1", "kla:2", "kla:3",
                 "chaotic", "dijkstra"]
        variants = ["buffer", "threadq", "nodeq", "numaq"]
    points = [(root, variant) for root in roots for variant in variants]
    points += [(spec, "hierarchy") for spec in HIERARCHY_SPECS]
    return graphs, points


#: the capacity warning a point with a small frontier cap raises by
#: design (its dense fallbacks are counted in the rows)
CAP_WARNING = "sparse exchange capacity overflowed"


def quiet_caps(fn):
    """``fn`` with :data:`CAP_WARNING` silenced."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", CAP_WARNING, RuntimeWarning)
            return fn(*args, **kwargs)
    return wrapped


@quiet_caps
def run(scale: int = 10, quick: bool = False, exchanges=None,
        frontier_cap: "int | None" = 4, device=None, cost=None,
        source=0) -> list:
    graphs, points = grid(quick)
    rows = []
    for gname, gen in graphs:
        g = gen(scale, seed=SEED)
        src = pick_source(g, source)
        truth = oracle(g, src)
        # every point partitions alike (block, default width): once a graph
        pg = partition_graph(g, MESH8.size)
        problem = Problem(pg, SingleSource(src))
        Solver(n_parts=MESH8.size, device=device, mesh=MESH8).solve(problem)
        for root, variant in points:
            for exchange in exchanges or EXCHANGES:
                if variant == "hierarchy":
                    cfg = SolverConfig.from_spec(
                        root, exchange=exchange, chunk_size=256,
                        frontier_cap=frontier_cap)
                else:
                    cfg = SolverConfig(root=root, variant=variant,
                                       exchange=exchange, chunk_size=256,
                                       frontier_cap=frontier_cap)
                solver = Solver(cfg, n_parts=MESH8.size, device=device,
                                mesh=MESH8)
                sol, wall_s = timed_solve(solver, problem)
                m = sol.metrics
                rows.append(dict(
                    graph=gname, scale=scale, source=src, root=root,
                    variant=variant, exchange=exchange,
                    ok=same_state(truth, sol.state),
                    wall_s=wall_s,
                    model_ms=model_time_s(m, 256, cost) * 1e3,
                    bytes_per_superstep=m.exchange_bytes / max(1, m.supersteps),
                    **m.as_dict()))
    return rows


@quiet_caps
def run_partition(scale: int = 10, partitions=None, exchanges=None,
                  frontier_cap: "int | None" = 16, device=None,
                  source=0) -> list:
    """One skewed RMAT at W 8, one ordering, every relabeling
    partitioner × {a2a, sparse}."""
    g = rmat1(scale, seed=SEED)
    src = pick_source(g, source)
    truth = oracle(g, src)
    rows = []
    for part in partitions or PARTITIONS:
        pg = partition_graph(g, MESH8.size, width=8, partitioner=part)
        st = pg.load_stats()
        for i, exchange in enumerate(exchanges or ["a2a", "sparse"]):
            cfg = SolverConfig.from_spec(
                "delta:5+threadq", exchange=exchange, chunk_size=256,
                partition=part, frontier_cap=frontier_cap)
            solver = Solver(cfg, n_parts=MESH8.size, device=device, mesh=MESH8)
            problem = Problem(pg, SingleSource(src))
            if i == 0:  # the partition's first solve, untimed
                solver.solve(problem)
            sol, wall_s = timed_solve(solver, problem)
            rows.append(dict(
                graph="rmat1", scale=scale, source=src, partition=part,
                exchange=exchange,
                ok=same_state(truth, sol.state), wall_s=wall_s,
                max_rows=st["max_rows"], n_local=pg.n_local,
                straggler_rows=st["straggler_rows"],
                ell_occupancy=st["ell_occupancy"], **sol.metrics.as_dict()))
    return rows


def lines(rows) -> list[str]:
    """``name,us_per_call,derived`` lines, as the JAX package prints."""
    out = []
    for r in rows:
        if r["variant"] == "hierarchy":
            point = r["root"].replace(" ", "")  # grammar-v2 spec
            name = f"family/{r['graph']}_s{r['scale']}/{point}/{r['exchange']}"
        else:
            name = (f"fig5-7/{r['graph']}_s{r['scale']}/"
                    f"{r['root']}+{r['variant']}/{r['exchange']}")
        derived = (
            f"relax={r['relaxations']};steps={r['supersteps']};"
            f"commits={r['commits']};xbytes={r['exchange_bytes']};"
            f"bps={r['bytes_per_superstep']:.0f};"
            f"fallbacks={r['sparse_fallbacks']};ok={int(r['ok'])}"
        )
        out.append(f"{name},{r['wall_s'] * 1e6:.1f},{derived}")
    return out


def partition_lines(rows) -> list[str]:
    out = []
    for r in rows:
        name = (f"partition/{r['graph']}_s{r['scale']}/"
                f"{r['partition']}/{r['exchange']}")
        derived = (
            f"R={r['max_rows']};straggler={r['straggler_rows']:.3f};"
            f"steps={r['supersteps']};xbytes={r['exchange_bytes']};"
            f"relax={r['relaxations']};ok={int(r['ok'])}"
        )
        out.append(f"{name},{r['wall_s'] * 1e6:.1f},{derived}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--quick", action="store_true",
                    help="rmat1, 4 roots x 2 variants + the hierarchy")
    ap.add_argument("--scale", type=int, default=None,
                    help="graph scale (default 9 with --quick, else 10)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--source", default="0",
                    help="source vertex, or 'hub' (most out-edges); "
                         "default 0, the JAX package's")
    ap.add_argument("--json", action="store_true",
                    help="write the rows to <out>/variants.json")
    ap.add_argument("--json-partition", action="store_true",
                    help="also run the partition cell into <out>/partition.json")
    ap.add_argument("--out", default=OUT_DIR)
    a = ap.parse_args(argv)
    scale = a.scale if a.scale is not None else (9 if a.quick else 10)
    source = a.source if a.source == "hub" else int(a.source)
    rows = run(scale, quick=a.quick, device=a.device, source=source)
    for line in lines(rows):
        print(line, flush=True)
    if a.json:
        write_json(rows, "variants.json", a.out)
    bad = [r for r in rows if not r["ok"]]
    if a.json_partition:
        prows = run_partition(scale, device=a.device, source=source)
        for line in partition_lines(prows):
            print(line, flush=True)
        write_json(prows, "partition.json", a.out)
        bad += [r for r in prows if not r["ok"]]
    if bad:
        print(f"{len(bad)} point(s) differ from Dijkstra", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
