"""A/B of chip_smoke.py phase 12(a)'s gate on the card: the warm walls
of the untraced and the ``/trace`` solve (main and push specs; min of
5, in turns) in each source tree given, each tree in a process of its
own, on rmat1 scale 20 cached in ``build/trace_ab/`` by the first call.

    python3 scripts/trace_ab.py PARENT . . PARENT
"""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "trace_ab"
SPECS = ("delta:5/sparse/fused", "delta:5/sparse")
REPEATS = 5

CHILD = r"""
import json, sys, time
import numpy as np, torch
sys.path.insert(0, sys.argv[1] + "/src")
from repro_torch import kernels as K
from repro_torch.api import Problem, SingleSource, Solver
from repro_torch.graph import Graph, partition_graph
K.build(); K.library()
d, specs, repeats = sys.argv[2], sys.argv[3].split(","), int(sys.argv[4])
g = Graph(int(open(d + "/n").read()),
          *(np.load(f"{d}/{k}.npy") for k in ("src", "dst", "weight")))
pg = partition_graph(g, 1)
pg.to("cuda")
problem = Problem(pg, SingleSource(0))
out = {}
for spec in specs:
    pair = (Solver(spec, device="cuda"), Solver(spec + "/trace", device="cuda"))
    for s in pair:
        s.solve(problem)
    best = [float("inf")] * 2
    for _ in range(repeats):
        for i, s in enumerate(pair):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.solve(problem)
            torch.cuda.synchronize()
            best[i] = min(best[i], time.perf_counter() - t0)
    out[spec] = best
print(json.dumps(out))
"""


def main(trees) -> None:
    if not (CACHE / "n").exists():
        sys.path.insert(0, str(ROOT / "src"))
        import numpy as np

        from repro_torch.graph import rmat1

        CACHE.mkdir(parents=True, exist_ok=True)
        g = rmat1(20, seed=0)
        for k in ("src", "dst", "weight"):
            np.save(CACHE / f"{k}.npy", getattr(g, k))
        (CACHE / "n").write_text(str(g.n))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    for tree in trees:
        r = subprocess.run([sys.executable, "-c", CHILD, tree, str(CACHE),
                            ",".join(SPECS), str(REPEATS)],
                           capture_output=True, text=True)
        if r.returncode:
            print(r.stderr[-3000:])
            raise SystemExit(1)
        for spec, (untraced, traced) in json.loads(r.stdout.splitlines()[-1]).items():
            print(f"{tree}: {spec} untraced {untraced:.4f} s traced {traced:.4f} s "
                  f"ratio {traced / untraced:.3f}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
