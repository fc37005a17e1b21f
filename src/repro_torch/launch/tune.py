"""Auto-tuner CLI of the port: search the spec grammar per graph,
persist the tuned-spec cache, inspect and export it.  Pilot solves run
on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.tune --search --graph rmat1 \
        --scale 10 --objective wall --cache TUNE_cache.json
    PYTHONPATH=src python -m repro_torch.launch.tune --search --quick \
        --devices 4 --scale 9 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.tune --inspect
    PYTHONPATH=src python -m repro_torch.launch.tune --export tuned.json

``--search`` runs :class:`repro_torch.tune.AutoTuner` coordinate
descent (ordering x exchange x partitioner, scored by pilot solves) on
the chosen graph and merges the winner into ``--cache``; ``--inspect``
prints every cached record with its scored leaderboard; ``--export``
copies the cache JSON to a deployment path (``repro_torch.serve.Router``
takes it as ``tuned=TunedSpecCache.load(path)``; the JAX package loads
the same file).  Actions compose: ``--search --inspect --export
out.json`` does all three.  ``--devices N`` solves the pilots on N
ranks stacked on the one device.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from repro_torch.launch.sssp import build_graph
from repro_torch.tune import OBJECTIVES, AutoTuner, TunedSpecCache


def _print_record(rec, *, top: int = 6) -> None:
    print(f"[tune] fingerprint {rec.fingerprint}: spec {rec.spec!r} "
          f"(objective {rec.objective}, score {rec.score:.3e})")
    for row in rec.leaderboard[:top]:
        mark = "*" if row["spec"] == rec.spec else " "
        print(f"   {mark} {row['spec']:32s} score={row['score']:.3e} "
              f"supersteps={row['supersteps']} "
              f"bytes/superstep={row['bytes_per_superstep']} "
              f"converged={row['converged']}")
    extra = len(rec.leaderboard) - top
    if extra > 0:
        print(f"     ... {extra} more candidates")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="offline spec auto-tuner (search/inspect/export)"
    )
    ap.add_argument("--search", action="store_true",
                    help="run the coordinate-descent search on --graph "
                         "and merge the winner into --cache (default "
                         "action when none is given)")
    ap.add_argument("--inspect", action="store_true",
                    help="print every cached record + leaderboard")
    ap.add_argument("--export", metavar="PATH",
                    help="write the cache JSON to PATH")
    ap.add_argument("--graph", default="rmat1",
                    choices=["rmat1", "rmat2", "road", "smallworld"])
    ap.add_argument("--scale", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--objective", default="model", choices=list(OBJECTIVES))
    ap.add_argument("--cache", default="TUNE_cache.json",
                    help="tuned-spec cache file (default %(default)s; "
                         "loaded if it exists, rewritten after --search)")
    ap.add_argument("--quick", action="store_true",
                    help="trim the search grid (2 orderings, block "
                         "partition only)")
    ap.add_argument("--pilot-iters", type=int, default=2000,
                    help="superstep cap per pilot solve")
    ap.add_argument("--devices", type=int, default=1, metavar="N",
                    help="ranks the pilots solve on, stacked on --device")
    ap.add_argument("--device", default=None,
                    help="'cuda' (default) or 'cpu' for the plain torch path")
    args = ap.parse_args(argv)

    if not (args.search or args.inspect or args.export):
        args.search = True

    cache = (TunedSpecCache.load(args.cache)
             if os.path.exists(args.cache) else TunedSpecCache())

    if args.search:
        tuner = AutoTuner(
            n_parts=args.devices,
            device=args.device,  # no CUDA and no --device cpu: raises here
            objective=args.objective,
            cache=cache,
            quick=args.quick,
            pilot_iters=args.pilot_iters,
        )
        g = build_graph(args.graph, args.scale, args.seed)
        print(f"[tune] searching {g.name}: n={g.n} m={g.m} "
              f"objective={args.objective} ranks={args.devices} "
              f"device={tuner.device} "
              f"grid={len(tuner.orderings)}x{len(tuner.exchanges)}"
              f"x{len(tuner.partitions)} (coordinate descent)")
        rec = tuner.search(g)
        _print_record(rec)
        print(f"[tune] {tuner.pilots_run} pilot solves; "
              f"cache -> {args.cache} ({len(cache)} records)")
        cache.save(args.cache)

    if args.inspect:
        if len(cache) == 0:
            print(f"[tune] cache {args.cache}: empty")
        for rec in cache.records():
            _print_record(rec)

    if args.export:
        cache.save(args.export)
        print(f"[tune] exported {len(cache)} records -> {args.export}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
