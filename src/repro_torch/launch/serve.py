"""Serving driver of the port: the persistent SSSP query service
(Router + SolutionCache + LandmarkIndex + UpdateFeed on one long-lived
Solver) against a Zipf-skewed query mix, then streamed improving edge
updates whose warm-refreshed answers are checked bit for bit against
cold solves.  Runs on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.serve --graph rmat1 \
        --scale 10 --queries 200 --landmarks 8 --updates 4
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --scale 9 \
        --stats-text --tuned-cache TUNE_cache.json

Prints queries/s, p50/p99 latency, and the cache, router and solver
stats.  ``--metrics-port`` serves the Prometheus text exposition (and
a JSON ``/stats``) on 127.0.0.1 while the run lasts, ``--stats-text``
prints it at the end; ``--tuned-cache`` routes flushes through the
spec a ``launch/tune.py`` search cached for the graph.

``--backend gloo`` (or ``nccl``) with ``--ranks P`` (and ``--pods K``)
serves over P rank processes, one rank each, as ``launch/sssp.py``
runs them: rank 0 admits, batches and times the queries and prints;
every other rank replays its commands (``Router.follow``) and runs the
same batched solves on its share of the ELL.  The warm-up, the timed
mix and the updates are three rounds of commands, each ended by
``Router.close``; the freshness check then runs on every rank.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --backend gloo --ranks 2 --scale 9
"""

from __future__ import annotations

import argparse
import contextlib
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.api import Problem, SingleSource, Solver
from repro_torch.device import resolve_device
from repro_torch.graph import graph_fingerprint
from repro_torch.launch.mesh import (
    check_backend,
    init_ranks,
    make_rank_mesh,
    spawn_ranks,
)
from repro_torch.launch.sssp import BACKENDS, RANK_TIMEOUT_S, build_graph
from repro_torch.obs import MetricsRegistry, Tracer, serve_metrics, use_tracer
from repro_torch.serve import (
    EdgeUpdate,
    LandmarkIndex,
    Query,
    Router,
    SolutionCache,
    UpdateFeed,
    serve_latency_stats,
)
from repro_torch.tune import TunedSpecCache

#: refreshed cache entries the freshness check holds against cold solves
FRESHNESS_CHECKS = 3


def zipf_sources(n: int, count: int, a: float, rng) -> np.ndarray:
    """Zipf-skewed vertex ids: rank r drawn with p ∝ r^-a, mapped onto a
    fixed random permutation of the vertex ids so the hot set is not an
    artifact of id order."""
    ranks = rng.zipf(a, size=count)
    ranks = np.minimum(ranks - 1, n - 1)
    perm = np.random.default_rng(0).permutation(n)
    return perm[ranks]


def build_query_mix(g, count: int, zipf_a: float, seed: int) -> list[Query]:
    """70% single-source, 20% point-to-point exact, 10% estimated."""
    rng = np.random.default_rng(seed)
    srcs = zipf_sources(g.n, count, zipf_a, rng)
    tgts = rng.integers(0, g.n, size=count)
    kinds = rng.random(count)
    out = []
    for s, t, k in zip(srcs, tgts, kinds):
        if k < 0.7:
            out.append(Query(int(s)))
        elif k < 0.9:
            out.append(Query(int(s), target=int(t)))
        else:
            out.append(Query(int(s), target=int(t), exact=False))
    return out


def improving_updates(g, count: int, seed: int):
    """``count`` weight drops (x 0.25) on random edges of ``g``, drawn
    from ``seed`` one at a time as the caller applies them (an edge drawn
    twice drops twice), as the JAX package's service CLI draws them."""
    rng = np.random.default_rng(seed)
    for _ in range(count):
        e = int(rng.integers(0, g.m))
        yield EdgeUpdate(int(g.src[e]), int(g.dst[e]),
                         float(g.weight[e]) * 0.25)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--graph", default="rmat1",
                    choices=["rmat1", "rmat2", "road", "smallworld"])
    ap.add_argument("--scale", type=int, default=10)
    ap.add_argument("--spec", default="delta:5/sparse/fused")
    ap.add_argument("--queries", type=int, default=200)
    ap.add_argument("--zipf", type=float, default=1.3,
                    help="Zipf exponent of the source skew")
    ap.add_argument("--landmarks", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-wait-ms", type=float, default=10.0)
    ap.add_argument("--cache-mb", type=int, default=256)
    ap.add_argument("--updates", type=int, default=4,
                    help="streamed improving edge updates to apply after "
                         "the query mix (0 disables)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cuda' (default) or 'cpu' for the plain torch path")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve Prometheus text exposition on "
                         "http://127.0.0.1:PORT/metrics (and a JSON /stats) "
                         "from a daemon thread; 0 picks a free port")
    ap.add_argument("--stats-text", action="store_true",
                    help="print the Prometheus text exposition after the "
                         "run (works without --metrics-port)")
    ap.add_argument("--tuned-cache", metavar="PATH", default=None,
                    help="a tuned-spec cache (launch/tune.py --cache) the "
                         "router consults on every flush")
    ap.add_argument("--ranks", type=int, default=1,
                    help="rank count P the graph is partitioned over")
    ap.add_argument("--pods", type=int, default=1,
                    help="pods the ranks split into (the 'pod' scope)")
    ap.add_argument("--backend", default="stacked", choices=BACKENDS,
                    help="stacked: every rank in this process; gloo or "
                         "nccl: one rank a process, rank 0 serving")
    args = ap.parse_args(argv)
    if args.backend == "stacked":
        solver = Solver(args.spec, n_parts=args.ranks, device=args.device,
                        mesh=make_rank_mesh(args.ranks, args.pods))
        return run(args, solver, show=True)
    # refuse what cannot run before any process group starts
    check_backend(args.backend, args.ranks,
                  torch.device(args.device or "cuda"))
    make_rank_mesh(args.ranks, args.pods)
    args.device = resolve_device(args.device).type
    if args.device == "cuda":
        from repro_torch.kernels import build

        build()  # once, before the rank processes would each compile it
    with tempfile.TemporaryDirectory() as tmp:
        spawn_ranks(rank_main, args.ranks,
                    (args, "file://" + os.path.join(tmp, "store")),
                    timeout=RANK_TIMEOUT_S)
    return 0


def rank_main(rank: int, world: int, args, init_method: str) -> None:
    """One rank process of the service: join the group, serve (rank 0)
    or follow, and exit non-zero on a failed check."""
    if args.device == "cpu":
        device = torch.device("cpu")
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    else:
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    ranks = init_ranks(args.backend, rank, world,
                       make_rank_mesh(world, args.pods), init_method)
    try:
        solver = Solver(args.spec, n_parts=world, device=device, ranks=ranks)
        rc = run(args, solver, show=rank == 0)
    finally:
        torch.distributed.destroy_process_group()
    if rc:
        raise SystemExit(rc)


def run(args, solver, show: bool) -> int:
    """Serve on ``solver``; every rank of a process backend runs it, and
    ``show`` (rank 0) prints and serves the metrics."""
    g = build_graph(args.graph, args.scale, args.seed)
    say = print if show else (lambda *a, **k: None)
    say(f"[serve] {g.name}: n={g.n} m={g.m} spec={solver.config.name} "
        f"device={solver.device} backend={args.backend} ranks={solver.n_parts}")
    tuned = None
    if args.tuned_cache is not None:
        tuned = TunedSpecCache.load(args.tuned_cache)
        rec = tuned.get(graph_fingerprint(g))
        say(f"[serve] tuned cache {args.tuned_cache}: {len(tuned)} records, "
            f"{'spec ' + repr(rec.spec) if rec else 'none'} for this graph")

    # live metrics: the tracer feeds the registry (span histograms and
    # event counters); --metrics-port serves it over HTTP
    registry = tracer = server = None
    if show and (args.metrics_port is not None or args.stats_text):
        registry = MetricsRegistry()
        tracer = Tracer(registry=registry)
        if args.metrics_port is not None:
            server = serve_metrics(registry, args.metrics_port)
            print(f"[serve] metrics: http://{server.server_address[0]}:"
                  f"{server.server_address[1]}/metrics (+ /stats)")
    try:
        with use_tracer(tracer) if tracer is not None else contextlib.nullcontext():
            return _serve(args, solver, g, tuned, registry, say)
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()


def _serve(args, solver, g, tuned, registry, say) -> int:
    cache = SolutionCache(byte_budget=args.cache_mb << 20)
    t0 = time.perf_counter()
    lm = LandmarkIndex(solver, g, k=args.landmarks, symmetric=True)
    say(f"[serve] landmark tier: K={lm.k} built in "
        f"{time.perf_counter() - t0:.2f}s ({lm.nbytes} bytes)")
    router = Router(solver, g, cache=cache, landmarks=lm, tuned=tuned,
                    max_batch=args.max_batch,
                    max_wait_s=args.max_wait_ms / 1e3)
    leader = solver.ranks.rank in (None, 0)

    def round_of(drive):
        """One round of commands: rank 0 drives and closes, the other
        ranks replay it."""
        if leader:
            out = drive()
            router.close()
            return out
        router.follow()
        return None

    if registry is not None:
        # callback gauges: the exposition always reads live state
        registry.gauge("repro_router_queries_total",
                       help="queries admitted", fn=lambda: router.stats.queries)
        registry.gauge("repro_router_batches_total",
                       help="admission flushes", fn=lambda: router.stats.batches)
        registry.gauge("repro_router_tuned_batches_total",
                       help="flushes served by a tuned-spec solver",
                       fn=lambda: router.stats.tuned_batches)
        registry.gauge("repro_router_latency_p99_seconds",
                       help="p99 over the latency ring",
                       fn=lambda: router.latency_stats().p99_s)
        registry.gauge("repro_router_latency_p50_seconds",
                       help="p50 over the latency ring",
                       fn=lambda: router.latency_stats().p50_s)
        registry.gauge("repro_cache_hits_total",
                       help="solution-cache hits", fn=lambda: cache.stats.hits)
        registry.gauge("repro_cache_misses_total",
                       help="solution-cache misses",
                       fn=lambda: cache.stats.misses)

    queries = build_query_mix(g, args.queries, args.zipf, args.seed)
    # warm the kernels and the allocator outside the timed window
    round_of(lambda: router.serve(queries[: args.max_batch]))
    cache.clear()
    cache.stats.hits = cache.stats.misses = 0

    def mix():
        t0 = time.perf_counter()
        tickets = []
        for q in queries:
            tickets.append(router.submit(q))
            router.pump()
        router.flush()
        return time.perf_counter() - t0, [t.result() for t in tickets]

    mixed = round_of(mix)
    if leader:
        wall, answers = mixed
        lat = serve_latency_stats(answers)
        say(f"[serve] {len(answers)} queries in {wall:.2f}s = "
            f"{len(answers) / wall:.1f} q/s")
        say(f"[serve] latency {lat}")
        say(f"[serve] cache {cache.stats}")
        say(f"[serve] router {router.stats.as_dict()}")
        say(f"[serve] solver {solver.stats()}")

    if args.updates:
        feed = UpdateFeed(g, solver, cache=cache, landmarks=lm)
        warm_total = round_of(lambda: sum(
            feed.apply(upd).warm_supersteps
            for upd in improving_updates(g, args.updates, args.seed + 1)))
        say(f"[serve] applied {args.updates} improving updates: "
            f"{feed.stats.as_dict()}")
        # freshness: refreshed entries equal cold solves on the new graph
        # (every rank: the caches are the same and the solves collective)
        checked = 0
        for key, sol in cache.entries_for(graph_fingerprint(g))[:FRESHNESS_CHECKS]:
            cold = solver.solve(Problem(g, SingleSource(key[1])))
            if not np.array_equal(sol.state, cold.state):
                say(f"[serve] FRESHNESS MISMATCH: source {key[1]} differs "
                    f"from a cold solve at "
                    f"{int((sol.state != cold.state).sum())} vertices")
                return 1
            checked += 1
        say(f"[serve] {checked} refreshed entries verified "
            f"bit-identical to cold solves "
            f"(warm supersteps={warm_total})")
    if registry is not None and args.stats_text:
        print("[serve] Prometheus exposition:")
        print(registry.expose())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
