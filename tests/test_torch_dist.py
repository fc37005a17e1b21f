"""The process backend: one rank a process of a gloo group
(``core/ranks.py::ProcessRanks``) against the stacked engine
(``StackedRanks``) at the same rank count, on the CPU.

One process group a rank count runs every solve of this module (a
module fixture spawns it once; the stacked solves run in this process
meanwhile).  The grid is ``paper_variant_specs()`` × {a2a, pmin, sparse
with the ref, push and fused relax, auto}, each spec on one of the
``tiny_graphs`` in turn; beside it ``solve_batch`` of 3 lanes,
``/adapt:rho``, ``/trace``, ``/q:bf16`` and ``/q:u16``; ``resolve``
after an improving weight drop and after a source addition on a few
specs; and the query service (``Router``, ``SolutionCache``,
``LandmarkIndex``, ``UpdateFeed``) on a seeded query mix with one
improving update, rank 0 serving and the others following.  State,
``padded``, ``metrics.as_dict()``, the flight record and every answer
must be bit-identical, and every process must return the same solution.
P = 4 runs on a two-pod mesh, so the ``pod`` level goes through a
subgroup.

This module imports no JAX: the rank processes import it to find their
entry point.  The graphs are the port's generators, which equal the
JAX package's ``tiny_graphs`` (checked here against the fixture).
"""

import os
import pickle
import subprocess
import sys
import threading
import time
import warnings

import pytest
import torch

import repro_torch.graph as tg
from repro_torch.api import Problem, SingleSource, Solver, SolverConfig
from repro_torch.graph import graph_fingerprint
from repro_torch.core import paper_variant_specs
from repro_torch.launch.mesh import (
    RankMesh,
    check_backend,
    init_ranks,
    make_rank_mesh,
    spawn_ranks,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GRAPHS = [
    ("rmat1", dict(scale=8, seed=3)),
    ("rmat2", dict(scale=8, seed=5)),
    ("grid_road_graph", dict(side=12, seed=1)),
    ("small_world_graph", dict(n=300, seed=2)),
]
EXCHANGES = [("a2a", "ref"), ("pmin", "ref"), ("sparse", "ref"),
             ("sparse", "push"), ("sparse", "fused"), ("auto", "ref")]
SPECS = paper_variant_specs()
BATCH_SOURCES = (0, 5, 40)
# (name, graph, spec, relax_impl, batch)
EXTRAS = [
    ("batch-sparse-fused", 0, "delta:5+threadq/sparse", "fused", True),
    ("batch-a2a", 1, "kla:2+nodeq/a2a", "ref", True),
    ("adapt-rho", 2, "delta:5/sparse/adapt:rho", "ref", False),
    ("trace", 3, "delta:3+nodeq/auto/trace", "ref", False),
    ("q-bf16", 0, "delta:5/sparse/q:bf16", "ref", False),
    ("q-u16", 1, "delta:5/sparse/q:u16", "fused", False),
]
MESHES = {2: make_rank_mesh(2), 4: make_rank_mesh(4, pods=2)}
# resolve: (name, graph, spec, relax_impl), each after a weight drop
# and after a source addition
RESOLVE_SPECS = [
    ("sparse-fused", 0, "delta:5/sparse", "fused"),
    ("threadq-a2a", 1, "delta:5+threadq/a2a", "ref"),
    ("nodeq-pmin", 2, "kla:2+nodeq/pmin", "ref"),
    ("auto-trace", 3, "delta:3/auto/trace", "ref"),
    ("q-bf16", 0, "delta:5/sparse/q:bf16", "push"),
]
RESOLVE_KINDS = ("drop", "source")
ADDED_SOURCE = 77
# the query service: specs, the graph and the seeded mix
SERVICE_SPECS = [("delta:5/sparse", "fused"), ("delta:5+threadq/a2a", "ref")]
SERVICE_QUERIES = 40


def grid_jobs():
    jobs = []
    for i, spec in enumerate(SPECS):
        for j, (ex, impl) in enumerate(EXCHANGES):
            jobs.append((f"{spec}/{ex}/{impl}", (i + j) % len(GRAPHS),
                         f"{spec}/{ex}", impl, False))
    return jobs + EXTRAS


def build_graphs():
    return [getattr(tg, kind)(**kw) for kind, kw in GRAPHS]


def solve_job(solver_of, graphs, job):
    """(state, padded, metrics, trace lists) of each solution of a job."""
    _, gi, spec, impl, batch = job
    g = graphs[gi]
    solver = solver_of(SolverConfig.from_spec(spec, relax_impl=impl))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        if batch:
            sols = solver.solve_batch(
                [Problem(g, SingleSource(v)) for v in BATCH_SOURCES])
        else:
            sols = [solver.solve(Problem(g, SingleSource(0)))]
    out = []
    for s in sols:
        tr = s.trace
        trace = None if tr is None else (tr.pending, tr.eligible, tr.rows,
                                         tr.sparse_used, tr.bytes_moved)
        out.append((s.state, s.padded, s.metrics.as_dict(), trace))
    return out


def dropped(g, every=7):
    """A copy of ``g`` with every ``every``-th weight divided by 4: an
    improving perturbation with the same edges (and so the same block
    layout)."""
    w = g.weight.copy()
    w[::every] *= 0.25
    return tg.Graph(g.n, g.src.copy(), g.dst.copy(), w, name=g.name)


def resolve_results(solver_of, graphs):
    """{(name, kind): (warm solution, cold solution)} of each RESOLVE_SPECS
    entry after a weight drop and after a source addition."""
    from repro_torch.api import MultiSource

    out = {}
    for name, gi, spec, impl in RESOLVE_SPECS:
        solver = solver_of(SolverConfig.from_spec(spec, relax_impl=impl))
        g = graphs[gi]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            prev = solver.solve(Problem(g, SingleSource(0)))
            g2 = dropped(g)
            cases = {
                "drop": (lambda: solver.resolve(prev, graph=g2),
                         lambda: solver.solve(Problem(g2, SingleSource(0)))),
                "source": (lambda: solver.resolve(prev, [ADDED_SOURCE]),
                           lambda: solver.solve(
                               Problem(g, MultiSource((0, ADDED_SOURCE))))),
            }
            for kind, (warm, cold) in cases.items():
                out[name, kind] = [packed(warm()), packed(cold())]
    return out


def packed(s):
    tr = s.trace
    trace = None if tr is None else (tr.pending, tr.eligible, tr.rows,
                                     tr.sparse_used, tr.bytes_moved)
    return (s.state, s.padded, s.metrics.as_dict(), trace)


class Clock:
    """A clock that moves only when told: the timeout trigger then fires
    at the same queries on every run."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def tick(self):
        self.t += 0.004


def answer_key(a):
    """An answer as comparable values (its latency kept apart)."""
    sol = a.solution
    return ((a.query.source, a.query.target, a.query.exact), a.served_by,
            a.distance, a.lower, a.upper,
            None if sol is None else (sol.state.tobytes(), sol.padded.tobytes(),
                                      sol.metrics.as_dict()))


def service_results(solver_of, ranks=None):
    """The query service on a seeded mix over a private copy of the first
    graph, one improving update, then a third of the mix again: rank 0
    (or the stacked run) drives, the other ranks follow.  Returns each
    spec's answers, latencies, statistics, landmark matrix and cache
    keys, and the broadcasts of the command stream."""
    from repro_torch.launch.serve import build_query_mix, improving_updates
    from repro_torch.serve import LandmarkIndex, Router, SolutionCache, UpdateFeed
    from repro_torch.serve.stream import stream_for

    leader = ranks is None or ranks.rank == 0
    out = {}
    for spec, impl in SERVICE_SPECS:
        g = build_graphs()[0]
        solver = solver_of(SolverConfig.from_spec(spec, relax_impl=impl))
        clock = Clock()
        sent = stream_for(solver).broadcasts  # the stream outlives a spec
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            cache = SolutionCache(byte_budget=1 << 20)
            lm = LandmarkIndex(solver, g, k=4, symmetric=True)
            router = Router(solver, g, cache=cache, landmarks=lm, max_batch=4,
                            max_wait_s=0.01, clock=clock)
            feed = UpdateFeed(g, solver, cache=cache, landmarks=lm)
            queries = build_query_mix(g, SERVICE_QUERIES, 1.3, seed=4)
            results = []
            if leader:
                tickets = []
                for q in queries:
                    tickets.append(router.submit(q))
                    clock.tick()
                    router.pump()
                router.flush()
                for upd in improving_updates(g, 1, seed=5):
                    results.append(feed.apply(upd))
                tickets += [router.submit(q) for q in queries[::3]]
                router.flush()
                router.close()
            else:
                tickets = router.follow()
        out[spec] = dict(
            answers=[answer_key(t.answer) for t in tickets],
            latencies=[t.answer.latency_s for t in tickets],
            cache=cache.stats.as_dict(), keys=list(cache.keys()),
            router=router.stats.as_dict(), feed=feed.stats.as_dict(),
            results=[(r.improving, r.warm_refreshes, r.fingerprint) for r in results],
            landmarks=lm.dist.tobytes(), fingerprint=graph_fingerprint(g),
            broadcasts=stream_for(solver).broadcasts - sent,
            flushes=router.stats.batches)
    return out


def rank_jobs(rank, world, url, mesh, jobs, out_dir, serve=False):
    """One rank process: join the group, run every job (with ``serve``
    also the resolve and service runs), and write what each returned to
    ``out_dir/rank{rank}.pkl``."""
    torch.set_num_threads(1)
    ranks = init_ranks("gloo", rank, world, mesh, url)
    graphs = build_graphs()

    def solver_of(cfg):
        return Solver(cfg, n_parts=world, device="cpu", ranks=ranks)

    results = {job[0]: solve_job(solver_of, graphs, job) for job in jobs}
    if serve:
        results["resolve"] = resolve_results(solver_of, graphs)
        results["service"] = service_results(solver_of, ranks)
    results["counts"] = dict(ranks.counts)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    torch.distributed.destroy_process_group()


def run_processes(world, mesh, jobs, out_dir, serve=False):
    """Spawn ``world`` gloo rank processes over ``mesh`` running
    ``jobs`` (and with ``serve`` the resolve and service runs); returns
    each rank's results."""
    os.makedirs(out_dir, exist_ok=True)
    url = "file://" + os.path.join(out_dir, "store")
    spawn_ranks(rank_jobs, world, (url, mesh, jobs, out_dir, serve), timeout=600)
    out = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def stacked_results(world, mesh, jobs):
    graphs = build_graphs()

    def solver_of(cfg):
        return Solver(cfg, n_parts=world, device="cpu", mesh=mesh)

    out = {job[0]: solve_job(solver_of, graphs, job) for job in jobs}
    out["resolve"] = resolve_results(solver_of, graphs)
    out["service"] = service_results(solver_of)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{P: (process results of every rank, stacked results)}; the
    process groups run in threads while this process solves stacked."""
    jobs = grid_jobs()
    procs, errors = {}, []
    # made here: tmp_path_factory is not safe to call from two threads
    dirs = {w: str(tmp_path_factory.mktemp(f"gloo{w}")) for w in MESHES}

    def spawn(world):
        try:
            procs[world] = run_processes(world, MESHES[world], jobs, dirs[world],
                                         serve=True)
        except BaseException as e:  # re-raised below, in the test
            errors.append(e)

    threads = [threading.Thread(target=spawn, args=(w,)) for w in MESHES]
    for t in threads:
        t.start()
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)  # leave the cores to the rank processes
    try:
        stacked = {w: stacked_results(w, MESHES[w], jobs) for w in MESHES}
    finally:
        torch.set_num_threads(n_threads)
    for t in threads:
        t.join(700)
        assert not t.is_alive(), "a process group did not finish"
    if errors:
        raise errors[0]
    return {w: (procs[w], stacked[w]) for w in MESHES}


def assert_same(got, want):
    assert len(got) == len(want)
    for (s1, p1, m1, t1), (s2, p2, m2, t2) in zip(got, want):
        assert s1.tobytes() == s2.tobytes()
        assert p1.shape == p2.shape and p1.tobytes() == p2.tobytes()
        assert m1 == m2
        assert t1 == t2


def test_port_graphs_are_the_tiny_graphs(tiny_graphs):
    for ref, port in zip(tiny_graphs, build_graphs()):
        assert ref.n == port.n and ref.name == port.name
        for a in ("src", "dst", "weight"):
            assert getattr(ref, a).tobytes() == getattr(port, a).tobytes()


@pytest.mark.parametrize("ex", EXCHANGES, ids=lambda e: "-".join(e))
@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("world", [2, 4])
def test_process_grid_matches_stacked(runs, world, spec, ex):
    procs, stacked = runs[world]
    key = f"{spec}/{ex[0]}/{ex[1]}"
    assert_same(procs[0][key], stacked[key])


@pytest.mark.parametrize("name", [e[0] for e in EXTRAS])
@pytest.mark.parametrize("world", [2, 4])
def test_process_extras_match_stacked(runs, world, name):
    procs, stacked = runs[world]
    assert_same(procs[0][name], stacked[name])
    sols = procs[0][name]
    if name.startswith("batch"):
        assert len(sols) == len(BATCH_SOURCES)
    if name == "trace":
        assert sols[0][3] is not None and sum(sols[0][3][1]) == sols[0][2]["commits"]
    if name.startswith("q-"):
        assert sols[0][2]["converged"]


@pytest.mark.parametrize("world", [2, 4])
def test_every_process_returns_the_same_solution(runs, world):
    procs, _ = runs[world]
    for r in range(1, world):
        for key, sols in procs[0].items():
            if key == "resolve":
                for case, pair in sols.items():
                    assert_same(procs[r][key][case], pair)
            elif key not in ("counts", "service"):
                assert_same(procs[r][key], sols)
    # the collectives ran, and every rank ran as many of each
    counts = procs[0]["counts"]
    assert counts["all_reduce"] > 0 and counts["all_to_all"] > 0
    for r in range(1, world):
        assert {k: v for k, v in procs[r]["counts"].items() if k != "bytes"} == \
            {k: v for k, v in counts.items() if k != "bytes"}


@pytest.mark.parametrize("kind", RESOLVE_KINDS)
@pytest.mark.parametrize("name", [r[0] for r in RESOLVE_SPECS])
@pytest.mark.parametrize("world", [2, 4])
def test_process_resolve_matches_stacked(runs, world, name, kind):
    """``resolve`` over the process backend after a weight drop or a
    source addition: the warm solution equals the stacked resolve bit
    for bit on every rank, and its state a cold solve's."""
    procs, stacked = runs[world]
    want_warm, want_cold = stacked["resolve"][name, kind]
    for r in range(world):
        warm, cold = procs[r]["resolve"][name, kind]
        assert_same([warm], [want_warm])
        assert_same([cold], [want_cold])
    assert want_warm[0].tobytes() == want_cold[0].tobytes()
    assert want_warm[2]["converged"]


@pytest.mark.parametrize("spec", [s for s, _ in SERVICE_SPECS])
@pytest.mark.parametrize("world", [2, 4])
def test_process_service_matches_stacked(runs, world, spec):
    """The query service over the process backend: every rank's answers,
    cache (statistics and keys, in LRU order), router and feed
    statistics, update results, landmark matrix and chained fingerprint
    equal the stacked service's on the same seeded mix; rank 0's
    latencies too (one fake clock), the others' are their own."""
    procs, stacked = runs[world]
    want = stacked["service"][spec]
    assert len(want["answers"]) == SERVICE_QUERIES + len(range(0, SERVICE_QUERIES, 3))
    assert any(a[1] == "landmark" for a in want["answers"])
    assert want["feed"]["warm_refreshes"] > 0
    for r in range(world):
        got = procs[r]["service"][spec]
        for key in ("answers", "cache", "keys", "router", "feed", "landmarks",
                    "fingerprint", "flushes"):
            assert got[key] == want[key], (r, key)
        if r == 0:
            assert got["latencies"] == want["latencies"]
            assert got["results"] == want["results"]
    # one broadcast a flush, one for the update, one for the close
    assert procs[0]["service"][spec]["broadcasts"] == want["flushes"] + 2
    assert want["broadcasts"] == 0


@pytest.mark.parametrize("world", [2, 4])
def test_each_rank_holds_its_share_of_the_ell(world):
    g = build_graphs()[0]
    pg = tg.partition_graph(g, world)
    full = pg.to("cpu")
    total = 0
    for r in range(world):
        part = pg.to("cpu", rank=r)
        assert part.col.shape == (1,) + pg.col.shape[1:]
        for a, b in zip(part, full):
            assert torch.equal(a[0], b[r])
        assert pg.to("cpu", rank=r) is part  # kept for later solves
        total += sum(t.numel() * t.element_size() for t in part)
    assert total == sum(t.numel() * t.element_size() for t in full)
    with pytest.raises(ValueError, match="outside"):
        pg.to("cpu", rank=world)


def test_stacked_ranks_keep_the_default_engine():
    """A Solver without ``ranks`` runs StackedRanks over a flat mesh."""
    s = Solver("delta:5/a2a", n_parts=4, device="cpu")
    assert s.stacked and s.mesh == RankMesh((4,), ("data",))
    commands = [(0, "flush", (), {})]
    assert s.ranks.broadcast_object(commands) is commands  # one process: itself
    with pytest.raises(ValueError, match="holds 4 ranks"):
        Solver("delta:5/a2a", n_parts=2, device="cpu", mesh=make_rank_mesh(4))


def test_nccl_with_more_processes_than_cards_raises():
    cards = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"{cards + 1} processes, {cards} card"):
        check_backend("nccl", cards + 1, "cuda")
    with pytest.raises(ValueError, match="CUDA devices only"):
        check_backend("nccl", 1, "cpu")
    with pytest.raises(ValueError, match="backend must be one of"):
        check_backend("mpi", 1, "cpu")
    check_backend("gloo", 4, "cpu")
    # the CLI refuses before it starts any process group
    from repro_torch.launch import sssp

    with pytest.raises(ValueError, match="card"):
        sssp.main(["--backend", "nccl", "--ranks", str(cards + 1),
                   "--device", "cuda", "--scale", "6"])


def exit_child(rank, world, code):
    if rank == world - 1:
        os._exit(code)
    time.sleep(60)  # a rank waiting for the failed one in a collective


def test_a_failed_rank_process_fails_the_run():
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank process 1 exited with code 3"):
        spawn_ranks(exit_child, 2, (3,), timeout=60)
    assert time.perf_counter() - t0 < 45  # the waiting rank was stopped, not waited for


def test_a_hung_rank_process_fails_the_run():
    with pytest.raises(TimeoutError, match="still running"):
        spawn_ranks(exit_child, 2, (0,), timeout=3)


def test_cli_gloo_two_ranks_verifies():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.sssp", "--device", "cpu",
         "--backend", "gloo", "--ranks", "2", "--scale", "8", "--verify"],
        env=env, capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    assert "verify vs Dijkstra: OK" in r.stdout
    assert "backend=gloo ranks=2" in r.stdout


def test_serve_cli_gloo_two_ranks():
    """The service CLI over two gloo processes: rank 0 serves and prints,
    the follower replays; the freshness check passes on both."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--backend", "gloo", "--ranks", "2", "--scale", "8", "--queries", "40",
         "--updates", "1"],
        env=env, capture_output=True, text=True, timeout=180, cwd=ROOT)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    assert "backend=gloo ranks=2" in r.stdout
    assert r.stdout.count("q/s") == 1  # rank 0 alone prints
    assert "3 refreshed entries verified bit-identical to cold solves" in r.stdout
