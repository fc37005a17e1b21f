"""The process backend: one rank a process of a gloo group
(``core/ranks.py::ProcessRanks``) against the stacked engine
(``StackedRanks``) at the same rank count, on the CPU.

One process group a rank count runs every solve of this module (a
module fixture spawns it once; the stacked solves run in this process
meanwhile).  The grid is ``paper_variant_specs()`` × {a2a, pmin, sparse
with the ref, push and fused relax, auto}, each spec on one of the
``tiny_graphs`` in turn; beside it ``solve_batch`` of 3 lanes,
``/adapt:rho``, ``/trace``, ``/q:bf16`` and ``/q:u16``.  State,
``padded``, ``metrics.as_dict()`` and the flight record must be
bit-identical, and every process must return the same solution.  P = 4
runs on a two-pod mesh, so the ``pod`` level goes through a subgroup.

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


def refusals(solver, g):
    """The messages of what a process backend refuses."""
    from repro_torch.serve import Router

    msgs = []
    sol = solver.solve(Problem(g, SingleSource(0)))
    for call in (lambda: solver.resolve(sol), lambda: Router(solver, g)):
        try:
            call()
        except ValueError as e:
            msgs.append(str(e))
    return msgs


def rank_jobs(rank, world, url, mesh, jobs, out_dir):
    """One rank process: join the group, run every job, and write what
    each returned to ``out_dir/rank{rank}.pkl``."""
    torch.set_num_threads(1)
    ranks = init_ranks("gloo", rank, world, mesh, url)
    graphs = build_graphs()

    def solver_of(cfg):
        return Solver(cfg, n_parts=world, device="cpu", ranks=ranks)

    results = {job[0]: solve_job(solver_of, graphs, job) for job in jobs}
    results["refusals"] = refusals(solver_of("delta:5/a2a"), graphs[0])
    results["counts"] = dict(ranks.counts)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    torch.distributed.destroy_process_group()


def run_processes(world, mesh, jobs, out_dir):
    """Spawn ``world`` gloo rank processes over ``mesh`` running
    ``jobs``; returns each rank's results."""
    os.makedirs(out_dir, exist_ok=True)
    url = "file://" + os.path.join(out_dir, "store")
    spawn_ranks(rank_jobs, world, (url, mesh, jobs, out_dir), timeout=600)
    out = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def stacked_results(world, mesh, jobs):
    graphs = build_graphs()

    def solver_of(cfg):
        return Solver(cfg, n_parts=world, device="cpu", mesh=mesh)

    return {job[0]: solve_job(solver_of, graphs, job) for job in jobs}


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
            procs[world] = run_processes(world, MESHES[world], jobs, dirs[world])
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
            if key != "counts":
                if key == "refusals":
                    assert procs[r][key] == sols
                else:
                    assert_same(procs[r][key], sols)
    # the collectives ran, and every rank ran as many of each
    counts = procs[0]["counts"]
    assert counts["all_reduce"] > 0 and counts["all_to_all"] > 0
    for r in range(1, world):
        assert {k: v for k, v in procs[r]["counts"].items() if k != "bytes"} == \
            {k: v for k, v in counts.items() if k != "bytes"}


@pytest.mark.parametrize("world", [2, 4])
def test_resolve_and_serve_refuse_a_process_backend(runs, world):
    msgs = runs[world][0][0]["refusals"]
    assert len(msgs) == 2
    assert msgs[0].startswith("resolve runs on stacked ranks only")
    assert msgs[1].startswith("the Router runs on stacked ranks only")
    assert all("ROADMAP.md Queue 1 item 1" in m for m in msgs)


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
