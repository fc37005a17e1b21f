"""Pod meshes: the ``pod`` scope of an ordering hierarchy over a
``RankMesh`` with a ``pod`` axis, against the JAX package's engine on a
``("pod", ...)`` device mesh.

* stacked ranks, P = 8 on ``RankMesh((2, 4), ("pod", "data"))``,
  against the reference on ``jax.make_mesh((2, 2, 2), ("pod", "data",
  "model"))`` with 8 forced host devices;
* one rank a process over gloo, P = 4 on ``RankMesh((2, 2), ("pod",
  "data"))``, against the reference on ``("pod", "data")`` with 4;

for ``delta:5 > pod:dijkstra``, ``kla:2 > pod:dijkstra >
device:dijkstra`` and the ``nodeq`` specs of ``paper_variant_specs()``
on the dense exchanges (a2a, pmin): state and ``metrics.as_dict()``
equal.  The references run in subprocesses, as
``tests/test_distributed_subprocess.py`` runs them (the XLA flag lives
only in the child), while the port solves here.  The reference's sparse
exchange fails at P = 8 (ROADMAP.md Queue 3), so the sparse pod runs
are held against Dijkstra and the process runs against the stacked
port.
"""

import json
import os
import pickle
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch.api import Solver
from repro_torch.core import dijkstra_reference, paper_variant_specs
from repro_torch.core.ranks import StackedRanks
from repro_torch.launch.mesh import RankMesh, make_rank_mesh
from test_torch_dist import GRAPHS, assert_same, build_graphs, run_processes, solve_job

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

POD_SPECS = (["delta:5 > pod:dijkstra", "kla:2 > pod:dijkstra > device:dijkstra"]
             + [s for s in paper_variant_specs() if s.endswith("+nodeq")])
DENSE = ("a2a", "pmin")
STACKED_MESH = RankMesh((2, 4), ("pod", "data"))
PROCESS_MESH = RankMesh((2, 2), ("pod", "data"))
REF_MESHES = {8: ((2, 2, 2), ("pod", "data", "model")),
              4: ((2, 2), ("pod", "data"))}

REF_CHILD = r"""
import json, pickle, sys, warnings
import jax
n_dev, shape, names = int(sys.argv[1]), json.loads(sys.argv[2]), json.loads(sys.argv[3])
jobs_path, out_path = sys.argv[4], sys.argv[5]
assert len(jax.devices()) == n_dev, jax.devices()
import repro.graph as rg
from repro.api import Problem, SingleSource, Solver
with open(jobs_path, "rb") as f:
    graph_specs, jobs = pickle.load(f)
graphs = [getattr(rg, kind)(**kw) for kind, kw in graph_specs]
mesh = jax.make_mesh(tuple(shape), tuple(names))
out = {}
for key, gi, spec in jobs:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        s = Solver(spec, mesh=mesh).solve(Problem(graphs[gi], SingleSource(0)))
    out[key] = (s.state, s.metrics.as_dict())
with open(out_path, "wb") as f:
    pickle.dump(out, f)
print("REF-MESH-OK")
"""


def dense_jobs():
    return [(f"{spec}/{ex}", (i + j) % len(GRAPHS), f"{spec}/{ex}")
            for i, spec in enumerate(POD_SPECS) for j, ex in enumerate(DENSE)]


def sparse_jobs():
    return [(f"{spec}/sparse", i % len(GRAPHS), f"{spec}/sparse")
            for i, spec in enumerate(POD_SPECS)]


def start_reference(n_dev, tmp):
    shape, names = REF_MESHES[n_dev]
    jobs_path = os.path.join(tmp, f"jobs{n_dev}.pkl")
    with open(jobs_path, "wb") as f:
        pickle.dump((GRAPHS, dense_jobs()), f)
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={n_dev}")
    out_path = os.path.join(tmp, f"ref{n_dev}.pkl")
    proc = subprocess.Popen(
        [sys.executable, "-c", REF_CHILD, str(n_dev), json.dumps(shape),
         json.dumps(names), jobs_path, out_path],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    return proc, out_path


def finish_reference(proc, out_path):
    try:
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0 and "REF-MESH-OK" in out, err[-3000:]
    with open(out_path, "rb") as f:
        return pickle.load(f)


def port_jobs(jobs):
    return [(key, gi, spec, "ref", False) for key, gi, spec in jobs]


def stacked(world, mesh, jobs):
    graphs = build_graphs()

    def solver_of(cfg):
        return Solver(cfg, n_parts=world, device="cpu", mesh=mesh)

    return {job[0]: solve_job(solver_of, graphs, job) for job in port_jobs(jobs)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The references (subprocesses), the process group (a thread) and
    the stacked solves (here), all at once."""
    tmp = str(tmp_path_factory.mktemp("pods"))
    refs = {n: start_reference(n, tmp) for n in REF_MESHES}
    jobs = dense_jobs() + sparse_jobs()
    procs, errors = {}, []

    def spawn():
        try:
            procs["out"] = run_processes(4, PROCESS_MESH, port_jobs(jobs),
                                         os.path.join(tmp, "gloo4"))
        except BaseException as e:  # re-raised below, in the test
            errors.append(e)

    thread = threading.Thread(target=spawn)
    thread.start()
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)  # leave the cores to the other processes
    try:
        out = {
            "stacked8": stacked(8, STACKED_MESH, jobs),
            "stacked4": stacked(4, PROCESS_MESH, jobs),
            "flat8": stacked(8, make_rank_mesh(8), dense_jobs()),
        }
    finally:
        torch.set_num_threads(n_threads)
    for n, (proc, path) in refs.items():
        out[f"ref{n}"] = finish_reference(proc, path)
    thread.join(700)
    assert not thread.is_alive(), "the process group did not finish"
    if errors:
        raise errors[0]
    out["process4"] = procs["out"][0]
    out["dijkstra"] = [dijkstra_reference(g, 0).astype(np.float32)
                       for g in build_graphs()]
    return out


def assert_ref(port, ref):
    (state, _, metrics, _), = port
    assert state.tobytes() == np.asarray(ref[0], np.float32).tobytes()
    assert metrics == ref[1]


@pytest.mark.parametrize("key", [j[0] for j in dense_jobs()])
def test_stacked_pod_mesh_matches_reference_8(runs, key):
    assert_ref(runs["stacked8"][key], runs["ref8"][key])


@pytest.mark.parametrize("key", [j[0] for j in dense_jobs()])
def test_process_pod_mesh_matches_reference_4(runs, key):
    assert_ref(runs["process4"][key], runs["ref4"][key])
    assert_same(runs["process4"][key], runs["stacked4"][key])


@pytest.mark.parametrize("job", sparse_jobs(), ids=lambda j: j[0])
def test_sparse_pod_mesh_reaches_dijkstra(runs, job):
    key, gi, _ = job
    truth = runs["dijkstra"][gi].tobytes()
    for run in ("stacked8", "stacked4", "process4"):
        (state, _, metrics, _), = runs[run][key]
        assert state.tobytes() == truth, run
        assert metrics["converged"]
    assert_same(runs["process4"][key], runs["stacked4"][key])


def test_pod_scope_changes_the_schedule(runs):
    """On a two-pod mesh the pod level is a sub-root of its own: some
    spec's schedule differs from the flat mesh's (where pod = all)."""
    differ = [key for key, _, _ in dense_jobs()
              if runs["stacked8"][key][0][2] != runs["flat8"][key][0][2]]
    assert differ
    for key, _, _ in dense_jobs():  # the same fixpoint either way
        assert runs["stacked8"][key][0][0].tobytes() == \
            runs["flat8"][key][0][0].tobytes()


def test_rank_mesh_layout():
    m = RankMesh((2, 4), ("pod", "data"))
    assert (m.size, m.pods, m.per_pod) == (8, 2, 4)
    assert [m.pod_of(r) for r in range(8)] == [0, 0, 0, 0, 1, 1, 1, 1]
    assert m.pod_ranks(1) == [4, 5, 6, 7]
    flat = make_rank_mesh(4)
    assert (flat.shape, flat.axis_names, flat.pods) == ((4,), ("data",), 1)
    assert make_rank_mesh(6, pods=3) == RankMesh((3, 2), ("pod", "data"))
    three = RankMesh((2, 2, 2), ("pod", "data", "model"))
    assert three.per_pod == 4 and three.pod_of(5) == 1
    with pytest.raises(ValueError, match="do not split"):
        make_rank_mesh(6, pods=4)
    with pytest.raises(ValueError, match="must lead"):
        RankMesh((2, 2), ("data", "pod"))
    with pytest.raises(ValueError, match="one name per axis"):
        RankMesh((2, 2), ("pod",))
    with pytest.raises(ValueError, match="outside"):
        m.pod_of(8)


def test_stacked_ranks_pod_min():
    """StackedRanks' pod scope: each rank sees its pod's min."""
    key = torch.tensor(np.random.default_rng(0).uniform(0, 9, (3, 8, 5)),
                       dtype=torch.float32)
    ranks = StackedRanks(RankMesh((2, 4), ("pod", "data")))
    got = ranks.min_over(key, "pod")
    want = torch.stack([key[:, :4].amin((1, 2)), key[:, 4:].amin((1, 2))], 1)
    assert torch.equal(got[..., 0], want.repeat_interleave(4, dim=1))
    assert torch.equal(ranks.min_over(key, "global"),
                       key.amin((1, 2), keepdim=True))
    flat = StackedRanks(8)
    assert torch.equal(flat.min_over(key, "pod"), flat.min_over(key, "global"))


def test_cli_gloo_pod_mesh_verifies():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.sssp", "--device", "cpu",
         "--backend", "gloo", "--ranks", "4", "--pods", "2", "--scale", "8",
         "--spec", "delta:5 > pod:dijkstra /sparse/fused", "--verify"],
        env=env, capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    assert "verify vs Dijkstra: OK" in r.stdout
    assert "mesh=(2, 2)('pod', 'data')" in r.stdout
