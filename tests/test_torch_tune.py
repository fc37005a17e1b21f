"""The port's adaptive execution (``/adapt[:policy]``,
``repro_torch.tune``) and spec auto-tuner against the JAX package's
``repro.tune``: state, ``metrics.as_dict()`` (``retraces``,
``collective_rounds``, ``exchange_bytes`` included) and the
controller's decisions bit-identical over a2a, sparse and auto, with
the static and rho policies (rho also from ``frontier_cap=1``, where it
grows the cap) and a scheduled policy that retunes Δ, the cap and the
exchange between segments; the policy registry; ``AutoTuner`` with the
``model``, ``supersteps`` and ``bytes`` objectives; the tuned-spec
cache's JSON in both directions; ``Router(tuned=...)`` on one query
mix; and ``launch/tune.py`` on the CPU.

``/fused`` and ``relax_impl="push"`` solves are held against the
reference's plain-relax spec (its kernels fail inside ``shard_map``
under jax 0.9.0).  At 2 and 4 stacked ranks the port's states are held
against the P=1 reference and Dijkstra.  The reference routes its
tuned solves through ``solve_batch``, whose sparse route fails under
jax 0.9.0, so the router mix uses dense specs.
"""

import json
import warnings

import jax
import numpy as np
import pytest

import repro.api as ref_api
import repro.core.engine as ref_engine
import repro.graph as ref_graph
import repro.serve as ref_serve
import repro.tune as ref_tune
import repro_torch.api as api
import repro_torch.graph as tg
import repro_torch.serve as serve
import repro_torch.tune as tune
from repro.launch.serve import build_query_mix as ref_query_mix
from repro_torch.core import dijkstra_reference, initial_state

SOURCE = 0


@pytest.fixture(scope="module")
def mesh1():
    return jax.make_mesh((1,), ("data",))


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        yield


def port_graph(g):
    return tg.Graph(g.n, g.src.copy(), g.dst.copy(), g.weight.copy(),
                    name=g.name)


def same(ref, port):
    assert port.state.tobytes() == ref.state.tobytes()
    assert port.metrics.as_dict() == ref.metrics.as_dict()


def adaptive_both(mesh, g, spec, policies=None, **kw):
    """One adaptive run in each package through ``run_adaptive``, from
    ``policies`` (a factory of a fresh policy, default the spec's):
    (ref, port) of (padded state, metrics, report)."""
    rcfg = ref_api.SolverConfig.from_spec(spec, chunk_size=64, **kw)
    pcfg = api.SolverConfig.from_spec(spec, chunk_size=64, **kw)
    make_ref = policies or (lambda pkg: pkg.make_tune_policy(rcfg.adapt))
    rpg = ref_api.Solver(rcfg, mesh=mesh).partition(g)
    recfg = rcfg.engine_config(ref_api.Problem(g, ref_api.SingleSource(0))
                               .processing_fn)
    D0, T0, L0 = ref_engine.initial_state(rpg, recfg.processing,
                                          [(SOURCE, 0.0, 0)])
    ref = ref_tune.run_adaptive(mesh, recfg, rpg, make_ref(ref_tune),
                                D0, T0, L0)
    psolver = api.Solver(pcfg, device="cpu")
    ppg = psolver.partition(port_graph(g))
    pecfg = pcfg.engine_config(api.Problem(port_graph(g), api.SingleSource(0))
                               .processing_fn)
    state = psolver._state(initial_state(ppg, pecfg.processing,
                                         [(SOURCE, 0.0, 0)]))
    port = tune.run_adaptive(pecfg, ppg, ppg.to("cpu"), make_ref(tune), *state)
    return ref, port


def same_run(ref, port):
    (rD, rm, rrep), (pD, pm, prep) = ref, port
    assert np.asarray(rD).tobytes() == pD.numpy().tobytes()
    assert pm.as_dict() == rm.as_dict()
    for f in ("segments", "retraces", "cap_growths", "final_delta",
              "final_frontier_cap"):
        assert getattr(prep, f) == getattr(rrep, f), f
    assert [d.__dict__ for d in prep.decisions] == \
        [d.__dict__ for d in rrep.decisions]


# ------------------------------------------------------------- policies


def test_policy_registry_equals_reference():
    for spec in ("rho", "static", "rho:0.25", " rho : 0.5 "):
        assert tune.canonical_policy(spec) == ref_tune.canonical_policy(spec)
        assert tune.policy_traits(spec) == ref_tune.policy_traits(spec)
    for bad in ("rhoo", "static:1", "rho:x", "rho:0", "rho:2"):
        with pytest.raises(ValueError) as a:
            tune.canonical_policy(bad)
        with pytest.raises(ValueError) as b:
            ref_tune.canonical_policy(bad)
        assert str(a.value) == str(b.value)
    assert api.SolverConfig.from_spec("delta:5/sparse/adapt").name == \
        ref_api.SolverConfig.from_spec("delta:5/sparse/adapt").name


def test_rho_policy_decides_as_reference():
    """The same windows through both RhoPolicies give the same
    decisions (overflow growth, Δ widening and narrowing, exchange)."""
    from repro.core.metrics import SuperstepWindow as RefWindow
    from repro_torch.core.metrics import SuperstepWindow

    rng = np.random.default_rng(0)
    rp, pp = ref_tune.RhoPolicy(0.1), tune.RhoPolicy(0.1)
    delta, cap = 5.0, 64
    for _ in range(40):
        k = int(rng.integers(1, 5))
        fields = dict(
            pending=rng.integers(0, 400, k).tolist(),
            eligible=rng.integers(0, 200, k).tolist(),
            rows=rng.integers(0, 200, k).tolist(),
            sparse_used=rng.integers(0, 2, k).tolist(),
            bytes_moved=[0] * k, overflow_streak=int(rng.integers(0, 4)),
            supersteps_total=k, n=512, rows_per_rank=600,
            sparse_capable=True)
        a = rp.decide(RefWindow(**fields), ref_tune.Tunables(delta, cap, 0))
        b = pp.decide(SuperstepWindow(**fields), tune.Tunables(delta, cap, 0))
        assert a.__dict__ == b.__dict__
        delta = a.delta or delta
        cap = a.frontier_cap or cap


# -------------------------------------------------------- adaptive runs


@pytest.mark.parametrize("cap", [None, 1])
@pytest.mark.parametrize("policy", ["static", "rho"])
@pytest.mark.parametrize("exchange", ["a2a", "sparse", "auto"])
def test_adaptive_run_equals_reference(mesh1, tiny_graphs, exchange, policy,
                                       cap):
    ref, port = adaptive_both(mesh1, tiny_graphs[0],
                              f"delta:5/{exchange}/adapt:{policy}",
                              frontier_cap=cap)
    same_run(ref, port)
    if policy == "rho" and cap == 1 and exchange != "a2a":
        assert port[2].retraces >= 1 and port[2].cap_growths >= 1


@pytest.mark.parametrize("gi", range(4))
def test_adaptive_solve_equals_reference_on_every_graph(mesh1, tiny_graphs, gi):
    g = tiny_graphs[gi]
    spec = "delta:5/sparse/adapt:rho"
    rs = ref_api.Solver(ref_api.SolverConfig.from_spec(
        spec, chunk_size=64, frontier_cap=1), mesh=mesh1)
    ps = api.Solver(api.SolverConfig.from_spec(
        spec, chunk_size=64, frontier_cap=1), device="cpu")
    ref = rs.solve(ref_api.Problem(g, ref_api.SingleSource(SOURCE)))
    port = ps.solve(api.Problem(port_graph(g), api.SingleSource(SOURCE)))
    same(ref, port)
    assert ps.stats()["adapt"] == rs.stats()["adapt"]


@pytest.mark.parametrize("exchange", ["sparse", "auto"])
def test_scheduled_policy_equals_reference(mesh1, tiny_graphs, exchange):
    """A schedule that widens and narrows Δ, forces the exchange both
    ways and changes the cap between segments."""
    def schedule(pkg):
        D = pkg.Decision
        return pkg.ScheduledPolicy([
            D(delta=10.0, exchange_force=1), D(frontier_cap=4),
            D(delta=2.5, exchange_force=2), D(exchange_force=0,
                                              frontier_cap=64),
            D(delta=7.0), D(exchange_force=1, frontier_cap=4),
        ])
    ref, port = adaptive_both(mesh1, tiny_graphs[1],
                              f"delta:5/{exchange}/adapt:static",
                              policies=schedule, frontier_cap=8)
    same_run(ref, port)
    assert port[2].cap_growths == 3 and port[2].retraces == 2


@pytest.mark.parametrize("impl,spec", [
    ("fused", "delta:5/sparse/adapt:rho"), ("push", "delta:5/sparse/adapt:rho"),
    ("fused", "delta:5/auto/adapt:static"),
])
def test_adaptive_kernel_routes_equal_reference(mesh1, tiny_graphs, impl, spec):
    g = tiny_graphs[0]
    ref = ref_api.Solver(ref_api.SolverConfig.from_spec(
        spec, chunk_size=64, frontier_cap=1), mesh=mesh1).solve(
            ref_api.Problem(g, ref_api.SingleSource(SOURCE)))
    port = api.Solver(api.SolverConfig.from_spec(
        spec, chunk_size=64, frontier_cap=1, relax_impl=impl),
        device="cpu").solve(api.Problem(port_graph(g), api.SingleSource(SOURCE)))
    same(ref, port)


def test_adaptive_static_equals_the_untraced_solve(tiny_graphs):
    """Segmenting the schedule moves neither the state nor the metrics."""
    g = port_graph(tiny_graphs[2])
    for spec in ("delta:5/sparse", "kla:2+threadq/sparse", "dijkstra/auto"):
        a = api.Solver(spec, device="cpu").solve(api.Problem(g, api.SingleSource(3)))
        b = api.Solver(spec + "/adapt:static", device="cpu").solve(
            api.Problem(g, api.SingleSource(3)))
        assert a.state.tobytes() == b.state.tobytes()
        assert a.metrics.as_dict() == b.metrics.as_dict()


@pytest.mark.parametrize("n_parts", [2, 4])
def test_adaptive_stacked_ranks_reach_the_fixpoint(mesh1, tiny_graphs, n_parts):
    g = tiny_graphs[0]
    ref = ref_api.Solver("delta:5/sparse/adapt:rho", mesh=mesh1).solve(
        ref_api.Problem(g, ref_api.SingleSource(SOURCE)))
    port = api.Solver(api.SolverConfig.from_spec(
        "delta:5/sparse/adapt:rho", frontier_cap=1), n_parts=n_parts,
        device="cpu").solve(api.Problem(port_graph(g), api.SingleSource(SOURCE)))
    assert port.metrics.converged and port.metrics.retraces >= 1
    assert port.state.tobytes() == ref.state.tobytes()
    assert np.array_equal(port.state, dijkstra_reference(port_graph(g), SOURCE))


def test_adaptive_resolve_equals_reference(mesh1, tiny_graphs):
    g = tiny_graphs[0]
    spec = "delta:5/auto/adapt:rho"
    rs, ps = ref_api.Solver(spec, mesh=mesh1), api.Solver(spec, device="cpu")
    pg_ = port_graph(g)
    ref = rs.resolve(rs.solve(ref_api.Problem(g, ref_api.SingleSource(0))),
                     new_sources=[17])
    port = ps.resolve(ps.solve(api.Problem(pg_, api.SingleSource(0))),
                      new_sources=[17])
    same(ref, port)


def test_solve_batch_refuses_adaptive_specs():
    g = tg.rmat1(6, seed=0)
    with pytest.raises(ValueError, match="adaptive"):
        api.Solver("delta:5/sparse/adapt", device="cpu").solve_batch(
            [api.Problem(g, api.SingleSource(v)) for v in (0, 1)])


# ------------------------------------------------------------ auto-tuner


@pytest.mark.parametrize("objective", ["model", "supersteps", "bytes"])
def test_autotuner_equals_reference(mesh1, tiny_graphs, objective):
    # the port's cost model carries H100 figures; given the JAX
    # package's, the model objective ranks and scores as it does
    from repro.core import metrics as ref_metrics

    ref_costs = (ref_metrics.COST_RELAX_S, ref_metrics.COST_SUPERSTEP_S,
                 ref_metrics.COST_BYTE_S)
    g = tiny_graphs[0]
    ref = ref_tune.AutoTuner(mesh1, objective=objective, pilot_iters=400)
    port = tune.AutoTuner(objective=objective, pilot_iters=400, device="cpu",
                          cost=ref_costs)
    rrec, prec = ref.search(g), port.search(port_graph(g))
    assert prec.spec == rrec.spec and prec.score == rrec.score
    assert prec.fingerprint == rrec.fingerprint
    assert prec.leaderboard == rrec.leaderboard
    assert port.pilots_run == ref.pilots_run == len(prec.leaderboard)
    assert port.tune(port_graph(g)) == api.SolverConfig.from_spec(prec.spec)


def test_autotuner_objective_validation():
    with pytest.raises(ValueError, match="did you mean 'supersteps'"):
        tune.AutoTuner(objective="superstep", device="cpu")


def test_tuned_cache_json_loads_both_ways(tmp_path, tiny_graphs):
    rec = dict(spec="delta:10/sparse", objective="model", score=1.5,
               fingerprint=list(tg.graph_fingerprint(port_graph(tiny_graphs[0]))),
               leaderboard=[dict(spec="delta:10/sparse", score=1.5)])
    ref_path, port_path = tmp_path / "ref.json", tmp_path / "port.json"
    ref_tune.TunedSpecCache.from_json([rec]).save(str(ref_path))
    tune.TunedSpecCache.from_json([rec]).save(str(port_path))
    assert ref_path.read_text() == port_path.read_text()
    a = tune.TunedSpecCache.load(str(ref_path))
    b = ref_tune.TunedSpecCache.load(str(port_path))
    assert a.to_json() == b.to_json() == [rec]
    fp = tuple(rec["fingerprint"])
    assert fp in a and a.get(fp).spec == b.get(fp).spec
    assert a.invalidate(fp) and not a.invalidate(fp)


def test_tuned_cache_follows_the_hash_chain(tiny_graphs):
    """A streamed update moves the fingerprint: the record stops
    matching and the next tune() searches again."""
    g = port_graph(tiny_graphs[0])
    tuner = tune.AutoTuner(quick=True, pilot_iters=400, device="cpu")
    tuner.search(g)
    assert tg.graph_fingerprint(g) in tuner.cache
    tg.chain_fingerprint(g, serve.EdgeUpdate(0, 1, 0.5).record())
    assert tg.graph_fingerprint(g) not in tuner.cache
    n = tuner.pilots_run
    tuner.tune(g)
    assert tuner.pilots_run > n


def test_router_tuned_equals_reference(mesh1, tiny_graphs):
    """One query mix through both routers, each with a tuned record
    for the graph: the same tuned flushes, answers and cache keys."""
    g = ref_graph.rmat1(8, seed=3)
    pg_ = port_graph(g)
    default, tuned_spec = "delta:5+threadq/a2a", "dijkstra+threadq/a2a"
    mix = ref_query_mix(g, 40, 1.3, 0)
    out = {}
    for key, pkg, stack, graph, solver in (
        ("ref", ref_tune, ref_serve, g, ref_api.Solver(default, mesh=mesh1)),
        ("port", tune, serve, pg_, api.Solver(default, device="cpu")),
    ):
        fp = (ref_graph if key == "ref" else tg).graph_fingerprint(graph)
        cache = pkg.TunedSpecCache()
        cache.put(pkg.TunedRecord(spec=tuned_spec, objective="model",
                                  score=0.0, fingerprint=tuple(fp)))
        router = stack.Router(solver, graph, tuned=cache, max_batch=4)
        queries = [stack.Query(q.source, q.target, q.exact) for q in mix]
        answers = router.serve(queries)
        out[key] = (router.stats.tuned_batches, router.stats.batches,
                    [(a.distance, a.served_by, a.solution.state.tobytes())
                     for a in answers],
                    sorted(k[2] for k in router.cache.keys()))
    assert out["port"] == out["ref"]
    assert out["port"][0] > 0


def test_launch_tune_cli_on_cpu(tmp_path, capsys):
    from repro_torch.launch.tune import main

    cache = tmp_path / "TUNE_cache.json"
    out_path = tmp_path / "exported.json"
    assert main(["--search", "--quick", "--scale", "8", "--device", "cpu",
                 "--devices", "2", "--cache", str(cache), "--inspect",
                 "--export", str(out_path)]) == 0
    out = capsys.readouterr().out
    assert "pilot solves" in out and "ranks=2 device=cpu" in out
    rows = json.loads(out_path.read_text())
    assert len(rows) == 1 and rows[0]["spec"]
    assert ref_tune.TunedSpecCache.load(str(out_path)).records()[0].spec == \
        rows[0]["spec"]


def test_serve_cli_with_metrics_and_a_tuned_cache(tmp_path, capsys):
    """The service CLI on the CPU with a tuned cache for its graph, the
    metrics server on a free loopback port and the exposition printed."""
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch.sssp import build_graph

    g = build_graph("rmat1", 8, 0)
    path = tmp_path / "tuned.json"
    tune.TunedSpecCache.from_json([dict(
        spec="delta:10/sparse", objective="model", score=0.0,
        fingerprint=list(tg.graph_fingerprint(g)))]).save(str(path))
    assert serve_cli.main(["--device", "cpu", "--scale", "8", "--queries", "40",
                           "--updates", "1", "--metrics-port", "0",
                           "--stats-text", "--tuned-cache", str(path)]) == 0
    out = capsys.readouterr().out
    assert "spec 'delta:10/sparse' for this graph" in out
    assert "/metrics (+ /stats)" in out
    tuned = [ln for ln in out.splitlines()
             if ln.startswith("repro_router_tuned_batches_total ")]
    assert len(tuned) == 1 and int(tuned[0].split()[1]) > 0
    assert 'repro_span_seconds_count{span="router.flush"}' in out
