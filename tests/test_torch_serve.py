"""The port's query service (``repro_torch.serve``) against the JAX
package's ``repro.serve``: the cases of ``tests/test_serve.py`` that
need neither 8 devices nor jit trace counts, and one seeded query mix
and update sequence driven through both stacks, whose answers, cache,
router and feed statistics and chained fingerprints must be equal.
Also ``LatencyStats``, the span tracer's names, and the service CLI on
the CPU.

The cross-stack runs use the dense spec ``delta:5+threadq/a2a`` on the
reference, whose batched sparse route fails under jax 0.9.0 (see
``test_torch_batch.py``); the port runs it and ``delta:5/sparse/fused``."""

import warnings

import jax
import numpy as np
import pytest

import repro.core as ref_core
import repro.graph as ref_graph
import repro.obs.trace as ref_obs
import repro.serve as ref_serve
import repro_torch.graph as tg
from repro.api import Solver as RefSolver
from repro.launch.serve import build_query_mix as ref_query_mix
from repro_torch.api import Problem, SingleSource, Solver
from repro_torch.core import LatencyStats, dijkstra_reference
from repro_torch.graph import (
    chain_fingerprint,
    clear_fingerprint_chain,
    graph_fingerprint,
)
from repro_torch.launch import serve as serve_cli
from repro_torch.obs import trace as obs
from repro_torch.serve import (
    EdgeUpdate,
    LandmarkIndex,
    Query,
    Router,
    SolutionCache,
    UpdateFeed,
    serve_latency_stats,
)

SPEC = "delta:5+threadq/a2a"


def close(a, b):
    return np.allclose(
        np.where(np.isinf(a), -1, a), np.where(np.isinf(b), -1, b)
    )


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        yield


@pytest.fixture(scope="module")
def mesh1():
    return jax.make_mesh((1,), ("data",))


@pytest.fixture(scope="module")
def solver():
    return Solver(SPEC, device="cpu")


def port_graph(g):
    return tg.Graph(g.n, g.src.copy(), g.dst.copy(), g.weight.copy(),
                    name=g.name)


def fresh_graph(seed=3):
    """A private graph per test: the update tests mutate edges in place."""
    return tg.rmat1(8, seed=seed)


# ------------------------------------------------- fingerprint chain


def test_chain_fingerprint_is_incremental_and_ordered():
    g1, g2 = fresh_graph(), fresh_graph()
    base = graph_fingerprint(g1)
    assert base == graph_fingerprint(g2)
    a = EdgeUpdate(0, 1, 2.0).record()
    b = EdgeUpdate(1, 0, 3.0).record()
    fa1 = chain_fingerprint(g1, a)
    fa2 = chain_fingerprint(g2, a)
    assert fa1 == fa2 and fa1 != base
    fb1 = chain_fingerprint(g1, b)
    g3 = fresh_graph()
    chain_fingerprint(g3, b)
    fb3 = chain_fingerprint(g3, a)
    assert fb1 != fb3  # order-sensitive hash chain
    assert graph_fingerprint(g1) == fb1
    assert graph_fingerprint(g1, full=True) == base
    clear_fingerprint_chain(g1)
    assert graph_fingerprint(g1) == base


def test_chain_fingerprint_tracks_full_rehash_oracle():
    g = fresh_graph()
    full_before = graph_fingerprint(g, full=True)
    upd = EdgeUpdate(int(g.src[5]), int(g.dst[5]), float(g.weight[5]) * 0.5)
    g.weight[5] *= 0.5
    token = chain_fingerprint(g, upd.record())
    assert graph_fingerprint(g, full=True) != full_before
    assert token != full_before
    assert token != graph_fingerprint(g, full=True)


def test_fingerprints_equal_the_reference_token_for_token():
    """Full rehashes and chains give the reference's tuples, value for
    value, through a sequence of records."""
    r, p = ref_graph.rmat1(8, seed=3), fresh_graph()
    assert graph_fingerprint(p) == ref_graph.graph_fingerprint(r)
    for upd in (EdgeUpdate(0, 1, 2.0), EdgeUpdate(3, 7, 0.5, delete=True),
                EdgeUpdate(9, 2, 1.25)):
        assert chain_fingerprint(p, upd.record()) == \
            ref_graph.chain_fingerprint(r, ref_serve.EdgeUpdate(
                upd.src, upd.dst, upd.weight, upd.delete).record())
        assert graph_fingerprint(p) == ref_graph.graph_fingerprint(r)
    assert graph_fingerprint(p, full=True) == \
        ref_graph.graph_fingerprint(r, full=True)


# ------------------------------------------------------------- cache


def _solution_for(solver, g, v):
    return solver.solve(Problem(g, SingleSource(v)))


def test_cache_lru_hit_miss_counters(solver):
    g = fresh_graph()
    key = SolutionCache.key_for(graph_fingerprint(g), 0, solver.config.name)
    cache = SolutionCache(byte_budget=1 << 20)
    assert cache.get(key) is None
    cache.put(key, _solution_for(solver, g, 0))
    assert cache.get(key) is not None
    assert cache.stats.hits == 1 and cache.stats.misses == 1
    assert cache.stats.bytes > 0 and cache.stats.hit_rate() == 0.5
    assert cache.peek(key) is not None and cache.stats.hits == 1


def test_cache_byte_budget_evicts_lru(solver):
    g = fresh_graph()
    fp = graph_fingerprint(g)
    one = _solution_for(solver, g, 0)
    cache = SolutionCache(byte_budget=int(one.nbytes * 2.5))
    keys = [SolutionCache.key_for(fp, v, solver.config.name) for v in range(4)]
    for k, v in zip(keys, range(4)):
        cache.put(k, _solution_for(solver, g, v))
    assert len(cache) == 2 and cache.stats.evictions == 2
    assert cache.peek(keys[0]) is None and cache.peek(keys[3]) is not None
    assert cache.stats.bytes <= cache.byte_budget
    tiny = SolutionCache(byte_budget=1)
    tiny.put(keys[0], one)
    assert len(tiny) == 1


def test_cache_invalidate_graph(solver):
    g = fresh_graph()
    fp = graph_fingerprint(g)
    cache = SolutionCache()
    for v in range(3):
        cache.put(SolutionCache.key_for(fp, v, solver.config.name),
                  _solution_for(solver, g, v))
    cache.put(SolutionCache.key_for(("other",), 0, solver.config.name),
              _solution_for(solver, g, 0))
    assert cache.invalidate_graph(fp) == 3
    assert len(cache) == 1 and cache.stats.invalidations == 3
    assert cache.entries_for(fp) == []


# --------------------------------------------------- solver seams


def test_solve_batch_padded_lanes_are_dropped(solver):
    g = fresh_graph()
    sols = solver.solve_batch([Problem(g, SingleSource(v)) for v in (0, 5, 11)])
    assert len(sols) == 3
    for v, sol in zip((0, 5, 11), sols):
        assert close(dijkstra_reference(g, v), sol.state)


def test_solution_seams(solver):
    g = fresh_graph()
    sol = solver.solve(Problem(g, SingleSource(3)))
    assert sol.source == 3 and sol.graph is g
    assert sol.nbytes == sol.state.nbytes + sol.padded.nbytes
    assert sol.distance_to(3) == 0.0
    ref = dijkstra_reference(g, 3)
    assert sol.distance_to(7) == ref[7] or (
        np.isinf(sol.distance_to(7)) and np.isinf(ref[7]))
    with pytest.raises(ValueError):
        sol.distance_to(g.n)
    info = solver.stats()
    assert info["partition_memo_size"] >= 1
    assert info["partition_memo_capacity"] == 8


# ------------------------------------------------------------ router


def test_router_serves_correct_answers(solver):
    g = fresh_graph()
    router = Router(solver, g, max_batch=4)
    ans = router.serve([Query(0), Query(5, target=9), Query(0, target=2)])
    ref0, ref5 = dijkstra_reference(g, 0), dijkstra_reference(g, 5)
    assert close(ref0, ans[0].solution.state)
    assert ans[1].distance == ref5[9] and ans[2].distance == ref0[2]
    assert ans[2].served_by in ("cache", "batch")
    assert all(a.latency_s >= 0 for a in ans)


def test_router_cache_hits_and_dedupe(solver):
    g = fresh_graph()
    router = Router(solver, g, max_batch=8)
    router.serve([Query(0), Query(0, target=1), Query(0, target=2)])
    assert router.stats.batched_solves == 1
    assert router.serve([Query(0)])[0].served_by == "cache"
    assert router.cache.stats.hits >= 1


def test_router_size_trigger_flushes(solver):
    router = Router(solver, fresh_graph(), max_batch=2)
    t1 = router.submit(Query(0))
    assert not t1.done
    t2 = router.submit(Query(5))
    assert t1.done and t2.done


def test_router_timeout_trigger(solver):
    now = [0.0]
    router = Router(solver, fresh_graph(), max_batch=64, max_wait_s=0.5,
                    clock=lambda: now[0])
    t = router.submit(Query(0))
    assert not router.pump() and not t.done
    now[0] = 0.6
    assert router.pump() and t.done
    assert t.answer.latency_s == pytest.approx(0.6)


def test_router_ticket_result_forces_flush(solver):
    g = fresh_graph()
    router = Router(solver, g, max_batch=64)
    ans = router.submit(Query(7)).result()
    assert close(dijkstra_reference(g, 7), ans.solution.state)


def test_router_refuses_tuned_routing(solver):
    """A tuned-spec cache without a record for the graph (or whose
    record names the default spec) leaves every flush on the default
    solver; tests/test_torch_tune.py covers a record that routes."""
    from repro_torch.tune import TunedRecord, TunedSpecCache

    g = fresh_graph()
    cache = TunedSpecCache()
    router = Router(solver, g, tuned=cache)
    ans = router.submit(Query(7)).result()
    assert close(dijkstra_reference(g, 7), ans.solution.state)
    cache.put(TunedRecord(spec=solver.config.name, objective="model",
                          score=0.0, fingerprint=graph_fingerprint(g)))
    router.submit(Query(9)).result()
    assert router.stats.tuned_batches == 0 and router.stats.batches == 2


# --------------------------------------------------------- landmarks


def test_landmark_bounds_sandwich_truth(solver):
    g = fresh_graph()
    lm = LandmarkIndex(solver, g, k=4, symmetric=True)
    assert lm.k == 4 and lm.dist.shape == (4, g.n)
    rng = np.random.default_rng(0)
    for s in rng.integers(0, g.n, 5):
        ref = dijkstra_reference(g, int(s))
        for t in rng.integers(0, g.n, 4):
            est, d = lm.estimate(int(s), int(t)), ref[int(t)]
            if np.isinf(d):
                assert np.isinf(est.upper)
            else:
                assert est.lower <= d <= est.upper
    est = lm.estimate(3, 3)
    assert est.exact and est.upper == 0.0
    hub = lm.landmarks[0]
    tgt = int(np.flatnonzero(np.isfinite(lm.dist[0]))[1])
    est = lm.estimate(hub, tgt)
    assert est.exact and est.upper == lm.dist[0, tgt]


def test_landmarks_equal_the_reference(solver, mesh1):
    r, p = ref_graph.rmat2(8, seed=5), port_graph(ref_graph.rmat2(8, seed=5))
    ref = ref_serve.LandmarkIndex(RefSolver(SPEC, mesh=mesh1), r, k=5,
                                  symmetric=True)
    port = LandmarkIndex(solver, p, k=5, symmetric=True)
    assert port.landmarks == ref.landmarks
    assert port.dist.tobytes() == ref.dist.tobytes()
    assert port.fingerprint == ref.fingerprint
    for s, t in ((0, 9), (17, 3), (40, 40), (100, 7)):
        a, b = port.estimate(s, t), ref.estimate(s, t)
        assert (a.source, a.target, a.lower, a.upper, a.exact) == \
            (b.source, b.target, b.lower, b.upper, b.exact)


def test_router_landmark_tier_and_escalation(solver):
    g = fresh_graph()
    lm = LandmarkIndex(solver, g, k=4, symmetric=True)
    router = Router(solver, g, landmarks=lm, max_batch=4)
    a = router.serve([Query(0, target=9, exact=False)])[0]
    assert a.served_by == "landmark" and a.lower <= a.upper
    assert a.distance == a.upper and router.stats.landmark_served == 1
    b = router.serve([Query(0, target=9, exact=True)])[0]
    ref = dijkstra_reference(g, 0)[9]
    assert b.served_by in ("cache", "batch") and b.distance == ref
    assert a.lower <= b.distance <= a.upper
    c = Router(solver, g, max_batch=4).serve(
        [Query(0, target=9, exact=False)])[0]
    assert c.served_by in ("cache", "batch") and c.distance == ref


# ---------------------------------------------------- streaming updates


def test_feed_improving_drop_warm_refresh_bit_identical(solver):
    g = fresh_graph()
    router = Router(solver, g, max_batch=4)
    router.serve([Query(0), Query(5)])
    feed = UpdateFeed(g, solver, cache=router.cache)
    e = 17
    res = feed.apply(EdgeUpdate(int(g.src[e]), int(g.dst[e]),
                                float(g.weight[e]) * 0.25))
    assert res.improving and not res.inserted
    assert res.warm_refreshes == 2 and res.cold_refreshes == 0
    assert res.fingerprint == graph_fingerprint(g)
    entries = router.cache.entries_for(graph_fingerprint(g))
    assert len(entries) == 2
    cold_steps = 0
    for key, sol in entries:
        cold = solver.solve(Problem(g, SingleSource(key[1])))
        assert np.array_equal(sol.state, cold.state)
        assert close(dijkstra_reference(g, key[1]), sol.state)
        cold_steps += cold.metrics.supersteps
    assert res.warm_supersteps < cold_steps


def test_feed_insertion_is_improving(solver):
    g = fresh_graph()
    m_before = g.m
    router = Router(solver, g, max_batch=4)
    router.serve([Query(0)])
    feed = UpdateFeed(g, solver, cache=router.cache)
    dst = 1
    while ((g.src == 0) & (g.dst == dst)).any():
        dst += 1
    res = feed.apply(EdgeUpdate(0, dst, 0.5))
    assert res.improving and res.inserted and g.m == m_before + 1
    [(key, sol)] = router.cache.entries_for(graph_fingerprint(g))
    cold = solver.solve(Problem(g, SingleSource(0)))
    assert np.array_equal(sol.state, cold.state)
    assert sol.state[dst] <= 0.5


def test_feed_non_improving_detected_and_cold_solved(solver):
    g = fresh_graph()
    router = Router(solver, g, max_batch=4)
    router.serve([Query(0), Query(5)])
    fp_old = graph_fingerprint(g)
    feed = UpdateFeed(g, solver, cache=router.cache)
    e = 3
    res = feed.apply(EdgeUpdate(int(g.src[e]), int(g.dst[e]),
                                float(g.weight[e]) * 100.0))
    assert not res.improving
    assert res.invalidated == 2 and res.cold_refreshes == 2
    assert router.cache.entries_for(fp_old) == []
    for key, sol in router.cache.entries_for(graph_fingerprint(g)):
        assert close(dijkstra_reference(g, key[1]), sol.state)
    e2 = 9
    res2 = feed.apply(EdgeUpdate(int(g.src[e2]), int(g.dst[e2]), delete=True))
    assert not res2.improving and res2.cold_refreshes == 2
    assert np.isinf(g.weight[e2])
    for key, sol in router.cache.entries_for(graph_fingerprint(g)):
        assert close(dijkstra_reference(g, key[1]), sol.state)


def test_feed_lazy_mode_invalidates_only(solver):
    g = fresh_graph()
    router = Router(solver, g, max_batch=4)
    router.serve([Query(0)])
    feed = UpdateFeed(g, solver, cache=router.cache, refresh="lazy")
    e = 11
    res = feed.apply(EdgeUpdate(int(g.src[e]), int(g.dst[e]),
                                float(g.weight[e]) * 0.25))
    assert res.warm_refreshes == 0 and res.invalidated == 1
    assert len(router.cache) == 0
    a = router.serve([Query(0)])[0]
    assert a.served_by == "batch"
    assert close(dijkstra_reference(g, 0), a.solution.state)


def test_service_keeps_no_superseded_partition(solver):
    """After improving updates the service (cache, landmarks, feed,
    router, solver memo) refers only to the current partition: the one
    it solved the mix on dies once the caller drops its answers, and
    lives while they are kept (a caller's Solution holds its partition
    and the ELL copied to the device)."""
    import gc
    import weakref

    from repro_torch.launch.serve import build_query_mix, improving_updates

    def service(keep):
        g = fresh_graph()
        cache = SolutionCache(byte_budget=1 << 20)
        lm = LandmarkIndex(solver, g, k=4, symmetric=True)
        router = Router(solver, g, cache=cache, landmarks=lm, max_batch=4)
        answers = router.serve(build_query_mix(g, 40, 1.3, seed=4))
        first = weakref.ref(solver.partition(g))
        feed = UpdateFeed(g, solver, cache=cache, landmarks=lm)
        for upd in improving_updates(g, 2, seed=5):
            assert feed.apply(upd).warm_refreshes > 0
        if not keep:
            del answers
        gc.collect()
        parts = {id(s.pg) for _, s in cache.entries_for(graph_fingerprint(g))}
        parts |= {id(s.pg) for s in lm.solutions}
        assert parts == {id(solver.partition(g))}
        return first() is not None

    assert not service(keep=False)
    assert service(keep=True)


def test_feed_layout_change_falls_back_to_cold():
    """At two ranks under ebal, insertions from one vertex move the
    ownership boundary: resolve refuses and the feed cold-solves."""
    g = fresh_graph()
    solver = Solver("delta:5/sparse/fused@ebal", n_parts=2, device="cpu")
    router = Router(solver, g, max_batch=4)
    router.serve([Query(0)])
    lm = LandmarkIndex(solver, g, k=2, symmetric=True)
    feed = UpdateFeed(g, solver, cache=router.cache, landmarks=lm)
    before = solver.partition(g)
    v, cold = 1, 0
    while solver.partition(g).same_layout(before):
        v += 1
        if ((g.src == 2) & (g.dst == v)).any():
            continue
        cold += feed.apply(EdgeUpdate(2, v, 3.0)).cold_refreshes
    assert cold == 1  # the update that moved the boundary
    [(key, sol)] = router.cache.entries_for(graph_fingerprint(g))
    assert close(dijkstra_reference(g, key[1]), sol.state)
    for v, row in zip(lm.landmarks, lm.dist):
        assert close(dijkstra_reference(g, v), row)


def test_feed_validates_inputs(solver):
    g = fresh_graph()
    feed = UpdateFeed(g, solver)
    with pytest.raises(ValueError):
        feed.apply(EdgeUpdate(g.n, 0, 1.0))
    with pytest.raises(ValueError):
        feed.apply(EdgeUpdate(0, 1, -2.0))
    with pytest.raises(ValueError):
        UpdateFeed(g, solver, refresh="sometimes")


# ------------------------------------------- both stacks, one mix


def _drive(stack, g, solver, queries, updates, clock):
    """One query mix, then the updates, through one stack (``stack``:
    the module holding Router, SolutionCache, ... ); returns the answers
    and the feed results."""
    cache = stack.SolutionCache(byte_budget=1 << 20)
    lm = stack.LandmarkIndex(solver, g, k=4, symmetric=True)
    router = stack.Router(solver, g, cache=cache, landmarks=lm, max_batch=4,
                          max_wait_s=0.01, clock=clock)
    tickets = []
    for q in queries:
        tickets.append(router.submit(stack.Query(q.source, q.target, q.exact)))
        clock.tick()
        router.pump()
    router.flush()
    answers = [t.result() for t in tickets]
    feeds = {}
    results = []
    for policy, upd in updates:
        feed = feeds.setdefault(policy, stack.UpdateFeed(
            g, solver, cache=cache, landmarks=lm, refresh=policy))
        results.append(feed.apply(stack.EdgeUpdate(upd.src, upd.dst,
                                                   upd.weight, upd.delete)))
    after = router.serve([stack.Query(q.source, q.target, q.exact)
                          for q in queries[:12]])
    return answers + after, results, router, cache, lm, feeds


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def tick(self):
        self.t += 0.004


@pytest.mark.parametrize("port_spec", [SPEC, "delta:5/sparse/fused"])
def test_service_equals_reference_on_a_seeded_mix(mesh1, port_spec):
    """A seeded mix (build_query_mix, as the CLIs make it) and one
    improving update, one insertion, one non-improving update and a lazy
    one through both stacks: every answer, the cache, router and feed
    statistics and the chained fingerprints equal."""
    r_g = ref_graph.rmat1(8, seed=3)
    p_g = port_graph(r_g)
    queries = serve_cli.build_query_mix(p_g, 60, 1.3, seed=4)
    assert queries == [Query(q.source, q.target, q.exact)
                       for q in ref_query_mix(r_g, 60, 1.3, seed=4)]
    e, f = 17, 40
    dst = 1
    while ((p_g.src == 2) & (p_g.dst == dst)).any():
        dst += 1
    updates = [
        ("eager", EdgeUpdate(int(p_g.src[e]), int(p_g.dst[e]),
                             float(p_g.weight[e]) * 0.25)),
        ("eager", EdgeUpdate(2, dst, 0.5)),
        ("eager", EdgeUpdate(int(p_g.src[f]), int(p_g.dst[f]),
                             float(p_g.weight[f]) * 4.0)),
        ("lazy", EdgeUpdate(int(p_g.src[e]), int(p_g.dst[e]), 0.125)),
    ]
    ref = _drive(ref_serve, r_g, RefSolver(SPEC, mesh=mesh1), queries,
                 updates, Clock())
    port = _drive(__import__("repro_torch.serve", fromlist=["Router"]), p_g,
                  Solver(port_spec, device="cpu"), queries, updates, Clock())
    (r_ans, r_res, r_router, r_cache, r_lm, r_feeds) = ref
    (p_ans, p_res, p_router, p_cache, p_lm, p_feeds) = port
    assert len(p_ans) == len(r_ans)
    for a, b in zip(p_ans, r_ans):
        assert (a.query.source, a.query.target, a.query.exact) == \
            (b.query.source, b.query.target, b.query.exact)
        assert (a.served_by, a.lower, a.upper) == (b.served_by, b.lower, b.upper)
        assert a.distance == b.distance or (
            a.distance is not None and np.isnan(a.distance) and np.isnan(b.distance))
        assert a.latency_s == b.latency_s
        assert (a.solution is None) == (b.solution is None)
        if a.solution is not None:
            assert a.solution.state.tobytes() == b.solution.state.tobytes()
            assert a.estimated == b.estimated
    assert p_cache.stats.as_dict() == r_cache.stats.as_dict()
    assert p_router.stats.as_dict() == r_router.stats.as_dict()
    for pol in ("eager", "lazy"):
        assert p_feeds[pol].stats.as_dict() == r_feeds[pol].stats.as_dict()
    for a, b in zip(p_res, r_res):
        assert (a.improving, a.inserted, a.warm_refreshes, a.cold_refreshes,
                a.invalidated) == (b.improving, b.inserted, b.warm_refreshes,
                                   b.cold_refreshes, b.invalidated)
        assert a.fingerprint == b.fingerprint
    assert graph_fingerprint(p_g) == ref_graph.graph_fingerprint(r_g)
    assert p_lm.dist.tobytes() == r_lm.dist.tobytes()
    assert p_router.latency_stats().as_dict() == \
        r_router.latency_stats().as_dict()
    assert sorted(k[:2] for k in p_cache.keys()) == \
        sorted(k[:2] for k in r_cache.keys())


def test_spans_carry_the_reference_names(mesh1):
    """The solver and the serving tier open spans and events under the
    reference's names (the reference also names its compiled-engine
    cache, which the port does not have)."""
    names = {}
    for key, tracing, stack, g, solver in (
        ("ref", ref_obs, ref_serve, ref_graph.rmat1(8, seed=3),
         RefSolver(SPEC, mesh=mesh1)),
        ("port", obs, __import__("repro_torch.serve", fromlist=["Router"]),
         fresh_graph(), Solver(SPEC, device="cpu")),
    ):
        tracer = tracing.Tracer()
        with tracing.use_tracer(tracer):
            lm = stack.LandmarkIndex(solver, g, k=2, symmetric=True)
            router = stack.Router(solver, g, landmarks=lm, max_batch=4)
            router.serve([stack.Query(0), stack.Query(5, target=2),
                          stack.Query(0, target=9, exact=False)])
            stack.UpdateFeed(g, solver, cache=router.cache,
                             landmarks=lm).apply(stack.EdgeUpdate(
                                 int(g.src[3]), int(g.dst[3]),
                                 float(g.weight[3]) * 0.5))
        names[key] = ({s.name for s in tracer.spans},
                      {e.name for e in tracer.events})
    engine_only = {"engine.build", "engine_cache_hit", "engine_cache_miss"}
    assert names["port"][0] == names["ref"][0] - engine_only
    assert names["port"][1] == names["ref"][1] - engine_only
    assert {"router.flush", "solver.solve_batch", "solver.resolve",
            "solver.bootstrap_sweep", "landmarks.build", "landmarks.refresh",
            "feed.apply", "feed.refresh_cache"} <= names["port"][0]


# ----------------------------------------------------- latency stats


def test_latency_stats_nearest_rank():
    xs = [float(i) for i in range(1, 101)]
    st = LatencyStats.from_samples(xs)
    assert st.count == 100 and st.p50_s == 50.0
    assert st.p90_s == 90.0 and st.p99_s == 99.0 and st.max_s == 100.0
    assert LatencyStats.from_samples([]).count == 0
    one = LatencyStats.from_samples([0.25])
    assert one.p50_s == one.p99_s == one.max_s == 0.25


@pytest.mark.parametrize("seed", range(4))
def test_latency_stats_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    a = rng.exponential(0.01, int(rng.integers(0, 40))).tolist()
    b = rng.exponential(0.02, int(rng.integers(1, 40))).tolist()
    port_a, port_b = LatencyStats.from_samples(a), LatencyStats.from_samples(b)
    ref_a = ref_core.LatencyStats.from_samples(a)
    ref_b = ref_core.LatencyStats.from_samples(b)
    assert port_a.as_dict() == ref_a.as_dict()
    assert port_a.merge(port_b).as_dict() == ref_a.merge(ref_b).as_dict()
    assert port_b.merge(port_a).as_dict() == ref_b.merge(ref_a).as_dict()
    assert str(port_b) == str(ref_b)
    answers = [type("A", (), {"latency_s": x})() for x in b]
    assert serve_latency_stats(answers).as_dict() == ref_b.as_dict()


# ------------------------------------------------------------- CLI


def test_serve_cli_runs_on_cpu(capsys):
    """The service end to end at scale 8 on the CPU; the freshness check
    (3 refreshed entries against cold solves) passes."""
    assert serve_cli.main(["--device", "cpu", "--scale", "8",
                           "--queries", "80", "--updates", "2"]) == 0
    out = capsys.readouterr().out
    assert "q/s" in out and "latency n=" in out
    assert "3 refreshed entries verified bit-identical to cold solves" in out
