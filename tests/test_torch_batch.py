"""The port's batched and warm-restarted solves against the JAX
package: ``solve_batch`` lane by lane, ``resolve``, the bootstrap sweep,
and the batched plain versions of the two frontier kernels.  States and
``metrics.as_dict()`` bit-identical.

Under jax 0.9.0 the reference's ``solve_batch`` runs only its dense
exchanges (a2a, pmin): on the sparse route its vmapped scatter inside
``shard_map`` fails with a ``vma`` error, as its ``/fused`` and
``relax_impl="pallas"`` solves do.  A vmapped lane makes every decision
on its own data and freezes once converged, so it is the single solve of
its problem; the port's sparse lanes are held against the reference's
single solves with ``relax_impl="ref"`` (bit-identical to its kernels by
construction), and the dense tests check that the reference's own lanes
equal its single solves."""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as ref_api
import repro.graph as ref_graph
import repro_torch.api as api
import repro_torch.graph as tg
from repro.api.solver import _bootstrap_candidates as ref_bootstrap
from repro.core.processing import PROCESSING_FNS as REF_FNS
from repro.kernels.relax_push import relax_push_gather as ref_push_gather
from repro.kernels.relax_push import relax_push_rows as ref_push_rows
from repro.kernels.superstep_fused import fused_superstep as ref_fused
from repro.kernels.superstep_fused import fused_superstep_ref as ref_fused_ref
from repro_torch.api import Problem, SingleSource, Solver, SolverConfig
from repro_torch.api.solver import _bootstrap_candidates
from repro_torch.core import dijkstra_reference
from repro_torch.core.processing import PROCESSING_FNS
from repro_torch.kernels import (
    fused_superstep,
    fused_superstep_batch,
    fused_superstep_batch_cuda,
    relax_push_gather,
    relax_push_gather_batch,
    relax_push_gather_batch_cuda,
    relax_push_rows,
    relax_push_rows_batch,
)

SOURCES = [0, 5, 17, 90, 200]


@pytest.fixture(scope="module")
def mesh1():
    return jax.make_mesh((1,), ("data",))


def port_graph(g):
    """The port's Graph over a copy of a reference graph's arrays."""
    return tg.Graph(g.n, g.src.copy(), g.dst.copy(), g.weight.copy(),
                    name=g.name)


def quiet(fn, *args, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return fn(*args, **kw)


def same_solution(port, ref, what):
    assert port.state.tobytes() == ref.state.tobytes(), what
    assert port.metrics.as_dict() == ref.metrics.as_dict(), what


def test_batch_bucket_rounding():
    assert [api.batch_bucket(b) for b in (1, 2, 3, 4, 5, 8, 9)] == \
        [ref_api.batch_bucket(b) for b in (1, 2, 3, 4, 5, 8, 9)] == \
        [1, 2, 4, 4, 8, 8, 16]
    with pytest.raises(ValueError):
        api.batch_bucket(0)


# dense exchanges: the reference's own solve_batch is the authority
@pytest.mark.parametrize("spec,processing", [
    ("delta:5/a2a", "sssp"),
    ("delta:5/pmin", "sssp"),
    ("kla:2+threadq/a2a", "sssp"),       # KLA levels + a threadq drain
    ("delta:5+threadq/a2a", "sswp"),     # max-reduce processing
])
@pytest.mark.parametrize("B", [2, 3, 5])
def test_solve_batch_dense_matches_reference_batch(tiny_graphs, mesh1, spec,
                                                   processing, B):
    g = tiny_graphs[0]
    pg = port_graph(g)
    srcs = SOURCES[:B]
    rsolver = ref_api.Solver(spec, mesh=mesh1)
    ref = quiet(rsolver.solve_batch, [
        ref_api.Problem(g, ref_api.SingleSource(v), processing=processing)
        for v in srcs])
    psolver = Solver(spec, device="cpu")
    port = quiet(psolver.solve_batch, [
        Problem(pg, SingleSource(v), processing=processing) for v in srcs])
    assert len(port) == B
    for v, p, r in zip(srcs, port, ref):
        same_solution(p, r, (spec, v))
        single_ref = quiet(rsolver.solve, ref_api.Problem(
            g, ref_api.SingleSource(v), processing=processing))
        same_solution(p, single_ref, (spec, v, "reference single"))
        single = quiet(psolver.solve,
                       Problem(pg, SingleSource(v), processing=processing))
        same_solution(p, single, (spec, v, "port single"))


# sparse exchanges with each relax route: the reference's single solves
@pytest.mark.parametrize("spec,impl,processing", [
    ("delta:5/sparse", "ref", "sssp"),
    ("delta:5/sparse", "fused", "sssp"),
    ("delta:5/sparse", "push", "sssp"),
    ("delta:5+threadq/sparse", "fused", "bfs"),
    ("kla:2+threadq/sparse", "fused", "sssp"),  # levels: kernels stay 'ref'
    ("delta:3+numaq/auto", "push", "sssp"),
])
@pytest.mark.parametrize("B", [2, 3, 5])
def test_solve_batch_sparse_matches_reference_lanes(tiny_graphs, mesh1, spec,
                                                    impl, processing, B):
    g = tiny_graphs[1]
    pg = port_graph(g)
    srcs = SOURCES[:B]
    port = quiet(Solver(SolverConfig.from_spec(spec, relax_impl=impl),
                        device="cpu").solve_batch,
                 [Problem(pg, SingleSource(v), processing=processing)
                  for v in srcs])
    rsolver = ref_api.Solver(spec, mesh=mesh1)
    psingle = Solver(SolverConfig.from_spec(spec, relax_impl=impl),
                     device="cpu")
    for v, p in zip(srcs, port):
        ref = quiet(rsolver.solve, ref_api.Problem(
            g, ref_api.SingleSource(v), processing=processing))
        same_solution(p, ref, (spec, impl, v))
        same_solution(p, quiet(psingle.solve, Problem(
            pg, SingleSource(v), processing=processing)), (spec, impl, v))


def test_solve_batch_decides_per_lane(tiny_graphs, mesh1):
    """A lane that overflows its frontier cap (a hub source) beside a lane
    that never does (a source with no out-edges, converged after one
    superstep): each lane's sparse_fallbacks, overflow_streak and
    supersteps are its own, as in the reference."""
    g = tiny_graphs[0]
    pg = port_graph(g)
    deg = np.bincount(g.src, minlength=g.n)
    hub, leaf = int(np.argmax(deg)), int(np.flatnonzero(deg == 0)[0])
    cfg = SolverConfig.from_spec("delta:5/sparse/fused", frontier_cap=4)
    port = quiet(Solver(cfg, device="cpu").solve_batch,
                 [Problem(pg, SingleSource(v)) for v in (hub, leaf, 3)])
    rsolver = ref_api.Solver(ref_api.SolverConfig.from_spec(
        "delta:5/sparse", frontier_cap=4), mesh=mesh1)
    for v, p in zip((hub, leaf, 3), port):
        same_solution(p, quiet(rsolver.solve, ref_api.Problem(
            g, ref_api.SingleSource(v))), v)
    hub_m, leaf_m = port[0].metrics, port[1].metrics
    assert hub_m.sparse_fallbacks > 0 and hub_m.overflow_streak > 0
    assert leaf_m.sparse_fallbacks == 0 and leaf_m.overflow_streak == 0
    assert leaf_m.supersteps == 1 < hub_m.supersteps


def test_solve_batch_lanes_converge_on_their_own(tiny_graphs, mesh1):
    """Dense exchange, the reference's batch itself: a lane that converges
    many supersteps before the other keeps its own supersteps and
    classes."""
    g = tiny_graphs[0]
    pg = port_graph(g)
    deg = np.bincount(g.src, minlength=g.n)
    leaf = int(np.flatnonzero(deg == 0)[0])
    ref = quiet(ref_api.Solver("delta:5/a2a", mesh=mesh1).solve_batch,
                [ref_api.Problem(g, ref_api.SingleSource(v)) for v in (0, leaf)])
    port = quiet(Solver("delta:5/a2a", device="cpu").solve_batch,
                 [Problem(pg, SingleSource(v)) for v in (0, leaf)])
    for p, r in zip(port, ref):
        same_solution(p, r, "lanes")
    assert port[1].metrics.supersteps == 1 < port[0].metrics.supersteps


def test_solve_batch_at_two_ranks_reaches_the_fixpoint(tiny_graphs):
    """P = 2 lanes: the same states as the port's single solves and the
    Dijkstra oracle (the reference runs P > 1 only in subprocesses)."""
    pg = port_graph(tiny_graphs[1])
    for spec in ("delta:5/sparse/fused", "delta:5/a2a", "kla:2+threadq/pmin"):
        solver = Solver(spec, n_parts=2, device="cpu")
        port = quiet(solver.solve_batch,
                     [Problem(pg, SingleSource(v)) for v in SOURCES[:3]])
        for v, p in zip(SOURCES[:3], port):
            same_solution(p, quiet(solver.solve, Problem(pg, SingleSource(v))),
                          (spec, v))
            assert p.state.tobytes() == \
                dijkstra_reference(pg, v).astype(np.float32).tobytes()


def test_solve_batch_refusals_match_reference(tiny_graphs, mesh1):
    g = tiny_graphs[0]
    pg = port_graph(g)
    for spec in ("delta:5/a2a/adapt", "delta:5/sparse/q:bf16",
                 "delta:5/a2a/trace"):
        with pytest.raises(ValueError) as ref_err:
            ref_api.Solver(spec, mesh=mesh1).solve_batch(
                [ref_api.Problem(g, ref_api.SingleSource(v)) for v in (0, 1)])
        with pytest.raises(ValueError) as port_err:
            Solver(spec, device="cpu").solve_batch(
                [Problem(pg, SingleSource(v)) for v in (0, 1)])
        assert str(port_err.value) == str(ref_err.value)
    solver = Solver("delta:5/a2a", device="cpu")
    with pytest.raises(ValueError, match="share a graph"):
        solver.solve_batch([Problem(pg, SingleSource(0)),
                            Problem(port_graph(g), SingleSource(1))])
    with pytest.raises(ValueError, match="processing fn"):
        solver.solve_batch([Problem(pg, SingleSource(0)),
                            Problem(pg, SingleSource(1), processing="bfs")])
    assert solver.solve_batch([]) == []


# ------------------------------------------------------------- resolve


@pytest.mark.parametrize("spec", ["delta:5+threadq/a2a", "kla:2+threadq/sparse",
                                  "delta:5/sparse/fused", "delta:5/sparse"])
def test_resolve_matches_reference(spec, mesh1):
    """After a weight drop, after an edge insertion, and with new sources
    (MultiSource): state and metrics bit-identical to the reference's
    resolve (its engine with relax_impl 'ref')."""
    g = ref_graph.rmat1(8, seed=3)
    pg = port_graph(g)
    rs = ref_api.Solver(spec.replace("/fused", ""), mesh=mesh1)
    impl = "push" if spec == "delta:5/sparse" else None
    ps = Solver(SolverConfig.from_spec(spec, **({"relax_impl": impl} if impl else {})),
                device="cpu")
    r = quiet(rs.solve, ref_api.Problem(g, ref_api.SingleSource(0)))
    p = quiet(ps.solve, Problem(pg, SingleSource(0)))
    same_solution(p, r, "cold")
    for G in (g, pg):  # an improving weight drop
        G.weight[17] *= np.float32(0.25)
    r = quiet(rs.resolve, r, graph=g)
    p = quiet(ps.resolve, p, graph=pg)
    same_solution(p, r, "weight drop")
    for G in (g, pg):  # an insertion
        G.src = np.append(G.src, np.int32(0))
        G.dst = np.append(G.dst, np.int32(200))
        G.weight = np.append(G.weight, np.float32(0.75))
    r = quiet(rs.resolve, r, graph=g)
    p = quiet(ps.resolve, p, graph=pg)
    same_solution(p, r, "insertion")
    r = quiet(rs.resolve, r, new_sources=ref_api.MultiSource((5, 90)))
    p = quiet(ps.resolve, p, new_sources=api.MultiSource((5, 90)))
    same_solution(p, r, "new sources")
    assert p.problem.sources == api.MultiSource((5, 90))
    cold = quiet(ps.solve, Problem(pg, api.MultiSource((0, 5, 90))))
    assert p.state.tobytes() == cold.state.tobytes()


def test_resolve_unperturbed_and_explicit_sources(mesh1):
    g = ref_graph.rmat2(8, seed=5)
    pg = port_graph(g)
    rs = ref_api.Solver("delta:5/a2a", mesh=mesh1)
    ps = Solver("delta:5/sparse/fused", device="cpu")
    r = quiet(rs.solve, ref_api.Problem(g, ref_api.SingleSource(3)))
    p = quiet(ps.solve, Problem(pg, SingleSource(3)))
    r2 = quiet(rs.resolve, r)
    p2 = quiet(ps.resolve, p)
    assert p2.state.tobytes() == r2.state.tobytes()
    assert p2.metrics.supersteps == r2.metrics.supersteps == 2
    r3 = quiet(rs.resolve, r, new_sources=[(7, 1.5, 0)])
    p3 = quiet(ps.resolve, p, new_sources=[(7, 1.5, 0)])
    assert p3.state.tobytes() == r3.state.tobytes()
    assert isinstance(p3.problem.sources, api.ExplicitSources)


def test_resolve_layout_change_raises_as_reference(mesh1):
    """A partition whose vertex-to-slot map differs (an ebal boundary that
    moved) refuses a warm start, with the reference's message."""
    g = ref_graph.rmat1(8, seed=3)
    pg = port_graph(g)
    rs = ref_api.Solver("delta:5/a2a@ebal", mesh=mesh1)
    ps = Solver("delta:5/a2a@ebal", device="cpu")
    r = quiet(rs.solve, ref_api.Problem(g, ref_api.SingleSource(0)))
    p = quiet(ps.solve, Problem(pg, SingleSource(0)))
    moved = np.roll(np.arange(g.n), 1)
    r_pg = dataclasses.replace(rs.partition(g), perm=moved)
    p_pg = dataclasses.replace(ps.partition(pg), perm=moved)
    assert not p.pg.same_layout(p_pg) and p.pg.same_layout(ps.partition(pg))
    with pytest.raises(ValueError) as ref_err:
        rs.resolve(r, graph=r_pg)
    with pytest.raises(ValueError) as port_err:
        ps.resolve(p, graph=p_pg)
    assert str(port_err.value) == str(ref_err.value)
    assert "layout changed" in str(port_err.value)


@pytest.mark.parametrize("processing", ["sssp", "sswp", "cc", "bfs"])
@pytest.mark.parametrize("n_parts", [1, 2])
def test_bootstrap_candidates_match_reference(processing, n_parts):
    """The torch sweep (scatter over the resident ELL) against the
    reference's numpy ``minimum.at`` / ``maximum.at``, bit for bit."""
    g = ref_graph.small_world_graph(300, seed=2)
    r_pg = ref_graph.partition_graph(g, n_parts, partitioner="shuffle:1")
    p_pg = tg.partition_graph(port_graph(g), n_parts, partitioner="shuffle:1")
    rng = np.random.default_rng(n_parts)
    committed = rng.uniform(0, 40, (n_parts, p_pg.n_local)).astype(np.float32)
    committed[rng.random(committed.shape) < 0.2] = \
        np.float32(PROCESSING_FNS[processing].worst)
    ref = ref_bootstrap(r_pg, REF_FNS[processing], committed)
    port = _bootstrap_candidates(p_pg.to("cpu"), p_pg.n_local,
                                 PROCESSING_FNS[processing],
                                 torch.as_tensor(committed))
    assert port.numpy().tobytes() == np.asarray(ref, np.float32).tobytes()


# ----------------------------------------- batched plain kernel versions


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def lane_case(seed, S, P, n_local, R, W, F, counts):
    """S lanes over a P-rank ELL with non-integer weights; lane s lists
    counts[s] rows, filled past its count with the sentinel R."""
    r = np.random.default_rng(seed)
    n_out = P * n_local
    dist = np.full((S, n_local + 1), np.inf, np.float32)
    hot = r.random((S, n_local)) < 0.5
    dist[:, :n_local][hot] = r.uniform(0, 40, int(hot.sum())).astype(np.float32)
    row_src = r.integers(0, n_local, (P, R)).astype(np.int32)
    col = r.integers(0, n_out + 1, (P, R, W)).astype(np.int32)
    wgt = np.where(col == n_out, np.inf,
                   r.uniform(0.1, 9.9, (P, R, W))).astype(np.float32)
    row_idx = np.full((S, F), R, np.int32)
    for s, k in enumerate(counts):
        row_idx[s, :k] = r.choice(R, k, replace=False)
    return dist, row_idx, np.asarray(counts, np.int32), row_src, col, wgt, n_out


LANE_CASES = [
    # seed, S, P, n_local, R, W, F, counts (0 and F among them)
    (0, 3, 1, 64, 50, 8, 12, [0, 12, 5]),
    (1, 4, 2, 40, 30, 4, 10, [10, 0, 3, 7]),
    (2, 8, 2, 100, 80, 5, 16, [16, 1, 0, 9, 16, 4, 11, 2]),
    (3, 2, 2, 32, 24, 33, 8, [8, 0]),
    (4, 6, 3, 50, 40, 16, 20, [20, 7, 0, 13, 1, 20]),
]


@pytest.mark.parametrize("case", LANE_CASES)
def test_batched_plain_versions_match_reference_lanes(case):
    """fused_superstep_batch, relax_push_gather_batch and
    relax_push_rows_batch (the plain versions a CPU tensor takes) against
    the reference's per-lane oracles and Pallas kernels (interpret mode)
    and against the port's single-lane plain versions, lane by lane."""
    dist, row_idx, counts, row_src, col, wgt, n_out = lane_case(*case)
    S, P = dist.shape[0], col.shape[0]
    args = (t(dist), t(row_idx), t(counts), t(row_src), t(col), t(wgt))
    fused = fused_superstep_batch(*args, n_out).numpy()
    gather = relax_push_gather_batch(*args).numpy()
    rows = relax_push_rows_batch(*args, n_out).numpy()
    assert fused.shape == rows.shape == (S, n_out + 1)
    assert gather.shape == (S, row_idx.shape[1], col.shape[2])
    for s in range(S):
        q, k = s % P, int(counts[s])
        lane = [jnp.asarray(a) for a in (dist[s], row_idx[s], row_src[q],
                                          col[q], wgt[q])]
        oracle = np.asarray(ref_fused_ref(*lane, n_out))
        pallas = np.asarray(ref_fused(lane[0], lane[1], jnp.int32(k), *lane[2:],
                                      n_out, interpret=True))
        assert fused[s].tobytes() == oracle.tobytes() == pallas.tobytes(), s
        push = np.asarray(ref_push_gather(lane[0], lane[1], jnp.int32(k),
                                          *lane[2:], interpret=True))
        assert gather[s].tobytes() == push.tobytes(), s
        push_rows = np.asarray(ref_push_rows(*lane, n_out, impl="ref"))
        assert rows[s, :n_out].tobytes() == push_rows.tobytes(), s
        single = (t(dist[s]), t(row_idx[s]), k, t(row_src[q]), t(col[q]),
                  t(wgt[q]))
        assert fused[s].tobytes() == \
            fused_superstep(*single, n_out).numpy().tobytes()
        assert gather[s].tobytes() == relax_push_gather(*single).numpy().tobytes()
        assert rows[s].tobytes() == \
            relax_push_rows(*single, n_out).numpy().tobytes()


def test_batched_plain_versions_mask_real_rows_past_count():
    """Rows listed past a lane's count point at real rows yet contribute
    nothing; each lane reads its own rank."""
    dist, row_idx, counts, row_src, col, wgt, n_out = lane_case(
        7, 4, 2, 30, 20, 4, 6, [2, 0, 6, 3])
    row_idx = np.random.default_rng(0).integers(0, 20, row_idx.shape).astype(np.int32)
    args = (t(dist), t(row_idx), t(counts), t(row_src), t(col), t(wgt))
    fused = fused_superstep_batch(*args, n_out)
    gather = relax_push_gather_batch(*args)
    for s in range(4):
        q, k = s % 2, int(counts[s])
        single = (t(dist[s]), t(row_idx[s]), k, t(row_src[q]), t(col[q]),
                  t(wgt[q]))
        assert torch.equal(fused[s], fused_superstep(*single, n_out))
        assert torch.equal(gather[s], relax_push_gather(*single))
        assert bool(torch.isinf(gather[s, k:]).all())


def test_batched_cuda_wrappers_refuse_cpu_tensors():
    dist, row_idx, counts, row_src, col, wgt, n_out = lane_case(*LANE_CASES[1])
    args = (t(dist), t(row_idx), t(counts), t(row_src), t(col), t(wgt))
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_superstep_batch_cuda(*args, n_out)
    with pytest.raises(ValueError, match="CUDA tensor"):
        relax_push_gather_batch_cuda(*args)
