"""The port at P > 1 ranks, the other processing functions, and the
self-stabilizing sweep.

The JAX package runs P > 1 only in multi-device subprocesses (which do
not run on this tree), so the port's P ∈ {2, 4} states are held against
the P=1 reference state and the Dijkstra oracle: the least fixpoint is
unique, so every rank count must reach the same state."""

import warnings

import jax
import numpy as np
import pytest

import repro.api as ref_api
import repro.graph as ref_graph
import repro_torch.graph as tg
from repro.core.selfstab import synchronous_sweep as ref_sweep
from repro_torch.api import EveryVertex, Problem, Solver
from repro_torch.core import dijkstra_reference
from repro_torch.core.selfstab import synchronous_sweep

GRAPHS = [
    ("rmat1", dict(scale=8, seed=3)),
    ("rmat2", dict(scale=8, seed=5)),
    ("grid_road_graph", dict(side=12, seed=1)),
    ("small_world_graph", dict(n=300, seed=2)),
]


@pytest.fixture(scope="module")
def mesh1():
    return jax.make_mesh((1,), ("data",))


def port_solve(spec, g, sources=0, processing="sssp", n_parts=1):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return Solver(spec, n_parts=n_parts, device="cpu").solve(
            Problem(g, sources, processing=processing))


def ref_solve(spec, g, mesh, sources, processing="sssp"):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return ref_api.Solver(spec, mesh=mesh).solve(
            ref_api.Problem(g, sources, processing=processing))


@pytest.mark.parametrize("n_parts", [2, 4])
@pytest.mark.parametrize("kind,kw", GRAPHS)
def test_ranks_reach_the_reference_fixpoint(kind, kw, n_parts, mesh1):
    ref_g = getattr(ref_graph, kind)(**kw)
    port_g = getattr(tg, kind)(**kw)
    ref = ref_solve("delta:5/a2a", ref_g, mesh1, ref_api.SingleSource(0))
    oracle = dijkstra_reference(port_g, 0).astype(np.float32)
    assert ref.state.tobytes() == oracle.tobytes()
    for spec in ("delta:5/a2a", "kla:2+threadq/pmin", "chaotic+nodeq/sparse",
                 "delta:3+numaq/auto", "dijkstra/sparse/fused",
                 "delta:5/sparse@ebal", "delta:7+threadq/sparse@shuffle:3"):
        port = port_solve(spec, port_g, n_parts=n_parts)
        assert port.state.tobytes() == ref.state.tobytes(), spec
        assert port.metrics.converged
        assert port.metrics.exchange_bytes > 0


def test_ranks_exchange_bytes_follow_the_word_model():
    """P=2 a2a moves (P-1)·n_local words per rank per superstep, pmin
    twice that."""
    g = tg.rmat1(8, seed=3)
    a2a = port_solve("delta:5/a2a", g, n_parts=2)
    pmin = port_solve("delta:5/pmin", g, n_parts=2)
    n_local = a2a.pg.n_local
    assert a2a.metrics.exchange_bytes == \
        a2a.metrics.supersteps * n_local * 4 * 2
    assert pmin.metrics.exchange_bytes == \
        2 * pmin.metrics.supersteps * n_local * 4 * 2


@pytest.mark.parametrize("processing,sources", [
    ("bfs", 0), ("sswp", 0), ("cc", EveryVertex()),
])
@pytest.mark.parametrize("exchange", ["a2a", "sparse"])
def test_other_processings_bit_identical(processing, sources, exchange, mesh1):
    ref_g, port_g = ref_graph.rmat2(8, seed=5), tg.rmat2(8, seed=5)
    ref_src = ref_api.EveryVertex() if isinstance(sources, EveryVertex) \
        else ref_api.SingleSource(sources)
    for spec in ("delta:5", "kla:2+threadq"):
        ref = ref_solve(f"{spec}/{exchange}", ref_g, mesh1, ref_src,
                        processing)
        port = port_solve(f"{spec}/{exchange}", port_g, sources, processing)
        assert port.state.tobytes() == ref.state.tobytes()
        assert port.metrics.as_dict() == ref.metrics.as_dict()
        two = port_solve(f"{spec}/{exchange}", port_g, sources, processing,
                         n_parts=2)
        assert two.state.tobytes() == ref.state.tobytes()


@pytest.mark.parametrize("kind,kw", GRAPHS[:2])
def test_selfstab_sweep_from_standard_init(kind, kw):
    ref_g = getattr(ref_graph, kind)(**kw)
    port_g = getattr(tg, kind)(**kw)
    d0 = np.full(port_g.n, np.inf, np.float32)
    port = synchronous_sweep(port_g, 0, d0, 3 * port_g.n, device="cpu")
    ref = ref_sweep(ref_g, 0, d0, iters=3 * ref_g.n)
    assert port.tobytes() == np.asarray(ref).tobytes()
    assert port.tobytes() == \
        dijkstra_reference(port_g, 0).astype(np.float32).tobytes()


def test_selfstab_sweep_from_corrupted_state():
    """The self-stabilization property: from an arbitrary corrupted
    state (R1 may raise distances) the sweep reaches the fixpoint."""
    ref_g, port_g = ref_graph.small_world_graph(300, seed=2), \
        tg.small_world_graph(300, seed=2)
    d0 = np.random.default_rng(0).uniform(0, 50, port_g.n).astype(np.float32)
    port = synchronous_sweep(port_g, 0, d0, 400, device="cpu")
    ref = ref_sweep(ref_g, 0, d0, iters=400)
    assert port.tobytes() == np.asarray(ref).tobytes()
    oracle = dijkstra_reference(port_g, 0)
    assert np.allclose(port, oracle)
