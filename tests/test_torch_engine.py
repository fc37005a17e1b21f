"""The port's engine against the JAX package's at P=1 over the paper's
variant grid: final state and ``WorkMetrics.as_dict()`` bit-identical.
The port's kernel paths (``/fused`` and ``relax_impl="push"``) are held
against the reference's plain sparse engine (``relax_impl="ref"``),
which the reference's fused kernel equals by construction."""

import warnings

import jax
import numpy as np
import pytest

import repro.api as ref_api
import repro.graph as ref_graph
import repro_torch.graph as tg
from repro.core import paper_variant_specs
from repro_torch.api import Problem, SingleSource, Solver


@pytest.fixture(scope="module")
def mesh1():
    return jax.make_mesh((1,), ("data",))


@pytest.fixture(scope="module")
def graphs():
    return ref_graph.rmat1(8, seed=3), tg.rmat1(8, seed=3)


def ref_solve(spec, g, mesh, source=0):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return ref_api.Solver(spec, mesh=mesh).solve(
            ref_api.Problem(g, ref_api.SingleSource(source)))


def port_solve(spec, g, source=0, **overrides):
    from repro_torch.api import SolverConfig

    cfg = SolverConfig.from_spec(spec, **overrides)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return Solver(cfg, device="cpu").solve(Problem(g, SingleSource(source)))


def assert_same(port, ref):
    assert port.state.dtype == ref.state.dtype
    assert port.state.tobytes() == ref.state.tobytes()
    assert port.metrics.as_dict() == ref.metrics.as_dict()


@pytest.mark.parametrize("spec", paper_variant_specs())
def test_paper_grid_bit_identical(spec, graphs, mesh1):
    ref_g, port_g = graphs
    for exchange in ("a2a", "sparse"):
        ref = ref_solve(f"{spec}/{exchange}", ref_g, mesh1)
        assert_same(port_solve(f"{spec}/{exchange}", port_g), ref)
        if exchange == "sparse":
            assert_same(port_solve(f"{spec}/sparse/fused", port_g), ref)
            assert_same(port_solve(f"{spec}/sparse", port_g,
                                   relax_impl="push"), ref)


@pytest.mark.parametrize("frontier_cap", [1, 4, 16, 1000])
def test_frontier_caps_and_overflow_fallbacks(frontier_cap, graphs, mesh1):
    """Small caps force row and slot overflow: the dense fallback count
    and overflow streak must follow the reference superstep by
    superstep."""
    ref_g, port_g = graphs
    for spec in ("delta:5/sparse", "dijkstra+threadq/auto", "kla:2/sparse"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            ref = ref_api.Solver(
                ref_api.SolverConfig.from_spec(spec, frontier_cap=frontier_cap),
                mesh=mesh1,
            ).solve(ref_api.Problem(ref_g, ref_api.SingleSource(0)))
        for impl in ("ref", "push", "fused"):
            port = port_solve(spec, port_g, frontier_cap=frontier_cap,
                              relax_impl=impl)
            assert_same(port, ref)


def test_max_iters_truncation_matches(graphs, mesh1):
    ref_g, port_g = graphs
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        ref = ref_api.Solver(
            ref_api.SolverConfig.from_spec("delta:5/sparse", max_iters=5),
            mesh=mesh1,
        ).solve(ref_api.Problem(ref_g, ref_api.SingleSource(0)))
    with pytest.warns(RuntimeWarning, match="max_iters=5"):
        from repro_torch.api import SolverConfig

        port = Solver(SolverConfig.from_spec("delta:5/sparse", max_iters=5),
                      device="cpu").solve(Problem(port_g, SingleSource(0)))
    assert not port.metrics.converged
    assert_same(port, ref)
    assert np.isinf(port.state).sum() > 0
