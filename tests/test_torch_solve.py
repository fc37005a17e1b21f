"""The port's facade against the JAX package's on all four tiny graphs
and every exchange mode at P=1: state and metrics bit-identical."""

import warnings

import jax
import pytest

import repro.api as ref_api
import repro.graph as ref_graph
import repro_torch.graph as tg
from repro_torch.api import Problem, SingleSource, Solver, SolverConfig

GRAPHS = [
    ("rmat1", dict(scale=8, seed=3)),
    ("rmat2", dict(scale=8, seed=5)),
    ("grid_road_graph", dict(side=12, seed=1)),
    ("small_world_graph", dict(n=300, seed=2)),
]
SPECS = ["delta:5+buffer", "kla:2+threadq", "chaotic+nodeq",
         "dijkstra+numaq", "delta:3 > device:dijkstra > chunk:topk:16"]


@pytest.fixture(scope="module")
def mesh1():
    return jax.make_mesh((1,), ("data",))


@pytest.mark.parametrize("exchange", ["a2a", "pmin", "sparse", "auto"])
@pytest.mark.parametrize("kind,kw", GRAPHS)
def test_specs_bit_identical_on_tiny_graphs(kind, kw, exchange, mesh1):
    ref_g = getattr(ref_graph, kind)(**kw)
    port_g = getattr(tg, kind)(**kw)
    source = ref_g.n // 3
    for spec in SPECS:
        full = f"{spec}/{exchange}"
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            ref = ref_api.Solver(full, mesh=mesh1).solve(
                ref_api.Problem(ref_g, ref_api.SingleSource(source)))
            impls = ("ref", "fused") if exchange in ("sparse", "auto") \
                else ("ref",)
            for impl in impls:
                cfg = SolverConfig.from_spec(full, relax_impl=impl)
                port = Solver(cfg, device="cpu").solve(
                    Problem(port_g, SingleSource(source)))
                assert port.state.tobytes() == ref.state.tobytes(), full
                assert port.metrics.as_dict() == ref.metrics.as_dict(), full
