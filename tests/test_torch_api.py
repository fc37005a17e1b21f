"""The port's spec grammar, ordering keys and entry points against the
JAX package: ``config.name`` identical for every spec, class keys
bit-identical, and no silent fallback off the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import SolverConfig as RefConfig
from repro.core import make_ordering as ref_make_ordering
from repro.core import paper_variant_specs as ref_paper_specs
from repro.launch.sssp import EXAMPLE_HIERARCHIES
from repro_torch.api import Problem, SingleSource, Solver, SolverConfig
from repro_torch.core import dijkstra_reference, make_ordering, paper_variant_specs
from repro_torch.graph import rmat1

SEGMENTS = ["", "/a2a", "/pmin", "/sparse", "/auto", "/sparse/fused",
            "/fused/auto", "/sparse/q", "/sparse/q:u16", "/adapt",
            "/sparse/adapt:static", "/adapt:rho:0.25/sparse", "/trace",
            "/sparse/trace@ebal", "@shuffle", "/pmin@degree"]


def test_paper_grid_is_the_reference_grid():
    assert paper_variant_specs() == ref_paper_specs()
    assert len(paper_variant_specs()) == 29


@pytest.mark.parametrize("seg", SEGMENTS)
def test_config_name_matches_reference(seg):
    specs = paper_variant_specs() + EXAMPLE_HIERARCHIES + [
        "delta:5 > chunk:topk:64", "global:dijkstra > device:delta:2",
        "chaotic+threadq", "delta:2.5+numaq",
    ]
    for spec in specs:
        port = SolverConfig.from_spec(spec + seg)
        ref = RefConfig.from_spec(spec + seg)
        assert port.name == ref.name, spec + seg
        assert SolverConfig.from_spec(port.name) == port
        assert port.hierarchy.spec == ref.hierarchy.spec


def test_relax_impl_push_is_not_part_of_the_name():
    a = SolverConfig.from_spec("delta:5/sparse", relax_impl="push")
    assert a.name == "delta:5+buffer/sparse" and a.relax_impl == "push"


@pytest.mark.parametrize("bad", [
    "", "delta:5/", "delta:5/sprase", "delta:5//a2a", "delta:5/a2a/pmin",
    "delta:5/fused/fused", "delta:5/fused:1", "delta:5/q:", "delta:5/adapt:",
    "delta:5/adapt:nope", "delta:5/q/adapt", "delta:5/q/trace", "@ebal",
    "delta:5@", "delta:5+", "foo:3", "delta:5 > global:dijkstra",
    "delta:5 > pod:topk:8", "delta:5@shuffle:x",
])
def test_malformed_specs_raise_like_reference(bad):
    with pytest.raises(ValueError):
        RefConfig.from_spec(bad)
    with pytest.raises(ValueError):
        SolverConfig.from_spec(bad)


@pytest.mark.parametrize("spec", [
    "chaotic", "dijkstra", "delta:3", "delta:5", "delta:7", "delta:0.3",
    "kla:1", "kla:2", "kla:3", "topk:8:delta:2.5",
])
def test_class_key_bit_identical(spec):
    rng = np.random.default_rng(len(spec))
    dist = np.concatenate([
        rng.uniform(0, 500, 4000), rng.integers(0, 300, 4000),
        np.arange(0, 60, 0.1), [np.inf, 0.0],
    ]).astype(np.float32)
    level = rng.integers(0, 40, dist.shape[0]).astype(np.float32)
    ref = np.asarray(ref_make_ordering(spec).class_key(
        jnp.asarray(dist), jnp.asarray(level)))
    port = make_ordering(spec).class_key(
        torch.from_numpy(dist), torch.from_numpy(level)).numpy()
    assert ref.dtype == port.dtype and ref.tobytes() == port.tobytes()


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Solver("delta:5/sparse/fused")
    from repro_torch.core.selfstab import synchronous_sweep

    g = rmat1(6, seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        synchronous_sweep(g, 0, np.full(g.n, np.inf, np.float32), 3)


@pytest.mark.parametrize("spec,what", [
    ("delta:5/sparse/q", "quantized"),
    ("delta:5/adapt", "adaptive"),
    ("delta:5/sparse/trace", "adaptive"),
])
def test_unported_modes_raise_on_solve(spec, what):
    """The quantized, adaptive and traced modes, which the port refused
    before it had them, now solve to the fixpoint (their parity with the
    JAX package: tests/test_torch_{quant,tune,recorder}.py)."""
    g = rmat1(6, seed=0)
    solver = Solver(spec, device="cpu")
    sol = solver.solve(Problem(g, SingleSource(0)))
    assert sol.metrics.converged
    assert np.array_equal(sol.state, dijkstra_reference(g, 0))
    assert (sol.trace is not None) == solver.config.trace
    if what == "quantized":
        assert solver.config.payload == "bf16"
    else:  # the segment engine, under a policy or for the recorder
        assert solver.stats()["adapt"]["solves"] == int(
            solver.config.adapt is not None)


def test_partition_mismatch_raises():
    from repro_torch.graph import partition_graph

    g = rmat1(6, seed=0)
    with pytest.raises(ValueError, match="ranks"):
        Solver("delta:5", n_parts=2, device="cpu").solve(
            Problem(partition_graph(g, 1), SingleSource(0)))
    with pytest.raises(ValueError, match="pre-partitioned"):
        Solver("delta:5@ebal", device="cpu").solve(
            Problem(partition_graph(g, 1), SingleSource(0)))


def test_cli_solves_verifies_and_profiles_on_cpu(capsys):
    from repro_torch.launch.sssp import main

    assert main(["--scale", "8", "--seed", "3", "--spec", "kla:2+threadq/sparse",
                 "--device", "cpu", "--verify", "--profile"]) == 0
    out = capsys.readouterr().out
    assert "verify vs Dijkstra: OK" in out and "[profile]" in out
    assert "spec=kla:2+threadq/sparse device=cpu" in out
