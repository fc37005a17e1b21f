"""The processing-function registry (``api/problem.py``:
``register_processing``, ``registered_processing``,
``processing_names``) against the JAX package's: a duplicate name is
refused, ``overwrite`` replaces, names are sorted, problems and the CLI
find a registered function by name, and a renamed copy of ``sssp``
registered in both packages solves bit-identically."""

import dataclasses
import warnings

import jax
import numpy as np
import pytest

import repro.api as ref_api
import repro.api.problem as ref_problem
import repro.core.processing as ref_processing
import repro_torch.api.problem as problem
import repro_torch.graph as tg
from repro_torch.api import (
    Problem,
    SingleSource,
    Solver,
    get_processing,
    processing_names,
    register_processing,
    registered_processing,
)
from repro_torch.core import SSSP, dijkstra_reference

SPECS = ["delta:5/a2a", "delta:5+threadq/sparse", "kla:2+nodeq/pmin",
         "chaotic/auto"]


@pytest.fixture(autouse=True)
def fresh_registries(monkeypatch):
    """Each test registers into copies of both registries."""
    monkeypatch.setattr(problem, "_REGISTRY", dict(problem._REGISTRY))
    monkeypatch.setattr(ref_problem, "_REGISTRY", dict(ref_problem._REGISTRY))


@pytest.fixture(scope="module")
def mesh1():
    return jax.make_mesh((1,), ("data",))


def test_builtin_names_sorted_and_equal_to_the_reference():
    assert processing_names() == ("bfs", "cc", "sssp", "sswp")
    assert processing_names() == ref_problem.processing_names()
    assert set(registered_processing()) == set(processing_names())


def test_duplicate_refused_and_overwrite_replaces():
    copy = dataclasses.replace(SSSP, name="sssp")
    with pytest.raises(ValueError, match="already registered"):
        register_processing(copy)
    assert register_processing(SSSP) is SSSP  # the same fn again is fine
    assert register_processing(copy, overwrite=True) is copy
    assert get_processing("sssp") is copy


def test_registered_copy_is_a_snapshot_and_names_sort():
    snap = registered_processing()
    register_processing(dataclasses.replace(SSSP, name="aardvark"))
    register_processing(dataclasses.replace(SSSP, name="zebra"))
    assert "zebra" not in snap
    names = processing_names()
    assert names == tuple(sorted(names)) and names[0] == "aardvark"
    with pytest.raises(ValueError, match="unknown processing 'zebr'.*zebra"):
        get_processing("zebr")


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("gi", range(4))
def test_renamed_sssp_solves_like_the_reference(spec, gi, tiny_graphs, mesh1):
    port_fn = register_processing(dataclasses.replace(SSSP, name="sssp_copy"))
    ref_api.register_processing(
        dataclasses.replace(ref_processing.SSSP, name="sssp_copy"))
    g = tiny_graphs[gi]
    pg = tg.Graph(g.n, g.src.copy(), g.dst.copy(), g.weight.copy(), name=g.name)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        port = Solver(spec, device="cpu").solve(
            Problem(pg, SingleSource(0), processing="sssp_copy"))
        ref = ref_api.Solver(spec, mesh=mesh1).solve(
            ref_api.Problem(g, ref_api.SingleSource(0), processing="sssp_copy"))
        plain = Solver(spec, device="cpu").solve(Problem(pg, SingleSource(0)))
    assert Problem(pg, 0, processing="sssp_copy").processing_fn is port_fn
    assert port.state.tobytes() == np.asarray(ref.state, np.float32).tobytes()
    assert port.metrics.as_dict() == ref.metrics.as_dict()
    assert port.state.tobytes() == plain.state.tobytes()
    assert port.state.tobytes() == \
        dijkstra_reference(pg, 0).astype(np.float32).tobytes()


def test_cli_problem_choices_follow_the_registry(capsys):
    from repro_torch.launch import sssp

    with pytest.raises(SystemExit):
        sssp.main(["--problem", "sssp_copy", "--device", "cpu"])
    assert "invalid choice: 'sssp_copy'" in capsys.readouterr().err
    register_processing(dataclasses.replace(SSSP, name="sssp_copy"))
    assert sssp.main(["--problem", "sssp_copy", "--device", "cpu",
                      "--scale", "6", "--spec", "delta:5/a2a"]) == 0
    assert "reached=" in capsys.readouterr().out
