"""The port's logical AGM (``repro_torch.core.agm``) against the JAX
package's ``repro.core.run_logical`` on ``tiny_graphs``: states and
``WorkMetrics`` equal for the SSSP AGM under every ordering kind and for
BFS, CC and SSWP AGMs; the reference's faults (SSWP keyed on the
ascending scale) raise the same exception types.  Also the API's small
names: ``ordering_kinds``, ``paper_variant_grid``, ``sssp_sources`` /
``cc_sources``, ``load_stats`` / ``describe``, the one-shot ``solve``,
and the SSSP CLI's ``--list-variants`` and spec composition."""

import warnings

import numpy as np
import pytest

import repro.core as ref_core
import repro.graph as ref_graph
import repro_torch.core as core
import repro_torch.graph as tg
from repro.launch.sssp import list_variants_lines as ref_list_variants_lines
from repro_torch import api
from repro_torch.launch import sssp as cli

ORDERINGS = ["chaotic", "dijkstra", "delta:5", "delta:20", "kla:1", "kla:2"]
# the SSWP orderings the reference runs; it raises under the others
SSWP_RUNS = ["chaotic", "kla:1", "kla:2"]
SSWP_RAISES = ["dijkstra", "delta:5", "delta:20"]
GRAPH_IDS = ["rmat1", "rmat2", "road", "smallworld"]


def port_graph(g):
    return tg.Graph(g.n, g.src.copy(), g.dst.copy(), g.weight.copy(), name=g.name)


def items_for(proc, n):
    """The natural initial workitem set of each processing function."""
    if proc == "cc":
        return core.cc_sources(n)
    if proc == "sswp":
        return [(0, float("inf"), 0)]
    return core.sssp_sources(0)


def assert_same_run(got, want):
    (s1, m1), (s2, m2) = got, want
    assert s1.dtype == s2.dtype == np.float64
    assert s1.tobytes() == s2.tobytes()
    assert m1.as_dict() == m2.as_dict()


@pytest.mark.parametrize("gi", range(4), ids=GRAPH_IDS)
@pytest.mark.parametrize("spec", ORDERINGS)
def test_sssp_agm_equals_the_reference(tiny_graphs, spec, gi):
    g = tiny_graphs[gi]
    want = ref_core.run_logical(ref_core.sssp_agm(g, 0, ref_core.make_ordering(spec)))
    got = core.run_logical(core.sssp_agm(port_graph(g), 0, core.make_ordering(spec)))
    assert_same_run(got, want)
    truth = core.dijkstra_reference(port_graph(g), 0)
    assert np.allclose(np.where(np.isinf(got[0]), -1, got[0]),
                       np.where(np.isinf(truth), -1, truth))


@pytest.mark.parametrize(
    "proc,spec",
    [("bfs", s) for s in ORDERINGS] + [("cc", s) for s in ORDERINGS]
    + [("sswp", s) for s in SSWP_RUNS])
def test_agm_equals_the_reference(tiny_graphs, proc, spec):
    """``AGM(g, p, ordering, items).run()`` for BFS, CC and SSWP."""
    from repro.core.processing import PROCESSING_FNS as REF_FNS

    for g in tiny_graphs:
        items = items_for(proc, g.n)
        want = ref_core.AGM(g, REF_FNS[proc], ref_core.make_ordering(spec),
                            items).run()
        got = core.AGM(port_graph(g), core.processing.PROCESSING_FNS[proc],
                       core.make_ordering(spec), items).run()
        assert_same_run(got, want)


@pytest.mark.parametrize("spec", SSWP_RAISES)
def test_sswp_raises_where_the_reference_raises(tiny_graphs, spec):
    """A max-processing keyed on the ascending scale: the invariant's
    AssertionError under dijkstra, ``floor(inf / Δ)``'s OverflowError
    under delta, on every graph, in both packages."""
    from repro.core.processing import SSWP as REF_SSWP

    want = AssertionError if spec == "dijkstra" else OverflowError
    for g in tiny_graphs:
        with pytest.raises(want):
            ref_core.AGM(g, REF_SSWP, ref_core.make_ordering(spec),
                         [(0, float("inf"), 0)]).run()
        with pytest.raises(want):
            core.AGM(port_graph(g), core.SSWP, core.make_ordering(spec),
                     [(0, float("inf"), 0)]).run()


def test_topk_has_no_scalar_class_key(tiny_graphs):
    g = tiny_graphs[0]
    with pytest.raises(TypeError):
        ref_core.run_logical(ref_core.sssp_agm(g, 0, ref_core.make_ordering("topk:8")))
    with pytest.raises(TypeError):
        core.run_logical(core.sssp_agm(port_graph(g), 0, core.make_ordering("topk:8")))


def test_max_classes_truncates_alike(tiny_graphs):
    g = tiny_graphs[0]
    want = ref_core.run_logical(ref_core.sssp_agm(g, 0, ref_core.make_ordering("dijkstra")),
                                max_classes=7)
    got = core.run_logical(core.sssp_agm(port_graph(g), 0, core.make_ordering("dijkstra")),
                           max_classes=7)
    assert got[1].classes == 7
    assert_same_run(got, want)


def test_a_registered_processing_runs_through_its_tensor_functions(tiny_graphs):
    """A processing function the built-ins do not cover runs on float64
    scalar tensors; a twin of SSSP under another name gives SSSP's run."""
    import dataclasses

    g = port_graph(tiny_graphs[1])
    twin = dataclasses.replace(core.SSSP, name="sssp_twin")
    want = core.run_logical(core.sssp_agm(g, 0, core.make_ordering("delta:5")))
    got = core.AGM(g, twin, core.make_ordering("delta:5"), core.sssp_sources(0)).run()
    assert_same_run(got, want)


def test_ordering_kinds_equal_the_reference():
    assert core.ordering_kinds() == ref_core.ordering_kinds()


def test_paper_variant_grid_equals_the_reference():
    for kw in ({}, dict(deltas=(2.0,), ks=(4,), chunk_size=64)):
        want = ref_core.paper_variant_grid(**kw)
        got = core.paper_variant_grid(**kw)
        assert [h.describe() for h in got] == [h.describe() for h in want]
        assert [h.name for h in got] == [h.name for h in want]
        assert [h.spec for h in got] == [h.spec for h in want]
    assert all(isinstance(h, api.Hierarchy) for h in core.paper_variant_grid())


def test_source_sets_equal_the_reference():
    assert core.sssp_sources(7) == ref_core.sssp_sources(7)
    assert core.cc_sources(9) == ref_core.cc_sources(9)


@pytest.mark.parametrize("partitioner", ["block", "ebal", "shuffle:3", "degree"])
@pytest.mark.parametrize("n_parts", [1, 2, 4])
def test_load_stats_and_describe_equal_the_reference(tiny_graphs, n_parts, partitioner):
    for g in tiny_graphs:
        want = ref_graph.partition_graph(g, n_parts, partitioner=partitioner)
        got = tg.partition_graph(port_graph(g), n_parts, partitioner=partitioner)
        st = got.load_stats()
        assert st == want.load_stats()
        assert got.describe() == want.describe()
        assert got.describe(st) == want.describe(want.load_stats())


def test_one_shot_solve_and_exports(tiny_graphs):
    g = port_graph(tiny_graphs[0])
    pb = api.Problem(g, api.SingleSource(3))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        one = api.solve(pb, "delta:5+threadq/sparse", device="cpu", n_parts=2)
        want = api.Solver("delta:5+threadq/sparse", n_parts=2, device="cpu").solve(pb)
    assert one.state.tobytes() == want.state.tobytes()
    assert one.metrics.as_dict() == want.metrics.as_dict()
    assert api.make_hierarchy("delta:5", "threadq") == \
        api.Hierarchy.from_spec("delta:5 > chunk:topk:1024")
    for name in ("solve", "Hierarchy", "make_hierarchy"):
        assert name in api.__all__
    for name in ("AGM", "run_logical", "sssp_agm", "ordering_kinds",
                 "paper_variant_grid", "sssp_sources", "cc_sources"):
        assert name in core.__all__


def test_list_variants_prints_the_reference_lines(capsys):
    assert cli.list_variants_lines() == ref_list_variants_lines()
    assert cli.main(["--list-variants"]) == 0
    assert capsys.readouterr().out.splitlines() == ref_list_variants_lines()


@pytest.mark.parametrize("argv,name", [
    ([], "delta:5+buffer/sparse/fused"),
    (["--root", "kla:2"], "kla:2+buffer/a2a"),
    (["--variant", "threadq", "--exchange", "sparse", "--chunk", "64"],
     "delta:5 > chunk:topk:64/sparse"),
    (["--spec", "dijkstra/pmin", "--root", "kla:2"], "dijkstra+buffer/pmin"),
    (["--spec", "delta:5/sparse@block", "--partition", "ebal"],
     "delta:5+buffer/sparse@ebal"),
])
def test_cli_composes_the_spec(argv, name):
    """``--spec`` wins; else ``root+variant/exchange`` once one is given
    (the reference CLI's defaults), else the fused sparse path;
    ``--chunk`` and ``--partition`` apply to either."""
    assert cli.solver_config(cli.parser().parse_args(argv)).name == name


def test_cli_partition_flag_prints_the_load_balance(capsys):
    assert cli.main(["--device", "cpu", "--scale", "8", "--root", "delta:5",
                     "--exchange", "sparse", "--partition", "ebal", "--ranks", "2",
                     "--verify"]) == 0
    out = capsys.readouterr().out
    g = tg.rmat1(8, 0)
    pg = tg.partition_graph(g, 2, partitioner="ebal")
    st = pg.load_stats()
    assert f"[sssp] {pg.describe(st)}" in out
    assert f"load balance (ebal): rows/rank={st['rows_per_rank']}" in out
    assert f"straggler ratio: rows={st['straggler_rows']:.3f}" in out
    assert "spec=delta:5+buffer/sparse@ebal" in out
    assert "verify vs Dijkstra: OK" in out
