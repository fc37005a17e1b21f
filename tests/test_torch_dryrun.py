"""The meta-device dry-run (``repro_torch.launch.dryrun``): the CLI over
every planned cell writes one ``ok`` record a cell and rank count
without building a graph or running an engine; a real partition's
resident bytes equal its plan's arguments; the Graph500-scale cells
report the bytes their row formula gives; and the superstep peak plan
holds against the CPU allocator's peak over a solve."""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.core.engine as engine
import repro_torch.graph.generators as generators
from repro_torch.api import Problem, SingleSource, Solver, SolverConfig
from repro_torch.configs import all_cells, sssp_cfg
from repro_torch.configs.cells import sssp_plan, sssp_rows
from repro_torch.core.engine import initial_state, sssp_sources
from repro_torch.core.processing import SSSP
from repro_torch.graph import partition_graph, rmat1
from repro_torch.launch import dryrun


def nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def test_cli_all_writes_ok_records_without_a_graph_or_an_engine(tmp_path, monkeypatch, capsys):
    def refuse(*a, **k):
        raise AssertionError("the dry-run must not build a graph or run an engine")

    monkeypatch.setattr(generators, "rmat_graph", refuse)
    monkeypatch.setattr(engine, "_run", refuse)
    dryrun.main(["--all", "--ranks", "1", "4", "--out", str(tmp_path)])
    recs = [json.loads(p.read_text()) for p in sorted(tmp_path.glob("*.json"))]
    assert len(recs) == 32 and all(r["ok"] for r in recs)
    assert {(r["arch"], r["cell"]) for r in recs} == set(all_cells())
    assert sorted(r["ranks"] for r in recs) == [1] * 16 + [4] * 16
    out = capsys.readouterr().out
    assert out.count("[dryrun]") == 32 and "dry-run complete: 16 cells" in out
    for r in recs:
        assert r["arg_bytes"] > 0 and r["model_flops"] > 0
        if r["arch"] == "sssp":
            assert r["arg_bytes_per_card"] * r["ranks"] == r["arg_bytes"]
            assert r["peak_bytes_per_card"] > r["resident_bytes_per_card"] > \
                r["arg_bytes_per_card"]
            assert r["fits_one_card"] == (r["peak_bytes_per_card"] <= dryrun.CARD_BYTES)
        else:
            assert r["peak_bytes_per_card"] is None
            assert r["arg_bytes_per_card"] == r["arg_bytes"]
    # one cell alone, cached unless forced, and a failing cell's record
    one = ["--arch", "sssp", "--cell", "road27_delta_nodeq_a2a", "--out", str(tmp_path)]
    dryrun.main(one)
    with pytest.raises(SystemExit, match="1 cell"):
        dryrun.main(["--arch", "sssp", "--cell", "no_such_cell", "--out", str(tmp_path)])
    bad = json.loads((tmp_path / "sssp__no_such_cell__P1.json").read_text())
    assert not bad["ok"] and bad["error"].startswith("KeyError")


@pytest.mark.parametrize("n_parts", [1, 4])
def test_reduced_partition_resident_bytes_equal_the_plan(n_parts):
    """rmat1 at the reduced cells' scale 10, W 8: the ELL and state a
    rank holds equal the plan's arguments a card at that partition's
    shape, and the row degree the engine keeps is the resident rest."""
    pg = partition_graph(rmat1(10, seed=0), n_parts, width=8)
    cfg = SolverConfig.from_spec("delta:5/sparse/fused")
    plan = sssp_plan("sssp", "rmat1_s10", cfg, n_parts=n_parts, n_local=pg.n_local,
                     rows=pg.rows_per_rank, width=pg.width)
    D, T, L = (torch.as_tensor(a) for a in initial_state(pg, SSSP, sssp_sources(0)))
    peak = dryrun.superstep_peak(plan)
    for rank in range(n_parts):
        ell = pg.to("cpu", rank=rank if n_parts > 1 else None)
        state = [D[rank:rank + 1], T[rank:rank + 1], L[rank:rank + 1]]
        assert nbytes([ell.row_src, ell.col, ell.wgt] + state) == plan.arg_bytes // n_parts
        assert nbytes(list(ell) + state) == peak["resident"]
    assert [tuple(t.shape) for t in plan.args] == [
        tuple(pg.row_src.shape), tuple(pg.col.shape), tuple(pg.wgt.shape)] + \
        [tuple(D.shape)] * 3


def test_graph500_cells_report_the_formula_bytes():
    """At one rank, col and wgt of an rmat26 cell take 44.7 GB (rows
    1.3·(2^26·32/32 + 2^26) × W 32 × 8 bytes) and road27's 11.2 GB."""
    for cell, gb in (("rmat26_delta_buffer_a2a", 44.7), ("road27_delta_nodeq_a2a", 11.2)):
        kw = sssp_cfg.SSSP_CELLS[cell]
        n = 1 << kw["scale"]
        rows = sssp_rows(n, kw["avg_degree"], kw["width"])
        col_wgt = rows * kw["width"] * 8
        assert round(col_wgt / 1e9, 1) == gb
        rec = dryrun.plan_record(sssp_cfg.make_cell(cell, 1), "graph")
        assert rec["arg_bytes"] == col_wgt + rows * 4 + 3 * (n + 1) * 4
        assert rec["shape"]["rows"] == rows
    assert rows == 348_966_092 and sssp_rows(1 << 26, 32, 32) == 174_483_046
    # the three rmat26 a2a/pmin cells do not fit one card at P 1, road27
    # does; at P 4 every cell fits
    fits = {(c, p): dryrun.plan_record(sssp_cfg.make_cell(c, p), "graph")["fits_one_card"]
            for c in sssp_cfg.SHAPES for p in (1, 4)}
    assert fits[("road27_delta_nodeq_a2a", 1)]
    assert not fits[("rmat26_delta_buffer_a2a", 1)]
    assert all(fits[(c, 4)] for c in sssp_cfg.SHAPES)


def allocator_peak(fn) -> int:
    """Peak bytes the CPU allocator held beyond what it held before
    ``fn`` ran, from the profiler's memory events: every allocation,
    those inside an op (``torch.where``'s promoted copy) included."""
    with profile(activities=[ProfilerActivity.CPU], profile_memory=True) as prof:
        fn()
    events = sorted((e.start_ns(), e.nbytes())
                    for e in prof.profiler.kineto_results.events()
                    if e.name() == "[memory]")
    cur = peak = 0
    for _, b in events:
        cur += b
        peak = max(peak, cur)
    return peak


@pytest.mark.parametrize("spec", ["delta:5/a2a", "delta:5+buffer/pmin", "kla:2+nodeq/a2a",
                                  "delta:5/sparse", "delta:5/sparse/fused"])
def test_peak_plan_holds_against_the_cpu_engine(spec):
    """The plan's peak a card within 15% of the peak the CPU allocator
    holds over a warm solve (rmat1 scale 12, one rank), where a
    superstep's dense sweep sets the peak (a frontier overflows F in each
    sparse solve)."""
    g = rmat1(12, seed=0)
    pg = partition_graph(g, 1)
    cfg = SolverConfig.from_spec(spec)
    solver = Solver(cfg, device="cpu")
    ell = pg.to("cpu")
    problem = Problem(pg, SingleSource(0))
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)  # many tiny ops: threads only contend here
    try:
        solver.solve(problem)
        measured = nbytes(list(ell)) + allocator_peak(lambda: solver.solve(problem))
    finally:
        torch.set_num_threads(n_threads)
    plan = sssp_plan("sssp", "rmat1_s12", cfg, n_parts=1, n_local=pg.n_local,
                     rows=pg.rows_per_rank, width=pg.width)
    est = dryrun.superstep_peak(plan)
    assert est["branch"] == "dense"
    assert abs(est["peak"] / measured - 1) <= 0.15, (est, measured)
