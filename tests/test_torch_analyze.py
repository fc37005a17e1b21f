"""repro_torch.analyze against the JAX package's repro.analyze on the
CPU: fingerprints and baselines read across packages, the spec checks
and the collective-plan text over the whole spec grid, the contract
verifier's laws and witnesses on the registered and on broken
processing functions, and the port's engine lint (its rules fire on
planted faults; the quick grid at 4 stacked ranks gates clean with the
repository's baseline)."""

import dataclasses
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analyze import contract as ref_contract
from repro.analyze import findings as ref_findings
from repro.analyze import spec_check as ref_spec
from repro.analyze.jaxpr_lint import payload_index_capacity as ref_capacity
from repro.analyze.report import grid_specs as ref_grid_specs
from repro.api import SolverConfig as RefConfig
from repro.core.processing import ProcessingFn as RefFn
from repro_torch.analyze import contract, engine_lint, findings, spec_check
from repro_torch.analyze.engine_lint import StepShape, lint_engine
from repro_torch.analyze.report import grid_specs
from repro_torch.api import SolverConfig, get_processing
from repro_torch.core import engine as port_engine
from repro_torch.core.processing import ProcessingFn
from repro_torch.core.ranks import StackedRanks

ROOT = pathlib.Path(__file__).resolve().parents[1]
BASELINE = ROOT / "analyze_baseline_torch.json"
SHAPE = dict(n_local=64, rows=80, width=8, n_parts=4)
EXTRAS = ["delta:5/sparse/fused", "delta:5/sparse/q:bf16",
          "delta:5/sparse/fused/q:u16", "kla:2/sparse/fused",
          "delta:5/a2a/fused", "delta:5/a2a/q:bf16"]
EXPLAIN = ["delta:5 > chunk:delta:1 /sparse", "delta:5+buffer/pmin",
           "kla:2+nodeq/auto", "delta:5 > pod:dijkstra /a2a",
           "delta:5/sparse/q:u16", "chaotic+threadq/sparse/adapt:rho/trace"]


def codes(fs):
    return [f.to_dict() for f in fs]


# ------------------------------------------------------------ findings


def test_fingerprints_and_baselines_cross_packages(tmp_path):
    args = [("spec", "frontier-cap-dense", "warn", "delta:5/a2a", "m", None),
            ("contract", "reduce-idempotent", "error", "x", "m", "(1.0,)"),
            ("engine", "host-sync", "warn", "delta:5+buffer/sparse", "m", None),
            ("spec", "note", "info", "s", "m", "w")]
    port = [findings.Finding(*a) for a in args]
    ref = [ref_findings.Finding(*a) for a in args]
    assert [findings.fingerprint(f) for f in port] == \
        [ref_findings.fingerprint(f) for f in ref]
    assert [f.to_dict() for f in port] == [f.to_dict() for f in ref]
    assert findings.baseline_records(port) == ref_findings.baseline_records(ref)
    a, b = tmp_path / "port.json", tmp_path / "ref.json"
    a.write_text(json.dumps(findings.baseline_records(port)))
    b.write_text(json.dumps(ref_findings.baseline_records(ref)))
    for path in (a, b):
        base_p = findings.load_baseline(str(path))
        assert base_p == ref_findings.load_baseline(str(path))
        fresh, old = findings.split_baselined(port, base_p)
        rfresh, rold = ref_findings.split_baselined(ref, base_p)
        assert codes(fresh) == codes(rfresh) and codes(old) == codes(rold)
        assert len(old) == 3 and findings.gate_failures(fresh) == []
    assert findings.load_baseline(str(tmp_path / "missing.json")) == set()


# ------------------------------------------------------------ spec pass


def test_grid_specs_equal_reference():
    assert grid_specs() == ref_grid_specs() and len(grid_specs()) == 464
    assert grid_specs(quick=True) == ref_grid_specs(quick=True)


@pytest.mark.parametrize("mesh_axes", [("data",), ("pod", "data")])
def test_check_config_equals_reference_over_the_grid(mesh_axes):
    n = 0
    for s in grid_specs() + EXTRAS:
        for shape in (None, SHAPE):
            got = spec_check.check_config(s, shape=shape, mesh_axes=mesh_axes)
            want = ref_spec.check_config(s, shape=shape, mesh_axes=mesh_axes)
            assert codes(got) == codes(want), s
            n += len(got)
    assert n > 400  # the grid's drift, pod and capacity notes


@pytest.mark.parametrize("processing", ["sssp", "bfs", "sswp"])
def test_check_config_processing_rules_equal_reference(processing):
    for s in ("delta:5/sparse/fused", "delta:5/sparse/q:u16", "kla:2/auto/fused"):
        assert codes(spec_check.check_config(s, processing=processing)) == \
            codes(ref_spec.check_config(s, processing=processing))


@pytest.mark.parametrize("mesh_axes", [("data",), ("pod", "data")])
def test_explain_config_text_equals_reference(mesh_axes):
    for s in EXPLAIN + grid_specs(quick=True)[::7]:
        for shape in (None, SHAPE):
            assert spec_check.explain_config(s, shape=shape, mesh_axes=mesh_axes) \
                == ref_spec.explain_config(s, shape=shape, mesh_axes=mesh_axes)


@pytest.mark.parametrize("spec,kw", [
    ("delta:5/a2a", dict(frontier_cap=16)),
    ("delta:5 > chunk:topk:64 /sparse", dict(frontier_cap=8)),
    ("delta:5/sparse@ebal", {}),
    ("delta:5/sparse/adapt:static/trace", dict(collect_metrics=False)),
])
def test_solver_config_lint_equals_reference(spec, kw):
    got = SolverConfig.from_spec(spec, **kw).lint(shape=SHAPE)
    want = RefConfig.from_spec(spec, **kw).lint(shape=SHAPE)
    assert got and codes(got) == codes(want)


# -------------------------------------------------------- contract pass


def test_registered_processing_verify_clean_and_domains_equal():
    from repro.api import get_processing as ref_get

    got = contract.verify_registered()
    assert set(got) >= {"sssp", "bfs", "cc", "sswp"}
    assert not any(got.values()), got
    assert {k: [] for k in got} == {
        k: [str(v) for v in vs]
        for k, vs in ref_contract.verify_registered().items() if k in got}
    for name in ("sssp", "bfs", "cc", "sswp"):
        dom = contract.reachable_domain(get_processing(name))
        assert dom == ref_contract.reachable_domain(ref_get(name))
        assert 3 <= len(dom) <= 48


BROKEN = {
    # name: (edge_update, better, reduce, worst), as tests/test_analyze.py
    "broken-sum": ("plus", "lt", "sum", float("inf")),
    "broken-le": ("plus", "le", "min", float("inf")),
    "broken-shrink": ("minus1", "lt", "min", float("inf")),
    "broken-worst": ("plus", "lt", "min", 0.0),
    "broken-handmin": ("plus", "lt", "where", float("inf")),
}


def broken_pair(name):
    up, better, red, worst = BROKEN[name]
    ups = {"plus": lambda s, w: s + w, "minus1": lambda s, w: s - 1.0}
    betters = {"lt": lambda a, b: a < b, "le": lambda a, b: a <= b}
    port_red = {"sum": lambda a, b: a + b, "min": torch.minimum,
                "where": lambda a, b: torch.where(a < b, a, b)}[red]
    ref_red = {"sum": lambda a, b: a + b, "min": jnp.minimum,
               "where": lambda a, b: jnp.where(a < b, a, b)}[red]
    return (ProcessingFn(name, ups[up], betters[better], port_red, worst),
            RefFn(name, ups[up], betters[better], ref_red, worst))


@pytest.mark.parametrize("name,law", [
    ("broken-sum", "reduce-idempotent"),
    ("broken-le", "better-irreflexive"),
    ("broken-shrink", "relax-inflationary"),
    ("broken-worst", "worst-identity"),
    ("broken-handmin", "reduce-array-consistent"),
])
def test_broken_functions_same_laws_and_witnesses(name, law):
    port_fn, ref_fn = broken_pair(name)
    got = contract.verify_processing(port_fn)
    want = ref_contract.verify_processing(ref_fn)
    assert [(v.law, v.witness) for v in got] == [(v.law, v.witness) for v in want]
    assert law in {v.law for v in got}
    assert [str(v) for v in got] == [str(v) for v in want]
    assert codes(contract.contract_findings({name: got})) == \
        codes(ref_contract.contract_findings({name: want}))
    assert contract.reachable_domain(port_fn) == ref_contract.reachable_domain(ref_fn)


def test_violation_cap_per_law_equals_reference():
    port_fn, ref_fn = broken_pair("broken-sum")
    got = contract.verify_processing(port_fn, max_violations=5)
    want = ref_contract.verify_processing(ref_fn, max_violations=5)
    assert [(v.law, v.witness) for v in got] == [(v.law, v.witness) for v in want]
    per_law: dict = {}
    for v in contract.verify_processing(port_fn):
        per_law[v.law] = per_law.get(v.law, 0) + 1
    assert len(got) == 5 and max(per_law.values()) <= 3


@pytest.mark.parametrize("kind,law", [
    ("f64", "trace-f64"), ("host", "trace-impure"), ("inplace", "trace-impure"),
    ("fails", "trace-fails"),
])
def test_inspection_by_op_recording(kind, law):
    ups = {
        "f64": lambda s, w: (s.double() + w.double()).float(),
        "host": lambda s, w: s + float(w),
        "inplace": lambda s, w: s.add_(0.0) + w,
        "fails": lambda s, w: s.no_such_method(w),
    }
    fn = ProcessingFn(f"broken-{kind}", ups[kind], lambda a, b: a < b,
                      torch.minimum, float("inf"))
    out: list = []
    contract._check_trace_laws(fn, out)
    laws = {v.law: v for v in out}
    assert law in laws and laws[law].witness == ("edge_update",)


# ----------------------------------------------------------- engine lint


def cfg_of(spec, processing="sssp", **kw):
    return SolverConfig.from_spec(spec, **kw).engine_config(get_processing(processing))


def rules(fs, severity=None):
    return {f.rule for f in fs if severity is None or f.severity == severity}


def test_payload_capacity_equals_reference():
    for dt in (np.float32, np.float16, np.float64, np.int32, np.uint16, np.int8,
               np.uint8, np.uint32, np.int64, np.bool_, "u32", "u16", "s8",
               "bf16", "f8e4m3fn", "f32", "pred"):
        assert engine_lint.payload_index_capacity(dt) == ref_capacity(dt), dt
    pairs = [(torch.float32, np.float32), (torch.float16, np.float16),
             (torch.int32, np.int32), (torch.int16, np.int16),
             (torch.uint8, np.uint8), (torch.int64, np.int64),
             (torch.bfloat16, jnp.bfloat16), (torch.bool, np.bool_),
             (torch.float8_e4m3fn, jnp.float8_e4m3fn)]
    for t, n in pairs:
        assert engine_lint.payload_index_capacity(t) == ref_capacity(n), t
    assert engine_lint.payload_capacity("u16", 1024) == (True, 65535)
    assert not engine_lint.payload_capacity(torch.bfloat16, 1024)[0]


def test_expected_collectives_plan():
    assert engine_lint.expected_collectives(cfg_of("delta:5/sparse"), 1) == {}
    assert engine_lint.expected_collectives(cfg_of("delta:5/pmin"), 4) == \
        {"all_reduce": True, "all_to_all": False}
    assert engine_lint.expected_collectives(cfg_of("delta:5/auto"), 4) == \
        {"all_reduce": True, "all_to_all": True}


@pytest.mark.parametrize("spec,processing", [
    ("kla:2+buffer/sparse/fused", "sssp"), ("delta:5/sparse/fused", "bfs"),
])
def test_lint_reports_fused_kernel_escape(spec, processing):
    fs = lint_engine(cfg_of(spec, processing), StepShape(), 4, "cpu")
    assert rules(fs, "warn") == {"fused-kernel-escape"}


@pytest.mark.parametrize("spec,kw", [
    ("delta:5/sparse/fused", {}), ("delta:5/sparse", dict(relax_impl="push")),
])
def test_lint_kernel_specs_call_their_kernel(spec, kw):
    run = engine_lint.run_step(cfg_of(spec, **kw), StepShape(), 4, "cpu")
    assert run.kernel_calls > 0 and run.host_reads == \
        run.budget[0] * run.supersteps + run.budget[1]
    assert rules(engine_lint.lint_run(cfg_of(spec, **kw), run,
                                      StepShape(n_parts=4))) == {"engine-stats"}


def test_lint_flags_an_injected_float64():
    sssp = get_processing("sssp")
    wide = dataclasses.replace(
        sssp, edge_update=lambda s, w: (s.double() + w).float())
    cfg = SolverConfig.from_spec("delta:5/sparse").engine_config(wide)
    fs = lint_engine(cfg, StepShape(), 4, "cpu")
    assert "f64-promotion" in rules(fs, "error")
    assert not rules(lint_engine(cfg_of("delta:5/sparse"), StepShape(), 4, "cpu"),
                     "error")


def test_lint_flags_a_payload_dtype_too_narrow(monkeypatch):
    """A payload sent as bf16 cannot index n_local = 512 vertices: its
    all-to-all is flagged (the receiver unpacks the f32 words again)."""
    real_payload, real_unpack = port_engine.sparse_payload, port_engine.unpack_combine

    def narrow(*a, **k):
        payload, over = real_payload(*a, **k)
        return payload.to(torch.bfloat16), over

    def unpack(recv, *a, **k):
        return real_unpack(recv.to(torch.float32), *a, **k)

    monkeypatch.setattr(port_engine, "sparse_payload", narrow)
    monkeypatch.setattr(port_engine, "unpack_combine", unpack)
    fs = lint_engine(cfg_of("delta:5/sparse"), StepShape(n_local=512), 2, "cpu")
    assert "payload-overflow" in rules(fs, "error")


def test_lint_flags_the_collective_plan_at_four_ranks(monkeypatch):
    # the pmin exchange routed through an all-to-all: a collective the
    # spec rules out
    def reduce_by_a2a(self, C, is_min, CL=None):
        B = C.shape[0]
        X = self.all_to_all(C.reshape(B, self.world, self.world, -1))
        return (X.amin(2) if is_min else X.amax(2)), None

    fs = lint_engine(cfg_of("delta:5/pmin"), StepShape(), 4, "cpu")
    assert "collective-plan" not in rules(fs)
    monkeypatch.setattr(StackedRanks, "reduce", reduce_by_a2a)
    fs = lint_engine(cfg_of("delta:5/pmin"), StepShape(), 4, "cpu")
    assert [f.severity for f in fs if f.rule == "collective-plan"] == ["warn"]
    # at one rank the plan is not checked
    assert "collective-plan" not in rules(
        lint_engine(cfg_of("delta:5/pmin"), StepShape(), 1, "cpu"))


def test_lint_flags_a_missing_all_to_all(monkeypatch):
    # an all-to-all that bypasses the recording ranks is one the step
    # never ran
    from repro_torch.roofline.ops import RecordingRanks

    monkeypatch.setattr(RecordingRanks, "all_to_all", StackedRanks.all_to_all)
    fs = lint_engine(cfg_of("delta:5/a2a"), StepShape(), 4, "cpu")
    assert [f.severity for f in fs if f.rule == "collective-plan"] == ["error"]


def test_lint_reports_a_failing_step(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("planted")

    monkeypatch.setattr(port_engine, "compact_rows", boom)
    fs = lint_engine(cfg_of("delta:5/sparse"), StepShape(), 1, "cpu")
    assert [(f.rule, f.severity) for f in fs] == [("step-fails", "error")]


# ----------------------------------------------------------------- CLI


@pytest.fixture(scope="module")
def cli_report(tmp_path_factory):
    """``launch.analyze --quick --ranks 4 --device cpu`` with the
    repository's baseline: its exit and its report."""
    from repro_torch.launch.analyze import main

    path = tmp_path_factory.mktemp("analyze") / "report.json"
    main(["--quick", "--ranks", "4", "--device", "cpu", "--json", str(path),
          "--baseline", str(BASELINE)])  # raises SystemExit on a failed gate
    return json.loads(path.read_text())


def test_quick_grid_gates_clean_with_the_baseline(cli_report):
    rep = cli_report
    assert rep["ok"] and rep["points"] == len(ref_grid_specs(quick=True)) + 3
    assert rep["traced_engines"] == 55 and rep["shape"]["n_parts"] == 4
    assert set(rep["processing_checked"]) >= {"sssp", "bfs", "cc", "sswp"}
    assert not [f for f in rep["findings"] if f["severity"] != "info"]
    # the one accepted finding: the u16 decode's FMA in float64 scratch
    assert [(f["rule"], f["subject"]) for f in rep["baselined"]] == \
        [("f64-promotion", "delta:5+buffer/sparse/fused/q:u16")]
    for subject, e in rep["engine"].items():
        assert e["host_syncs"] == e["host_sync_budget"], subject
        assert e["collectives"]["all_reduce"] > 0, subject
        if e["kernel"] is not None:
            assert e["kernel_calls"] > 0, subject


def test_cli_explain_equals_reference(capsys, monkeypatch):
    import sys

    from repro.launch import analyze as ref_cli
    from repro_torch.launch.analyze import main

    specs = ["delta:5 > chunk:delta:1 /sparse", "kla:2+buffer/auto"]
    main(["--explain", *specs])
    got = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["analyze", "--explain", *specs])
    ref_cli.main()
    assert got == capsys.readouterr().out and "collective rounds" in got
