"""The port's flight recorder (``/trace``, ``repro_torch.obs.recorder``)
and metrics export (``repro_torch.obs.export``) against the JAX
package's ``repro.obs``: traced solves over a2a, sparse and auto whose
state, ``metrics.as_dict()`` and ``SolveTrace.as_dict()`` (less the
segments' wall clocks) are bit-identical to the reference's and to the
untraced solve's; ``resolve``'s host sweep; the exposition text, Chrome
trace and JSONL flight record of the same records; the metrics server
on loopback; and ``launch/obs.py`` on the CPU.

``/fused`` and ``relax_impl="push"`` traces are held against the
reference's plain-relax spec (its kernels fail inside ``shard_map``
under jax 0.9.0).
"""

import copy
import json
import urllib.request
import warnings

import jax
import numpy as np
import pytest

import repro.api as ref_api
import repro.obs as ref_obs
import repro_torch.api as api
import repro_torch.graph as tg
import repro_torch.obs as obs
from repro.core.metrics import SuperstepWindow as RefWindow
from repro.core.metrics import WorkMetrics as RefMetrics
from repro_torch.core.metrics import SuperstepWindow, WorkMetrics


@pytest.fixture(scope="module")
def mesh1():
    return jax.make_mesh((1,), ("data",))


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        yield


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def port_graph(g):
    return tg.Graph(g.n, g.src.copy(), g.dst.copy(), g.weight.copy(),
                    name=g.name)


def trace_dict(tr):
    """``SolveTrace.as_dict()`` without the segments' wall clocks."""
    d = tr.as_dict()
    d["segments"] = [{k: v for k, v in s.items() if k not in ("t0", "t1")}
                     for s in d["segments"]]
    return d


def traced_both(mesh, g, spec, impl=None, source=0, **kw):
    ref = ref_api.Solver(ref_api.SolverConfig.from_spec(
        spec, chunk_size=64, **kw), mesh=mesh).solve(
            ref_api.Problem(g, ref_api.SingleSource(source)))
    if impl is not None:
        kw["relax_impl"] = impl
    port = api.Solver(api.SolverConfig.from_spec(spec, chunk_size=64, **kw),
                      device="cpu").solve(
        api.Problem(port_graph(g), api.SingleSource(source)))
    return ref, port


def same_trace(ref, port):
    assert port.state.tobytes() == ref.state.tobytes()
    assert port.metrics.as_dict() == ref.metrics.as_dict()
    # a kernel route's spec names '/fused' where the reference's does not
    named = copy.copy(port.trace)
    named.config_name = ref.trace.config_name
    assert trace_dict(named) == trace_dict(ref.trace)
    assert named.table() == ref.trace.table()
    assert named.superstep_records() == ref.trace.superstep_records()
    port.trace.reconcile(port.metrics)


# ----------------------------------------------------------- traced solves


@pytest.mark.parametrize("cap", [None, 4])
@pytest.mark.parametrize("spec", ["delta:5", "kla:2+threadq", "dijkstra"])
@pytest.mark.parametrize("exchange", ["a2a", "sparse", "auto"])
def test_trace_equals_reference(mesh1, tiny_graphs, exchange, spec, cap):
    ref, port = traced_both(mesh1, tiny_graphs[0], f"{spec}/{exchange}/trace",
                            frontier_cap=cap)
    same_trace(ref, port)


@pytest.mark.parametrize("gi", [1, 2, 3])
def test_trace_equals_reference_on_every_graph(mesh1, tiny_graphs, gi):
    ref, port = traced_both(mesh1, tiny_graphs[gi], "delta:5/sparse/trace",
                            source=1)
    same_trace(ref, port)


@pytest.mark.parametrize("impl", ["fused", "push"])
def test_trace_kernel_routes_equal_reference(mesh1, tiny_graphs, impl):
    ref, port = traced_both(mesh1, tiny_graphs[0], "delta:5/sparse/trace",
                            impl=impl, frontier_cap=4)
    same_trace(ref, port)
    assert port.trace.config_name == port.config.name


def test_trace_composes_with_adapt(mesh1, tiny_graphs):
    ref, port = traced_both(mesh1, tiny_graphs[1],
                            "delta:5/sparse/adapt:rho/trace", frontier_cap=1)
    same_trace(ref, port)
    assert port.metrics.retraces >= 1


@pytest.mark.parametrize("exchange", ["a2a", "sparse", "auto"])
def test_trace_is_bit_identical_to_the_untraced_solve(tiny_graphs, exchange):
    g = port_graph(tiny_graphs[3])
    prob = api.Problem(g, api.SingleSource(1))
    base = api.Solver(f"delta:5/{exchange}", device="cpu").solve(prob)
    traced = api.Solver(f"delta:5/{exchange}/trace", device="cpu").solve(prob)
    assert base.state.tobytes() == traced.state.tobytes()
    assert base.metrics == traced.metrics and base.trace is None
    tr = traced.trace
    tr.reconcile(traced.metrics)
    assert tr.supersteps == traced.metrics.supersteps
    assert sum(s["supersteps"] for s in tr.segments) == tr.supersteps
    assert all(s["t1"] >= s["t0"] for s in tr.segments)
    assert tr.pending[-1] == 0


def test_trace_resolve_counts_the_host_sweep(mesh1, tiny_graphs):
    spec = "delta:5/sparse/trace"
    g = copy.deepcopy(tiny_graphs[0])
    rs, ps = ref_api.Solver(spec, mesh=mesh1), api.Solver(spec, device="cpu")
    pg_ = port_graph(g)
    ref0 = rs.solve(ref_api.Problem(g, ref_api.SingleSource(0)))
    port0 = ps.solve(api.Problem(pg_, api.SingleSource(0)))
    g.weight[:] = np.minimum(g.weight, np.float32(0.5))  # improving
    pg_.weight[:] = g.weight
    ref, port = rs.resolve(ref0, graph=g), ps.resolve(port0, graph=pg_)
    assert port.trace.host_sweeps == ref.trace.host_sweeps == 1
    same_trace(ref, port)


def test_solve_batch_refuses_traced_specs():
    g = tg.rmat1(6, seed=0)
    with pytest.raises(ValueError, match="flight recorder"):
        api.Solver("delta:5/sparse/trace", device="cpu").solve_batch(
            [api.Problem(g, api.SingleSource(v)) for v in (0, 1)])


def test_recorder_accumulates_segments_as_reference():
    fields = dict(pending=[3, 1], eligible=[2, 2], rows=[2, 2],
                  sparse_used=[1, 0], bytes_moved=[8, 16], overflow_streak=0,
                  supersteps_total=2, n=16, rows_per_rank=16,
                  sparse_capable=True)
    out = []
    for rec, window, metrics in (
        (obs.FlightRecorder("spec"), SuperstepWindow, WorkMetrics),
        (ref_obs.FlightRecorder("spec"), RefWindow, RefMetrics),
    ):
        rec.on_window(window(**fields), {"supersteps": 2, "t0": 1.0, "t1": 2.0})
        rec.on_window(window(**fields), {"supersteps": 2, "t0": 3.0, "t1": 4.0})
        out.append(rec.finish(metrics(repair_sweeps=0)).as_dict())
    assert out[0] == out[1]


def test_reconcile_names_the_first_mismatch():
    tr = obs.SolveTrace(pending=[2, 0], eligible=[2, 1], rows=[2, 1],
                        sparse_used=[1, 1], bytes_moved=[0, 0],
                        sparse_capable=True)
    with pytest.raises(AssertionError, match="commits"):
        tr.reconcile(WorkMetrics(supersteps=2, commits=5, exchange_bytes=0))
    with pytest.raises(AssertionError, match="supersteps"):
        tr.reconcile(WorkMetrics(supersteps=5, commits=3))


# ----------------------------------------------------------------- export


def record_both():
    """The same spans, events and solve trace through both packages'
    tracers, each on a FakeClock and feeding a registry."""
    out = []
    for pkg in (obs, ref_obs):
        reg = pkg.MetricsRegistry()
        tr = pkg.Tracer(clock=FakeClock(), registry=reg)
        with pkg.use_tracer(tr):
            with pkg.span("solve", spec="s"):
                pkg.event("cache_miss")
                with pkg.span("inner"):
                    pass
            pkg.event("cache_miss")
        st = pkg.SolveTrace(
            config_name="s", n=8, rows_per_rank=8, sparse_capable=True,
            pending=[4, 2, 0], eligible=[4, 2, 1], rows=[4, 2, 1],
            sparse_used=[1, 0, 1], bytes_moved=[0, 64, 0],
            segments=[{"segment": 0, "supersteps": 2, "t0": 1.0, "t1": 2.0},
                      {"segment": 1, "supersteps": 1, "t0": 2.0, "t1": 4.0}])
        c = reg.counter("c_total", help="h", labels={"k": "v"})
        c.inc(2.5)
        reg.gauge("g_live", help="h", fn=lambda: 7)
        h = reg.histogram("h_seconds", help="h", buckets=(0.1, 1.0))
        for x in (0.05, 0.5, 5.0):
            h.observe(x)
        out.append((pkg, reg, tr, st))
    return out


def test_exposition_equals_reference():
    (_, preg, _, _), (_, rreg, _, _) = record_both()
    assert preg.expose() == rreg.expose()
    assert preg.as_dict() == rreg.as_dict()
    assert 'repro_events_total{event="cache_miss"} 2' in preg.expose()


def test_chrome_trace_and_flight_jsonl_equal_reference():
    (pkg, _, ptr, pst), (ref, _, rtr, rst) = record_both()
    assert pkg.chrome_trace(ptr, [pst]) == ref.chrome_trace(rtr, [rst])
    assert pkg.flight_jsonl(ptr, [pst]) == ref.flight_jsonl(rtr, [rst])
    doc = pkg.chrome_trace(ptr, [pst])
    assert sum(e["ph"] == "C" for e in doc["traceEvents"]) == 2 * 3
    json.dumps(doc)


def test_serve_metrics_on_loopback():
    reg = obs.MetricsRegistry()
    reg.counter("up_total", help="h").inc()
    server = obs.serve_metrics(reg, port=0)
    try:
        host, port = server.server_address[:2]
        with urllib.request.urlopen(f"http://{host}:{port}/metrics",
                                    timeout=10) as r:
            assert "up_total 1" in r.read().decode()
        with urllib.request.urlopen(f"http://{host}:{port}/stats",
                                    timeout=10) as r:
            assert json.loads(r.read().decode())["up_total"]["type"] == "counter"
    finally:
        server.shutdown()
        server.server_close()


# -------------------------------------------------------------------- CLI


def test_launch_obs_cli_on_cpu(tmp_path, capsys):
    from repro_torch.launch.obs import main

    jsonl, trace_json = tmp_path / "flight.jsonl", tmp_path / "trace.json"
    metrics = tmp_path / "metrics.txt"
    assert main(["record", "--device", "cpu", "--scale", "8",
                 "--spec", "delta:5/sparse/fused", "--gate", "0",
                 "--table", "--jsonl", str(jsonl), "--trace-json",
                 str(trace_json), "--metrics", str(metrics)]) == 0
    out = capsys.readouterr().out
    assert "state EQUAL, metrics EQUAL, trace sums reconcile" in out
    assert "repro_span_seconds" in metrics.read_text()
    assert main(["summarize", str(jsonl)]) == 0
    assert "total supersteps=" in capsys.readouterr().out
    assert main(["export", str(jsonl), "--out", str(tmp_path / "t2.json")]) == 0
    assert json.loads((tmp_path / "t2.json").read_text())["traceEvents"]
