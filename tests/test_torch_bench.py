"""The port's experiment drivers (``repro_torch.bench``) against the JAX
package's ``benchmarks/``: the variants quick grid at scale 8 (27
points), the partition cell and weak scaling, on the CPU port, each
held row by row to the reference driver's child script, run once a
module in its own subprocess with 8 forced host devices (started first,
so that it runs while the port solves here).  Every row matches on
``ok``, the ``metrics.as_dict()`` fields and ``bytes_per_superstep``;
``model_ms`` matches under the reference's cost figures; ``wall_s`` is
not compared.  Table I is in ``test_torch_bench_table1.py``."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import metrics as ref_metrics
from repro_torch.bench import run as bench_run
from repro_torch.bench import scaling, variants
from repro_torch.core.metrics import WorkMetrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reference_driver(name: str):
    """A driver module of the JAX package's ``benchmarks/`` (a directory,
    not a package on the path)."""
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(ROOT, "benchmarks", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


bench_variants = reference_driver("bench_variants")
bench_scaling = reference_driver("bench_scaling")
#: the reference's cost figures, for model_ms
REF_COST = (ref_metrics.COST_RELAX_S, ref_metrics.COST_SUPERSTEP_S,
            ref_metrics.COST_BYTE_S)
METRIC_KEYS = list(WorkMetrics().as_dict())
SCALE = 8


def start_reference(child: str) -> subprocess.Popen:
    """A reference benchmark child on 8 forced host devices, as its
    driver's ``run`` starts it (the XLA flag lives only in the child)."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    return subprocess.Popen([sys.executable, "-c", child], env=env, cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def finish(proc: subprocess.Popen):
    out, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.splitlines()[-1])


@pytest.fixture(scope="module")
def rows():
    refs = {
        "variants": start_reference(bench_variants.CHILD % {
            "scale": SCALE, "quick": 1, "exchanges": repr(bench_variants.EXCHANGES),
            "frontier_cap": repr(4), "hier_specs": repr(bench_variants.HIERARCHY_SPECS)}),
        "partition": start_reference(bench_variants.CHILD_PART % {
            "scale": SCALE, "partitions": repr(bench_variants.PARTITIONS),
            "exchanges": repr(["a2a", "sparse"]), "frontier_cap": repr(16)}),
        "scaling": start_reference(bench_scaling.CHILD),
    }
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)  # leave the cores to the reference processes
    try:
        port = {
            "variants": variants.run(SCALE, quick=True, device="cpu", cost=REF_COST),
            "partition": variants.run_partition(SCALE, device="cpu"),
            "scaling": scaling.run(device="cpu", cost=REF_COST),
        }
    finally:
        torch.set_num_threads(n_threads)
        ref = {k: finish(p) for k, p in refs.items()}
    return port, ref


def assert_row(port: dict, ref: dict, keys):
    assert {k: port[k] for k in keys} == {k: ref[k] for k in keys}
    assert port["ok"] is True


VARIANT_POINTS = [(root, variant, ex) for root, variant in variants.grid(True)[1]
                  for ex in variants.EXCHANGES]


def test_grids_equal_the_reference():
    assert variants.EXCHANGES == bench_variants.EXCHANGES
    assert variants.HIERARCHY_SPECS == bench_variants.HIERARCHY_SPECS
    assert variants.PARTITIONS == bench_variants.PARTITIONS
    assert len(VARIANT_POINTS) == 27


@pytest.mark.parametrize("i", range(len(VARIANT_POINTS)),
                         ids=["/".join(p) for p in VARIANT_POINTS])
def test_variants_quick_row(rows, i):
    port, ref = rows
    assert len(port["variants"]) == len(ref["variants"]) == 27
    p, r = port["variants"][i], ref["variants"][i]
    assert (p["root"], p["variant"], p["exchange"]) == VARIANT_POINTS[i]
    # the port's rows also name their source (the reference's is 0)
    assert set(p) == set(r) | {"source"} and p["source"] == 0
    assert_row(p, r, ["graph", "scale", "root", "variant", "exchange", "ok",
                      "bytes_per_superstep", "model_ms"] + METRIC_KEYS)


@pytest.mark.parametrize("part", variants.PARTITIONS)
def test_partition_rows(rows, part):
    port, ref = rows
    ps = [r for r in port["partition"] if r["partition"] == part]
    rs = [r for r in ref["partition"] if r["partition"] == part]
    assert len(ps) == len(rs) == 2
    for p, r in zip(ps, rs):
        assert set(p) == set(r) | {"source"} and p["source"] == 0
        assert_row(p, r, ["graph", "scale", "partition", "exchange", "ok", "max_rows",
                          "n_local", "straggler_rows", "ell_occupancy"] + METRIC_KEYS)


SCALING_POINTS = [(P, root, variant) for P, _, _ in scaling.MESHES
                  for root, variant in scaling.SPECS]


@pytest.mark.parametrize("i", range(len(SCALING_POINTS)),
                         ids=[f"P{p}-{r}+{v}" for p, r, v in SCALING_POINTS])
def test_scaling_row(rows, i):
    port, ref = rows
    p, r = port["scaling"][i], ref["scaling"][i]
    assert (p["P"], p["root"], p["variant"]) == SCALING_POINTS[i]
    # the port's rows also say whether the state equals Dijkstra's
    assert set(p) == set(r) | {"ok"}
    assert_row(p, r, ["P", "scale", "root", "variant", "model_ms"] + METRIC_KEYS)


def test_model_ms_defaults_to_the_h100_figures(rows):
    """Without ``cost`` the rows carry the port's H100 cost model."""
    from repro_torch.core.metrics import model_time_s

    port, _ = rows
    r = port["variants"][0]
    m = WorkMetrics(**{k: r[k] for k in METRIC_KEYS})
    assert model_time_s(m, 256) != model_time_s(m, 256, REF_COST)
    assert r["model_ms"] == model_time_s(m, 256, REF_COST) * 1e3


def test_clis_on_the_cpu(tmp_path, monkeypatch, capsys):
    """``variants --quick --json --json-partition`` and ``run --fast``
    (its grid cut to the quick one here) print the reference's line
    names and write JSON under ``--out``."""
    assert variants.main(["--quick", "--scale", "7", "--device", "cpu", "--json",
                          "--json-partition", "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert out.count("fig5-7/rmat1_s7/") == 24 and out.count("family/rmat1_s7/") == 3
    assert out.count("partition/rmat1_s7/") == 8
    saved = json.loads((tmp_path / "variants.json").read_text())
    assert len(saved) == 27 and all(r["ok"] for r in saved)
    assert len(json.loads((tmp_path / "partition.json").read_text())) == 8
    # from the hub: the most out-edges, a longer solve than vertex 0's
    assert variants.main(["--quick", "--scale", "7", "--device", "cpu", "--source",
                          "hub", "--json", "--out", str(tmp_path / "hub")]) == 0
    g = variants.rmat1(7, seed=variants.SEED)
    hub = json.loads((tmp_path / "hub" / "variants.json").read_text())
    assert {r["source"] for r in hub} == {variants.pick_source(g, "hub")}
    assert variants.pick_source(g, "hub") == int(np.bincount(g.src).argmax())
    assert all(r["ok"] for r in hub)
    capsys.readouterr()

    quick = variants.run
    monkeypatch.setattr(variants, "run",
                        lambda scale, device=None: quick(7, quick=True, device=device))
    assert bench_run.main(["--fast", "--device", "cpu", "--json",
                           "--out", str(tmp_path / "run")]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,us_per_call,derived" and len(out) == 28
    assert (tmp_path / "run" / "variants.json").exists()
