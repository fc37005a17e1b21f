"""repro_torch.roofline on the CPU: the H100 model's terms and bound,
the op recorder's charges, the kernels' closed forms against the JAX
package's formula and against byte counts the smoke run printed, and
the superstep profile (the all-to-all a sparse superstep records
equals the closed-form payload, as the JAX package computes it)."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core.frontier import frontier_caps as ref_frontier_caps
from repro.core.frontier import payload_plane_words as ref_plane_words
from repro.roofline import superstep as ref_superstep
from repro_torch import kernels as K
from repro_torch.api import Problem, SingleSource, Solver, SolverConfig, get_processing
from repro_torch.core.engine import initial_state, run_engine
from repro_torch.roofline import (
    HBM_BW,
    LINK_BW,
    OpRecorder,
    RecordingRanks,
    Roofline,
    bound,
    collective_bytes,
    flops_and_bytes,
    from_record,
    fused_kernel_bytes,
    op_traffic,
    relax_region_bytes,
    seeded_partition,
    superstep_profile,
)
from repro_torch.roofline import kernels as closed
from repro_torch.roofline.superstep import _relax_region

SHAPE4 = {"n_local": 64, "width": 8, "n_parts": 4}


def ecfg(spec, **kw):
    return SolverConfig.from_spec(spec, **kw).engine_config(get_processing("sssp"))


@pytest.fixture(scope="module")
def pg4():
    return seeded_partition(64, 4, 8)


# ---------------------------------------------------------------- model


def test_roofline_terms_on_the_h100():
    r = Roofline(arch="a", cell="c", mesh="m", chips=4,
                 hlo_flops=989e12, hlo_bytes=HBM_BW * 2, coll_bytes=LINK_BW * 0.5,
                 model_flops=989e12 * 4 * 0.5)
    assert abs(r.t_compute - 1.0) < 1e-9 and abs(r.t_memory - 2.0) < 1e-9
    assert abs(r.t_collective - 0.5) < 1e-9 and r.dominant == "memory"
    assert abs(r.useful_ratio - 0.5) < 1e-9 and abs(r.roofline_fraction - 0.25) < 1e-9
    f32 = dataclasses.replace(r, dtype="float32")
    assert abs(f32.t_compute - 989 / 67) < 1e-9 and f32.dominant == "compute"
    assert r.row()["dtype"] == "bfloat16"


def test_from_record_probe_correction():
    rec = {
        "arch": "a", "cell": "c", "mesh": "m", "chips": 2, "dtype": "float32",
        "cost": {"flops": 999.0, "bytes accessed": 999.0},
        "collectives": {"total_bytes": 999}, "model_flops": 100.0,
        "probes": {"n_layers": 10,
                   "L1": {"flops": 30.0, "bytes": 20.0, "collective_bytes": 4},
                   "L2": {"flops": 40.0, "bytes": 25.0, "collective_bytes": 6}},
    }
    r = from_record(rec)
    assert (r.hlo_flops, r.hlo_bytes, r.coll_bytes) == (120, 65, 22)
    assert r.peak == 67e12


def test_bound_and_closed_forms_match_the_smoke_runs_numbers():
    # phase 3 and 10 lines of the smoke run on the H100 (bytes; bound ms)
    assert round(bound(76438512, 0)[0], 4) == 0.0228
    assert bound(76438512, 0)[1] == "bytes"
    assert round(bound(735303356, 1)[0], 4) == 0.2195
    nbytes, flops = closed.flash_attention_traffic(4, 32, 8, 2048, 2048, 128, True, 2)
    assert (nbytes, flops) == (167772160, 137506062336)
    ms, by = bound(nbytes, flops, 989e12)
    assert by == "operations" and round(ms, 4) == 0.1390
    assert closed.spmm_ell_traffic(2887373, 64, 1244750, 100, 63538872, "sum") == \
        (3131184176, 2 * 63538872 * 100)
    assert closed.spmm_ell_traffic(2887373, 64, 1244749, 100, 63538872, "max")[0] == \
        3131183776


@pytest.mark.parametrize("row_cap,width,n_local,n_pad", [
    (10, 8, 64, 256), (177109, 64, 1048576, 1048576), (1, 1, 1, 1),
    (44277, 64, 262144, 1048576), (333, 33, 1000, 4000),
])
def test_fused_kernel_bytes_equals_reference(row_cap, width, n_local, n_pad):
    assert fused_kernel_bytes(row_cap, width, n_local, n_pad) == \
        ref_superstep.fused_kernel_bytes(row_cap, width, n_local, n_pad)


# -------------------------------------------------------------- recorder


def test_recorder_charges_ops_host_reads_and_writes():
    x = torch.arange(64, dtype=torch.float32)
    w = torch.ones(8, 8)
    with OpRecorder() as rec:
        y = x + 1                      # 256 in, 256 out
        v = y.view(8, 8)               # free
        z = v @ w                      # mm: 2·8·8·8
        z.add_(1.0)                    # in place on a fresh tensor
        n = int(z.sum()) + len(y.tolist()) + bool(y[0] > 0)
    assert n > 0
    t = op_traffic(rec.records, top=None)
    assert t["by_op"]["aten.add"] == 512
    assert "aten.view" not in t["by_op"]
    assert rec.host_reads == ["__int__", "tolist", "__bool__"]
    flops, byts = flops_and_bytes(rec.records)
    assert flops >= 2 * 8 * 8 * 8 and byts == t["total_bytes"]
    assert z.untyped_storage().data_ptr() in rec.writes
    assert x.untyped_storage().data_ptr() not in rec.writes


def test_recorder_makes_frontier_kernel_calls_opaque(pg4):
    """A frontier op's call is one record of its closed form, on either
    route; the plain version's aten ops are not charged."""
    p = get_processing("sssp")
    D, T, L = (torch.as_tensor(a) for a in initial_state(pg4, p, [(0, 0.0, 0)]))
    ell = pg4.to("cpu")
    K.reset_launch_counts()
    with OpRecorder() as rec:
        run_engine(ecfg("delta:5/sparse/fused"), ell, pg4.n_local, D, T, L)
    calls = rec.kernel_calls["fused_superstep", "ref"]
    assert calls > 0 and K.call_counts()["fused_superstep"] == {"cuda": 0, "ref": calls}
    kern = [r for r in rec.records if r.op == "kernel.fused_superstep"]
    row_cap, _ = ref_frontier_caps(pg4.rows_per_rank, 8, 64, 4)
    assert len(kern) == calls
    assert kern[0].out_bytes == fused_kernel_bytes(row_cap, 8, 64, 256)


def test_recording_ranks_tally_as_process_ranks(pg4):
    ranks = RecordingRanks(4)
    X = torch.zeros(1, 4, 4, 10)
    ranks.all_to_all(X)
    ranks.vote(torch.zeros(2, 1, 4, dtype=torch.int32))
    ranks.sum(torch.zeros(1, dtype=torch.int64))
    c = collective_bytes(ranks)
    assert c["counts"] == {"all_to_all": 1, "all_reduce": 2}
    assert c["bytes"] == {"all_to_all": 3 * 10 * 4, "all_reduce": 8 + 8}


# ------------------------------------------------------------- superstep


def test_relax_region_is_shape_only():
    """The region's charge on the meta device equals the same ops on
    real CPU tensors."""
    R, W, nl, F = 80, 8, 64, 10
    args = (torch.zeros(nl + 1), torch.arange(F, dtype=torch.int32),
            torch.zeros(R, dtype=torch.int64), torch.zeros((R, W), dtype=torch.int32),
            torch.zeros(R, W))
    with OpRecorder() as rec:
        _relax_region(*args, 4 * nl)
    assert op_traffic(rec.records)["total_bytes"] == relax_region_bytes(
        ecfg("delta:5/sparse/fused"), {"n_local": nl, "rows": R, "width": W}, 4)


def test_sparse_step_records_the_closed_form_payload(pg4):
    """One sparse superstep at P 4: the all-to-all bytes a rank sends
    equal 4·(P-1)·payload words, the JAX package's closed form."""
    p = get_processing("sssp")
    cfg = dataclasses.replace(ecfg("delta:5/sparse"), max_iters=1)
    D, T, L = (torch.as_tensor(a) for a in initial_state(pg4, p, [(0, 0.0, 0)]))
    ranks = RecordingRanks(4)
    run_engine(cfg, pg4.to("cpu"), pg4.n_local, D, T, L, ranks=ranks)
    _, slot_cap = ref_frontier_caps(pg4.rows_per_rank, 8, 64, 4)
    closed_form = 4 * 3 * ref_plane_words(slot_cap, False, "exact")
    assert [c for c in ranks.calls if c[0] == "all_to_all"][0][1] == closed_form
    prof = superstep_profile(cfg, pg4, "cpu", state=initial_state(
        pg4, p, [(0, 0.0, 0)]))
    assert prof["supersteps"] == 1
    assert prof["exchange_payload_bytes_per_superstep"] == closed_form
    assert prof["collective_counts"]["all_to_all"] == 1


def test_profile_keys_equal_reference_at_one_rank():
    """The JAX package's profile (its compiled while body, one device)
    and the port's (a recorded run) name the same keys and the same
    exchange and fused-kernel terms."""
    import jax

    from repro.api import SolverConfig as RefConfig
    from repro.api import get_processing as ref_get

    cfg = ecfg("delta:5/sparse/fused")
    ref = ref_superstep.superstep_profile(
        RefConfig.from_spec("delta:5/sparse/fused").engine_config(ref_get("sssp")),
        mesh=jax.make_mesh((1,), ("data",)))
    got = superstep_profile(cfg, {"n_local": 64, "width": 8}, "cpu")
    assert set(ref) <= set(got)
    assert got["exchange_payload_bytes_per_superstep"] == \
        ref["exchange_payload_bytes_per_superstep"] == 0
    sh = got["shape"]
    row_cap, _ = ref_frontier_caps(sh["rows"], sh["width"], sh["n_local"], 1)
    assert got["fused_kernel_bytes"] == ref_superstep.fused_kernel_bytes(
        row_cap, sh["width"], sh["n_local"], sh["n_local"])


@pytest.mark.parametrize("spec,impl", [("delta:5/sparse/fused", "fused"),
                                       ("delta:5/sparse", "push"),
                                       ("delta:5/a2a", "ref")])
def test_profile_at_four_ranks(spec, impl):
    cfg = ecfg(spec, relax_impl=impl)
    prof = superstep_profile(cfg, SHAPE4, "cpu", top=None)
    solve = Solver(SolverConfig.from_spec(spec, relax_impl=impl), n_parts=4,
                   device="cpu").solve(Problem(seeded_partition(64, 4, 8),
                                               SingleSource(0)))
    assert prof["supersteps"] == solve.metrics.supersteps
    assert prof["hbm_bytes_per_superstep"] > 0
    assert prof["t_memory_ms"] == pytest.approx(prof["hbm_bytes_total"] / HBM_BW * 1e3)
    if impl == "ref":
        assert "kernel_bytes" not in prof and not prof["kernel_calls"]
        return
    kernel = "fused_superstep" if impl == "fused" else "relax_push_gather"
    assert f"kernel.{kernel}" in prof["hbm_by_op"]
    assert prof["kernel_calls"][f"{kernel}/ref"] > 0
    # the kernel route charges less than the plain relax of the same steps
    assert prof["hbm_bytes_per_superstep"] < prof["hbm_bytes_unfused"]
    assert prof["relax_region_bytes"] > prof["kernel_bytes"] > 0
    assert np.isfinite(prof["collective_bytes_per_superstep"])
