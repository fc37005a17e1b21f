"""Dry-run of the port's cells: shapes, bytes and a peak memory plan a
card, on the meta device.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --ranks 1 4
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch sssp \\
        --cell road27_delta_nodeq_a2a --ranks 4

The JAX package's dry-run (``repro/launch/dryrun.py``) lowers and
compiles every cell on 512 placeholder devices and reads XLA's memory
analysis.  The port compiles nothing, so this plans from the shapes of
each cell's :class:`~repro_torch.configs.cells.CellPlan`, as the
reference plans from ``ShapeDtypeStruct``s.  Per cell and rank count it
writes one record to ``<out>/<arch>__<cell>__P<ranks>.json``:

    arg_bytes, arg_bytes_per_card   exact from the plan's meta tensors
    peak_bytes_per_card             SSSP only: :func:`superstep_peak`
    fits_one_card                   within one H100's 80 GB (a model
                                    cell: its arguments alone; planned,
                                    never measured)
    model_flops, notes, ok | error

A card runs one rank: an SSSP plan at P ranks holds 1/P of the stacked
arguments a card, as the process backend (``core/ranks.py``) does; an
LM plan at P ranks holds each argument's block on its ``dp x tp`` grid
(tp = min(P, 16): the JAX package's specs, ``configs/cells.py``, a
train cell's AdamW state by ``optimizer.state_specs``), as
``models/lm.py`` serves and trains across ranks; a MIND or GNN cell
holds all its arguments (a train cell's: params, AdamW state, batch and
step) on every card (MIND and the GNNs across ranks, and MLA under TP,
are still to be ported: ``ROADMAP.md`` Queue 1).  Nothing here builds a
graph, runs an engine loop or a model forward, or reaches a kernel: a
meta tensor has no values for the engine's host reads, and no kernel op
takes one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

from torch.utils._pytree import tree_leaves

from repro_torch.core.frontier import frontier_caps, payload_plane_words
from repro_torch.core.processing import SSSP

#: device memory of one NVIDIA H100 80GB, as its data sheet gives it
CARD_BYTES = 80 * 10**9

F32, I32, I64, BOOL = 4, 4, 8, 1


def superstep_peak(plan) -> dict:
    """Peak device bytes a card of one superstep of an SSSP plan, from
    its shape (``plan.shape``) and solver configuration, one rank a
    card.  The sum of

      resident     the rank's ELL slice and state planes (the plan's
                   arguments a card) and the per-row relaxation degree
                   the engine keeps beside them (``DeviceELL.row_deg``,
                   int64 a row);
      run          what the loop holds across a superstep
                   (``core/engine.py::_run``): row_src widened to int64,
                   the eligible row mask, the loop's D and T (and L),
                   the eligible vertex mask;
      temporaries  the largest live set of one superstep's branch: the
                   dense ELL sweep (``relax_dense``: the (R, W) f32
                   candidates, the padding mask, the int64 scatter index
                   with its spill columns and the int64 copy of the
                   int32 columns that ``torch.where`` makes to promote
                   them, and with a level plane the level candidates and
                   the win mask), the sparse push relax at the row
                   capacity F (the plain gather, the gather kernel's
                   (F, W) candidates, or the fused kernel's output
                   alone), or the sparse exchange's slotting
                   (``core/frontier.py::bucket_slots``: int64 planes over
                   the padded vertices).

    A sparse cell counts the dense sweep too: a superstep whose
    frontier overflows F takes it (the one-rank main solve at rmat1
    scale 20 does once).  Small (n,)-sized scalars and the allocator's
    rounding are left out."""
    sh = plan.shape
    P, nl, R, W = sh["n_parts"], sh["n_local"], sh["rows"], sh["width"]
    ecfg = plan.config.engine_config(SSSP)
    level = ecfg.hierarchy.needs_level
    n_pad = P * nl
    RW = R * W
    state = (nl + 1) * F32
    resident = plan.arg_bytes // P + R * I64
    run = R * I64 + R * BOOL + (3 if level else 2) * state + (nl + 1) * BOOL
    buf = (n_pad + R) * F32  # the scatter's output with its spill columns

    def scatter(A: int, AW: int, narrow: bool) -> int:
        """``scatter`` at its index ``where``: the padding mask, the int64
        index and spill columns, and for int32 columns (``narrow``) the
        int64 copy ``where`` makes of them to promote them to the spill
        columns' dtype; then mask and copy give way to the output."""
        return AW * I64 + A * I64 + max(AW * (BOOL + narrow * I64),
                                        (n_pad + A) * F32)

    branches = {}
    # dense sweep: src_val (R,) and the (R, W) candidates, then the scatter
    dense = R * F32 + RW * F32 + scatter(R, RW, narrow=True)
    if level:
        # the value scatter's output stays (C); the level candidates, the
        # live-slot mask, col widened to int64, the win mask and the
        # masked level values ride into the second scatter
        dense = max(dense, R * F32 + RW * F32 + buf
                    + RW * (BOOL + F32 + I64 + BOOL + F32)
                    + scatter(R, RW, narrow=False))
    branches["dense"] = dense
    sparse = ecfg.exchange in ("sparse", "auto")
    if sparse:
        F, slot_cap = frontier_caps(R, W, nl, P, ecfg.frontier_cap)
        FW = F * W
        kernel = (ecfg.relax_impl in ("fused", "push") and not level
                  and ecfg.processing.name == "sssp")
        # compact_rows: running counts and targets over R, int64
        compact = 4 * R * I64 + R * I32 + (F + R) * I32
        if kernel and ecfg.relax_impl == "fused":
            push = 2 * (n_pad + 1) * F32
        elif kernel:  # gather kernel, then the torch scatter-min
            push = FW * F32 + FW * I32 + scatter(F, FW, narrow=True)
        else:  # the plain gather: index, columns, weights, candidates
            push = F * 4 * I64 + 3 * FW * F32 + scatter(F, FW, narrow=True)
            if level:
                push = max(push, F * 4 * I64 + 3 * FW * F32 + buf
                           + FW * (BOOL + F32 + I64 + BOOL + F32)
                           + scatter(F, FW, narrow=False))
        branches["push"] = compact + push
        planes = (2 if level else 1)
        words = payload_plane_words(slot_cap, level, ecfg.payload)
        # bucket_slots at its slot `where`: the position, the spill
        # arange and the slot, int64, beside the candidate mask; then
        # the payload planes and the received copy
        branches["exchange"] = (planes * buf + n_pad * BOOL + 3 * n_pad * I64
                                + (planes + 1) * (n_pad + P * slot_cap) * F32
                                + 2 * P * words * F32)
    else:
        # a2a / pmin: the candidates' copy through the collective
        branches["exchange"] = (2 if level else 1) * (buf + 2 * n_pad * F32)
    branch = max(branches, key=branches.get)
    temporaries = branches[branch]
    return dict(resident=resident, run=run, temporaries=temporaries,
                branch=branch, branches=branches,
                peak=resident + run + temporaries)


def plan_record(plan, family: str) -> dict:
    """The dry-run record of one plan (the module docstring)."""
    ranks = plan.ranks
    rec = dict(
        arch=plan.arch, cell=plan.cell, kind=plan.kind, family=family,
        ranks=ranks, arg_bytes=plan.arg_bytes, model_flops=plan.model_flops,
        notes=plan.notes, card_bytes=CARD_BYTES,
        args=[(list(t.shape), str(t.dtype).split(".")[-1])
              for t in tree_leaves(plan.args)],
    )
    if plan.kind == "sssp":
        peak = superstep_peak(plan)
        rec.update(
            shape=plan.shape, spec=plan.config.name,
            arg_bytes_per_card=plan.arg_bytes // ranks,
            resident_bytes_per_card=peak["resident"],
            peak_bytes_per_card=peak["peak"],
            peak_terms=peak,
            fits_one_card=peak["peak"] <= CARD_BYTES,
        )
    else:
        per_card = plan.arg_bytes_per_card
        rec.update(arg_bytes_per_card=per_card,
                   peak_bytes_per_card=None,
                   fits_one_card=per_card <= CARD_BYTES,
                   fits_basis="planned from the arguments alone (no activation "
                              "plan), not measured")
        if plan.grid is not None:
            rec["grid"] = dict(zip(plan.grid.axis_names, plan.grid.grid.shape))
    return rec


def run_cell(arch_id: str, cell: str, ranks: int, out_dir: str,
             force: bool = False, verbose: bool = True) -> dict:
    from repro_torch.configs import get_arch

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(
        out_dir, f"{arch_id}__{cell}__P{ranks}.json".replace("/", "_"))
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    rec = dict(arch=arch_id, cell=cell, ranks=ranks, ok=False)
    t0 = time.time()
    try:
        mod = get_arch(arch_id)
        rec = plan_record(mod.make_cell(cell, ranks), mod.FAMILY)
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 — the record keeps the failure
        rec.update(error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    rec["t_plan_s"] = round(time.time() - t0, 4)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    if verbose:
        print(summary_line(rec), flush=True)
    return rec


def summary_line(rec: dict) -> str:
    if not rec["ok"]:
        return (f"[dryrun] {rec['arch']:16s} {rec['cell']:28s} P{rec['ranks']} "
                f"FAIL {rec['error']}")
    peak = rec["peak_bytes_per_card"]
    peak_s = "-" if peak is None else f"{peak / 1e9:.3f} GB"
    fits = "fits one card" if rec["fits_one_card"] else "does not fit one card"
    fits += " (planned, not measured)"
    return (f"[dryrun] {rec['arch']:16s} {rec['cell']:28s} P{rec['ranks']} ok: "
            f"args {rec['arg_bytes_per_card'] / 1e9:.3f} GB a card, "
            f"peak {peak_s} a card, {fits}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="meta-device dry-run of the "
                                 "port's cells")
    ap.add_argument("--arch")
    ap.add_argument("--cell")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--ranks", type=int, nargs="+", default=[1],
                    help="rank counts to plan each cell at, one rank a card")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    from repro_torch.configs import all_cells

    if args.all:
        cells = all_cells()
    elif args.arch and args.cell:
        cells = [(args.arch, args.cell)]
    else:
        ap.error("give --arch and --cell, or --all")
    if any(r < 1 for r in args.ranks):
        ap.error(f"rank counts must be positive: {args.ranks}")

    failures = 0
    for ranks in args.ranks:
        for arch_id, cell in cells:
            rec = run_cell(arch_id, cell, ranks, args.out, args.force)
            failures += 0 if rec.get("ok") else 1
    if failures:
        sys.exit(f"{failures} cell(s) failed")
    print(f"dry-run complete: {len(cells)} cells at ranks {args.ranks} planned")


if __name__ == "__main__":
    main()
