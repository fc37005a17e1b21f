"""Op-wise per-superstep profile of the port's engine.

The roofline model (:mod:`repro_torch.roofline.model`) reads a whole
step; work on the superstep loop needs the per-superstep view: which ops
move the device-memory bytes, what the collectives send, and what the
frontier kernels save.  The JAX package compiles its loop and walks the
while body's HLO.  The port's loop runs eagerly, so
:func:`superstep_profile` runs the engine (``core/engine.py``) under an
:class:`~repro_torch.roofline.ops.OpRecorder` on
:class:`~repro_torch.roofline.ops.RecordingRanks` and charges every op
it ran (``roofline/ops.py``).  The set-up and the closing read of a run
are recorded alone (a run of no superstep) and taken off.

A frontier kernel is charged its closed form on either route
(``roofline/kernels.py``).  For a kernel config the profile also gives
the plain torch relax's charge (``relax_impl="ref"`` on the same state):

    hbm_bytes_unfused       the same supersteps through the plain relax
    relax_region_bytes      its push relax region alone, a rank, at the
                            row capacity (recorded on the meta device)
    kernel_bytes            the closed form of one kernel call a rank
                            (``fused_kernel_bytes`` for ``/fused``)

which is the fusion's value: the (F, W) candidates and the scatter's
intermediates never go through device memory.  On the card the profile
adds the device time of the same run (``torch.profiler``, the least of
three windows), the memory bound of the charged bytes and its share of
that time.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.engine import EngineConfig, initial_state, run_engine
from repro_torch.core.frontier import frontier_caps, payload_plane_words
from repro_torch.graph.generators import rmat1
from repro_torch.graph.partition import PartitionedGraph, partition_graph
from repro_torch.kernels import _lib
from repro_torch.roofline.kernels import fused_kernel_bytes, push_gather_bytes
from repro_torch.roofline.model import HBM_BW, LINK_BW
from repro_torch.roofline.ops import (
    OpRecorder,
    RecordingRanks,
    collective_bytes,
    op_traffic,
)

#: default partition shape of a seeded graph, as analyze's StepShape
#: (roofline cannot import it: analyze imports roofline)
DEFAULT_SHAPE = {"n_local": 64, "rows": 80, "width": 8}

#: timed runs on the card, the least taken (device time and wall)
TIMING_RUNS = 3

#: the frontier op a kernel relax_impl calls for one lane
KERNEL_OPS = {"fused": "fused_superstep", "push": "relax_push_gather"}


def seeded_partition(n_local: int, n_parts: int, width: int,
                     seed: int = 0) -> PartitionedGraph:
    """rmat1 on ``n_parts × n_local`` vertices (a power of two), seeded,
    block-partitioned over ``n_parts`` ranks at ELL width ``width``."""
    n = n_parts * n_local
    if n < 2 or n & (n - 1):
        raise ValueError(
            f"n_parts × n_local = {n} must be a power of two (an R-MAT's "
            "vertex count)")
    return partition_graph(rmat1(n.bit_length() - 1, seed=seed), n_parts,
                           width=width)


def kernel_applies(ecfg: EngineConfig) -> bool:
    """Whether ``ecfg``'s sparse relax goes through a frontier kernel:
    a kernel relax_impl, min-plus ``sssp`` processing and no level
    plane (``core/engine.py``'s rule)."""
    return (ecfg.relax_impl in ("fused", "push")
            and ecfg.exchange in ("sparse", "auto")
            and ecfg.processing.name == "sssp"
            and not ecfg.hierarchy.needs_level)


def _relax_region(D, f_idx, row_src, col, wgt, n_pad: int):
    """The engine's plain push relax of one rank (``core/engine.py``,
    ``relax_push`` with relax_impl 'ref'), op for op: gather the F
    listed rows (fill rows take the dummy source and the padding
    column), form min-plus candidates, scatter-min them through spill
    columns."""
    R, W = col.shape
    n_local = D.shape[0] - 1
    F = f_idx.shape[0]
    fi = f_idx.to(torch.int64)
    valid = fi < R
    fic = fi.clamp(max=R - 1)
    srcg = torch.where(valid, torch.gather(row_src, 0, fic), n_local)
    strip = fic[:, None].expand(F, W)
    colg = torch.where(valid[:, None], torch.gather(col, 0, strip), n_pad)
    wgtg = torch.where(valid[:, None], torch.gather(wgt, 0, strip),
                       float("inf"))
    cand = torch.gather(D, 0, srcg)[:, None] + wgtg
    spill = torch.arange(n_pad, n_pad + F, device=D.device)[:, None]
    idx = torch.where(colg == n_pad, spill, colg)
    buf = torch.full((n_pad + F,), float("inf"), dtype=torch.float32,
                     device=D.device)
    buf.scatter_reduce_(0, idx.reshape(-1), cand.reshape(-1), "amin")
    return buf[:n_pad]


def relax_region_bytes(ecfg: EngineConfig, shape: Optional[dict] = None,
                       n_parts: int = 1) -> int:
    """Charged bytes of the plain push relax region of one rank at
    ``ecfg``'s frontier shapes (row capacity F of ``shape``), recorded
    on the meta device: the charge depends on shapes alone."""
    sh = dict(DEFAULT_SHAPE, **(shape or {}))
    R, W, nl = sh["rows"], sh["width"], sh["n_local"]
    row_cap, _ = frontier_caps(R, W, nl, n_parts, ecfg.frontier_cap)
    meta = torch.device("meta")
    args = (
        torch.empty(nl + 1, dtype=torch.float32, device=meta),
        torch.empty(row_cap, dtype=torch.int32, device=meta),
        torch.empty(R, dtype=torch.int64, device=meta),
        torch.empty((R, W), dtype=torch.int32, device=meta),
        torch.empty((R, W), dtype=torch.float32, device=meta),
    )
    with OpRecorder() as rec:
        _relax_region(*args, n_parts * nl)
    return int(op_traffic(rec.records)["total_bytes"])


def _as_partition(shape_or_graph) -> PartitionedGraph:
    if isinstance(shape_or_graph, PartitionedGraph):
        return shape_or_graph
    sh = dict(DEFAULT_SHAPE, **dict(shape_or_graph or {}))
    return seeded_partition(sh["n_local"], sh.get("n_parts", 1), sh["width"])


def _run(ecfg, ell, pg, state, ranks=None):
    """One run from copies of ``state``, (D, T, L) on ``ell``'s device."""
    D, T, L = (a.clone() for a in state)
    return run_engine(ecfg, ell, pg.n_local, D, T, L, ranks=ranks)


def _recorded(ecfg, ell, pg, state):
    """(per-op bytes, collective traffic, supersteps, recorder) of a run
    less its set-up: the run, and a run of no superstep, recorded."""
    out = []
    for cfg in (dataclasses.replace(ecfg, max_iters=0), ecfg):
        ranks = RecordingRanks(pg.n_parts)
        with OpRecorder() as rec:
            res = _run(cfg, ell, pg, state, ranks)
        out.append((op_traffic(rec.records, top=None)["by_op"],
                    collective_bytes(ranks), res.supersteps, rec))
    (ops0, coll0, _, _), (ops1, coll1, steps, rec) = out
    by_op = {k: v - ops0.get(k, 0) for k, v in ops1.items()}
    coll = {
        "bytes": {k: v - coll0["bytes"].get(k, 0)
                  for k, v in coll1["bytes"].items()},
        "counts": {k: v - coll0["counts"].get(k, 0)
                   for k, v in coll1["counts"].items()},
    }
    return by_op, coll, steps, rec


def _device_ms(ecfg, ell, pg, state) -> float:
    """Device time of one run less its set-up (a run of no superstep),
    by torch.profiler's kernel records: TIMING_RUNS windows each, in
    turns, each right after an unprofiled run of the same.  A window
    that recorded fewer kernels than another of the same run lost some
    (a profiler window can) and is dropped; of the rest the least
    counts (a lone superstep's time varies from window to window)."""
    from torch.profiler import ProfilerActivity, profile

    windows = ([], [])  # (kernels recorded, ms) a window
    for _ in range(TIMING_RUNS):
        for cfg, out in zip((dataclasses.replace(ecfg, max_iters=0), ecfg),
                            windows):
            _run(cfg, ell, pg, state)  # warm: clocks, cached blocks
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                _run(cfg, ell, pg, state)
                torch.cuda.synchronize()
            ev = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
            out.append((sum(e.count for e in ev),
                        sum(e.self_device_time_total for e in ev) / 1e3))

    def least_whole(ws):
        most = max(n for n, _ in ws)
        return min(ms for n, ms in ws if n == most)

    return least_whole(windows[1]) - least_whole(windows[0])


def _wall_s(ecfg, ell, pg, state) -> float:
    """Host wall of one warm run: the least of TIMING_RUNS."""
    walls = []
    for _ in range(TIMING_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _run(ecfg, ell, pg, state)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return min(walls)


def superstep_profile(
    ecfg: EngineConfig,
    shape_or_graph=None,
    device=None,
    *,
    state=None,
    source: int = 0,
    top: Optional[int] = 8,
) -> dict:
    """Op-wise per-superstep device-memory and collective profile of
    ``ecfg`` on one card.

    ``shape_or_graph``: a shape dict (``n_local``, ``width``, optional
    ``n_parts``; a seeded R-MAT of that shape) or a
    :class:`PartitionedGraph`.
    ``state``: (D, T, L) arrays of (P, n_local+1) to run exactly one
    superstep from; None runs the whole solve from ``source``.  The
    ranks are stacked on ``device`` (None: the card).  Bytes are the
    card's, over all its ranks; ``hbm_by_op`` holds the ``top`` ops
    (None: all)."""
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    pg = _as_partition(shape_or_graph)
    P, nl, R, W = pg.n_parts, pg.n_local, pg.rows_per_rank, pg.width
    sh = {"n_local": nl, "rows": R, "width": W}
    ell = pg.to(dev)
    p = ecfg.processing
    if state is None:
        state = initial_state(pg, p, [(source, p.initial_value(source), 0)])
    else:
        ecfg = dataclasses.replace(ecfg, max_iters=1)
    # on the device once: a host copy inside a timed window is no part of
    # a superstep (and a pageable one varies by a millisecond)
    state = tuple((a if isinstance(a, torch.Tensor)
                   else torch.as_tensor(np.asarray(a))).to(dev) for a in state)
    if ecfg.adapt_window:
        ecfg = dataclasses.replace(ecfg, adapt_window=0)
    _run(ecfg, ell, pg, state)  # warm
    by_op, coll, steps, rec = _recorded(ecfg, ell, pg, state)
    n = max(steps, 1)
    hbm = int(sum(by_op.values()))
    row_cap, slot_cap = frontier_caps(R, W, nl, P, ecfg.frontier_cap)
    xwords = payload_plane_words(slot_cap, ecfg.hierarchy.needs_level,
                                 ecfg.payload)
    ranked = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]  # None: all
    prof = {
        "relax_impl": ecfg.relax_impl,
        "payload": ecfg.payload,
        "n_parts": P,
        "shape": sh,
        "supersteps": steps,
        "hbm_bytes_total": hbm,
        "hbm_bytes_per_superstep": hbm // n,
        "hbm_by_op": {k: v // n for k, v in ranked},
        "collective_bytes_per_superstep":
            int(sum(coll["bytes"].values())) // n,
        "collective_counts": {k: v / n for k, v in coll["counts"].items()},
        "exchange_payload_bytes_per_superstep": 4 * max(P - 1, 0) * xwords,
        "kernel_calls": {f"{k}/{route}": c
                         for (k, route), c in rec.kernel_calls.items()},
        "t_memory_ms": hbm / HBM_BW * 1e3,
        "t_collective_ms": int(sum(coll["bytes"].values())) / LINK_BW * 1e3,
    }
    if kernel_applies(ecfg):
        kernel = KERNEL_OPS[ecfg.relax_impl]
        base = dataclasses.replace(ecfg, relax_impl="ref")
        ref_ops, _, ref_steps, _ = _recorded(base, ell, pg, state)
        prof["hbm_bytes_unfused"] = int(sum(ref_ops.values())) // max(ref_steps, 1)
        prof["relax_region_bytes"] = relax_region_bytes(ecfg, sh, P)
        one = (fused_kernel_bytes(row_cap, W, nl, P * nl)
               if ecfg.relax_impl == "fused" else push_gather_bytes(row_cap, W, nl))
        prof["kernel"] = kernel
        prof["kernel_bytes"] = one
        if ecfg.relax_impl == "fused":
            prof["fused_kernel_bytes"] = one
    if dev.type == "cuda":
        launches0 = _lib.launch_counts()
        dev_ms = _device_ms(ecfg, ell, pg, state)
        prof["launches"] = {k: (v - launches0[k]) // (2 * TIMING_RUNS)
                            for k, v in _lib.launch_counts().items()
                            if v - launches0[k]}
        prof["wall_s"] = _wall_s(ecfg, ell, pg, state)
        bound_ms = max(prof["t_memory_ms"], prof["t_collective_ms"])
        prof["device_ms"] = dev_ms
        prof["bound_ms"] = bound_ms
        prof["bound_share"] = bound_ms / dev_ms if dev_ms else None
    return prof
