"""Engine lint: run the superstep loop on a small seeded graph and check
what it did.

The JAX package traces its engine to a jaxpr and compiles it to HLO
without running it (``analyze/jaxpr_lint.py``, ``analyze/hlo_lint.py``
there).  The port's engine runs eagerly, so there is no program to read
before it runs.  Instead :func:`lint_engine` runs the engine
(``core/engine.py``) for at most ``StepShape.supersteps`` supersteps on
a seeded R-MAT of ``n_parts × n_local`` vertices, partitioned at
``shape.width``, with every rank stacked on one device through
:class:`~repro_torch.roofline.ops.RecordingRanks`, and records its aten
ops and host reads with :class:`~repro_torch.roofline.ops.OpRecorder`.
Rules:

  host-sync            host reads a superstep.  The engine reads the
                       host by design: the pending count every
                       superstep, and on the sparse path the frontier's
                       overflow flag and (unless ``auto`` is statically
                       dense) the exchange vote; plus one read of the
                       counters a run (:func:`host_sync_budget`).  The
                       count is reported as info; more than the budget
                       is a warn.  The counterpart of ``host-callback``.
  f64-promotion        any float64 tensor in the step (int64 is allowed:
                       it is torch's index type for gather and scatter).
  payload-overflow     an all-to-all payload whose dtype cannot
                       represent the vertex-index range (the quantized
                       exchange must keep an exact index plane).
  payload-plane        a sparse exchange's all-to-all payload whose last
                       axis is neither the planes × slot_cap word count
                       nor the dense n_local.
  fused-kernel-escape  a ``/fused`` spec, or a push spec, on the sparse
                       path whose step never called its kernel op (a
                       non-min-plus processing or a level-bearing
                       hierarchy takes the plain relax).  On the CPU the
                       op's calls on the plain route count
                       (``kernels/_lib.py::call_counts``); on the card
                       its launches (``launch_counts``).
  collective-plan      at P > 1, the recorded collectives against
                       :func:`expected_collectives` (the counterpart of
                       ``hlo-collective-plan``).
  step-fails           the engine raised (the counterpart of
                       ``trace-fails`` and ``hlo-compile-fails``).
  engine-stats         info: supersteps, host reads, kernel calls,
                       collectives and the bytes they send, and the
                       charged device-memory bytes.

Rules of the JAX package with no counterpart here: ``weak-scalar`` (an
eager program has no jit cache for a Python constant to fork),
``dead-branch`` (control flow is Python: a branch not taken is never
run), and ``hlo-f64`` / ``hlo-host-call`` (``f64-promotion`` and
``host-sync`` see every op and host read the run made, the compiled
module's view included).

:func:`lint_grid` runs one engine per distinct program: partitioners
relabel data, not programs.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.analyze.findings import Finding
from repro_torch.core.engine import EngineConfig, initial_state, run_engine
from repro_torch.core.frontier import frontier_caps, payload_plane_words
from repro_torch.kernels import _lib
from repro_torch.roofline.ops import (
    OpRecorder,
    RecordingRanks,
    collective_bytes,
    op_traffic,
)
from repro_torch.roofline.superstep import KERNEL_OPS, seeded_partition


@dataclasses.dataclass(frozen=True)
class StepShape:
    """Partition shape of the seeded graph the engine runs on: ``rows``
    is the row count the spec checks assume (the graph's partition has
    its own), ``supersteps`` the most supersteps a lint runs."""

    n_local: int = 64
    rows: int = 80
    width: int = 8
    n_parts: int = 1
    supersteps: int = 32

    @property
    def n_pad(self) -> int:
        return self.n_parts * self.n_local


#: numpy/HLO dtype names -> numpy (bf16/f8 handled separately)
_HLO_DTYPES = {
    "pred": np.bool_, "s8": np.int8, "u8": np.uint8,
    "s16": np.int16, "u16": np.uint16, "s32": np.int32,
    "u32": np.uint32, "s64": np.int64, "u64": np.uint64,
    "f16": np.float16, "f32": np.float32, "f64": np.float64,
}


def _numpy_dtype(dt: torch.dtype):
    """The numpy dtype of a torch dtype with one (not bf16, the f8s)."""
    n = dt.itemsize
    if dt == torch.bool:
        return np.dtype(np.bool_)
    if dt.is_complex:
        return np.dtype(f"c{n}")
    if dt.is_floating_point:
        return np.dtype(f"f{n}")
    return np.dtype(f"{'i' if dt.is_signed else 'u'}{n}")


def payload_index_capacity(dtype) -> int:
    """Largest vertex index a payload plane of ``dtype`` can carry
    exactly (bit-exact for integer planes, contiguous-integer range for
    float planes used arithmetically).  Accepts torch and numpy dtypes
    and HLO shape names ('u16', 'bf16', 'f8e4m3fn'); equal to the JAX
    package's for every dtype."""
    if isinstance(dtype, torch.dtype):
        if dtype == torch.bfloat16:
            return 1 << 8
        if dtype.is_floating_point and dtype.itemsize == 1:  # the float8s
            return 1 << 3
        dtype = _numpy_dtype(dtype)
    if isinstance(dtype, str) and dtype in _HLO_DTYPES:
        dtype = _HLO_DTYPES[dtype]
    elif isinstance(dtype, str) and dtype.startswith(("bf16", "f8")):
        return 1 << 8 if dtype == "bf16" else 1 << 3
    dt = np.dtype(dtype)
    if dt.kind in ("i", "u"):
        return int(np.iinfo(dt).max)
    if dt == np.float64:
        return 1 << 53
    if dt == np.float32:
        return 1 << 24
    if dt == np.float16:
        return 1 << 11
    # bf16 and the f8s — 8- and 3/2-bit mantissas
    name = getattr(dt, "name", str(dtype))
    if "bfloat16" in name or "bf16" in str(dtype):
        return 1 << 8
    return 1 << 3


def payload_capacity(dtype, n_local: int) -> tuple[bool, int]:
    """Can an exchange payload plane of ``dtype`` index ``n_local``
    vertices exactly?  Returns (ok, capacity)."""
    cap = payload_index_capacity(dtype)
    return cap >= n_local, cap


def expected_collectives(cfg: EngineConfig, n_parts: int) -> dict:
    """The collective plan a spec implies, as {operation: required}:
    True = must appear, False = must not, None = may appear.  The
    operations are ``torch.distributed``'s, as a process backend runs
    them (``core/ranks.py``)."""
    if n_parts <= 1:
        # one rank: the plan is not checked (the JAX package's modules
        # compile their collectives away there)
        return {}
    plan: dict = {"all_reduce": True}  # the pending count at minimum
    if cfg.exchange in ("a2a", "sparse", "auto"):
        plan["all_to_all"] = True
    elif cfg.exchange == "pmin":
        plan["all_to_all"] = False
    return plan


def host_sync_budget(cfg: EngineConfig, shape: StepShape,
                     rows: Optional[int] = None) -> tuple[int, int]:
    """(host reads a superstep, host reads a run) the engine makes by
    design: the pending count; on the sparse path also the frontier's
    overflow flag and, unless ``auto`` is statically dense at these
    capacities, the exchange vote; and one read of the counters a run."""
    per = 1
    if cfg.exchange in ("sparse", "auto"):
        _, slot_cap = frontier_caps(rows or shape.rows, shape.width,
                                    shape.n_local, shape.n_parts,
                                    cfg.frontier_cap)
        nplanes = 2 if cfg.hierarchy.needs_level else 1
        static_dense = cfg.exchange == "auto" and payload_plane_words(
            slot_cap, cfg.hierarchy.needs_level, cfg.payload
        ) >= nplanes * shape.n_local
        per += 1 if static_dense else 2
    return per, 1


def engine_subject(cfg: EngineConfig) -> str:
    """The spec a config stands for, as ``SolverConfig.name`` writes it
    (no partitioner: it relabels data, not the program), with the push
    relax and a processing other than sssp marked."""
    s = f"{cfg.hierarchy.name}/{cfg.exchange}"
    if cfg.relax_impl == "fused":
        s += "/fused"
    if cfg.payload != "exact":
        s += f"/q:{cfg.payload}"
    if cfg.relax_impl == "push":
        s += " [push]"
    if cfg.processing.name != "sssp":
        s += f" [{cfg.processing.name}]"
    return s


@functools.lru_cache(maxsize=8)
def _graph(n_local: int, n_parts: int, width: int):
    return seeded_partition(n_local, n_parts, width)


@dataclasses.dataclass
class StepRun:
    """What one engine run did (see :func:`run_step`)."""

    subject: str
    n_parts: int
    rows: int
    supersteps: int = 0
    host_reads: int = 0
    budget: tuple = (0, 0)
    kernel: Optional[str] = None  # the kernel op the spec asks for
    kernel_calls: int = 0         # its calls (the card: its launches)
    collectives: Optional[dict] = None
    payloads: list = dataclasses.field(default_factory=list)
    f64_ops: list = dataclasses.field(default_factory=list)
    hbm_bytes: int = 0
    error: Optional[str] = None

    def summary(self) -> dict:
        coll = self.collectives or {"counts": {}, "bytes": {}}
        return {
            "supersteps": self.supersteps,
            "host_syncs": self.host_reads,
            "host_sync_budget": self.budget[0] * self.supersteps
            + self.budget[1],
            "kernel": self.kernel,
            "kernel_calls": self.kernel_calls,
            "collectives": coll["counts"],
            "collective_bytes": coll["bytes"],
            "hbm_bytes": self.hbm_bytes,
        }


def run_step(
    cfg: EngineConfig,
    shape: StepShape = StepShape(),
    n_parts: Optional[int] = None,
    device=None,
    subject: Optional[str] = None,
) -> StepRun:
    """Run ``cfg``'s engine from vertex 0 of the seeded graph for at
    most ``shape.supersteps`` supersteps on ``n_parts`` stacked ranks
    (default ``shape.n_parts``) on ``device`` (None: the card), recorded."""
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    P = shape.n_parts if n_parts is None else int(n_parts)
    sh = dataclasses.replace(shape, n_parts=P)
    pg = _graph(sh.n_local, P, sh.width)
    run = StepRun(subject or engine_subject(cfg), P, pg.rows_per_rank)
    run.budget = host_sync_budget(cfg, sh, pg.rows_per_rank)
    if cfg.relax_impl in ("fused", "push") and cfg.exchange in ("sparse", "auto"):
        run.kernel = KERNEL_OPS[cfg.relax_impl]
    cfg = dataclasses.replace(cfg, max_iters=min(cfg.max_iters, sh.supersteps),
                              adapt_window=0)
    p = cfg.processing
    D, T, L = (torch.as_tensor(a, device=dev) for a in initial_state(
        pg, p, [(0, p.initial_value(0), 0)]))
    ell = pg.to(dev)
    ranks = RecordingRanks(P)
    launches0 = _lib.launch_counts()
    try:
        with OpRecorder() as rec:
            res = run_engine(cfg, ell, pg.n_local, D, T, L, ranks=ranks)
    except Exception as e:  # noqa: BLE001 — surface as a finding
        run.error = f"{type(e).__name__}: {e}"
        return run
    run.supersteps = res.supersteps
    run.host_reads = len(rec.host_reads)
    if run.kernel is not None:
        run.kernel_calls = (
            _lib.launch_counts()[run.kernel] - launches0[run.kernel]
            if dev.type == "cuda" else rec.kernel_calls[run.kernel, "ref"])
    run.collectives = collective_bytes(ranks)
    run.payloads = [(dt, shp) for op, _, dt, shp in ranks.calls
                    if op == "all_to_all"]
    run.f64_ops = sorted({r.op for r in rec.records
                          if torch.float64 in r.out_dtypes
                          or torch.complex128 in r.out_dtypes})
    run.hbm_bytes = op_traffic(rec.records)["total_bytes"]
    return run


def lint_run(cfg: EngineConfig, run: StepRun,
             shape: StepShape = StepShape()) -> list:
    """The rules of the module docstring over one :class:`StepRun`."""
    subject = run.subject
    if run.error is not None:
        return [Finding("engine", "step-fails", "error", subject,
                        f"the engine does not run: {run.error}")]
    out: list = []
    nl, P = shape.n_local, run.n_parts
    per, once = run.budget
    budget = per * run.supersteps + once
    if run.host_reads > budget:
        out.append(Finding(
            "engine", "host-sync", "warn", subject,
            f"{run.host_reads} host reads in {run.supersteps} supersteps, "
            f"over the budget of {per} a superstep and {once} a run "
            f"({budget}) — every read waits for the device",
        ))
    if run.f64_ops:
        out.append(Finding(
            "engine", "f64-promotion", "error", subject,
            f"{', '.join(run.f64_ops)} produce float64 — a float64 "
            "constant or cast is widening the f32 engine state (2x "
            "exchange bytes, silent)",
        ))
    sparse = cfg.exchange in ("sparse", "auto")
    _, slot_cap = frontier_caps(run.rows, shape.width, nl, P,
                                cfg.frontier_cap)
    expected_k = {payload_plane_words(slot_cap, cfg.hierarchy.needs_level,
                                      cfg.payload), nl}
    for dt in sorted({dt for dt, _ in run.payloads}, key=str):
        ok, cap = payload_capacity(dt, nl)
        if not ok:
            out.append(Finding(
                "engine", "payload-overflow", "error", subject,
                f"exchange payload dtype {str(dt).replace('torch.', '')} "
                f"can only index {cap} vertices exactly but n_local={nl} "
                "— quantized payloads must keep an exact index plane",
            ))
    if sparse:
        bad = sorted({shp for _, shp in run.payloads
                      if shp[-1] not in expected_k})
        if bad:
            out.append(Finding(
                "engine", "payload-plane", "error", subject,
                f"sparse exchange payload shapes {bad} do not match the "
                f"planes x slot_cap layout (last axis in "
                f"{sorted(expected_k)}) — sparse and dense paths would "
                "unpack different bytes",
            ))
    if run.kernel is not None and run.kernel_calls == 0:
        out.append(Finding(
            "engine", "fused-kernel-escape", "warn", subject,
            f"relax_impl={cfg.relax_impl!r} asks for the {run.kernel} "
            f"kernel but the step never called it in {run.supersteps} "
            "supersteps — the engine fell back to the plain torch relax "
            "(non-min-plus processing or a level-bearing hierarchy); "
            "drop '/fused' or switch to an sssp-shaped spec",
        ))
    counts = run.collectives["counts"]
    for op, required in expected_collectives(cfg, P).items():
        present = counts.get(op, 0) > 0
        if required and not present:
            out.append(Finding(
                "engine", "collective-plan", "error", subject,
                f"spec requires a {op} (exchange={cfg.exchange!r}) but "
                "the step ran none — the collective plan and the spec "
                "disagree",
            ))
        elif required is False and present:
            out.append(Finding(
                "engine", "collective-plan", "warn", subject,
                f"spec implies no {op} (exchange={cfg.exchange!r}) but "
                f"the step ran {counts[op]}",
            ))
    a2a_bytes = run.collectives["bytes"].get("all_to_all", 0)
    out.append(Finding(
        "engine", "engine-stats", "info", subject,
        f"supersteps={run.supersteps} host_syncs={run.host_reads} "
        f"(budget {budget}) kernel_calls={run.kernel_calls} "
        f"collectives={counts} collective_bytes="
        f"{run.collectives['total_bytes']} payload_bytes={a2a_bytes} "
        f"hbm_bytes={run.hbm_bytes}",
    ))
    return out


def lint_engine(
    cfg: EngineConfig,
    shape: StepShape = StepShape(),
    n_parts: Optional[int] = None,
    device=None,
    subject: Optional[str] = None,
) -> list:
    """Run ``cfg``'s engine on the seeded graph (:func:`run_step`) and
    lint what it did.  Returns [Finding]."""
    run = run_step(cfg, shape, n_parts, device, subject)
    return lint_run(cfg, run, dataclasses.replace(shape, n_parts=run.n_parts))


def engine_key(cfg: EngineConfig) -> tuple:
    """What makes two configs one program."""
    return (cfg.hierarchy, cfg.exchange, cfg.frontier_cap, cfg.relax_impl,
            cfg.collect_metrics, cfg.payload, cfg.processing.name)


def lint_grid(
    configs,
    shape: StepShape = StepShape(),
    n_parts: Optional[int] = None,
    device=None,
    stats: Optional[dict] = None,
) -> dict:
    """Lint many EngineConfigs, one run a distinct program.  Returns
    {subject: [Finding]}; ``stats``, when given, receives
    {subject: :meth:`StepRun.summary`}."""
    seen: dict = {}
    for cfg in configs:
        key = engine_key(cfg)
        if key in seen:
            continue
        run = run_step(cfg, shape, n_parts, device)
        sh = dataclasses.replace(shape, n_parts=run.n_parts)
        seen[key] = (run.subject, lint_run(cfg, run, sh))
        if stats is not None:
            stats[run.subject] = run.summary()
    return {subj: fs for subj, fs in seen.values()}
