"""EAGM execution engine (torch).

The graph is 1D-partitioned over P ranks (paper §V).  By default all P
ranks live on one device: state tensors are ``(P, n_local+1)``, a
global min over ranks is an ``amin`` over the rank axis, and an
all-to-all is a transpose.  With a process backend
(:class:`repro_torch.core.ranks.ProcessRanks`) each process holds one
rank, its state is ``(1, n_local+1)``, and each of those steps is a
``torch.distributed`` collective.  The engine calls both through the
ranks object (``core/ranks.py``).  Per owned vertex v every rank keeps

    D[v] — committed state (the paper's ``distance`` mapping), and
    T[v] — the best pending workitem state for v.

``v`` is pending iff ``better(T[v], D[v])``.  One loop iteration is one
superstep:

  1.+2. fold over the ordering hierarchy (core/eagm.py): the GLOBAL
     annotation selects the smallest equivalence class, each further
     annotation refines eligibility at its scope,
  3. commit eligible workitems,
  4. relax their out-edges (dense ELL sweep, or on the sparse path the
     compacted frontier rows only: plain torch, the ``relax_push``
     gather kernel, or the ``superstep_fused`` kernel),
  5. exchange candidates to their owners (``a2a`` transpose + combine,
     ``pmin`` all-reduce, or the ``sparse`` (idx, val) payload with a
     dense fallback on capacity overflow; ``auto`` prefers dense while
     the pending count is large),
  6. fold into T and count the pending workitems (termination).

The loop runs eagerly.  The host reads three things a superstep: the
frontier's row-overflow flag (dense or push relax; each process its
own rank's, as the JAX package's ``lax.cond`` decides per rank), the
sparse exchange's vote with the capacity-overflow flag, and the pending
count; the work counters stay on the device, summed locally, and are
reduced over the ranks and read once a run.  State with a leading lane
axis runs B queries at once, as the JAX package's ``vmap`` of its
loop.

:func:`run_segment` is the adaptive engine's entry (``/adapt``,
``/trace``; ``EngineConfig.adapt_window > 0``): at most ``limit``
supersteps from a carried (active, last class key, overflow streak),
with the root Δ and the exchange choice given per segment, returning
the full state and the segment's per-superstep window (pending,
eligible, rows, sparse used).  Pending and the sparse choice are values
the host reads anyway; eligible and rows stay on the device and come
back with the counters in one host read a segment.

State, metrics and every decision match the JAX package's
``repro.core.engine`` bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.eagm import Hierarchy, as_hierarchy
from repro_torch.core.frontier import (
    PAYLOAD_MODES,
    compact_rows,
    frontier_caps,
    payload_plane_words,
    sparse_payload,
    unpack_combine,
)
from repro_torch.core.ordering import DeltaStepping, suggest
from repro_torch.core.processing import SSSP, ProcessingFn
from repro_torch.core.ranks import StackedRanks
from repro_torch.graph.partition import DeviceELL, PartitionedGraph
from repro_torch.kernels import (
    fused_superstep,
    fused_superstep_batch,
    relax_push_rows,
    relax_push_rows_batch,
)

INF = float("inf")

#: candidate-exchange strategies (see the module docstring)
EXCHANGE_MODES = ("a2a", "pmin", "sparse", "auto")

#: sparse-path relaxation backends: 'ref' plain torch, 'push' the
#: relax_push gather kernel + torch scatter-min (the JAX package's
#: 'pallas'), 'fused' the superstep_fused kernel.  Kernels apply to
#: min-plus (sssp) processing without levels; others stay 'ref'.
RELAX_IMPLS = ("ref", "push", "fused")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    policy: "Hierarchy | str"
    processing: ProcessingFn = SSSP
    exchange: str = "a2a"
    max_iters: int = 10**9
    collect_metrics: bool = True
    # max eligible virtual rows compacted per rank per superstep on the
    # sparse path (None = rows/8)
    frontier_cap: Optional[int] = None
    relax_impl: str = "ref"
    # sparse-exchange payload (frontier.PAYLOAD_MODES): 'exact', or the
    # round-up 'bf16' / 'u16' codes the solver's repair loop makes exact
    payload: str = "exact"
    # > 0: the adaptive segment engine (run_segment), at most this many
    # supersteps a segment
    adapt_window: int = 0

    def __post_init__(self):
        object.__setattr__(self, "policy", as_hierarchy(self.policy))
        if self.exchange not in EXCHANGE_MODES:
            raise ValueError(
                f"exchange must be one of {EXCHANGE_MODES}, got "
                f"{self.exchange!r}{suggest(str(self.exchange), EXCHANGE_MODES)}"
            )
        if self.frontier_cap is not None and self.frontier_cap <= 0:
            raise ValueError(f"frontier_cap must be positive: {self.frontier_cap}")
        if self.relax_impl not in RELAX_IMPLS:
            raise ValueError(
                f"relax_impl must be one of {RELAX_IMPLS}, got "
                f"{self.relax_impl!r}{suggest(str(self.relax_impl), RELAX_IMPLS)}"
            )
        if self.adapt_window < 0:
            raise ValueError(f"adapt_window must be >= 0: {self.adapt_window}")
        if self.payload not in PAYLOAD_MODES:
            raise ValueError(
                f"payload must be one of {PAYLOAD_MODES}, got "
                f"{self.payload!r}{suggest(str(self.payload), PAYLOAD_MODES)}"
            )
        if self.payload != "exact" and not self.processing.is_min:
            raise ValueError(
                f"quantized payload {self.payload!r} requires a min-reduce "
                f"semiring; processing fn {self.processing.name!r} does not "
                "reduce with min"
            )

    @property
    def hierarchy(self) -> Hierarchy:
        return self.policy


class Segment(NamedTuple):
    """What an adaptive segment starts from and runs with."""

    active: int        # pending workitems carried in
    last_key: object   # the last root class key (float or f32 tensor)
    streak: int        # consecutive capacity overflows carried in
    limit: int         # at most this many supersteps
    delta: Optional[float]  # the root Δ (None: the spec's ordering)
    force_ex: int      # 0 the mode's rule, 1 force sparse, 2 force dense


class SegmentResult(NamedTuple):
    """An adaptive segment's state (with the dummy slot, for the next
    segment), its counters and its per-superstep window."""

    D: torch.Tensor    # (P, n_local+1); (1, n_local+1) a process
    T: torch.Tensor
    L: torch.Tensor
    supersteps: int
    commits: int
    relaxations: int
    classes: int
    active: int
    fallbacks: int
    last_key: torch.Tensor  # (1,) f32 on the state's device
    streak: int
    max_streak: int
    pending: list      # pending workitems after each superstep
    eligible: list     # eligible-class size per superstep
    rows: list         # eligible ELL rows per superstep
    sparse_used: list  # 1 iff the sparse exchange ran


class EngineResult(NamedTuple):
    """A run's committed state and counters.  For state with a lane
    axis, ``D`` is (B, P, n_local) and every counter a list of B ints,
    one a lane."""

    D: torch.Tensor   # (P, n_local) committed state (the local ranks')
    supersteps: int
    commits: int
    relaxations: int
    classes: int
    active: int       # pending workitems left (0 iff converged)
    fallbacks: int    # sparse-capable supersteps that used the dense exchange
    max_streak: int   # longest run of consecutive capacity overflows


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-rank gather along the last axis: x (B, P, N), idx (B or 1,
    P, ...) int64 (1: shared by every lane) -> (B, P, ...)."""
    B = x.shape[0]
    flat = idx.reshape(idx.shape[0], idx.shape[1], -1).expand(B, -1, -1)
    return torch.gather(x, 2, flat).reshape((B,) + idx.shape[1:])


def run_engine(
    cfg: EngineConfig,
    ell: DeviceELL,
    n_local: int,
    D: torch.Tensor,
    T: torch.Tensor,
    L: torch.Tensor,
    ranks=None,
) -> EngineResult:
    """Run supersteps from the (P, n_local+1) state (D, T, L) until no
    workitem is pending or ``cfg.max_iters`` is reached.

    ``ranks`` carries the rank-axis collectives (``core/ranks.py``):
    None stacks every rank of ``ell`` on its device; a
    :class:`~repro_torch.core.ranks.ProcessRanks` runs this process's
    rank, with ``ell`` and the state holding that rank only.  The
    result is the local ranks' state; the counters are global.

    State of shape (B, P, n_local+1) runs B lanes (independent queries
    on one graph) as the JAX package's ``vmap`` of its loop does: every
    reduction and decision stays inside a lane, a converged lane keeps
    its state and counters while the others run, and each lane counts
    its own supersteps.  Where one lane overflows its frontier cap or
    loses the sparse vote, every lane takes the dense branch: both
    branches give the same candidates wherever both apply.  The host
    reads three things a superstep, each for all lanes at once.  On the
    sparse route a kernel launches once a superstep for all B·P (lane,
    local rank) pairs (the batched entry); state without a lane axis
    launches the single entry once a local rank."""
    if cfg.adapt_window > 0:
        raise ValueError(
            "an adaptive engine config (adapt_window > 0) runs in "
            "segments: use run_segment"
        )
    return _run(cfg, ell, n_local, D, T, L, None, ranks)


def run_segment(
    cfg: EngineConfig,
    ell: DeviceELL,
    n_local: int,
    D: torch.Tensor,
    T: torch.Tensor,
    L: torch.Tensor,
    seg: Segment,
    ranks=None,
) -> SegmentResult:
    """One adaptive segment from the (P, n_local+1) state: at most
    ``seg.limit`` supersteps while work is pending, with the root Δ
    ``seg.delta`` (the key ``floor(T / Δ)`` with Δ a float32 tensor,
    the op sequence of ``DeltaStepping.class_key``, so it equals the
    static engine's bit for bit while Δ is the spec's) and the exchange
    override ``seg.force_ex`` (1 forces sparse, the capacity veto still
    applying; 2 forces dense).  Counters start at zero, the pending
    count, class key and overflow streak from ``seg``.  One lane only:
    the JAX package refuses batched adaptive engines too.  ``ranks`` as
    in :func:`run_engine`; the window is global."""
    if cfg.adapt_window <= 0:
        raise ValueError(
            f"run_segment needs an adaptive engine config (adapt_window "
            f"> 0): {cfg.adapt_window}"
        )
    if D.dim() != 2:
        raise ValueError(
            "adaptive segment engines do not support batched sources; "
            "solve one query at a time"
        )
    if seg.force_ex not in (0, 1, 2):
        raise ValueError(f"force_ex must be 0, 1 or 2: {seg.force_ex}")
    return _run(cfg, ell, n_local, D, T, L, seg, ranks)


def _run(cfg, ell, n_local, D, T, L, seg, ranks):
    """The superstep loop of :func:`run_engine` (``seg`` None) and of
    :func:`run_segment`."""
    lanes = D.dim() == 3
    if not lanes:
        D, T, L = D[None], T[None], L[None]
    p = cfg.processing
    hier = cfg.hierarchy
    use_level = hier.needs_level
    is_min = p.is_min
    worst = float(p.worst)
    op = p.scatter_op
    row_src, col, wgt, row_deg = ell
    if ranks is None:
        ranks = StackedRanks(col.shape[0])
    n_parts = ranks.world  # global: the shapes of the exchange
    P_loc, R, W = col.shape
    if P_loc != ranks.local or D.shape[1] != P_loc:
        raise ValueError(
            f"the ELL holds {P_loc} ranks and the state {D.shape[1]}, but "
            f"this process runs {ranks.local} of {n_parts}")
    n_pad = n_parts * n_local
    B = D.shape[0]
    S = B * P_loc  # (lane, local rank) pairs, lane-major
    dev = D.device
    rs1 = row_src.to(torch.int64)[None]  # (1, P, R): shared by every lane
    col1 = col[None]
    sparse_mode = cfg.exchange in ("sparse", "auto")
    nplanes = 2 if use_level else 1
    if sparse_mode:
        row_cap, slot_cap = frontier_caps(R, W, n_local, n_parts,
                                          cfg.frontier_cap)
        # 'auto': more than half the graph pending means a dense frontier
        auto_thresh = max(1, n_pad // 2)
    # at these capacities the sparse payload never moves fewer words
    # than the dense exchange, so 'auto' is always dense
    static_dense = cfg.exchange == "auto" and payload_plane_words(
        slot_cap, use_level, cfg.payload
    ) >= nplanes * n_local
    kernel_ok = p.name == "sssp" and not use_level
    worst_col = torch.full((B, P_loc, 1), worst, dtype=torch.float32,
                           device=dev)
    inf_col = torch.full((B, P_loc, 1), INF, dtype=torch.float32, device=dev)

    def scatter(cols, vals, fill, how):
        """(B or 1, P, A, W) columns and (B, P, A, W) candidates
        scatter-combined into (B, P, n_pad) over ``fill``.  Column n_pad,
        the ELL padding, is dropped: the padding of row a goes to a
        spill column of its own, n_pad + a (the spill columns of
        ``core/frontier.py``)."""
        A = cols.shape[2]
        spill = torch.arange(n_pad, n_pad + A, device=dev)[:, None]
        idx = torch.where(cols == n_pad, spill, cols)
        buf = torch.full((B, P_loc, n_pad + A), fill, dtype=torch.float32,
                         device=dev)
        buf.scatter_reduce_(
            2, idx.reshape(idx.shape[0], P_loc, -1).expand(B, -1, -1),
            vals.reshape(B, P_loc, -1), how)
        return buf[..., :n_pad]

    def level_scatter(cols, cands, lvl_cands, C):
        """Min level among candidates matching the winning value."""
        cl = cols.to(torch.int64)
        win = (
            (lvl_cands < INF)
            & (cands == _rows(C, cl.clamp(0, n_pad - 1)))
            & (cl < n_pad)
        )
        return scatter(cl, torch.where(win, lvl_cands, INF), INF, "amin")

    it = 0
    # per lane: the host's copies of the pending count and the counters
    # the sparse vote moves; the work counters stay on the device
    active = [1 if seg is None else int(seg.active)] * B
    supersteps = [0] * B
    fallbacks = [0] * B
    streak = [0 if seg is None else int(seg.streak)] * B
    max_streak = [0] * B
    active_t = torch.full((B,), active[0], dtype=torch.int64, device=dev)
    commits = torch.zeros(B, dtype=torch.int64, device=dev)
    relax = torch.zeros(B, dtype=torch.int64, device=dev)
    classes = torch.zeros(B, dtype=torch.int64, device=dev)
    if seg is None:
        limit = cfg.max_iters
        last_key = torch.full((B,), float("nan"), dtype=torch.float32,
                              device=dev)
    else:
        limit = int(seg.limit)
        if isinstance(seg.last_key, torch.Tensor):  # the last segment's
            last_key = seg.last_key.reshape(1).to(dev)
        else:
            last_key = torch.full((1,), float(seg.last_key),
                                  dtype=torch.float32, device=dev)
        # the dynamic root Δ, a float32 tensor as DeltaStepping's own
        delta_t = (None if seg.delta is None else
                   torch.full((), seg.delta, dtype=torch.float32, device=dev))
        # the window: pending and the sparse choice are host values the
        # loop reads anyway; eligible and rows stay on the device
        pend_w, sparse_w, elig_w, rows_w = [], [], [], []
    count_work = cfg.collect_metrics or seg is not None

    while max(active) > 0 and it < limit:
        # a converged lane has nothing pending, so it commits and sends
        # nothing; only its counters need holding
        live = [a > 0 for a in active]
        live_t = active_t > 0

        # ---- 1+2. ordering hierarchy: fold over annotations ----------
        eligible = p.better(T, D)
        kmin = None
        for ai, (lvl, o) in enumerate(hier.annotations):
            if (ai == 0 and seg is not None and delta_t is not None
                    and isinstance(o, DeltaStepping)):
                raw_key = torch.floor(T / delta_t)  # class_key's op sequence
            else:
                raw_key = o.class_key(T, L)
            key = torch.where(eligible, raw_key, INF)
            if lvl in ("global", "pod"):  # pod: the mesh's pod axis
                m = ranks.min_over(key, lvl)
                eligible = eligible & (key == m)
                if lvl == "global":
                    kmin = m.reshape(B)
            elif o.drain is not None:  # rank-local top-B drain
                k = min(o.drain, n_local)
                kth = torch.topk(key, k, dim=2, largest=False).values[..., k - 1:k]
                eligible = eligible & (key <= kth)
            else:  # rank-local minimal class
                eligible = eligible & (key == key.amin(dim=2, keepdim=True))

        # ---- 3. commit ------------------------------------------------
        D = torch.where(eligible, T, D)
        elig_rows = _rows(eligible, rs1)  # (B, P, R)

        # ---- 4. relax -------------------------------------------------
        def relax_dense():
            """Pull sweep over all R virtual rows (masked)."""
            if is_min:
                # +inf padding annihilates padded slots; mask only at the
                # vertex level
                src_val = _rows(torch.where(eligible, D, worst), rs1)
                cand = p.edge_update(src_val[..., None], wgt)
                cand = cand.expand((B,) + col.shape)
            else:
                src_val = torch.where(elig_rows, _rows(D, rs1), worst)
                cand = p.edge_update(src_val[..., None], wgt)
                cand = torch.where(elig_rows[..., None] & (wgt < INF), cand,
                                   worst)
            C = scatter(col1, cand, worst, op)
            if not use_level:
                return C, None
            live_slot = elig_rows[..., None] & (wgt < INF)
            lvl_cand = torch.where(live_slot,
                                   (_rows(L, rs1) + 1.0)[..., None], INF)
            return C, level_scatter(col1, cand, lvl_cand, C)

        def relax_push():
            """Push mode: relax only the compacted frontier rows; fill
            rows gather the dummy source and the padding column."""
            if cfg.relax_impl in ("fused", "push") and kernel_ok:
                fused = cfg.relax_impl == "fused"
                if lanes:  # one launch for every (lane, rank)
                    kernel = (fused_superstep_batch if fused
                              else relax_push_rows_batch)
                    C = kernel(D.reshape(S, -1),
                               f_idx.reshape(S, row_cap).contiguous(),
                               f_cnt.reshape(S), row_src, col, wgt, n_pad)
                else:  # one launch a local rank
                    kernel = fused_superstep if fused else relax_push_rows
                    C = torch.stack([
                        kernel(D[0, q], f_idx[0, q], f_cnt[0, q], row_src[q],
                               col[q], wgt[q], n_pad)
                        for q in range(P_loc)
                    ])
                return C[..., :n_pad].reshape(B, P_loc, n_pad), None
            fi = f_idx.to(torch.int64)
            valid = fi < R
            fic = fi.clamp(max=R - 1)
            srcg = torch.where(valid, _rows(rs1.expand(B, -1, -1), fic),
                               n_local)
            strip = fic[..., None].expand(B, P_loc, row_cap, W)
            colg = torch.where(
                valid[..., None],
                torch.gather(col1.expand(B, -1, -1, -1), 2, strip), n_pad)
            wgtg = torch.where(
                valid[..., None],
                torch.gather(wgt[None].expand(B, -1, -1, -1), 2, strip), INF)
            cand = p.edge_update(_rows(D, srcg)[..., None], wgtg)
            cand = cand.expand(wgtg.shape)
            C = scatter(colg, cand, worst, op)
            if not use_level:
                return C, None
            lvl_cand = torch.where(wgtg < INF,
                                   (_rows(L, srcg) + 1.0)[..., None], INF)
            return C, level_scatter(colg, cand, lvl_cand, C)

        if sparse_mode:
            f_idx, f_cnt, row_overflow = compact_rows(
                elig_rows.reshape(S, R), row_cap)
            f_idx = f_idx.reshape(B, P_loc, row_cap)
            f_cnt = f_cnt.reshape(B, P_loc)
            row_overflow = row_overflow.reshape(B, P_loc)
            # a rank whose frontier overflows F sweeps densely; the dense
            # and push candidates agree wherever both apply, so one dense
            # sweep serves every local rank of every lane (a process
            # decides for its own rank alone)
            C, CL = relax_dense() if bool(row_overflow.any()) else relax_push()
        else:
            C, CL = relax_dense()

        # ---- 5. exchange candidates to owners -------------------------
        def exchange_a2a():
            X = ranks.all_to_all(C.reshape(B, P_loc, n_parts, n_local))
            mine = p.reduce_array(X, 2)
            if not use_level:
                return mine, None
            XL = ranks.all_to_all(CL.reshape(B, P_loc, n_parts, n_local))
            return mine, torch.where(X == mine[:, :, None], XL, INF).amin(2)

        sp_used = [0] * B
        if cfg.exchange == "pmin":
            mine, mineL = ranks.reduce(C, is_min, CL if use_level else None)
        elif cfg.exchange == "a2a":
            mine, mineL = exchange_a2a()
        elif static_dense:
            mine, mineL = exchange_a2a()
            fallbacks = [f + lv for f, lv in zip(fallbacks, live)]
        else:  # 'sparse' | 'auto'
            extra = [(CL.reshape(S, n_pad), INF)] if use_level else []
            payload, ex_overflow = sparse_payload(
                C.reshape(S, n_pad), extra, n_parts, slot_cap, worst,
                cfg.payload)
            cap_ok = ~ex_overflow.reshape(B, P_loc)
            ok = cap_ok
            if cfg.exchange == "auto":
                ok = ok & (active_t <= auto_thresh)[:, None]
            if seg is not None and seg.force_ex == 1:
                ok = cap_ok  # forced sparse: the capacity veto still applies
            elif seg is not None and seg.force_ex == 2:
                ok = torch.zeros_like(ok)
            over = row_overflow | ex_overflow.reshape(B, P_loc)
            # every rank of a lane takes the same branch (the shapes
            # differ, and a process on the other branch would wait in a
            # collective for ever): the vote reaches every rank first;
            # one lane's dense branch serves all lanes
            use_sp, no_overflow = ranks.vote(
                torch.stack([ok, ~over]).to(torch.int32)
            ).tolist()
            if all(use_sp):
                sp_used = [1] * B
                recv = ranks.all_to_all(payload.reshape(B, P_loc, n_parts, -1))
                mine, mineL = unpack_combine(
                    recv.reshape(S, n_parts, -1), n_local, slot_cap, is_min,
                    worst, use_level, cfg.payload,
                )
                mine = mine.reshape(B, P_loc, n_local)
                if use_level:
                    mineL = mineL.reshape(B, P_loc, n_local)
            else:
                mine, mineL = exchange_a2a()
            for b in range(B):
                if live[b]:
                    fallbacks[b] += not use_sp[b]
                    streak[b] = 0 if no_overflow[b] else streak[b] + 1
                    max_streak[b] = max(max_streak[b], streak[b])

        # ---- 6. fold into pending state T -----------------------------
        mine_ext = torch.cat([mine, worst_col], dim=2)
        improved = p.better(mine_ext, T)
        T = torch.where(improved, mine_ext, T)
        if use_level:
            L = torch.where(improved, torch.cat([mineL, inf_col], dim=2), L)

        if count_work:
            step_commits = eligible.sum(dim=(1, 2))
            commits += step_commits
            relax += (elig_rows * row_deg).sum(dim=(1, 2))
            classes += ((kmin != last_key) & live_t).to(torch.int64)
        last_key = kmin
        active_t = ranks.sum(p.better(T, D).sum(dim=(1, 2)))
        if seg is not None:
            elig_w.append(step_commits[0])
            rows_w.append(elig_rows[0].sum())
        active = active_t.tolist()
        if seg is not None:
            pend_w.append(active[0])
            sparse_w.append(sp_used[0])
        supersteps = [s + lv for s, lv in zip(supersteps, live)]
        it += 1

    # the work counters (and a segment's window), summed over the ranks:
    # one collective and one host read.  The class count is global
    # already (kmin is), so it is not summed.
    work = [commits, relax]
    if seg is not None and it:
        work.append(torch.stack(elig_w + rows_w))
    work = torch.cat([ranks.sum(torch.cat(work)), classes]).tolist()
    commits_l, relax_l = work[:B], work[B:2 * B]
    classes_l = work[-B:]
    window = work[2 * B:-B]
    if seg is not None:
        return SegmentResult(
            D[0], T[0], L[0], it, commits_l[0], relax_l[0], classes_l[0],
            active[0], fallbacks[0], last_key, streak[0], max_streak[0],
            pend_w, window[:it], window[it:], sparse_w)
    out = [supersteps, commits_l, relax_l, classes_l, active, fallbacks,
           max_streak]
    if not lanes:
        return EngineResult(D[0, :, :n_local], *(c[0] for c in out))
    return EngineResult(D[..., :n_local], *out)


def initial_state(
    pg: PartitionedGraph, processing: ProcessingFn, sources: list[tuple]
):
    """Dense initial state from the initial workitem set S, as numpy
    (P, n_local+1) arrays (D, T, L).

    ``sources`` — [(vertex, state, level)] in original vertex ids,
    placed through the partition's owner map.  Duplicates keep the best
    state; ties keep the smallest level.  The trailing slot per rank is
    the dummy target of padded virtual rows and stays at ``worst``.
    """
    P_, nl = pg.n_parts, pg.n_local
    worst = np.float32(processing.worst)
    D = np.full((P_, nl + 1), worst, dtype=np.float32)
    T = np.full((P_, nl + 1), worst, dtype=np.float32)
    L = np.full((P_, nl + 1), np.inf, dtype=np.float32)
    for (v, s, lvl) in sources:
        i, j = pg.owner_slot(int(v))
        i, j = int(i), int(j)
        s, lvl = np.float32(s), np.float32(lvl)
        if bool(processing.better(s, T[i, j])):
            T[i, j] = s
            L[i, j] = lvl
        elif s == T[i, j]:
            L[i, j] = min(L[i, j], lvl)
    return D, T, L


def initial_state_batch(
    pg: PartitionedGraph, processing: ProcessingFn,
    sources_batch: list[list[tuple]],
):
    """Per-query initial states stacked along a leading lane axis: numpy
    (B, P, n_local+1) arrays (D, T, L) for a run of B lanes."""
    per = [initial_state(pg, processing, s) for s in sources_batch]
    return tuple(np.stack(planes) for planes in zip(*per))


def sssp_sources(source: int) -> list[tuple]:
    """The SSSP initial workitem set {⟨source, 0⟩} as (vertex, state, level)."""
    return [(int(source), 0.0, 0)]


def cc_sources(n: int) -> list[tuple]:
    """The CC initial workitem set {⟨v, v⟩ : v ∈ V}."""
    return [(v, float(v), 0) for v in range(n)]
