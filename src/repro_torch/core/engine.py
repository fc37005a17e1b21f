"""Rank-stacked EAGM execution engine (torch).

The graph is 1D-partitioned over P ranks (paper §V), and all P ranks
live on one device: state tensors are ``(P, n_local+1)``, a global
min over ranks is an ``amin`` over the rank axis, and an all-to-all is
a transpose.  Per owned vertex v every rank keeps

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

The loop runs eagerly and reads the pending count, the frontier's
overflow flags and the sparse-exchange vote on the host every
superstep.  State, metrics and every decision match the JAX package's
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
from repro_torch.core.ordering import suggest
from repro_torch.core.processing import SSSP, ProcessingFn
from repro_torch.graph.partition import DeviceELL, PartitionedGraph
from repro_torch.kernels import fused_superstep, relax_push_rows

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
    # 'exact' only; quantized payloads parse but are not ported
    payload: str = "exact"
    # > 0 selects the adaptive segment engine, which is not ported
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


class EngineResult(NamedTuple):
    D: torch.Tensor   # (P, n_local) committed state
    supersteps: int
    commits: int
    relaxations: int
    classes: int
    active: int       # pending workitems left (0 iff converged)
    fallbacks: int    # sparse-capable supersteps that used the dense exchange
    max_streak: int   # longest run of consecutive capacity overflows


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-rank gather: x (P, N), idx (P, ...) int64 -> (P, ...)."""
    return torch.gather(x, 1, idx.reshape(idx.shape[0], -1)).reshape(idx.shape)


def run_engine(
    cfg: EngineConfig,
    ell: DeviceELL,
    n_local: int,
    D: torch.Tensor,
    T: torch.Tensor,
    L: torch.Tensor,
) -> EngineResult:
    """Run supersteps from the (P, n_local+1) state (D, T, L) until no
    workitem is pending or ``cfg.max_iters`` is reached."""
    if cfg.payload != "exact":
        raise NotImplementedError(
            f"quantized payload {cfg.payload!r} (/q) is not yet ported"
        )
    if cfg.adapt_window > 0:
        raise NotImplementedError(
            "the adaptive segment engine (/adapt, /trace) is not yet ported"
        )
    p = cfg.processing
    hier = cfg.hierarchy
    use_level = hier.needs_level
    is_min = p.is_min
    worst = float(p.worst)
    op = p.scatter_op
    row_src, col, wgt, row_deg = ell
    n_parts, R, W = col.shape
    n_pad = n_parts * n_local
    dev = D.device
    row_src_l = row_src.to(torch.int64)
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
    worst_col = torch.full((n_parts, 1), worst, dtype=torch.float32, device=dev)
    inf_col = torch.full((n_parts, 1), INF, dtype=torch.float32, device=dev)

    def scatter(cols, vals, fill, how):
        """(P, A, W) candidates scatter-combined into (P, n_pad) over
        ``fill``.  Column n_pad, the ELL padding, is dropped: the padding
        of row a goes to a spill column of its own, n_pad + a (the spill
        columns of ``core/frontier.py``)."""
        A = cols.shape[1]
        spill = torch.arange(n_pad, n_pad + A, device=dev)[:, None]
        buf = torch.full((n_parts, n_pad + A), fill, dtype=torch.float32,
                         device=dev)
        buf.scatter_reduce_(
            1, torch.where(cols == n_pad, spill, cols).reshape(n_parts, -1),
            vals.reshape(n_parts, -1), how)
        return buf[:, :n_pad]

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
    active = 1
    fallbacks = streak = max_streak = 0
    commits = torch.zeros((), dtype=torch.int64, device=dev)
    relax = torch.zeros((), dtype=torch.int64, device=dev)
    classes = torch.zeros((), dtype=torch.int64, device=dev)
    last_key = torch.full((), float("nan"), dtype=torch.float32, device=dev)

    while active > 0 and it < cfg.max_iters:
        active_prev = active

        # ---- 1+2. ordering hierarchy: fold over annotations ----------
        eligible = p.better(T, D)
        kmin = None
        for lvl, o in hier.annotations:
            key = torch.where(eligible, o.class_key(T, L), INF)
            if lvl in ("global", "pod"):  # one flat rank axis: pod = all
                m = key.amin()
                eligible = eligible & (key == m)
                if lvl == "global":
                    kmin = m
            elif o.drain is not None:  # rank-local top-B drain
                B = min(o.drain, n_local)
                kth = torch.topk(key, B, dim=1, largest=False).values[:, B - 1:B]
                eligible = eligible & (key <= kth)
            else:  # rank-local minimal class
                eligible = eligible & (key == key.amin(dim=1, keepdim=True))

        # ---- 3. commit ------------------------------------------------
        D = torch.where(eligible, T, D)
        elig_rows = _rows(eligible, row_src_l)  # (P, R)

        # ---- 4. relax -------------------------------------------------
        def relax_dense():
            """Pull sweep over all R virtual rows (masked)."""
            if is_min:
                # +inf padding annihilates padded slots; mask only at the
                # vertex level
                src_val = _rows(torch.where(eligible, D, worst), row_src_l)
                cand = p.edge_update(src_val[..., None], wgt).expand(col.shape)
            else:
                src_val = torch.where(elig_rows, _rows(D, row_src_l), worst)
                cand = p.edge_update(src_val[..., None], wgt)
                cand = torch.where(elig_rows[..., None] & (wgt < INF), cand,
                                   worst)
            C = scatter(col, cand, worst, op)
            if not use_level:
                return C, None
            live = elig_rows[..., None] & (wgt < INF)
            lvl_cand = torch.where(live, (_rows(L, row_src_l) + 1.0)[..., None],
                                   INF)
            return C, level_scatter(col, cand, lvl_cand, C)

        def relax_push():
            """Push mode: relax only the compacted frontier rows; fill
            rows gather the dummy source and the padding column."""
            if cfg.relax_impl in ("fused", "push") and kernel_ok:
                kernel = (fused_superstep if cfg.relax_impl == "fused"
                          else relax_push_rows)
                C = torch.stack([
                    kernel(D[q], f_idx[q], f_cnt[q], row_src[q], col[q],
                           wgt[q], n_pad)[:n_pad]
                    for q in range(n_parts)
                ])
                return C, None
            fi = f_idx.to(torch.int64)
            valid = fi < R
            fic = fi.clamp(max=R - 1)
            srcg = torch.where(valid, _rows(row_src_l, fic), n_local)
            strip = fic[..., None].expand(n_parts, row_cap, W)
            colg = torch.where(valid[..., None], torch.gather(col, 1, strip),
                               n_pad)
            wgtg = torch.where(valid[..., None], torch.gather(wgt, 1, strip),
                               INF)
            cand = p.edge_update(_rows(D, srcg)[..., None], wgtg)
            cand = cand.expand(wgtg.shape)
            C = scatter(colg, cand, worst, op)
            if not use_level:
                return C, None
            lvl_cand = torch.where(wgtg < INF, (_rows(L, srcg) + 1.0)[..., None],
                                   INF)
            return C, level_scatter(colg, cand, lvl_cand, C)

        if sparse_mode:
            f_idx, f_cnt, row_overflow = compact_rows(elig_rows, row_cap)
            # a rank whose frontier overflows F sweeps densely; the dense
            # and push candidates agree wherever both apply, so one dense
            # sweep serves every rank
            C, CL = relax_dense() if bool(row_overflow.any()) else relax_push()
        else:
            C, CL = relax_dense()

        # ---- 5. exchange candidates to owners -------------------------
        def exchange_a2a():
            X = C.reshape(n_parts, n_parts, n_local).transpose(0, 1)
            mine = p.reduce_array(X, 1)
            if not use_level:
                return mine, None
            XL = CL.reshape(n_parts, n_parts, n_local).transpose(0, 1)
            return mine, torch.where(X == mine[:, None], XL, INF).amin(1)

        def exchange_pmin():
            Cg = p.reduce_array(C, 0)
            mine = Cg.reshape(n_parts, n_local)
            if not use_level:
                return mine, None
            CLg = torch.where(C == Cg[None], CL, INF).amin(0)
            return mine, CLg.reshape(n_parts, n_local)

        if cfg.exchange == "pmin":
            mine, mineL = exchange_pmin()
        elif cfg.exchange == "a2a":
            mine, mineL = exchange_a2a()
        elif static_dense:
            mine, mineL = exchange_a2a()
            fallbacks += 1
        else:  # 'sparse' | 'auto'
            extra = [(CL, INF)] if use_level else []
            payload, ex_overflow = sparse_payload(C, extra, n_parts, slot_cap,
                                                  worst)
            ok = ~ex_overflow
            if cfg.exchange == "auto":
                ok = ok & (active_prev <= auto_thresh)
            over_local = row_overflow | ex_overflow
            # every rank takes the same branch: the shapes differ
            use_sp, no_overflow = torch.stack(
                [ok.all(), ~over_local.any()]
            ).tolist()
            if use_sp:
                mine, mineL = unpack_combine(
                    payload.transpose(0, 1), n_local, slot_cap, is_min,
                    worst, use_level,
                )
            else:
                mine, mineL = exchange_a2a()
                fallbacks += 1
            streak = 0 if no_overflow else streak + 1
            max_streak = max(max_streak, streak)

        # ---- 6. fold into pending state T -----------------------------
        mine_ext = torch.cat([mine, worst_col], dim=1)
        improved = p.better(mine_ext, T)
        T = torch.where(improved, mine_ext, T)
        if use_level:
            L = torch.where(improved, torch.cat([mineL, inf_col], dim=1), L)

        if cfg.collect_metrics:
            commits += eligible.sum()
            relax += (elig_rows * row_deg).sum()
            classes += (kmin != last_key).to(torch.int64)
        last_key = kmin
        active = int(p.better(T, D).sum())
        it += 1

    return EngineResult(
        D[:, :n_local], it, int(commits), int(relax), int(classes), active,
        fallbacks, max_streak,
    )


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
