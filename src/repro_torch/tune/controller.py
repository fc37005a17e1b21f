"""Adaptive execution loop: segments + controller policy.

:func:`run_adaptive` is the host side of the ``EngineConfig.
adapt_window`` seam.  It runs the engine in segments
(:func:`repro_torch.core.engine.run_segment`, at most ``adapt_window``
supersteps each, the full (D, T, L) state staying on the device between
them), turns each segment's window into a
:class:`repro_torch.core.metrics.SuperstepWindow`, and lets the policy
retune the next segment's tunables: the root Δ, the exchange choice and
the frontier cap.

``retraces`` counts the frontier caps a solve first used after its
first one, the count the JAX package makes of the segment engines such
a cap compiles.  The port runs its engine eagerly and compiles nothing,
so here the count marks no compilation; it is kept so that
``Solution.metrics`` equals the JAX package's.

Exactness: the kernel is self-stabilizing, so retuning the ordering
mid-solve reorders the schedule but cannot move the fixpoint.  Byte
accounting stays exact across cap changes because each segment's words
are computed with that segment's capacities (``api.solver.
exchange_words``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from repro_torch.core.engine import EngineConfig, Segment, run_segment
from repro_torch.core.frontier import frontier_caps
from repro_torch.core.metrics import SuperstepWindow, WorkMetrics
from repro_torch.core.ordering import DeltaStepping
from repro_torch.graph.partition import DeviceELL, PartitionedGraph
from repro_torch.obs import trace as obs
from repro_torch.tune.policies import Decision, TunePolicy, Tunables


@dataclasses.dataclass
class AdaptReport:
    """What the controller did during one adaptive solve."""

    segments: int = 0
    retraces: int = 0      # frontier caps first used after the first
    cap_growths: int = 0   # cap-change decisions applied
    decisions: list = dataclasses.field(default_factory=list)
    final_delta: Optional[float] = None
    final_frontier_cap: Optional[int] = None


def run_adaptive(
    ecfg: EngineConfig,
    pg: PartitionedGraph,
    ell: DeviceELL,
    policy: TunePolicy,
    D0: torch.Tensor,
    T0: torch.Tensor,
    L0: torch.Tensor,
    on_window: Optional[Callable[[SuperstepWindow, dict], None]] = None,
    ranks=None,
) -> tuple[torch.Tensor, WorkMetrics, AdaptReport]:
    """Drive the segment engine to convergence (or ``max_iters``) under
    ``policy`` from the (P, n_local+1) state on ``ell``'s device.
    Returns the padded (P, n_local) committed state (on the device),
    exact WorkMetrics, and the controller's AdaptReport.

    ``ranks`` is the engine's (``core/ranks.py``; None: stacked).  Over
    a process backend the state and ``ell`` are this process's rank's
    and the returned state too; every window, decision and metric is
    global, so every process takes the same decisions and records the
    same flight record.

    ``on_window`` is the flight-recorder tap: when given, it is called
    once per segment, the last one included and before the policy is
    consulted, with the segment's SuperstepWindow and a dict of the
    segment (``supersteps``, wall ``t0``/``t1`` on the tracer's clock,
    the tunables in force, ``fallbacks``).  Without it the last
    segment's window is not built (no policy reads it).

    The host reads the initial pending count once a solve, and each
    segment reads its window with its counters once
    (:func:`run_segment`).
    """
    from repro_torch.api import solver as fac  # lazy: avoids an import cycle

    if ecfg.adapt_window <= 0:
        raise ValueError("run_adaptive needs an adaptive EngineConfig "
                         f"(adapt_window > 0): {ecfg.adapt_window}")
    p = ecfg.processing
    Wn = ecfg.adapt_window
    sparse_capable = ecfg.exchange in ("sparse", "auto")
    P_, nl = pg.n_parts, pg.n_local
    n = P_ * nl

    root = ecfg.hierarchy.root
    delta = float(root.delta) if isinstance(root, DeltaStepping) else None
    if sparse_capable:
        cap, _ = frontier_caps(
            pg.rows_per_rank, pg.width, nl, P_, ecfg.frontier_cap
        )
    else:
        cap = None
    force = 0

    D, T, L = D0, T0, L0
    pending = p.better(T0, D0).sum().reshape(1)
    active = int(pending if ranks is None else ranks.sum(pending))
    last_key = float("nan")
    streak = 0

    it_total = 0
    commits = relax = classes = fallbacks = 0
    words = 0
    rounds = 0
    max_streak = 0
    caps_seen = {cap}
    seg_cfgs: dict = {}  # frontier cap -> the segment's engine config
    report = AdaptReport()

    while active > 0 and it_total < ecfg.max_iters:
        with obs.span(
            "tune.segment", segment=report.segments,
            delta=delta, frontier_cap=cap, force=force,
        ) as sp:
            ecfg_seg = seg_cfgs.get(cap)
            if ecfg_seg is None:
                ecfg_seg = seg_cfgs[cap] = (
                    dataclasses.replace(ecfg, frontier_cap=cap)
                    if sparse_capable else ecfg)
            limit = min(Wn, ecfg.max_iters - it_total)
            t0_seg = obs.now()
            r = run_segment(ecfg_seg, ell, nl, D, T, L,
                            Segment(active, last_key, streak, limit, delta,
                                    force), ranks)
            D, T, L = r.D, r.T, r.L
            it = r.supersteps
            if it == 0:
                # cannot happen while active > 0 and limit >= 1; never
                # spin on a segment that made no progress
                break
            fb = r.fallbacks
            it_total += it
            commits += r.commits
            relax += r.relaxations
            classes += r.classes
            fallbacks += fb
            active = r.active
            last_key = r.last_key
            streak = r.streak
            max_streak = max(max_streak, r.max_streak)
            words += fac.exchange_words(pg, ecfg_seg, it, fb)
            rounds += it * (3 + (1 if sparse_capable else 0))
            report.segments += 1
            t1_seg = obs.now()
            sp.set(supersteps=it, pending=active, fallbacks=fb)

            done = active == 0 or it_total >= ecfg.max_iters
            if on_window is None and done:
                break

            # per-superstep bytes from the sparse/dense choice and THIS
            # segment's capacities
            dense_b = fac.exchange_words(pg, ecfg_seg, 1, 1) * 4 * P_
            sparse_b = fac.exchange_words(pg, ecfg_seg, 1, 0) * 4 * P_
            window = SuperstepWindow(
                pending=list(r.pending),
                eligible=list(r.eligible),
                rows=list(r.rows),
                sparse_used=list(r.sparse_used),
                bytes_moved=[sparse_b if s else dense_b
                             for s in r.sparse_used],
                overflow_streak=streak,
                supersteps_total=it_total,
                n=n,
                rows_per_rank=pg.rows_per_rank,
                sparse_capable=sparse_capable,
            )
            if on_window is not None:
                on_window(window, {
                    "supersteps": it, "t0": t0_seg, "t1": t1_seg,
                    "delta": delta, "frontier_cap": cap, "force": force,
                    "fallbacks": fb,
                })
            if done:
                break
            decision = policy.decide(window, Tunables(delta, cap, force))
            if not isinstance(decision, Decision):
                raise TypeError(
                    f"policy {type(policy).__name__} returned "
                    f"{type(decision).__name__}, expected Decision"
                )
            report.decisions.append(decision)
            sp.set(
                decision_delta=decision.delta,
                decision_frontier_cap=decision.frontier_cap,
                decision_force=decision.exchange_force,
            )
            if decision.delta is not None and delta is not None:
                d = float(decision.delta)
                if not (d > 0.0 and math.isfinite(d)):
                    raise ValueError(
                        f"policy proposed non-positive delta {d}"
                    )
                delta = d
            if decision.exchange_force is not None:
                f = int(decision.exchange_force)
                if f not in (0, 1, 2):
                    raise ValueError(
                        f"policy proposed exchange_force {f}, expected 0|1|2"
                    )
                force = f
            if decision.frontier_cap is not None and sparse_capable:
                new_cap = min(pg.rows_per_rank,
                              max(1, int(decision.frontier_cap)))
                if new_cap != cap:
                    cap = new_cap
                    report.cap_growths += 1
                    if cap not in caps_seen:
                        caps_seen.add(cap)
                        report.retraces += 1
                        obs.event("adapt_retrace", frontier_cap=cap,
                                  segment=report.segments)

    report.final_delta = delta
    report.final_frontier_cap = cap

    m = WorkMetrics(
        classes=classes,
        commits=commits,
        relaxations=relax,
        supersteps=it_total,
        workitems=commits,
        converged=(active == 0),
        sparse_fallbacks=fallbacks,
        overflow_streak=max_streak,
        retraces=report.retraces,
    )
    m.exchange_bytes = words * 4 * P_
    m.collective_rounds = rounds
    fac._warn_metrics(m, ecfg, pg, active)
    return D[:, :nl], m, report
