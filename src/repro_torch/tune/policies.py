"""Controller policies: metrics window -> next segment's tunables.

A policy is the runtime half of the paper's "generate the algorithm
for the target architecture" thesis (arXiv 1706.05760 §VII): instead
of freezing delta / frontier_cap / exchange per solve, the segmented
engine publishes a :class:`repro_torch.core.metrics.SuperstepWindow` every
``adapt_window`` supersteps and the policy answers with a
:class:`Decision`.  Self-stabilization makes any answer *safe* — the
kernel's fixpoint is unique and every retuning only reorders the
schedule — so policies optimize cost, never correctness.

Policies are plain Python objects (one fresh instance per solve, so
they may carry state) registered by name; the spec grammar's
``/adapt:<policy>`` resolves here via :func:`make_tune_policy`.
``<policy>`` may carry one ``:<arg>`` suffix, passed to the factory
as a string (e.g. ``rho:0.05`` sets RhoPolicy's target fraction).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Protocol

from repro_torch.core.metrics import SuperstepWindow
from repro_torch.core.ordering import suggest


@dataclasses.dataclass(frozen=True)
class Tunables:
    """The knobs live at a segment boundary (what the engine will use
    next unless the policy's Decision overrides them)."""

    delta: Optional[float]       # root bucket width; None if the root
    #                              ordering is not delta-stepping
    frontier_cap: Optional[int]  # current sparse row capacity; None in
    #                              plain dense exchange modes
    exchange_force: int          # 0 = mode default, 1 = force sparse
    #                              (capacity veto still applies),
    #                              2 = force dense


@dataclasses.dataclass(frozen=True)
class Decision:
    """Policy output; ``None`` fields keep the current value.  The
    controller clamps ``frontier_cap`` to the per-rank row count and counts
    a retrace when it lands on a capacity this solve has not used yet."""

    delta: Optional[float] = None
    frontier_cap: Optional[int] = None
    exchange_force: Optional[int] = None


class TunePolicy(Protocol):
    """Structural interface every controller policy implements."""

    def decide(
        self, window: SuperstepWindow, tunables: Tunables
    ) -> Decision:
        ...


class StaticPolicy:
    """Never changes anything — the adaptive engine with the static
    schedule, whose state and metrics equal the classic loop's."""

    def decide(
        self, window: SuperstepWindow, tunables: Tunables
    ) -> Decision:
        return Decision()


class ScheduledPolicy:
    """Replays an explicit list of Decisions, one per segment (then
    holds): any schedule reaches the same fixpoint (the
    self-stabilization argument)."""

    def __init__(self, schedule):
        self._schedule = list(schedule)
        self._i = 0

    def decide(
        self, window: SuperstepWindow, tunables: Tunables
    ) -> Decision:
        if self._i < len(self._schedule):
            d = self._schedule[self._i]
            self._i += 1
            return d
        return Decision()


class RhoPolicy:
    """rho-stepping-style self-tuning: sample
    the live frontier each segment and

    * double ``frontier_cap`` after >= 2 consecutive overflow
      supersteps (grow capacity instead of falling back dense),
    * retune ``delta`` toward a target eligible-class size — widen
      when the class is starved (too little parallelism per
      superstep), narrow when it floods (too much wasted work) —
      bounded to [1/64, 64]x the spec's delta so one noisy window
      cannot wedge the schedule,
    * pick the exchange from measured pending occupancy instead of
      the static ``auto`` threshold: force dense while more than half
      the graph is pending, force sparse otherwise.
    """

    def __init__(self, target_frac: float = 1.0 / 16.0):
        if not 0.0 < target_frac <= 1.0:
            raise ValueError(
                f"rho target_frac must be in (0, 1]: {target_frac}"
            )
        self.target_frac = float(target_frac)
        self._delta0: Optional[float] = None

    def decide(
        self, window: SuperstepWindow, tunables: Tunables
    ) -> Decision:
        delta: Optional[float] = None
        cap: Optional[int] = None
        force: Optional[int] = None
        if (
            tunables.frontier_cap is not None
            and window.overflow_streak >= 2
        ):
            cap = tunables.frontier_cap * 2
        if tunables.delta is not None and window.eligible:
            if self._delta0 is None:
                self._delta0 = tunables.delta
            base = self._delta0
            target = max(1.0, self.target_frac * window.n)
            avg = window.mean_eligible()
            if avg < target / 4.0:
                delta = min(tunables.delta * 2.0, base * 64.0)
            elif avg > target * 4.0:
                delta = max(tunables.delta / 2.0, base / 64.0)
        if window.sparse_capable and window.pending:
            frac = window.last_pending() / max(1, window.n)
            force = 2 if frac > 0.5 else 1
        return Decision(
            delta=delta, frontier_cap=cap, exchange_force=force
        )


# ---------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------

#: name -> (factory(arg: str | None) -> policy, traits dict)
_POLICIES: dict = {}


def register_tune_policy(
    name: str,
    factory: Callable[[Optional[str]], TunePolicy],
    *,
    grows_cap: bool = False,
    retunes_delta: bool = False,
) -> None:
    """Register a controller policy under ``name`` (usable as
    ``/adapt:<name>`` in specs).  ``factory`` receives the optional
    ``:<arg>`` suffix (string) and must return a fresh policy
    instance per call.  Re-registering a name replaces it.  The trait
    flags say what a policy may change (``grows_cap``: the frontier
    cap, ``retunes_delta``: Δ)."""
    if not name or ":" in name or "/" in name or "@" in name:
        raise ValueError(f"invalid policy name {name!r}")
    _POLICIES[name] = (
        factory,
        dict(grows_cap=grows_cap, retunes_delta=retunes_delta),
    )


def _split(spec: str) -> tuple[str, Optional[str]]:
    spec = str(spec).strip()
    if ":" in spec:
        name, arg = spec.split(":", 1)
        return name.strip(), arg.strip()
    return spec, None


def _lookup(spec: str):
    name, arg = _split(spec)
    entry = _POLICIES.get(name)
    if entry is None:
        raise ValueError(
            f"unknown adapt policy {name!r}; registered policies: "
            f"{tuple(sorted(_POLICIES))}"
            f"{suggest(name, tuple(_POLICIES))}"
        )
    return name, arg, entry


def canonical_policy(spec: str) -> str:
    """Validate a ``/adapt:<policy>`` spec and return its canonical
    form (constructs the policy once, so bad args fail at parse time
    with the factory's message)."""
    name, arg, (factory, _) = _lookup(spec)
    factory(arg)  # arg validation
    return name if arg is None else f"{name}:{arg}"


def make_tune_policy(spec: str) -> TunePolicy:
    """A fresh policy instance for one solve."""
    _, arg, (factory, _) = _lookup(spec)
    return factory(arg)


def policy_traits(spec: str) -> dict:
    """The registered trait flags for a policy spec."""
    _, _, (_, traits) = _lookup(spec)
    return dict(traits)


def _rho_factory(arg: Optional[str]) -> RhoPolicy:
    if arg is None:
        return RhoPolicy()
    try:
        frac = float(arg)
    except ValueError:
        raise ValueError(
            f"rho policy arg must be a float target fraction: {arg!r}"
        ) from None
    return RhoPolicy(target_frac=frac)


def _static_factory(arg: Optional[str]) -> StaticPolicy:
    if arg is not None:
        raise ValueError(
            f"static policy takes no argument, got {arg!r}"
        )
    return StaticPolicy()


register_tune_policy(
    "rho", _rho_factory, grows_cap=True, retunes_delta=True
)
register_tune_policy("static", _static_factory)
