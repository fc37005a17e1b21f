"""Strict weak orderings on workitems (paper §III, Definitions 5-9).

A workitem is ⟨v, T[v]⟩ plus the KLA level attribute L[v]; an ordering
is a *class key* function: two workitems share an equivalence class
iff their keys are equal, and classes run in increasing key order.
Keys are float32 tensors.

Every ordering has ``class_key(dist, level)``, ``needs_level``,
``drain`` (TopK only) and ``spec`` (``make_ordering(o.spec) == o``).

``DeltaStepping`` divides by a float32 *tensor* on the state's device:
CUDA's ``div`` by a host scalar multiplies by the reciprocal, which
can round ``floor(d / Δ)`` differently from the JAX package's IEEE
division.
"""

from __future__ import annotations

import dataclasses
import difflib
from typing import Callable, Optional, Union

import torch


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), x, dtype=torch.float32, device=like.device)


@dataclasses.dataclass(frozen=True)
class Chaotic:
    """Definition 5: w1 <_chaotic w2 is always False — one giant class."""

    needs_level = False
    drain = None

    @property
    def spec(self) -> str:
        return "chaotic"

    def class_key(self, dist, level):
        return torch.zeros_like(dist)


@dataclasses.dataclass(frozen=True)
class Dijkstra:
    """Definition 6: w1 <_dj w2 iff d1 < d2 — one class per distance."""

    needs_level = False
    drain = None

    @property
    def spec(self) -> str:
        return "dijkstra"

    def class_key(self, dist, level):
        return dist


@dataclasses.dataclass(frozen=True)
class DeltaStepping:
    """Definition 7: w1 <_Δ w2 iff ⌊d1/Δ⌋ < ⌊d2/Δ⌋."""

    delta: float = 5.0
    needs_level = False
    drain = None

    @property
    def spec(self) -> str:
        return f"delta:{self.delta:g}"

    def class_key(self, dist, level):
        return torch.floor(dist / _f32(self.delta, dist))


@dataclasses.dataclass(frozen=True)
class KLA:
    """Definition 9: w1 <_kla w2 iff ⌊l1/k⌋ < ⌊l2/k⌋ (level attribute)."""

    k: int = 2
    drain = None

    @property
    def spec(self) -> str:
        return f"kla:{self.k}"

    @property
    def needs_level(self) -> bool:
        return True

    def class_key(self, dist, level):
        level = level.to(torch.float32)
        return torch.floor(level / _f32(float(self.k), level))


@dataclasses.dataclass(frozen=True)
class TopK:
    """Drain ordering: keep the B smallest workitems under ``key`` (ties
    included) — the paper's thread-level priority queue.  Only
    meaningful at the device-local scopes (device, chunk)."""

    b: int = 1024
    key: Union[Chaotic, Dijkstra, DeltaStepping, KLA] = Dijkstra()

    def __post_init__(self):
        if self.b <= 0:
            raise ValueError(f"TopK drain size must be positive: {self.b}")
        if isinstance(self.key, TopK):
            raise ValueError("TopK cannot nest another TopK as its key")

    @property
    def spec(self) -> str:
        if isinstance(self.key, Dijkstra):
            return f"topk:{self.b}"
        return f"topk:{self.b}:{self.key.spec}"

    @property
    def needs_level(self) -> bool:
        return needs_level(self.key)

    @property
    def drain(self) -> int:
        return self.b

    def class_key(self, dist, level):
        return self.key.class_key(dist, level)


Ordering = Union[Chaotic, Dijkstra, DeltaStepping, KLA, TopK]


def needs_level(ordering: Ordering) -> bool:
    return getattr(ordering, "needs_level", False)


#: canonical kind -> parser(arg_str_or_None) -> Ordering
_REGISTRY: "dict[str, Callable[[Optional[str]], Ordering]]" = {}
#: alias -> canonical kind
_ALIASES: "dict[str, str]" = {}


def register_ordering(kind: str, parser, *aliases: str) -> None:
    """Register an ordering kind for :func:`make_ordering`."""
    _REGISTRY[kind] = parser
    _ALIASES[kind] = kind
    for a in aliases:
        _ALIASES[a] = kind


def _parse_topk(arg: Optional[str]) -> TopK:
    if arg is None:
        return TopK()
    if ":" in arg:  # topk:B:inner-ordering-spec
        b, inner = arg.split(":", 1)
        return TopK(int(b), make_ordering(inner))
    return TopK(int(arg))


register_ordering("chaotic", lambda a: Chaotic())
register_ordering("dijkstra", lambda a: Dijkstra(), "dj")
register_ordering(
    "delta",
    lambda a: DeltaStepping(float(a) if a else 5.0),
    "delta-stepping", "ds",
)
register_ordering("kla", lambda a: KLA(int(a) if a else 2))
register_ordering("topk", _parse_topk)


def ordering_kinds() -> tuple:
    """The registered canonical ordering kinds."""
    return tuple(sorted(_REGISTRY))


def suggest(word: str, choices) -> str:
    """``" (did you mean 'x'?)"`` when a close match exists, else ""."""
    close = difflib.get_close_matches(word, list(choices), n=1, cutoff=0.6)
    return f" (did you mean {close[0]!r}?)" if close else ""


def make_ordering(spec: str) -> Ordering:
    """Parse 'chaotic' | 'dijkstra' | 'delta:5' | 'kla:2' | 'topk:64'
    (or 'topk:64:delta:1' for a non-Dijkstra drain key)."""
    if isinstance(spec, str) and ":" in spec:
        kind, arg = spec.split(":", 1)
    else:
        kind, arg = spec, None
    kind = str(kind).strip().lower()
    canonical = _ALIASES.get(kind)
    if canonical is None:
        raise ValueError(
            f"unknown ordering spec: {spec!r} — kind must be one of "
            f"{sorted(_REGISTRY)}{suggest(kind, _ALIASES)}"
        )
    try:
        return _REGISTRY[canonical](arg)
    except (TypeError, ValueError) as e:
        if isinstance(e, ValueError) and str(e).startswith(
            ("unknown ordering spec", "bad argument in ordering spec")
        ):
            raise
        raise ValueError(f"bad argument in ordering spec {spec!r}: {e}")
