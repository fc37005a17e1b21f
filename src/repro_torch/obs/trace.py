"""Span tracer of the port: nested spans and point events with
monotonic timestamps, recorded by the solver (``solver.solve``,
``solver.partition``, ``solver.solve_batch``, ``solver.resolve``, ...)
and the serving tier (``router.flush``, ``landmarks.build``,
``feed.apply``, ...) under the same names as the JAX package's
``repro.obs.trace``.

* Near-zero cost when off: with no tracer installed, ``span()`` and
  ``event()`` read one module global and return a shared no-op.
* Thread-safe when on: records append under a lock; the span stack
  (parent attribution) is thread-local.
* Testable time: the clock is injected (``Tracer(clock=...)``).
* Bounded: past ``max_records`` new records are dropped and counted.
* Per process: over a process backend each rank process keeps its own
  tracer; a caller reports rank 0's.

Usage::

    from repro_torch.obs import trace as obs

    tracer = obs.Tracer()
    with obs.use_tracer(tracer):
        with obs.span("solve", spec="delta:5/sparse") as sp:
            obs.event("partition_memo_hit")
            sp.set(supersteps=17)
    tracer.spans[0].duration_s
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from typing import Any, Callable, Iterator, Optional

__all__ = [
    "Event",
    "Span",
    "SpanHandle",
    "Tracer",
    "current_tracer",
    "event",
    "now",
    "set_tracer",
    "span",
    "use_tracer",
]


@dataclasses.dataclass
class Span:
    """One closed span: a named wall-clock interval with attributes."""

    name: str
    t0: float
    t1: float
    attrs: dict[str, Any]
    span_id: int
    parent_id: Optional[int]
    thread: str

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0

    def as_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Event:
    """One point-in-time record, attributed to the enclosing span."""

    name: str
    t: float
    attrs: dict[str, Any]
    span_id: Optional[int]
    thread: str

    def as_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


class SpanHandle:
    """Context manager for one open span.  ``set(**attrs)`` adds
    attributes any time before exit."""

    __slots__ = ("_tracer", "name", "attrs", "t0", "span_id", "parent_id")

    def __init__(
        self,
        tracer: "Tracer",
        name: str,
        attrs: dict[str, Any],
        parent_id: Optional[int],
    ):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.t0 = tracer.clock()
        self.span_id = tracer._next_id()
        self.parent_id = parent_id

    def set(self, **attrs: Any) -> "SpanHandle":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "SpanHandle":
        self._tracer._push(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        self._tracer._pop(self)


class _NoopSpan:
    """Shared do-nothing span for the tracer-off fast path."""

    __slots__ = ()

    def set(self, **attrs: Any) -> "_NoopSpan":
        return self

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        return None


_NOOP = _NoopSpan()


class Tracer:
    """Thread-safe span/event recorder with an injectable monotonic
    clock and a bounded record buffer.

    ``registry`` (optional, a :class:`repro_torch.obs.export.
    MetricsRegistry`) receives every closed span as a
    ``repro_span_seconds{span=...}`` histogram observation and every
    event as a ``repro_events_total{event=...}`` counter increment, so
    the live metrics come from the same instrumentation as the trace.
    """

    def __init__(
        self,
        clock: Callable[[], float] = time.perf_counter,
        registry: Optional[Any] = None,
        max_records: int = 200_000,
    ):
        if max_records <= 0:
            raise ValueError(f"max_records must be positive: {max_records}")
        self.clock = clock
        self.registry = registry
        self.max_records = int(max_records)
        self.spans: list[Span] = []
        self.events: list[Event] = []
        self.dropped = 0
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._local = threading.local()

    # -- record plumbing ----------------------------------------------

    def _next_id(self) -> int:
        return next(self._ids)

    def _stack(self) -> list[SpanHandle]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = []
            self._local.stack = st
        return st

    def current_span_id(self) -> Optional[int]:
        st = self._stack()
        return st[-1].span_id if st else None

    def _push(self, handle: SpanHandle) -> None:
        self._stack().append(handle)

    def _pop(self, handle: SpanHandle) -> None:
        t1 = self.clock()
        st = self._stack()
        if st and st[-1] is handle:
            st.pop()
        rec = Span(
            name=handle.name,
            t0=handle.t0,
            t1=t1,
            attrs=handle.attrs,
            span_id=handle.span_id,
            parent_id=handle.parent_id,
            thread=threading.current_thread().name,
        )
        with self._lock:
            if len(self.spans) + len(self.events) >= self.max_records:
                self.dropped += 1
            else:
                self.spans.append(rec)
        if self.registry is not None:
            self.registry.histogram(
                "repro_span_seconds",
                help="wall seconds per traced span",
                labels={"span": handle.name},
            ).observe(rec.duration_s)

    # -- public API ----------------------------------------------------

    def span(self, name: str, **attrs: Any) -> SpanHandle:
        return SpanHandle(self, name, attrs, self.current_span_id())

    def event(self, name: str, **attrs: Any) -> None:
        rec = Event(
            name=name,
            t=self.clock(),
            attrs=attrs,
            span_id=self.current_span_id(),
            thread=threading.current_thread().name,
        )
        with self._lock:
            if len(self.spans) + len(self.events) >= self.max_records:
                self.dropped += 1
            else:
                self.events.append(rec)
        if self.registry is not None:
            self.registry.counter(
                "repro_events_total",
                help="traced point events",
                labels={"event": name},
            ).inc()

    def clear(self) -> None:
        with self._lock:
            self.spans.clear()
            self.events.clear()
            self.dropped = 0

    def find(self, name: str) -> list[Span]:
        """Closed spans with this name (test convenience)."""
        with self._lock:
            return [s for s in self.spans if s.name == name]

    def children_of(self, span_id: int) -> list[Span]:
        with self._lock:
            return [s for s in self.spans if s.parent_id == span_id]


# ---------------------------------------------------------------------
# module-level current tracer (the instrumentation call sites)
# ---------------------------------------------------------------------

_TRACER: Optional[Tracer] = None


def current_tracer() -> Optional[Tracer]:
    return _TRACER


def set_tracer(tracer: Optional[Tracer]) -> Optional[Tracer]:
    """Install ``tracer`` as the process-wide current tracer; returns
    the previous one.  ``None`` disables tracing (the fast path)."""
    global _TRACER
    prev = _TRACER
    _TRACER = tracer
    return prev


@contextlib.contextmanager
def use_tracer(tracer: Optional[Tracer]) -> Iterator[Optional[Tracer]]:
    """Scoped :func:`set_tracer` — restores the previous tracer on
    exit, so tests and CLIs never leak instrumentation state."""
    prev = set_tracer(tracer)
    try:
        yield tracer
    finally:
        set_tracer(prev)


def span(name: str, **attrs: Any):
    """Open a span on the current tracer (no-op when tracing is off).
    Usable as a context manager; the yielded handle accepts
    ``.set(**attrs)``."""
    t = _TRACER
    if t is None:
        return _NOOP
    return t.span(name, **attrs)


def event(name: str, **attrs: Any) -> None:
    """Record a point event on the current tracer (no-op when off)."""
    t = _TRACER
    if t is not None:
        t.event(name, **attrs)


def now() -> float:
    """The current tracer's clock (``time.perf_counter`` when tracing
    is off) — lets instrumented code stamp records consistently with
    the spans around them."""
    t = _TRACER
    return t.clock() if t is not None else time.perf_counter()
