"""Observability of the port: the span tracer (:mod:`repro_torch.obs.trace`),
a no-op unless a :class:`Tracer` is installed with :func:`use_tracer`."""

from repro_torch.obs.trace import (
    Event,
    Span,
    Tracer,
    current_tracer,
    event,
    set_tracer,
    span,
    use_tracer,
)

__all__ = [
    "Event",
    "Span",
    "Tracer",
    "current_tracer",
    "event",
    "set_tracer",
    "span",
    "use_tracer",
]
