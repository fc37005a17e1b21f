"""Observability of the port: span tracing, per-superstep flight
recording, and metrics exposition.

* :mod:`repro_torch.obs.trace` — the span tracer, a no-op unless a
  :class:`Tracer` is installed with :func:`use_tracer`.
* :mod:`repro_torch.obs.recorder` — the ``/trace`` flight recorder: a
  solve runs through the segment engine to publish per-superstep
  windows (bit-identical to the untraced solve), gathered into a
  :class:`SolveTrace` on ``Solution.trace``.
* :mod:`repro_torch.obs.export` — Chrome-trace/Perfetto JSON, JSONL
  flight records, and a Prometheus-style :class:`MetricsRegistry` with
  text exposition (``launch/serve.py --metrics-port``).
"""

from repro_torch.obs.export import (
    MetricsRegistry,
    chrome_trace,
    flight_jsonl,
    serve_metrics,
    write_chrome_trace,
    write_flight_jsonl,
)
from repro_torch.obs.recorder import FlightRecorder, SolveTrace
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
    "FlightRecorder",
    "MetricsRegistry",
    "SolveTrace",
    "Span",
    "Tracer",
    "chrome_trace",
    "current_tracer",
    "event",
    "flight_jsonl",
    "serve_metrics",
    "set_tracer",
    "span",
    "use_tracer",
    "write_chrome_trace",
    "write_flight_jsonl",
]
