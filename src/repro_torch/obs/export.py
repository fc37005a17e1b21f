"""Exporters: Chrome-trace JSON, JSONL flight records, and a
Prometheus-style metrics registry.

Three consumers of the same instrumentation, in decreasing order of
fidelity:

* :func:`chrome_trace` — the full span tree plus per-superstep counter
  tracks as a Chrome trace-event JSON (load in Perfetto / chrome://
  tracing).  Spans become ``ph:"X"`` complete events; each
  :class:`~repro_torch.obs.recorder.SolveTrace` contributes ``ph:"C"``
  counter tracks (pending / eligible / bytes per superstep) with
  timestamps interpolated inside the segment spans that produced them.
* :func:`flight_jsonl` — one JSON object per line (spans, events,
  supersteps) for offline analysis; ``launch/obs.py summarize``
  re-reads these.
* :class:`MetricsRegistry` — live counters / gauges / histograms with
  Prometheus text exposition (format 0.0.4), served by
  :func:`serve_metrics` for ``launch/serve.py --metrics-port``.

Everything here is stdlib-only; no Prometheus client library is
assumed.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Iterable, Optional

from repro_torch.obs.trace import Tracer

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "chrome_trace",
    "flight_jsonl",
    "serve_metrics",
    "write_chrome_trace",
    "write_flight_jsonl",
]


# ---------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------

def _fmt_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        '%s="%s"' % (k, str(v).replace("\\", "\\\\").replace('"', '\\"'))
        for k, v in sorted(labels.items())
    )
    return "{%s}" % inner


def _fmt_value(v: float) -> str:
    # Prometheus wants decimal floats; integers render without the
    # trailing .0 for readability.
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


class Counter:
    """Monotonically increasing value."""

    kind = "counter"

    def __init__(self) -> None:
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter increment must be >= 0: {amount}")
        with self._lock:
            self.value += amount

    def samples(self, name: str, labels: dict[str, str]) -> list[tuple[str, float]]:
        return [(name + _fmt_labels(labels), self.value)]


class Gauge:
    """Set-to-current value; optionally backed by a callback so the
    exposition always reflects live state (e.g. cache bytes)."""

    kind = "gauge"

    def __init__(self, fn: Optional[Callable[[], float]] = None) -> None:
        self.value = 0.0
        self.fn = fn
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def samples(self, name: str, labels: dict[str, str]) -> list[tuple[str, float]]:
        v = self.value if self.fn is None else float(self.fn())
        return [(name + _fmt_labels(labels), v)]


# Latency-oriented default: 1ms .. ~16s, powers of 4.
_DEFAULT_BUCKETS = (0.001, 0.004, 0.016, 0.064, 0.256, 1.024, 4.096, 16.384)


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics: each bucket
    counts observations <= its upper bound; +Inf bucket == count)."""

    kind = "histogram"

    def __init__(self, buckets: Iterable[float] = _DEFAULT_BUCKETS) -> None:
        self.bounds = tuple(sorted(float(b) for b in buckets))
        if not self.bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self.counts = [0] * len(self.bounds)
        self.count = 0
        self.total = 0.0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        with self._lock:
            self.count += 1
            self.total += value
            for i, b in enumerate(self.bounds):
                if value <= b:
                    self.counts[i] += 1

    def samples(self, name: str, labels: dict[str, str]) -> list[tuple[str, float]]:
        out: list[tuple[str, float]] = []
        for b, c in zip(self.bounds, self.counts):
            lb = dict(labels)
            lb["le"] = _fmt_value(b)
            out.append((name + "_bucket" + _fmt_labels(lb), float(c)))
        lb = dict(labels)
        lb["le"] = "+Inf"
        out.append((name + "_bucket" + _fmt_labels(lb), float(self.count)))
        out.append((name + "_sum" + _fmt_labels(labels), self.total))
        out.append((name + "_count" + _fmt_labels(labels), float(self.count)))
        return out


class MetricsRegistry:
    """Named, labeled metric families with text exposition.

    ``counter``/``gauge``/``histogram`` are get-or-create: repeat calls
    with the same name+labels return the same instrument, so call sites
    never need to pre-register anything.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # name -> (kind, help, {sorted-label-items -> instrument})
        self._families: dict[str, tuple[str, str, dict[tuple, Any]]] = {}

    def _get(self, name: str, kind: str, help: str,
             labels: Optional[dict[str, str]], factory: Callable[[], Any]) -> Any:
        key = tuple(sorted((labels or {}).items()))
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = (kind, help, {})
                self._families[name] = fam
            elif fam[0] != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam[0]}, not {kind}")
            series = fam[2]
            inst = series.get(key)
            if inst is None:
                inst = factory()
                series[key] = inst
            return inst

    def counter(self, name: str, help: str = "",
                labels: Optional[dict[str, str]] = None) -> Counter:
        return self._get(name, "counter", help, labels, Counter)

    def gauge(self, name: str, help: str = "",
              labels: Optional[dict[str, str]] = None,
              fn: Optional[Callable[[], float]] = None) -> Gauge:
        g = self._get(name, "gauge", help, labels, lambda: Gauge(fn))
        if fn is not None:
            g.fn = fn
        return g

    def histogram(self, name: str, help: str = "",
                  labels: Optional[dict[str, str]] = None,
                  buckets: Iterable[float] = _DEFAULT_BUCKETS) -> Histogram:
        return self._get(name, "histogram", help, labels,
                         lambda: Histogram(buckets))

    def expose(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: list[str] = []
        with self._lock:
            families = sorted(self._families.items())
        for name, (kind, help, series) in families:
            if help:
                lines.append(f"# HELP {name} {help}")
            lines.append(f"# TYPE {name} {kind}")
            for key in sorted(series):
                inst = series[key]
                for sample, value in inst.samples(name, dict(key)):
                    lines.append(f"{sample} {_fmt_value(value)}")
        return "\n".join(lines) + "\n"

    def as_dict(self) -> dict[str, Any]:
        """JSON-friendly snapshot (the ``/stats`` endpoint)."""
        out: dict[str, Any] = {}
        with self._lock:
            families = sorted(self._families.items())
        for name, (kind, _help, series) in families:
            rows = []
            for key in sorted(series):
                inst = series[key]
                for sample, value in inst.samples(name, dict(key)):
                    rows.append({"series": sample, "value": value})
            out[name] = {"type": kind, "samples": rows}
        return out


# ---------------------------------------------------------------------
# Chrome trace-event export
# ---------------------------------------------------------------------

def _us(t: float, t_base: float) -> float:
    return (t - t_base) * 1e6


def chrome_trace(tracer: Tracer,
                 solve_traces: Iterable[Any] = (),
                 process_name: str = "repro") -> dict[str, Any]:
    """Build a Chrome trace-event JSON object from a tracer's records
    plus any :class:`~repro_torch.obs.recorder.SolveTrace` objects.

    Spans map to ``ph:"X"`` complete events (one track per thread);
    events to ``ph:"i"`` instants; each solve trace contributes
    ``ph:"C"`` counter tracks (pending / eligible / bytes_moved per
    superstep).  Counter timestamps interpolate uniformly inside the
    wall-clock window of the segment that produced the superstep, so
    the convergence curve lines up with the segment spans above it.
    """
    spans = list(tracer.spans)
    events = list(tracer.events)
    t_base = min(
        [s.t0 for s in spans] + [e.t for e in events],
        default=0.0,
    )
    tids: dict[str, int] = {}

    def tid(thread: str) -> int:
        if thread not in tids:
            tids[thread] = len(tids) + 1
        return tids[thread]

    out: list[dict[str, Any]] = [{
        "name": "process_name", "ph": "M", "pid": 1, "tid": 0,
        "args": {"name": process_name},
    }]
    for s in spans:
        out.append({
            "name": s.name, "ph": "X", "pid": 1, "tid": tid(s.thread),
            "ts": _us(s.t0, t_base), "dur": (s.t1 - s.t0) * 1e6,
            "args": dict(s.attrs, span_id=s.span_id,
                         parent_id=s.parent_id),
        })
    for e in events:
        out.append({
            "name": e.name, "ph": "i", "pid": 1, "tid": tid(e.thread),
            "ts": _us(e.t, t_base), "s": "t",
            "args": dict(e.attrs, span_id=e.span_id),
        })
    for tr_i, tr in enumerate(solve_traces):
        label = getattr(tr, "config_name", None) or f"solve{tr_i}"
        step0 = 0
        for seg in tr.segments:
            n_steps = seg["supersteps"]
            if n_steps <= 0:
                continue
            t0, t1 = seg["t0"], seg["t1"]
            dt = (t1 - t0) / n_steps
            for j in range(n_steps):
                k = step0 + j
                ts = _us(t0 + j * dt, t_base)
                out.append({
                    "name": f"{label} frontier", "ph": "C", "pid": 1,
                    "tid": 0, "ts": ts,
                    "args": {"pending": tr.pending[k],
                             "eligible": tr.eligible[k]},
                })
                out.append({
                    "name": f"{label} bytes", "ph": "C", "pid": 1,
                    "tid": 0, "ts": ts,
                    "args": {"bytes_moved": tr.bytes_moved[k]},
                })
            step0 += n_steps
    for thread, t in tids.items():
        out.append({
            "name": "thread_name", "ph": "M", "pid": 1, "tid": t,
            "args": {"name": thread},
        })
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, tracer: Tracer,
                       solve_traces: Iterable[Any] = ()) -> None:
    with open(path, "w") as f:
        json.dump(chrome_trace(tracer, solve_traces), f)


# ---------------------------------------------------------------------
# JSONL flight records
# ---------------------------------------------------------------------

def flight_jsonl(tracer: Optional[Tracer] = None,
                 solve_traces: Iterable[Any] = ()) -> list[str]:
    """Serialize records as JSON lines: ``{"kind": "span"|"event"|
    "superstep"|"solve", ...}``.  Order: solve headers, supersteps,
    spans, events."""
    lines: list[str] = []
    for tr in solve_traces:
        lines.append(json.dumps({"kind": "solve", **tr.as_dict()}))
        for rec in tr.superstep_records():
            lines.append(json.dumps({"kind": "superstep", **rec}))
    if tracer is not None:
        for s in tracer.spans:
            lines.append(json.dumps({"kind": "span", **s.as_dict()}))
        for e in tracer.events:
            lines.append(json.dumps({"kind": "event", **e.as_dict()}))
    return lines


def write_flight_jsonl(path: str, tracer: Optional[Tracer] = None,
                       solve_traces: Iterable[Any] = ()) -> None:
    with open(path, "w") as f:
        for line in flight_jsonl(tracer, solve_traces):
            f.write(line + "\n")


# ---------------------------------------------------------------------
# HTTP exposition
# ---------------------------------------------------------------------

def serve_metrics(registry: MetricsRegistry, port: int,
                  host: str = "127.0.0.1") -> ThreadingHTTPServer:
    """Serve ``/metrics`` (Prometheus text) and ``/stats`` (JSON) on a
    daemon thread; returns the server (call ``.shutdown()`` to stop).
    Port 0 picks a free port — read it back from
    ``server.server_address[1]``."""

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self) -> None:  # noqa: N802 (http.server API)
            if self.path.split("?")[0] == "/metrics":
                body = registry.expose().encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif self.path.split("?")[0] == "/stats":
                body = json.dumps(registry.as_dict(), indent=2).encode()
                ctype = "application/json"
            else:
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, format: str, *args: Any) -> None:
            pass  # silence per-request stderr noise

    server = ThreadingHTTPServer((host, port), Handler)
    thread = threading.Thread(target=server.serve_forever,
                              name="obs-metrics", daemon=True)
    thread.start()
    return server
