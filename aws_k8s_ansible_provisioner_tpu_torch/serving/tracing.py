"""Dependency-free distributed tracing for the serving path (W3C + OTLP).

A copy of the JAX package's ``serving/tracing.py`` (the port imports nothing
of that package). The deploy stack ships a trace pipeline — an OTEL collector
with an OTLP receiver forwarding to a Tempo backend
(deploy/otel-observability-setup.yaml) — and this module is the serving
path's producer, in the same zero-dependency idiom as the rest of the serving
stack (stdlib http.client, no opentelemetry-sdk):

- **W3C Trace Context**: :func:`parse_traceparent` / :func:`format_traceparent`
  speak the ``traceparent`` header (``00-<32hex>-<16hex>-<2hex>``), so the
  router's root context propagates through every dispatch hop into the server,
  and an upstream caller's own traceparent is continued rather than replaced.
- **Spans**: :class:`Tracer` creates spans with explicit start/end timestamps —
  phase children (queue-wait, prefill, decode) are built *retroactively* from
  the engine's Request timestamps, so the engine's hot loop never touches the
  tracer. Ids come from a seedable generator (``TPU_SERVE_TRACE_SEED`` or
  ``Tracer(seed=...)``) so tests can assert a byte-exact golden span tree.
- **Export**: :class:`OTLPHTTPExporter` batches finished spans on a background
  thread and POSTs OTLP/JSON to ``<endpoint>/v1/traces``. The queue is
  bounded and the failure mode is DROP: a dead/hanging/5xx-ing collector can
  never stall or fail a request — it only increments
  ``tpu_serve_spans_dropped_total`` (the same contract as the engine's
  load-shed counters: degradation is observable, never amplifying).

Engine Request timestamps are ``time.monotonic()``; OTLP wants unix nanos.
:func:`mono_ns` maps between the clocks through one (monotonic, wall) pair
captured at import, so all spans in a process share a consistent skew.
"""

from __future__ import annotations

import json
import os
import queue
import random
import threading
import time
import urllib.parse
from typing import Dict, List, Optional

from aws_k8s_ansible_provisioner_tpu_torch.serving import chaos as _chaos
from aws_k8s_ansible_provisioner_tpu_torch.serving.metrics import Counter, Registry

TRACEPARENT_HEADER = "traceparent"

# OTLP SpanKind enum values (trace.proto): the three the serving path uses.
KIND_INTERNAL = 1
KIND_SERVER = 2
KIND_CLIENT = 3

# The serving tree's ONLY sanctioned wall-clock reads: every
# other site must use time.monotonic()/mono_ns — deadline or duration math
# on the wall clock breaks the moment NTP steps it. True wall-clock stamps
# (API ``created`` fields, span timestamps, log lines) route through these
# two helpers so the intent is explicit and greppable.


def wall_clock() -> float:
    """Current unix time in seconds — the explicit wall-clock stamp."""
    return time.time()


def wall_clock_ns() -> int:
    """Current unix time in nanoseconds — the explicit wall-clock stamp."""
    return time.time_ns()


# One (monotonic, wall) reference pair per process: every span derived from
# engine monotonic timestamps shares the same skew, so phase children never
# jitter against each other even if the wall clock steps mid-request.
_MONO_REF = time.monotonic()
_WALL_REF_NS = wall_clock_ns()


def mono_ns(t_mono: float) -> int:
    """Map a ``time.monotonic()`` reading onto the unix-nano timeline."""
    return _WALL_REF_NS + int((t_mono - _MONO_REF) * 1e9)


class TraceMetrics:
    """The tracing layer's own counters, rendered by BOTH the engine's and
    the router's /metrics routes (the subsystem is shared; its drop counter
    is the one signal that distinguishes 'collector outage' from 'tracing
    off')."""

    def __init__(self):
        self.registry = Registry()
        r = self.registry
        self.spans_dropped = r.register(Counter(
            "tpu_serve_spans_dropped_total",
            "Finished spans dropped instead of exported, by reason "
            "(queue_full = bounded queue at capacity; export_error = "
            "collector refused/hung/5xx'd — requests are never stalled "
            "either way)", ("reason",)))
        self.spans_exported = r.register(Counter(
            "tpu_serve_spans_exported_total",
            "Spans accepted by the OTLP endpoint"))
        self.export_failures = r.register(Counter(
            "tpu_serve_span_export_failures_total",
            "Failed OTLP export batches (each drops its spans)"))


# Process-wide: the exporter(s) and both /metrics routes share these.
metrics = TraceMetrics()


class SpanContext:
    """Identity that crosses process boundaries: (trace_id, span_id, sampled).

    ``trace_id`` is 32 lowercase hex chars, ``span_id`` 16 — the W3C wire
    widths, kept as strings end-to-end (they are echoed into response bodies
    and OTLP/JSON, both of which want hex text)."""

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id: str, span_id: str, sampled: bool = True):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = sampled

    def __repr__(self):
        return (f"SpanContext({self.trace_id}, {self.span_id}, "
                f"sampled={self.sampled})")


def parse_traceparent(value: Optional[str]) -> Optional[SpanContext]:
    """Parse a W3C ``traceparent`` header; None for absent/malformed.

    Malformed headers are treated as absent (a fresh trace starts) — the
    W3C-specified recovery; tracing must never 4xx a request."""
    if not value or not isinstance(value, str):
        return None
    parts = value.strip().lower().split("-")
    if len(parts) < 4:
        return None
    version, trace_id, span_id, flags = parts[0], parts[1], parts[2], parts[3]
    if version == "ff" or len(version) != 2:
        return None
    if len(trace_id) != 32 or len(span_id) != 16 or len(flags) != 2:
        return None
    try:
        int(version, 16)
        t = int(trace_id, 16)
        s = int(span_id, 16)
        f = int(flags, 16)
    except ValueError:
        return None
    if t == 0 or s == 0:    # all-zero ids are invalid per spec
        return None
    return SpanContext(trace_id, span_id, sampled=bool(f & 0x01))


def format_traceparent(ctx: SpanContext) -> str:
    """Render the context as a version-00 ``traceparent`` header value."""
    return f"00-{ctx.trace_id}-{ctx.span_id}-{'01' if ctx.sampled else '00'}"


class Span:
    """One timed operation. Mutable until :meth:`Tracer.finish`."""

    __slots__ = ("name", "context", "parent_span_id", "kind", "start_ns",
                 "end_ns", "attributes", "status", "status_message")

    def __init__(self, name: str, context: SpanContext,
                 parent_span_id: str = "", kind: int = KIND_INTERNAL,
                 start_ns: Optional[int] = None,
                 attributes: Optional[dict] = None):
        self.name = name
        self.context = context
        self.parent_span_id = parent_span_id
        self.kind = kind
        self.start_ns = wall_clock_ns() if start_ns is None else int(start_ns)
        self.end_ns: Optional[int] = None
        self.attributes: Dict[str, object] = dict(attributes or {})
        self.status = "unset"       # "unset" | "ok" | "error"
        self.status_message = ""

    def set_attribute(self, key: str, value) -> "Span":
        self.attributes[key] = value
        return self

    def error(self, message: str) -> "Span":
        self.status = "error"
        self.status_message = str(message)
        return self


class Tracer:
    """Span factory with W3C propagation and (optionally seeded) id
    generation. One instance per component (router / engine server) so each
    carries its own ``service.name`` resource, even in-process in tests."""

    def __init__(self, service_name: str = "tpu-serve",
                 exporter: Optional["OTLPHTTPExporter"] = None,
                 sample: float = 1.0, seed: Optional[int] = None):
        self.service_name = service_name
        self.exporter = exporter
        self.sample = max(0.0, min(1.0, float(sample)))
        # Deterministic ids for golden tests; os.urandom entropy otherwise
        # (replicas must not collide). The lock serializes the seeded RNG so
        # concurrent handler threads still draw a well-defined sequence.
        self._rng = random.Random(seed) if seed is not None else None
        self._lock = threading.Lock()

    def _hex(self, nbits: int) -> str:
        width = nbits // 4
        while True:
            if self._rng is not None:
                with self._lock:
                    v = self._rng.getrandbits(nbits)
            else:
                v = int.from_bytes(os.urandom(nbits // 8), "big")
            if v:           # the all-zero id is invalid on the wire
                return format(v, f"0{width}x")

    def _sampled(self) -> bool:
        if self.sample >= 1.0:
            return True
        if self.sample <= 0.0:
            return False
        if self._rng is not None:
            with self._lock:
                return self._rng.random() < self.sample
        return int.from_bytes(os.urandom(4), "big") < self.sample * 2**32

    def start_span(self, name: str, parent: Optional[SpanContext] = None,
                   kind: int = KIND_INTERNAL,
                   attributes: Optional[dict] = None,
                   start_ns: Optional[int] = None) -> Span:
        """New span. With ``parent``, joins its trace and inherits its
        sampling decision (the W3C parent-based policy: the root decides
        once, the whole tree follows); without, starts a trace and decides
        by ``sample``."""
        if parent is not None:
            ctx = SpanContext(parent.trace_id, self._hex(64), parent.sampled)
            return Span(name, ctx, parent_span_id=parent.span_id, kind=kind,
                        start_ns=start_ns, attributes=attributes)
        ctx = SpanContext(self._hex(128), self._hex(64), self._sampled())
        return Span(name, ctx, kind=kind, start_ns=start_ns,
                    attributes=attributes)

    def finish(self, span: Span, end_ns: Optional[int] = None) -> Span:
        """Seal the span and hand it to the exporter (non-blocking, may
        drop). Unsampled spans are created-but-never-exported: their ids
        still flow into responses for log correlation."""
        if span.end_ns is None:
            span.end_ns = wall_clock_ns() if end_ns is None else int(end_ns)
        if span.end_ns < span.start_ns:
            span.end_ns = span.start_ns
        if self.exporter is not None and span.context.sampled:
            self.exporter.export(span, self.service_name)
        return span

    def emit_span(self, name: str, parent: SpanContext, start_ns: int,
                  end_ns: int, kind: int = KIND_INTERNAL,
                  attributes: Optional[dict] = None) -> Span:
        """Create-and-finish a retroactive span from explicit timestamps —
        how the server turns engine Request timings into phase children
        without the engine ever holding a tracer."""
        span = self.start_span(name, parent=parent, kind=kind,
                               attributes=attributes, start_ns=start_ns)
        return self.finish(span, end_ns=end_ns)


# ---------------------------------------------------------------------------
# OTLP/HTTP JSON export
# ---------------------------------------------------------------------------


def _attr_value(v) -> dict:
    """OTLP AnyValue JSON encoding (bool before int: bool is an int
    subclass)."""
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}     # proto JSON maps int64 to string
    if isinstance(v, float):
        return {"doubleValue": v}
    return {"stringValue": str(v)}


def _encode_attrs(attrs: dict) -> List[dict]:
    return [{"key": k, "value": _attr_value(v)} for k, v in attrs.items()]


def encode_spans(items: List[tuple]) -> dict:
    """OTLP/JSON ExportTraceServiceRequest for (span, service_name) pairs,
    grouped into one resourceSpans entry per service."""
    by_service: Dict[str, List[Span]] = {}
    for span, service in items:
        by_service.setdefault(service, []).append(span)
    resource_spans = []
    for service, spans in by_service.items():
        encoded = []
        for s in spans:
            d = {
                "traceId": s.context.trace_id,
                "spanId": s.context.span_id,
                "name": s.name,
                "kind": s.kind,
                "startTimeUnixNano": str(s.start_ns),
                "endTimeUnixNano": str(s.end_ns or s.start_ns),
                "attributes": _encode_attrs(s.attributes),
            }
            if s.parent_span_id:
                d["parentSpanId"] = s.parent_span_id
            if s.status == "error":
                d["status"] = {"code": 2, "message": s.status_message}
            elif s.status == "ok":
                d["status"] = {"code": 1}
            encoded.append(d)
        resource_spans.append({
            "resource": {"attributes": _encode_attrs(
                {"service.name": service})},
            "scopeSpans": [{"scope": {"name": "tpu_serve.tracing"},
                            "spans": encoded}],
        })
    return {"resourceSpans": resource_spans}


class OTLPHTTPExporter:
    """Batching OTLP/HTTP JSON exporter: bounded queue, background thread,
    drop-on-failure.

    The request path only ever executes :meth:`export` — a lock-free
    ``put_nowait`` — so the worst a collector outage can cost a request is
    that enqueue. Everything that can block (connect, send, a chaos-injected
    hang) happens on the worker thread, and every failure converts to
    ``tpu_serve_spans_dropped_total`` instead of backpressure."""

    def __init__(self, endpoint: str, batch_size: int = 64,
                 flush_interval_s: float = 1.0, queue_max: int = 2048,
                 timeout_s: float = 5.0):
        u = urllib.parse.urlsplit(endpoint if "://" in endpoint
                                  else "http://" + endpoint)
        self.host = u.hostname or "127.0.0.1"
        self.port = u.port or 4318
        self.path = (u.path.rstrip("/") or "") + "/v1/traces"
        self.endpoint = endpoint
        self.batch_size = max(1, int(batch_size))
        self.flush_interval_s = float(flush_interval_s)
        self.timeout_s = float(timeout_s)
        self._q: "queue.Queue[tuple]" = queue.Queue(maxsize=max(1, queue_max))
        self._stop = threading.Event()
        self._busy = False          # worker holds a batch (flush() polls)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="otlp-exporter")
        self._thread.start()

    # -- request-path side ---------------------------------------------------

    def export(self, span: Span, service_name: str) -> bool:
        """Enqueue one finished span. Never blocks, never raises; a full
        queue drops the span and counts it."""
        try:
            self._q.put_nowait((span, service_name))
            return True
        except queue.Full:
            metrics.spans_dropped.inc(reason="queue_full")
            return False

    # -- worker side ---------------------------------------------------------

    def _run(self):
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=self.flush_interval_s)
            except queue.Empty:
                continue
            if first is None:       # shutdown sentinel
                break
            self._busy = True
            batch = [first]
            while len(batch) < self.batch_size:
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    break
                if item is None:
                    self._stop.set()
                    break
                batch.append(item)
            try:
                self._send(batch)
                metrics.spans_exported.inc(len(batch))
            except Exception:
                # Drop, count, carry on: a dead collector costs telemetry,
                # never requests. (Includes the chaos-injected refuse/hang/
                # 5xx faults.)
                metrics.export_failures.inc()
                metrics.spans_dropped.inc(len(batch), reason="export_error")
            finally:
                self._busy = False

    def _send(self, batch: List[tuple]):
        import http.client

        ch = _chaos.get()
        if ch.enabled:
            ch.on_span_export()     # fault point: refuse / hang / 5xx
        body = json.dumps(encode_spans(batch)).encode()
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout_s)
        try:
            conn.request("POST", self.path, body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            resp.read()
            if resp.status >= 400:
                raise RuntimeError(f"OTLP endpoint answered {resp.status}")
        finally:
            conn.close()

    # -- lifecycle -----------------------------------------------------------

    def flush(self, timeout_s: float = 5.0) -> bool:
        """Best-effort wait until the queue is drained and no batch is in
        flight (tests; the request path never calls this)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self._q.empty() and not self._busy:
                return True
            time.sleep(0.01)
        return False

    def shutdown(self, timeout_s: float = 2.0):
        self.flush(timeout_s)
        self._stop.set()
        try:
            self._q.put_nowait(None)
        except queue.Full:
            pass
        self._thread.join(timeout=timeout_s)


# ---------------------------------------------------------------------------
# Module-level wiring
# ---------------------------------------------------------------------------

_default_tracer: Optional[Tracer] = None
_default_lock = threading.Lock()


def build_tracer(service_name: str, endpoint: Optional[str] = None,
                 sample: float = 1.0,
                 seed: Optional[int] = None) -> Tracer:
    """Assemble a tracer for one component. ``endpoint`` falls back to
    ``$OTEL_EXPORTER_OTLP_ENDPOINT`` (the standard env the serving manifest
    sets from ansible_vars); empty = spans are created (ids echo into
    responses) but never exported. ``seed`` falls back to
    ``$TPU_SERVE_TRACE_SEED`` for reproducible harnesses."""
    if endpoint is None:
        endpoint = os.environ.get("OTEL_EXPORTER_OTLP_ENDPOINT", "")
    if seed is None:
        raw = os.environ.get("TPU_SERVE_TRACE_SEED", "")
        if raw:
            try:
                seed = int(raw)
            except ValueError:
                seed = None
    exporter = OTLPHTTPExporter(endpoint) if endpoint else None
    return Tracer(service_name, exporter=exporter, sample=sample, seed=seed)


def configure(service_name: str = "tpu-serve",
              endpoint: Optional[str] = None, sample: float = 1.0,
              seed: Optional[int] = None) -> Tracer:
    """Build and install the process-default tracer (components that carry
    their own Tracer — router, server — don't need this)."""
    global _default_tracer
    tracer = build_tracer(service_name, endpoint=endpoint, sample=sample,
                          seed=seed)
    with _default_lock:
        _default_tracer = tracer
    return tracer


def get_tracer() -> Tracer:
    """The process-default tracer; lazily a no-export tracer honoring
    ``$OTEL_EXPORTER_OTLP_ENDPOINT`` when set."""
    global _default_tracer
    with _default_lock:
        if _default_tracer is None:
            _default_tracer = build_tracer("tpu-serve")
        return _default_tracer
