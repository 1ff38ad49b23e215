"""Black-box flight recorder for the serving path (per-request timelines).

When a request dies today — deadline expiry, watchdog stall, shed, failover —
all the stack keeps is a counter increment; the *why* is gone. This module is
the serving path's black box: a lock-light, bounded ring of structured events
(admit, queue, prefill-chunk, pipeline dispatch/fetch, preempt, drain, shed,
deadline-reap, failover-resume, chaos-fault) stamped with ``monotonic_ns``
plus the request's trace/span ids, and — on any anomalous terminal edge — a
snapshot of that request's complete timeline into a capped on-disk JSONL
spool. ``/debug/flight/<request_id>`` and ``/debug/events?last=N`` serve the
snapshots and the live ring.

A copy of the JAX package's ``serving/flightrec.py`` (the port imports
nothing of that package). The contract is the span exporter's
(``serving/tracing.py``), verbatim: recording is
drop-on-overflow and can NEVER block or fail a request. The request path only
ever appends to a bounded deque / dict under a short lock and ``put_nowait``s
snapshots onto a bounded queue; everything that can block (the spool write, a
chaos-injected disk fault) happens on the background writer thread, and every
failure converts to ``tpu_serve_flight_drops_total`` instead of backpressure.

Event timestamps are ``time.monotonic_ns()`` (duration math never
touches the wall clock); dumps add a ``t_unix_ns`` per event through
``tracing.mono_ns`` so timelines line up with the request spans in Tempo.
"""

from __future__ import annotations

import collections
import json
import os
import queue
import threading
import time
from typing import Deque, Dict, List, Optional

from aws_k8s_ansible_provisioner_tpu_torch.serving import chaos as _chaos
from aws_k8s_ansible_provisioner_tpu_torch.serving import tracing as _tracing
from aws_k8s_ansible_provisioner_tpu_torch.serving.metrics import Counter, Registry

# Terminal reasons that do NOT trigger a dump ("" = still unset at finish).
OK_REASONS = ("stop", "length", "")


class FlightMetrics:
    """The recorder's own counters, rendered by BOTH the engine's and the
    router's /metrics routes (the subsystem is shared; the drop counter is
    the one signal that distinguishes 'spool outage' from 'recorder off')."""

    def __init__(self):
        self.registry = Registry()
        r = self.registry
        self.events = r.register(Counter(
            "tpu_serve_flight_events_total",
            "Flight-recorder events appended to the ring"))
        self.drops = r.register(Counter(
            "tpu_serve_flight_drops_total",
            "Flight-recorder events/dumps dropped instead of recorded, by "
            "reason (timeline_overflow / request_overflow = per-request "
            "bounds; spool_queue_full = writer backlog; dump_error = spool "
            "write failed — requests are never stalled either way)",
            ("reason",)))
        self.dumps = r.register(Counter(
            "tpu_serve_flight_dumps_total",
            "Anomaly timelines snapshotted (in-memory + spool attempt)"))
        self.dump_failures = r.register(Counter(
            "tpu_serve_flight_dump_failures_total",
            "Failed spool writes (each drops its dump, counted above)"))


# Process-wide: the recorder(s) and both /metrics routes share these.
metrics = FlightMetrics()


def _evt_dict(evt: tuple) -> dict:
    """Render one ring event tuple as a JSON-safe dict."""
    t_ns, etype, rid, data = evt
    d = {"t_mono_ns": t_ns,
         "t_unix_ns": _tracing.mono_ns(t_ns / 1e9),
         "type": etype}
    if rid is not None:
        d["request_id"] = rid
    if data:
        d.update(data)
    return d


class FlightRecorder:
    """Bounded ring + per-request timelines + background JSONL spool writer.

    Single instance per process (module singleton below); the engine thread
    and server handler threads all record through it. The ring is a plain
    ``deque(maxlen=...)`` (GIL-atomic appends); the per-request timeline map
    takes a short lock because two threads (engine + server) may touch the
    same request's timeline.
    """

    def __init__(self, spool_dir: str = "", enabled: bool = True,
                 ring_cap: int = 4096, max_requests: int = 512,
                 max_events_per_request: int = 256, max_snapshots: int = 64,
                 spool_max_bytes: int = 16 * 1024 * 1024,
                 queue_max: int = 256):
        self.enabled = bool(enabled)
        self.spool_dir = str(spool_dir or "")
        self.spool_max_bytes = int(spool_max_bytes)
        self.max_requests = int(max_requests)
        self.max_events_per_request = int(max_events_per_request)
        self.max_snapshots = int(max_snapshots)
        self._ring: Deque[tuple] = collections.deque(maxlen=max(16, ring_cap))
        self._lock = threading.Lock()
        # rid -> [event, ...] for requests not yet finished (lock-guarded:
        # the engine thread and a server handler thread may append to the
        # same request's timeline)
        self._timelines: Dict[object, List[tuple]] = {}
        # rid -> dump dict for the last max_snapshots anomalies (lock-guarded)
        self._snapshots: "collections.OrderedDict" = collections.OrderedDict()
        self._last_anomaly: Optional[dict] = None
        self._q: "queue.Queue[Optional[dict]]" = queue.Queue(
            maxsize=max(1, queue_max))
        self._stop = threading.Event()
        self._busy = False          # writer holds a dump (flush() polls)
        self._thread: Optional[threading.Thread] = None
        if self.enabled:
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="flight-spool")
            self._thread.start()

    # -- request-path side ---------------------------------------------------

    def record(self, etype: str, rid=None, **data):
        """Append one event. Never blocks, never raises out of bounds —
        overflow drops the event and counts it."""
        if not self.enabled:
            return
        evt = (time.monotonic_ns(), etype, rid, data or None)
        self._ring.append(evt)
        metrics.events.inc()
        if rid is None:
            return
        with self._lock:
            tl = self._timelines.get(rid)
            if tl is None:
                if len(self._timelines) >= self.max_requests:
                    metrics.drops.inc(reason="request_overflow")
                    return
                tl = []
                self._timelines[rid] = tl
            if len(tl) >= self.max_events_per_request:
                metrics.drops.inc(reason="timeline_overflow")
                return
            tl.append(evt)

    def finish(self, rid, reason: str = "", ok: Optional[bool] = None,
               **data):
        """Terminal edge for ``rid``: records the final event and — when the
        edge is anomalous (``ok=False``, or ``reason`` outside OK_REASONS) —
        snapshots the request's complete timeline for /debug/flight and the
        spool. OK finishes just free the timeline."""
        if not self.enabled:
            return
        if ok is None:
            ok = reason in OK_REASONS
        self.record("finish", rid, reason=reason or "stop", ok=bool(ok),
                    **data)
        with self._lock:
            tl = self._timelines.pop(rid, None)
        if ok:
            return
        dump = {
            "request_id": rid,
            "reason": reason,
            "t_unix_ns": _tracing.wall_clock_ns(),
            "events": [_evt_dict(e) for e in (tl or [])],
        }
        for e in dump["events"]:    # hoist trace ids to the top level
            if "trace_id" in e:
                dump["trace_id"] = e["trace_id"]
                dump["span_id"] = e.get("span_id", "")
                break
        metrics.dumps.inc()
        with self._lock:
            self._snapshots[rid] = dump
            while len(self._snapshots) > self.max_snapshots:
                self._snapshots.popitem(last=False)
            self._last_anomaly = {"request_id": rid, "reason": reason,
                                  "t_unix_ns": dump["t_unix_ns"]}
        if not self.spool_dir:
            return
        try:
            self._q.put_nowait(dump)
        except queue.Full:
            metrics.drops.inc(reason="spool_queue_full")

    # -- read side (debug endpoints, /healthz) -------------------------------

    def tail(self, n: int = 100) -> List[dict]:
        """The last ``n`` ring events, oldest first (/debug/events)."""
        evts = list(self._ring)
        return [_evt_dict(e) for e in evts[-max(0, int(n)):]]

    def dump_for(self, rid) -> Optional[dict]:
        """The anomaly snapshot for ``rid`` (/debug/flight/<id>), or the
        LIVE timeline for a still-running request, else None."""
        with self._lock:
            d = self._snapshots.get(rid)
            if d is not None:
                return d
            tl = self._timelines.get(rid)
            if tl is not None:
                return {"request_id": rid, "reason": "", "live": True,
                        "events": [_evt_dict(e) for e in tl]}
        return None

    def summary(self) -> dict:
        """Compact health view (/healthz, router fleet aggregation)."""
        with self._lock:
            last = dict(self._last_anomaly) if self._last_anomaly else None
        return {
            "enabled": self.enabled,
            "events_total": metrics.events.total(),
            "dumps_total": metrics.dumps.total(),
            "drops_total": metrics.drops.total(),
            "last_anomaly": last,
        }

    # -- worker side ---------------------------------------------------------

    def _spool_path(self) -> str:
        return os.path.join(self.spool_dir, "flight.jsonl")

    def _run(self):
        while not self._stop.is_set():
            try:
                dump = self._q.get(timeout=0.25)
            except queue.Empty:
                continue
            if dump is None:        # shutdown sentinel
                break
            self._busy = True
            try:
                self._write(dump)
            except Exception:
                metrics.dump_failures.inc()
                metrics.drops.inc(reason="dump_error")
            finally:
                self._busy = False

    def _write(self, dump: dict):
        ch = _chaos.get()
        if ch.enabled:
            ch.on_flight_dump()     # fault point: disk full / hang
        path = self._spool_path()
        os.makedirs(self.spool_dir, exist_ok=True)
        # capped spool: roll the file aside once it exceeds the budget (one
        # generation of history beats silent unbounded growth)
        try:
            if os.path.getsize(path) > self.spool_max_bytes:
                os.replace(path, path + ".1")
        except OSError:
            pass
        line = json.dumps(dump, separators=(",", ":"), default=str)
        with open(path, "a", encoding="utf-8") as f:
            f.write(line + "\n")

    # -- lifecycle -----------------------------------------------------------

    def flush(self, timeout_s: float = 5.0) -> bool:
        """Best-effort wait until the spool queue drains (tests only)."""
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
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)


# ---------------------------------------------------------------------------
# Module-level wiring: one recorder per process, helpers the hot paths call.
# ---------------------------------------------------------------------------

_recorder: Optional[FlightRecorder] = None
_recorder_lock = threading.Lock()


def get() -> FlightRecorder:
    """The process-wide recorder (a default in-memory one until
    :func:`configure` installs the served configuration)."""
    global _recorder
    with _recorder_lock:
        if _recorder is None:
            _recorder = FlightRecorder()
        return _recorder


def configure(spool_dir: str = "", enabled: bool = True,
              **kw) -> FlightRecorder:
    """Build and install the process recorder (build_state / tests)."""
    global _recorder
    rec = FlightRecorder(spool_dir=spool_dir, enabled=enabled, **kw)
    with _recorder_lock:
        old, _recorder = _recorder, rec
    if old is not None:
        old.shutdown(timeout_s=0.5)
    return rec


def reset() -> FlightRecorder:
    """Fresh default recorder (tests)."""
    return configure()


def record(etype: str, rid=None, **data):
    """Module-level shorthand the engine/server hot paths call."""
    get().record(etype, rid, **data)


def finish(rid, reason: str = "", ok: Optional[bool] = None, **data):
    """Module-level shorthand for terminal edges."""
    get().finish(rid, reason=reason, ok=ok, **data)
