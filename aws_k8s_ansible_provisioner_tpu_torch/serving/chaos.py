"""Deterministic fault-injection harness for the serving path.

A copy of the JAX package's ``serving/chaos.py`` (the port imports nothing
of that package). The serving stack's failure behavior is part of its
contract: this module makes every defined degradation path *drivable* from a
test — deterministically, with no timing races — so the tests can assert the
documented behavior for each fault. The port's engine, server and page pool
have the sites of the replica's faults; ``connect_refused`` and
``stream_read_error`` fire in the port's router (``serving/router.py``), the
``autoscale_*`` faults in its autoscaler (``serving/autoscaler.py``):

==========================  ==============================================
fault                       defined degradation behavior
==========================  ==============================================
``connect_refused``         router marks the replica dead, fails over to
                            the next candidate, serves the request (safe:
                            nothing was sent), recovers the replica via the
                            poller's health probe
``stalled_decode``          engine step wedges; /healthz flips to 503
                            "stalled"; the watchdog aborts the step and the
                            affected requests fail with "error" — the
                            process survives and keeps serving
``page_exhaustion``         page allocation fails; the engine preempts the
                            lowest-progress request (recompute-resume) or
                            requeues the admission instead of wedging;
                            slots/pages fully released, no crash
``slow_client``             one slow-reading stream consumer backpressures
                            only its own handler thread; the engine and
                            sibling requests keep full throughput
``mid_stream_disconnect``   server cancels the engine request; the slot and
                            its pages release exactly once
``kill_stream``             the REPLICA dies mid-stream from its peer's
                            point of view: after ``after_chunks`` relayed
                            content chunks the server hard-RSTs the
                            connection and cancels the engine request —
                            the router fails the stream over to another
                            replica as a deterministic continuation
                            (resume_token_ids), splicing only new chunks
``stream_read_error``       router-side fault point: the SSE relay's read
                            from the backend raises after ``after_events``
                            relayed events — drives the failover path
                            without any server cooperation
``pipeline_fetch_error``    the deferred fetch of a pipelined decode
                            dispatch fails (a transfer fault at the
                            block point): the in-flight dispatch is
                            discarded, its requests fail with "error"
                            through the normal teardown (slots/pages
                            released exactly once) and the engine keeps
                            serving
``ragged_feature_error``    a FEATURE operand of a ragged dispatch fails —
                            the guided-mask device upload surfaces its error
                            at the deferred fetch (``kind=guided``), or a
                            spec-decode verify row is corrupted at its
                            synchronous read (``kind=spec``). Either way the
                            dispatch is discarded with nothing emitted, its
                            requests fail with "error" through the normal
                            teardown (slots/pages released exactly once) and
                            the engine keeps serving — the feature paths
                            inherit the pipeline's failure contract
``kv_offload_error``        a host-tier KV entry about to be restored is
                            corrupted (truncated payload — a bad PCIe copy
                            or host-RAM bit rot stand-in): the engine's
                            fetch-time verification drops the entry, the
                            restorable extension truncates there and the
                            span re-prefills — tokens are never wrong, the
                            drop is counted
                            (``tpu_serve_kv_restore_dropped_total``).
                            ``entries`` caps how many of the chain's
                            entries are corrupted per firing (default all)
``span_export``             the OTLP trace collector misbehaves — refuses
                            connections, hangs, or answers 5xx (``mode``) —
                            only the exporter's background thread sees it:
                            requests succeed unchanged and the spans are
                            dropped and counted
                            (``tpu_serve_spans_dropped_total``)
``flight_dump_error``       the flight-recorder spool write fails (disk
                            full) or hangs (``mode``) — only the recorder's
                            background writer thread sees it: requests
                            succeed unchanged and the dump is dropped and
                            counted (``tpu_serve_flight_drops_total``)
``capacity_export_error``   the capacity estimator's gauge refresh raises
                            inside a /metrics or /healthz render: the
                            render proceeds with the previous gauge values,
                            the drop is counted
                            (``tpu_capacity_export_drops_total``) and
                            requests succeed unchanged — the estimator can
                            never block a request
``autoscale_launch_error``  a replica launch fails. ``mode=transient``
                            (default) raises an error matching
                            miniansible's TRANSIENT_PATTERNS — the
                            autoscaler must retry on its deterministic
                            capped backoff schedule; ``mode=fatal`` raises
                            an unclassifiable error — the autoscaler must
                            journal the give-up and keep reconciling.
                            Either way the failure is counted
                            (``tpu_autoscale_launch_failures{class}``) and
                            never wedges the controller
``autoscale_drain_stuck``   a draining replica's inflight count never
                            reaches zero (a wedged stream): the autoscaler
                            must flag it stuck after ``drain_stuck_s``
                            (``tpu_autoscale_stuck_replicas``, journal
                            entry) and force-reap it at
                            ``drain_escalate_s`` — escalation through the
                            reconcile path, never a wedged controller
``deadline``                (engine-native, no injection needed) request
                            past its deadline is cancelled, slot/pages
                            released, client gets 408 deadline_exceeded
``drain``                   (engine-native, no injection needed) SIGTERM /
                            /admin/drain sheds new admissions (503
                            "draining", router re-routes), finishes
                            in-flight work, exits 0 within drain_timeout_s
==========================  ==============================================

Server-side faults are *injected* through hook points in engine.py /
server.py / paged_kv.py; client-side faults (slow reader, mid-stream
disconnect) are *driven* by the socket-level helpers at the bottom, which
the chaos suite uses as its misbehaving clients.

Injection is programmatic (``chaos.get().inject(...)``) or via env/config:
``TPU_SERVE_CHAOS="stalled_decode:duration_s=2,page_exhaustion:times=3"``
— each entry is ``fault[:key=value]*`` with the counting keys ``after``
(skip the first N trigger sites) and ``times`` (fire for M triggers;
-1 = forever). Counting is per-process and deterministic: the Nth call to
:meth:`ChaosController.fire` behaves identically on every run.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from typing import Dict, Optional

FAULTS = ("connect_refused", "stalled_decode", "page_exhaustion",
          "slow_client", "mid_stream_disconnect", "kill_stream",
          "stream_read_error", "span_export", "pipeline_fetch_error",
          "ragged_dispatch_error", "ragged_feature_error",
          "flight_dump_error", "kv_offload_error",
          "capacity_export_error", "autoscale_launch_error",
          "autoscale_drain_stuck")


class InjectedFault(RuntimeError):
    """Base for failures raised by an armed fault (never raised unarmed)."""


class InjectedStall(InjectedFault):
    """A chaos-stalled decode step aborted by the engine watchdog."""


class _FaultSpec:
    __slots__ = ("name", "after", "times", "params", "triggers", "fired")

    def __init__(self, name: str, after: int = 0, times: int = 1, **params):
        self.name = name
        self.after = int(after)     # trigger sites to skip before firing
        self.times = int(times)     # firings before disarming (-1 = forever)
        self.params = params
        self.triggers = 0           # total fire() consultations
        self.fired = 0              # actual firings


class ChaosController:
    """Process-wide fault registry with deterministic trigger counting."""

    def __init__(self, spec: str = ""):
        self._lock = threading.Lock()
        self._specs: Dict[str, _FaultSpec] = {}
        if spec:
            self._parse(spec)

    # -- arming --------------------------------------------------------------

    def _parse(self, spec: str):
        for entry in spec.split(","):
            entry = entry.strip()
            if not entry:
                continue
            name, *kvs = entry.split(":")
            kwargs: Dict[str, object] = {}
            for kv in kvs:
                k, _, v = kv.partition("=")
                try:
                    kwargs[k] = json.loads(v)
                except (ValueError, TypeError):
                    kwargs[k] = v
            self.inject(name, **kwargs)

    def inject(self, fault: str, after: int = 0, times: int = 1, **params):
        """Arm ``fault``: skip its first ``after`` trigger sites, then fire
        for ``times`` triggers (-1 = until cleared)."""
        if fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}; known: {FAULTS}")
        with self._lock:
            self._specs[fault] = _FaultSpec(fault, after=after, times=times,
                                            **params)

    def clear(self, fault: Optional[str] = None):
        with self._lock:
            if fault is None:
                self._specs.clear()
            else:
                self._specs.pop(fault, None)

    @property
    def enabled(self) -> bool:
        return bool(self._specs)

    def active(self, fault: str) -> Optional[dict]:
        """The fault's params if armed (without consuming a trigger)."""
        with self._lock:
            s = self._specs.get(fault)
            return dict(s.params) if s is not None else None

    def fire(self, fault: str) -> Optional[dict]:
        """Consume one trigger of ``fault``. Returns its params when this
        trigger fires, else None. Deterministic: depends only on the call
        count, never on time."""
        with self._lock:
            s = self._specs.get(fault)
            if s is None:
                return None
            s.triggers += 1
            if s.triggers <= s.after:
                return None
            if s.times >= 0 and s.fired >= s.times:
                return None
            s.fired += 1
            params = dict(s.params)
        # Every fired fault lands in the flight-recorder ring (outside the
        # chaos lock — the recorder takes its own; the deferred import
        # breaks the chaos <- flightrec module cycle). Drop-on-overflow:
        # recording can never block or fail the faulting path either.
        from aws_k8s_ansible_provisioner_tpu_torch.serving import flightrec

        flightrec.record("chaos_fault", None, fault=fault)
        return params

    def stats(self) -> dict:
        with self._lock:
            return {n: {"triggers": s.triggers, "fired": s.fired}
                    for n, s in self._specs.items()}

    # -- server-side hook points ---------------------------------------------

    def on_decode_step(self, engine) -> None:
        """engine._do_decode entry: an armed ``stalled_decode`` wedges the
        step (host-side busy-wait standing in for a hung device dispatch)
        until the watchdog's abort flag flips — then raises InjectedStall,
        which run_forever turns into failed requests, not a dead process.
        ``duration_s`` caps the stall so an un-watched engine self-heals."""
        p = self.fire("stalled_decode")
        if p is None:
            return
        duration = float(p.get("duration_s", 5.0))
        t0 = time.monotonic()
        while time.monotonic() - t0 < duration:
            if getattr(engine, "_stall_abort", False):
                raise InjectedStall(
                    "chaos: stalled decode step aborted by watchdog after "
                    f"{time.monotonic() - t0:.2f}s")
            time.sleep(0.005)

    def on_pipeline_fetch(self, engine) -> None:
        """EnginePrograms._decode_fetch entry: an armed
        ``pipeline_fetch_error`` raises in place of the blocking device
        read — standing in for a transfer failure that only surfaces at
        the deferred block point of an asynchronously-dispatched program.
        step() unwinds, run_forever's catch-all fails the affected requests
        (_fail_all discards the in-flight record first so nothing re-fetches
        the poisoned dispatch) and the engine keeps serving."""
        p = self.fire("pipeline_fetch_error")
        if p is None:
            return
        raise InjectedFault(
            "chaos: injected pipelined decode fetch failure")

    def on_mixed_fetch(self, engine) -> None:
        """EnginePrograms._decode_fetch entry for RAGGED MIXED records
        only: an armed ``ragged_dispatch_error`` raises at the blocking
        read of a mixed (prefill-chunk + decode) dispatch. The in-flight
        record is discarded, the chunk walk's error path releases the
        half-prefilled slot's pages exactly once (it clears ``_chunk``
        before re-raising, so _fail_all cannot release it a second time),
        and the engine keeps serving."""
        p = self.fire("ragged_dispatch_error")
        if p is None:
            return
        raise InjectedFault(
            "chaos: injected ragged mixed-dispatch failure")

    def on_feature_path(self, engine, kind: str) -> None:
        """Feature-operand fault sites of the ragged pipeline:
        ``kind="guided"`` fires at the deferred fetch of a dispatch that
        carried a grammar allow-mask operand (the one-step-ahead async
        upload surfacing a transfer error at its block point);
        ``kind="spec"`` fires at the synchronous read of a spec-decode
        verify result (a corrupted verify row). An armed
        ``ragged_feature_error`` raises InjectedFault — step() unwinds,
        run_forever's catch-all discards the in-flight record un-emitted
        and fails the affected requests with "error" (slots/pages released
        exactly once), and the engine keeps serving. ``kind=...`` in the
        fault params restricts firing to one feature path; trigger counting
        only consumes on matching sites, so after/times stay deterministic
        per path."""
        p = self.active("ragged_feature_error")
        if p is None:
            return
        want = p.get("kind")
        if want and str(want) != kind:
            return
        if self.fire("ragged_feature_error") is None:
            return
        raise InjectedFault(
            f"chaos: injected ragged feature-path failure ({kind})")

    def on_kv_restore(self, tier, host_keys) -> None:
        """engine._host_entries, before the host-tier payloads of a restore
        are fetched: an armed ``kv_offload_error`` truncates the entries'
        payloads in place (HostTier.corrupt) — standing in for a bad PCIe
        copy or host-RAM corruption discovered only at restore time. The
        engine's fetch-time shape verification then drops the entries and
        re-prefills the span: degraded latency, never wrong tokens.
        ``entries`` caps how many of the chain's entries are corrupted per
        firing (default: all of them)."""
        p = self.fire("kv_offload_error")
        if p is None:
            return
        n = int(p.get("entries", len(host_keys)))
        for key in list(host_keys)[:max(0, n)]:
            tier.corrupt(key)

    def on_engine_step(self, engine) -> None:
        """engine.step entry: an armed ``page_exhaustion`` makes the page
        allocators refuse the next ``allocs`` (default 1) allocation calls
        (paged_kv.PagePool.fail_next_allocs) — exercising the requeue and
        preempt-under-pressure paths with a pool that is *logically* dry."""
        p = self.fire("page_exhaustion")
        if p is None:
            return
        n = int(p.get("allocs", 1))
        for alloc in getattr(engine, "allocators", ()):
            alloc.fail_next_allocs += n

    def check_connect(self, addr: str) -> None:
        """router connect phase: an armed ``connect_refused`` raises the
        same ConnectionRefusedError a dead replica produces, before any
        bytes leave the router. ``addr_prefix`` restricts it to matching
        backends."""
        p = self.fire("connect_refused")
        if p is None:
            return
        prefix = str(p.get("addr_prefix", ""))
        if prefix and not addr.startswith(prefix):
            return
        raise ConnectionRefusedError(f"chaos: injected connect refusal "
                                     f"for backend {addr}")

    def on_stream_chunk(self, handler, n_chunks: int) -> None:
        """server _stream_response, after each relayed content chunk: an
        armed ``kill_stream`` hard-closes (SO_LINGER-0 RST) the client
        connection once the stream has emitted ``after_chunks`` chunks —
        the replica "dies" mid-stream from its peer's (the router's) point
        of view — then raises InjectedFault so the stream handler unwinds
        and cancels the engine request exactly like a real broken pipe.
        Per-STREAM chunk counting is the caller's (``n_chunks``); the
        controller's deterministic times/after budget decides which streams
        die."""
        p = self.active("kill_stream")
        if p is None or n_chunks < int(p.get("after_chunks", 1)):
            return
        if self.fire("kill_stream") is None:
            return
        import struct as _struct
        # RST, not FIN: a clean close is how SSE legitimately ENDS — a
        # crashed replica resets. The makefile objects hold fd refs, so
        # close them FIRST (idempotently re-closed by the handler's own
        # finish()), then the socket close actually sends the RST.
        handler.close_connection = True
        try:
            handler.connection.setsockopt(
                socket.SOL_SOCKET, socket.SO_LINGER,
                _struct.pack("ii", 1, 0))
        except OSError:
            pass
        for f in (handler.wfile, handler.rfile, handler.connection):
            try:
                f.close()
            except OSError:
                pass
        # the http.server plumbing still flushes/closes wfile/rfile after
        # the handler unwinds — hand it harmless sinks, not the dead socket
        import io as _io
        handler.wfile = _io.BytesIO()
        handler.rfile = _io.BytesIO(b"")
        raise InjectedFault(f"chaos: replica killed mid-stream after "
                            f"{n_chunks} chunks")

    def check_stream_read(self, addr: str, n_events: int) -> None:
        """router SSE relay, before each backend read: an armed
        ``stream_read_error`` raises the ConnectionResetError a dying
        backend socket produces once ``after_events`` events were relayed —
        the failover path is drivable without any server cooperation.
        ``addr_prefix`` restricts it to matching backends."""
        p = self.active("stream_read_error")
        if p is None or n_events < int(p.get("after_events", 1)):
            return
        p = self.fire("stream_read_error")
        if p is None:
            return
        prefix = str(p.get("addr_prefix", ""))
        if prefix and not addr.startswith(prefix):
            return
        raise ConnectionResetError(f"chaos: injected mid-stream read "
                                   f"failure from backend {addr}")

    def on_span_export(self) -> None:
        """tracing.OTLPHTTPExporter._send entry (exporter background thread
        ONLY — never a request thread): an armed ``span_export`` makes the
        trace collector misbehave per ``mode``: ``refuse`` (default) raises
        the ConnectionRefusedError of a dead collector; ``hang`` sleeps
        ``hang_s`` (default 5.0, standing in for a wedged endpoint — still
        on the background thread, so request latency is untouched) then
        raises; ``5xx`` models a collector that answers but rejects. All
        three must resolve to dropped-and-counted spans, never a failed or
        stalled request."""
        p = self.fire("span_export")
        if p is None:
            return
        mode = str(p.get("mode", "refuse"))
        if mode == "hang":
            time.sleep(float(p.get("hang_s", 5.0)))
            raise OSError("chaos: span export hung, then timed out")
        if mode == "5xx":
            raise InjectedFault("chaos: trace collector answered 503")
        raise ConnectionRefusedError("chaos: trace collector refused "
                                     "connection")

    def on_flight_dump(self) -> None:
        """flightrec.FlightRecorder._write entry (spool writer background
        thread ONLY — never a request thread): an armed ``flight_dump_error``
        makes the spool write misbehave per ``mode``: ``oserror`` (default)
        raises the OSError of a full disk; ``hang`` sleeps ``hang_s``
        (default 2.0 — still on the writer thread, so request latency is
        untouched) then raises. Both must resolve to a dropped-and-counted
        dump (``tpu_serve_flight_drops_total{reason="dump_error"}``), never
        a failed or stalled request: the mirror of the span_export
        contract."""
        p = self.fire("flight_dump_error")
        if p is None:
            return
        mode = str(p.get("mode", "oserror"))
        if mode == "hang":
            time.sleep(float(p.get("hang_s", 2.0)))
        raise OSError("chaos: flight spool write failed (disk full)")

    def on_capacity_export(self) -> None:
        """capacity.CapacityEstimator.export entry (a /metrics or /healthz
        handler thread — observability reads, never a request path): an
        armed ``capacity_export_error`` raises in place of the gauge
        refresh. export() must swallow it, count the drop
        (``tpu_capacity_export_drops_total``) and let the render proceed
        with the previous gauge values (drop-not-fail)."""
        p = self.fire("capacity_export_error")
        if p is None:
            return
        raise InjectedFault("chaos: injected capacity export failure")

    def on_autoscale_launch(self) -> None:
        """autoscaler._do_launch entry (the reconcile tick — never a
        request thread): an armed ``autoscale_launch_error`` raises in
        place of the launcher call. ``mode=transient`` (default) phrases
        the error so ``miniansible.classify_failure`` tags it transient —
        the controller must schedule a deterministic-backoff retry;
        ``mode=fatal`` phrases it unclassifiably — the controller must
        journal the give-up (drop-not-fail either way)."""
        p = self.fire("autoscale_launch_error")
        if p is None:
            return
        if str(p.get("mode", "transient")) == "fatal":
            raise InjectedFault(
                "chaos: replica manifest rejected by admission webhook "
                "(invalid spec)")
        raise InjectedFault(
            "chaos: cloud API temporarily unavailable provisioning "
            "replica VM")

    def on_autoscale_drain(self, addr: str) -> bool:
        """autoscaler._progress_drains poll (the reconcile tick): an
        armed ``autoscale_drain_stuck`` makes ``addr``'s inflight read as
        permanently nonzero — a wedged stream that never finishes. Each
        poll consumes one trigger, so ``times`` is the number of ticks
        the drain stays wedged: armed long enough it drives the
        stuck-flag (``drain_stuck_s``) and force-reap
        (``drain_escalate_s``) escalation path. ``addr_prefix`` restricts
        it to matching replicas."""
        p = self.fire("autoscale_drain_stuck")
        if p is None:
            return False
        prefix = str(p.get("addr_prefix", ""))
        if prefix and not addr.startswith(prefix):
            return False
        return True


_controller: Optional[ChaosController] = None
_controller_lock = threading.Lock()


def get() -> ChaosController:
    """The process-wide controller (created from $TPU_SERVE_CHAOS once)."""
    global _controller
    with _controller_lock:
        if _controller is None:
            _controller = ChaosController(os.environ.get("TPU_SERVE_CHAOS",
                                                         ""))
        return _controller


def reset() -> ChaosController:
    """Fresh controller (tests; re-reads $TPU_SERVE_CHAOS)."""
    global _controller
    with _controller_lock:
        _controller = None
    return get()


def kill_replica_after_chunks(k: int, times: int = 1, after: int = 0):
    """Arm the replica-kill-mid-stream scenario: the next ``times`` streams to emit ``k`` content chunks die
    with an RST at that point (server-side ``kill_stream`` fault). Under a
    router this drives the mid-stream failover path: the router re-issues
    the request to another replica as a deterministic continuation and
    splices only new chunks, so the client stream stays byte-identical to an
    undisturbed run."""
    get().inject("kill_stream", after=after, times=times, after_chunks=k)


# ---------------------------------------------------------------------------
# Client-side fault drivers (the misbehaving clients the chaos suite runs)
# ---------------------------------------------------------------------------


def _raw_post(host: str, port: int, path: str, payload: dict,
              timeout: float = 60.0) -> socket.socket:
    """Open a raw socket and send a POST; returns the connected socket with
    the response unread — the caller controls read pacing and lifetime."""
    body = json.dumps(payload).encode()
    req = (f"POST {path} HTTP/1.1\r\nHost: {host}:{port}\r\n"
           f"Content-Type: application/json\r\n"
           f"Content-Length: {len(body)}\r\n\r\n").encode() + body
    sock = socket.create_connection((host, port), timeout=timeout)
    sock.sendall(req)
    return sock


def stream_then_disconnect(host: str, port: int, payload: dict,
                           path: str = "/v1/completions",
                           after_bytes: int = 1,
                           timeout: float = 60.0) -> bytes:
    """Mid-stream disconnect driver: start a streaming completion, read at
    least ``after_bytes`` of the SSE body, then drop the connection with a
    RST-ish abrupt close. Returns the bytes read before the drop."""
    payload = {**payload, "stream": True}
    sock = _raw_post(host, port, path, payload, timeout=timeout)
    got = b""
    try:
        while len(got) < after_bytes:
            chunk = sock.recv(4096)
            if not chunk:
                break
            got += chunk
    finally:
        # SO_LINGER 0: close sends RST, the hard-kill variant of a client
        # vanishing (wifi drop, OOM-killed consumer)
        try:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                            b"\x01\x00\x00\x00\x00\x00\x00\x00")
        except OSError:
            pass
        sock.close()
    return got


def slow_client_stream(host: str, port: int, payload: dict,
                       path: str = "/v1/completions",
                       read_delay_s: float = 0.2,
                       read_size: int = 1,
                       timeout: float = 120.0) -> bytes:
    """Slow-consumer driver: stream a completion reading ``read_size`` bytes
    per ``read_delay_s`` — TCP backpressure against the handler thread.
    Returns the full body once the server finishes."""
    payload = {**payload, "stream": True}
    sock = _raw_post(host, port, path, payload, timeout=timeout)
    got = b""
    deadline = time.monotonic() + timeout
    try:
        while time.monotonic() < deadline:
            chunk = sock.recv(max(1, read_size))
            if not chunk:
                break
            got += chunk
            if b"data: [DONE]" in got:
                break
            time.sleep(read_delay_s)
    finally:
        sock.close()
    return got
