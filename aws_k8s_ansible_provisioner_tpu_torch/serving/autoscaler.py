"""Fleet actuation: the self-scaling replica controller.

A copy of the JAX package's ``serving/autoscaler.py`` (the port imports
nothing of that package); its imports point at the port's ``chaos``,
``flightrec``, ``metrics`` and ``router``, and its default ready-time is
the port replica's own on an H100 (``DEFAULT_READY_S``).

serving/capacity.py computes the complete scaling signal — offered load,
per-replica ceiling, a seconds-to-saturation forecast, and a replica
recommendation sized with headroom equal to a replica's ready-time — and
this module consumes it: under a ramp the fleet grows instead of shedding
at the knee, and an idle fleet drains to zero instead of burning cards
(serverless LLM fleets live or die on exactly this actuation loop). The
controller closes the loop:

1. **Reconcile, don't command.** ``step()`` compares the committed target
   against the fleet recommendation (the router's ``/debug/capacity``
   aggregation by default; injectable for tests) and moves actual replica
   count toward it one deliberate action at a time. The clock is
   injectable (capacity/slo discipline) so every window below is
   exact-arithmetic testable.

2. **Scale-up admits only ready replicas.** New replicas come from a
   pluggable :class:`ReplicaLauncher` — in-process callables for tests and
   rehearse-local, a command template for kind or a card — and enter
   rotation only after answering ``/readyz`` 200. A prewarmed STANDBY pool
   (size derived from the ready-time) is promoted first: promotion is
   instant, so the ready-time disappears from the scale-up latency.

3. **Scale-down is the replica's drain, never a kill.** The least-loaded
   replica leaves rotation, gets ``POST /admin/drain {"exit": false}``,
   and is reaped only at inflight==0 — zero non-2xx on surviving streams.
   A drain that never reaches zero is *stuck*: it is flagged, journaled,
   and finally escalated (force-reaped) by the reconcile path instead of
   wedging the controller behind one wedged replica.

4. **Scale-to-zero parks the fleet behind the router.** When
   ``min_replicas == 0`` and the fleet has been idle for
   ``idle_timeout_s``, the target drops to zero; the router answers the
   next ``/v1/*`` request by calling :meth:`Autoscaler.request_cold_start`
   and holding the request until a replica serves — the cold start costs
   a replica's ready-time, and a standby hides even that.

5. **Flap-proof by construction.** A target change must (a) persist for
   ``stable_s`` (hysteresis — one noisy forecast bucket proposes, it
   never commits) and (b) not reverse direction within ``cooldown_s`` of
   the previous commit (suppressed reversals are counted and journaled).
   Launch failures are classified transient/fatal with
   ``deploy.miniansible.classify_failure`` and retried on its
   deterministic capped backoff schedule — a quota blip retries, a bad
   manifest does not.

Every decision lands in the flight-recorder spool
(``autoscale_decision`` events) and the ``tpu_autoscale_*`` family
renders on BOTH /metrics routes, written only by
:meth:`Autoscaler.export`.
"""

from __future__ import annotations

import http.client
import json
import logging
import math
import shlex
import subprocess
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from aws_k8s_ansible_provisioner_tpu_torch.serving import chaos as _chaos
from aws_k8s_ansible_provisioner_tpu_torch.serving import flightrec
from aws_k8s_ansible_provisioner_tpu_torch.serving.metrics import (
    Counter, Gauge, Registry)

log = logging.getLogger("tpu_serve.autoscaler")

try:
    from deploy.miniansible import backoff_schedule, classify_failure
except ImportError:     # pragma: no cover - deploy/ not shipped beside the
    # serving package (minimal container): keep the controller importable
    # with the same *shape* of policy — no retry without the classifier
    # (an unrecognized error must stay fatal, same as miniansible's rule).
    def classify_failure(res: dict) -> Tuple[str, str]:
        return "fatal", str(res.get("msg") or "")[:300]

    def backoff_schedule(base: float, attempts: int, seed: str = "",
                         cap: Optional[float] = None) -> List[float]:
        cap = 60.0 if cap is None else cap
        return [min(base * (2.0 ** i), cap) for i in range(max(0, attempts))]


# Replica lifecycle states (ReplicaHandle.state).
LAUNCHING = "launching"   # spawned, waiting for /readyz
STANDBY = "standby"       # ready, parked OUT of rotation (prewarmed)
SERVING = "serving"       # ready and in the router pool
DRAINING = "draining"     # out of rotation, finishing in-flight work
STOPPED = "stopped"       # reaped (terminal; handle is dropped)

# Defaults. ready_s is a replica's ready-time — the quantity both the
# launch admission deadline and the auto standby size derive from: the
# port's default replica (Qwen3-0.6B, seeded int8 weights, 32 slots x 2048,
# CUDA graphs captured) from its start to /readyz 200 on an NVIDIA H100 80GB
# HBM3 at a 700 W power limit, the median of chip_smoke.py's fleet-phase
# launches (13.70, 13.70, 15.96, 15.52 s: 14.61) rounded up to a whole
# second (serving/capacity.py's DEFAULT_HEADROOM_S is the same figure).
DEFAULT_READY_S = 15.0
DEFAULT_INTERVAL_S = 1.0
DEFAULT_STABLE_S = 5.0
DEFAULT_COOLDOWN_S = 30.0
DEFAULT_IDLE_TIMEOUT_S = 120.0
DEFAULT_READY_TIMEOUT_S = 60.0
DEFAULT_DRAIN_STUCK_S = 45.0
DEFAULT_DRAIN_ESCALATE_S = 90.0
DEFAULT_LAUNCH_RETRIES = 3
DEFAULT_BACKOFF_BASE_S = 2.0
PROBE_TIMEOUT_S = 2.0


class AutoscaleMetrics:
    """The tpu_autoscale_* family. Registered here, rendered by BOTH
    /metrics routes, written only by Autoscaler.export().
    Monotone counts are exported as gauges set from the controller's
    internal counters — the single-writer discipline forbids inc() at the
    decision sites."""

    def __init__(self):
        r = Registry()
        self.registry = r
        self.desired_replicas = r.register(Gauge(
            "tpu_autoscale_desired_replicas",
            "Committed replica target (clamped recommendation after "
            "hysteresis + cooldown; 0 = parked / scale-to-zero)"))
        self.actual_replicas = r.register(Gauge(
            "tpu_autoscale_actual_replicas",
            "Replicas currently serving (ready AND in the router pool)"))
        self.standby_replicas = r.register(Gauge(
            "tpu_autoscale_standby_replicas",
            "Prewarmed ready replicas parked out of rotation (promoted "
            "before any launch on scale-up)"))
        self.launching_replicas = r.register(Gauge(
            "tpu_autoscale_launching_replicas",
            "Replicas spawned but not yet past /readyz (launch retries "
            "waiting out their backoff are counted separately)"))
        self.draining_replicas = r.register(Gauge(
            "tpu_autoscale_draining_replicas",
            "Replicas out of rotation finishing in-flight work before "
            "reap (inflight==0)"))
        self.stuck_replicas = r.register(Gauge(
            "tpu_autoscale_stuck_replicas",
            "Draining replicas past drain_stuck_s with inflight still "
            "nonzero — flagged and finally escalated, never wedging the "
            "controller"))
        self.scale_ups = r.register(Gauge(
            "tpu_autoscale_scale_ups",
            "Committed upward target changes since start (monotone count "
            "exported as a gauge: tpulint R12 single-writer discipline)"))
        self.scale_downs = r.register(Gauge(
            "tpu_autoscale_scale_downs",
            "Committed downward target changes since start (monotone "
            "count exported as a gauge)"))
        self.launch_failures = r.register(Gauge(
            "tpu_autoscale_launch_failures",
            "Replica launch failures by miniansible classification "
            "(transient = retried on the deterministic backoff schedule; "
            "fatal = abandoned)", ("class",)))
        self.cold_starts = r.register(Gauge(
            "tpu_autoscale_cold_starts",
            "Requests that found a parked fleet and triggered the "
            "AOT-backed cold-start path (monotone count)"))
        self.flaps_suppressed = r.register(Gauge(
            "tpu_autoscale_flaps_suppressed",
            "Direction reversals blocked by the cooldown window "
            "(monotone count; a noisy forecast proposes, it never flaps)"))
        self.last_decision_age_s = r.register(Gauge(
            "tpu_autoscale_last_decision_age_s",
            "Seconds since the controller last journaled a decision "
            "(-1 = no decision yet)"))
        self.autoscale_export_drops = r.register(Counter(
            "tpu_autoscale_export_drops_total",
            "Gauge refreshes dropped because status() raised "
            "(drop-not-fail: the /metrics render proceeds with stale "
            "values)"))


metrics = AutoscaleMetrics()


# ---------------------------------------------------------------------------
# Launchers: how a replica process comes to exist / stops existing.
# ---------------------------------------------------------------------------


class ReplicaLauncher:
    """Pluggable replica factory. ``launch()`` returns ``(addr, opaque)``
    — the ``host:port`` the replica will answer on plus whatever handle
    ``terminate`` needs to reap it. ``launch`` may raise: the controller
    classifies the failure transient/fatal and applies the deterministic
    backoff policy. ``terminate`` must be idempotent and never raise into
    the controller (best-effort reaping)."""

    def launch(self) -> Tuple[str, object]:
        raise NotImplementedError

    def terminate(self, addr: str, opaque: object) -> None:
        raise NotImplementedError


class CallableLauncher(ReplicaLauncher):
    """In-process launcher for tests and rehearse-local: ``spawn()``
    returns ``(addr, opaque)`` (e.g. a server thread + stop event),
    ``stop(addr, opaque)`` tears it down."""

    def __init__(self, spawn: Callable[[], Tuple[str, object]],
                 stop: Optional[Callable[[str, object], None]] = None):
        self._spawn = spawn
        self._stop = stop

    def launch(self) -> Tuple[str, object]:
        return self._spawn()

    def terminate(self, addr: str, opaque: object) -> None:
        if self._stop is not None:
            self._stop(addr, opaque)


class CommandLauncher(ReplicaLauncher):
    """Subprocess launcher for kind or a card: formats ``template`` with a
    freshly-allocated ``{port}`` (and ``{host}``), Popens it, and reaps
    with SIGTERM -> SIGKILL. The template comes from the deploy manifest
    (serving.yaml.j2's router ``--autoscale-launch-cmd``), so the replica
    command line is single-sourced with the Deployment's own."""

    def __init__(self, template: str, host: str = "127.0.0.1"):
        if "{port}" not in template:
            raise ValueError("launch command template must contain {port}")
        self.template = template
        self.host = host

    @staticmethod
    def _free_port() -> int:
        import socket
        s = socket.socket()
        try:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]
        finally:
            s.close()

    def launch(self) -> Tuple[str, object]:
        port = self._free_port()
        cmd = self.template.format(port=port, host=self.host)
        proc = subprocess.Popen(shlex.split(cmd),
                                stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL)
        return f"{self.host}:{port}", proc

    def terminate(self, addr: str, opaque: object) -> None:
        if opaque is None:
            return
        try:
            opaque.terminate()
            try:
                opaque.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                opaque.kill()
                opaque.wait(timeout=5.0)
        except Exception:
            log.warning("terminate of %s failed", addr, exc_info=True)


class ReplicaHandle:
    """One replica the controller knows about. ``opaque`` is the
    launcher's reap handle (None for adopted replicas the controller did
    not launch — those are drained but never terminated)."""

    __slots__ = ("addr", "state", "purpose", "opaque", "t_launched",
                 "t_ready", "t_drain", "stuck", "seed", "attempts")

    def __init__(self, addr: str, state: str, purpose: str = "serving",
                 opaque: object = None, t_launched: float = 0.0,
                 seed: str = "", attempts: int = 0):
        self.addr = addr
        self.state = state
        self.purpose = purpose      # "serving" | "standby"
        self.opaque = opaque
        self.t_launched = t_launched
        self.t_ready = 0.0
        self.t_drain = 0.0
        self.stuck = False
        self.seed = seed
        self.attempts = attempts


# -- default HTTP probes (overridable for FakeClock unit tests) -------------


def _get_json(addr: str, path: str) -> Tuple[int, dict]:
    host, _, port = addr.rpartition(":")
    conn = http.client.HTTPConnection(host, int(port),
                                      timeout=PROBE_TIMEOUT_S)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        body = resp.read()
        try:
            d = json.loads(body)
        except ValueError:
            d = {}
        return resp.status, d if isinstance(d, dict) else {}
    finally:
        conn.close()


def default_ready(addr: str) -> bool:
    """/readyz 200 = admittable. Anything else (503 warming/draining,
    connect refused while the process boots) = not yet."""
    try:
        status, _ = _get_json(addr, "/readyz")
        return status == 200
    except OSError:
        return False


def default_inflight(addr: str) -> int:
    """/healthz ``inflight`` (the JSON rides 503 answers too). A replica
    that stopped answering holds nothing — 0, so the reap proceeds."""
    try:
        _, d = _get_json(addr, "/healthz")
        return max(0, int(d.get("inflight") or 0))
    except (OSError, ValueError, TypeError):
        return 0


def default_drain(addr: str) -> bool:
    """POST /admin/drain {"exit": false} — the replica's rotation-removal
    drain: the replica sheds new admissions (router re-routes) and
    finishes in-flight work; the controller reaps it at inflight==0."""
    host, _, port = addr.rpartition(":")
    body = json.dumps({"exit": False}).encode()
    conn = http.client.HTTPConnection(host, int(port),
                                      timeout=PROBE_TIMEOUT_S)
    try:
        conn.request("POST", "/admin/drain", body=body,
                     headers={"Content-Type": "application/json"})
        return conn.getresponse().status == 200
    except OSError:
        return False
    finally:
        conn.close()


class Autoscaler:
    """Reconciliation controller: fleet recommendation -> replica count.

    All shared state is guarded by ``self._lock``; probe/launcher/pool
    I/O happens strictly outside it (locksan: no autoscaler lock is ever
    held across a network call or a pool lock acquisition). One ``step``
    runs at a time (``_step_lock``) whether driven by the background
    runner or a test calling it directly."""

    def __init__(self, enabled: bool = False,
                 min_replicas: int = 1, max_replicas: int = 8,
                 interval_s: float = DEFAULT_INTERVAL_S,
                 stable_s: float = DEFAULT_STABLE_S,
                 cooldown_s: float = DEFAULT_COOLDOWN_S,
                 idle_timeout_s: float = DEFAULT_IDLE_TIMEOUT_S,
                 ready_timeout_s: float = DEFAULT_READY_TIMEOUT_S,
                 drain_stuck_s: float = DEFAULT_DRAIN_STUCK_S,
                 drain_escalate_s: float = DEFAULT_DRAIN_ESCALATE_S,
                 launch_retries: int = DEFAULT_LAUNCH_RETRIES,
                 backoff_base_s: float = DEFAULT_BACKOFF_BASE_S,
                 standby: int = -1,
                 ready_s: float = DEFAULT_READY_S,
                 clock: Callable[[], float] = time.monotonic):
        self.enabled = bool(enabled)
        self.min_replicas = max(0, int(min_replicas))
        self.max_replicas = max(self.min_replicas, int(max_replicas), 1)
        self.interval_s = max(0.05, float(interval_s))
        self.stable_s = max(0.0, float(stable_s))
        self.cooldown_s = max(0.0, float(cooldown_s))
        self.idle_timeout_s = max(0.0, float(idle_timeout_s))
        self.ready_timeout_s = max(0.1, float(ready_timeout_s))
        self.drain_stuck_s = max(0.1, float(drain_stuck_s))
        self.drain_escalate_s = max(self.drain_stuck_s,
                                    float(drain_escalate_s))
        self.launch_retries = max(0, int(launch_retries))
        self.backoff_base_s = max(0.0, float(backoff_base_s))
        self.standby = int(standby)     # -1 = auto from ready_s
        self.ready_s = max(0.0, float(ready_s))
        self.clock = clock
        self._lock = threading.Lock()
        self._step_lock = threading.Lock()
        # wiring (install()/configure() carry these across reconfigures)
        self.pool = None                            # router.BackendPool
        self.launcher: Optional[ReplicaLauncher] = None
        self._ready_fn: Callable[[str], bool] = default_ready
        self._inflight_fn: Callable[[str], int] = default_inflight
        self._drain_fn: Callable[[str], bool] = default_drain
        self._recommend_fn: Optional[Callable[[], dict]] = None
        # fleet state
        self._replicas: Dict[str, ReplicaHandle] = {}
        self._pending: List[dict] = []      # launches waiting out backoff
        self._seq = 0
        # decision state
        self._target: Optional[int] = None
        self._proposal: Optional[int] = None
        self._proposal_dir = 0
        self._proposal_since = 0.0
        self._last_dir = 0
        self._last_scale_t = 0.0
        self._flap_counted = False
        self._idle_since: Optional[float] = None
        self._cold_pending = False
        # monotone counts (exported as gauges by export())
        self._n_scale_ups = 0
        self._n_scale_downs = 0
        self._n_launch_failures = {"transient": 0, "fatal": 0}
        self._n_cold_starts = 0
        self._n_flaps_suppressed = 0
        self._last_decision = ""
        self._last_decision_t: Optional[float] = None
        # runner
        self._thread: Optional[threading.Thread] = None
        self._stop_ev = threading.Event()
        self._wake = threading.Event()
        self._serving_ev = threading.Event()

    # -- wiring --------------------------------------------------------------

    def install(self, pool=None, launcher: Optional[ReplicaLauncher] = None,
                ready_fn: Optional[Callable[[str], bool]] = None,
                inflight_fn: Optional[Callable[[str], int]] = None,
                drain_fn: Optional[Callable[[str], bool]] = None,
                recommend_fn: Optional[Callable[[], dict]] = None):
        """Attach the router pool, the launcher, and (tests) probe
        overrides. Call before start()."""
        with self._lock:
            if pool is not None:
                self.pool = pool
            if launcher is not None:
                self.launcher = launcher
            if ready_fn is not None:
                self._ready_fn = ready_fn
            if inflight_fn is not None:
                self._inflight_fn = inflight_fn
            if drain_fn is not None:
                self._drain_fn = drain_fn
            if recommend_fn is not None:
                self._recommend_fn = recommend_fn
        return self

    def adopt(self, addr: str):
        """Register a replica that already exists (the pool's initial
        static backends): it counts toward actual, can be drained on
        scale-down, but is never terminated (opaque=None — the controller
        did not launch it, so it only ever drains it)."""
        with self._lock:
            if addr not in self._replicas:
                self._replicas[addr] = ReplicaHandle(addr, SERVING)
                self._serving_ev.set()

    # -- runner --------------------------------------------------------------

    def start(self):
        """Spawn the background reconcile loop (idempotent)."""
        if not self.enabled:
            return self
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            t = threading.Thread(target=self._run, daemon=True,
                                 name="tpu-autoscaler")
            self._thread = t
        t.start()
        return self

    def stop(self, timeout_s: float = 2.0):
        self._stop_ev.set()
        self._wake.set()
        with self._lock:
            t = self._thread
            self._thread = None
        if t is not None and t.is_alive():
            t.join(timeout=timeout_s)

    def _run(self):
        while not self._stop_ev.is_set():
            try:
                self.step()
            except Exception:
                log.warning("autoscaler step failed", exc_info=True)
            if self._wake.wait(self.interval_s):
                self._wake.clear()

    # -- cold start (router request path) ------------------------------------

    def request_cold_start(self, timeout_s: float = 30.0) -> bool:
        """A request arrived and the pool is empty: unpark the fleet and
        wait (bounded) for a replica to serve. Returns True when one is
        serving. Counted once per triggering request."""
        if not self.enabled:
            return False
        with self._lock:
            if any(h.state == SERVING for h in self._replicas.values()):
                return True
            self._cold_pending = True
            self._n_cold_starts += 1
        self._serving_ev.clear()
        self._wake.set()
        ok = self._serving_ev.wait(timeout_s)
        with self._lock:
            self._cold_pending = False
        return ok

    # -- the reconcile tick --------------------------------------------------

    def step(self, now: Optional[float] = None):
        """One reconcile pass. Deliberately non-blocking-ish: every probe
        is one bounded HTTP call, launches are spawned (not awaited), and
        drains are polled — a stuck anything surfaces as state, never as
        a wedged controller."""
        if not self.enabled:
            return
        with self._step_lock:
            now = self.clock() if now is None else now
            self._progress_launches(now)
            self._progress_drains(now)
            self._retry_pending(now)
            self._reconcile(now)
            self._maintain_standby(now)

    # launch admission ------------------------------------------------------

    def _progress_launches(self, now: float):
        with self._lock:
            launching = [h for h in self._replicas.values()
                         if h.state == LAUNCHING]
        for h in launching:
            try:
                ready = bool(self._ready_fn(h.addr))
            except Exception:
                ready = False
            if ready:
                self._admit(h, now)
            elif now - h.t_launched >= self.ready_timeout_s:
                self._terminate(h)
                with self._lock:
                    self._replicas.pop(h.addr, None)
                self._launch_failed(
                    h.purpose, h.seed, h.attempts,
                    f"replica {h.addr} timed out waiting for /readyz "
                    f"({self.ready_timeout_s:.0f}s)", now)

    def _admit(self, h: ReplicaHandle, now: float):
        with self._lock:
            h.t_ready = now
            h.state = STANDBY if h.purpose == "standby" else SERVING
            state = h.state
        if state == SERVING:
            self._pool_add(h.addr)
            self._serving_ev.set()
        self._journal(now, "replica_ready", addr=h.addr, state=state,
                      ready_wait_s=round(now - h.t_launched, 3))

    # drain lifecycle -------------------------------------------------------

    def _progress_drains(self, now: float):
        with self._lock:
            draining = [h for h in self._replicas.values()
                        if h.state == DRAINING]
        ch = _chaos.get()
        for h in draining:
            if ch.on_autoscale_drain(h.addr):
                inflight = 1    # injected wedge: streams never finish
            else:
                try:
                    inflight = int(self._inflight_fn(h.addr))
                except Exception:
                    inflight = 0
            if inflight <= 0:
                self._reap(h, now, "drained")
            elif not h.stuck and now - h.t_drain >= self.drain_stuck_s:
                with self._lock:
                    h.stuck = True
                self._journal(now, "drain_stuck", addr=h.addr,
                              inflight=inflight,
                              draining_s=round(now - h.t_drain, 3))
            elif h.stuck and now - h.t_drain >= self.drain_escalate_s:
                self._journal(now, "drain_escalated", addr=h.addr,
                              inflight=inflight,
                              draining_s=round(now - h.t_drain, 3))
                self._reap(h, now, "drain_escalated")

    def _reap(self, h: ReplicaHandle, now: float, reason: str):
        self._terminate(h)
        with self._lock:
            h.state = STOPPED
            self._replicas.pop(h.addr, None)
            if not any(x.state == SERVING for x in self._replicas.values()):
                self._serving_ev.clear()
        if reason == "drained":
            self._journal(now, "drained", addr=h.addr,
                          drain_s=round(now - h.t_drain, 3))

    def _terminate(self, h: ReplicaHandle):
        if h.opaque is None or self.launcher is None:
            return      # adopted replica: drained, never killed
        try:
            self.launcher.terminate(h.addr, h.opaque)
        except Exception:
            log.warning("launcher.terminate(%s) failed", h.addr,
                        exc_info=True)

    # launch + failure policy -----------------------------------------------

    def _retry_pending(self, now: float):
        with self._lock:
            due = [p for p in self._pending if now >= p["next_t"]]
            self._pending = [p for p in self._pending if now < p["next_t"]]
        for p in due:
            self._do_launch(p["purpose"], now, seed=p["seed"],
                            attempts=p["attempts"])

    def _do_launch(self, purpose: str, now: float, seed: str = "",
                   attempts: int = 0):
        if self.launcher is None:
            return
        if not seed:
            with self._lock:
                self._seq += 1
                seed = f"{purpose}-{self._seq}"
        try:
            _chaos.get().on_autoscale_launch()
            addr, opaque = self.launcher.launch()
        except Exception as e:
            self._launch_failed(purpose, seed, attempts, str(e), now)
            return
        h = ReplicaHandle(addr, LAUNCHING, purpose=purpose, opaque=opaque,
                          t_launched=now, seed=seed, attempts=attempts)
        with self._lock:
            self._replicas[addr] = h
        self._journal(now, "launch", addr=addr, purpose=purpose,
                      attempt=attempts + 1)

    def _launch_failed(self, purpose: str, seed: str, attempts: int,
                       msg: str, now: float):
        cls, reason = classify_failure({"msg": msg})
        with self._lock:
            self._n_launch_failures[cls] = \
                self._n_launch_failures.get(cls, 0) + 1
        attempts += 1
        if cls == "transient" and attempts <= self.launch_retries:
            delay = backoff_schedule(self.backoff_base_s, attempts,
                                     seed=seed)[attempts - 1]
            with self._lock:
                self._pending.append({"purpose": purpose, "seed": seed,
                                      "attempts": attempts,
                                      "next_t": now + delay})
            self._journal(now, "launch_retry", purpose=purpose,
                          attempt=attempts, delay_s=delay, reason=reason)
        else:
            self._journal(now, "launch_failed", purpose=purpose,
                          attempts=attempts, classification=cls,
                          reason=reason)

    # the decision ----------------------------------------------------------

    def _recommend(self) -> dict:
        """Fleet recommendation + offered load. Default source is the
        router's /debug/capacity aggregation over the pool's poller
        samples; tests inject a forecast directly."""
        if self._recommend_fn is not None:
            return dict(self._recommend_fn() or {})
        if self.pool is None:
            return {}
        from aws_k8s_ansible_provisioner_tpu_torch.serving import router
        return dict(router._fleet_capacity(self.pool.fleet())["fleet"])

    def _reconcile(self, now: float):
        try:
            rec = self._recommend()
        except Exception:
            rec = {}
        with self._lock:
            serving = sum(1 for h in self._replicas.values()
                          if h.state == SERVING)
            launching = sum(1 for h in self._replicas.values()
                            if h.state == LAUNCHING
                            and h.purpose == "serving")
            pending = sum(1 for p in self._pending
                          if p["purpose"] == "serving")
            cold = self._cold_pending
        current = serving + launching + pending
        reporting = int(rec.get("reporting_replicas") or 0)
        offered = float(rec.get("offered_tps") or 0.0)
        raw = rec.get("recommended_replicas")

        # idle tracking (scale-to-zero): offered load is the busy signal;
        # a fleet with no reporting replicas (parked) stays idle.
        with self._lock:
            if offered > 1e-9:
                self._idle_since = None
            elif self._idle_since is None:
                self._idle_since = now
            idle_for = now - self._idle_since \
                if self._idle_since is not None else 0.0
            if self._target is None:
                # bootstrap: adopt what exists, floored at min_replicas
                self._target = min(self.max_replicas,
                                   max(current, self.min_replicas))
            target = self._target

        if raw is None or (reporting == 0 and current == 0):
            # no signal (parked or poller not warm): hold the target
            desired = target
        else:
            desired = min(self.max_replicas,
                          max(self.min_replicas, int(raw)))
        if self.min_replicas == 0 and not cold:
            if current == 0:
                desired = 0     # parked stays parked until a request
            elif idle_for >= self.idle_timeout_s:
                desired = 0     # scale-to-zero: idle past the window
        if cold:
            desired = max(desired, 1, self.min_replicas)

        self._decide(now, desired, cold)
        self._actuate(now)

    def _decide(self, now: float, desired: int, cold: bool):
        events = []
        with self._lock:
            target = self._target
            if cold and target < 1:
                self._target = max(1, self.min_replicas)
                self._last_dir, self._last_scale_t = 1, now
                self._n_scale_ups += 1
                self._proposal = None
                events.append(("cold_start",
                               {"from": target, "to": self._target}))
            elif desired == target:
                self._proposal = None
                self._proposal_dir = 0
                self._flap_counted = False
            else:
                d = 1 if desired > target else -1
                if self._proposal is None or self._proposal_dir != d:
                    # new proposal (or direction flip): hysteresis window
                    # restarts — one noisy bucket never commits
                    self._proposal_dir = d
                    self._proposal_since = now
                    self._flap_counted = False
                self._proposal = desired
                if now - self._proposal_since + 1e-9 >= self.stable_s:
                    blocked = (self._last_dir != 0 and d != self._last_dir
                               and now - self._last_scale_t
                               < self.cooldown_s)
                    if blocked:
                        if not self._flap_counted:
                            self._n_flaps_suppressed += 1
                            self._flap_counted = True
                            events.append(("flap_suppressed", {
                                "from": target, "to": desired,
                                "cooldown_left_s": round(
                                    self.cooldown_s
                                    - (now - self._last_scale_t), 3)}))
                    else:
                        self._target = desired
                        self._last_dir = d
                        self._last_scale_t = now
                        self._proposal = None
                        self._proposal_dir = 0
                        if d > 0:
                            self._n_scale_ups += 1
                        else:
                            self._n_scale_downs += 1
                        events.append(("scale_up" if d > 0 else "scale_down",
                                       {"from": target, "to": desired}))
        for decision, data in events:
            self._journal(now, decision, **data)

    # actuation -------------------------------------------------------------

    def _actuate(self, now: float):
        with self._lock:
            target = self._target or 0
            serving = [h for h in self._replicas.values()
                       if h.state == SERVING]
            standby = [h for h in self._replicas.values()
                       if h.state == STANDBY]
            launching = sum(1 for h in self._replicas.values()
                            if h.state == LAUNCHING
                            and h.purpose == "serving")
            pending = sum(1 for p in self._pending
                          if p["purpose"] == "serving")
        current = len(serving) + launching + pending
        if current < target:
            need = target - current
            # standby promotion first: the ready-time has already been
            # paid, so the scale-up is one pool insert
            for h in standby[:need]:
                with self._lock:
                    h.state = SERVING
                    h.purpose = "serving"
                self._pool_add(h.addr)
                self._serving_ev.set()
                self._journal(now, "promote_standby", addr=h.addr)
                need -= 1
            for _ in range(need):
                self._do_launch("serving", now)
        elif current > target and serving:
            # one drain per tick: gradual, and each drain immediately
            # lowers ``current`` so the next tick re-evaluates
            victim = self._least_loaded(serving)
            with self._lock:
                victim.state = DRAINING
                victim.t_drain = now
            self._pool_remove(victim.addr)
            try:
                drained = bool(self._drain_fn(victim.addr))
            except Exception:
                drained = False
            self._journal(now, "drain", addr=victim.addr,
                          accepted=drained, target=target)

    def _least_loaded(self, serving: List[ReplicaHandle]) -> ReplicaHandle:
        """Scale-down victim: fewest in-flight streams (pool /load sample
        when fresh, else a direct /healthz probe). Ties break on address
        for determinism."""
        loads = {}
        if self.pool is not None:
            try:
                fl = self.pool.fleet()
                loads = {a: e.get("load") for a, e in fl.items()
                         if isinstance(e, dict) and e.get("load") is not None}
            except Exception:
                loads = {}

        def score(h: ReplicaHandle):
            s = loads.get(h.addr)
            if s is None:
                try:
                    s = int(self._inflight_fn(h.addr))
                except Exception:
                    s = 0
            return (s, h.addr)

        return min(serving, key=score)

    # standby pool ----------------------------------------------------------

    def standby_target(self) -> int:
        """Prewarmed pool size. Auto (-1) derives from the replica
        ready-time: enough standbys that one promotion covers one
        ready-time of launch latency — ceil(ready_s / ready_s) = 1 for
        any nonzero ready-time (0 when cold start is free)."""
        if self.standby >= 0:
            return self.standby
        return int(math.ceil(self.ready_s / max(self.ready_s, 1e-9))) \
            if self.ready_s > 0 else 0

    def _maintain_standby(self, now: float):
        want = self.standby_target()
        with self._lock:
            standby = [h for h in self._replicas.values()
                       if h.state == STANDBY]
            warming = sum(1 for h in self._replicas.values()
                          if h.state == LAUNCHING
                          and h.purpose == "standby")
            pending = sum(1 for p in self._pending
                          if p["purpose"] == "standby")
            total = len(self._replicas) + len(self._pending)
        have = len(standby) + warming + pending
        if have < want and total < self.max_replicas + want:
            self._do_launch("standby", now)
        elif len(standby) > want:
            # shrink: standbys hold no streams — reap directly
            extra = sorted(standby, key=lambda h: h.addr)[want:]
            for h in extra:
                self._reap(h, now, "standby_shrunk")
                self._journal(now, "standby_shrunk", addr=h.addr)

    # pool plumbing ---------------------------------------------------------

    def _pool_add(self, addr: str):
        if self.pool is None:
            return
        try:
            self.pool.add_backend(addr)
        except Exception:
            log.warning("pool.add_backend(%s) failed", addr, exc_info=True)

    def _pool_remove(self, addr: str):
        if self.pool is None:
            return
        try:
            self.pool.remove_backend(addr)
        except Exception:
            log.warning("pool.remove_backend(%s) failed", addr,
                        exc_info=True)

    # journal / status / export ----------------------------------------------

    def _journal(self, now: float, decision: str, **data):
        with self._lock:
            self._last_decision = decision
            self._last_decision_t = now
        try:
            flightrec.record("autoscale_decision", None,
                             decision=decision, **data)
        except Exception:
            pass
        log.info("autoscale %s %s", decision, data)

    def status(self, now: Optional[float] = None) -> dict:
        """The /debug/autoscale document."""
        now = self.clock() if now is None else now
        with self._lock:
            by_state: Dict[str, int] = {}
            for h in self._replicas.values():
                by_state[h.state] = by_state.get(h.state, 0) + 1
            stuck = sum(1 for h in self._replicas.values() if h.stuck)
            target = self._target
            age = (now - self._last_decision_t) \
                if self._last_decision_t is not None else -1.0
            return {
                "enabled": self.enabled,
                "desired": target if target is not None
                else self.min_replicas,
                "actual": by_state.get(SERVING, 0),
                "launching": by_state.get(LAUNCHING, 0),
                "standby": by_state.get(STANDBY, 0),
                "draining": by_state.get(DRAINING, 0),
                "stuck": stuck,
                "pending_launches": len(self._pending),
                "min_replicas": self.min_replicas,
                "max_replicas": self.max_replicas,
                "standby_target": self.standby_target(),
                "parked": (target == 0
                           and by_state.get(SERVING, 0) == 0),
                "cold_start_pending": self._cold_pending,
                "scale_ups": self._n_scale_ups,
                "scale_downs": self._n_scale_downs,
                "launch_failures": dict(self._n_launch_failures),
                "cold_starts": self._n_cold_starts,
                "flaps_suppressed": self._n_flaps_suppressed,
                "last_decision": self._last_decision,
                "last_decision_age_s": round(age, 3),
            }

    def export(self) -> Optional[dict]:
        """Refresh every tpu_autoscale_* gauge — the single writer site
        for the family. Both /metrics routes call this
        right before rendering; a raise is swallowed and counted
        (drop-not-fail)."""
        try:
            st = self.status()
            metrics.desired_replicas.set(float(st["desired"]))
            metrics.actual_replicas.set(float(st["actual"]))
            metrics.standby_replicas.set(float(st["standby"]))
            metrics.launching_replicas.set(float(st["launching"]))
            metrics.draining_replicas.set(float(st["draining"]))
            metrics.stuck_replicas.set(float(st["stuck"]))
            metrics.scale_ups.set(float(st["scale_ups"]))
            metrics.scale_downs.set(float(st["scale_downs"]))
            lf = st["launch_failures"]
            metrics.launch_failures.set(float(lf.get("transient", 0)),
                                        **{"class": "transient"})
            metrics.launch_failures.set(float(lf.get("fatal", 0)),
                                        **{"class": "fatal"})
            metrics.cold_starts.set(float(st["cold_starts"]))
            metrics.flaps_suppressed.set(float(st["flaps_suppressed"]))
            metrics.last_decision_age_s.set(st["last_decision_age_s"])
            return st
        except Exception:
            metrics.autoscale_export_drops.inc()
            return None


# ---------------------------------------------------------------------------
# Module-level wiring: one controller per process (the capacity pattern).
# ---------------------------------------------------------------------------

_controller: Optional[Autoscaler] = None
_controller_lock = threading.Lock()


def get() -> Autoscaler:
    global _controller
    with _controller_lock:
        if _controller is None:
            _controller = Autoscaler()
        return _controller


def configure(**kw) -> Autoscaler:
    """Swap in a freshly-configured controller, carrying over the wiring
    (pool, launcher, probe overrides) the previous instance held, and
    stopping its runner thread."""
    global _controller
    with _controller_lock:
        old = _controller
        _controller = Autoscaler(**kw)
        if old is not None:
            old.stop()
            _controller.pool = old.pool
            _controller.launcher = old.launcher
            _controller._ready_fn = old._ready_fn
            _controller._inflight_fn = old._inflight_fn
            _controller._drain_fn = old._drain_fn
            _controller._recommend_fn = old._recommend_fn
        return _controller


def reset() -> Autoscaler:
    global _controller
    with _controller_lock:
        old = _controller
        _controller = Autoscaler()
    if old is not None:
        old.stop()
    return _controller
