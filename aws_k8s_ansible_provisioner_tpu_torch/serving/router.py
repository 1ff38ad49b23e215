"""Inference gateway router: HTTP front door for N serving-engine replicas.

A copy of the JAX package's ``serving/router.py`` (the port imports nothing
of that package); its imports point at the port's ``chaos``, ``autoscaler``,
``capacity``, ``devmon``, ``flightrec``, ``metrics``, ``slo`` and
``tracing``, none of which loads ``torch``. It takes the place of the llm-d
inference gateway (Go) that the reference deploys via ``llmd-installer.sh``
and addresses at ``llm-d-test.yaml:14-26``. The contract preserved:

- exposes the OpenAI surface (``/v1/*``) of the backends unchanged, so the L4
  test playbook's ephemeral curl pods work against the router exactly as they
  did against the llm-d gateway;
- load-balances across every replica behind the backend Service by resolving
  the DNS name to all A records (headless-Service friendly) — or a static
  comma-separated ``host:port`` list;
- routes INFERENCE-AWARE, the actual capability of the llm-d gateway it
  replaces (round-robin in front of continuous-batching engines with prefix
  caches throws away both signals): a ~1 Hz poller reads each replica's
  3-field ``/load`` endpoint and requests go to the least-loaded replica;
  completion requests carry a prompt-prefix affinity key, and same-prefix
  requests stick to the same replica while its load permits — which is what
  makes the engines' paged prefix caches (hash-chain page sharing) actually
  hit across requests;
- retries idempotent-safe failures on the next replica, taking a dead backend
  out of rotation for a cooldown window (the health-driven routing the
  reference delegated to the external gateway);
- streams responses through unbuffered (SSE passthrough for
  ``stream: true`` completions), and continues a stream whose replica died
  on another replica (``resume_token_ids``), splicing only new chunks.

Affinity keys hash the leading PROMPT TEXT (the router deliberately carries
no tokenizer): tokenization is prefix-stable for equal text, so equal text
prefixes are exactly the requests whose token pages the engine's hash-chain
index can share. Stdlib-only (http.server + urllib) so the router container
needs nothing beyond the framework image: neither this module nor anything
it imports loads ``torch``.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import http.client
import itertools
import json
import logging
import math
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from aws_k8s_ansible_provisioner_tpu_torch.serving import chaos as _chaos
from aws_k8s_ansible_provisioner_tpu_torch.serving import (
    autoscaler, capacity, devmon, flightrec, metrics, slo, tracing)
from aws_k8s_ansible_provisioner_tpu_torch.serving.metrics import (
    Counter, Gauge, Registry)

log = logging.getLogger("tpu_serve.router")

# Connect phase gets its own short timeout: a dead replica should fail over in
# seconds. The read timeout stays long (a non-streaming completion can
# legitimately generate for minutes). Keeping these distinct is what makes the
# retry policy safe — see _proxy (a single long timeout would let a slow POST
# be replayed on a second backend while the first was still generating).
CONNECT_TIMEOUT_S = 5.0
READ_TIMEOUT_S = 600.0
# End-to-end deadline header (serving/server.py DEADLINE_HEADER): forwarded
# to the backend unchanged AND used to bound this hop's read timeout — a
# request that declared a 5 s deadline must not pin a router thread for the
# full READ_TIMEOUT_S when its backend wedges.
DEADLINE_HEADER = "X-Request-Deadline-Ms"
READ_TIMEOUT_GRACE_S = 30.0
# 429 is a ROUTABLE signal: the backend shed the request at admission —
# nothing was generated — so trying the next replica (or the same pool again
# after a jittered backoff) is always safe, unlike mid-generation failures.
# The budget bounds the extra attempts per request; backoff is jittered so a
# synchronized burst doesn't re-converge on the same replica.
RETRY_429_BUDGET = 2
RETRY_429_BACKOFF_S = 0.1


class RouterMetrics:
    """Gateway-level request/failover counters for the L5 scrape (router
    requests are otherwise invisible to observability)."""

    def __init__(self):
        self.registry = Registry()
        r = self.registry
        self.requests = r.register(Counter(
            "tpu_router_requests_total", "Requests relayed, by response code",
            ("code",)))
        self.failovers = r.register(Counter(
            "tpu_router_failovers_total",
            "Requests retried on another replica after a connect failure"))
        self.dead_marks = r.register(Counter(
            "tpu_router_backend_dead_total",
            "Times a backend was taken out of rotation"))
        self.backends = r.register(Gauge(
            "tpu_router_backends", "Currently resolved backend replicas"))
        self.retries_429 = r.register(Counter(
            "tpu_router_429_retries_total",
            "Shed (429) responses retried on another replica after a "
            "jittered backoff"))
        self.recovered = r.register(Counter(
            "tpu_router_backend_recovered_total",
            "Cooling-down backends returned to rotation early after "
            "answering the health probe"))
        # Replica lifecycle: mid-stream failover + drain-aware routing.
        self.stream_failovers = r.register(Counter(
            "tpu_router_stream_failovers_total",
            "Streams continued on another replica after a replica died "
            "mid-stream (deterministic continuation; only new chunks "
            "spliced to the client)"))
        self.draining_skips = r.register(Counter(
            "tpu_router_backend_draining_total",
            "Requests re-routed off a draining replica (503 draining "
            "shed at admission — nothing generated, always re-routable)"))


# A /load sample older than this no longer orders candidates (a replica that
# stopped answering its poller is either dead — the connect path will find
# out — or wedged; either way its last-known load is fiction).
LOAD_TTL_S = 5.0
# A replica reporting ``draining`` on /load is out of rotation WITHOUT being
# dead-marked (it is healthy, it is leaving). Entries refresh every poll;
# the TTL returns a replica whose poller went silent (restart completing)
# to normal connect-phase discovery instead of excluding it forever.
DRAIN_TTL_S = 10.0
# Mid-stream failovers per request: each continuation re-prefills the
# emitted prefix on another replica, so the budget bounds the worst-case
# extra prefill work a flapping fleet can induce per stream.
STREAM_FAILOVER_BUDGET = 2
# Affinity yields when the sticky replica's in-flight+queued exceeds the
# least-loaded replica's by more than this (prefix reuse saves prefill; it
# never justifies queueing behind a pile while a sibling idles).
LOAD_SLACK = 4
AFFINITY_CAP = 8192           # LRU entries (prefix-key -> replica)
AFFINITY_PREFIX_CHARS = 512   # prompt chars hashed into the key


class BackendPool:
    """Replica pool: least-loaded-first with prefix affinity, round-robin
    fallback while load is unknown.

    Backends come from DNS (``host:port`` resolved to all A records — the
    headless-Service contract) or a static comma-separated ``host:port``
    list (in-process rehearsal + mixed-port layouts). Internal addresses are
    ``"host:port"`` strings either way.
    """

    def __init__(self, backend_service: str, refresh_s: float = 10.0,
                 cooldown_s: float = 15.0, load_slack: int = LOAD_SLACK):
        self._static: list[str] = []
        self.host = self.port = None
        if "," in backend_service:
            for part in backend_service.split(","):
                host, sep, port = part.strip().rpartition(":")
                if not sep or not host or not port.isdigit():
                    raise ValueError(f"--backend-service list entries must "
                                     f"be host:port, got {part!r}")
                self._static.append(f"{host}:{port}")
        else:
            host, sep, port = backend_service.rpartition(":")
            if not sep or not host or not port.isdigit():
                raise ValueError(f"--backend-service must be host:port, "
                                 f"got {backend_service!r}")
            self.host = host
            self.port = int(port)
        self.refresh_s = refresh_s
        self.cooldown_s = cooldown_s
        self.load_slack = load_slack
        self._lock = threading.Lock()
        # autoscaler-managed replicas: layered on top of whatever DNS/the
        # static list resolves, surviving refreshes until remove_backend
        self._dynamic: list[str] = []
        self._addrs: list[str] = list(self._static)
        self._rr = itertools.count()
        self._dead: dict[str, float] = {}
        # addr -> time last seen draining (poller-fed; TTL'd in pick())
        self._draining: dict[str, float] = {}
        self._last_refresh = 0.0
        # addr -> (active + queued, t_sampled); written by the ~1 Hz poller
        self._load: dict[str, tuple[int, float]] = {}
        # addr -> (/healthz fleet summary dict, t_sampled); the poller
        # refreshes this beside /load so /debug/fleet and its dashboards
        # read SLO burn rates + flight anomalies without fanning out a
        # scrape per dashboard refresh
        self._health: dict[str, tuple[dict, float]] = {}
        # prompt-prefix key -> last replica that served it (LRU)
        self._affinity: "collections.OrderedDict[str, str]" = \
            collections.OrderedDict()

    def _resolve(self) -> list[str]:
        if self._static:
            base = list(self._static)
        elif self.host is None:
            # a fully-drained static pool (scale-to-zero): nothing to
            # resolve — the autoscaler's dynamic layer is the whole fleet
            base = []
        else:
            try:
                infos = socket.getaddrinfo(self.host, self.port,
                                           socket.AF_INET,
                                           socket.SOCK_STREAM)
                base = sorted({f"{i[4][0]}:{self.port}" for i in infos})
            except socket.gaierror:
                base = []
        return base + [a for a in self._dynamic if a not in base]

    def addrs(self) -> list[str]:
        """Current replica set (refreshing if stale) — the poller's target
        list."""
        now = time.monotonic()
        with self._lock:
            if now - self._last_refresh > self.refresh_s or not self._addrs:
                addrs = self._resolve()
                if addrs:
                    self._addrs = addrs
                self._last_refresh = now
            return list(self._addrs)

    def note_load(self, addr: str, active: int, queued: int):
        with self._lock:
            self._load[addr] = (int(active) + int(queued), time.monotonic())

    def note_health(self, addr: str, health: dict):
        """Stash a replica's /healthz fleet summary (poller-fed)."""
        with self._lock:
            self._health[addr] = (health, time.monotonic())

    def fleet(self) -> dict:
        """Per-replica fleet view: last /load + /healthz samples with ages
        (/debug/fleet)."""
        now = time.monotonic()
        with self._lock:
            out = {}
            for addr in self._addrs:
                ent: dict = {}
                ld = self._load.get(addr)
                if ld is not None:
                    ent["load"] = ld[0]
                    ent["load_age_s"] = round(now - ld[1], 2)
                h = self._health.get(addr)
                if h is not None:
                    ent["health"] = h[0]
                    ent["health_age_s"] = round(now - h[1], 2)
                ent["cooling"] = addr in self._dead \
                    and now - self._dead[addr] < self.cooldown_s
                ent["draining"] = addr in self._draining \
                    and now - self._draining[addr] < DRAIN_TTL_S
                out[addr] = ent
            return out

    def note_affinity(self, key: str, addr: str):
        """Remember which replica served this prompt prefix (its pages are
        now in that replica's prefix index)."""
        with self._lock:
            self._affinity[key] = addr
            self._affinity.move_to_end(key)
            while len(self._affinity) > AFFINITY_CAP:
                self._affinity.popitem(last=False)

    def migrate_affinity(self, src: str, dst: str) -> int:
        """Bulk re-point every affinity entry on ``src`` to ``dst``
        when a replica leaves the pool its HBM prefix
        index dies with it, but the FIRST re-hit on the new home rebuilds
        the chain — and with the tier-2 host store the rebuilt pages
        outlive HBM pressure there — so keeping the cohort together beats
        scattering it over the pool and re-prefilling everywhere. LRU
        positions are preserved (no move_to_end: a migration is not a use).
        Returns the number of entries re-pointed."""
        with self._lock:
            return self._migrate_affinity_locked(src, dst)

    def _migrate_affinity_locked(self, src: str, dst: str) -> int:
        moved = 0
        for key, a in self._affinity.items():
            if a == src:
                self._affinity[key] = dst
                moved += 1
        return moved

    def _score(self, addr: str, now: float):
        ent = self._load.get(addr)
        if ent is None or now - ent[1] > LOAD_TTL_S:
            return None
        return ent[0]

    def pick(self, affinity_key: str | None = None) -> list[str]:
        """Candidate backends, best-first.

        Ordering: (1) the affinity replica, while alive and within
        ``load_slack`` of the least-loaded; (2) replicas with fresh /load
        samples, least-loaded first; (3) load-unknown replicas in round-robin
        rotation (the whole pool degrades to plain round-robin when the
        poller hasn't run — cold start, tests, or a /load-less backend)."""
        now = time.monotonic()
        with self._lock:
            if now - self._last_refresh > self.refresh_s or not self._addrs:
                addrs = self._resolve()
                if addrs:
                    self._addrs = addrs
                self._last_refresh = now
            self._dead = {a: t for a, t in self._dead.items()
                          if now - t < self.cooldown_s}
            self._draining = {a: t for a, t in self._draining.items()
                              if now - t < DRAIN_TTL_S}
            alive = [a for a in self._addrs
                     if a not in self._dead and a not in self._draining]
            # all draining → fall back to the draining set (they shed 503
            # and the request-path handles it); all dead → try everything
            pool = alive \
                or [a for a in self._addrs if a not in self._dead] \
                or self._addrs
            if not pool:
                return []
            k = next(self._rr) % len(pool)
            rotated = pool[k:] + pool[:k]
            scored = [(self._score(a, now), a) for a in rotated]
            known = [(s, a) for s, a in scored if s is not None]
            unknown = [a for s, a in scored if s is None]
            known.sort(key=lambda sa: sa[0])
            order = [a for _, a in known] + unknown
            if affinity_key is not None:
                sticky = self._affinity.get(affinity_key)
                if sticky in pool and sticky != order[0]:
                    s = self._score(sticky, now)
                    best = known[0][0] if known else None
                    # A sticky replica with a stale/missing /load sample is
                    # only honored when NO replica has a fresh one (cold
                    # start / poller off): a wedged-but-connectable replica
                    # must not keep attracting its affinity traffic past the
                    # load_slack yield.
                    if (s is None and best is None) or (
                            s is not None and s <= best + self.load_slack):
                        order.remove(sticky)
                        order.insert(0, sticky)
            return order

    def mark_dead(self, addr: str):
        with self._lock:
            self._dead[addr] = time.monotonic()
            self._load.pop(addr, None)

    def add_backend(self, addr: str) -> bool:
        """Admit an autoscaler-launched replica into rotation NOW. The
        address joins the dynamic layer (surviving DNS refreshes) and any
        stale dead/draining record from a previous life at the same
        address is cleared. Returns whether it was new."""
        with self._lock:
            fresh = addr not in self._dynamic
            if fresh:
                self._dynamic.append(addr)
            if addr not in self._addrs:
                self._addrs.append(addr)
            self._dead.pop(addr, None)
            self._draining.pop(addr, None)
            return fresh

    def remove_backend(self, addr: str) -> bool:
        """Take a replica out of the pool permanently (autoscaler
        scale-down: the drain handles in-flight work; this stops NEW
        requests landing on it). Removes it from the static list too, so
        a drained initial backend stays gone. Returns whether it was
        present."""
        with self._lock:
            present = addr in self._addrs
            if present:
                self._addrs.remove(addr)
            if addr in self._dynamic:
                self._dynamic.remove(addr)
            if addr in self._static:
                self._static.remove(addr)
            self._load.pop(addr, None)
            # Re-point (not drop) the dead replica's affinity cohort to one
            # surviving replica — least-loaded by fresh /load sample, else
            # the first in rotation. The cohort's first re-hit there
            # re-prefills once and re-seeds the prefix chain (HBM + host
            # tier); dropping the entries instead would scatter the cohort
            # and pay that rebuild on EVERY replica it lands on. No
            # survivor → entries drop (nothing to point at).
            now = time.monotonic()
            survivors = [a for a in self._addrs
                         if a not in self._dead and a not in self._draining] \
                or self._addrs
            if survivors:
                dst = min(survivors,
                          key=lambda a: (self._score(a, now) is None,
                                         self._score(a, now) or 0.0))
                self._migrate_affinity_locked(addr, dst)
            else:
                self._affinity = collections.OrderedDict(
                    (k, a) for k, a in self._affinity.items() if a != addr)
            return present

    def note_draining(self, addr: str) -> bool:
        """A replica reported ``draining``: remove it from rotation WITHOUT
        dead-marking (no cooldown to serve out — it re-enters within one
        poll of draining going false). Returns whether this is a
        transition (was in rotation)."""
        with self._lock:
            fresh = addr not in self._draining
            self._draining[addr] = time.monotonic()
            return fresh

    def clear_draining(self, addr: str) -> bool:
        """The replica stopped draining (restart finished / drain
        cancelled): back into rotation NOW."""
        with self._lock:
            return self._draining.pop(addr, None) is not None

    def draining(self) -> list[str]:
        now = time.monotonic()
        with self._lock:
            return sorted(a for a, t in self._draining.items()
                          if now - t < DRAIN_TTL_S)

    def note_recovered(self, addr: str) -> bool:
        """A cooling-down replica answered its health probe: return it to
        rotation NOW instead of waiting out the rest of the cooldown (a
        restarted pod re-enters within one poller interval). Returns whether
        the replica was actually cooling."""
        with self._lock:
            return self._dead.pop(addr, None) is not None

    def cooling(self) -> list[str]:
        """Replicas currently inside their cooldown window."""
        now = time.monotonic()
        with self._lock:
            return [a for a, t in self._dead.items()
                    if now - t < self.cooldown_s]

    def url(self, addr: str, path: str) -> str:
        return f"http://{addr}{path}"


def _affinity_key(path: str, body: bytes | None) -> str | None:
    """Prefix-affinity key for a completion POST: hash of the leading prompt
    text (chat: the serialized messages). None = no affinity (malformed or
    non-completion traffic routes purely by load)."""
    if not body:
        return None
    try:
        obj = json.loads(body)
        if path.startswith("/v1/chat/completions"):
            # Conversation identity, not raw serialized-prefix: a shared
            # system prompt >= the prefix window would collapse EVERY chat
            # onto one key. The whole system text plus the
            # first non-system turn distinguishes conversations, while a
            # follow-up turn of the same conversation (same system + same
            # first user message, longer history) keeps its key — exactly
            # the requests whose prior-turn pages the engine indexed.
            msgs = obj.get("messages") or []
            if not isinstance(msgs, list) or not msgs:
                return None
            sys_txt = "".join(str(m.get("content", "")) for m in msgs
                              if isinstance(m, dict)
                              and m.get("role") == "system")
            first_turn = next((str(m.get("content", "")) for m in msgs
                               if isinstance(m, dict)
                               and m.get("role") != "system"), "")
            text = sys_txt + "\x00" + first_turn[:AFFINITY_PREFIX_CHARS]
        else:
            prompt = obj.get("prompt", "")
            if isinstance(prompt, list):
                prompt = prompt[0] if prompt else ""
            text = prompt if isinstance(prompt, str) else ""
            text = text[:AFFINITY_PREFIX_CHARS]
        if not text.strip("\x00"):
            return None
        return hashlib.sha1(text.encode("utf-8", "replace")).hexdigest()
    except (ValueError, TypeError, AttributeError):
        return None


def _fleet_capacity(fleet: dict) -> dict:
    """Aggregate the per-replica ``capacity`` blocks (poller-stashed
    /healthz) into the ``GET /debug/capacity`` fleet view.

    Fleet offered load and fleet ceiling are straight sums over replicas
    that report one (additive by construction — each replica measures its
    own arrivals and its own service rate). A replica whose /healthz
    predates serving/capacity.py (mixed-version fleet mid-rollout) gets an
    ``available: false`` row and is excluded from the sums, so a rollout
    never turns the dashboard into a KeyError and the fleet numbers only
    claim the replicas actually measured. The fleet replica recommendation
    scales total projected demand by the MEAN per-replica ceiling (what one
    more replica of the current mix would add)."""
    replicas = {}
    offered = ceiling = projected = 0.0
    admitted_rps = shed_rps = 0.0
    reporting = saturated = idle = 0
    for addr, ent in fleet.items():
        cap = (ent.get("health") or {}).get("capacity")
        if not isinstance(cap, dict):
            replicas[addr] = {"available": False}
            continue
        reporting += 1
        row = {
            "available": True,
            "offered_tps": cap.get("offered_tps", 0.0),
            "ceiling_tps": cap.get("ceiling_tps", 0.0),
            "ceiling_source": cap.get("ceiling_source", "none"),
            "utilization": cap.get("utilization", 0.0),
            "queue_delay_s": cap.get("queue_delay_s", 0.0),
            "seconds_to_saturation": cap.get("seconds_to_saturation"),
            "saturated": bool(cap.get("saturated", False)),
            "recommended_replicas": cap.get("recommended_replicas", 1),
            "idle": bool(cap.get("idle", False)),
            "last_submit_age_s": cap.get("last_submit_age_s"),
        }
        if row["idle"]:
            idle += 1
        if "health_age_s" in ent:
            row["age_s"] = ent["health_age_s"]
        replicas[addr] = row
        offered += float(cap.get("offered_tps") or 0.0)
        ceiling += float(cap.get("ceiling_tps") or 0.0)
        projected += float(cap.get("projected_offered_tps")
                           or cap.get("offered_tps") or 0.0)
        off_block = cap.get("offered")
        if isinstance(off_block, dict):
            admitted_rps += float(off_block.get("admitted_per_s") or 0.0)
            shed_rps += float(off_block.get("shed_per_s") or 0.0)
        if cap.get("saturated"):
            saturated += 1
    mean_ceiling = (ceiling / reporting) if reporting else 0.0
    if mean_ceiling > 0:
        # Demand-derived, deliberately NOT floored at the current fleet
        # size: a recommendation that can never go below reporting_replicas
        # would make scale-down impossible for the actuation loop. The
        # autoscaler's hysteresis + cooldown absorb a transiently low
        # reading; a fleet with no measured ceiling keeps the floor.
        recommended = max(1, math.ceil(projected / mean_ceiling - 1e-9))
    else:
        recommended = max(1, reporting)
    if shed_rps > 0.0 and reporting > 0:
        # Shed-aware floor: a fleet turning requests away at admission is
        # saturated by OBSERVATION, whatever the ceiling arithmetic claims
        # (the roofline blend can be wildly optimistic, and a ceiling
        # too generous would otherwise pin the recommendation at the
        # current size while clients eat 429s). Demand in requests/s is
        # admitted + shed; what the current fleet actually services is the
        # admitted rate, so size by their ratio.
        if admitted_rps > 0.0:
            factor = (admitted_rps + shed_rps) / admitted_rps
            recommended = max(recommended,
                              math.ceil(reporting * factor - 1e-9))
        else:
            recommended = max(recommended, reporting + 1)
    return {
        "replicas": replicas,
        "fleet": {
            "reporting_replicas": reporting,
            "missing_replicas": len(fleet) - reporting,
            "saturated_replicas": saturated,
            "idle_replicas": idle,
            # the autoscaler's scale-to-zero gate: every measured replica
            # reports zero offered load over its window
            "idle": reporting > 0 and idle == reporting,
            "offered_tps": round(offered, 6),
            "admitted_rps": round(admitted_rps, 6),
            "shed_rps": round(shed_rps, 6),
            "ceiling_tps": round(ceiling, 6),
            "utilization": round(offered / ceiling, 6) if ceiling > 0
            else 0.0,
            "projected_offered_tps": round(projected, 6),
            "recommended_replicas": recommended,
        },
    }


def start_load_poller(pool: BackendPool, interval_s: float = 1.0,
                      stop: threading.Event | None = None,
                      metrics: RouterMetrics | None = None
                      ) -> threading.Thread:
    """~1 Hz poller: /load samples for alive replicas (feeding
    BackendPool.note_load) and a /healthz RECOVERY probe for cooling-down
    ones — a restarted replica that answers healthy again re-enters rotation
    within one poll interval instead of serving out its whole cooldown
    (a stalled replica answers 503 and stays out). A
    failed poll just leaves the replica's sample to the stale-TTL — the
    request path's connect failures own dead-marking."""

    def poll_one(addr, cooling=False):
        host, _, port = addr.rpartition(":")
        conn = http.client.HTTPConnection(host, int(port), timeout=2.0)
        try:
            if cooling:
                # recovery probe: /healthz, not /load — a wedged engine
                # still answers /load 200 but /healthz 503 ("stalled"),
                # and it must NOT re-attract traffic
                conn.request("GET", "/healthz")
                if conn.getresponse().status == 200 \
                        and pool.note_recovered(addr):
                    log.info("backend %s healthy again; back in rotation",
                             addr)
                    if metrics is not None:
                        metrics.recovered.inc()
                return
            conn.request("GET", "/load")
            resp = conn.getresponse()
            if resp.status == 200:
                d = json.loads(resp.read())
                if isinstance(d, dict):
                    # drain recognition: a draining replica leaves
                    # rotation WITHOUT dead-marking and re-enters within
                    # one poll of draining going false (drain cancelled,
                    # or the drained pod restarted)
                    if d.get("draining"):
                        if pool.note_draining(addr):
                            log.info("backend %s draining; out of rotation",
                                     addr)
                    elif pool.clear_draining(addr):
                        log.info("backend %s done draining; back in "
                                 "rotation", addr)
                    pool.note_load(addr, d.get("active", 0) or 0,
                                   d.get("queued", 0) or 0)
            # SLO/flight fleet summary rides the same poll (same keep-alive
            # connection): /healthz carries burn rates, throughput, pool
            # pressure, and the flight recorder's last anomaly — the data
            # /debug/fleet renders. A 503 still carries the JSON
            # (stalled/draining replicas are exactly the interesting rows).
            conn.request("GET", "/healthz")
            hresp = conn.getresponse()
            h = json.loads(hresp.read())
            if isinstance(h, dict):
                pool.note_health(addr, h)
        except Exception:
            # NEVER let a malformed reply kill the poller thread — the
            # router would silently degrade to round-robin for its whole
            # lifetime. A failed poll just leaves the
            # replica's sample to the stale-TTL.
            log.debug("poll of %s failed", addr, exc_info=True)
        finally:
            conn.close()

    def poll_once():
        addrs = pool.addrs()
        cooling = set(pool.cooling())
        # CONCURRENT polls (cooling replicas get the cheap recovery probe):
        # a few blackholed pod IPs during a rolling restart must not stretch
        # the cycle past LOAD_TTL_S and stale out every healthy sample
        # — the bounded join below caps the cycle either way
        threads = []
        for addr in addrs:
            t = threading.Thread(target=poll_one,
                                 args=(addr, addr in cooling), daemon=True)
            t.start()
            threads.append(t)
        for t in threads:
            t.join(timeout=2.5)

    def run():
        while stop is None or not stop.is_set():
            poll_once()
            if stop is not None and stop.wait(interval_s):
                break
            if stop is None:
                time.sleep(interval_s)

    t = threading.Thread(target=run, daemon=True,
                         name="router-load-poller")
    t.start()
    return t


def _failover_spec(path: str, body: bytes | None):
    """The parsed request body when this request is eligible for mid-stream
    failover, else None.

    Eligible = a single-choice streaming completion the backend tags with
    per-chunk ``token_ids``: the router can then re-issue a dying stream to
    another replica as a deterministic continuation (resume_token_ids +
    resume_text_chars) and splice only new chunks. Multi-choice (n/best_of),
    echo, and requests that are already continuations stay on the
    truncate-on-death path."""
    if body is None or not path.startswith(("/v1/completions",
                                           "/v1/chat/completions")):
        return None
    try:
        obj = json.loads(body)
    except ValueError:
        return None
    if not isinstance(obj, dict) or not obj.get("stream"):
        return None
    if obj.get("n", 1) != 1 or obj.get("best_of", 1) != 1:
        return None
    if obj.get("echo") or obj.get("resume_token_ids") is not None:
        return None
    return obj


def _track_sse_event(event: bytes, st: dict):
    """Account one relayed SSE event into the failover state: generated
    token ids covered, generated-text chars the client now has, [DONE]."""
    if not event.startswith(b"data: "):
        return
    payload = event[len(b"data: "):].strip()
    if payload == b"[DONE]":
        st["done"] = True
        return
    try:
        obj = json.loads(payload)
    except ValueError:
        return
    if not isinstance(obj, dict):
        return
    for c in obj.get("choices") or []:
        if not isinstance(c, dict):
            continue
        if "token_ids" in c:
            # the backend speaks the failover dialect: relayed text is
            # fully accounted by relayed token ids, so continuation is safe
            st["tagged"] = True
            st["token_ids"].extend(int(t) for t in c.get("token_ids") or [])
        txt = c.get("text")
        if txt is None:
            txt = (c.get("delta") or {}).get("content")
        if isinstance(txt, str):
            st["chars"] += len(txt)


def _continuation_body(fo: dict, st: dict) -> bytes:
    """The continuation request for a stream that died after relaying
    ``st``: original body + resume fields, max_tokens decremented to the
    REMAINING budget (the backend adds the resume length back — a body
    without max_tokens keeps the server default as the total budget)."""
    obj = dict(fo)
    obj["resume_token_ids"] = list(st["token_ids"])
    obj["resume_text_chars"] = int(st["chars"])
    if "max_tokens" in fo:
        try:
            obj["max_tokens"] = max(0, int(fo["max_tokens"])
                                    - len(st["token_ids"]))
        except (TypeError, ValueError):
            pass
    return json.dumps(obj).encode()


class RouterHandler(BaseHTTPRequestHandler):
    pool: BackendPool = None       # injected by serve()
    metrics: RouterMetrics = None  # injected by serve()
    tracer: tracing.Tracer = None  # injected by serve(); None = no spans
    protocol_version = "HTTP/1.1"
    # Per-request trace state (class defaults so keep-alive connections
    # never leak a previous request's spans into the next).
    _root_span = None
    _hop_span = None
    _trace_ctx = None
    _next_kind = "first"

    def log_message(self, fmt, *args):  # quiet; structured logging below
        log.debug(fmt, *args)

    def _respond_json(self, code: int, obj: dict):
        if self._trace_ctx is not None and isinstance(obj.get("error"),
                                                      dict):
            # log correlation on gateway-originated errors (408/429/502/
            # 503): the ids to look the request up in Tempo
            obj["error"].setdefault("trace_id", self._trace_ctx.trace_id)
            obj["error"].setdefault("span_id", self._trace_ctx.span_id)
        if self._root_span is not None:
            self._root_span.set_attribute("http.status_code", code)
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    # -- dispatch-hop span plumbing ------------------------------------------
    # One "router.dispatch" child span per attempt at a backend. The loop
    # body only ever calls _hop_begin at the attempt's top and _hop_end at
    # each branch that settles the attempt — ``next_kind`` names what the
    # FOLLOWING attempt will be (failover / retry_429 / stream_continuation),
    # which is how the golden span-tree test tells a 429 retry hop from a
    # connect failover hop.

    def _hop_begin(self, addr: str, index: int):
        if self._root_span is None:
            return
        self._hop_span = self.tracer.start_span(
            "router.dispatch", parent=self._root_span.context,
            kind=tracing.KIND_CLIENT,
            attributes={"backend.addr": addr, "dispatch.index": index,
                        "dispatch.kind": self._next_kind})

    def _hop_attr(self, key: str, value):
        if self._hop_span is not None:
            self._hop_span.set_attribute(key, value)

    def _hop_end(self, outcome: str = "", next_kind: str = ""):
        if self._hop_span is not None:
            if outcome:
                self._hop_span.set_attribute("dispatch.outcome", outcome)
            self.tracer.finish(self._hop_span)
            self._hop_span = None
        if next_kind:
            self._next_kind = next_kind

    def _proxy(self, method: str):
        """Root-span wrapper around the dispatch loop: opens (or continues,
        when the client sent a ``traceparent``) the trace whose child hops
        the loop emits, and guarantees both the dangling hop and the root
        are finished however the loop exits."""
        tracer = self.tracer
        if tracer is None or self.path.split("?")[0] in (
                "/health", "/metrics", "/debug/fleet", "/debug/capacity"):
            return self._proxy_impl(method)
        parent = tracing.parse_traceparent(
            self.headers.get(tracing.TRACEPARENT_HEADER))
        self._root_span = tracer.start_span(
            "router.request", parent=parent, kind=tracing.KIND_SERVER,
            attributes={"http.method": method,
                        "http.target": self.path.split("?")[0]})
        self._trace_ctx = self._root_span.context
        self._hop_span = None
        self._next_kind = "first"
        try:
            return self._proxy_impl(method)
        except Exception as e:
            self._root_span.error(f"{type(e).__name__}: {e}")
            raise
        finally:
            self._hop_end()
            tracer.finish(self._root_span)
            self._root_span = None
            self._trace_ctx = None

    def _proxy_impl(self, method: str):
        if self.path == "/health":
            now = time.monotonic()
            with self.pool._lock:
                loads = {a: self.pool._load[a][0]
                         for a in self.pool._addrs
                         if a in self.pool._load
                         and now - self.pool._load[a][1] <= LOAD_TTL_S}
                # same expiry pick() applies — a router receiving only
                # health probes must not report recovered replicas as
                # cooling down forever
                dead = sorted(a for a, t in self.pool._dead.items()
                              if now - t < self.pool.cooldown_s)
                draining = sorted(a for a, t in self.pool._draining.items()
                                  if now - t < DRAIN_TTL_S)
            self._respond_json(200, {"status": "ok",
                                     "backends": self.pool._addrs,
                                     # fresh per-replica active+queued from
                                     # the /load poller; absent = unknown
                                     "backend_load": loads,
                                     "cooling_down": dead,
                                     "draining": draining})
            return
        if self.path == "/metrics":
            # The router's OWN counters (not proxied): the engine pods are
            # scraped directly by pod discovery; this route makes the gateway
            # itself visible to L5. The shared flight/SLO registries render
            # here too (the both-routes contract) — in the router
            # process they carry the GATEWAY's view (its own process has no
            # engine, so burn gauges stay at their exported defaults).
            slo.get().export()
            devmon.get().export()
            capacity.get().export()
            autoscaler.get().export()
            om = "application/openmetrics-text" in \
                (self.headers.get("Accept") or "")
            text = (self.metrics.registry.render(om)
                    + tracing.metrics.registry.render(om)
                    + flightrec.metrics.registry.render(om)
                    + slo.metrics.registry.render(om)
                    + devmon.metrics.registry.render(om)
                    + capacity.metrics.registry.render(om)
                    + autoscaler.metrics.registry.render(om)
                    + metrics.pipeline.registry.render(om))
            if om:
                text += "# EOF\n"
                ctype = ("application/openmetrics-text; version=1.0.0; "
                         "charset=utf-8")
            else:
                ctype = "text/plain; version=0.0.4"
            body = text.encode()
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if self.path.split("?")[0] == "/debug/fleet":
            # Fleet health aggregation: the poller's last /load +
            # /healthz sample per replica — burn rates, throughput, pool
            # pressure, last flight anomaly — in one gateway round trip.
            # Ages tell a dashboard how stale
            # each row is (a silent replica keeps its last sample + age).
            doc = {
                "backends": list(self.pool.addrs()),
                "cooling_down": self.pool.cooling(),
                "draining": self.pool.draining(),
                "replicas": self.pool.fleet(),
            }
            a = autoscaler.get()
            if a.enabled:
                doc["autoscale"] = a.status()
            self._respond_json(200, doc)
            return
        if self.path.split("?")[0] == "/debug/autoscale":
            # The controller's own view: committed target vs actual,
            # standby/draining/stuck counts, decision journal head.
            self._respond_json(200, autoscaler.get().status())
            return
        if self.path.split("?")[0] == "/debug/capacity":
            # Fleet capacity aggregation: per-replica offered load vs
            # service ceiling from the poller's last /healthz ``capacity``
            # block, summed into fleet-level saturation + a fleet replica
            # recommendation. Replicas running a pre-capacity build (mixed
            # version fleet during a rollout) get an explicit
            # ``available: false`` row rather than poisoning the sums.
            self._respond_json(200, _fleet_capacity(self.pool.fleet()))
            return
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length) if length else None
        path = self.path.split("?")[0]
        affinity_key = None
        if method == "POST" and path in ("/v1/completions",
                                         "/v1/chat/completions"):
            affinity_key = _affinity_key(path, body)
        candidates = self.pool.pick(affinity_key)
        self.metrics.backends.set(len(self.pool._addrs))
        if not candidates and method == "POST" \
                and path.startswith("/v1/") and autoscaler.get().enabled:
            # Scale-to-zero wake-up: the fleet is parked and a request
            # arrived. Hold THIS request (bounded) while the autoscaler
            # promotes a standby or cold-starts a replica (the wait is a
            # replica's ready-time), then re-pick. A standby promotion resolves in ~one tick.
            if autoscaler.get().request_cold_start():
                candidates = self.pool.pick(affinity_key)
        if not candidates:
            self.metrics.requests.inc(code="503")
            self._respond_json(503, {"error": {
                "message": "no serving backends resolved", "type": "router_error"}})
            return
        hdrs = {h: self.headers[h]
                for h in ("Content-Type", "Authorization", "Accept",
                          DEADLINE_HEADER)
                if self.headers.get(h)}
        # End-to-end deadline, parsed ONCE: every re-dispatch (429 backoff,
        # connect failover, mid-stream continuation) forwards only the
        # REMAINING budget — sleeps and failed attempts eat real wall-clock
        # the backend's enforcement must count (a header forwarded verbatim
        # would give a second hop a fresh deadline). The same remainder bounds this hop's read timeout. A
        # malformed header is forwarded verbatim; the backend answers 400.
        t_start = time.monotonic()
        ddl_ms = None
        raw_ddl = self.headers.get(DEADLINE_HEADER)
        if raw_ddl:
            try:
                ddl_ms = float(raw_ddl)
            except ValueError:
                pass    # backend rejects the malformed header with a 400
        # Mid-stream failover: for an eligible stream, every relayed
        # SSE event is accounted (token ids / text chars / [DONE]) so a
        # replica death mid-stream re-enters this loop as a CONTINUATION —
        # original body + resume fields — and only new chunks reach the
        # client. ``headers_sent`` guards every would-send-status path.
        fo = _failover_spec(path, body) if method == "POST" else None
        fo_state = {"token_ids": [], "chars": 0, "done": False,
                    "tagged": False, "headers_sent": False, "failovers": 0}
        cur_body = body
        last_err = None
        shed = None          # last 429 body, relayed if every retry sheds
        drained = None       # last draining-503 body, relayed if all drain
        n_429 = 0
        for i, addr in enumerate(candidates):
            if i > 0 and not fo_state["headers_sent"]:
                self.metrics.failovers.inc()
            hdrs2 = dict(hdrs)
            self._hop_begin(addr, i)
            if self._hop_span is not None:
                # the hop span IS the backend's parent: the server's
                # request span hangs off this dispatch attempt, so a
                # failover's two attempts stay distinguishable in Tempo
                hdrs2[tracing.TRACEPARENT_HEADER] = \
                    tracing.format_traceparent(self._hop_span.context)
            read_to = READ_TIMEOUT_S
            if ddl_ms is not None:
                rem_ms = ddl_ms - (time.monotonic() - t_start) * 1000.0
                if rem_ms <= 0:
                    # deadline burnt inside the gateway: answering now beats
                    # dispatching work the backend must immediately expire
                    self._hop_end("deadline_exhausted")
                    if fo_state["headers_sent"]:
                        self.close_connection = True
                        return
                    self.metrics.requests.inc(code="408")
                    self._respond_json(408, {"error": {
                        "message": "request deadline exhausted during "
                                   "gateway retries",
                        "type": "timeout", "code": "deadline_exceeded"}})
                    return
                hdrs2[DEADLINE_HEADER] = str(int(max(1.0, rem_ms)))
                # the per-hop remaining budget: the golden span-tree test
                # asserts this decreases strictly across retry hops
                self._hop_attr("deadline.remaining_ms",
                               int(max(1.0, rem_ms)))
                # the remaining deadline bounds this hop's read timeout too:
                # the backend answers 408 within it, so waiting the full
                # READ_TIMEOUT_S past it only pins a router thread
                read_to = min(READ_TIMEOUT_S,
                              max(1.0, rem_ms / 1000.0)
                              + READ_TIMEOUT_GRACE_S)
            # Phase 1: CONNECT, with its own short timeout. Connect-level
            # failures (refused, unreachable, DNS) are always safe to retry on
            # the next replica — the request never reached a server, so even a
            # non-idempotent POST cannot have started generating (retrying
            # POSTs after a long read timeout would duplicate in-flight
            # generations).
            a_host, _, a_port = addr.rpartition(":")
            conn = http.client.HTTPConnection(a_host, int(a_port),
                                              timeout=CONNECT_TIMEOUT_S)
            try:
                _chaos.get().check_connect(addr)   # fault injection hook
                conn.connect()
            except OSError as e:
                conn.close()
                self.pool.mark_dead(addr)
                self.metrics.dead_marks.inc()
                last_err = e
                self._hop_end("connect_failed", next_kind="failover")
                log.warning("backend %s connect failed (%s); trying next",
                            addr, e)
                continue
            # Phase 2: send + await response under the deadline-bounded read
            # timeout. The backend HAS the request now; a timeout here may
            # mean it is still generating. Requests with a body are NOT
            # retried past this point (a retry would duplicate the
            # generation on a second replica) — EXCEPT failover-eligible
            # streams, which re-issue as a continuation: whatever the dead
            # replica generated but didn't relay is re-derived
            # deterministically, and the client never sees a byte twice.
            try:
                conn.sock.settimeout(read_to)
                conn.request(method, self.path, body=cur_body, headers=hdrs2)
                resp = conn.getresponse()
            except OSError as e:
                conn.close()
                self.pool.mark_dead(addr)
                self.metrics.dead_marks.inc()
                last_err = e
                if cur_body is not None:
                    if fo is not None \
                            and fo_state["failovers"] < STREAM_FAILOVER_BUDGET \
                            and (fo_state["tagged"]
                                 or fo_state["chars"] == 0):
                        fo_state["failovers"] += 1
                        self.metrics.stream_failovers.inc()
                        cur_body = _continuation_body(fo, fo_state)
                        self._hop_end("backend_died",
                                      next_kind="stream_continuation")
                        log.warning("backend %s died pre-response (%s); "
                                    "re-issuing stream as continuation "
                                    "(%d tokens relayed)", addr, e,
                                    len(fo_state["token_ids"]))
                        continue
                    self._hop_end("backend_died")
                    log.warning("backend %s failed after accepting a request "
                                "body (%s); NOT retrying elsewhere", addr, e)
                    if fo_state["headers_sent"]:
                        self.close_connection = True
                        return
                    self.metrics.requests.inc(code="502")
                    self._respond_json(502, {"error": {
                        "message": f"backend failed mid-request: {e}",
                        "type": "router_error"}})
                    return
                self._hop_end("send_failed", next_kind="failover")
                log.warning("backend %s failed (%s); trying next", addr, e)
                continue
            # Phase 2.4: 503 + X-TPU-Draining = the replica shed at
            # admission because it is LEAVING (SIGTERM / preStop drain) —
            # nothing was generated, so re-routing is always safe, and the
            # replica is NOT dead-marked (no cooldown to serve out; the
            # poller excludes it until it stops draining).
            if resp.status == 503 and resp.headers.get("X-TPU-Draining"):
                drained = (resp.headers.get("Retry-After"), resp.read())
                conn.close()
                self.pool.note_draining(addr)
                self.metrics.draining_skips.inc()
                last_err = f"backend {addr} draining"
                self._hop_end("draining", next_kind="failover")
                log.info("backend %s draining; trying next", addr)
                continue
            # Phase 2.5: a 429 means the backend SHED the request at
            # admission — nothing was generated, so (unlike any other
            # post-send failure) retrying on the next replica is safe even
            # with a body. Jittered backoff, bounded budget; the replica is
            # NOT marked dead (it is healthy, just full). If every candidate
            # sheds, the last 429 (with its Retry-After) is the answer.
            if resp.status == 429:
                shed = (resp.headers.get("Retry-After"), resp.read())
                conn.close()
                if n_429 < RETRY_429_BUDGET and i < len(candidates) - 1:
                    n_429 += 1
                    self.metrics.retries_429.inc()
                    self._hop_end("shed_429", next_kind="retry_429")
                    import random as _random

                    time.sleep(RETRY_429_BACKOFF_S
                               * (0.5 + _random.random()))
                    continue
                self._hop_end("shed_429")
                if fo_state["headers_sent"]:
                    # a continuation shed everywhere: the open stream cannot
                    # become a 429 now — truncate
                    self.close_connection = True
                    return
                self._relay_shed(shed)
                return
            ctype = resp.headers.get("Content-Type", "application/json")
            if affinity_key is not None and resp.status < 500:
                # this replica now holds the prefix's pages — stick to it
                self.pool.note_affinity(affinity_key, addr)
            # Phase 3a: failover-capable SSE relay — COMPLETE events only
            # (the client must never hold half an event when the stream
            # switches replicas), each accounted into fo_state.
            if fo is not None and resp.status == 200 \
                    and "text/event-stream" in ctype:
                if not fo_state["headers_sent"]:
                    self.metrics.requests.inc(code="200")
                    self.send_response(200)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Connection", "close")
                    self.end_headers()
                    fo_state["headers_sent"] = True
                outcome = self._relay_sse(resp, addr, fo_state)
                conn.close()
                if outcome == "done":
                    if self._root_span is not None:
                        self._root_span.set_attribute("http.status_code",
                                                      200)
                    self._hop_end("stream_done")
                    return
                if outcome == "client_gone":
                    self._hop_end("client_gone")
                    # client disconnect, NOT a backend failure: no failover,
                    # no dead-mark (the backend cancels via broken pipe)
                    log.info("client disconnected mid-stream")
                    self.close_connection = True
                    return
                self.pool.mark_dead(addr)
                self.metrics.dead_marks.inc()
                if fo_state["failovers"] >= STREAM_FAILOVER_BUDGET \
                        or (fo_state["chars"] and not fo_state["tagged"]):
                    # can't (backend never tagged token ids) or won't
                    # (budget spent) continue: truncate
                    self._hop_end("backend_died")
                    log.warning("backend %s died mid-stream; NOT failing "
                                "over (tagged=%s, failovers=%d)", addr,
                                fo_state["tagged"], fo_state["failovers"])
                    self.close_connection = True
                    return
                fo_state["failovers"] += 1
                self.metrics.stream_failovers.inc()
                cur_body = _continuation_body(fo, fo_state)
                self._hop_end("backend_died",
                              next_kind="stream_continuation")
                log.warning("backend %s died mid-stream after %d tokens / "
                            "%d chars; continuing on the next replica",
                            addr, len(fo_state["token_ids"]),
                            fo_state["chars"])
                continue
            if fo_state["headers_sent"]:
                # a continuation answered something that isn't a stream
                # (4xx/5xx app error): the open SSE response cannot change
                # status — truncate
                self._hop_end("unexpected_status")
                conn.close()
                log.warning("continuation on %s answered %s; truncating "
                            "stream", addr, resp.status)
                self.close_connection = True
                return
            # Phase 3b: plain relay. A 4xx/5xx status is the app's answer,
            # not a dead replica — passed through as-is. A failure while
            # relaying must NOT retry another replica (that would splice a
            # second status line into the body) and a client disconnect
            # (BrokenPipeError) must NOT mark the backend dead.
            try:
                self.metrics.requests.inc(code=str(resp.status))
                if self._root_span is not None:
                    self._root_span.set_attribute("http.status_code",
                                                  resp.status)
                self._hop_attr("http.status_code", resp.status)
                self.send_response(resp.status)
                self.send_header("Content-Type", ctype)
                if "text/event-stream" in ctype:
                    # SSE: stream chunks through unbuffered; connection close
                    # delimits the body.
                    self.send_header("Connection", "close")
                    self.end_headers()
                    # read1 returns as soon as ANY bytes arrive — read(4096)
                    # would buffer whole events and defeat token streaming.
                    read1 = getattr(resp, "read1", None) or resp.read
                    while True:
                        chunk = read1(4096)
                        if not chunk:
                            break
                        self.wfile.write(chunk)
                        self.wfile.flush()
                else:
                    data = resp.read()
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
            except BrokenPipeError:
                log.info("client disconnected mid-response")
                self.close_connection = True
            except OSError as e:
                # Backend died mid-body: response is unsalvageable; cut the
                # connection so the client sees a truncated body, not a corrupt one.
                self.pool.mark_dead(addr)
                self.metrics.dead_marks.inc()
                log.warning("backend %s died mid-response: %s", addr, e)
                self.close_connection = True
            finally:
                conn.close()
            self._hop_end("relayed")
            return
        if fo_state["headers_sent"]:
            # a mid-stream failover ran out of replicas: truncate
            log.warning("stream abandoned: no replica could continue it")
            self.close_connection = True
            return
        if shed is not None:
            # every connectable replica shed the request: the honest answer
            # is the overload signal itself, not a 502
            self._relay_shed(shed)
            return
        if drained is not None:
            # the whole pool is draining (rolling restart trough): the
            # honest answer is the draining 503 + Retry-After, not a 502
            self.metrics.requests.inc(code="503")
            self.send_response(503)
            self.send_header("Content-Type", "application/json")
            self.send_header("X-TPU-Draining", "1")
            if drained[0]:
                self.send_header("Retry-After", drained[0])
            self.send_header("Content-Length", str(len(drained[1])))
            self.end_headers()
            self.wfile.write(drained[1])
            return
        self.metrics.requests.inc(code="502")
        self._respond_json(502, {"error": {
            "message": f"all backends failed: {last_err}", "type": "router_error"}})

    def _relay_shed(self, shed):
        """Answer with the backend's own 429 (Retry-After preserved)."""
        self.metrics.requests.inc(code="429")
        self.send_response(429)
        self.send_header("Content-Type", "application/json")
        if shed[0]:
            self.send_header("Retry-After", shed[0])
        self.send_header("Content-Length", str(len(shed[1])))
        self.end_headers()
        self.wfile.write(shed[1])

    def _relay_sse(self, resp, addr: str, st: dict) -> str:
        """Relay COMPLETE SSE events to the client, accounting each into the
        failover state (token ids / chars / [DONE]). Whole-event forwarding
        is what makes a mid-stream death spliceable: the client never holds
        half an event when the stream switches replicas. Returns ``"done"``
        (stream ended cleanly), ``"backend_died"`` (socket error, premature
        EOF, or chunked-body truncation), or ``"client_gone"``."""
        ch = _chaos.get()
        read1 = getattr(resp, "read1", None) or resp.read
        buf = b""
        n_events = 0
        while True:
            try:
                if ch.enabled:
                    # router-side fault point: injected mid-stream read error
                    ch.check_stream_read(addr, n_events)
                data = read1(4096)
            except (OSError, http.client.HTTPException):
                return "backend_died"
            if not data:
                # clean EOF before [DONE] = the replica shut down mid-stream
                return "done" if st["done"] else "backend_died"
            buf += data
            while b"\n\n" in buf:
                event, buf = buf.split(b"\n\n", 1)
                try:
                    self.wfile.write(event + b"\n\n")
                    self.wfile.flush()
                except OSError:
                    return "client_gone"
                _track_sse_event(event, st)
                n_events += 1

    def do_GET(self):
        self._proxy("GET")

    def do_POST(self):
        self._proxy("POST")


def serve(backend_service: str, host: str, port: int,
          otlp_endpoint: str = "", trace_sample: float = 1.0,
          autoscale: bool = False, autoscale_launch_cmd: str = "",
          autoscale_kw: dict | None = None):
    RouterHandler.pool = BackendPool(backend_service)
    RouterHandler.metrics = RouterMetrics()
    RouterHandler.tracer = tracing.build_tracer(
        "tpu-serve-router", endpoint=otlp_endpoint or None,
        sample=trace_sample)
    start_load_poller(RouterHandler.pool, metrics=RouterHandler.metrics)
    if autoscale:
        a = autoscaler.configure(enabled=True, **(autoscale_kw or {}))
        launcher = None
        if autoscale_launch_cmd:
            launcher = autoscaler.CommandLauncher(autoscale_launch_cmd)
        a.install(pool=RouterHandler.pool, launcher=launcher)
        for addr in RouterHandler.pool.addrs():
            a.adopt(addr)
        a.start()
    httpd = ThreadingHTTPServer((host, port), RouterHandler)
    log.info("router listening on %s:%d -> %s", host, port, backend_service)
    httpd.serve_forever()


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    p = argparse.ArgumentParser(description="serving gateway router")
    p.add_argument("--backend-service", required=True,
                   help="host:port of the engine Service (DNS resolved to replicas)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--otlp-endpoint", default="",
                   help="OTLP/HTTP trace collector base URL; empty falls "
                        "back to $OTEL_EXPORTER_OTLP_ENDPOINT, neither = "
                        "spans stay local")
    p.add_argument("--trace-sample", type=float, default=1.0,
                   help="root-span sampling probability in [0, 1]")
    p.add_argument("--autoscale", type=int, default=0,
                   help="1 = run the replica autoscaler in this gateway: "
                        "consume /debug/capacity's fleet recommendation, "
                        "launch/drain replicas to match (serving/"
                        "autoscaler.py)")
    p.add_argument("--autoscale-launch-cmd", default="",
                   help="replica launch command template with a {port} "
                        "placeholder (CommandLauncher); empty = the "
                        "autoscaler can only drain/adopt, never launch")
    p.add_argument("--autoscale-min", type=int, default=1,
                   help="replica floor (0 enables scale-to-zero: an idle "
                        "fleet parks and the first request cold-starts it)")
    p.add_argument("--autoscale-max", type=int, default=8,
                   help="replica ceiling")
    p.add_argument("--autoscale-standby", type=int, default=-1,
                   help="prewarmed standby replicas kept ready out of "
                        "rotation (-1 = derive from the replica ready-time)")
    p.add_argument("--autoscale-interval", type=float,
                   default=autoscaler.DEFAULT_INTERVAL_S,
                   help="reconcile tick seconds")
    p.add_argument("--autoscale-stable", type=float,
                   default=autoscaler.DEFAULT_STABLE_S,
                   help="hysteresis: a target change must persist this "
                        "long before it commits")
    p.add_argument("--autoscale-cooldown", type=float,
                   default=autoscaler.DEFAULT_COOLDOWN_S,
                   help="minimum seconds between direction reversals "
                        "(flap suppression)")
    p.add_argument("--autoscale-idle-timeout", type=float,
                   default=autoscaler.DEFAULT_IDLE_TIMEOUT_S,
                   help="idle seconds before scale-to-zero parks the "
                        "fleet (only with --autoscale-min 0)")
    args = p.parse_args(argv)
    serve(args.backend_service, args.host, args.port,
          otlp_endpoint=args.otlp_endpoint, trace_sample=args.trace_sample,
          autoscale=bool(args.autoscale),
          autoscale_launch_cmd=args.autoscale_launch_cmd,
          autoscale_kw=dict(min_replicas=args.autoscale_min,
                            max_replicas=args.autoscale_max,
                            standby=args.autoscale_standby,
                            interval_s=args.autoscale_interval,
                            stable_s=args.autoscale_stable,
                            cooldown_s=args.autoscale_cooldown,
                            idle_timeout_s=args.autoscale_idle_timeout))


if __name__ == "__main__":
    main()
