"""Capacity & saturation observatory — the scaling-signal plane.

A copy of the JAX package's ``serving/capacity.py`` (the port imports
nothing of that package). Serverless autoscaling scales on
queue-depth/shed-rate/p95 — but those are raw counters, not a signal. This
module composes them into the complete signal an autoscaler actuates on:
offered load, a replica's ceiling and the time to saturation against a
replica's ready-time (recommendation-only — no actuation here):

1. **Offered load.** Every ``Engine.submit()`` outcome — admitted or shed —
   reports its requested decode budget here. Sliding 60 s / 5 m windows
   (slo.py's ``trim_window`` discipline) yield request and token arrival
   rates plus the admitted-vs-shed split. Offered load counts sheds: demand
   the admission controller turned away is still demand.

2. **Service capacity.** Sustained decode tok/s blended from devmon's
   roofline ceiling and the measured per-program throughput
   (``DevMon.service_rates()``): the measured rate is already degraded by
   DMA-wait (it divides real device seconds), the analytical roofline is an
   upper bound never fully achieved, so the ceiling sits ``ROOFLINE_BLEND``
   of the way between them, then degrades by a duty-cycle factor for the
   host gaps the dispatch loop pays between programs.

3. **Saturation.** Utilization = offered / ceiling; a Little's-law queue
   delay (queue depth ÷ service rate in requests/s); shed fraction over the
   window.

4. **Forecast.** Bucketed offered-load rates over the 5 m window feed an
   EWMA level and a least-squares trend slope → ``seconds_to_saturation``
   (capped at ``FORECAST_CAP_S``; 0.0 = saturated now), and
   ``recommended_replicas`` sized so the fleet absorbs the demand projected
   ``headroom_s`` ahead — headroom equal to a replica's measured
   ready-time, so a replica started on this signal is serving before the
   projection lands.

Surfaces: the six ``tpu_capacity_*`` gauges on BOTH /metrics routes
(written only by ``CapacityEstimator.export()``), a
``capacity`` block on /healthz relayed by the router's ~1 Hz poller into
``GET /debug/capacity``, and the tputop capacity panel.

Contracts, inherited from flightrec/slo/devmon: ``observe_submit`` is an
O(1) append under a short lock (seeded streams are byte-identical with the
estimator on or off); ``export()`` drops-not-fails (chaos fault
``capacity_export_error`` — a broken estimator costs one gauge refresh,
never a request or a /metrics render); every timestamp flows through an
injectable monotonic clock so forecasts are exact-arithmetic testable.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, Optional, Tuple

from aws_k8s_ansible_provisioner_tpu_torch.serving.metrics import (
    Counter, Gauge, Registry)
from aws_k8s_ansible_provisioner_tpu_torch.serving.slo import trim_window

# Rate window (headline gauges) and trend window (forecast slope).
WINDOW_S = 60.0
TREND_WINDOW_S = 300.0

# Trend resolution: offered-load rates are bucketed at this granularity
# before the EWMA/least-squares pass (raw per-submit timestamps would make
# the slope an artifact of arrival jitter, not of load growth).
TREND_BUCKET_S = 10.0

# EWMA weight per trend bucket (0.5: the level halves its memory every
# bucket — fast enough to track a ramp, slow enough to ignore one burst).
EWMA_ALPHA = 0.5

# Ceiling blend: how far the ceiling sits from measured toward the
# analytical roofline. The roofline is an upper bound never fully achieved;
# promising 25% of the remaining gap acknowledges optimization headroom
# without scaling the fleet against a number the device has never hit.
ROOFLINE_BLEND = 0.25

# Assumed sustainable duty cycle: device tok/s -> wall tok/s degradation
# for the host gaps between dispatched programs. When the observed duty
# cycle exceeds it, the observation wins (the host demonstrably keeps the
# device busier than the assumption).
DUTY_FLOOR = 0.9

# Forecast cap: seconds_to_saturation at/above this means "no saturation
# within the horizon" — a finite sentinel keeps the gauge OpenMetrics-clean
# (no +Inf) and the dashboards sortable.
FORECAST_CAP_S = 3600.0

# Headroom the replica recommendation buys: a replica's ready-time — the
# port's default replica from its start to /readyz 200 on an NVIDIA H100
# 80GB HBM3 at a 700 W power limit, the median of chip_smoke.py's
# fleet-phase launches rounded up to a whole second (the autoscaler's
# DEFAULT_READY_S); --capacity-headroom-s sets a deployment's own.
DEFAULT_HEADROOM_S = 15.0


class CapacityMetrics:
    """The tpu_capacity_* family. Registered here, rendered by BOTH
    /metrics routes, written only by CapacityEstimator.export()."""

    def __init__(self):
        r = Registry()
        self.registry = r
        self.offered_tps = r.register(Gauge(
            "tpu_capacity_offered_tps",
            "Offered decode load over the rate window, tokens/s of "
            "requested budget — admitted AND shed (demand, not service)"))
        self.ceiling_tps = r.register(Gauge(
            "tpu_capacity_ceiling_tps",
            "Estimated sustainable decode tokens/s for this replica "
            "(devmon measured throughput blended toward the roofline, "
            "degraded by the duty-cycle factor)"))
        self.utilization = r.register(Gauge(
            "tpu_capacity_utilization",
            "Offered load over the capacity ceiling (>= 1.0 = saturated; "
            "0 when the ceiling is still unknown)"))
        self.queue_delay_s = r.register(Gauge(
            "tpu_capacity_queue_delay_s",
            "Little's-law queue-delay estimate: admission queue depth "
            "over the ceiling-derived service rate in requests/s"))
        self.seconds_to_saturation = r.register(Gauge(
            "tpu_capacity_seconds_to_saturation",
            "EWMA + linear-trend forecast of when offered load crosses "
            "the ceiling (0 = saturated now; capped, cap = no saturation "
            "within the horizon)"))
        self.recommended_replicas = r.register(Gauge(
            "tpu_capacity_recommended_replicas",
            "Replicas of this class needed for the demand projected one "
            "AOT ready-time ahead (recommendation only — nothing actuates "
            "on it in-process)"))
        self.export_drops = r.register(Counter(
            "tpu_capacity_export_drops_total",
            "Gauge refreshes dropped because the estimator raised "
            "(drop-not-fail: the /metrics render proceeds with stale "
            "values)"))


metrics = CapacityMetrics()


class CapacityEstimator:
    """Per-replica offered-load / ceiling / saturation / forecast engine.

    ``clock`` is injectable (tests drive a fake); the lock guards only the
    submit deque, and no devmon or engine closure is ever called while it
    is held (locksan: no nested lock order against devmon's)."""

    MAX_SAMPLES = 100_000   # hard memory bound (drop-oldest via deque)

    def __init__(self, enabled: bool = True,
                 headroom_s: float = DEFAULT_HEADROOM_S,
                 window_s: float = WINDOW_S,
                 trend_window_s: float = TREND_WINDOW_S,
                 roofline_blend: float = ROOFLINE_BLEND,
                 duty_floor: float = DUTY_FLOOR,
                 clock: Callable[[], float] = time.monotonic):
        self.enabled = bool(enabled)
        self.headroom_s = max(0.0, float(headroom_s))
        self.window_s = float(window_s)
        self.trend_window_s = max(float(trend_window_s), self.window_s)
        self.roofline_blend = min(1.0, max(0.0, roofline_blend))
        self.duty_floor = min(1.0, max(0.0, duty_floor))
        self.clock = clock
        self._lock = threading.Lock()
        self._t0 = clock()
        # (t, tokens_requested, shed) — one entry per submit() outcome
        self._submits: Deque[Tuple[float, float, int]] = deque(
            maxlen=self.MAX_SAMPLES)
        # last submit() of any kind — the autoscaler's scale-to-zero idle
        # signal (None = never: idle since birth)
        self._last_submit_t: Optional[float] = None
        # saturation-calibrated ceiling (tok/s): EWMA of the admitted
        # token rate measured while admission was SHEDDING — ground truth
        # that overrides an optimistic analytical ceiling (0 = never
        # calibrated; see snapshot())
        self._observed_ceiling_tps: float = 0.0
        # engine wiring (installed by Engine._install_capacity)
        self._queue_depth_fn: Optional[Callable[[], int]] = None
        self._measured_tps_fn: Optional[Callable[[], float]] = None
        # service-rate source; default reads the process devmon (injectable
        # so tests hand-build the ceiling arithmetic)
        self._devmon_fn: Optional[Callable[[], dict]] = None

    # -- wiring --------------------------------------------------------------

    def install_engine(self, queue_depth_fn: Callable[[], int],
                       measured_tps_fn: Callable[[], float]):
        with self._lock:
            self._queue_depth_fn = queue_depth_fn
            self._measured_tps_fn = measured_tps_fn

    def install_devmon(self, devmon_fn: Callable[[], dict]):
        with self._lock:
            self._devmon_fn = devmon_fn

    # -- observation side (engine submit path; O(1), never blocks) ----------

    def observe_submit(self, tokens: float = 1.0, shed: bool = False):
        """Record one submit() outcome — admitted or shed — with its
        requested decode budget in tokens. Offered load counts both:
        demand the admission controller turned away is still demand."""
        if not self.enabled:
            return
        now = self.clock()
        with self._lock:
            self._last_submit_t = now
            self._submits.append((now, max(0.0, float(tokens)),
                                  1 if shed else 0))
            trim_window(self._submits, now, self.trend_window_s)

    # -- query side (deterministic at a fixed clock reading) -----------------

    def offered(self, now: Optional[float] = None,
                window_s: Optional[float] = None) -> dict:
        """Arrival rates over the window: requests/s, tokens/s, and the
        admitted-vs-shed split. Rates divide by the LIVE part of the
        window (a 10 s old estimator doesn't dilute its rate over 60 s)."""
        now = self.clock() if now is None else now
        window_s = self.window_s if window_s is None else window_s
        horizon = now - window_s
        n = shed = 0
        toks = shed_toks = 0.0
        with self._lock:
            for t, tok, s in reversed(self._submits):
                if t < horizon:
                    break
                n += 1
                toks += tok
                if s:
                    shed += 1
                    shed_toks += tok
        elapsed = max(min(window_s, now - self._t0), 1e-9)
        return {
            "window_s": window_s,
            "requests_per_s": n / elapsed,
            "tokens_per_s": toks / elapsed,
            "admitted_per_s": (n - shed) / elapsed,
            "shed_per_s": shed / elapsed,
            "shed_fraction": (shed / n) if n else 0.0,
            "avg_tokens_per_request": (toks / n) if n else 0.0,
        }

    def ceiling(self, now: Optional[float] = None) -> dict:
        """Sustainable decode tok/s: devmon's measured service rate
        blended ``roofline_blend`` of the way toward the analytical
        roofline, then degraded by the duty factor. Falls back to the
        engine's own tok/s gauge when devmon has no decode window yet."""
        with self._lock:
            devmon_fn = self._devmon_fn
            tps_fn = self._measured_tps_fn
        rates: dict = {}
        if devmon_fn is None:
            # late import: capacity must stay importable engine-free
            from aws_k8s_ansible_provisioner_tpu_torch.serving import devmon
            try:
                rates = devmon.get().service_rates(now)
            except Exception:
                rates = {}
        else:
            try:
                rates = dict(devmon_fn() or {})
            except Exception:
                rates = {}
        measured = float(rates.get("measured_tps") or 0.0)
        roofline = float(rates.get("roofline_tps") or 0.0)
        duty = float(rates.get("duty_cycle") or 0.0)
        source = "devmon"
        if measured <= 0.0 and tps_fn is not None:
            # no decode window yet: the engine's throughput gauge is the
            # only measurement; no roofline to blend toward
            try:
                measured = max(0.0, float(tps_fn() or 0.0))
            except Exception:
                measured = 0.0
            roofline = measured
            source = "engine"
        if measured <= 0.0:
            return {"ceiling_tps": 0.0, "measured_tps": 0.0,
                    "roofline_tps": 0.0, "duty_factor": self.duty_floor,
                    "source": "none"}
        roofline = max(roofline, measured)
        blended = measured + self.roofline_blend * (roofline - measured)
        duty_factor = min(1.0, max(duty, self.duty_floor))
        return {"ceiling_tps": blended * duty_factor,
                "measured_tps": measured, "roofline_tps": roofline,
                "duty_factor": duty_factor, "source": source}

    def _trend_series(self, now: float) -> list:
        """Bucketed offered-token rates over the trend window, oldest
        first: [(bucket_mid_t, tokens_per_s), ...]. Buckets align to
        ``now``; the in-progress bucket is excluded (its rate would read
        low), and buckets predating the estimator are excluded (they were
        never observable, not observed-empty)."""
        start = now - self.trend_window_s
        with self._lock:
            samples = list(self._submits)
        n_buckets = int(self.trend_window_s / TREND_BUCKET_S)
        sums = [0.0] * n_buckets
        for t, tok, _ in samples:
            i = int((t - start) / TREND_BUCKET_S)
            if 0 <= i < n_buckets:
                sums[i] += tok
        series = []
        for i in range(n_buckets):
            lo = start + i * TREND_BUCKET_S
            if lo < self._t0 - 1e-9 or lo + TREND_BUCKET_S > now + 1e-9:
                continue
            series.append((lo + TREND_BUCKET_S / 2.0,
                           sums[i] / TREND_BUCKET_S))
        return series

    @staticmethod
    def _ewma_and_slope(series: list) -> Tuple[Optional[float], float]:
        """(EWMA level, least-squares slope tok/s per s) over the bucket
        series; (None, 0.0) when there is nothing to fit."""
        if not series:
            return None, 0.0
        level = series[0][1]
        for _, r in series[1:]:
            level = EWMA_ALPHA * r + (1.0 - EWMA_ALPHA) * level
        if len(series) < 2:
            return level, 0.0
        n = float(len(series))
        mx = sum(t for t, _ in series) / n
        my = sum(r for _, r in series) / n
        var = sum((t - mx) ** 2 for t, _ in series)
        if var <= 0.0:
            return level, 0.0
        cov = sum((t - mx) * (r - my) for t, r in series)
        return level, cov / var

    def snapshot(self, now: Optional[float] = None) -> dict:
        """The /healthz capacity block (and the /debug/capacity row)."""
        now = self.clock() if now is None else now
        off = self.offered(now)
        ceil_d = self.ceiling(now)
        ceiling = ceil_d["ceiling_tps"]
        ceiling_source = ceil_d["source"]
        # Saturation calibration: while admission is SHEDDING, the replica
        # is by definition serving at its real limit, so the admitted token
        # rate in that window is a measured ceiling — ground truth that
        # beats the roofline blend (wildly optimistic on a host device, where a
        # ceiling too generous would report ~0 utilization while clients
        # eat 429s, pinning the fleet recommendation at its current size).
        admitted_tps = off["admitted_per_s"] * off["avg_tokens_per_request"]
        with self._lock:
            if off["shed_per_s"] > 0.0 and admitted_tps > 0.0:
                prior = self._observed_ceiling_tps
                self._observed_ceiling_tps = admitted_tps if prior <= 0.0 \
                    else EWMA_ALPHA * admitted_tps + (1 - EWMA_ALPHA) * prior
            observed = self._observed_ceiling_tps
        if 0.0 < observed < ceiling:
            ceiling = observed
            ceiling_source = "observed"
        offered_tps = off["tokens_per_s"]
        utilization = (offered_tps / ceiling) if ceiling > 0.0 else 0.0

        queue_depth = 0
        with self._lock:
            q_fn = self._queue_depth_fn
        if q_fn is not None:
            try:
                queue_depth = max(0, int(q_fn()))
            except Exception:
                queue_depth = 0
        avg_tok = off["avg_tokens_per_request"]
        if ceiling > 0.0 and avg_tok > 0.0:
            # Little's law: delay = L / mu, with mu in requests/s
            queue_delay_s = queue_depth * avg_tok / ceiling
        else:
            queue_delay_s = 0.0

        level, slope = self._ewma_and_slope(self._trend_series(now))
        if ceiling <= 0.0:
            # capacity unknown: no saturation claim either way
            sts = FORECAST_CAP_S
        elif offered_tps >= ceiling or (level is not None
                                        and level >= ceiling):
            sts = 0.0
        elif level is None or slope <= 1e-9:
            sts = FORECAST_CAP_S
        else:
            sts = min(FORECAST_CAP_S, (ceiling - level) / slope)

        projected = (level if level is not None else offered_tps) \
            + max(0.0, slope) * self.headroom_s
        if ceiling > 0.0 and projected > 0.0:
            recommended = max(1, math.ceil(projected / ceiling - 1e-9))
        else:
            recommended = 1
        with self._lock:
            last_submit = self._last_submit_t
        if last_submit is not None:
            last_submit_age = max(0.0, now - last_submit)
        else:
            # never submitted: idle for the estimator's whole life
            last_submit_age = max(0.0, now - self._t0)
        return {
            "enabled": self.enabled,
            "window_s": self.window_s,
            "trend_window_s": self.trend_window_s,
            "headroom_s": self.headroom_s,
            "last_submit_age_s": round(last_submit_age, 3),
            "idle": offered_tps <= 0.0,
            "offered": off,
            "offered_tps": offered_tps,
            "ceiling_tps": ceiling,
            "ceiling_source": ceiling_source,
            "measured_tps": ceil_d["measured_tps"],
            "roofline_tps": ceil_d["roofline_tps"],
            "duty_factor": ceil_d["duty_factor"],
            "utilization": utilization,
            "queue_depth": queue_depth,
            "queue_delay_s": queue_delay_s,
            "ewma_offered_tps": level if level is not None else 0.0,
            "trend_tps_per_s": slope,
            "projected_offered_tps": projected,
            "seconds_to_saturation": sts,
            "saturated": sts <= 0.0,
            "recommended_replicas": recommended,
        }

    def export(self) -> Optional[dict]:
        """Refresh every tpu_capacity_* gauge — the single writer site for
        the family. Routes call this right before rendering;
        a raise here is swallowed and counted (drop-not-fail: the render
        proceeds with the previous values)."""
        try:
            from aws_k8s_ansible_provisioner_tpu_torch.serving import chaos
            chaos.get().on_capacity_export()
            snap = self.snapshot()
            metrics.offered_tps.set(snap["offered_tps"])
            metrics.ceiling_tps.set(snap["ceiling_tps"])
            metrics.utilization.set(snap["utilization"])
            metrics.queue_delay_s.set(snap["queue_delay_s"])
            metrics.seconds_to_saturation.set(
                snap["seconds_to_saturation"])
            metrics.recommended_replicas.set(
                float(snap["recommended_replicas"]))
            return snap
        except Exception:
            metrics.export_drops.inc()
            return None


# ---------------------------------------------------------------------------
# Module-level wiring: one estimator per process (the devmon pattern).
# ---------------------------------------------------------------------------

_estimator: Optional[CapacityEstimator] = None
_estimator_lock = threading.Lock()


def get() -> CapacityEstimator:
    global _estimator
    with _estimator_lock:
        if _estimator is None:
            _estimator = CapacityEstimator()
        return _estimator


def configure(**kw) -> CapacityEstimator:
    """Swap in a freshly-configured estimator, carrying over the wiring
    (engine closures + devmon source) the previous instance held —
    build_state configures AFTER the engine attaches."""
    global _estimator
    with _estimator_lock:
        old = _estimator
        _estimator = CapacityEstimator(**kw)
        if old is not None:
            _estimator._queue_depth_fn = old._queue_depth_fn
            _estimator._measured_tps_fn = old._measured_tps_fn
            _estimator._devmon_fn = old._devmon_fn
        return _estimator


def reset() -> CapacityEstimator:
    global _estimator
    with _estimator_lock:
        _estimator = CapacityEstimator()
        return _estimator
