"""Declarative SLOs with Google-SRE multi-window burn rates (5m / 1h).

A copy of the JAX package's ``serving/slo.py`` (the port imports nothing of
that package). Serverless autoscaling needs a scaling signal built from
queue-depth/shed-rate/p95 — this module makes that signal a proper SLO
computation instead of ad-hoc threshold checks scattered through an
autoscaler loop. Four objectives over sliding windows:

==============  ==========================================================
objective       bad event (counts against the error budget)
==============  ==========================================================
``ttft_p95``    a first token slower than the TTFT target (budget 5%)
``e2e_p95``     an end-to-end latency above the e2e target (budget 5%)
``error_rate``  a request finishing "error"/"timeout" (budget = config)
``shed_rate``   a submission shed at admission (budget = config)
==============  ==========================================================

The burn rate is the SRE-book definition: (observed bad fraction in the
window) / (budget fraction). 1.0 = burning exactly the budget; 14.4 on the
5m window is the classic page-now threshold. Two windows (5m, 1h) give the
fast-burn/slow-burn pair; both export as
``tpu_serve_slo_burn_rate{objective,window}`` gauges and surface on
``/healthz`` for the router's fleet view and the L3 reconcile probe.

Everything is computed from ``time.monotonic()`` through an injectable clock,
so seeded tests assert exact burn values with a fake clock — no sleeps, no
flakes. Observation is O(1) append under a short lock; the burn computation
walks at most the window's samples at query time (observability reads pay,
request paths don't).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Deque, Dict, Optional, Tuple

from aws_k8s_ansible_provisioner_tpu_torch.serving.metrics import Gauge, Registry

# (label, seconds) — the SRE fast/slow burn pair.
WINDOWS: Tuple[Tuple[str, float], ...] = (("5m", 300.0), ("1h", 3600.0))


def trim_window(dq, now: float, window_s: float) -> None:
    """Drop samples older than ``now - window_s`` off a time-ordered deque
    of ``(t, ...)`` tuples. The one trimming discipline every windowed
    accumulator in serving/ shares (this engine's burn windows, devmon's
    attribution window) — samples age out on WRITE and READ, so an idle
    window drains to empty instead of freezing its last value."""
    horizon = now - window_s
    while dq and dq[0][0] < horizon:
        dq.popleft()

# Terminal statuses that burn the error budget ("cancelled" is the client
# hanging up — their choice, not our failure).
BAD_STATUSES = ("error", "timeout")


class SLOMetrics:
    """The SLO engine's gauge set, rendered by BOTH the engine's and the
    router's /metrics routes (the burn rate is the fleet-level signal; the
    router aggregates it without scraping every replica twice)."""

    def __init__(self):
        self.registry = Registry()
        self.burn_rate = self.registry.register(Gauge(
            "tpu_serve_slo_burn_rate",
            "SLO error-budget burn rate per objective and window "
            "(1.0 = burning exactly the budget; >1 = on track to exhaust it)",
            ("objective", "window")))


# Process-wide: the engine(s) and both /metrics routes share these.
metrics = SLOMetrics()


class Objective:
    """One declarative objective: a latency target or a bad-event ratio."""

    __slots__ = ("name", "target_s", "budget")

    def __init__(self, name: str, budget: float,
                 target_s: Optional[float] = None):
        self.name = name
        self.target_s = target_s        # None for pure ratio objectives
        self.budget = max(1e-9, float(budget))


class SLOEngine:
    """Sliding-window burn-rate computation over the four objectives.

    ``clock`` defaults to ``time.monotonic`` and is injectable so tests
    drive exact timelines. Samples are ``(t, bad)`` pairs in per-objective
    deques, trimmed past the longest window on append; burn rates are
    computed at query time, so two calls at the same (fake) clock reading
    return identical values — the determinism contract the seeded tests
    assert.
    """

    MAX_SAMPLES = 100_000   # hard memory bound per objective (drop-oldest)

    def __init__(self, ttft_p95_ms: float = 0.0, e2e_p95_ms: float = 0.0,
                 error_rate: float = 0.01, shed_rate: float = 0.05,
                 enabled: bool = True,
                 clock: Callable[[], float] = time.monotonic):
        self.enabled = bool(enabled)
        self.clock = clock
        self.objectives: Dict[str, Objective] = {}
        if ttft_p95_ms and ttft_p95_ms > 0:
            self.objectives["ttft_p95"] = Objective(
                "ttft_p95", 0.05, target_s=ttft_p95_ms / 1000.0)
        if e2e_p95_ms and e2e_p95_ms > 0:
            self.objectives["e2e_p95"] = Objective(
                "e2e_p95", 0.05, target_s=e2e_p95_ms / 1000.0)
        if error_rate and error_rate > 0:
            self.objectives["error_rate"] = Objective("error_rate",
                                                      error_rate)
        if shed_rate and shed_rate > 0:
            self.objectives["shed_rate"] = Objective("shed_rate", shed_rate)
        self._lock = threading.Lock()
        self._samples: Dict[str, Deque[Tuple[float, int]]] = {
            name: collections.deque(maxlen=self.MAX_SAMPLES)
            for name in self.objectives}

    # -- observation side (engine thread + handler threads) ------------------

    def _observe(self, name: str, bad: bool):
        dq = self._samples.get(name)
        if dq is None:
            return
        now = self.clock()
        with self._lock:
            dq.append((now, 1 if bad else 0))
            trim_window(dq, now, WINDOWS[-1][1])

    def observe_ttft(self, ttft_s: float):
        if not self.enabled:
            return
        obj = self.objectives.get("ttft_p95")
        if obj is not None:
            self._observe("ttft_p95", ttft_s > obj.target_s)

    def observe_request(self, status: str, duration_s: float):
        """One terminal request: feeds error_rate and e2e_p95."""
        if not self.enabled:
            return
        self._observe("error_rate", status in BAD_STATUSES)
        obj = self.objectives.get("e2e_p95")
        if obj is not None and status not in BAD_STATUSES:
            self._observe("e2e_p95", duration_s > obj.target_s)

    def observe_admission(self, shed: bool):
        """One submit() outcome: feeds shed_rate (good = admitted)."""
        if not self.enabled:
            return
        self._observe("shed_rate", shed)

    # -- query side (deterministic at a fixed clock reading) -----------------

    def bad_fraction(self, objective: str, window_s: float,
                     now: Optional[float] = None) -> float:
        """Raw bad fraction in the window (burn rate BEFORE the budget
        division) — the shed/error pressure figure consumers that are not
        budget-relative (serving/capacity.py's saturation view) read
        directly. 0.0 with no samples or an unknown objective."""
        dq = self._samples.get(objective)
        if dq is None:
            return 0.0
        t0 = (self.clock() if now is None else now) - window_s
        with self._lock:
            n = bad = 0
            for t, b in reversed(dq):
                if t < t0:
                    break
                n += 1
                bad += b
        return (bad / n) if n else 0.0

    def burn_rate(self, objective: str, window_s: float,
                  now: Optional[float] = None) -> float:
        """(bad fraction in the window) / budget; 0.0 with no samples."""
        obj = self.objectives.get(objective)
        if obj is None:
            return 0.0
        return self.bad_fraction(objective, window_s, now=now) / obj.budget

    def snapshot(self, now: Optional[float] = None) -> dict:
        """Per-objective burn rates for /healthz and the fleet view."""
        now = self.clock() if now is None else now
        out = {}
        for name, obj in self.objectives.items():
            out[name] = {
                "budget": obj.budget,
                **({"target_s": obj.target_s}
                   if obj.target_s is not None else {}),
                **{label: round(self.burn_rate(name, secs, now=now), 6)
                   for label, secs in WINDOWS},
            }
        return out

    def export(self):
        """Refresh the tpu_serve_slo_burn_rate gauges (called by the
        /metrics and /healthz handlers just before rendering)."""
        now = self.clock()
        for name in self.objectives:
            for label, secs in WINDOWS:
                metrics.burn_rate.set(self.burn_rate(name, secs, now=now),
                                      objective=name, window=label)

    def burning(self, threshold: float = 1.0,
                window: str = "5m") -> Optional[str]:
        """The first objective whose ``window`` burn exceeds ``threshold``
        (the L3 probe's slo: ok|burning signal), else None."""
        secs = dict(WINDOWS).get(window, WINDOWS[0][1])
        for name in self.objectives:
            if self.burn_rate(name, secs) > threshold:
                return name
        return None


# ---------------------------------------------------------------------------
# Module-level wiring: one SLO engine per process.
# ---------------------------------------------------------------------------

_engine: Optional[SLOEngine] = None
_engine_lock = threading.Lock()


def get() -> SLOEngine:
    """The process-wide SLO engine (default objectives until configure)."""
    global _engine
    with _engine_lock:
        if _engine is None:
            _engine = SLOEngine()
        return _engine


def configure(**kw) -> SLOEngine:
    """Build and install the process SLO engine (build_state / tests)."""
    global _engine
    eng = SLOEngine(**kw)
    with _engine_lock:
        _engine = eng
    return eng


def reset() -> SLOEngine:
    """Fresh default engine (tests)."""
    return configure()
