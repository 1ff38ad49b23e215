"""Minimal Prometheus metrics registry (text exposition format, no deps).

A copy of the JAX package's ``serving/metrics.py`` (the port imports nothing
of that package): the same families under the ``tpu_serve_`` prefix and the
``vllm_*`` aliases, which the OTEL collector scrapes from ``/metrics`` on the
serving port and whose shapes the observability layer's PromQL cookbook
queries.

Both exposition formats are supported from the same registries: classic
Prometheus text (``text/plain; version=0.0.4``, the default) and OpenMetrics
(``application/openmetrics-text``) when the scraper's Accept header asks for
it. OpenMetrics mode adds exemplars to histogram *bucket* lines only — the
``# {trace_id="..."} v`` tail that links a latency bucket to its trace. The
route handler appends the single ``# EOF`` terminator after concatenating
every registry; ``render()`` never writes it so registries stay composable.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

_LabelKey = Tuple[Tuple[str, str], ...]


class Counter:
    def __init__(self, name: str, help_: str, labelnames: Sequence[str] = ()):
        self.name, self.help = name, help_
        self.labelnames = tuple(labelnames)
        self._values: Dict[_LabelKey, float] = {}
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0, **labels):
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def total(self) -> float:
        """Sum over all label combinations (bench/test introspection)."""
        with self._lock:
            return sum(self._values.values())

    def value(self, **labels) -> float:
        """One label combination's count (/healthz tier splits, tests)."""
        key = tuple(sorted(labels.items()))
        with self._lock:
            return self._values.get(key, 0.0)

    def collect(self, openmetrics: bool = False) -> List[str]:
        # OpenMetrics names the counter FAMILY without the _total suffix
        # (samples keep it); classic text uses the full name everywhere.
        fam = self.name
        if openmetrics and fam.endswith("_total"):
            fam = fam[:-len("_total")]
        out = [f"# HELP {fam} {self.help}", f"# TYPE {fam} counter"]
        for key, val in sorted(self._values.items()):
            out.append(f"{self.name}{_fmt_labels(key)} {val}")
        if not self._values:
            out.append(f"{self.name} 0")
        return out


class Gauge:
    """Gauge, optionally labeled (e.g. tpu_serve_slo_burn_rate{objective,
    window}). The unlabeled form keeps the original single-value behavior:
    it always renders exactly one sample, 0.0 until the first set()."""

    def __init__(self, name: str, help_: str, labelnames: Sequence[str] = ()):
        self.name, self.help = name, help_
        self.labelnames = tuple(labelnames)
        self._values: Dict[_LabelKey, float] = {}
        self._lock = threading.Lock()

    def set(self, v: float, **labels):
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = float(v)

    def add(self, v: float, **labels):
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + v

    def value(self, **labels) -> float:
        """Current value (admission-control wait estimation, tests)."""
        key = tuple(sorted(labels.items()))
        with self._lock:
            return self._values.get(key, 0.0)

    def collect(self, openmetrics: bool = False) -> List[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} gauge"]
        with self._lock:
            for key, val in sorted(self._values.items()):
                out.append(f"{self.name}{_fmt_labels(key)} {val}")
            if not self._values:
                out.append(f"{self.name} 0.0")
        return out


class Histogram:
    """Prometheus histogram with explicit buckets (for request/TTFT latency)."""

    DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                       10.0, 30.0, 60.0)

    def __init__(self, name: str, help_: str,
                 buckets: Optional[Sequence[float]] = None):
        self.name, self.help = name, help_
        self.buckets = tuple(buckets or self.DEFAULT_BUCKETS)
        self._counts = [0] * (len(self.buckets) + 1)
        # last exemplar per bucket (incl +Inf): (trace_id, observed value).
        # One slot per bucket — "most recent wins", the standard client
        # behavior; rendered only in OpenMetrics mode, on bucket lines only.
        self._exemplars: List[Optional[Tuple[str, float]]] = \
            [None] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._total = 0
        self._lock = threading.Lock()

    def observe(self, v: float, trace_id: Optional[str] = None):
        with self._lock:
            self._sum += v
            self._total += 1
            placed = False
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self._counts[i] += 1
                    if trace_id and not placed:
                        # exemplar lives on the LOWEST bucket containing
                        # the observation (where it "falls")
                        self._exemplars[i] = (str(trace_id), v)
                        placed = True
            self._counts[-1] += 1  # +Inf
            if trace_id and not placed:
                self._exemplars[-1] = (str(trace_id), v)

    def _exemplar_tail(self, i: int, openmetrics: bool) -> str:
        ex = self._exemplars[i]
        if not openmetrics or ex is None:
            return ""
        tid, v = ex
        return f' # {{trace_id="{_escape_label_value(tid)}"}} {v}'

    def collect(self, openmetrics: bool = False) -> List[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
        for i, b in enumerate(self.buckets):
            out.append(f'{self.name}_bucket{{le="{b}"}} {self._counts[i]}'
                       + self._exemplar_tail(i, openmetrics))
        out.append(f'{self.name}_bucket{{le="+Inf"}} {self._counts[-1]}'
                   + self._exemplar_tail(len(self.buckets), openmetrics))
        out.append(f"{self.name}_sum {self._sum}")
        out.append(f"{self.name}_count {self._total}")
        return out


def _escape_label_value(v) -> str:
    """Exposition-format label-value escaping (shared by both formats):
    backslash, double-quote, and line-feed must be escaped or a crafted
    value (a model name, a trace id) corrupts the whole scrape."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(key: _LabelKey) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in key)
    return "{" + inner + "}"


class Registry:
    def __init__(self):
        self._metrics: List = []
        self._lock = threading.Lock()

    def register(self, m):
        with self._lock:
            self._metrics.append(m)
        return m

    def render(self, openmetrics: bool = False) -> str:
        lines: List[str] = []
        with self._lock:
            for m in self._metrics:
                lines.extend(m.collect(openmetrics))
        return "\n".join(lines) + "\n"


class EngineMetrics:
    """The engine's metric set; names mirror the vLLM ones the collector
    scrapes."""

    def __init__(self):
        self.registry = Registry()
        r = self.registry
        self.request_total = r.register(Counter(
            "tpu_serve_request_total", "Total requests", ("status",)))
        # vllm-compatible alias so that the PromQL cookbook of the
        # observability layer works unchanged
        self.vllm_request_total = r.register(Counter(
            "vllm_request_total", "Total requests (vllm-compatible alias)",
            ("status",)))
        self.active_requests = r.register(Gauge(
            "tpu_serve_active_requests", "Requests currently in decode slots"))
        self.queue_depth = r.register(Gauge(
            "tpu_serve_queue_depth", "Requests waiting for a slot"))
        self.generated_tokens = r.register(Counter(
            "tpu_serve_generated_tokens_total", "Generated tokens"))
        self.prompt_tokens = r.register(Counter(
            "tpu_serve_prompt_tokens_total", "Prompt tokens prefilled"))
        self.request_duration = r.register(Histogram(
            "tpu_serve_request_duration_seconds", "End-to-end request latency"))
        self.vllm_request_duration = r.register(Histogram(
            "vllm_request_duration_seconds",
            "End-to-end request latency (vllm-compatible alias)"))
        self.ttft = r.register(Histogram(
            "tpu_serve_time_to_first_token_seconds", "Time to first token"))
        self.decode_step_duration = r.register(Histogram(
            "tpu_serve_decode_step_seconds",
            "Per-token decode DEVICE time over all slots (device window / "
            "horizon; wall time includes pipeline overlap and host bubble)",
            buckets=(.001, .0025, .005, .01, .025, .05, .1, .25, .5, 1., 2.5)))
        self.tokens_per_second = r.register(Gauge(
            "tpu_serve_tokens_per_second", "Recent decode throughput"))
        # Decode pipeline: bubble = device idle between a
        # dispatch completing with nothing enqueued behind it and the next
        # enqueue (host emit/SSE/scheduling time). Synchronous mode pays it
        # every dispatch; the one-deep pipeline hides it behind device
        # compute, so bubble-rate ~0 is the success signal.
        self.decode_bubble_seconds = r.register(Counter(
            "tpu_serve_decode_bubble_seconds_total",
            "Device idle seconds between decode dispatches (host bubble)"))
        self.pipeline_depth = r.register(Gauge(
            "tpu_serve_pipeline_depth",
            "Decode dispatches currently in flight past the fetched one "
            "(1 = pipelined steady state, 0 = synchronous/drained)"))
        # Wall time spent inside device dispatches (prefill + decode). The
        # node metrics exporter scrapes this across the process boundary and
        # derives tpu_duty_cycle_percent from its rate — the engine process
        # owns the devices, so only it can measure busy time.
        self.device_busy_seconds = r.register(Counter(
            "tpu_serve_device_busy_seconds_total",
            "Seconds spent in device dispatches (duty-cycle source)"))
        self.prefix_cache_hits = r.register(Counter(
            "tpu_serve_prefix_cache_hits_total",
            "Requests that reused a cached prompt prefix"))
        self.prefix_tokens_reused = r.register(Counter(
            "tpu_serve_prefix_tokens_reused_total",
            "Prompt tokens served from the prefix cache instead of prefill"))
        self.spec_drafted_tokens = r.register(Counter(
            "tpu_serve_spec_drafted_tokens_total",
            "Draft tokens proposed (prompt-lookup or draft-model)"))
        self.spec_accepted_tokens = r.register(Counter(
            "tpu_serve_spec_accepted_tokens_total",
            "Draft tokens accepted by the verify pass"))
        self.spec_acceptance_rate = r.register(Gauge(
            "tpu_serve_spec_acceptance_rate",
            "Cumulative accepted/drafted ratio of speculative decoding"))
        # Paged-KV pool health (vLLM publishes the same trio as
        # vllm:num_preemptions/gpu_cache_usage_perc): preemption spikes or a
        # pinned-high page gauge mean the pool is undersized for the load.
        self.preemptions = r.register(Counter(
            "tpu_serve_preemptions_total",
            "Requests preempted (pages reclaimed; resumed by recompute)"))
        self.kv_pages_total = r.register(Gauge(
            "tpu_serve_kv_pages_total", "Physical KV pages in the pool"))
        self.kv_pages_in_use = r.register(Gauge(
            "tpu_serve_kv_pages_in_use",
            "KV pages currently referenced by live requests"))
        # Free/evictable split: "pool full" and "pool
        # full of reusable prefixes" are different capacity situations —
        # evictable pages reclaim on demand but still serve prefix hits.
        self.kv_pages_free = r.register(Gauge(
            "tpu_serve_kv_pages_free",
            "KV pages on the free list (content meaningless)"))
        self.kv_pages_evictable = r.register(Gauge(
            "tpu_serve_kv_pages_evictable",
            "Refcount-zero KV pages retained for prefix reuse "
            "(reclaimable on demand)"))
        # Tier-2 KV (the host-RAM prefix-page store): where each
        # admission's prefix lookup resolved, and the PCIe traffic the tier
        # moves. restore_bytes replaces re-prefill FLOPs; dropped counts
        # corrupted/truncated entries that fell back to re-prefill.
        self.prefix_tier_hits = r.register(Counter(
            "tpu_serve_prefix_tier_hits_total",
            "Paged admissions by prefix-lookup outcome tier",
            ("tier",)))
        self.kv_spill_bytes = r.register(Counter(
            "tpu_serve_kv_spill_bytes_total",
            "KV bytes spilled from reclaimed HBM pages to the host tier"))
        self.kv_restore_bytes = r.register(Counter(
            "tpu_serve_kv_restore_bytes_total",
            "KV bytes restored from the host tier instead of re-prefilled"))
        self.kv_restore_dropped = r.register(Counter(
            "tpu_serve_kv_restore_dropped_total",
            "Host-tier entries dropped at restore (corrupt/truncated/raced "
            "away; the span re-prefilled instead)"))
        self.kv_host_tier_used_bytes = r.register(Gauge(
            "tpu_serve_kv_host_tier_used_bytes",
            "Bytes of spilled KV pages resident in the host tier"))
        self.kv_host_tier_entries = r.register(Gauge(
            "tpu_serve_kv_host_tier_entries",
            "Spilled KV pages resident in the host tier"))
        # Batch-block size the decode kernels run with (slots per CTA of
        # the dense decode kernel; 1 on the paged engine).
        self.decode_bblock = r.register(Gauge(
            "tpu_serve_decode_bblock",
            "Decode kernel batch-block size (slots per grid step)"))
        # Cold-start observability: Engine.warmup's wall time, and the
        # total of the memory-fit manifest the engine adopted
        # (serving/aot.py; 0 without one).
        self.compile_seconds = r.register(Counter(
            "tpu_serve_compile_seconds_total",
            "Wall seconds spent compiling programs at warmup"))
        self.hbm_compiled_bytes = r.register(Gauge(
            "tpu_serve_hbm_compiled_bytes",
            "Per-chip HBM bytes the AOT manifest ledger accounts "
            "(params + KV pool + max program temp)"))
        # Robustness layer: overload shedding, end-to-end deadlines,
        # and the stall watchdog each get an explicit first-class signal —
        # a dashboard must distinguish "we refused work by design" from
        # "work failed".
        self.requests_shed = r.register(Counter(
            "tpu_serve_requests_shed_total",
            "Requests rejected at admission (429), by reason",
            ("reason",)))
        self.deadline_expired = r.register(Counter(
            "tpu_serve_deadline_expired_total",
            "Requests cancelled because their end-to-end deadline passed"))
        self.watchdog_stalls = r.register(Counter(
            "tpu_serve_watchdog_stalls_total",
            "Stalled decode steps the watchdog aborted (requests failed, "
            "process kept alive)"))
        self.admission_preemptions = r.register(Counter(
            "tpu_serve_admission_preemptions_total",
            "Lowest-progress requests preempted to unwedge page-starved "
            "admission"))
        # Replica lifecycle: 1 while the engine is draining (rejecting
        # new admissions, finishing in-flight work) — the readiness signal
        # /readyz and the router's /load poller key off the same state.
        self.draining = r.register(Gauge(
            "tpu_serve_draining",
            "1 while the engine is draining (new admissions shed with "
            "reason=draining)"))

    def mark_request(self, status: str, duration_s: float,
                     trace_id: Optional[str] = None):
        self.request_total.inc(status=status)
        self.vllm_request_total.inc(status=status)
        self.request_duration.observe(duration_s, trace_id=trace_id)
        self.vllm_request_duration.observe(duration_s, trace_id=trace_id)
        # every terminal edge funnels through here: the SLO burn-rate
        # engine's feed (serving/slo.py; imported here, as slo's module
        # imports this one)
        from aws_k8s_ansible_provisioner_tpu_torch.serving import slo as _slo

        _slo.get().observe_request(status, duration_s)


class PipelineMetrics:
    """Process-wide decode-pipeline health counters, shared by every engine
    in the process and rendered by the server's ``/metrics`` route (the
    module-level :data:`pipeline`).

    The decode pipeline's whole value is staying ON under mixed traffic:
    every drain discharges the in-flight dispatch early and the
    next decode pays the full host bubble again. This counter makes the
    ragged-attention win — mixed prefill+decode steps riding the pipeline
    instead of killing it — measurable in production, by reason (the port
    counts the same reasons in ``Engine.counts["pipeline_drains_<reason>"]``):

    - ``prefill``: a prefill admission / activation invalidated the carry
      (the legacy per-admission drain the ragged path removes);
    - ``chunk``:   a chunked-prefill walk forced the synchronous branch;
    - ``spec``:    speculative decode needed current host mirrors;
    - ``drain``:   engine drain / idle settle (intentional, not a loss);
    - ``fail``:    a failed fetch discarded the in-flight dispatch.
    """

    def __init__(self):
        self.registry = Registry()
        r = self.registry
        self.drains = r.register(Counter(
            "tpu_serve_pipeline_drains_total",
            "Decode-pipeline drains (in-flight dispatch discharged early), "
            "by reason",
            ("reason",)))
        self.dispatches = r.register(Counter(
            "tpu_serve_pipeline_dispatches_total",
            "Decode/mixed dispatches enqueued (drain-rate denominator)"))

    def snapshot(self) -> dict:
        """Drain totals by reason + the drain rate (drains per dispatch) for
        dashboards — the one number that says whether the pipeline
        is actually staying open under the current traffic mix."""
        with self.drains._lock:
            by_reason = {(dict(key).get("reason") or "other"): int(val)
                         for key, val in self.drains._values.items()}
        total = sum(by_reason.values())
        dispatched = self.dispatches.total()
        return {
            "drains_total": total,
            "drains_by_reason": by_reason,
            "dispatches_total": int(dispatched),
            "drain_rate": round(total / dispatched, 4) if dispatched else 0.0,
        }


pipeline = PipelineMetrics()
