"""Device telemetry & roofline attribution — the DCGM-analogue layer.

A copy of the JAX package's ``serving/devmon.py`` (the port imports nothing
of that package), with the H100's peaks as defaults and the cost model's
MLP term counting the parameters a token touches (ROADMAP C28). The
reference stack deploys a DCGM exporter so Prometheus sees the *device*
(utilization, memory, clocks) beside the serving metrics; this module turns
the device seconds the engine measures for each dispatch (CUDA events on a
card, host time on the CPU; ``serving/engine.py``) into:

1. **Per-program roofline attribution.** Every dispatch reports
   ``(program_kind, batch, tokens, mean_ctx, device_seconds)`` into windowed
   accumulators. An analytical FLOP/byte cost model (weights + KV bytes per
   step, derived from ModelConfig — a roofline model, falsifiable in
   production) converts the window sums into ``tpu_device_mfu{program}``,
   ``tpu_device_membw_util{program}``, ``tpu_device_duty_cycle`` and
   ``tpu_device_dma_wait_fraction`` (measured step time vs the
   roofline-predicted floor: max(flops/peak_flops, bytes/peak_bw)).

2. **Live HBM ledger.** Actual occupancy by component (params, KV pages in
   use, sampler carry, cached sampling operands, …) sampled from host-side
   metadata — never a device read — rendered as
   ``tpu_device_hbm_live_bytes{component}`` and reconciled against the AOT
   manifest's compiled ledger: ``tpu_device_hbm_drift_bytes`` plus a
   warn-never-kill verdict for /healthz.

Recording follows the flight-recorder contract: ``note()`` is a handful of
float ops and a deque append under a lock — it can never block, fail, or
perturb a request (seeded streams are byte-identical with devmon on or
off). All six gauges are written from exactly ONE site, ``DevMon.export()``,
and every timestamp comes through an injectable monotonic
clock (slo.py discipline) so the /debug/roofline table is exact-arithmetic
testable under a fake clock.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, Dict, Optional, Tuple

from aws_k8s_ansible_provisioner_tpu_torch.serving.metrics import (
    Gauge, Registry)
from aws_k8s_ansible_provisioner_tpu_torch.serving.slo import trim_window

# Attribution window (seconds). One window: the dashboard question is "what
# is the device doing NOW", not SLO burn over an hour — slo.py owns that.
WINDOW_S = 60.0

# H100 SXM defaults: dense bf16 peak and HBM3 bandwidth per card (the
# constructor and the server's flags take other values).
DEFAULT_PEAK_TFLOPS = 989.0
DEFAULT_HBM_GBPS = 3350.0
DEFAULT_HBM_TOLERANCE_MB = 64.0

# Program kinds the engine reports — the label set is closed so the gauge
# cardinality is bounded no matter what traffic does.
PROGRAM_KINDS = ("prefill", "prefill_batch", "prefill_chunk", "prefix_copy",
                 "kv_restore", "decode", "spec_decode", "mixed_step")


class DevMonMetrics:
    """The tpu_device_* family. Registered here, rendered by BOTH /metrics
    routes, written only by DevMon.export()."""

    def __init__(self):
        r = Registry()
        self.registry = r
        self.mfu = r.register(Gauge(
            "tpu_device_mfu",
            "Model FLOP utilization per program over the attribution "
            "window (analytical flops / measured device seconds / peak)"))
        self.membw_util = r.register(Gauge(
            "tpu_device_membw_util",
            "HBM bandwidth utilization per program over the attribution "
            "window (analytical bytes moved / measured device seconds / "
            "peak bandwidth)"))
        self.duty_cycle = r.register(Gauge(
            "tpu_device_duty_cycle",
            "Fraction of the attribution window the device spent inside "
            "dispatched programs (busy-watermark seconds / window)"))
        self.dma_wait_fraction = r.register(Gauge(
            "tpu_device_dma_wait_fraction",
            "Fraction of measured device time above the roofline-predicted "
            "compute/bandwidth floor — the DMA-wait + dispatch-gap residue "
            "the PERF.md double-buffer model predicts"))
        self.hbm_live_bytes = r.register(Gauge(
            "tpu_device_hbm_live_bytes",
            "Live HBM occupancy by component, from host-side metadata "
            "(params, KV pages in use, sampler carry, cached operands)"))
        self.hbm_drift_bytes = r.register(Gauge(
            "tpu_device_hbm_drift_bytes",
            "Live HBM total minus the AOT manifest's compiled ledger "
            "(0 when no manifest is loaded; positive = the ledger "
            "under-promised)"))


metrics = DevMonMetrics()


@dataclass(frozen=True)
class CostModel:
    """Analytical per-dispatch FLOP/byte model (a roofline).

    ``flops_per_token``  — 2 x matmul params touched per generated/prefilled
                           token (attention score flops excluded, standard
                           weight-MFU accounting).
    ``weight_bytes``     — bytes streamed from HBM for one full forward
                           step, amortized over the whole batch.
    ``kv_row_bytes``     — k+v bytes for ONE token of context across all
                           layers/heads (int8 rows include their f32 scale,
                           mirroring kv_cache.py's accounting).
    ``mask_row_bytes``   — bytes of ONE row of the guided-decoding allow
                           bitset (ceil(V/32) uint32 words): the per-step
                           host→HBM upload a guided row adds when it rides
                           the ragged pipeline. Tiny next to
                           weights — the point of attributing it is proving
                           that, not worrying about it.
    """

    flops_per_token: float
    weight_bytes: float
    kv_row_bytes: float
    mask_row_bytes: float = 0.0

    @staticmethod
    def from_config(cfg, kv_dtype: str = "bf16",
                    weight_bytes: Optional[float] = None) -> "CostModel":
        """Derive the model from a ModelConfig (+ the serving kv dtype).

        The MLP term counts the matrices a token runs through: the gate, up
        and down projections of a gated MLP, the two of a plain one (OPT,
        phi), and for a MoE layer the router plus the gate, up and down
        projections of its ``num_experts_per_tok`` experts of width
        ``moe_intermediate_size``. The JAX model counts three matrices of
        ``intermediate_size`` for every layer (ROADMAP C28); the two agree
        on the gated dense configs. Biases and norms are left out (< 1 %)."""
        h = cfg.hidden_size
        q_dim = cfg.num_heads * cfg.head_dim
        kv_dim = cfg.num_kv_heads * cfg.head_dim
        attn = h * q_dim + 2 * h * kv_dim + q_dim * h
        if cfg.num_experts > 0:
            mlp = h * cfg.num_experts + cfg.num_experts_per_tok * 3 * h \
                * cfg.moe_intermediate_size
        else:
            mlp = (3 if cfg.gated_mlp else 2) * h * cfg.intermediate_size
        matmul_params = cfg.num_layers * (attn + mlp) + cfg.vocab_size * h
        if weight_bytes is None:
            # embedding table streams too; bf16 resident weights
            weight_bytes = float(matmul_params + cfg.vocab_size * h) * 2.0
        if kv_dtype == "int8":
            per_head_row = cfg.head_dim * 1 + 4   # int8 row + f32 scale
        else:
            per_head_row = cfg.head_dim * 2       # bf16
        kv_row = cfg.num_layers * 2 * cfg.num_kv_heads * per_head_row
        mask_row = float(-(-cfg.vocab_size // 32) * 4)   # ceil(V/32) u32 words
        return CostModel(flops_per_token=2.0 * matmul_params,
                         weight_bytes=float(weight_bytes),
                         kv_row_bytes=float(kv_row),
                         mask_row_bytes=mask_row)

    def cost(self, kind: str, batch: int, tokens: int, ctx_rows: float,
             steps: int, guided_rows: int = 0) -> Tuple[float, float]:
        """(flops, hbm_bytes) for one dispatch.

        decode-like: weights stream once per STEP (shared by the batch);
        each generated token reads its whole context's KV rows.
        prefill-like: weights stream once; each prompt token writes its KV
        row (attention reads ride the same rows and stay sub-dominant).
        prefix_copy: pure DMA — read + write of the copied rows, zero flops.
        kv_restore: host-tier restore — one HBM write per
        restored KV row, zero flops. Its bandwidth-sense MFU column is the
        restore-vs-reprefill ledger: the same tokens through a prefill kind
        would have cost flops_per_token * tokens of tensor-core work.
        """
        if kind == "prefix_copy":
            return 0.0, 2.0 * tokens * self.kv_row_bytes
        if kind == "kv_restore":
            return 0.0, float(tokens) * self.kv_row_bytes
        flops = self.flops_per_token * tokens
        # Guided rows upload one allow-bitset row per step; pure extra HBM
        # traffic, zero flops.
        mask = guided_rows * steps * self.mask_row_bytes
        if kind == "mixed_step":
            # ragged mixed batch: weights stream once for BOTH the decode
            # rows and the packed prefill chunk (the fusion's bandwidth
            # win); decode rows read their context, chunk rows write theirs
            return flops, (self.weight_bytes
                           + tokens * ctx_rows * self.kv_row_bytes + mask)
        if kind in ("decode", "spec_decode"):
            byts = steps * self.weight_bytes \
                + tokens * ctx_rows * self.kv_row_bytes + mask
        else:
            byts = steps * self.weight_bytes + tokens * self.kv_row_bytes \
                + mask
        return flops, byts


class DevMon:
    """Windowed per-program attribution + live HBM ledger.

    ``clock`` is injectable (tests drive a fake); every public method takes
    the lock, so engine-thread notes and HTTP-thread exports never race.
    """

    def __init__(self, enabled: bool = True,
                 peak_tflops: float = DEFAULT_PEAK_TFLOPS,
                 hbm_gbps: float = DEFAULT_HBM_GBPS,
                 hbm_tolerance_mb: float = DEFAULT_HBM_TOLERANCE_MB,
                 window_s: float = WINDOW_S,
                 clock: Callable[[], float] = time.monotonic):
        self.enabled = enabled
        self.peak_flops = max(1.0, peak_tflops) * 1e12
        self.peak_bw = max(1.0, hbm_gbps) * 1e9
        self.hbm_tolerance_bytes = max(0.0, hbm_tolerance_mb) * 1e6
        self.window_s = window_s
        self.clock = clock
        self._lock = threading.Lock()
        self._t0 = clock()
        # kind -> deque of (t, device_s, flops, bytes, tokens, steps)
        self._acc: Dict[str, Deque[tuple]] = {
            k: deque(maxlen=100_000) for k in PROGRAM_KINDS}
        self.cost_model: Optional[CostModel] = None
        # () -> {component: bytes} from host metadata; () -> compiled bytes
        self._hbm_live_fn: Optional[Callable[[], Dict[str, float]]] = None
        self._hbm_compiled_fn: Optional[Callable[[], float]] = None

    # -- wiring -------------------------------------------------------------

    def install_cost_model(self, cm: CostModel):
        with self._lock:
            self.cost_model = cm

    def install_hbm(self, live_fn: Callable[[], Dict[str, float]],
                    compiled_fn: Callable[[], float]):
        with self._lock:
            self._hbm_live_fn = live_fn
            self._hbm_compiled_fn = compiled_fn

    # -- recording (engine thread; drop-not-fail, never blocks on device) ---

    def note(self, kind: str, device_s: float, batch: int = 1,
             tokens: int = 1, ctx_rows: float = 0.0, steps: int = 1,
             guided_rows: int = 0):
        """Record one settled dispatch. Called ONLY after the engine has
        already synced the dispatch (the _decode_fetch side of the
        pipeline) — never adds a device read to the dispatch path (R8).
        ``guided_rows`` = decode rows carrying a grammar allow-mask operand
        (each adds one mask_row_bytes upload per step to the byte model)."""
        if not self.enabled or kind not in self._acc:
            return
        cm = self.cost_model
        if cm is None:
            flops, byts = 0.0, 0.0
        else:
            flops, byts = cm.cost(kind, batch, tokens, ctx_rows, steps,
                                  guided_rows=guided_rows)
        now = self.clock()
        with self._lock:
            dq = self._acc[kind]
            dq.append((now, device_s, flops, byts, tokens, steps))
            trim_window(dq, now, self.window_s)

    # -- queries ------------------------------------------------------------

    def program_stats(self, now: Optional[float] = None) -> Dict[str, dict]:
        """Per-program window aggregates: measured s/step, roofline floor,
        MFU, bandwidth utilization, dma-wait fraction."""
        now = self.clock() if now is None else now
        out: Dict[str, dict] = {}
        with self._lock:
            for kind, dq in self._acc.items():
                trim_window(dq, now, self.window_s)
                if not dq:
                    continue
                dev = sum(e[1] for e in dq)
                flops = sum(e[2] for e in dq)
                byts = sum(e[3] for e in dq)
                toks = sum(e[4] for e in dq)
                steps = sum(e[5] for e in dq)
                floor = max(flops / self.peak_flops, byts / self.peak_bw)
                dev_safe = max(dev, 1e-12)
                out[kind] = {
                    "dispatches": len(dq),
                    "device_seconds": dev,
                    "tokens": toks,
                    "measured_s_per_step": dev / max(1, steps),
                    "predicted_floor_s_per_step": floor / max(1, steps),
                    "mfu": flops / (dev_safe * self.peak_flops),
                    "membw_util": byts / (dev_safe * self.peak_bw),
                    "dma_wait_fraction": max(0.0, dev - floor) / dev_safe,
                }
        return out

    def duty_cycle(self, now: Optional[float] = None) -> float:
        now = self.clock() if now is None else now
        elapsed = min(self.window_s, max(now - self._t0, 1e-9))
        with self._lock:
            busy = sum(e[1] for dq in self._acc.values() for e in dq
                       if e[0] >= now - self.window_s)
        return min(1.0, busy / elapsed)

    def service_rates(self, now: Optional[float] = None) -> dict:
        """Decode-side service capacity over the window, aggregated across
        the decode-like programs — the measurement serving/capacity.py
        blends into its ceiling. ``measured_tps`` divides real device
        seconds (already degraded by DMA-wait); ``roofline_tps`` divides
        the analytical floor (what the card could do at the roofline; equal
        to measured when no cost model is installed, i.e. floor unknown)."""
        now = self.clock() if now is None else now
        progs = self.program_stats(now)
        toks = dev = floor = 0.0
        for kind in ("decode", "spec_decode"):
            p = progs.get(kind)
            if not p:
                continue
            toks += p["tokens"]
            dev += p["device_seconds"]
            floor += p["device_seconds"] * (1.0 - p["dma_wait_fraction"])
        measured = (toks / dev) if dev > 0.0 else 0.0
        roofline = (toks / floor) if floor > 0.0 else measured
        return {"tokens": toks, "device_seconds": dev,
                "measured_tps": measured, "roofline_tps": roofline,
                "dma_wait_fraction": ((dev - floor) / dev) if dev > 0.0
                else 0.0,
                "duty_cycle": self.duty_cycle(now)}

    def hbm_snapshot(self) -> dict:
        """Live component map + drift vs the AOT compiled ledger. Verdict
        warns (never kills) when live exceeds compiled + tolerance."""
        with self._lock:
            live_fn, compiled_fn = self._hbm_live_fn, self._hbm_compiled_fn
        components: Dict[str, float] = {}
        if live_fn is not None:
            try:
                components = {k: float(v) for k, v in live_fn().items()}
            except Exception:
                components = {}
        live = sum(components.values())
        compiled = 0.0
        if compiled_fn is not None:
            try:
                compiled = float(compiled_fn() or 0.0)
            except Exception:
                compiled = 0.0
        drift = (live - compiled) if compiled > 0.0 else 0.0
        verdict = "warn" if (compiled > 0.0
                             and live > compiled
                             + self.hbm_tolerance_bytes) else "ok"
        return {"components": components, "live_bytes": live,
                "compiled_bytes": compiled, "drift_bytes": drift,
                "tolerance_bytes": self.hbm_tolerance_bytes,
                "verdict": verdict}

    def snapshot(self, now: Optional[float] = None) -> dict:
        """The /debug/roofline payload (also embedded in /healthz)."""
        now = self.clock() if now is None else now
        progs = self.program_stats(now)
        dev = sum(p["device_seconds"] for p in progs.values())
        excess = sum(p["dma_wait_fraction"] * p["device_seconds"]
                     for p in progs.values())
        return {
            "enabled": self.enabled,
            "window_s": self.window_s,
            "peak_tflops": self.peak_flops / 1e12,
            "peak_hbm_gbps": self.peak_bw / 1e9,
            "duty_cycle": self.duty_cycle(now),
            "dma_wait_fraction": (excess / dev) if dev > 0 else 0.0,
            "programs": progs,
            "hbm": self.hbm_snapshot(),
        }

    def export(self):
        """Refresh every tpu_device_* gauge from the current window — the
        single writer site for the family. Routes call this
        right before rendering, the slo.py pattern."""
        snap = self.snapshot()
        for kind, p in snap["programs"].items():
            metrics.mfu.set(p["mfu"], program=kind)
            metrics.membw_util.set(p["membw_util"], program=kind)
        metrics.duty_cycle.set(snap["duty_cycle"])
        metrics.dma_wait_fraction.set(snap["dma_wait_fraction"])
        for comp, b in snap["hbm"]["components"].items():
            metrics.hbm_live_bytes.set(b, component=comp)
        metrics.hbm_drift_bytes.set(snap["hbm"]["drift_bytes"])
        return snap


_monitor: Optional[DevMon] = None
_monitor_lock = threading.Lock()


def get() -> DevMon:
    global _monitor
    with _monitor_lock:
        if _monitor is None:
            _monitor = DevMon()
        return _monitor


def configure(**kw) -> DevMon:
    """Swap in a freshly-configured monitor, carrying over the engine wiring
    (cost model + HBM samplers) the previous instance held — build_state
    configures AFTER the engine attaches."""
    global _monitor
    with _monitor_lock:
        old = _monitor
        _monitor = DevMon(**kw)
        if old is not None:
            if old.cost_model is not None and _monitor.cost_model is None:
                _monitor.cost_model = old.cost_model
            if old._hbm_live_fn is not None:
                _monitor._hbm_live_fn = old._hbm_live_fn
                _monitor._hbm_compiled_fn = old._hbm_compiled_fn
        return _monitor


def reset() -> DevMon:
    global _monitor
    with _monitor_lock:
        _monitor = DevMon()
        return _monitor


def note(kind: str, device_s: float, **kw):
    """Module shorthand for the engine's hot path (flightrec.record style)."""
    get().note(kind, device_s, **kw)
