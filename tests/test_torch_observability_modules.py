"""The port's copies of the JAX package's jax-free observability modules
(``serving/{chaos,tracing,flightrec,slo,devmon,capacity}.py``) against the
originals: one scripted sequence per module goes through the JAX module and
the port's copy under the same fake clock and seed, and their snapshots and
``registry.render()`` text must be equal byte for byte. Each module's
process-wide metric set is swapped for a fresh one on both sides, so that
the renders hold this script's counts alone.

The copies differ from the originals in two places, pinned here: devmon's
peak defaults are the H100's, and its cost model counts the parameters a
token touches (a MoE layer's router and top-k experts, a plain MLP's two
matrices), where the JAX model counts three ``intermediate_size`` matrices
in every layer (ROADMAP C28).
"""

import dataclasses
import json
import os
import types

import pytest

from aws_k8s_ansible_provisioner_tpu import config as jconfig
from aws_k8s_ansible_provisioner_tpu.serving import capacity as jcapacity
from aws_k8s_ansible_provisioner_tpu.serving import chaos as jchaos
from aws_k8s_ansible_provisioner_tpu.serving import devmon as jdevmon
from aws_k8s_ansible_provisioner_tpu.serving import flightrec as jflight
from aws_k8s_ansible_provisioner_tpu.serving import slo as jslo
from aws_k8s_ansible_provisioner_tpu.serving import tracing as jtracing
from aws_k8s_ansible_provisioner_tpu_torch import config as tconfig
from aws_k8s_ansible_provisioner_tpu_torch.serving import capacity as tcapacity
from aws_k8s_ansible_provisioner_tpu_torch.serving import chaos as tchaos
from aws_k8s_ansible_provisioner_tpu_torch.serving import devmon as tdevmon
from aws_k8s_ansible_provisioner_tpu_torch.serving import flightrec as tflight
from aws_k8s_ansible_provisioner_tpu_torch.serving import slo as tslo
from aws_k8s_ansible_provisioner_tpu_torch.serving import tracing as ttracing

JAX = types.SimpleNamespace(chaos=jchaos, tracing=jtracing, flightrec=jflight,
                            slo=jslo, devmon=jdevmon, capacity=jcapacity)
PORT = types.SimpleNamespace(chaos=tchaos, tracing=ttracing,
                             flightrec=tflight, slo=tslo, devmon=tdevmon,
                             capacity=tcapacity)

# one fixed unix-nano reference for both tracing modules (their own is the
# import time of each), so that mono_ns and the dumps' stamps agree
WALL_NS = 1_700_000_000_000_000_000


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    """Fresh metric sets and chaos controllers on both sides, one reference
    clock pair for both tracing modules, no chaos armed afterwards."""
    for pkg in (JAX, PORT):
        monkeypatch.setattr(pkg.tracing, "metrics", pkg.tracing.TraceMetrics())
        monkeypatch.setattr(pkg.flightrec, "metrics",
                            pkg.flightrec.FlightMetrics())
        monkeypatch.setattr(pkg.slo, "metrics", pkg.slo.SLOMetrics())
        monkeypatch.setattr(pkg.devmon, "metrics",
                            pkg.devmon.DevMonMetrics())
        monkeypatch.setattr(pkg.capacity, "metrics",
                            pkg.capacity.CapacityMetrics())
        monkeypatch.setattr(pkg.tracing, "_MONO_REF", 0.0)
        monkeypatch.setattr(pkg.tracing, "_WALL_REF_NS", WALL_NS)
        monkeypatch.setattr(pkg.tracing, "wall_clock_ns", lambda: WALL_NS)
        monkeypatch.delenv("TPU_SERVE_CHAOS", raising=False)
        pkg.chaos.reset()
    yield
    for pkg in (JAX, PORT):
        pkg.chaos.reset()


def _dump(obj) -> str:
    return json.dumps(obj, sort_keys=True, default=str)


# -- the scripts: each drives one package's module and returns its outputs --


def _chaos_script(pkg, tmp_path):
    pkg.flightrec.reset()    # the ring holds this script's events only
    c = pkg.chaos.ChaosController(
        "stalled_decode:duration_s=2,page_exhaustion:times=3:allocs=2,"
        "kill_stream:after_chunks=4:times=-1,span_export:mode=\"5xx\"")
    fires = []
    for fault in ("page_exhaustion", "stalled_decode", "page_exhaustion",
                  "kill_stream", "page_exhaustion", "page_exhaustion",
                  "span_export", "connect_refused", "kill_stream"):
        fires.append([fault, c.fire(fault)])
    c.inject("ragged_feature_error", after=1, times=2, kind="spec")
    fires.append(c.active("ragged_feature_error"))
    fires.extend(c.fire("ragged_feature_error") for _ in range(4))
    try:
        c.inject("no_such_fault")
        refused = None
    except ValueError as e:
        refused = str(e)
    stats = c.stats()
    c.clear("kill_stream")
    return {"fires": fires, "stats": stats, "enabled": c.enabled,
            "after_clear": c.stats(), "refused": refused,
            "faults": list(pkg.chaos.FAULTS),
            "ring": [e["type"] for e in pkg.flightrec.get().tail(64)
                     if e["type"] == "chaos_fault"]}


class _Recorder:
    def __init__(self):
        self.items = []

    def export(self, span, service_name):
        self.items.append((span, service_name))
        return True


def _tracing_script(pkg, tmp_path):
    tr = pkg.tracing
    headers = ["00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
               "00-0AF7651916CD43DD8448EB211C80319C-B7AD6B7169203331-00",
               "ff-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
               "00-" + "0" * 32 + "-b7ad6b7169203331-01", "garbage", None,
               "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331"]
    parsed = []
    for h in headers:
        ctx = tr.parse_traceparent(h)
        parsed.append(None if ctx is None else
                      [ctx.trace_id, ctx.span_id, ctx.sampled,
                       tr.format_traceparent(ctx)])
    rec = _Recorder()
    tracer = tr.Tracer("tpu-serve-engine", exporter=rec, sample=0.5, seed=7)
    root = tracer.start_span("server.request", kind=tr.KIND_SERVER,
                             start_ns=WALL_NS + 10,
                             attributes={"http.route": "/v1/completions",
                                         "request.stream": True,
                                         "n": 3, "ratio": 0.25})
    for i, name in enumerate(("admission", "queue_wait", "prefill")):
        tracer.emit_span(name, root.context, WALL_NS + 10 + i,
                         WALL_NS + 11 + i, attributes={"phase.ms": 1e-6})
    root.error("engine failure")
    tracer.finish(root, end_ns=WALL_NS + 5)        # clamped to its start
    ext = tr.parse_traceparent(headers[0])
    child = tracer.start_span("server.request", parent=ext,
                              start_ns=WALL_NS)
    tracer.finish(child, end_ns=WALL_NS + 100)
    unsampled = [tracer.start_span("x").context.sampled for _ in range(8)]
    # an exporter whose worker has stopped: a queue of 4 takes 4 spans of 10
    # and drops 6 (queue_full), deterministically
    exp = tr.OTLPHTTPExporter("127.0.0.1:9", queue_max=4)
    exp.shutdown(timeout_s=2.0)
    accepted = [exp.export(s, "svc") for s, _ in rec.items * 2]
    return {"parsed": parsed,
            "otlp": tr.encode_spans(rec.items),
            "unsampled": unsampled, "accepted": accepted,
            "endpoint": [exp.host, exp.port, exp.path],
            "render": tr.metrics.registry.render(False),
            "render_om": tr.metrics.registry.render(True)}


def _flightrec_script(pkg, tmp_path, monkeypatch):
    fr = pkg.flightrec
    clock = {"ns": 5_000_000_000}

    def mono_ns():
        clock["ns"] += 1_000_000
        return clock["ns"]

    monkeypatch.setattr(fr, "time", types.SimpleNamespace(
        monotonic_ns=mono_ns, monotonic=pkg.flightrec.time.monotonic,
        sleep=pkg.flightrec.time.sleep))
    spool = tmp_path / "spool"
    rec = fr.FlightRecorder(spool_dir=str(spool), ring_cap=16,
                            max_requests=3, max_events_per_request=4,
                            max_snapshots=2)
    for rid in (1, 2, 3, 4):
        rec.record("queue", rid, n_prompt=rid * 10, max_tokens=8)
        rec.record("trace", rid, trace_id=f"{rid:032x}", span_id=f"{rid:016x}")
    for _ in range(4):
        rec.record("pipeline_dispatch", None, horizon=8, batch=3)
    rec.record("admit", 1, slot=0, resumed=False, queue_wait_s=0.001)
    rec.record("preempt", 1, slot=0, n_generated=3, front=True)
    rec.record("cancel_reap", 1, slot=0)               # timeline overflow
    rec.finish(2, "stop")
    rec.finish(1, "cancelled", ok=False)
    rec.finish(3, "timeout", ok=False, phase="queued")
    rec.finish(5, "shed", ok=False)
    rec.record("drain", None, state="begin", timeout_s=30.0)
    assert rec.flush(10.0)
    out = {"tail": rec.tail(12), "tail_all": rec.tail(100),
           "dump1": rec.dump_for(1), "dump3": rec.dump_for(3),
           "dump5": rec.dump_for(5), "missing": rec.dump_for(2),
           "summary": rec.summary(),
           "spool": (spool / "flight.jsonl").read_text().splitlines(),
           "render": fr.metrics.registry.render(False)}
    rec.shutdown()
    return out


def _slo_script(pkg, tmp_path):
    clock = FakeClock()
    eng = pkg.slo.SLOEngine(ttft_p95_ms=500, e2e_p95_ms=2000, error_rate=0.05,
                            shed_rate=0.1, clock=clock)
    snaps = []
    for i in range(40):
        clock.t += 7.5
        eng.observe_ttft(0.1 if i % 5 else 0.9)
        eng.observe_request("error" if i % 13 == 0 else
                            "cancelled" if i % 11 == 0 else "success",
                            1.0 + (i % 3))
        eng.observe_admission(shed=i % 9 == 0)
        if i % 10 == 9:
            snaps.append(eng.snapshot())
    eng.export()
    out = {"snaps": snaps, "burning": eng.burning(),
           "burning_1h": eng.burning(threshold=0.5, window="1h"),
           "bad_fraction": eng.bad_fraction("shed_rate", 300.0),
           "render": pkg.slo.metrics.registry.render(False)}
    clock.t += 4000.0
    out["idle"] = eng.snapshot()
    out["window"] = [0.0, 1.0]
    q = pkg.slo.collections.deque([(0.0, 1), (1.0, 0), (5.0, 1)])
    pkg.slo.trim_window(q, 6.0, 3.0)
    out["trimmed"] = list(q)
    return out


def _devmon_script(pkg, tmp_path, cfg):
    clock = FakeClock()
    mon = pkg.devmon.DevMon(peak_tflops=197.0, hbm_gbps=819.0,
                            hbm_tolerance_mb=1.0, window_s=60.0, clock=clock)
    cm = pkg.devmon.CostModel.from_config(cfg, kv_dtype="int8",
                                          weight_bytes=123_456_789.0)
    mon.install_cost_model(cm)
    live = {"params": 1.5e8, "kv_pages": 2.5e7, "kv_pages_evictable": 1e6,
            "sampler_carry": 256.0}
    mon.install_hbm(lambda: dict(live), lambda: 1.75e8)
    for i in range(30):
        clock.t += 1.5
        mon.note("decode", 0.004 + 1e-4 * i, batch=8, tokens=64,
                 ctx_rows=300.0 + i, steps=8, guided_rows=i % 2)
        if i % 4 == 0:
            mon.note("mixed_step", 0.006, batch=9, tokens=8 + 256,
                     ctx_rows=200.0, steps=1)
        if i % 7 == 0:
            mon.note("prefill_batch", 0.02, batch=4, tokens=512)
            mon.note("kv_restore", 0.001, tokens=128)
            mon.note("prefix_copy", 0.0005, tokens=64)
            mon.note("spec_decode", 0.008, batch=8, tokens=40,
                     ctx_rows=310.0)
        mon.note("not_a_program", 1.0)
    snap = mon.export()
    out = {"snapshot": snap, "rates": mon.service_rates(),
           "render": pkg.devmon.metrics.registry.render(False)}
    clock.t += 100.0
    out["idle"] = mon.snapshot()
    return out


def _capacity_script(pkg, tmp_path):
    clock = FakeClock()
    est = pkg.capacity.CapacityEstimator(headroom_s=5.5, window_s=60.0,
                                         trend_window_s=300.0, clock=clock)
    depth = {"n": 0}
    est.install_engine(lambda: depth["n"], lambda: 120.0)
    rates = {"measured_tps": 0.0}
    est.install_devmon(lambda: dict(rates))
    snaps = [est.snapshot()]
    for i in range(120):
        clock.t += 2.5
        est.observe_submit(tokens=16 + (i % 5) * 8 + i, shed=i > 90 and
                           i % 3 == 0)
        depth["n"] = i // 10
        if i == 40:
            rates.update(measured_tps=900.0, roofline_tps=4000.0,
                         duty_cycle=0.5)
        if i % 30 == 29:
            snaps.append(est.snapshot())
    snap = est.export()
    out = {"snaps": snaps, "export": snap, "offered": est.offered(),
           "render": pkg.capacity.metrics.registry.render(False)}
    est2 = pkg.capacity.CapacityEstimator(headroom_s=5.5, clock=clock)
    est2.install_devmon(lambda: 1 / 0)                   # a broken source
    out["broken"] = est2.snapshot()
    return out


@pytest.mark.parametrize("module", ["chaos", "tracing", "flightrec", "slo",
                                    "devmon", "capacity"])
def test_module_matches_jax(module, tmp_path, monkeypatch):
    """The same script through the JAX module and the port's copy: the
    same snapshots, dumps and renders, byte for byte (devmon with the same
    peaks given to both and a gated dense config, where the cost models
    agree)."""
    outs = []
    for name, pkg in (("jax", JAX), ("port", PORT)):
        d = tmp_path / name
        d.mkdir()
        if module == "chaos":
            outs.append(_chaos_script(pkg, d))
        elif module == "tracing":
            outs.append(_tracing_script(pkg, d))
        elif module == "flightrec":
            outs.append(_flightrec_script(pkg, d, monkeypatch))
        elif module == "slo":
            outs.append(_slo_script(pkg, d))
        elif module == "devmon":
            cfg = (jconfig if pkg is JAX else tconfig).QWEN3_0_6B
            outs.append(_devmon_script(pkg, d, cfg))
        else:
            outs.append(_capacity_script(pkg, d))
    jax_out, port_out = outs
    if module == "flightrec":
        # the dumps' spool path names the directory of each side
        assert jax_out["spool"] and len(jax_out["spool"]) == 3
    assert _dump(port_out) == _dump(jax_out)
    if "render" in jax_out:
        assert port_out["render"] == jax_out["render"]
        assert port_out["render"].strip()


@pytest.mark.parametrize("name", ["tiny_qwen3", "QWEN3_0_6B", "QWEN3_8B",
                                  "tiny_mistral", "LLAMA_3_2_1B"])
@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
def test_cost_model_from_config_matches_jax(name, kv_dtype):
    """``CostModel.from_config`` on the gated dense configs: the same model
    as the JAX one, with and without the weight bytes given."""
    def cfg(mod):
        c = getattr(mod, name)
        return c() if callable(c) else c

    for wb in (None, 1e9):
        got = tdevmon.CostModel.from_config(cfg(tconfig), kv_dtype=kv_dtype,
                                            weight_bytes=wb)
        want = jdevmon.CostModel.from_config(cfg(jconfig), kv_dtype=kv_dtype,
                                             weight_bytes=wb)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def _active_matmul_params(cfg) -> int:
    """The matmul parameters one token runs through, from the config:
    attention, the MLP it takes (a MoE layer: the router and its top-k
    experts; a plain MLP: two matrices) and the head."""
    h = cfg.hidden_size
    q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    attn = 2 * h * q + 2 * h * kv
    if cfg.num_experts:
        mlp = h * cfg.num_experts + cfg.num_experts_per_tok * 3 * h \
            * cfg.moe_intermediate_size
    else:
        mlp = (3 if cfg.gated_mlp else 2) * h * cfg.intermediate_size
    return cfg.num_layers * (attn + mlp) + cfg.vocab_size * h


@pytest.mark.parametrize("name,jax_over", [
    # Qwen3-30B-A3B: 8 experts of 768 = intermediate_size 6144, so the JAX
    # model misses only the routers ([2048, 128] a layer, 0.41 %)
    ("QWEN3_30B_A3B", 48 * -2048 * 128),
    ("tiny_qwen3_moe", None),
    # phi-2 and OPT: a plain MLP of two matrices, counted as three
    ("PHI_2", 32 * 2560 * 10240),
    ("OPT_1_3B", 24 * 2048 * 8192),
])
def test_c28_cost_model_counts_the_parameters_a_token_touches(name, jax_over):
    """C28: the JAX cost model counts ``3 * hidden * intermediate_size``
    for every layer's MLP, whatever the layer is. The port counts what a
    token runs through: a MoE layer's router and top-k experts of
    ``moe_intermediate_size``, a plain MLP's two matrices. The difference
    is pinned per config (2 flops a parameter)."""
    def cfg(mod):
        c = getattr(mod, name)
        return c() if callable(c) else c

    tcfg = cfg(tconfig)
    port = tdevmon.CostModel.from_config(tcfg, weight_bytes=1.0)
    ref = jdevmon.CostModel.from_config(cfg(jconfig), weight_bytes=1.0)
    assert port.flops_per_token == 2.0 * _active_matmul_params(tcfg)
    diff = (ref.flops_per_token - port.flops_per_token) / 2
    if jax_over is None:
        # the tiny MoE: the JAX model counts intermediate_size, which has
        # nothing to do with the experts the token takes
        h = tcfg.hidden_size
        want = tcfg.num_layers * (
            3 * h * tcfg.intermediate_size - h * tcfg.num_experts
            - tcfg.num_experts_per_tok * 3 * h * tcfg.moe_intermediate_size)
        assert diff == want != 0
    else:
        assert diff == jax_over
    assert port.kv_row_bytes == ref.kv_row_bytes
    assert port.mask_row_bytes == ref.mask_row_bytes


def test_devmon_defaults_are_the_h100s():
    """The port's devmon defaults, the server's flags and ServingConfig
    give the H100 SXM's dense bf16 peak and HBM3 bandwidth (the JAX ones
    are a v5e's), and the capacity headroom a replica's ready time on the
    H100 (the JAX one is a TPU replica's); the constructors still take
    other values."""
    assert (tdevmon.DEFAULT_PEAK_TFLOPS, tdevmon.DEFAULT_HBM_GBPS) == \
        (989.0, 3350.0)
    mon = tdevmon.DevMon()
    assert mon.peak_flops == 989e12 and mon.peak_bw == 3350e9
    s = tconfig.ServingConfig()
    assert (s.devmon_peak_tflops, s.devmon_peak_hbm_gbps) == (989.0, 3350.0)
    assert tdevmon.DevMon(peak_tflops=197.0).peak_flops == 197e12
    assert s.capacity_headroom_s == tcapacity.DEFAULT_HEADROOM_S == \
        tcapacity.CapacityEstimator().headroom_s == 15.0
    assert tcapacity.CapacityEstimator(headroom_s=5.5).headroom_s == 5.5
    # every other observability field keeps the JAX name and default
    j = jconfig.ServingConfig()
    assert j.capacity_headroom_s != s.capacity_headroom_s
    for f in ("otlp_endpoint", "trace_sample", "slo_ttft_p95_ms",
              "slo_error_rate", "flight_spool_dir", "devmon_enabled",
              "devmon_hbm_tolerance_mb", "capacity_enabled",
              "capacity_window_s",
              "capacity_trend_window_s", "ragged_attention",
              "ragged_features"):
        assert getattr(s, f) == getattr(j, f), f


def test_chaos_env_spec_is_read_once(monkeypatch):
    """``$TPU_SERVE_CHAOS`` arms the port's controller as it arms the JAX
    one (the first ``get()`` after a reset reads it)."""
    spec = "stalled_decode:duration_s=2,page_exhaustion:times=3:allocs=2"
    monkeypatch.setenv("TPU_SERVE_CHAOS", spec)
    got = [pkg.chaos.reset() for pkg in (JAX, PORT)]
    assert [c.active("page_exhaustion") for c in got] == [{"allocs": 2}] * 2
    assert [c.active("stalled_decode") for c in got] == \
        [{"duration_s": 2}] * 2
    monkeypatch.delenv("TPU_SERVE_CHAOS")
    assert not PORT.chaos.reset().enabled
    assert os.environ.get("TPU_SERVE_CHAOS") is None
