"""The port server's observability surface against the JAX server's: the
request span tree continued from a ``traceparent`` (read through an
in-memory exporter once the span is finished, not when the body arrives),
the trace ids in ``usage`` and in error bodies, the ``/healthz`` blocks,
the ``/metrics`` families (the busy-time repair among them), the
``/debug/*`` routes, the OTLP export to a collector on localhost, and the
flags of the serving manifest's engine command.

Both servers serve tiny models with the byte tokenizer on the CPU, in
process on free ports.
"""

import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import pytest
import torch
import yaml

from aws_k8s_ansible_provisioner_tpu_torch.config import ServingConfig
from aws_k8s_ansible_provisioner_tpu_torch.serving import flightrec, tracing
from aws_k8s_ansible_provisioner_tpu_torch.serving import server as tserver

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
TRACEPARENT = "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"
PHASES = ["admission", "queue_wait", "prefill", "decode", "stream_out"]
SERVING = dict(model="tiny-qwen3", max_decode_slots=4, max_cache_len=128,
               page_size=8, prefill_buckets=(16, 32, 64), dtype="float32",
               prefill_chunk=16)


class Recorder:
    """In-memory exporter: (span, service) as each span is finished."""

    def __init__(self):
        self.items = []

    def export(self, span, service_name):
        self.items.append((span, service_name))
        return True

    def wait_for(self, n_roots: int, timeout: float = 20.0):
        """The spans once ``n_roots`` ``server.request`` spans (and their
        children, finished first) are in: the finish happens after the
        answer is written, so the client cannot take its read as the
        signal."""
        t0 = time.monotonic()
        while time.monotonic() - t0 < timeout:
            if sum(s.name == "server.request" for s, _ in self.items) >= \
                    n_roots:
                return list(self.items)
            time.sleep(0.01)
        raise AssertionError(f"spans never arrived: {self.items}")


def _serve_port(serving):
    state = tserver.build_state(serving, device="cpu")
    srv = tserver.make_server(state, "127.0.0.1", 0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    state.start_engine()

    def stop():
        srv.shutdown()
        srv.server_close()
        state.stop_engine()
        th.join(10)

    return f"http://127.0.0.1:{srv.server_address[1]}", state, stop


@pytest.fixture(scope="module")
def server():
    base, state, stop = _serve_port(ServingConfig(**SERVING))
    yield base, state
    stop()


@pytest.fixture(scope="module")
def jax_server():
    """The JAX package's server over tiny_qwen3 in process, as in
    ``test_torch_server.py``."""
    import jax
    import jax.numpy as jnp

    from aws_k8s_ansible_provisioner_tpu.config import \
        ServingConfig as JServing
    from aws_k8s_ansible_provisioner_tpu.config import tiny_qwen3
    from aws_k8s_ansible_provisioner_tpu.models.layers import init_params
    from aws_k8s_ansible_provisioner_tpu.serving import server as jserver
    from aws_k8s_ansible_provisioner_tpu.utils.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    cfg = tiny_qwen3(vocab_size=tok.vocab_size, eos_token_id=tok.eos_token_id)
    params = init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    state = jserver.build_state(JServing(weights_dtype="bf16", **SERVING),
                                model_cfg=cfg, params=params, tokenizer=tok)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ready, stop = threading.Event(), threading.Event()
    th = threading.Thread(target=jserver.serve,
                          args=(state, "127.0.0.1", port, ready, stop),
                          daemon=True)
    th.start()
    assert ready.wait(60)
    yield f"http://127.0.0.1:{port}", state
    stop.set()
    th.join(30)


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _post(url, body, headers=None):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _tree(items):
    """The span tree as names, kinds, parent names, attribute keys, in
    start order (the phases' order)."""
    by_id = {s.context.span_id: s for s, _ in items}
    out = []
    for s, service in sorted(items, key=lambda x: (x[0].start_ns,
                                                   x[0].name != "server."
                                                   "request")):
        parent = by_id.get(s.parent_span_id)
        out.append({"name": s.name, "kind": s.kind, "service": service,
                    "parent": parent.name if parent is not None else
                    ("<remote>" if s.parent_span_id else None),
                    "status": s.status,
                    "attributes": sorted(s.attributes)})
    return out


@pytest.mark.parametrize("stream", [False, True])
def test_span_tree_matches_the_jax_server(server, jax_server, stream):
    """One request with a ``traceparent`` to each server: ``server.request``
    (kind SERVER, child of the given span, in its trace) and its five
    phases, in order, with the same names, kinds, parents and attribute
    keys; the port's phases do not overlap and tile the request span; the
    answer's usage echoes the span's ids."""
    trees, ids = [], []
    for base, state, tr in ((server[0], server[1], tracing),
                            (jax_server[0], jax_server[1], None)):
        if tr is None:
            from aws_k8s_ansible_provisioner_tpu.serving import \
                tracing as tr
        rec = Recorder()
        state.tracer = tr.Tracer("tpu-serve-engine", exporter=rec, seed=11)
        body = {"prompt": "trace me", "max_tokens": 6, "ignore_eos": True,
                "stream": stream, "deadline_ms": 60000}
        if stream:
            body["stream_options"] = {"include_usage": True}
        status, raw = _post(base + "/v1/completions", body,
                            {"traceparent": TRACEPARENT})
        assert status == 200
        if stream:
            events = [json.loads(line[6:]) for line in
                      raw.decode().splitlines()
                      if line.startswith("data: {")]
            usage = events[-1]["usage"]
        else:
            usage = json.loads(raw)["usage"]
        items = rec.wait_for(1)
        state.tracer = None
        root = next(s for s, _ in items if s.name == "server.request")
        assert root.context.trace_id == TRACEPARENT.split("-")[1]
        assert root.parent_span_id == TRACEPARENT.split("-")[2]
        assert (usage["trace_id"], usage["span_id"]) == \
            (root.context.trace_id, root.context.span_id)
        trees.append(_tree(items))
        ids.append(root)
    port_tree, jax_tree = trees
    assert port_tree == jax_tree
    assert [t["name"] for t in port_tree] == ["server.request"] + PHASES
    # the port's phases: contiguous, non-overlapping, the request's width
    items = sorted((s for s in _phase_spans(ids[0])), key=lambda s:
                   s.start_ns)
    assert [s.name for s in items] == PHASES
    for a, b in zip(items, items[1:]):
        assert a.end_ns == b.start_ns
    assert items[0].start_ns == ids[0].start_ns
    assert items[-1].end_ns == ids[0].end_ns


_LAST = {}


def _phase_spans(root):
    return _LAST[root.context.span_id]


@pytest.fixture(autouse=True)
def _keep_phases(monkeypatch):
    """Keep each traced request's phase spans by their parent's id (the
    tree test reads the port's after the fact)."""
    _LAST.clear()
    orig = tracing.Tracer.emit_span

    def emit(self, name, parent, start_ns, end_ns, **kw):
        span = orig(self, name, parent, start_ns, end_ns, **kw)
        _LAST.setdefault(parent.span_id, []).append(span)
        return span

    monkeypatch.setattr(tracing.Tracer, "emit_span", emit)


def test_error_bodies_carry_the_trace_ids(server):
    base, state = server
    rec = Recorder()
    state.tracer = tracing.Tracer("tpu-serve-engine", exporter=rec, seed=3)
    try:
        status, raw = _post(base + "/v1/completions",
                            {"prompt": "x", "max_tokens": 0},
                            {"traceparent": TRACEPARENT})
    finally:
        items = rec.wait_for(1)
        state.tracer = None
    err = json.loads(raw)["error"]
    root = next(s for s, _ in items if s.name == "server.request")
    assert status == 400 and err["trace_id"] == root.context.trace_id
    assert err["span_id"] == root.context.span_id


JAX_HEALTH_BLOCKS = ("slo", "slo_burning", "flight", "device", "hbm_drift",
                     "capacity")


def test_healthz_has_the_jax_blocks(server, jax_server):
    """``/healthz`` carries the JAX server's observability blocks, with
    the JAX blocks' keys (values are each replica's own)."""
    _post(server[0] + "/v1/completions", {"prompt": "warm", "max_tokens": 4})
    _post(jax_server[0] + "/v1/completions",
          {"prompt": "warm", "max_tokens": 4})
    port = json.loads(_get(server[0] + "/healthz")[1])
    ref = json.loads(_get(jax_server[0] + "/healthz")[1])
    for block in JAX_HEALTH_BLOCKS:
        assert block in port, block
        if isinstance(ref[block], dict):
            assert set(port[block]) == set(ref[block]), block
    assert port["hbm_drift"] == "ok"
    assert port["device"]["hbm_live_bytes"] > 0
    assert port["capacity"]["enabled"] is True
    assert set(port["slo"]) == set(ref["slo"]) == {"error_rate", "shed_rate"}
    assert port["decode_bubble_pct"] is not None
    for key in ("decode_bubble_pct", "ragged_attention", "ragged_features",
                "pipeline", "aot"):
        assert key in port and key in ref, key


def _samples(text, name):
    return {line.split()[0]: float(line.split()[1])
            for line in text.splitlines()
            if line.startswith(name) and not line.startswith("#")}


def test_metrics_render_the_observability_families(server):
    """``/metrics`` renders tracing's, the flight recorder's, the SLO
    engine's, devmon's and the capacity estimator's families beside the
    engine's, and the busy-time repair: after serving,
    ``tpu_serve_device_busy_seconds_total`` is above 0 (it stayed at 0
    before the port booked device time) and devmon's decode series are
    set."""
    base, state = server
    status, _ = _post(base + "/v1/completions",
                      {"prompt": "busy", "max_tokens": 12,
                       "ignore_eos": True})
    assert status == 200
    text = _get(base + "/metrics")[1].decode()
    for family in ("tpu_serve_spans_dropped_total",
                   "tpu_serve_spans_exported_total",
                   "tpu_serve_flight_events_total",
                   "tpu_serve_flight_drops_total", "tpu_serve_slo_burn_rate",
                   "tpu_device_mfu", "tpu_device_membw_util",
                   "tpu_device_duty_cycle", "tpu_device_hbm_live_bytes",
                   "tpu_capacity_offered_tps", "tpu_capacity_ceiling_tps",
                   "tpu_capacity_export_drops_total",
                   "tpu_serve_decode_bubble_seconds_total",
                   "tpu_serve_pipeline_dispatches_total"):
        assert f"# TYPE {family}" in text, family
    assert _samples(text, "tpu_serve_device_busy_seconds_total")[
        "tpu_serve_device_busy_seconds_total"] > 0
    mfu = _samples(text, "tpu_device_mfu")
    assert mfu['tpu_device_mfu{program="decode"}'] > 0
    assert _samples(text, "tpu_serve_flight_events_total")[
        "tpu_serve_flight_events_total"] > 0
    om = urllib.request.Request(base + "/metrics", headers={
        "Accept": "application/openmetrics-text"})
    with urllib.request.urlopen(om, timeout=60) as r:
        assert r.read().decode().endswith("# EOF\n")


def test_debug_routes(server):
    """``/debug/roofline`` and ``/debug/capacity`` (the snapshots),
    ``/debug/events?last=N`` (the ring, oldest first), ``/debug/flight/<id>``
    (an anomaly's dump: here a request past its deadline; 404 for an
    unknown id) and ``/debug/profile?ms=N`` (a Chrome trace written
    server-side)."""
    base, state = server
    _post(base + "/v1/completions", {"prompt": "debug", "max_tokens": 8})
    roof = json.loads(_get(base + "/debug/roofline")[1])
    assert roof["peak_tflops"] == 989.0 and roof["peak_hbm_gbps"] == 3350.0
    assert roof["programs"]["decode"]["dispatches"] > 0
    assert set(roof["hbm"]["components"]) >= {"params", "kv_pages"}
    cap = json.loads(_get(base + "/debug/capacity")[1])
    assert cap["offered"]["requests_per_s"] > 0
    events = json.loads(_get(base + "/debug/events?last=5")[1])["events"]
    assert 0 < len(events) <= 5
    assert [e["t_mono_ns"] for e in events] == \
        sorted(e["t_mono_ns"] for e in events)
    # a request whose deadline expires: 408, and its timeline is dumped
    status, raw = _post(base + "/v1/completions",
                        {"prompt": "slow", "max_tokens": 120,
                         "ignore_eos": True, "deadline_ms": 1})
    assert status == 408
    t0 = time.monotonic()
    dump = None
    while dump is None and time.monotonic() - t0 < 20:
        last = flightrec.get().summary()["last_anomaly"]
        if last and last["reason"] == "timeout":
            status, raw = _get(f"{base}/debug/flight/{last['request_id']}")
            assert status == 200
            dump = json.loads(raw)
        time.sleep(0.01)
    assert dump["reason"] == "timeout"
    assert [e["type"] for e in dump["events"]][-1] == "finish"
    assert _get(base + "/debug/flight/999999999")[0] == 404
    status, raw = _get(base + "/debug/profile?ms=50")
    out = json.loads(raw)
    assert status == 200 and out["window_ms"] == 50
    with open(out["trace_path"], encoding="utf-8") as f:
        assert "traceEvents" in json.load(f)
    os.remove(out["trace_path"])


class _Collector(BaseHTTPRequestHandler):
    payloads = []

    def log_message(self, *a):
        pass

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        type(self).payloads.append((self.path, json.loads(self.rfile.read(n))))
        self.send_response(200)
        self.send_header("Content-Length", "2")
        self.end_headers()
        self.wfile.write(b"{}")


def test_spans_export_to_an_otlp_collector(tmp_path):
    """``otlp_endpoint`` (``--otlp-endpoint``): the server's tracer batches
    its spans to ``<endpoint>/v1/traces`` as OTLP/JSON under the service
    ``tpu-serve-engine``; the flight spool directory takes the anomalies'
    dumps."""
    coll = ThreadingHTTPServer(("127.0.0.1", 0), _Collector)
    threading.Thread(target=coll.serve_forever, daemon=True).start()
    _Collector.payloads = []
    spool = tmp_path / "spool"
    base, state, stop = _serve_port(ServingConfig(
        otlp_endpoint=f"http://127.0.0.1:{coll.server_address[1]}",
        flight_spool_dir=str(spool), **SERVING))
    try:
        assert _post(base + "/v1/completions",
                     {"prompt": "export", "max_tokens": 4},
                     {"traceparent": TRACEPARENT})[0] == 200
        assert _post(base + "/v1/completions",
                     {"prompt": "late", "max_tokens": 120,
                      "ignore_eos": True, "deadline_ms": 1})[0] == 408
        t0 = time.monotonic()
        while time.monotonic() - t0 < 20:
            if sum(len(r["scopeSpans"][0]["spans"]) for _, p in
                   _Collector.payloads for r in p["resourceSpans"]) >= 12:
                break
            time.sleep(0.02)
        assert state.tracer.exporter.flush(10)
        assert flightrec.get().flush(10)
    finally:
        stop()
        coll.shutdown()
        coll.server_close()
    spans = [(r["resource"]["attributes"][0]["value"]["stringValue"], s)
             for path, p in _Collector.payloads for r in p["resourceSpans"]
             for s in r["scopeSpans"][0]["spans"]]
    assert all(path == "/v1/traces" for path, _ in _Collector.payloads)
    assert {svc for svc, _ in spans} == {"tpu-serve-engine"}
    names = [s["name"] for _, s in spans]
    assert names.count("server.request") == 2
    assert sorted(set(names)) == sorted(["server.request"] + PHASES)
    root = next(s for _, s in spans if s["name"] == "server.request"
                and s.get("parentSpanId") == TRACEPARENT.split("-")[2])
    assert root["traceId"] == TRACEPARENT.split("-")[1]
    lines = (spool / "flight.jsonl").read_text().splitlines()
    assert [json.loads(x)["reason"] for x in lines] == ["timeout"]


def _engine_commands():
    """The engine container's command of the serving manifest, rendered as
    the deploy tests render it, with ``rehearsal_cpu`` false and true."""
    from aws_k8s_ansible_provisioner_tpu.config import render_manifest

    out = {}
    for cpu in (False, True):
        kw = dict(rehearsal_cpu=True, model="tiny-qwen3",
                  framework_image="img", storage_class="standard") \
            if cpu else {}
        text = render_manifest(
            str(REPO / "deploy" / "manifests" / "serving.yaml.j2"), **kw)
        eng = next(d for d in yaml.safe_load_all(text) if d
                   and d["kind"] == "Deployment"
                   and d["metadata"]["name"] == "tpu-serving-engine")
        cmd = eng["spec"]["template"]["spec"]["containers"][0]["command"]
        out[cpu] = cmd[cmd.index("-m") + 2:]
    return out


# each manifest flag: the ServingConfig field it sets (None: another place)
MANIFEST_FIELDS = {
    "--model": "model", "--checkpoint-dir": "checkpoint_dir",
    "--platform": None, "--max-decode-slots": "max_decode_slots",
    "--max-cache-len": "max_cache_len", "--host": "host", "--port": "port",
    "--tp": "mesh.tp", "--dp": "mesh.dp", "--sp": "mesh.sp",
    "--ep": "mesh.ep", "--kv-dtype": "kv_dtype",
    "--weights-dtype": "weights_dtype",
    "--request-timeout": "request_timeout_s",
    "--max-queue-depth": "max_queue_depth",
    "--decode-pipeline": "decode_pipeline",
    "--ragged-attention": "ragged_attention",
    "--drain-timeout": "drain_timeout_s", "--otlp-endpoint": "otlp_endpoint",
    "--trace-sample": "trace_sample", "--slo-ttft-p95-ms": "slo_ttft_p95_ms",
    "--slo-error-rate": "slo_error_rate",
    "--flight-spool-dir": "flight_spool_dir",
    "--devmon-peak-tflops": "devmon_peak_tflops",
    "--devmon-peak-hbm-gbps": "devmon_peak_hbm_gbps",
    "--devmon-hbm-tolerance-mb": "devmon_hbm_tolerance_mb",
    "--capacity-headroom-s": "capacity_headroom_s",
    "--capacity-window-s": "capacity_window_s",
    "--chat-template": "chat_template",
}


@pytest.mark.parametrize("rehearsal_cpu", [False, True])
def test_manifest_engine_command_is_taken(rehearsal_cpu):
    """The engine arguments the serving manifest passes (after the module
    name) parse with the port's server flags, and the ServingConfig they
    give holds the values the template rendered; ``--platform cpu`` (the
    kind rehearsal) means ``--device cpu``. The manifest itself still
    launches the JAX module."""
    argv = _engine_commands()[rehearsal_cpu]
    p = tserver.build_parser()
    args = p.parse_args(argv)
    tserver.check_args(p, args)
    cfg = tserver.serving_config(args)
    given = {}
    i = 0
    while i < len(argv):
        flag = argv[i]
        assert flag in MANIFEST_FIELDS or flag == "--spec-decode", flag
        if i + 1 < len(argv) and not argv[i + 1].startswith("--"):
            given[flag] = argv[i + 1]
            i += 2
        else:
            given[flag] = True
            i += 1
    for flag, val in given.items():
        field = MANIFEST_FIELDS.get(flag)
        if field is None:
            continue
        obj = cfg
        for part in field.split("."):
            obj = getattr(obj, part)
        assert obj == type(obj)(val), (flag, obj, val)
    assert args.device == ("cpu" if rehearsal_cpu else "cuda")
    assert ("--platform" in given) == rehearsal_cpu
    # the values the JAX ServingConfig gives the template, where its
    # defaults are the port's (devmon's peaks are a v5e's there)
    assert cfg.otlp_endpoint == given["--otlp-endpoint"]
    assert cfg.devmon_peak_tflops == float(given["--devmon-peak-tflops"])


@pytest.mark.parametrize("argv,why", [
    (["--ragged-attention", "0"], "--ragged-attention 0"),
    (["--ragged-features", "0"], "--ragged-features 0"),
    (["--platform", "tpu"], "--platform tpu"),
])
def test_unported_flag_values_are_refused(argv, why, capsys):
    p = tserver.build_parser()
    args = p.parse_args(argv)
    with pytest.raises(SystemExit):
        tserver.check_args(p, args)
    assert why in capsys.readouterr().err


def test_flags_reach_serving_config():
    p = tserver.build_parser()
    args = p.parse_args(["--platform", "cpu", "--no-devmon", "--no-capacity",
                         "--capacity-trend-window-s", "120",
                         "--trace-sample", "0.5"])
    tserver.check_args(p, args)
    cfg = tserver.serving_config(args)
    assert args.device == "cpu"
    assert not cfg.devmon_enabled and not cfg.capacity_enabled
    assert cfg.capacity_trend_window_s == 120.0 and cfg.trace_sample == 0.5
