"""The port's ``serving/metrics.py`` (a copy of the JAX package's) and the
engine's feed of it, against the JAX package: the same exposition in both
formats for the same operations, the same family names, and after the same
greedy workload on tiny_qwen3 the same request, token and prefix counters;
then ``/metrics`` over the port's server.
"""

import dataclasses
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aws_k8s_ansible_provisioner_tpu.config import ServingConfig as JServing
from aws_k8s_ansible_provisioner_tpu.config import tiny_qwen3 as jax_tiny
from aws_k8s_ansible_provisioner_tpu.models.layers import init_params
from aws_k8s_ansible_provisioner_tpu.serving import metrics as jmetrics
from aws_k8s_ansible_provisioner_tpu.serving.engine import Engine as JEngine
from aws_k8s_ansible_provisioner_tpu.serving.engine import Request as JRequest
from aws_k8s_ansible_provisioner_tpu_torch.config import ModelConfig
from aws_k8s_ansible_provisioner_tpu_torch.config import \
    ServingConfig as TServing
from aws_k8s_ansible_provisioner_tpu_torch.models.convert import \
    from_jax_params
from aws_k8s_ansible_provisioner_tpu_torch.serving import metrics as tmetrics
from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import \
    Engine as TEngine
from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import \
    Request as TRequest

torch.set_num_threads(2)


def _families(text: str) -> list:
    return [ln.split()[2:4] for ln in text.splitlines()
            if ln.startswith("# TYPE ")]


@pytest.mark.parametrize("openmetrics", [False, True])
def test_the_same_operations_render_the_same_text(openmetrics):
    """Counters (labelled, with a value that needs escaping), gauges,
    histograms with exemplars: the copy renders what the JAX module
    renders."""
    texts = []
    for mod in (jmetrics, tmetrics):
        r = mod.Registry()
        c = r.register(mod.Counter("x_requests_total", "requests",
                                   ("status", "model")))
        c.inc(status="success", model='a"b\\c\nd')
        c.inc(2.5, status="timeout", model="m")
        g = r.register(mod.Gauge("x_depth", "depth"))
        g.set(3)
        g.add(1.5)
        lg = r.register(mod.Gauge("x_burn", "burn", ("window",)))
        lg.set(0.25, window="5m")
        h = r.register(mod.Histogram("x_seconds", "latency",
                                     buckets=(0.1, 1.0)))
        for v, tid in ((0.05, "t1"), (0.5, None), (7.0, "t3")):
            h.observe(v, trace_id=tid)
        r.register(mod.Counter("x_empty_total", "never incremented"))
        texts.append(r.render(openmetrics))
    assert texts[0] == texts[1]


def test_engine_and_pipeline_families_are_the_jax_ones():
    """The port's ``EngineMetrics`` and ``PipelineMetrics`` render the JAX
    ones' family names and types (the ``vllm_*`` aliases included), in
    both formats, and the pipeline snapshot has the same keys."""
    for om in (True, False):
        want = _families(jmetrics.EngineMetrics().registry.render(om)
                         + jmetrics.PipelineMetrics().registry.render(om))
        got = _families(tmetrics.EngineMetrics().registry.render(om)
                        + tmetrics.PipelineMetrics().registry.render(om))
        assert got == want
    names = {n for n, _ in got}          # the classic names
    assert {"vllm_request_total", "vllm_request_duration_seconds",
            "tpu_serve_request_total", "tpu_serve_requests_shed_total",
            "tpu_serve_deadline_expired_total", "tpu_serve_draining",
            "tpu_serve_watchdog_stalls_total",
            "tpu_serve_admission_preemptions_total",
            "tpu_serve_pipeline_drains_total"} <= names
    assert tmetrics.PipelineMetrics().snapshot().keys() == \
        jmetrics.PipelineMetrics().snapshot().keys()


@pytest.fixture(scope="module")
def model():
    jcfg = jax_tiny()
    params = init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)

    def scale(node):
        return {k: scale(v) if isinstance(v, dict) else
                v * 8 if k == "kernel" else v for k, v in node.items()}

    params = scale(params)
    params["embed"] = {"weight": params["embed"]["weight"] * 8}
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    tparams = from_jax_params(jax.tree.map(np.asarray, params), tcfg)
    return jcfg, params, tcfg, tparams


def _workload(eng, Request):
    """Greedy requests: fresh prompts (one walks the chunks), then the
    chunked prompt again with a new tail (a prefix hit), then a request
    cancelled while queued."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(2, 128, n).tolist() for n in (5, 11, 30, 7)]
    reqs = [eng.submit(Request(prompt_ids=p, max_tokens=m, ignore_eos=i != 1))
            for i, (p, m) in enumerate(zip(prompts, (6, 9, 4, 12)))]
    _run(eng)
    again = eng.submit(Request(prompt_ids=prompts[2] + [3, 4, 5],
                               max_tokens=5, ignore_eos=True))
    _run(eng)
    gone = eng.submit(Request(prompt_ids=[9, 9, 9], max_tokens=5))
    eng.cancel(gone)
    _run(eng)
    return [r.generated for r in reqs + [again]] + [gone.finish_reason]


def _run(eng):
    for _ in range(10000):
        if not eng.step():
            return
    raise AssertionError("engine did not go idle")


def _counters(eng) -> dict:
    m = eng.metrics
    return {
        "status": {s: m.request_total.value(status=s)
                   for s in ("success", "cancelled", "timeout", "error")},
        "vllm": {s: m.vllm_request_total.value(status=s)
                 for s in ("success", "cancelled")},
        "generated_tokens": m.generated_tokens.total(),
        "prompt_tokens": m.prompt_tokens.total(),
        "prefix_cache_hits": m.prefix_cache_hits.total(),
        "prefix_tokens_reused": m.prefix_tokens_reused.total(),
        "tier": {t: m.prefix_tier_hits.value(tier=t)
                 for t in ("hbm", "host", "miss")},
        "ttft_observed": m.ttft._total,
        "durations_observed": m.request_duration._total,
        "active": m.active_requests.value(),
        "queue_depth": m.queue_depth.value(),
    }


@pytest.mark.parametrize("paged", [True, False])
def test_the_same_greedy_workload_counts_the_same(model, paged):
    """After the same greedy workload both engines count the same
    requests by status, generated and prompt tokens, prefix hits and
    reused tokens, and leave the gauges at rest."""
    jcfg, jp, tcfg, tp = model
    serving = dict(weights_dtype="bf16", dtype="float32", max_decode_slots=2,
                   max_cache_len=64, page_size=8,
                   prefill_buckets=(8, 16, 32), prefill_chunk=16,
                   prefix_cache_min_len=8, prefix_cache_payback_rows=1,
                   paged=paged, admission_preempt_after_s=0.0)
    je = JEngine(jcfg, jp, JServing(**serving))
    te = TEngine(tcfg, tp, TServing(**serving), device="cpu")
    assert _workload(te, TRequest) == _workload(je, JRequest)
    got, want = _counters(te), _counters(je)
    assert got == want
    assert got["generated_tokens"] == te.counts["generated_tokens"]
    assert got["status"]["success"] == 5 and got["prefix_cache_hits"] >= 1


def test_metrics_route_has_the_scrape_shape():
    """``/metrics``: Prometheus text by default (the families the JAX
    server's test asserts), OpenMetrics with its ``# EOF`` on ``Accept``,
    and ``tpu_serve_generated_tokens_total`` equal to the engine's count."""
    from aws_k8s_ansible_provisioner_tpu_torch.serving.server import (
        build_state, make_server)

    state = build_state(TServing(model="tiny-qwen3", max_decode_slots=2,
                                 max_cache_len=64, page_size=8,
                                 prefill_buckets=(16, 32), dtype="float32"),
                        device="cpu")
    srv = make_server(state, "127.0.0.1", 0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    state.start_engine()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        req = urllib.request.Request(
            base + "/v1/completions", data=json.dumps(
                {"prompt": "count me", "max_tokens": 5,
                 "ignore_eos": True}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.status == 200
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            text = r.read().decode()
            assert r.headers["Content-Type"].startswith("text/plain")
        for name in ("tpu_serve_request_total", "vllm_request_total",
                     "vllm_request_duration_seconds_bucket",
                     "tpu_serve_time_to_first_token_seconds_bucket",
                     "tpu_serve_pipeline_dispatches_total"):
            assert name in text
        assert 'tpu_serve_request_total{status="success"} 1.0' in text
        line = next(ln for ln in text.splitlines()
                    if ln.startswith("tpu_serve_generated_tokens_total "))
        assert float(line.split()[1]) == \
            state.engine.counts["generated_tokens"] == 5
        req = urllib.request.Request(
            base + "/metrics",
            headers={"Accept": "application/openmetrics-text"})
        with urllib.request.urlopen(req, timeout=30) as r:
            om = r.read().decode()
            assert r.headers["Content-Type"].startswith(
                "application/openmetrics-text")
        assert om.endswith("# EOF\n") and om.count("# EOF") == 1
        assert "# TYPE tpu_serve_request counter" in om
    finally:
        srv.shutdown()
        srv.server_close()
        state.stop_engine()
        th.join(10)
