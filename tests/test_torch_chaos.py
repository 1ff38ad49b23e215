"""The faults of ``serving/chaos.py`` on the port's engine and server, at
the JAX engine's sites: ``page_exhaustion`` (admission requeue, decode
preemption), ``stalled_decode`` (the watchdog's abort), the fetch-time
faults (``pipeline_fetch_error``, ``ragged_dispatch_error``,
``ragged_feature_error`` for guided and speculative rows),
``kv_offload_error`` (a corrupted host-tier entry), ``kill_stream`` (a
replica dying mid-stream) and the observability modules' own
(``span_export``, ``flight_dump_error``, ``capacity_export_error``).

Each fault leaves the engine serving, releases every slot and page exactly
once (a page released twice raises in ``PagePool.release``; the checks
below also hold the free lists), lands in the flight recorder as a
``chaos_fault`` event, and the next seeded request equals the undisturbed
stream. Where the JAX engine gives a defined stream under the same
injection (``page_exhaustion``, ``kv_offload_error``), the streams are
compared with it.
"""

import dataclasses
import json
import socket
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aws_k8s_ansible_provisioner_tpu.config import ServingConfig as JServing
from aws_k8s_ansible_provisioner_tpu.config import tiny_qwen3 as jax_tiny
from aws_k8s_ansible_provisioner_tpu.models.layers import init_params
from aws_k8s_ansible_provisioner_tpu.serving import chaos as jchaos
from aws_k8s_ansible_provisioner_tpu.serving.engine import Engine as JEngine
from aws_k8s_ansible_provisioner_tpu.serving.engine import Request as JRequest
from aws_k8s_ansible_provisioner_tpu_torch.config import (ModelConfig,
                                                          ServingConfig)
from aws_k8s_ansible_provisioner_tpu_torch.models.convert import \
    from_jax_params
from aws_k8s_ansible_provisioner_tpu_torch.serving import (capacity, chaos,
                                                           flightrec,
                                                           tracing)
from aws_k8s_ansible_provisioner_tpu_torch.serving import server as tserver
from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import \
    Engine as TEngine
from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import \
    Request as TRequest
from aws_k8s_ansible_provisioner_tpu_torch.serving.guided import \
    grammar_for_request
from aws_k8s_ansible_provisioner_tpu_torch.utils.tokenizer import \
    ByteTokenizer

torch.set_num_threads(2)

TOK = ByteTokenizer()
# the JAX chaos tests' engine (tests/test_chaos.py); no admission-pressure
# preemption (a wall-clock rule)
CHAOS = dict(weights_dtype="bf16", max_decode_slots=2, max_cache_len=128,
             page_size=32, prefill_buckets=(16, 32, 64, 128),
             dtype="float32", derived_seed=0, admission_preempt_after_s=0)


@pytest.fixture(scope="module")
def model():
    jcfg = jax_tiny(vocab_size=TOK.vocab_size, eos_token_id=TOK.eos_token_id)
    params = init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)

    def scale(node):
        return {k: scale(v) if isinstance(v, dict) else
                v * 8 if k == "kernel" else v for k, v in node.items()}

    params = scale(params)
    params["embed"] = {"weight": params["embed"]["weight"] * 8}
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    tparams = from_jax_params(jax.tree.map(np.asarray, params), tcfg)
    return jcfg, params, tcfg, tparams


@pytest.fixture(autouse=True)
def clean_chaos(monkeypatch):
    monkeypatch.delenv("TPU_SERVE_CHAOS", raising=False)
    for mod in (chaos, jchaos):
        mod.reset()
    flightrec.reset()
    yield
    for mod in (chaos, jchaos):
        mod.reset()


def _port(model, **over):
    _, _, tcfg, tp = model
    return TEngine(tcfg, tp, ServingConfig(**{**CHAOS, **over}),
                   device="cpu")


def _jax(model, **over):
    jcfg, jp, _, _ = model
    return JEngine(jcfg, jp, JServing(**{**CHAOS, **over}))


def _run(eng, max_steps=20000):
    for _ in range(max_steps):
        if not eng.step():
            return
    raise AssertionError("engine did not go idle")


def _released(eng):
    """Every slot free once, every page free or evictable once, nothing
    queued, chunking or in flight."""
    assert sorted(eng._free) == list(range(eng.num_slots)), eng._free
    assert not any(eng.slot_req) and not eng._queue
    assert eng._chunk is None and eng._inflight is None
    if eng.paged:
        for a in eng.allocators:
            st = a.stats()
            assert st["pages_live"] == 0, st
            assert st["pages_free"] + st["pages_evictable"] == \
                st["pages_total"], st
            assert len(set(a._free)) == len(a._free)
        assert all(not p for p in eng._slot_pages)


def _faults(name):
    return [e for e in flightrec.get().tail(4096)
            if e["type"] == "chaos_fault" and e.get("fault") == name]


def _ids(text):
    return TOK.encode(text)


def _undisturbed(model, prompt, **req):
    eng = _port(model)
    r = eng.submit(TRequest(prompt_ids=prompt, **req))
    _run(eng)
    return r.generated


def _settle(eng, timeout=60.0):
    t0 = time.monotonic()
    while (eng._active_slots() or eng.pending or eng._chunk is not None
           or eng._inflight is not None):
        if time.monotonic() - t0 > timeout:
            raise AssertionError("the engine did not settle")
        time.sleep(0.01)


def test_page_exhaustion_at_admission_requeues_and_heals(model):
    """An allocation refused after the admission gate (the JAX engine's
    ``_paged_admit`` returning None) requeues the request at the head with
    its slot back; the next step admits it, and its stream is the JAX
    engine's under the same injection and the undisturbed one."""
    prompt = _ids("alloc fails once")
    streams = []
    for eng, req_cls, ch in ((_jax(model), JRequest, jchaos),
                             (_port(model), TRequest, chaos)):
        ch.get().inject("page_exhaustion", times=1, allocs=1)
        r = eng.submit(req_cls(prompt_ids=prompt, max_tokens=6))
        eng.step()
        assert not eng._active_slots()
        if req_cls is TRequest:
            assert eng.pending == 1 and sorted(eng._free) == [0, 1]
        _run(eng)
        assert r.finish_reason in ("stop", "length")
        streams.append(r.generated)
    assert streams[0] == streams[1] == _undisturbed(model, prompt,
                                                    max_tokens=6)
    _released(eng)
    assert len(_faults("page_exhaustion")) == 1


def test_page_exhaustion_mid_decode_preempts_not_crashes(model):
    """The pool refuses a growth allocation mid-decode: the newest request
    is preempted and resumed, and its stream is the undisturbed one and
    the JAX engine's (the chaos hook's allocator counter, driven
    directly)."""
    prompt = _ids("grow across pages")
    streams = []
    for eng, req_cls in ((_jax(model), JRequest), (_port(model), TRequest)):
        r = eng.submit(req_cls(prompt_ids=prompt, max_tokens=40,
                               ignore_eos=True))
        eng.step()
        assert eng._active_slots()
        for a in eng.allocators:
            a.fail_next_allocs = 1
        _run(eng)
        assert r.finish_reason == "length"
        assert eng.metrics.preemptions.total() >= 1
        streams.append(r.generated)
    assert streams[0] == streams[1] == _undisturbed(
        model, prompt, max_tokens=40, ignore_eos=True)
    _released(eng)
    assert any(e["type"] == "preempt" for e in flightrec.get().tail(4096))


def _serving_thread(eng):
    stop = threading.Event()
    th = threading.Thread(target=eng.run_forever, args=(stop,), daemon=True)
    th.start()
    return stop, th


def _after_fault(model, eng, prompt=None):
    """The engine keeps serving: a seeded sampled request after the fault
    gives the undisturbed stream; then every slot and page is free."""
    prompt = prompt or _ids("after the fault")
    req = dict(max_tokens=10, temperature=0.9, top_p=0.9, top_k=40, seed=5,
               ignore_eos=True)
    r = eng.submit(TRequest(prompt_ids=prompt, **req))
    r.wait(timeout=60)
    assert r.finish_reason == "length"
    _settle(eng)
    _released(eng)
    assert r.generated == _undisturbed(model, prompt, **req)


def test_stalled_decode_fails_the_requests_and_the_engine_serves_on(model):
    """The stall wedges the decode step until the watchdog arms its abort
    flag (``_stall_abort``, which the stall reads): the request fails with
    ``error``, the watchdog counts one stall, the flight recorder holds
    the fault, the stall and the failure, and the engine serves on."""
    eng = _port(model, watchdog_stall_s=0.2)
    chaos.get().inject("stalled_decode", times=1, duration_s=30.0)
    stop, th = _serving_thread(eng)
    try:
        t0 = time.monotonic()
        r = eng.submit(TRequest(prompt_ids=_ids("will stall"), max_tokens=8,
                                ignore_eos=True))
        r.wait(timeout=30)
        assert time.monotonic() - t0 < 20          # not the 30 s stall
        assert r.finish_reason == "error" and len(r.generated) < 8
        assert "InjectedStall" in eng.last_error
        assert eng.metrics.watchdog_stalls.total() == 1
        types = [e["type"] for e in flightrec.get().tail(4096)]
        for want in ("chaos_fault", "watchdog_stall", "fail_all"):
            assert want in types, want
        assert flightrec.get().dump_for(r.id)["reason"] == "error"
        _after_fault(model, eng)
    finally:
        stop.set()
        th.join(10)


@pytest.mark.parametrize("fault,pipeline", [("pipeline_fetch_error", 1),
                                            ("pipeline_fetch_error", 0),
                                            ("ragged_dispatch_error", 1)])
def test_fetch_faults_fail_the_dispatch_and_the_engine_serves_on(
        model, fault, pipeline):
    """A fault at the fetch of a decode dispatch (or, for
    ``ragged_dispatch_error``, of a mixed dispatch: a long prompt walks
    its chunks beside a running request) discards the dispatch, fails its
    requests with ``error`` and releases their slots and pages once; the
    engine serves on."""
    eng = _port(model, decode_pipeline=pipeline, prefill_chunk=16)
    chaos.get().inject(fault, after=1, times=1)
    stop, th = _serving_thread(eng)
    try:
        reqs = [eng.submit(TRequest(prompt_ids=_ids("running request"),
                                    max_tokens=40, ignore_eos=True))]
        if fault == "ragged_dispatch_error":
            while not eng._active_slots():
                time.sleep(0.002)
            reqs.append(eng.submit(TRequest(
                prompt_ids=list(range(40, 100)), max_tokens=4,
                ignore_eos=True)))
        for r in reqs:
            r.wait(timeout=60)
        assert any(r.finish_reason == "error" for r in reqs)
        assert "InjectedFault" in eng.last_error
        assert len(_faults(fault)) == 1
        _after_fault(model, eng)
    finally:
        stop.set()
        th.join(10)


def test_guided_feature_fault_fails_and_the_engine_serves_on(model):
    """``ragged_feature_error`` (``kind=guided``): the fetch of a decode
    dispatch that carried a guided row fails; its requests (the guided one
    and its unguided neighbour) fail, their slots and pages free once."""
    eng = _port(model)
    grammar = grammar_for_request(TOK, {"guided_regex": "[a-z]{4,12}"},
                                  [TOK.eos_token_id])
    chaos.get().inject("ragged_feature_error", times=1, kind="guided")
    stop, th = _serving_thread(eng)
    try:
        plain = eng.submit(TRequest(prompt_ids=_ids("neighbour"),
                                    max_tokens=40, ignore_eos=True))
        guided = eng.submit(TRequest(prompt_ids=_ids("guided"),
                                     max_tokens=20, guided=grammar))
        for r in (plain, guided):
            r.wait(timeout=60)
        assert guided.finish_reason == "error"
        assert len(_faults("ragged_feature_error")) == 1
        _after_fault(model, eng)
    finally:
        stop.set()
        th.join(10)


def test_spec_feature_fault_fails_at_the_verify_read(model):
    """``ragged_feature_error`` (``kind=spec``) at the verify's read:
    nothing is emitted from it, the requests fail, the engine serves on
    (with speculation still on)."""
    eng = _port(model, spec_decode=True, spec_k=3)
    chaos.get().inject("ragged_feature_error", times=1, kind="spec")
    stop, th = _serving_thread(eng)
    try:
        prompt = _ids("abc abc abc abc abc abc abc abc abc")
        r = eng.submit(TRequest(prompt_ids=prompt, max_tokens=40,
                                ignore_eos=True))
        r.wait(timeout=60)
        assert r.finish_reason == "error"
        # the verify's tokens were never read, nor counted
        assert eng.counts["spec_dispatches"] == 0
        assert len(_faults("ragged_feature_error")) == 1
        _after_fault(model, eng, prompt)
        g = eng.submit(TRequest(prompt_ids=prompt, max_tokens=24,
                                ignore_eos=True))
        g.wait(timeout=60)
        assert eng.counts["spec_dispatches"] > 0
        assert g.generated == _undisturbed(model, prompt, max_tokens=24,
                                           ignore_eos=True)
    finally:
        stop.set()
        th.join(10)


def test_kv_offload_error_drops_the_entry_not_the_tokens(model):
    """``kv_offload_error`` corrupts the host-tier entries a restore is
    about to fetch: verification drops them (``kv_restore_dropped``), the
    span re-prefills, and the stream is the cold one and the JAX
    engine's under the same injection."""
    tier = dict(max_decode_slots=4, max_cache_len=64, page_size=8,
                prefill_buckets=(8, 16, 32, 64), kv_pool_pages=10,
                kv_host_tier_bytes=1 << 22)
    rng = np.random.default_rng(11)
    a, b, c = (rng.integers(3, 250, 33).tolist() for _ in range(3))
    out = []
    for eng, req_cls, ch in ((_jax(model, **tier), JRequest, jchaos),
                             (_port(model, **tier), TRequest, chaos)):
        streams = []
        for i, p in enumerate((a, b, c, a)):
            if i == 3:
                ch.get().inject("kv_offload_error", times=1)
            r = eng.submit(req_cls(prompt_ids=p, max_tokens=6,
                                   ignore_eos=True))
            _run(eng)
            streams.append(r.generated)
        assert streams[3] == streams[0]
        out.append((streams, int(eng.metrics.kv_restore_dropped.total())))
    assert out[0] == out[1] and out[1][1] >= 1
    _released(eng)
    assert len(_faults("kv_offload_error")) == 1


@pytest.fixture(scope="module")
def server():
    serving = ServingConfig(model="tiny-qwen3", max_decode_slots=4,
                            max_cache_len=128, page_size=8,
                            prefill_buckets=(16, 32, 64), dtype="float32",
                            prefill_chunk=16, derived_seed=0)
    state = tserver.build_state(serving, device="cpu")
    srv = tserver.make_server(state, "127.0.0.1", 0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    state.start_engine()
    yield "127.0.0.1", srv.server_address[1], state
    srv.shutdown()
    srv.server_close()
    state.stop_engine()
    th.join(10)


def _stream_ids(host, port, body):
    """The token ids of a completed stream, or the bytes read before the
    connection died."""
    conn = socket.create_connection((host, port), timeout=60)
    data = json.dumps({**body, "stream": True}).encode()
    conn.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
                 b"Content-Type: application/json\r\n"
                 + f"Content-Length: {len(data)}\r\n\r\n".encode() + data)
    got = b""
    try:
        while b"data: [DONE]" not in got:
            chunk = conn.recv(65536)
            if not chunk:
                break
            got += chunk
    except ConnectionResetError:
        pass
    finally:
        conn.close()
    ids = []
    for line in got.decode(errors="replace").splitlines():
        if line.startswith("data: {"):
            for c in json.loads(line[6:])["choices"]:
                ids.extend(c.get("token_ids") or [])
    return ids, b"data: [DONE]" in got


def test_kill_stream_resets_the_connection_and_releases(server):
    """``kill_stream`` (``chaos.kill_replica_after_chunks``): after 3
    content chunks the server resets the connection and cancels the
    request; its slot and pages free once, and the next stream of the
    same seeded body is whole and starts with the ids the killed one
    sent."""
    host, port, state = server
    body = {"prompt": "stream me", "max_tokens": 24, "ignore_eos": True,
            "temperature": 0.9, "seed": 3}
    chaos.kill_replica_after_chunks(3)
    killed, done = _stream_ids(host, port, body)
    # three content chunks (a chunk may carry several ids while the
    # detokenizer holds back an incomplete UTF-8 sequence)
    assert not done and 3 <= len(killed) < 24
    _settle(state.engine)
    _released(state.engine)
    assert len(_faults("kill_stream")) == 1
    whole, done = _stream_ids(host, port, body)
    assert done and len(whole) == 24 and whole[:len(killed)] == killed
    _settle(state.engine)
    _released(state.engine)


def _post(host, port, body):
    req = urllib.request.Request(
        f"http://{host}:{port}/v1/completions",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json",
                 "traceparent": "00-0af7651916cd43dd8448eb211c80319c-"
                                "b7ad6b7169203331-01"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


@pytest.mark.parametrize("mode", ["refuse", "5xx", "hang"])
def test_span_export_faults_drop_spans_not_requests(server, mode):
    """A misbehaving collector (``span_export``: refused, 5xx, hung) costs
    the spans (``tpu_serve_spans_dropped_total{reason="export_error"}``),
    never the request."""
    host, port, state = server
    before = tracing.metrics.spans_dropped.value(reason="export_error")
    exporter = tracing.OTLPHTTPExporter("127.0.0.1:9", flush_interval_s=0.05)
    state.tracer = tracing.Tracer("tpu-serve-engine", exporter=exporter)
    chaos.get().inject("span_export", times=-1, mode=mode, hang_s=0.2)
    try:
        status, out = _post(host, port, {"prompt": "spans", "max_tokens": 4})
        assert status == 200 and out["usage"]["trace_id"]
        t0 = time.monotonic()
        while tracing.metrics.spans_dropped.value(reason="export_error") \
                < before + 6 and time.monotonic() - t0 < 20:
            time.sleep(0.02)
    finally:
        state.tracer = None
        chaos.get().clear()
        exporter.shutdown()
    assert tracing.metrics.spans_dropped.value(reason="export_error") >= \
        before + 6
    assert _faults("span_export")


@pytest.mark.parametrize("mode", ["oserror", "hang"])
def test_flight_dump_error_drops_the_dump_not_the_request(server, tmp_path,
                                                          mode):
    """A spool write that fails or hangs (``flight_dump_error``) drops the
    anomaly's dump (``tpu_serve_flight_drops_total{reason="dump_error"}``)
    and keeps the in-memory snapshot; requests succeed."""
    host, port, state = server
    rec = flightrec.configure(spool_dir=str(tmp_path))
    chaos.get().inject("flight_dump_error", times=1, mode=mode, hang_s=0.2)
    before = flightrec.metrics.drops.value(reason="dump_error")
    r = state.engine.submit(TRequest(prompt_ids=_ids("late"), max_tokens=50,
                                     ignore_eos=True, deadline_s=0.001))
    r.wait(timeout=30)
    assert r.finish_reason == "timeout"
    assert rec.flush(10)
    assert flightrec.metrics.drops.value(reason="dump_error") == before + 1
    assert rec.dump_for(r.id)["reason"] == "timeout"
    assert not (tmp_path / "flight.jsonl").exists()
    status, _ = _post(host, port, {"prompt": "fine", "max_tokens": 3})
    assert status == 200
    flightrec.configure()


def test_capacity_export_error_drops_a_refresh_not_the_render(server):
    """``capacity_export_error`` in a ``/metrics`` render: the render
    answers 200 with the previous gauge values and counts the drop."""
    host, port, state = server
    before = capacity.metrics.export_drops.total()
    chaos.get().inject("capacity_export_error", times=1)
    with urllib.request.urlopen(f"http://{host}:{port}/metrics",
                                timeout=60) as r:
        text = r.read().decode()
        assert r.status == 200
    assert "tpu_capacity_offered_tps" in text
    assert capacity.metrics.export_drops.total() == before + 1
    assert _faults("capacity_export_error")
