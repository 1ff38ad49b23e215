"""The failover continuation (``resume_token_ids``) of the port on the CPU:
two port servers on the same weights (tiny_qwen3 scaled by 8, the byte
tokenizer) and the JAX server beside them. A stream cut after k events on
one server and re-issued to the other as the JAX router re-issues it (the
ids and characters received, ``max_tokens`` decremented) splices into the
undisturbed stream, text and ids, greedy, seeded and penalized; the
continuation's events are the JAX server's for the same body. Then the
JAX router and the port's (``serving/router.py`` of either package imports
no JAX) in front of two port replicas, with the router's
``stream_read_error`` fault: the client's stream is the undisturbed one,
one failover is counted, and both engines quiesce.
"""

import http.client
import json
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer

import pytest
import torch
from test_torch_server import (_jax_params, jax_server,  # noqa: F401
                               twin_server)
from test_torch_stream import _stream, assert_same_events, stream_text

torch.set_num_threads(2)


def _port_server(jstate):
    """A port server over the JAX server's weights, as ``twin_server``
    builds it; returns (base URL, state, stop function)."""
    import dataclasses

    import jax
    import numpy as np

    from aws_k8s_ansible_provisioner_tpu_torch.config import (ModelConfig,
                                                              ServingConfig)
    from aws_k8s_ansible_provisioner_tpu_torch.models.convert import \
        from_jax_params
    from aws_k8s_ansible_provisioner_tpu_torch.serving.server import (
        build_state, make_server)
    from aws_k8s_ansible_provisioner_tpu_torch.utils.tokenizer import \
        ByteTokenizer

    cfg = ModelConfig(**dataclasses.asdict(jstate.engine.cfg))
    params = from_jax_params(jax.tree.map(np.asarray, _jax_params(
        jstate.engine.cfg)), cfg)
    serving = ServingConfig(weights_dtype="bf16", model="tiny-qwen3",
                            max_decode_slots=4, max_cache_len=128,
                            page_size=8, prefill_buckets=(16, 32, 64),
                            dtype="float32", prefill_chunk=16,
                            derived_seed=0)
    state = build_state(serving, model_cfg=cfg, params=params,
                        tokenizer=ByteTokenizer(), device="cpu")
    srv = make_server(state, "127.0.0.1", 0)
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
def second_server(jax_server):
    base, state, stop = _port_server(jax_server[1])
    yield base, state
    stop()


def _quiesced(state, timeout=60.0):
    """Wait until the engine has no active slot and no queue."""
    eng = state.engine
    t0 = time.monotonic()
    while eng._active_slots() or eng.pending or eng._chunk is not None:
        assert time.monotonic() - t0 < timeout, "the engine did not quiesce"
        time.sleep(0.02)


def _read_k(base, body, k):
    """The first ``k`` content events of a stream (those with
    ``token_ids``), then the connection closed as a dying replica's is."""
    host, port = base.split("//")[1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=60)
    conn.request("POST", "/v1/completions", body=json.dumps(body),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200
    events = []
    while len(events) < k:
        line = resp.fp.readline()
        assert line, "the stream ended before k events"
        if line.startswith(b"data: {"):
            ev = json.loads(line[len(b"data: "):])
            if any(c.get("token_ids") for c in ev["choices"]):
                events.append(ev)
    conn.close()
    return events


def _continuation(body, events):
    """The JAX router's continuation body after relaying ``events``."""
    ids = [t for ev in events for c in ev["choices"]
           for t in c.get("token_ids") or []]
    chars = sum(len(c.get("text") or (c.get("delta") or {}).get("content")
                    or "") for ev in events for c in ev["choices"])
    out = {**body, "resume_token_ids": ids, "resume_text_chars": chars}
    if "max_tokens" in body:
        out["max_tokens"] = max(0, body["max_tokens"] - len(ids))
    return out


_BASE = {"prompt": "Hi! How are you?", "max_tokens": 20, "ignore_eos": True,
         "stream": True}
_RESUMES = {
    "greedy": {},
    "seeded": {"seed": 1000, "temperature": 0.7},
    "penalized": {"seed": 7, "temperature": 0.9, "presence_penalty": 1.5,
                  "frequency_penalty": 0.5, "repetition_penalty": 1.3},
    "logprobs": {"logprobs": 2, "seed": 4, "temperature": 0.8},
    "stop-string": {"stop": ["zzz"], "seed": 12, "temperature": 0.8},
    "include_usage": {"stream_options": {"include_usage": True},
                      "seed": 3, "temperature": 0.9},
}


@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("case", sorted(_RESUMES))
def test_continuation_splices_into_the_undisturbed_stream(
        twin_server, second_server, jax_server, case, k):
    """A stream read for k events on one port server, whose connection is
    then closed (the server frees the slot), and re-issued to a second port
    server as a continuation: the client's text and ids are the undisturbed
    stream's and the JAX server's; the continuation's events (no role or
    echo chunk; usage counting the relayed tokens, ``failover: true``) are
    the JAX server's for the same body."""
    (a, a_state), (b, _), (jbase, _) = twin_server, second_server, \
        jax_server
    body = {**_BASE, **_RESUMES[case]}
    whole = _stream(a + "/v1/completions", body)[2]
    jwhole = _stream(jbase + "/v1/completions", body)[2]
    assert_same_events(whole, jwhole)
    head = _read_k(a, body, k)
    _quiesced(a_state)
    cont_body = _continuation(body, head)
    got = _stream(b + "/v1/completions", cont_body)
    want = _stream(jbase + "/v1/completions", cont_body)
    assert got[0] == want[0] == 200, (got, want)
    assert_same_events(got[2], want[2])
    spliced = head + got[2]
    assert stream_text(spliced) == stream_text(whole)
    assert len(stream_text(whole)[1]) == body["max_tokens"]
    if "stream_options" in body:
        usage = got[2][-2]
        assert usage["failover"] is True
        assert usage["usage"]["completion_tokens"] == body["max_tokens"]


def test_chat_continuation_splices(twin_server, second_server, jax_server):
    """The same on the chat route: the continuation sends no role chunk."""
    (a, _), (b, _), (jbase, _) = twin_server, second_server, jax_server
    body = {"messages": [{"role": "user", "content": "Hi!"}],
            "max_tokens": 12, "ignore_eos": True, "stream": True,
            "seed": 21}
    url = "/v1/chat/completions"
    whole = _stream(a + url, body)[2]
    head = [ev for ev in whole if ev != "[DONE]"
            and any(c.get("token_ids") for c in ev["choices"])][:4]
    cont = _continuation(body, head)
    got, want = _stream(b + url, cont), _stream(jbase + url, cont)
    assert_same_events(got[2], want[2])
    assert all("role" not in c["delta"] for ev in got[2][:-1]
               for c in ev["choices"])
    assert stream_text(head + got[2]) == stream_text(whole)


@pytest.mark.parametrize("case", ["stop-id", "eos", "length", "min_tokens"])
def test_relayed_ids_that_end_the_stream_admit_nothing(
        twin_server, second_server, jax_server, case):
    """Relayed ids that already meet a stop condition (a stop id past
    ``min_tokens``, the EOS, the budget): the finish chunk, usage and
    ``[DONE]`` alone, as the JAX server answers, with nothing admitted;
    below ``min_tokens`` a stop id does not end it."""
    (_, a_state), (b, b_state), (jbase, _) = twin_server, second_server, \
        jax_server
    eos = a_state.engine.eos_token_id
    body = {**_BASE, "stream_options": {"include_usage": True},
            "max_tokens": 3, "resume_text_chars": 3}
    body.update({
        "stop-id": {"stop_token_ids": [77], "resume_token_ids": [65, 77],
                    "max_tokens": 8},
        "eos": {"ignore_eos": False, "resume_token_ids": [65, eos],
                "max_tokens": 8},
        "length": {"resume_token_ids": [65, 66, 67], "max_tokens": 0},
        "min_tokens": {"stop_token_ids": [77], "min_tokens": 3,
                       "resume_token_ids": [65, 77], "max_tokens": 2},
    }[case])
    admitted = b_state.engine.counts["mixed_dispatches"]
    got = _stream(b + "/v1/completions", body)
    want = _stream(jbase + "/v1/completions", body)
    assert got[0] == want[0] == 200
    assert_same_events(got[2], want[2])
    _quiesced(b_state)
    if case == "min_tokens":
        assert b_state.engine.counts["mixed_dispatches"] > admitted
        return
    assert b_state.engine.counts["mixed_dispatches"] == admitted
    assert len(got[2]) == 3 and got[2][1]["failover"] is True
    assert got[2][0]["choices"][0]["finish_reason"] == (
        "length" if case == "length" else "stop")


def test_continuation_is_refused_on_the_dense_engine():
    """The continuation rides the paged engine's resume: the dense engine
    refuses it, as the JAX engine does."""
    from aws_k8s_ansible_provisioner_tpu_torch.config import (ServingConfig,
                                                              tiny_qwen3)
    from aws_k8s_ansible_provisioner_tpu_torch.models.layers import \
        init_params
    from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import (
        ContextLengthExceeded, Engine, Request)

    cfg = tiny_qwen3()
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         torch.float32)
    dense = Engine(cfg, params, ServingConfig(
        paged=False, max_decode_slots=2, max_cache_len=64, dtype="float32",
        prefill_buckets=(16, 32)), device="cpu")
    with pytest.raises(ValueError, match="requires the paged engine"):
        dense.submit(Request(prompt_ids=[1, 2], resume_ids=(3,)))
    paged = Engine(cfg, params, ServingConfig(
        max_decode_slots=2, max_cache_len=64, dtype="float32", page_size=8,
        prefill_buckets=(16, 32)), device="cpu")
    with pytest.raises(ContextLengthExceeded):
        paged.submit(Request(prompt_ids=[1] * 40, resume_ids=(3,) * 23))
    with pytest.raises(ValueError, match="resume token ids"):
        paged.submit(Request(prompt_ids=[1, 2], resume_ids=(cfg.vocab_size,)))
    req = paged.submit(Request(prompt_ids=[1, 2], resume_ids=(3, 4),
                               max_tokens=5, stream=True, ignore_eos=True))
    paged.run_until_idle()
    assert req.generated[:2] == [3, 4] and len(req.generated) == 5
    streamed = []
    while True:
        item = req.out_queue.get(timeout=5)
        if item is None:
            break
        streamed.append(item)
    # only the new tokens reach the queue
    assert streamed == req.generated[2:]


@pytest.fixture(params=["jax", "port"])
def router_stack(request, jax_server):
    """The JAX router or the port's (``serving/router.py`` of either
    package), with its load poller, in front of two fresh port replicas;
    yields (router URL, the replicas' (base, state), the router module,
    the chaos module it fires)."""
    import importlib

    pkg = {"jax": "aws_k8s_ansible_provisioner_tpu",
           "port": "aws_k8s_ansible_provisioner_tpu_torch"}[request.param]
    rt = importlib.import_module(pkg + ".serving.router")
    chaos = importlib.import_module(pkg + ".serving.chaos")
    replicas = [_port_server(jax_server[1]) for _ in range(2)]
    addrs = ",".join(base.split("//")[1] for base, _, _ in replicas)
    H = rt.RouterHandler
    old = H.pool, H.metrics
    H.pool = rt.BackendPool(addrs, cooldown_s=5.0)
    H.metrics = rt.RouterMetrics()
    poll_stop = threading.Event()
    rt.start_load_poller(H.pool, interval_s=0.2, stop=poll_stop)
    router = ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=router.serve_forever, daemon=True).start()
    yield (f"http://127.0.0.1:{router.server_port}",
           [(base, state) for base, state, _ in replicas], rt, chaos)
    poll_stop.set()
    router.shutdown()
    router.server_close()
    for _, _, stop in replicas:
        stop()
    H.pool, H.metrics = old


@pytest.mark.parametrize("sampling", [{}, {"seed": 4242,
                                           "temperature": 0.7}],
                         ids=["greedy", "seeded"])
def test_router_fails_a_stream_over_to_a_port_replica(router_stack,
                                                      sampling):
    """The router's ``stream_read_error`` fault (a reset on the SSE
    relay's backend read after 3 events; the JAX router's and the port's)
    fails the stream over to the other port replica as a continuation: the
    client's stream equals an undisturbed run through the router, ids and
    text, with ``[DONE]``; one ``tpu_router_stream_failovers_total``; both
    port engines quiesce (``/load``: 0 active, 0 queued)."""
    rurl, replicas, rt, chaos = router_stack
    RouterHandler = rt.RouterHandler
    payload = {"model": "tiny-qwen3", "prompt": "read error scenario",
               "max_tokens": 16, "stream": True, "ignore_eos": True,
               **sampling}
    try:
        ref = _stream(rurl + "/v1/completions", payload)
        assert ref[0] == 200 and ref[2][-1] == "[DONE]"
        assert len(stream_text(ref[2])[1]) == 16
        chaos.reset()
        chaos.get().inject("stream_read_error", times=1, after_events=3)
        got = _stream(rurl + "/v1/completions", payload)
        assert chaos.get().stats()["stream_read_error"]["fired"] == 1
    finally:
        chaos.reset()
    assert got[0] == 200 and got[2][-1] == "[DONE]"
    assert stream_text(got[2]) == stream_text(ref[2])
    assert RouterHandler.metrics.stream_failovers.total() == 1
    for base, state in replicas:
        _quiesced(state)
        t0 = time.monotonic()
        while True:
            with urllib.request.urlopen(base + "/load", timeout=10) as r:
                load = json.loads(r.read())
            if load["active"] == 0 and load["queued"] == 0:
                break
            assert time.monotonic() - t0 < 30, load
            time.sleep(0.05)
