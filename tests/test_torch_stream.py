"""The port's SSE streaming on the CPU against the JAX server's, on the same
weights (tiny_qwen3 scaled by 8, the byte tokenizer): both servers in
process on free ports, the same bodies to both. The parsed events are
compared after dropping ``id`` and ``created`` (and the JAX server's trace
ids in ``usage``; the port has no tracing), the logprobs within 1e-4 (the
JAX and torch log-softmax round apart); the events of an ``n`` > 1 stream
are compared choice by choice (the handler interleaves the choices as
their tokens arrive). Also: a streamed answer equals the non-streamed one,
and a client that hangs up mid-stream frees its slot.
"""

import copy
import http.client
import json
import time
import urllib.error
import urllib.request

import pytest
import torch
from test_torch_server import (_bare_ids, _post,  # noqa: F401
                               _same_logprobs, _same_top, jax_server,
                               twin_server)

torch.set_num_threads(2)


def _stream(url, body, timeout=120):
    """POST ``body``; (status, Content-Type, events): each ``data:`` line
    parsed (``"[DONE]"`` kept as the string), or the error's JSON."""
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            raw = r.read().decode()
            ctype = r.headers["Content-Type"]
            status = r.status
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], json.loads(e.read())
    events = [ln[len("data: "):] for ln in raw.split("\n")
              if ln.startswith("data: ")]
    return status, ctype, [e if e == "[DONE]" else json.loads(e)
                           for e in events]


def _norm(ev):
    """An event without ``id``, ``created`` and the usage's trace ids; its
    choices' logprobs taken out and returned beside it."""
    if ev == "[DONE]":
        return ev, []
    ev = copy.deepcopy(ev)
    ev.pop("id")
    ev.pop("created")
    if ev.get("usage"):
        ev["usage"] = {k: ev["usage"][k] for k in (
            "prompt_tokens", "completion_tokens", "total_tokens")}
    return ev, [c.pop("logprobs", None) for c in ev["choices"]]


def _same_chat_lp(got, want):
    """Two chat logprobs payloads alike: tokens equal, logprobs within
    1e-4, each entry's top list by :func:`_same_top`."""
    if got is None or want is None:
        return got == want
    if len(got["content"]) != len(want["content"]):
        return False
    for g, w in zip(got["content"], want["content"]):
        if g["token"] != w["token"] or abs(g["logprob"] - w["logprob"]) \
                >= 1e-4 or len(g["top_logprobs"]) != len(w["top_logprobs"]):
            return False
        if not _same_top({e["token"]: e["logprob"]
                          for e in g["top_logprobs"]},
                         {e["token"]: e["logprob"]
                          for e in w["top_logprobs"]}):
            return False
    return True


def _same_lp(got, want):
    if (got and "content" in got) or (want and "content" in want):
        return _same_chat_lp(got, want)
    return _same_logprobs(got, want)


def _by_choice(events):
    """The events grouped by choice index, in order, and the others (the
    usage chunk, ``[DONE]``) in order."""
    groups, rest = {}, []
    for ev in events:
        if ev != "[DONE]" and len(ev["choices"]) == 1:
            groups.setdefault(ev["choices"][0]["index"], []).append(ev)
        else:
            rest.append(ev)
    return groups, rest


def assert_same_events(got, want):
    """The port's events are the JAX server's (see the module docstring)."""
    (gg, grest), (wg, wrest) = _by_choice(got), _by_choice(want)
    assert sorted(gg) == sorted(wg)
    pairs = [(g, w) for i in wg for g, w in zip(gg[i], wg[i])] + \
        list(zip(grest, wrest))
    assert [len(gg[i]) for i in sorted(gg)] + [len(grest)] == \
        [len(wg[i]) for i in sorted(wg)] + [len(wrest)], (got, want)
    for g, w in pairs:
        (gn, glp), (wn, wlp) = _norm(g), _norm(w)
        assert gn == wn, (g, w)
        assert all(_same_lp(a, b) for a, b in zip(glp, wlp)), (g, w)


def stream_text(events, index=0):
    """(the text, the token ids, the finish reason) of one choice."""
    text, ids, finish = "", [], None
    for ev in events:
        if ev == "[DONE]":
            continue
        for c in ev["choices"]:
            if c["index"] != index:
                continue
            text += c.get("text") or (c.get("delta") or {}).get("content") \
                or ""
            ids += c.get("token_ids") or []
            finish = c["finish_reason"] or finish
    return text, ids, finish


_BASE = {"prompt": "Hi! How are you?", "max_tokens": 12, "ignore_eos": True,
         "stream": True}
_SEEDED = {"seed": 5, "temperature": 0.9}

# the streamed bodies, each as a function of the bare greedy stream's ids
# and text
_CASES = {
    "greedy": lambda ids, text: {},
    "seeded": lambda ids, text: dict(_SEEDED),
    "n-2": lambda ids, text: {"n": 2, **_SEEDED},
    "n-2-logprobs": lambda ids, text: {"n": 2, "logprobs": 1, **_SEEDED},
    "echo": lambda ids, text: {"echo": True},
    "echo-logprobs": lambda ids, text: {"echo": True, "logprobs": 2},
    "logprobs-2": lambda ids, text: {"logprobs": 2},
    "logprobs-0": lambda ids, text: {"logprobs": 0, **_SEEDED},
    "include_usage": lambda ids, text: {
        "stream_options": {"include_usage": True}},
    "include_usage-n-2": lambda ids, text: {
        "n": 2, "stream_options": {"include_usage": True}, **_SEEDED},
    # a stop string of three characters spans three tokens' chunks
    "stop-across-chunks": lambda ids, text: {"stop": [text[4:7], "never"]},
    "stop-logprobs": lambda ids, text: {"stop": text[5:7], "logprobs": 1},
    "stop_token_ids": lambda ids, text: {"stop_token_ids": [ids[6]],
                                         "min_tokens": 2},
    "penalties": lambda ids, text: {"presence_penalty": 1.5,
                                    "repetition_penalty": 1.3, **_SEEDED},
    # byte tokens 0xC3 and 0xA9 made likely: "é" split over two tokens,
    # beside incomplete sequences the detokenizer holds back
    "utf8-split": lambda ids, text: {"logit_bias": {"195": 9, "169": 9},
                                     "max_tokens": 24, "seed": 1,
                                     "temperature": 1.0},
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_stream_events_like_the_jax_server(twin_server, jax_server, case):
    """Each streamed body gets the JAX server's events: ``text/event-stream``,
    the same chunks (text held back over incomplete UTF-8 and stop-string
    prefixes, ``token_ids``, per-token logprob records, the echoed prompt,
    finish reasons, the usage chunk) and ``[DONE]``; the concatenated text
    and ids equal the non-streamed answer's."""
    (base, state), (jbase, _) = twin_server, jax_server
    ids = _bare_ids(state)
    body = {**_BASE, **_CASES[case](ids, state.tokenizer.decode(ids))}
    got = _stream(base + "/v1/completions", body)
    want = _stream(jbase + "/v1/completions", body)
    assert got[0] == want[0] == 200, (got, want)
    assert got[1].startswith("text/event-stream")
    assert got[2][-1] == "[DONE]" and got[2].count("[DONE]") == 1
    assert_same_events(got[2], want[2])
    full = _post(base + "/v1/completions", {**body, "stream": False,
                                            "stream_options": None})[1]
    for c in full["choices"]:
        if body.get("stop") and "logprobs" in body:
            # per-token chunks cut at a stop string without holding text
            # back, on the text decoded so far (the JAX server's too)
            break
        s_text, s_ids, s_fin = stream_text(got[2], c["index"])
        assert s_text == c["text"] and s_fin == c["finish_reason"], (c, s_text)
        if not body.get("stop") and not body.get("echo"):
            assert len(s_ids) == full["usage"]["completion_tokens"] // \
                body.get("n", 1)
    if case == "utf8-split":
        s_text, s_ids, _ = stream_text(got[2])
        assert "é" in s_text and any(
            len(c["choices"][0].get("token_ids") or []) > 1
            for c in got[2][:-1])
    if "include_usage" in case:
        usage = got[2][-2]
        assert usage["choices"] == [] and "failover" not in usage
        assert usage["usage"]["completion_tokens"] == \
            full["usage"]["completion_tokens"]
        assert all(ev["usage"] is None for ev in got[2][:-2])


def test_client_disconnect_mid_stream_frees_its_slot(twin_server):
    """A client that reads two events of a long stream and hangs up: the
    broken pipe cancels the engine request, and the slot and its pages come
    back."""
    base, state = twin_server
    eng = state.engine
    host, port = base.split("//")[1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=60)
    conn.request("POST", "/v1/completions", body=json.dumps({
        **_BASE, "max_tokens": 100}),
        headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200
    seen = 0
    while seen < 2:
        if resp.fp.readline().startswith(b"data: "):
            seen += 1
    assert eng._active_slots()
    conn.close()
    t0 = time.monotonic()
    while eng._active_slots() or eng.pending:
        assert time.monotonic() - t0 < 60, "the slot was not released"
        time.sleep(0.02)
    assert eng.allocator.stats()["pages_live"] == 0


# -- the engine's stream queue: every token once, then one None ---------------


@pytest.fixture(scope="module")
def stream_model():
    from aws_k8s_ansible_provisioner_tpu_torch.config import tiny_qwen3
    from aws_k8s_ansible_provisioner_tpu_torch.models.layers import \
        init_params

    cfg = tiny_qwen3()
    return cfg, init_params(cfg, torch.Generator().manual_seed(0),
                            torch.float32)


def _engine(stream_model, **kw):
    from aws_k8s_ansible_provisioner_tpu_torch.config import ServingConfig
    from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import Engine

    cfg, params = stream_model
    serving = ServingConfig(**{
        "max_decode_slots": 2, "max_cache_len": 128, "page_size": 8,
        "prefill_buckets": (16, 32), "dtype": "float32",
        "prefill_chunk": 16, "derived_seed": 0,
        "admission_preempt_after_s": 0, **kw})
    return Engine(cfg, params, serving, device="cpu")


def _queued(req):
    """Everything on the request's queue, without waiting."""
    items = []
    while not req.out_queue.empty():
        items.append(req.out_queue.get_nowait())
    return items


def _steps(eng, n):
    for _ in range(n):
        eng.step()


# each scenario: engine options, then a function of (engine, Request) that
# runs it and returns the streamed requests with their finish reason
def _length(eng, Request):
    r = eng.submit(Request(prompt_ids=[5, 6, 7], max_tokens=9,
                           ignore_eos=True, stream=True))
    eng.run_until_idle()
    return [(r, "length")]


def _stop(eng, Request):
    ref = eng.submit(Request(prompt_ids=[5, 6, 7], max_tokens=6,
                             ignore_eos=True))
    eng.run_until_idle()
    r = eng.submit(Request(prompt_ids=[5, 6, 7], max_tokens=6,
                           ignore_eos=True, stream=True,
                           stop_token_ids=(ref.generated[3],)))
    eng.run_until_idle()
    return [(r, "stop")]


def _chunked(eng, Request):
    # the mixed chunk's token is the first; decode horizons give the rest
    r = eng.submit(Request(prompt_ids=list(range(3, 43)), max_tokens=12,
                           ignore_eos=True, stream=True, logprobs=1))
    eng.run_until_idle()
    assert eng.counts["mixed_dispatches"] >= 3
    return [(r, "length")]


def _spec(eng, Request):
    r = eng.submit(Request(prompt_ids=[9, 10, 11, 12] * 6, max_tokens=24,
                           ignore_eos=True, stream=True))
    eng.run_until_idle()
    assert eng.counts["spec_dispatches"] > 0
    return [(r, "length")]


def _cancel(eng, Request):
    running = eng.submit(Request(prompt_ids=[5, 6], max_tokens=100,
                                 ignore_eos=True, stream=True))
    other = eng.submit(Request(prompt_ids=[7, 8], max_tokens=100,
                               ignore_eos=True, stream=True))
    queued = eng.submit(Request(prompt_ids=[9, 10], max_tokens=100,
                                ignore_eos=True, stream=True))
    _steps(eng, 4)
    eng.cancel(running)
    eng.cancel(queued)
    _steps(eng, 2)
    eng.cancel(other)
    eng.run_until_idle()
    return [(running, "cancelled"), (other, "cancelled"),
            (queued, "cancelled")]


def _deadline(eng, Request):
    r = eng.submit(Request(prompt_ids=[5, 6], max_tokens=100,
                           ignore_eos=True, stream=True, deadline_s=0.05))
    q = eng.submit(Request(prompt_ids=[5, 6], max_tokens=100,
                           ignore_eos=True, stream=True, deadline_s=0.05))
    w = eng.submit(Request(prompt_ids=[5, 6], max_tokens=100,
                           ignore_eos=True, stream=True, deadline_s=0.05))
    _steps(eng, 2)
    time.sleep(0.1)
    eng.run_until_idle()
    return [(r, "timeout"), (q, "timeout"), (w, "timeout")]


def _drain(eng, Request):
    r = eng.submit(Request(prompt_ids=[5, 6], max_tokens=100,
                           ignore_eos=True, stream=True))
    _steps(eng, 2)
    eng.begin_drain(0.0)
    eng.run_until_idle()
    return [(r, "timeout")]


def _failed_step(eng, Request):
    r = eng.submit(Request(prompt_ids=[5, 6], max_tokens=100,
                           ignore_eos=True, stream=True))
    walk = eng.submit(Request(prompt_ids=list(range(3, 43)),
                              max_tokens=100, ignore_eos=True, stream=True))
    q = eng.submit(Request(prompt_ids=[7], max_tokens=100, ignore_eos=True,
                           stream=True))
    _steps(eng, 3)
    eng._fail_all()            # what run_forever does when a step raises
    return [(r, "error"), (walk, "error"), (q, "error")]


def _preempted(eng, Request):
    rs = [eng.submit(Request(prompt_ids=[5 + i, 6], max_tokens=40,
                             ignore_eos=True, stream=True, seed=i,
                             temperature=0.8)) for i in range(2)]
    _steps(eng, 4)
    eng._preempt(eng._active_slots()[-1])
    eng.run_until_idle()
    assert eng.counts["preemptions"] >= 1
    return [(r, "length") for r in rs]


def _continuation(eng, Request):
    ref = eng.submit(Request(prompt_ids=[5, 6, 7], max_tokens=12,
                             seed=3, temperature=0.9, ignore_eos=True))
    eng.run_until_idle()
    r = eng.submit(Request(prompt_ids=[5, 6, 7], max_tokens=12, seed=3,
                           temperature=0.9, ignore_eos=True, stream=True,
                           resume_ids=tuple(ref.generated[:5])))
    eng.run_until_idle()
    assert r.generated == ref.generated
    return [(r, "length")]


_SCENARIOS = {
    "length": ({}, _length),
    "stop": ({}, _stop),
    "chunk": ({}, _chunked),
    "verify": ({"spec_decode": True}, _spec),
    "cancel": ({}, _cancel),
    "deadline": ({"max_decode_slots": 1}, _deadline),
    "drain": ({}, _drain),
    "failed-step": ({"max_decode_slots": 1}, _failed_step),
    "preemption": ({}, _preempted),
    "continuation": ({}, _continuation),
}


@pytest.mark.parametrize("pipeline", [1, 0])
@pytest.mark.parametrize("case", sorted(_SCENARIOS))
def test_stream_queue_gets_each_token_once_then_one_none(stream_model,
                                                         case, pipeline):
    """A streamed request's queue holds each token it generated, in order
    and once (after its logprob record; a continuation's relayed tokens and
    a preemption's rebuild put nothing), then exactly one None, whatever
    ends it: the budget, a stop id, a cancel (running or queued), a
    deadline (running or queued), a drain's reap, a failed step (running,
    in the chunk walk, queued); with tokens from the decode horizon, the
    mixed chunk and the verify."""
    from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import Request

    opts, scenario = _SCENARIOS[case]
    eng = _engine(stream_model, decode_pipeline=pipeline, **opts)
    for req, finish in scenario(eng, Request):
        items = _queued(req)
        assert req.finish_reason == finish
        assert items[-1] is None and items.count(None) == 1
        assert items[:-1] == req.generated[len(req.resume_ids):]
        if req.logprobs is not None:
            assert len(req.logprob_data) == len(req.generated)
