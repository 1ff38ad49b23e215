"""The replica lifecycle of the port against the JAX package: drain and
undrain, end-to-end deadlines, admission control (queue bound, estimated
wait), the admission-pressure preemption and the stall watchdog, engine by
engine and over HTTP.

tiny_qwen3 (the byte tokenizer's vocabulary) at float32 on the same scaled
weights, as in ``test_torch_engine.py``. Each engine-level scenario runs on
both engines, which must give the same finish reasons, shed reasons,
counters and streams, and then hold every slot and page free (a slot or a
page released twice would show in the free list or raise). The scenarios
drive ``step()`` by hand, with explicit sleeps or deadlines set between
steps, as the JAX package's drain and chaos tests do; the HTTP tests run
both servers in process on free ports (port 0), with the same bodies.
"""

import dataclasses
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aws_k8s_ansible_provisioner_tpu.config import ServingConfig as JServing
from aws_k8s_ansible_provisioner_tpu.config import tiny_qwen3 as jax_tiny
from aws_k8s_ansible_provisioner_tpu.models.layers import init_params
from aws_k8s_ansible_provisioner_tpu.serving.engine import Engine as JEngine
from aws_k8s_ansible_provisioner_tpu.serving.engine import \
    EngineOverloaded as JOverloaded
from aws_k8s_ansible_provisioner_tpu.serving.engine import Request as JRequest
from aws_k8s_ansible_provisioner_tpu.utils.tokenizer import \
    ByteTokenizer as JByteTokenizer
from aws_k8s_ansible_provisioner_tpu_torch.config import ModelConfig
from aws_k8s_ansible_provisioner_tpu_torch.config import \
    ServingConfig as TServing
from aws_k8s_ansible_provisioner_tpu_torch.models.convert import \
    from_jax_params
from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import \
    Engine as TEngine
from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import \
    EngineOverloaded as TOverloaded
from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import \
    Request as TRequest
from aws_k8s_ansible_provisioner_tpu_torch.utils.tokenizer import \
    ByteTokenizer

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOK = ByteTokenizer()
# the JAX drain tests' engine (tests/test_drain.py) and the chaos tests'
# (tests/test_chaos.py)
DRAIN = dict(weights_dtype="bf16", max_decode_slots=4, max_cache_len=64,
             prefill_buckets=(8, 16, 32), dtype="float32",
             drain_timeout_s=30.0, derived_seed=0)
CHAOS = dict(weights_dtype="bf16", max_decode_slots=2, max_cache_len=128,
             page_size=32, prefill_buckets=(16, 32, 64, 128),
             dtype="float32", derived_seed=0)


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


def _engines(model, **serving):
    jcfg, jp, tcfg, tp = model
    return (JEngine(jcfg, jp, JServing(**serving)),
            TEngine(tcfg, tp, TServing(**serving), device="cpu"))


def _run(eng, max_steps=10000):
    for _ in range(max_steps):
        if not eng.step():
            return
    raise AssertionError("engine did not go idle")


def _released(je, te):
    """Every slot and page of both engines is free, nothing is queued,
    chunking or in flight."""
    st = je.sched.stats()
    assert st.active_slots == 0 and st.queue_depth == 0, st
    assert je._chunk is None and not any(je.slot_req)
    if je.paged:
        assert all(a.stats()["pages_live"] == 0 for a in je.allocators)
        assert all(not p for p in je._slot_pages)
    assert sorted(te._free) == list(range(te.num_slots)), te._free
    assert not te._queue and te._chunk is None and te._inflight is None
    assert not any(te.slot_req) and not te._resume_ctx
    if te.paged:
        assert te.allocator.stats()["pages_live"] == 0
        assert all(not p for p in te._slot_pages)


def _totals(eng) -> dict:
    """The lifecycle counters both engines keep in ``metrics``."""
    m = eng.metrics
    out = {name: int(getattr(m, name).total()) for name in (
        "deadline_expired", "requests_shed", "admission_preemptions",
        "preemptions", "generated_tokens", "prompt_tokens")}
    out["status"] = {s: int(m.request_total.value(status=s)) for s in (
        "success", "timeout", "cancelled", "error")}
    out["shed"] = {r: int(m.requests_shed.value(reason=r)) for r in (
        "draining", "queue_full", "est_wait")}
    return out


def _both(model, scenario, **serving):
    """Run ``scenario(engine, Request, EngineOverloaded)`` on both engines:
    the records and the lifecycle counters must be equal, and every slot
    and page free afterwards. Returns the port's record and engine."""
    je, te = _engines(model, **serving)
    want = scenario(je, JRequest, JOverloaded)
    got = scenario(te, TRequest, TOverloaded)
    assert got == want
    assert _totals(te) == _totals(je)
    _released(je, te)
    return got, te


# -- the drain state machine (tests/test_drain.py) ---------------------------


def _sheds_while_draining(eng, Request, Overloaded):
    t = eng.begin_drain()
    with pytest.raises(Overloaded) as ei:
        eng.submit(Request(prompt_ids=[1, 2, 3], max_tokens=4))
    eng.end_drain()
    req = eng.submit(Request(prompt_ids=[1, 2, 3], max_tokens=4,
                             ignore_eos=True))
    _run(eng)
    return {"t": round(t), "reason": ei.value.reason,
            "retry": ei.value.retry_after_s >= 1.0,
            "draining": eng.draining, "finish": req.finish_reason,
            "tokens": req.generated}


def test_draining_engine_sheds_new_submits(model):
    got, _ = _both(model, _sheds_while_draining, **DRAIN)
    assert got["t"] == 30 and got["reason"] == "draining" and got["retry"]
    assert got["finish"] == "length" and not got["draining"]


def _drain_finishes_active(eng, Request, Overloaded):
    reqs = [eng.submit(Request(prompt_ids=[2 + i, 5, 9], max_tokens=6,
                               ignore_eos=True)) for i in range(3)]
    eng.step()                      # admit (batched prefill)
    eng.begin_drain()               # drain with 3 active generations
    _run(eng)
    return {"finish": [r.finish_reason for r in reqs],
            "tokens": [r.generated for r in reqs], "draining": eng.draining}


@pytest.mark.parametrize("paged", [True, False])
def test_drain_finishes_active_requests(model, paged):
    got, _ = _both(model, _drain_finishes_active, paged=paged, **DRAIN)
    assert got["finish"] == ["length"] * 3
    assert all(len(t) == 6 for t in got["tokens"]) and got["draining"]


def _drain_timeout(eng, Request, Overloaded):
    active = [eng.submit(Request(prompt_ids=[3, 1, 4], max_tokens=40,
                                 ignore_eos=True)) for _ in range(2)]
    eng.step()                      # both admitted
    queued = eng.submit(Request(prompt_ids=[2, 7], max_tokens=40,
                                ignore_eos=True))
    eng.begin_drain(timeout_s=0.05)
    time.sleep(0.08)                # the drain deadline passes
    _run(eng)
    expired = eng.metrics.deadline_expired.total()
    eng._reap_expired()             # a second reap finds nothing
    return {"finish": [r.finish_reason for r in active + [queued]],
            "tokens": [r.generated for r in active + [queued]],
            "expired": expired,
            "again": eng.metrics.deadline_expired.total() - expired}


@pytest.mark.parametrize("paged", [True, False])
def test_drain_timeout_cancels_stragglers_exactly_once(model, paged):
    """Past the drain deadline the reap cancels the running and the queued
    requests, each counted once, and a second reap does nothing."""
    got, _ = _both(model, _drain_timeout, paged=paged,
                   **{**DRAIN, "max_decode_slots": 2})
    assert got["finish"] == ["timeout"] * 3
    assert all(0 < len(t) < 40 for t in got["tokens"][:2])
    assert got["tokens"][2] == []
    assert got["expired"] == 3 and got["again"] == 0


def _drain_tightens(eng, Request, Overloaded):
    r = Request(prompt_ids=[1, 2], max_tokens=4, deadline_s=1.0)
    eng.submit(r)
    eng.begin_drain(timeout_s=500.0)
    own = eng._effective_deadline(r) == pytest.approx(r.t_deadline)
    r2 = Request(prompt_ids=[1], max_tokens=4)
    r2.t_deadline = 0.0             # no deadline of its own: the drain's
    drain = eng._effective_deadline(r2) == pytest.approx(eng._drain_deadline)
    eng.end_drain()
    _run(eng)
    return {"own": own, "drain": drain, "finish": r.finish_reason,
            "tokens": r.generated}


def test_drain_deadline_tightens_not_loosens(model):
    got, _ = _both(model, _drain_tightens, **DRAIN)
    assert got["own"] and got["drain"]


def test_racing_drains_keep_the_first_deadline(model):
    """The preStop hook and SIGTERM both begin a drain, from two threads:
    of 16 racing callers (switch interval shortened) exactly one sets the
    deadline and gets its own timeout back; the others get the time left
    until that deadline."""
    _, te = _engines(model, **DRAIN)
    timeouts = [100.0 + i for i in range(16)]
    got = [None] * 16
    gate = threading.Barrier(16)

    def call(i):
        gate.wait()
        got[i] = te.begin_drain(timeout_s=timeouts[i])

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(30)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    winners = [i for i in range(16) if got[i] == timeouts[i]]
    assert len(winners) == 1, got
    w = winners[0]
    assert all(got[i] <= timeouts[w] for i in range(16))
    assert te.draining and te.metrics.draining.value() == 1.0


# -- deadlines and admission control (tests/test_chaos.py) -------------------


def _racing_final_token(eng, Request, Overloaded):
    """Eight two-token requests over two slots; before step j (j < 8)
    request j's deadline is set to have passed, wherever it then is:
    queued, prefilled, with its final dispatch in flight, or done."""
    reqs = [eng.submit(Request(prompt_ids=TOK.encode(f"race {i}"),
                               max_tokens=2, ignore_eos=True))
            for i in range(8)]
    where = []
    for j in range(10000):
        if j < len(reqs):
            r = reqs[j]
            where.append(r.finish_reason or (
                "running" if any(x is r for x in eng.slot_req)
                else "waiting"))
            r.t_deadline = time.monotonic() - 1e-3
        if not eng.step() and j >= len(reqs):
            break
    return {"finish": [r.finish_reason for r in reqs], "where": where,
            "tokens": [r.generated for r in reqs]}


@pytest.mark.parametrize("pipeline", [1, 0])
def test_deadline_expiry_racing_final_token_releases_exactly_once(model,
                                                                  pipeline):
    """The deadline of a request whose final tokens may be in flight
    expires: the request finishes once (its late tokens discarded), with
    the reason the JAX engine gives, and its slot and pages are released
    once."""
    got, te = _both(model, _racing_final_token, decode_pipeline=pipeline,
                    **CHAOS)
    assert set(got["finish"]) <= {"stop", "length", "timeout"}
    assert "timeout" in got["finish"]
    assert int(te.metrics.deadline_expired.total()) == \
        got["finish"].count("timeout")


def _queued_expiry(eng, Request, Overloaded):
    r = eng.submit(Request(prompt_ids=TOK.encode("expired in queue"),
                           max_tokens=4, deadline_s=0.001))
    time.sleep(0.01)
    eng.step()
    return {"finish": r.finish_reason,
            "sentinel": r.out_queue.get(timeout=1) is None,
            "admitted": bool(r.t_prefill_start)}


def test_queued_deadline_expiry_notifies_without_admission(model):
    got, te = _both(model, _queued_expiry, **CHAOS)
    assert got == {"finish": "timeout", "sentinel": True, "admitted": False}
    assert te.metrics.deadline_expired.total() == 1
    assert te.counts["prefill_dispatches"] == 0


@pytest.mark.parametrize("paged", [True, False])
def test_deadline_reaps_a_chunk_walk(model, paged):
    """A prompt mid-way through its chunk walk (a mixed dispatch of the
    paged walk in flight beside a running request) expires: the walk's
    slot and pages are released once and the running request's stream is
    untouched."""
    def scenario(eng, Request, Overloaded):
        runner = eng.submit(Request(prompt_ids=[5, 6, 7], max_tokens=30,
                                    ignore_eos=True))
        eng.step()
        walker = eng.submit(Request(prompt_ids=list(range(10, 50)),
                                    max_tokens=5, ignore_eos=True))
        for _ in range(100):
            eng.step()
            if eng._chunk is not None and eng._chunk["off"] >= 16:
                break
        walked = eng._chunk["off"]
        walker.t_deadline = time.monotonic() - 1e-3
        _run(eng)
        return {"walked": walked,
                "finish": [runner.finish_reason, walker.finish_reason],
                "tokens": [runner.generated, walker.generated]}

    got, _ = _both(model, scenario, prefill_chunk=8, paged=paged,
                   **{**CHAOS, "max_cache_len": 64,
                      "prefill_buckets": (8, 16, 32, 64)})
    assert got["finish"] == ["length", "timeout"]
    assert len(got["tokens"][0]) == 30 and got["tokens"][1] == []


def _queue_bound(eng, Request, Overloaded):
    r1 = eng.submit(Request(prompt_ids=TOK.encode("first"), max_tokens=2))
    with pytest.raises(Overloaded) as ei:
        eng.submit(Request(prompt_ids=TOK.encode("second"), max_tokens=2))
    _run(eng)
    return {"reason": ei.value.reason, "retry": ei.value.retry_after_s,
            "finish": r1.finish_reason, "tokens": r1.generated}


def test_queue_bound_sheds_with_structured_error(model):
    got, _ = _both(model, _queue_bound,
                   **{**CHAOS, "max_decode_slots": 1, "max_queue_depth": 1})
    assert got["reason"] == "queue_full" and got["retry"] >= 1.0


def _estimated_wait(eng, Request, Overloaded):
    # forged throughput history: 1 token/s, 10 tokens generated so far
    eng.metrics.tokens_per_second.set(1.0)
    eng.metrics.generated_tokens.inc(10)
    r1 = eng.submit(Request(prompt_ids=TOK.encode("fills the queue"),
                            max_tokens=2))
    with pytest.raises(Overloaded) as ei:
        eng.submit(Request(prompt_ids=TOK.encode("sheds"), max_tokens=2))
    _run(eng)
    return {"reason": ei.value.reason, "retry": ei.value.retry_after_s,
            "finish": r1.finish_reason, "tokens": r1.generated}


def test_estimated_wait_shed(model):
    got, te = _both(model, _estimated_wait,
                    **{**CHAOS, "max_decode_slots": 1,
                       "admission_max_wait_s": 0.5})
    # 1 queued x 10 tokens / 1 token/s = 10 s > 0.5 s
    assert got["reason"] == "est_wait" and got["retry"] == 10.5
    assert te.metrics.requests_shed.value(reason="est_wait") == 1


def test_bad_deadline_is_refused(model):
    for eng, Request in zip(_engines(model, **CHAOS), (JRequest, TRequest)):
        with pytest.raises(ValueError, match="deadline"):
            eng.submit(Request(prompt_ids=[1, 2], deadline_s=0.0))
        r = eng.submit(Request(prompt_ids=[1, 2], deadline_s=5000.0))
        # capped by request_timeout_s (600)
        assert r.t_deadline - r.t_submit == pytest.approx(600.0)


# -- the admission-pressure preemption (tests/test_chaos.py) -----------------

PRESSURE = {**CHAOS, "kv_pool_pages": 4, "admission_preempt_after_s": 0.005}


def _victims(eng):
    """Record the request of each preempted slot (wraps ``_preempt``)."""
    seen = []
    orig = eng._preempt

    def wrapped(slot, *a, **kw):
        seen.append(eng.slot_req[slot].prompt_ids)
        return orig(slot, *a, **kw)

    eng._preempt = wrapped
    return seen


def _pressure(eng, Request, Overloaded):
    """A 120-token prompt fills the four-page pool; a small prompt then
    starves for pages with the second slot free."""
    victims = _victims(eng)
    hog = eng.submit(Request(prompt_ids=[65] * 120, max_tokens=7,
                             ignore_eos=True))
    while not eng._active_slots():
        eng.step()
    small = eng.submit(Request(prompt_ids=TOK.encode("let me in"),
                               max_tokens=2))
    eng.step()                      # blocked admission: the timer starts
    admitted = any(eng.slot_req[s] is small for s in eng._active_slots())
    time.sleep(0.02)
    worked = eng.step()             # the timer has run: the hog goes back
    first = {"admitted": admitted, "worked": worked,
             "victim": victims[0] == [65] * 120,
             "admission_preemptions":
                 int(eng.metrics.admission_preemptions.total()),
             "preemptions": int(eng.metrics.preemptions.total()),
             "active": len(eng._active_slots())}
    _run(eng)
    return {"first": first, "finish": [hog.finish_reason,
                                       small.finish_reason],
            "tokens": [hog.generated, small.generated]}


def test_admission_pressure_preempts_lowest_progress(model):
    """The page-starved head with a free slot preempts the lowest-progress
    running request (the hog, requeued at the back) instead of waiting for
    it; both engines pick the same victim, the step that preempts reports
    work (with the victim the sole active slot, a False step would strand
    it), and the hog resumes to the same stream."""
    je, te = _engines(model, **PRESSURE)
    want = _pressure(je, JRequest, JOverloaded)
    got = _pressure(te, TRequest, TOverloaded)
    assert got == want
    assert got["first"] == {"admitted": False, "worked": True,
                            "victim": True, "admission_preemptions": 1,
                            "preemptions": 1, "active": 0}
    assert got["finish"][0] == "length" and len(got["tokens"][0]) == 7
    assert got["finish"][1] in ("stop", "length")
    _released(je, te)


def test_pressure_relief_is_off_at_zero(model):
    """``admission_preempt_after_s=0`` keeps the head waiting for the hog's
    pages: no preemption, and the same streams."""
    def scenario(eng, Request, Overloaded):
        hog = eng.submit(Request(prompt_ids=[65] * 120, max_tokens=7,
                                 ignore_eos=True))
        while not eng._active_slots():
            eng.step()
        small = eng.submit(Request(prompt_ids=TOK.encode("let me in"),
                                   max_tokens=2))
        eng.step()
        time.sleep(0.02)
        eng.step()
        _run(eng)
        return {"tokens": [hog.generated, small.generated]}

    _, te = _both(model, scenario,
                  **{**PRESSURE, "admission_preempt_after_s": 0.0})
    assert te.metrics.preemptions.total() == 0


def test_failed_prefill_releases_its_slots(model):
    """A batch prefill that raises answers its requests with "error" and
    releases their slots and pages (the step re-raises for run_forever)."""
    def scenario(eng, Request, Overloaded):
        def boom(*a, **kw):
            raise RuntimeError("injected prefill failure")

        names = ("_do_prefill", "_do_prefill_batch") \
            if isinstance(eng, JEngine) else ("_prefill_batch",)
        saved = {n: getattr(eng, n) for n in names}
        for n in names:
            setattr(eng, n, boom)
        reqs = [eng.submit(Request(prompt_ids=[9 + i, 4], max_tokens=3,
                                   ignore_eos=True)) for i in range(2)]
        with pytest.raises(RuntimeError, match="injected"):
            eng.step()
        for n in names:
            setattr(eng, n, saved[n])
        after = eng.submit(Request(prompt_ids=[8, 4], max_tokens=3,
                                   ignore_eos=True))
        _run(eng)
        return {"finish": [r.finish_reason for r in reqs + [after]],
                "tokens": after.generated}

    got, _ = _both(model, scenario, **CHAOS)
    assert got["finish"] == ["error", "error", "length"]


# -- the stall watchdog (tests/test_server.py, tests/test_chaos.py) ----------


def test_engine_stall_detection(model):
    for eng in _engines(model, **DRAIN):
        assert eng.stalled_for_s == 0.0                      # idle
        eng.last_step_start = time.monotonic() - 1.0
        assert eng.stalled_for_s == 0.0                      # in a step
        eng.last_step_start = time.monotonic() - eng.STALL_AFTER_S - 5
        assert eng.stalled_for_s > 0.0                       # wedged


def test_stall_visible_on_health_fields(model):
    for eng in _engines(model, **{**CHAOS, "watchdog_stall_s": 0.25}):
        assert eng.STALL_AFTER_S == 0.25
        eng.last_step_start = time.monotonic() - 1.0
        assert eng.stalled_for_s > 0.0


# -- HTTP: both servers in process -------------------------------------------


class _Servers:
    """The port's server and the JAX server over the same weights and
    serving config, each on a free port, with its engine thread."""

    def __init__(self, model, **serving):
        from aws_k8s_ansible_provisioner_tpu.serving import server as jserver
        from aws_k8s_ansible_provisioner_tpu_torch.serving.server import (
            build_state, make_server)

        jcfg, jp, tcfg, tp = model
        self.state = build_state(TServing(model="tiny-qwen3", **serving),
                                 model_cfg=tcfg, params=tp,
                                 tokenizer=ByteTokenizer(), device="cpu")
        self._srv = make_server(self.state, "127.0.0.1", 0)
        self._th = threading.Thread(target=self._srv.serve_forever,
                                    daemon=True)
        self._th.start()
        self.state.start_engine()
        self.port = f"http://127.0.0.1:{self._srv.server_address[1]}"
        self.jstate = jserver.build_state(
            JServing(model="tiny-qwen3", **serving), model_cfg=jcfg,
            params=jp, tokenizer=JByteTokenizer())
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            jport = sock.getsockname()[1]
        ready, self._jstop = threading.Event(), threading.Event()
        self._jth = threading.Thread(
            target=jserver.serve,
            args=(self.jstate, "127.0.0.1", jport, ready, self._jstop),
            daemon=True)
        self._jth.start()
        assert ready.wait(30)
        self.jax = f"http://127.0.0.1:{jport}"

    def close(self):
        self._srv.shutdown()
        self._srv.server_close()
        self.state.stop_engine()
        self._th.join(10)
        self._jstop.set()
        self._jth.join(30)


def _call(url, body=None, headers=None, timeout=60):
    """(status, JSON body, headers) of a GET (``body`` None) or a POST."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        url, data=data,
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _wait_active(eng, n=1, timeout=60):
    t0 = time.monotonic()
    while len(eng._active_slots()) < n:
        assert time.monotonic() - t0 < timeout, "request never activated"
        time.sleep(0.01)


def _shape(out):
    """What the two servers must agree on: status, the lifecycle headers,
    the error's type and code."""
    status, body, hdrs = out
    err = body.get("error") or {}
    return (status, hdrs.get("X-TPU-Draining"), "Retry-After" in hdrs,
            err.get("type"), err.get("code"), body.get("status"))


@pytest.fixture(scope="module")
def servers(model):
    s = _Servers(model, **DRAIN)
    yield s
    s.close()


def test_healthz_keys_are_the_jax_servers_with_the_same_types(servers):
    """``/health``, ``/healthz`` and ``/ping`` give one answer; its keys
    are a subset of the JAX server's, each value of the same type (C16);
    ``/readyz`` and ``/load`` answer alike."""
    s = servers
    assert _call(s.port + "/v1/completions",
                 {"prompt": "warm", "max_tokens": 3})[0] == 200
    assert _call(s.jax + "/v1/completions",
                 {"prompt": "warm", "max_tokens": 3})[0] == 200
    answers = [_call(s.port + p) for p in ("/health", "/healthz", "/ping")]
    for status, body, _ in answers:
        assert status == 200 and body["status"] == "ok"
    got = answers[1][1]
    want = _call(s.jax + "/healthz")[1]
    assert set(got) <= set(want), set(got) - set(want)
    for k, v in got.items():
        assert type(v) is type(want[k]), (k, v, want[k])
    assert got["kv_host_tier"].keys() == want["kv_host_tier"].keys()
    assert got["prefix_tier_hits"].keys() == want["prefix_tier_hits"].keys()
    for path in ("/readyz", "/load"):
        port, jax_ = _call(s.port + path), _call(s.jax + path)
        assert _shape(port) == _shape(jax_)
        assert port[1].keys() == jax_[1].keys()
    assert _call(s.port + "/load")[1] == {"active": 0, "queued": 0,
                                          "slots": 4, "draining": False}


def test_health_is_degraded_after_a_failed_step(servers):
    """``last_error`` sets ``degraded`` (200): a failed step is never
    answered as healthy, and the next request is served."""
    eng = servers.state.engine
    eng.last_error = "RuntimeError: injected"
    try:
        status, body, _ = _call(servers.port + "/healthz")
        assert status == 200 and body["status"] == "degraded"
        assert body["last_error"] == "RuntimeError: injected"
    finally:
        eng.last_error = ""


def test_admin_drain_flips_readiness_and_sheds(servers):
    """``/admin/drain`` with ``exit: false`` and ``/admin/undrain``: the
    same status codes, headers and error codes as the JAX server's on
    ``/readyz``, ``/healthz``, ``/load`` and a completion, and readiness
    back after the undrain."""
    seqs = []
    for base in (servers.port, servers.jax):
        seq = [_shape(_call(base + "/readyz"))]
        code, body, _ = _call(base + "/admin/drain", {"exit": False})
        seq.append((code, body["status"], body["exit_when_idle"]))
        try:
            seq.append(_shape(_call(base + "/readyz")))
            h = _call(base + "/healthz")
            seq.append((h[0], h[1]["status"], h[1]["draining"]))
            seq.append(_call(base + "/load")[1]["draining"])
            seq.append(_shape(_call(base + "/v1/completions",
                                    {"model": "tiny-qwen3", "prompt": "x",
                                     "max_tokens": 4})))
        finally:
            code, body, _ = _call(base + "/admin/undrain", {})
            seq.append((code, body))
        seq.append(_shape(_call(base + "/readyz")))
        seq.append(_call(base + "/v1/completions",
                         {"model": "tiny-qwen3", "prompt": "y",
                          "max_tokens": 4})[0])
        seqs.append(seq)
    assert seqs[0] == seqs[1]
    assert seqs[0][2] == (503, "1", False, None, None, "draining")
    assert seqs[0][5] == (503, "1", True, "unavailable_error", "draining",
                          None)
    assert seqs[0][-1] == 200


def test_deadline_header_and_body_field(servers):
    """408 ``deadline_exceeded`` by the header and by the body field; a
    deadline that is not a positive number of milliseconds gets 400; the
    same answers from both servers, and the expired request's slot comes
    back."""
    long_ = {"prompt": "header deadline", "max_tokens": 45,
             "ignore_eos": True}
    cases = [(long_, {"X-Request-Deadline-Ms": "1"}),
             ({**long_, "deadline_ms": 1}, None),
             ({"prompt": "x", "deadline_ms": -5}, None),
             ({"prompt": "x", "deadline_ms": "soon"}, None),
             ({"prompt": "x", "max_tokens": 2}, {"X-Request-Deadline-Ms":
                                                  "0"}),
             ({"prompt": "x", "max_tokens": 2, "deadline_ms": 60000}, None)]
    got = [_shape(_call(servers.port + "/v1/completions", b, h))
           for b, h in cases]
    want = [_shape(_call(servers.jax + "/v1/completions", b, h))
            for b, h in cases]
    assert got == want
    assert [g[0] for g in got] == [408, 408, 400, 400, 400, 200]
    assert got[0][3:5] == ("timeout", "deadline_exceeded")
    eng = servers.state.engine
    assert eng.metrics.deadline_expired.total() >= 2
    t0 = time.monotonic()
    while eng._active_slots() or eng.pending:
        assert time.monotonic() - t0 < 30
        time.sleep(0.02)
    assert sorted(eng._free) == list(range(eng.num_slots))


def test_http_429_with_retry_after(model):
    """One slot, a queue of one: with the slot busy and the queue full a
    completion gets 429 ``engine_overloaded:queue_full`` with
    ``Retry-After`` from both servers, and ``/healthz`` counts the shed."""
    s = _Servers(model, **{**CHAOS, "max_decode_slots": 1,
                           "max_queue_depth": 1, "decode_horizon": 1})
    try:
        out = []
        for base, eng, Request in ((s.port, s.state.engine, TRequest),
                                   (s.jax, s.jstate.engine, JRequest)):
            done = {}
            th = threading.Thread(target=lambda: done.setdefault(
                "hog", _call(base + "/v1/completions",
                             {"prompt": "hog", "max_tokens": 120,
                              "ignore_eos": True})))
            th.start()
            _wait_active(eng)
            queued = eng.submit(Request(prompt_ids=[65, 66, 67],
                                        max_tokens=4))
            shed = _call(base + "/v1/completions",
                         {"prompt": "shed me", "max_tokens": 4})
            health = _call(base + "/healthz")[1]
            eng.cancel(queued)
            th.join(60)
            assert not th.is_alive()
            out.append((_shape(shed), health["shed_total"],
                        health["max_queue_depth"], done["hog"][0]))
        assert out[0] == out[1]
        assert out[0][0] == (429, None, True, "overloaded_error",
                             "engine_overloaded:queue_full", None)
        assert out[0][1:] == (1, 1, 200)
    finally:
        s.close()


def test_stalled_step_answers_503_and_counts_one_stall(model):
    """A step that sleeps past ``watchdog_stall_s=0.2``: the watchdog
    counts one stall, ``/healthz`` and ``/readyz`` answer 503 "stalled"
    while it lasts, and 200 again after it."""
    from aws_k8s_ansible_provisioner_tpu_torch.serving.server import (
        build_state, make_server)

    _, _, tcfg, tp = model
    state = build_state(TServing(model="tiny-qwen3", watchdog_stall_s=0.2,
                                 **DRAIN),
                        model_cfg=tcfg, params=tp, tokenizer=ByteTokenizer(),
                        device="cpu")
    eng = state.engine
    stall, stalled = threading.Event(), threading.Event()
    step = eng.step

    def slow_step():
        if stall.is_set():
            stall.clear()
            stalled.set()
            time.sleep(1.5)
        return step()

    eng.step = slow_step
    srv = make_server(state, "127.0.0.1", 0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    state.start_engine()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        assert _call(base + "/healthz")[0] == 200
        stall.set()
        assert stalled.wait(10)
        time.sleep(0.5)
        health, ready = _call(base + "/healthz"), _call(base + "/readyz")
        assert health[0] == 503 and health[1]["status"] == "stalled"
        assert health[1]["stalled_for_s"] >= 0.2
        assert ready[0] == 503 and ready[1] == {"status": "stalled"}
        t0 = time.monotonic()
        while eng.stalled_for_s:
            assert time.monotonic() - t0 < 10
            time.sleep(0.05)
        health = _call(base + "/healthz")
        assert health[0] == 200 and health[1]["status"] == "ok"
        assert health[1]["watchdog_stalls_total"] == 1
        assert _call(base + "/readyz")[0] == 200
    finally:
        srv.shutdown()
        srv.server_close()
        state.stop_engine()
        th.join(10)


def test_probe_l3_and_undrain_repair_against_a_port_replica(model,
                                                            monkeypatch):
    """The deploy layer's L3 probe and its cheap repair
    (``deploy/probes.py``) against a real port replica: a draining replica
    fails the probe with its 503, the undrain repairs it in place."""
    sys.path.insert(0, os.path.join(REPO, "deploy"))
    import probes

    from aws_k8s_ansible_provisioner_tpu_torch.serving.server import (
        build_state, make_server)

    _, _, tcfg, tp = model
    state = build_state(TServing(model="tiny-qwen3", **DRAIN),
                        model_cfg=tcfg, params=tp, tokenizer=ByteTokenizer(),
                        device="cpu")
    srv = make_server(state, "127.0.0.1", 0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    state.start_engine()
    try:
        monkeypatch.setenv("TPU_PROBE_REPLICAS",
                           f"127.0.0.1:{srv.server_address[1]}")
        assert probes.probe_l3({}, None).ok
        state.begin_drain(exit_when_idle=False)
        r = probes.probe_l3({}, None)
        assert not r.ok and "503" in r.detail
        assert probes.repair_l3_undrain({}, None, log=lambda *_: None)
        assert probes.probe_l3({}, None).ok and not state.engine.draining
    finally:
        srv.shutdown()
        srv.server_close()
        state.stop_engine()
        th.join(10)


def test_sigterm_drains_and_exits_zero_with_the_request_finished():
    """SIGTERM to the port's server (``--device cpu``) while a completion
    runs: a new completion gets 503 ``draining``, the running one answers
    200 with its whole budget, and the process exits 0 within
    ``--drain-timeout``."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "aws_k8s_ansible_provisioner_tpu_torch.serving.server",
         "--model", "tiny-qwen3", "--device", "cpu", "--port", "0",
         "--host", "127.0.0.1", "--max-decode-slots", "4",
         "--max-cache-len", "256", "--decode-pipeline", "0",
         "--drain-timeout", "30"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines = []
    found = threading.Event()

    def reader():
        for line in proc.stdout:
            lines.append(line)
            if re.search(r"serving tiny-qwen3 on 127\.0\.0\.1:\d+", line):
                found.set()

    threading.Thread(target=reader, daemon=True).start()
    try:
        assert found.wait(120), "".join(lines)
        port = re.search(r"on 127\.0\.0\.1:(\d+)", "".join(lines)).group(1)
        base = f"http://127.0.0.1:{port}"
        assert _call(base + "/readyz")[0] == 200
        budget = 110            # the tiny model's window is 128
        result = {}
        th = threading.Thread(target=lambda: result.setdefault(
            "out", _call(base + "/v1/completions",
                         {"prompt": "drain me", "max_tokens": budget,
                          "ignore_eos": True}, timeout=120)))
        th.start()
        t0 = time.monotonic()
        while _call(base + "/load")[1]["active"] < 1:
            assert time.monotonic() - t0 < 60, "the request never ran"
            time.sleep(0.01)
        proc.send_signal(signal.SIGTERM)
        t_term = time.monotonic()
        t0 = time.monotonic()
        while _call(base + "/readyz")[0] != 503:
            assert time.monotonic() - t0 < 10
            time.sleep(0.01)
        code, body, hdrs = _call(base + "/v1/completions",
                                 {"prompt": "new", "max_tokens": 4})
        assert code == 503 and hdrs.get("X-TPU-Draining") == "1"
        assert body["error"]["code"] == "draining"
        th.join(90)
        assert not th.is_alive(), "the request never finished"
        code, body, _ = result["out"]
        assert code == 200, body
        assert body["usage"]["completion_tokens"] == budget
        assert body["choices"][0]["finish_reason"] == "length"
        assert proc.wait(timeout=40) == 0, "".join(lines)
        assert time.monotonic() - t_term < 30
        assert any("drained and stopped" in ln for ln in lines)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
