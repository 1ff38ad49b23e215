"""The port's router (``serving/router.py``) against the JAX package's: the
scenarios of ``tests/test_router.py`` through each router, parametrised
over the two, against the same fake backends; and, byte for byte, the same
outputs of both under the same scripted inputs: affinity keys, ``pick``
order and cooldown under a fake clock, the failover continuation after the
same relayed events, ``_fleet_capacity`` on the same fleet dicts, the
``/metrics`` text after the same traffic, and the command line of
``python -m ...serving.router``. Backends and routers listen on ephemeral
ports; waits poll a condition with a deadline.
"""

import json
import os
import socket
import struct
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from aws_k8s_ansible_provisioner_tpu.serving import router as jrouter
from aws_k8s_ansible_provisioner_tpu_torch.serving import router as trouter

ROUTERS = {"jax": jrouter, "port": trouter}


@pytest.fixture(params=sorted(ROUTERS))
def rt(request):
    """One router module, its handler's pool and metrics restored after."""
    mod = ROUTERS[request.param]
    h = mod.RouterHandler
    saved = (h.pool, h.metrics, h.tracer)
    yield mod
    h.pool, h.metrics, h.tracer = saved


class FakeEngine(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):
        pass

    def _send(self, code, obj):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/v1/models":
            self._send(200, {"object": "list",
                             "data": [{"id": "Qwen/Qwen3-0.6B"}],
                             "port": self.server.server_port})
        elif self.path == "/load":
            self._send(200, {"active": getattr(self.server, "active", 0),
                             "queued": 0, "slots": 4})
        elif self.path == "/healthz":
            code = getattr(self.server, "health", 200)
            self._send(code, {"status": "ok" if code == 200 else "stalled"})
        else:
            self._send(404, {"error": "nope"})

    def do_POST(self):
        n = int(self.headers.get("Content-Length") or 0)
        req = json.loads(self.rfile.read(n) or b"{}")
        self._send(200, {"echo": req, "port": self.server.server_port})


def _serve(handler, **attrs):
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    for k, v in attrs.items():
        setattr(srv, k, v)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _addr(srv):
    return f"127.0.0.1:{srv.server_port}"


def _router(mod, pool):
    mod.RouterHandler.pool = pool
    mod.RouterHandler.metrics = mod.RouterMetrics()
    mod.RouterHandler.tracer = None
    return _serve(mod.RouterHandler)


def _post(port, path, body, headers=None, timeout=30):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.status, r.read()


def _until(cond, timeout=10.0):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < timeout, "condition not reached"
        time.sleep(0.02)


def _shutdown(*srvs):
    for s in srvs:
        s.shutdown()
        s.server_close()


def _frozen_pool(mod, addrs, **kw):
    pool = mod.BackendPool("127.0.0.1:1", **kw)
    pool._addrs = list(addrs)
    pool._last_refresh = float("inf")
    return pool


def _fixed_order_pool(mod, addrs):
    class FixedOrder(mod.BackendPool):
        def pick(self, affinity_key=None):
            return list(addrs)
    return FixedOrder(",".join(addrs))


# -- the scenarios of tests/test_router.py, through each router -----------


def test_proxies_get_post_health_and_errors(rt):
    be = _serve(FakeEngine)
    router = _router(rt, rt.BackendPool(_addr(be)))
    try:
        status, body = _get(router.server_port, "/v1/models")
        assert status == 200
        assert json.loads(body)["data"][0]["id"] == "Qwen/Qwen3-0.6B"
        _, body = _post(router.server_port, "/v1/completions",
                        {"prompt": "hi", "max_tokens": 4})
        assert json.loads(body)["echo"]["prompt"] == "hi"
        status, body = _get(router.server_port, "/health")
        assert status == 200 and json.loads(body)["status"] == "ok"
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(router.server_port, "/v1/unknown")
        assert e.value.code == 404
        _, text = _get(router.server_port, "/metrics")
        assert b'tpu_router_requests_total{code="200"}' in text
        assert b"tpu_router_backends" in text
    finally:
        _shutdown(router, be)


def test_503_when_no_backends(rt):
    router = _router(rt, rt.BackendPool("nonexistent.invalid:9"))
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(router.server_port, "/v1/models")
        assert e.value.code == 503
    finally:
        _shutdown(router)


def test_failover_on_connect_refused(rt):
    """Nothing was sent to a replica that refused the connection, so even
    a POST fails over to the next one."""
    be = _serve(FakeEngine)
    router = _router(rt, _fixed_order_pool(
        rt, ["127.255.255.254:9", _addr(be)]))
    try:
        _, body = _post(router.server_port, "/v1/completions",
                        {"prompt": "hi"})
        assert json.loads(body)["echo"]["prompt"] == "hi"
        assert rt.RouterHandler.metrics.failovers.total() >= 1
        assert rt.RouterHandler.metrics.dead_marks.total() == 1
    finally:
        _shutdown(router, be)


def test_pool_rotation_cooldown_and_malformed_service(rt):
    pool = rt.BackendPool("127.0.0.1:1234", cooldown_s=60)
    pool._addrs = ["10.0.0.1", "10.0.0.2"]
    pool._last_refresh = float("inf")
    assert {pool.pick()[0], pool.pick()[0]} == {"10.0.0.1", "10.0.0.2"}
    pool.mark_dead("10.0.0.1")
    for _ in range(4):
        assert pool.pick()[0] == "10.0.0.2"
    for bad in ("no-port-here", "host:", ":8000", "host:notaport"):
        with pytest.raises(ValueError):
            rt.BackendPool(bad)


def test_pick_orders_by_load_and_affinity(rt):
    pool = _frozen_pool(rt, ["a:1", "b:1", "c:1"])
    pool.note_load("a:1", active=3, queued=5)
    pool.note_load("b:1", active=0, queued=0)
    pool.note_load("c:1", active=2, queued=0)
    for _ in range(6):
        assert pool.pick() == ["b:1", "c:1", "a:1"]
    pool.note_affinity("k1", "c:1")
    assert pool.pick("k1")[0] == "c:1"       # within the slack
    pool.note_load("c:1", active=9, queued=0)
    assert pool.pick("k1")[0] == "b:1"       # past it: affinity yields
    # a stale sticky sample does not beat fresh ones
    pool._load["c:1"] = (0, time.monotonic() - rt.LOAD_TTL_S - 1)
    assert pool.pick("k1")[0] == "b:1"
    pool._load.clear()                       # no fresh sample anywhere
    assert pool.pick("k1")[0] == "c:1"


def test_poller_feeds_pool_and_requests_converge(rt):
    """The real poller samples two backends of unequal /load; distinct
    prompts all land on the idle one."""
    busy, idle = _serve(FakeEngine, active=5), _serve(FakeEngine, active=0)
    pool = rt.BackendPool(f"{_addr(busy)},{_addr(idle)}")
    stop = threading.Event()
    rt.start_load_poller(pool, interval_s=0.05, stop=stop)
    router = _router(rt, pool)
    try:
        _until(lambda: len(pool._load) == 2)
        ports = [json.loads(_post(router.server_port, "/v1/completions",
                                  {"prompt": f"unique {i}"})[1])["port"]
                 for i in range(4)]
        assert ports == [idle.server_port] * 4
    finally:
        stop.set()
        _shutdown(router, busy, idle)


def test_same_prefix_sticks_to_one_backend(rt):
    srvs = [_serve(FakeEngine), _serve(FakeEngine)]
    router = _router(rt, rt.BackendPool(",".join(_addr(s) for s in srvs)))
    try:
        ports = {json.loads(_post(router.server_port, "/v1/completions",
                                  {"prompt": "the shared history"})[1])[
            "port"] for _ in range(5)}
        assert len(ports) == 1
    finally:
        _shutdown(router, *srvs)


def test_recovered_replica_reenters_rotation(rt):
    """A cooling replica answering /healthz 200 is back within one poll; a
    503-stalled one stays out."""
    srv = _serve(FakeEngine, health=503)
    addr = _addr(srv)
    pool = rt.BackendPool(addr, cooldown_s=3600)
    metrics = rt.RouterMetrics()
    pool.mark_dead(addr)
    stop = threading.Event()
    rt.start_load_poller(pool, interval_s=0.05, stop=stop, metrics=metrics)
    try:
        _until(lambda: srv.health == 503)
        time.sleep(0.2)                      # a few polls answered 503
        assert addr in pool.cooling()
        srv.health = 200
        _until(lambda: addr not in pool.cooling())
        assert pool.pick()[0] == addr and metrics.recovered.total() >= 1
    finally:
        stop.set()
        _shutdown(srv)


class Draining(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):
        pass

    def do_POST(self):
        self.rfile.read(int(self.headers.get("Content-Length") or 0))
        body = b'{"error": {"code": "draining"}}'
        self.send_response(503)
        self.send_header("Content-Type", "application/json")
        self.send_header("X-TPU-Draining", "1")
        self.send_header("Retry-After", "7")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def test_draining_503_reroutes_without_dead_mark(rt):
    dr, ok = _serve(Draining), _serve(FakeEngine)
    router = _router(rt, _fixed_order_pool(rt, [_addr(dr), _addr(ok)]))
    try:
        _, body = _post(router.server_port, "/v1/completions",
                        {"prompt": "x"})
        assert json.loads(body)["port"] == ok.server_port
        m = rt.RouterHandler.metrics
        assert m.draining_skips.total() == 1 and m.dead_marks.total() == 0
        assert _addr(dr) in rt.RouterHandler.pool.draining()
    finally:
        _shutdown(router, dr, ok)


def test_all_replicas_draining_relays_503(rt):
    srvs = [_serve(Draining), _serve(Draining)]
    router = _router(rt, _fixed_order_pool(rt, [_addr(s) for s in srvs]))
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(router.server_port, "/v1/completions", {"prompt": "x"})
        assert e.value.code == 503
        assert e.value.headers.get("X-TPU-Draining") == "1"
        assert e.value.headers.get("Retry-After") == "7"
    finally:
        _shutdown(router, *srvs)


def _reset_after(handler, events):
    """Write ``events`` as SSE, then reset the connection."""
    handler.rfile.read(int(handler.headers.get("Content-Length") or 0))
    handler.send_response(200)
    handler.send_header("Content-Type", "text/event-stream")
    handler.end_headers()
    for ev in events:
        handler.wfile.write(b"data: " + json.dumps(ev).encode() + b"\n\n")
    handler.wfile.flush()
    handler.connection.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                                  struct.pack("ii", 1, 0))
    os.close(handler.connection.detach())


class DiesAfterTwo(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):
        pass

    def do_POST(self):
        _reset_after(self, [
            {"choices": [{"index": 0, "text": t, "token_ids": [i]}]}
            for i, t in ((7, "a"), (9, "b"))])


class UntaggedDies(DiesAfterTwo):
    def do_POST(self):
        _reset_after(self, [{"choices": [{"text": "a"}]}])


class Continues(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):
        pass

    def do_POST(self):
        n = int(self.headers.get("Content-Length") or 0)
        self.server.got = json.loads(self.rfile.read(n))
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(
            b'data: {"choices":[{"index":0,"text":"cd",'
            b'"token_ids":[11,13]}]}\n\n'
            b'data: {"choices":[{"index":0,"text":"",'
            b'"finish_reason":"length"}]}\n\n'
            b'data: [DONE]\n\n')
        self.wfile.flush()
        self.close_connection = True


def test_mid_stream_failover_splices_continuation(rt):
    b1, b2 = _serve(DiesAfterTwo), _serve(Continues)
    router = _router(rt, _fixed_order_pool(rt, [_addr(b1), _addr(b2)]))
    try:
        _, raw = _post(router.server_port, "/v1/completions",
                       {"prompt": "x", "stream": True, "max_tokens": 8,
                        "seed": 3})
        events = [ln[len("data: "):] for ln in raw.decode().splitlines()
                  if ln.startswith("data: ")]
        assert events[-1] == "[DONE]"
        text, ids = "", []
        for ev in events[:-1]:
            for c in json.loads(ev)["choices"]:
                text += c.get("text") or ""
                ids += c.get("token_ids") or []
        assert (text, ids) == ("abcd", [7, 9, 11, 13])
        assert b2.got["resume_token_ids"] == [7, 9]
        assert b2.got["resume_text_chars"] == 2
        assert (b2.got["max_tokens"], b2.got["seed"]) == (6, 3)
        assert rt.RouterHandler.metrics.stream_failovers.total() == 1
        assert _addr(b1) in rt.RouterHandler.pool.cooling()
    finally:
        _shutdown(router, b1, b2)


def test_untagged_stream_death_truncates(rt):
    b1, b2 = _serve(UntaggedDies), _serve(FakeEngine)
    router = _router(rt, _fixed_order_pool(rt, [_addr(b1), _addr(b2)]))
    try:
        try:
            raw = _post(router.server_port, "/v1/completions",
                        {"prompt": "x", "stream": True,
                         "max_tokens": 8})[1].decode(errors="replace")
        except (urllib.error.HTTPError, OSError):
            raw = ""
        assert "[DONE]" not in raw
        assert rt.RouterHandler.metrics.stream_failovers.total() == 0
    finally:
        _shutdown(router, b1, b2)


def test_remove_backend_repoints_affinity(rt):
    pool = _frozen_pool(rt, ["a:1", "b:1", "c:1"])
    for k in ("k1", "k2"):
        pool.note_affinity(k, "a:1")
    pool.note_affinity("k3", "b:1")
    assert pool.migrate_affinity("a:1", "c:1") == 2
    assert pool.migrate_affinity("a:1", "c:1") == 0
    pool.note_load("b:1", active=0, queued=0)
    pool.note_load("c:1", active=5, queued=2)
    assert pool.remove_backend("c:1")
    assert dict(pool._affinity) == {"k1": "b:1", "k2": "b:1", "k3": "b:1"}
    lone = _frozen_pool(rt, ["a:1"])
    lone.note_affinity("k1", "a:1")
    lone.remove_backend("a:1")
    assert dict(lone._affinity) == {}


# -- byte-for-byte parity with the JAX router ------------------------------


class FakeTime:
    """The routers' ``time`` module under a scripted clock."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t

    def sleep(self, s):
        self.t += s


def _pool_script(mod):
    """Load samples, affinity, a dead mark, drains and recovery under a
    fake clock: every pick's order and the pool's views."""
    clock = FakeTime()
    mod.time, real = clock, mod.time
    try:
        pool = mod.BackendPool("10.0.0.1:80,10.0.0.2:80,10.0.0.3:80",
                               cooldown_s=15.0)
        out = [pool.pick() for _ in range(4)]
        pool.note_load("10.0.0.1:80", 3, 1)
        pool.note_load("10.0.0.2:80", 0, 0)
        out.append(pool.pick())
        key = mod._affinity_key("/v1/completions", json.dumps(
            {"prompt": "history " * 100}).encode())
        pool.note_affinity(key, "10.0.0.3:80")
        out += [pool.pick(key), pool.pick()]
        clock.t += 3.0
        pool.note_load("10.0.0.3:80", 6, 0)
        out.append(pool.pick(key))             # 6 > 0 + slack: yields
        pool.mark_dead("10.0.0.2:80")
        out += [pool.pick(key), pool.cooling(), pool.fleet()]
        clock.t += mod.LOAD_TTL_S + 1          # every sample stale
        out += [pool.pick(key), pool.pick()]
        pool.note_draining("10.0.0.1:80")
        out += [pool.pick(), pool.draining()]
        clock.t += 15.0                        # the cooldown is over
        pool.note_health("10.0.0.2:80", {"status": "ok"})
        out += [pool.pick(), pool.cooling(), pool.fleet()]
        out.append(pool.add_backend("10.0.0.9:80"))
        out.append(pool.remove_backend("10.0.0.3:80"))
        out += [dict(pool._affinity), pool.addrs(), pool.pick(key)]
        return out
    finally:
        mod.time = real


def test_pool_script_matches_jax():
    got = [json.dumps(_pool_script(m), sort_keys=True)
           for m in (jrouter, trouter)]
    assert got[0] == got[1]


_BODIES = [
    ("/v1/completions", {"prompt": "shared prefix " * 40 + "tail A"}),
    ("/v1/completions", {"prompt": ["first", "second"]}),
    ("/v1/completions", {"prompt": ""}),
    ("/v1/completions", {"prompt": 7}),
    ("/v1/chat/completions", {"messages": [
        {"role": "system", "content": "You are helpful. " * 100},
        {"role": "user", "content": "plan my trip"}]}),
    ("/v1/chat/completions", {"messages": [
        {"role": "user", "content": "é" * 600},
        {"role": "assistant", "content": "sure"}]}),
    ("/v1/chat/completions", {"messages": []}),
    ("/v1/chat/completions", {"messages": "not a list"}),
]


def test_affinity_keys_match_jax():
    bodies = [(p, json.dumps(b).encode()) for p, b in _BODIES] + \
        [("/v1/completions", b"not json"), ("/v1/completions", None)]
    got = [[m._affinity_key(p, b) for p, b in bodies]
           for m in (jrouter, trouter)]
    assert got[0] == got[1]
    assert sum(k is not None for k in got[0]) == 4


_RELAYED = [
    b'data: {"choices":[{"index":0,"text":"a","token_ids":[7]}]}',
    b'data: {"choices":[{"index":0,"delta":{"content":"bc"},'
    b'"token_ids":[9,10]}]}',
    b": keep-alive",
    b"data: not json",
    b'data: {"choices":[{"index":0,"text":"\xc3\xa9","token_ids":[]}]}',
]


@pytest.mark.parametrize("body", [
    {"prompt": "x", "stream": True, "max_tokens": 8, "seed": 3},
    {"messages": [{"role": "user", "content": "hi"}], "stream": True},
    {"prompt": "x", "stream": True, "max_tokens": "many"},
], ids=["completion", "chat-no-max-tokens", "bad-max-tokens"])
def test_failover_body_matches_jax(body):
    outs = []
    for m in (jrouter, trouter):
        raw = json.dumps(body).encode()
        fo = m._failover_spec("/v1/completions", raw)
        st = {"token_ids": [], "chars": 0, "done": False, "tagged": False,
              "headers_sent": False, "failovers": 0}
        states = []
        for ev in _RELAYED + [b"data: [DONE]"]:
            m._track_sse_event(ev, st)
            states.append(json.dumps(st, sort_keys=True))
        outs.append((states, m._continuation_body(fo, st),
                     [m._failover_spec(p, raw) for p in (
                         "/v1/chat/completions", "/v1/models")],
                     m._failover_spec("/v1/completions", json.dumps(
                         {**body, "n": 2}).encode())))
    assert outs[0] == outs[1]
    assert json.loads(outs[1][1])["resume_token_ids"] == [7, 9, 10]


def _capacity(tps, ceiling, **kw):
    return {"offered_tps": tps, "ceiling_tps": ceiling,
            "ceiling_source": "devmon", "utilization": tps / ceiling,
            "queue_delay_s": 0.0, "seconds_to_saturation": 3600.0,
            "saturated": False, "recommended_replicas": 1, "idle": False,
            "last_submit_age_s": 0.5, "projected_offered_tps": tps, **kw}


_FLEETS = [
    {},
    {"a:1": {"health": {"capacity": _capacity(120.0, 400.0)},
             "health_age_s": 0.4},
     "b:1": {"health": {"status": "ok"}},
     "c:1": {}},
    {"a:1": {"health": {"capacity": _capacity(
        900.0, 400.0, saturated=True, projected_offered_tps=1300.0,
        offered={"admitted_per_s": 3.0, "shed_per_s": 1.5})}},
     "b:1": {"health": {"capacity": _capacity(
         350.0, 400.0, offered={"admitted_per_s": 2.0,
                                "shed_per_s": 0.0})}}},
    {"a:1": {"health": {"capacity": _capacity(
        0.0, 1e-9, idle=True, offered={"admitted_per_s": 0.0,
                                       "shed_per_s": 0.2})}},
     "b:1": {"health": {"capacity": {"idle": True}}}},
]


def test_fleet_capacity_matches_jax():
    got = [[json.dumps(m._fleet_capacity(f), sort_keys=True)
            for f in _FLEETS] for m in (jrouter, trouter)]
    assert got[0] == got[1]
    assert json.loads(got[1][2])["fleet"]["recommended_replicas"] >= 3


def _fresh_registries(monkeypatch):
    """Every registry a router's /metrics renders, fresh, on both sides."""
    from aws_k8s_ansible_provisioner_tpu.serving import (autoscaler,
                                                         capacity, devmon,
                                                         flightrec, metrics,
                                                         slo, tracing)
    from aws_k8s_ansible_provisioner_tpu_torch.serving import \
        autoscaler as tautoscaler
    from aws_k8s_ansible_provisioner_tpu_torch.serving import \
        capacity as tcapacity
    from aws_k8s_ansible_provisioner_tpu_torch.serving import \
        devmon as tdevmon
    from aws_k8s_ansible_provisioner_tpu_torch.serving import \
        flightrec as tflightrec
    from aws_k8s_ansible_provisioner_tpu_torch.serving import \
        metrics as tmetrics
    from aws_k8s_ansible_provisioner_tpu_torch.serving import slo as tslo
    from aws_k8s_ansible_provisioner_tpu_torch.serving import \
        tracing as ttracing

    for pkg in ((autoscaler, capacity, devmon, flightrec, metrics, slo,
                 tracing),
                (tautoscaler, tcapacity, tdevmon, tflightrec, tmetrics, tslo,
                 ttracing)):
        a, c, d, f, m, s, t = pkg
        for mod in (a, c, d, s):
            monkeypatch.setattr(mod, "metrics", type(mod.metrics)())
            mod.reset()
        monkeypatch.setattr(f, "metrics", f.FlightMetrics())
        monkeypatch.setattr(t, "metrics", type(t.metrics)())
        monkeypatch.setattr(m, "pipeline", m.PipelineMetrics())


def _traffic(mod):
    """The same requests through a router in front of two fake backends
    (one of them refusing connections first); its /metrics text, classic
    and OpenMetrics."""
    be = _serve(FakeEngine)
    router = _router(mod, _fixed_order_pool(
        mod, ["127.255.255.254:9", _addr(be)]))    # the first refuses
    try:
        _get(router.server_port, "/v1/models")
        for i in range(3):
            _post(router.server_port, "/v1/completions", {"prompt": f"{i}"})
        with pytest.raises(urllib.error.HTTPError):
            _get(router.server_port, "/v1/unknown")
        _get(router.server_port, "/health")
        _get(router.server_port, "/debug/capacity")
        _, text = _get(router.server_port, "/metrics")
        req = urllib.request.Request(
            f"http://127.0.0.1:{router.server_port}/metrics",
            headers={"Accept": "application/openmetrics-text"})
        with urllib.request.urlopen(req, timeout=10) as r:
            om = r.read()
        return text, om
    finally:
        _shutdown(router, be)


def test_metrics_text_matches_jax(monkeypatch):
    _fresh_registries(monkeypatch)
    hs = [m.RouterHandler for m in (jrouter, trouter)]
    saved = [(h.pool, h.metrics, h.tracer) for h in hs]
    try:
        got = [_traffic(m) for m in (jrouter, trouter)]
    finally:
        for h, s in zip(hs, saved):
            h.pool, h.metrics, h.tracer = s
    assert got[0][0] == got[1][0]
    assert got[0][1] == got[1][1]
    text = got[1][0].decode()
    for name in ("tpu_router_failovers_total 5", "tpu_autoscale_",
                 "tpu_capacity_", "tpu_router_backend_dead_total 5"):
        assert name in text, name


_ARGVS = [
    ["--backend-service", "engine:8000"],
    ["--backend-service", "10.0.0.1:8000,10.0.0.2:8000", "--host",
     "127.0.0.1", "--port", "9090", "--otlp-endpoint", "http://c:4318",
     "--trace-sample", "0.25"],
    ["--backend-service", "engine:8000", "--autoscale", "1",
     "--autoscale-launch-cmd", "python -m x --port {port}",
     "--autoscale-min", "0", "--autoscale-max", "4",
     "--autoscale-standby", "2", "--autoscale-interval", "0.5",
     "--autoscale-stable", "3", "--autoscale-cooldown", "20",
     "--autoscale-idle-timeout", "60"],
]


def _main_args(mod, argv, monkeypatch):
    seen = {}
    monkeypatch.setattr(mod, "serve", lambda *a, **kw: seen.update(
        args=a, kw=kw))
    mod.main(argv)
    return seen


@pytest.mark.parametrize("argv", _ARGVS, ids=["dns", "static", "autoscale"])
def test_command_line_matches_jax(argv, monkeypatch):
    """``main`` hands ``serve`` the same arguments for the same argv."""
    got = [_main_args(m, argv, monkeypatch) for m in (jrouter, trouter)]
    assert got[0] == got[1] and got[0]["args"][0] == argv[1]


def test_every_jax_router_flag_is_taken(capsys):
    import re

    flags = []
    for m in (jrouter, trouter):
        with pytest.raises(SystemExit):
            m.main(["--help"])
        flags.append(sorted(set(re.findall(r"--[a-z][a-z-]+",
                                           capsys.readouterr().out))))
    assert flags[0] == flags[1] and "--autoscale-launch-cmd" in flags[1]
