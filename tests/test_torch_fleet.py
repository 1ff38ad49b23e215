"""A mixed fleet on the CPU: one JAX replica and one port replica
(in-process servers, tiny_qwen3 on the same weights, the byte tokenizer)
behind the port's router and behind the JAX router. Seeded greedy and
sampled requests, whole and streamed, answer byte for byte alike (every
field but the per-request id, timestamp and trace ids) through either
router and straight to either replica. The port router's own faults
(``connect_refused``, ``stream_read_error``) fail a stream over onto the
other replica and splice it exactly; a cold start through the port's
router launches a port replica with a ``CallableLauncher``. Then the
serving manifest's router command taken by the port router's command
line, and the replica's ``tpu_autoscale_*`` family at its defaults, as the
JAX replica renders it.
"""

import json
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path

import pytest
import torch
import yaml
from test_torch_failover import _port_server
from test_torch_server import jax_server  # noqa: F401
from test_torch_stream import _norm, _stream, stream_text

from aws_k8s_ansible_provisioner_tpu.serving import router as jrouter
from aws_k8s_ansible_provisioner_tpu_torch.serving import autoscaler
from aws_k8s_ansible_provisioner_tpu_torch.serving import chaos, flightrec
from aws_k8s_ansible_provisioner_tpu_torch.serving import router as trouter

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
ROUTERS = {"jax": jrouter, "port": trouter}
_BODIES = {
    "greedy": {"model": "tiny-qwen3", "prompt": "Hi! How are you?",
               "max_tokens": 14, "ignore_eos": True},
    "seeded": {"model": "tiny-qwen3", "prompt": "A seeded fleet request",
               "max_tokens": 14, "ignore_eos": True, "seed": 4242,
               "temperature": 0.8, "top_p": 0.9},
    "chat": {"model": "tiny-qwen3", "max_tokens": 10, "ignore_eos": True,
             "seed": 7, "temperature": 0.7,
             "messages": [{"role": "user", "content": "Hello fleet"}]},
}


def _router(mod, addrs, stop):
    """``mod``'s router over ``addrs`` with its load poller."""
    pool = mod.BackendPool(",".join(addrs), cooldown_s=5.0)
    mod.RouterHandler.pool = pool
    mod.RouterHandler.metrics = mod.RouterMetrics()
    mod.RouterHandler.tracer = None
    mod.start_load_poller(pool, interval_s=0.1, stop=stop)
    srv = ThreadingHTTPServer(("127.0.0.1", 0), mod.RouterHandler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


@pytest.fixture(scope="module")
def fleet(jax_server):  # noqa: F811
    """(the JAX replica's URL, the port replica's URL and state, the
    JAX replica's state)."""
    base, state, stop = _port_server(jax_server[1])
    yield jax_server[0], base, state, jax_server[1]
    stop()


@pytest.fixture
def routers(fleet):
    """Both routers, each over both replicas; their URLs by name."""
    addrs = [u.split("//")[1] for u in fleet[:2]]
    saved = {k: (m.RouterHandler.pool, m.RouterHandler.metrics,
                 m.RouterHandler.tracer) for k, m in ROUTERS.items()}
    stop = threading.Event()
    srvs = {k: _router(m, addrs, stop) for k, m in ROUTERS.items()}
    yield {k: f"http://127.0.0.1:{s.server_port}" for k, s in srvs.items()}
    stop.set()
    for k, s in srvs.items():
        s.shutdown()
        s.server_close()
        h = ROUTERS[k].RouterHandler
        h.pool, h.metrics, h.tracer = saved[k]
    chaos.reset()


def _scrub(obj):
    obj = dict(obj)
    obj.pop("id", None)
    obj.pop("created", None)
    if isinstance(obj.get("usage"), dict):
        obj["usage"] = {k: v for k, v in obj["usage"].items()
                        if k not in ("trace_id", "span_id")}
    return obj


def _answer(base, name, stream):
    body = _BODIES[name]
    path = "/v1/chat/completions" if "messages" in body else \
        "/v1/completions"
    if stream:
        status, _, events = _stream(base + path, {**body, "stream": True})
        assert status == 200 and events[-1] == "[DONE]", events
        return [_norm(ev)[0] for ev in events]
    req = urllib.request.Request(
        base + path, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return _scrub(json.loads(r.read()))


@pytest.mark.parametrize("stream", [False, True], ids=["whole", "stream"])
@pytest.mark.parametrize("name", sorted(_BODIES))
def test_mixed_fleet_answers_alike(fleet, routers, name, stream):
    """Straight to the JAX replica, straight to the port replica, through
    the JAX router and through the port router (twice each): one answer."""
    want = _answer(fleet[0], name, stream)
    got = {"port replica": _answer(fleet[1], name, stream)}
    for k, url in routers.items():
        for i in range(2):
            got[f"{k} router {i}"] = _answer(url, name, stream)
    for where, answer in got.items():
        assert answer == want, where


def _until(cond, timeout=30.0):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < timeout, "condition not reached"
        time.sleep(0.02)


@pytest.mark.parametrize("fault", ["connect_refused", "stream_read_error"])
@pytest.mark.parametrize("name", ["greedy", "seeded", "chat"])
def test_port_router_faults_splice_exactly(fleet, routers, fault, name):
    """The port router's fault sends the stream to the other replica (a
    refused connect before anything was sent; a reset read after three
    relayed events, continued with ``resume_token_ids``): the client's
    stream is the undisturbed one, text, ids and events."""
    body = _BODIES[name]
    path = "/v1/chat/completions" if "messages" in body else \
        "/v1/completions"
    url = routers["port"] + path
    ref = _stream(url, {**body, "stream": True})
    m = trouter.RouterHandler.metrics
    before = (m.dead_marks.total(), m.failovers.total(),
              m.stream_failovers.total())
    chaos.reset()
    if fault == "connect_refused":
        chaos.get().inject(fault, times=1)
    else:
        chaos.get().inject(fault, times=1, after_events=3)
    try:
        got = _stream(url, {**body, "stream": True})
        assert chaos.get().stats()[fault]["fired"] == 1
    finally:
        chaos.reset()
        flightrec.reset()    # the fault's event leaves the process ring
    assert got[0] == 200 and got[2][-1] == "[DONE]"
    assert stream_text(got[2]) == stream_text(ref[2])
    if fault == "connect_refused":
        assert [_norm(e)[0] for e in got[2]] == [_norm(e)[0] for e in ref[2]]
    after = (m.dead_marks.total(), m.failovers.total(),
             m.stream_failovers.total())
    assert after[0] == before[0] + 1
    assert (after[1] - before[1], after[2] - before[2]) == \
        ((1, 0) if fault == "connect_refused" else (0, 1))
    # the poller's health probe returns the replica to rotation
    _until(lambda: not trouter.RouterHandler.pool.cooling())


def test_cold_start_through_the_port_router(fleet):
    """A parked fleet behind the port router: the first request is held
    while the autoscaler launches a port replica (``CallableLauncher``),
    then served with the JAX replica's answer."""
    launched = []

    def spawn():
        base, state, stop = _port_server(fleet[3])
        launched.append(stop)
        return base.split("//")[1], stop

    h = trouter.RouterHandler
    saved = (h.pool, h.metrics, h.tracer)
    pool = trouter.BackendPool("127.0.0.1:9,127.0.0.1:10")
    for a in ("127.0.0.1:9", "127.0.0.1:10"):
        pool.remove_backend(a)
    h.pool, h.metrics, h.tracer = pool, trouter.RouterMetrics(), None
    stop = threading.Event()
    trouter.start_load_poller(pool, interval_s=0.1, stop=stop)
    srv = ThreadingHTTPServer(("127.0.0.1", 0), h)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    a = autoscaler.configure(enabled=True, min_replicas=0, max_replicas=1,
                             interval_s=0.05, stable_s=0.1, cooldown_s=0.5,
                             standby=0, ready_timeout_s=60.0)
    a.install(pool=pool, launcher=autoscaler.CallableLauncher(
        spawn, lambda addr, stop_fn: stop_fn()),
        recommend_fn=lambda: {"recommended_replicas": 1,
                              "offered_tps": 1.0, "reporting_replicas": 0})
    a.start()
    try:
        assert a.status()["parked"] is True and pool.pick() == []
        got = _answer(f"http://127.0.0.1:{srv.server_port}", "seeded", True)
        assert got == _answer(fleet[0], "seeded", True)
        st = a.status()
        assert (st["cold_starts"], st["actual"], len(launched)) == (1, 1, 1)
    finally:
        a.stop()
        autoscaler.reset()
        stop.set()
        srv.shutdown()
        srv.server_close()
        h.pool, h.metrics, h.tracer = saved
        for stop_fn in launched:
            stop_fn()


def _router_commands():
    """The router container's arguments after the module name, from the
    serving manifest rendered as the deploy tests render it, with
    ``rehearsal_cpu`` false and true."""
    from aws_k8s_ansible_provisioner_tpu.config import render_manifest

    out = {}
    for cpu in (False, True):
        kw = dict(rehearsal_cpu=True, model="tiny-qwen3",
                  framework_image="img", storage_class="standard") \
            if cpu else {}
        text = render_manifest(
            str(REPO / "deploy" / "manifests" / "serving.yaml.j2"), **kw)
        cmds = [c["command"] for d in yaml.safe_load_all(text)
                if d and d["kind"] == "Deployment"
                for c in d["spec"]["template"]["spec"]["containers"]
                if "aws_k8s_ansible_provisioner_tpu.serving.router"
                in c.get("command", [])]
        assert len(cmds) == 1
        out[cpu] = cmds[0][cmds[0].index("-m") + 2:]
    return out


@pytest.mark.parametrize("rehearsal_cpu", [False, True])
def test_manifest_router_command_is_taken(rehearsal_cpu, monkeypatch):
    """The manifest's router arguments parse with the port router's
    command line and reach ``serve`` as the JAX router's do."""
    argv = _router_commands()[rehearsal_cpu]
    assert "--autoscale" in argv and "--backend-service" in argv
    seen = []
    for mod in (jrouter, trouter):
        monkeypatch.setattr(mod, "serve", lambda *a, **kw: seen.append(
            (a, kw)))
        mod.main(argv)
    assert len(seen) == 2 and seen[0] == seen[1]
    assert seen[1][0][0] == argv[argv.index("--backend-service") + 1]


def test_replica_renders_the_autoscale_family_at_its_defaults(fleet,
                                                              monkeypatch):
    """A replica process runs no controller: its ``/metrics`` carries the
    ``tpu_autoscale_*`` family at the defaults, series for series and
    value for value as the JAX replica's."""
    from aws_k8s_ansible_provisioner_tpu.serving import autoscaler as jauto

    series = []
    for mod, base in ((jauto, fleet[0]), (autoscaler, fleet[1])):
        monkeypatch.setattr(mod, "metrics", mod.AutoscaleMetrics())
        mod.reset()
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            text = r.read().decode()
        series.append([ln for ln in text.splitlines()
                       if "tpu_autoscale_" in ln])
    assert series[0] == series[1]
    names = {ln.split("{")[0].split()[0] for ln in series[1]
             if not ln.startswith("#")}
    assert {"tpu_autoscale_desired_replicas",
            "tpu_autoscale_actual_replicas",
            "tpu_autoscale_launch_failures",
            "tpu_autoscale_export_drops_total"} <= names
