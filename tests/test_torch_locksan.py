"""The port's LockSan (``serving/locksan.py``): the inversion and
shared-write cases of ``tests/test_locksan.py`` against the port's copy,
and a routed seeded run (the port's router in front of a port replica,
tiny_qwen3 on the byte tokenizer) under the port's sanitizer: no violation
recorded, and the same bytes as the run without it. ``tests/conftest.py``
installs the JAX package's sanitizer under ``TPU_LOCKSAN=1``; the port's is
installed by this file's fixture.
"""

import json
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import pytest
import torch
from test_torch_failover import _port_server
from test_torch_server import jax_server  # noqa: F401

from aws_k8s_ansible_provisioner_tpu_torch.serving import locksan
from aws_k8s_ansible_provisioner_tpu_torch.serving import router as trouter

torch.set_num_threads(2)


@pytest.fixture()
def san():
    """The port's sanitizer installed for the test, prior state restored
    after."""
    was = locksan.installed()
    locksan.install()
    locksan.reset()
    yield locksan
    locksan.reset()
    if not was:
        locksan.uninstall()


def _pair(san, tag):
    return (san.tracked_lock(site=f"{tag}.py:1"),
            san.tracked_lock(site=f"{tag}.py:2"))


def test_two_lock_inversion_caught(san):
    a, b = _pair(san, "synthetic")
    with a, b:
        pass
    assert san.violations() == []
    with b, a:
        pass
    vs = san.violations()
    assert len(vs) == 1 and vs[0]["kind"] == "lock-order-inversion"
    assert "synthetic.py:1" in vs[0]["detail"]
    assert "synthetic.py:2" in vs[0]["detail"]


def test_inversion_report_is_reproducible(san):
    def provoke():
        a, b = _pair(san, "repro")
        with a, b:
            pass
        with b, a:
            pass
        out = san.report()
        san.reset()
        return out

    assert provoke() == provoke() != "locksan: clean"


def test_inversion_across_threads(san):
    a, b = _pair(san, "xthread")
    first_done = threading.Event()

    def t1():
        with a, b:
            pass
        first_done.set()

    def t2():
        first_done.wait(10)
        with b, a:
            pass

    ts = [threading.Thread(target=t) for t in (t1, t2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(10)
    vs = san.violations()
    assert len(vs) == 1 and vs[0]["kind"] == "lock-order-inversion"


def test_three_lock_cycle_and_clean_orders(san):
    a, b = _pair(san, "tri")
    c = san.tracked_lock(site="tri.py:3")
    r = san.tracked_lock(reentrant=True, site="tri.py:4")
    with r, r, a, b:                         # re-entry is not an ordering
        pass
    with b, c:
        pass
    assert san.violations() == []
    with c, a:
        pass
    vs = san.violations()
    assert len(vs) == 1 and vs[0]["kind"] == "lock-order-inversion"


def test_port_serving_lock_sites_are_wrapped(san):
    import queue

    from aws_k8s_ansible_provisioner_tpu_torch.serving.metrics import Counter

    m = Counter("tpu_serve_locksan_probe", "probe")
    assert isinstance(m._lock, locksan._SanLock)
    assert "serving/metrics.py" in m._lock.site
    assert not isinstance(queue.Queue().mutex, locksan._SanLock)


class _Shared:
    _R5_THREAD_OWNED = ("counter",)

    def __init__(self):
        self.counter = 0


@pytest.mark.parametrize("guarded", [False, True])
def test_shared_writes_from_two_threads(san, guarded):
    """Unguarded writes from two distinct threads are flagged, guarded
    ones are clean (the attributes of ``_R5_THREAD_OWNED``)."""
    undo = san.watch_attrs(_Shared)
    try:
        obj = _Shared()
        obj._lock = san.tracked_lock(site="watch.py:1")

        def write():
            if guarded:
                with obj._lock:
                    obj.counter += 1
            else:
                obj.counter += 1

        t = threading.Thread(target=write)
        t.start()
        t.join(10)
        write()
        assert obj.counter == 2
        vs = san.violations()
        if guarded:
            assert vs == []
        else:
            assert len(vs) == 1 and vs[0]["kind"] == "unguarded-shared-write"
            assert "counter" in vs[0]["detail"]
    finally:
        undo()


def _scrub(raw: bytes, stream: bool) -> bytes:
    """Response bytes minus the per-request id, timestamp and trace ids."""
    def clean(obj):
        obj.pop("id", None)
        obj.pop("created", None)
        if isinstance(obj.get("usage"), dict):
            obj["usage"].pop("trace_id", None)
            obj["usage"].pop("span_id", None)
        return json.dumps(obj, sort_keys=True).encode()

    if not stream:
        return clean(json.loads(raw))
    return b"\n".join(
        b"data: " + clean(json.loads(ln[len(b"data: "):]))
        if ln.startswith(b"data: ") and ln != b"data: [DONE]" else ln
        for ln in raw.split(b"\n"))


def _routed_run(jstate):
    """A fresh port replica behind the port router: a seeded completion
    whole and streamed, their bytes."""
    base, _, stop_replica = _port_server(jstate)
    h = trouter.RouterHandler
    saved = (h.pool, h.metrics, h.tracer)
    h.pool = trouter.BackendPool(base.split("//")[1])
    h.metrics, h.tracer = trouter.RouterMetrics(), None
    srv = ThreadingHTTPServer(("127.0.0.1", 0), h)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    body = {"model": "tiny-qwen3", "prompt": "locksan parity", "seed": 777,
            "temperature": 0.8, "max_tokens": 12, "ignore_eos": True}
    out = []
    try:
        for stream in (False, True):
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.server_port}/v1/completions",
                data=json.dumps({**body, "stream": stream}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                out.append(_scrub(r.read(), stream))
    finally:
        srv.shutdown()
        srv.server_close()
        h.pool, h.metrics, h.tracer = saved
        stop_replica()
    return out


def test_routed_run_is_clean_and_unchanged_under_locksan(jax_server):  # noqa: F811
    """The replica and the router built with the sanitizer installed (so
    that their serving/ locks are tracked) answer the bytes they answer
    without it, and no violation is recorded."""
    off = _routed_run(jax_server[1])
    was = locksan.installed()
    locksan.install()
    locksan.reset()
    try:
        on = _routed_run(jax_server[1])
        stats = locksan.stats()
        vs = locksan.violations()
    finally:
        locksan.reset()
        if not was:
            locksan.uninstall()
    assert vs == [], locksan.report()
    assert stats["acquires"] > 0 and stats["sites"] > 0
    assert on == off
    assert b'"text"' in on[0] and b"data: [DONE]" in on[1]
