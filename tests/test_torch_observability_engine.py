"""The port engine's observability hooks against the JAX engine's:
recording changes no token, the flight recorder sees the same lifecycle
events at the same edges, and every dispatch books device time
(``device_busy_seconds``, the decode bubble, devmon's program kinds) and
the HBM ledger's components from tensor metadata.

tiny_qwen3 (the byte tokenizer's vocabulary) at float32 on the same scaled
weights as ``test_torch_lifecycle.py``; the engines step by hand. On the
CPU device time is host time from a dispatch to its settle (the JAX busy
watermark); on a card it is CUDA events (``chip_smoke.py``'s observability
phase).
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aws_k8s_ansible_provisioner_tpu.config import ServingConfig as JServing
from aws_k8s_ansible_provisioner_tpu.config import tiny_qwen3 as jax_tiny
from aws_k8s_ansible_provisioner_tpu.models.layers import init_params
from aws_k8s_ansible_provisioner_tpu.serving import capacity as jcapacity
from aws_k8s_ansible_provisioner_tpu.serving import devmon as jdevmon
from aws_k8s_ansible_provisioner_tpu.serving import flightrec as jflight
from aws_k8s_ansible_provisioner_tpu.serving import slo as jslo
from aws_k8s_ansible_provisioner_tpu.serving.engine import Engine as JEngine
from aws_k8s_ansible_provisioner_tpu.serving.engine import \
    EngineOverloaded as JOverloaded
from aws_k8s_ansible_provisioner_tpu.serving.engine import Request as JRequest
from aws_k8s_ansible_provisioner_tpu_torch.config import (MeshConfig,
                                                          ModelConfig)
from aws_k8s_ansible_provisioner_tpu_torch.config import \
    ServingConfig as TServing
from aws_k8s_ansible_provisioner_tpu_torch.models.convert import \
    from_jax_params
from aws_k8s_ansible_provisioner_tpu_torch.parallel import mesh as tmesh
from aws_k8s_ansible_provisioner_tpu_torch.serving import capacity as tcapacity
from aws_k8s_ansible_provisioner_tpu_torch.serving import devmon as tdevmon
from aws_k8s_ansible_provisioner_tpu_torch.serving import flightrec as tflight
from aws_k8s_ansible_provisioner_tpu_torch.serving import slo as tslo
from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import \
    Engine as TEngine
from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import \
    EngineOverloaded as TOverloaded
from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import \
    Request as TRequest
from aws_k8s_ansible_provisioner_tpu_torch.utils.tokenizer import \
    ByteTokenizer

torch.set_num_threads(2)

TOK = ByteTokenizer()
# the JAX chaos tests' engine (tests/test_chaos.py), with a queue of 2 and
# no admission-pressure preemption (a wall-clock rule)
SCENARIO = dict(weights_dtype="bf16", max_decode_slots=2, max_cache_len=128,
                page_size=32, prefill_buckets=(16, 32, 64, 128),
                dtype="float32", derived_seed=0, max_queue_depth=2,
                admission_preempt_after_s=0)
STREAMS = dict(weights_dtype="bf16", max_decode_slots=4, max_cache_len=128,
               page_size=8, prefill_buckets=(16, 32, 64), dtype="float32",
               prefill_chunk=16, derived_seed=0)
# the ring's dispatch-level events: the port's walk dispatches mixed_step
# also with no decode row active (the engine docstring's first
# difference), so these differ by design; every lifecycle event matches
DISPATCH_EVENTS = ("pipeline_dispatch", "pipeline_fetch")


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
def fresh_modules(monkeypatch):
    """Fresh process recorders and flight counters on both sides (the
    engines record into their package's singletons, which other tests of
    the process have used)."""
    for mods in ((jflight, jslo, jdevmon, jcapacity),
                 (tflight, tslo, tdevmon, tcapacity)):
        for m in mods:
            m.reset()
    for fr in (jflight, tflight):
        monkeypatch.setattr(fr, "metrics", fr.FlightMetrics())
    yield


def _recording(on: bool):
    """Every observability module of the port on (the defaults) or off."""
    tflight.configure(enabled=on)
    tslo.configure(enabled=on)
    tdevmon.configure(enabled=on)
    tcapacity.configure(enabled=on)


def _run(eng, max_steps=20000):
    for _ in range(max_steps):
        if not eng.step():
            return
    raise AssertionError("engine did not go idle")


def _settled(eng):
    """Make each ``step`` of a JAX engine wait for the device work it
    dispatched. On the CPU the XLA client may alias an aligned numpy array
    that ``jnp.asarray`` uploads instead of copying it: the JAX engine's
    cached block table (``_decode_operands``) is such an upload, so a
    pipelined dispatch still in flight can read the rows that the next
    step's bookkeeping rewrites in place (a freed slot, a new page). Which
    arrays alias depends on the heap's state, that is on the tests that ran
    before in the process. Waiting after each step takes the race away and
    changes no token of a correct run."""
    step = eng.step

    def settled_step():
        busy = step()
        jax.block_until_ready(eng.cache)
        return busy

    eng.step = settled_step
    return eng


def _prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(20, 250, int(k)).tolist()
            for k in rng.integers(5, 40, n)]


def _stream_requests(cls):
    prompts = _prompts(6)
    out = []
    for i, p in enumerate(prompts):
        kw = dict(prompt_ids=p, max_tokens=12, ignore_eos=True)
        if i % 2:
            kw.update(temperature=0.9, top_p=0.9, top_k=30, seed=100 + i)
        out.append(cls(**kw))
    return out


@pytest.mark.parametrize("pipeline", [1, 0])
def test_streams_identical_with_recording_on_and_off(model, pipeline):
    """Seeded greedy and sampled streams of the port engine are the same
    with every observability module recording and with all of them off,
    and equal the JAX engine's (recording) on the same weights."""
    jcfg, jp, tcfg, tp = model
    streams = []
    for on in (True, False):
        _recording(on)
        eng = TEngine(tcfg, tp, TServing(decode_pipeline=pipeline,
                                         **STREAMS), device="cpu")
        reqs = [eng.submit(r) for r in _stream_requests(TRequest)]
        _run(eng)
        streams.append([r.generated for r in reqs])
        if on:
            assert tflight.get().tail(1), "nothing was recorded"
            assert eng.metrics.device_busy_seconds.total() > 0
        else:
            assert not tflight.get().tail(1)
            assert not tdevmon.get().program_stats()
    assert streams[0] == streams[1]
    je = _settled(JEngine(jcfg, jp, JServing(decode_pipeline=pipeline,
                                              **STREAMS)))
    jreqs = [je.submit(r) for r in _stream_requests(JRequest)]
    _run(je)
    assert [r.generated for r in jreqs] == streams[0]


def _scenario(eng, req_cls, overloaded, flight):
    """One run through the lifecycle's edges: two running requests, a shed
    (queue full), a queued request cancelled and one past its deadline, a
    preemption (the pool refuses one allocation mid-decode), a drain with
    its shed, a running request cancelled, the rest to the end. Returns
    the ring's (type, request id) pairs, the streams and the finishes."""
    def ids(n, k):
        return [(7 * k + 3 * i) % 200 + 20 for i in range(n)]

    a = eng.submit(req_cls(prompt_ids=ids(20, 1), max_tokens=100,
                           ignore_eos=True))
    b = eng.submit(req_cls(prompt_ids=ids(20, 2), max_tokens=40,
                           ignore_eos=True))
    eng.step()
    c = eng.submit(req_cls(prompt_ids=ids(10, 3), max_tokens=8,
                           ignore_eos=True))
    d = eng.submit(req_cls(prompt_ids=ids(10, 4), max_tokens=8,
                           ignore_eos=True))
    with pytest.raises(overloaded):
        eng.submit(req_cls(prompt_ids=ids(10, 5), max_tokens=8))
    eng.cancel(c)
    d.t_deadline = time.monotonic() - 1.0
    for _ in range(4):
        eng.step()
    for alloc in eng.allocators:
        alloc.fail_next_allocs = 1
    for _ in range(4):
        eng.step()
    eng.begin_drain(60.0)
    with pytest.raises(overloaded):
        eng.submit(req_cls(prompt_ids=ids(10, 6), max_tokens=8))
    eng.end_drain()
    eng.cancel(a)
    _run(eng)
    ring = [(e["type"], e.get("request_id"))
            for e in flight.get().tail(4096)]
    return ring, [a.generated, b.generated], \
        [r.finish_reason for r in (a, b, c, d)]


def test_flight_events_follow_the_jax_engine(model):
    """The scenario holds preempt, shed, deadline, cancel and drain, and
    both engines record the same sequence of lifecycle events (by name);
    the streams and finishes match too."""
    jcfg, jp, tcfg, tp = model
    jring, jgen, jfin = _scenario(
        _settled(JEngine(jcfg, jp, JServing(**SCENARIO))), JRequest,
        JOverloaded, jflight)
    te = TEngine(tcfg, tp, TServing(**SCENARIO), device="cpu")
    tring, tgen, tfin = _scenario(te, TRequest, TOverloaded, tflight)

    def names(ring):
        return [t for t, _ in ring if t not in DISPATCH_EVENTS]

    assert names(tring) == names(jring)
    for want in ("preempt", "shed", "deadline_reap", "cancel_reap", "drain",
                 "queue", "admit", "finish", "prefill_chunk"):
        assert want in names(tring), want
    assert tfin == jfin == ["cancelled", "length", "cancelled", "timeout"]
    assert tgen == jgen
    # the anomalous finishes kept their timelines for /debug/flight
    summary = tflight.get().summary()
    assert summary["dumps_total"] == jflight.get().summary()["dumps_total"]
    assert summary["last_anomaly"]["reason"] == \
        jflight.get().summary()["last_anomaly"]["reason"]
    assert sorted(te._free) == [0, 1] and \
        te.allocator.stats()["pages_live"] == 0


def test_device_time_is_booked_by_program_kind(model):
    """A paged run books device seconds at every settle: the busy counter,
    a decode step duration per fetch, and devmon's ``decode``,
    ``mixed_step`` (the chunk walk), ``prefill`` and ``prefill_batch``
    kinds, each with positive seconds and roofline shares."""
    _, _, tcfg, tp = model
    eng = TEngine(tcfg, tp, TServing(**STREAMS), device="cpu")
    reqs = [eng.submit(TRequest(prompt_ids=p, max_tokens=10,
                                ignore_eos=True))
            for p in _prompts(5, seed=3) + [list(range(30, 90))]]
    _run(eng)
    assert all(len(r.generated) == 10 for r in reqs)
    m = eng.metrics
    assert m.device_busy_seconds.total() > 0
    assert m.decode_step_duration._total > 0
    progs = tdevmon.get().program_stats()
    for kind in ("decode", "mixed_step", "prefill_batch"):
        p = progs[kind]
        assert p["dispatches"] > 0 and p["device_seconds"] > 0, kind
        assert 0 < p["mfu"] and 0 < p["membw_util"], kind
    total = sum(p["device_seconds"] for p in progs.values())
    assert total == pytest.approx(m.device_busy_seconds.total(), rel=1e-9)
    # the busy watermark: no second is booked twice, so the booked time
    # stays within the run's wall time
    assert tdevmon.get().duty_cycle() <= 1.0


def test_dense_engine_books_its_chunk_walk(model):
    """The dense engine's chunk walk books ``prefill_chunk`` and its
    decode dispatches ``decode``."""
    _, _, tcfg, tp = model
    eng = TEngine(tcfg, tp, TServing(paged=False, **STREAMS), device="cpu")
    r = eng.submit(TRequest(prompt_ids=list(range(30, 90)), max_tokens=6,
                            ignore_eos=True))
    eng.submit(TRequest(prompt_ids=[40, 41, 42], max_tokens=30,
                        ignore_eos=True))
    _run(eng)
    assert len(r.generated) == 6
    progs = tdevmon.get().program_stats()
    assert progs["prefill_chunk"]["dispatches"] >= 3
    assert progs["decode"]["device_seconds"] > 0


def test_decode_bubble_is_fed_on_the_synchronous_path(model):
    """With ``decode_pipeline=0`` every decode fetch leaves the device
    idle until the next dispatch: the gap is booked as the decode bubble
    (the JAX engine's site); the pipelined run books less of it."""
    _, _, tcfg, tp = model
    bubble = {}
    for pipeline in (0, 1):
        eng = TEngine(tcfg, tp, TServing(decode_pipeline=pipeline,
                                         **STREAMS), device="cpu")
        eng.submit(TRequest(prompt_ids=[50, 51, 52, 53], max_tokens=40,
                            ignore_eos=True))
        _run(eng)
        bubble[pipeline] = eng.metrics.decode_bubble_seconds.total()
    assert bubble[0] > 0


def test_hbm_ledger_components_from_tensor_metadata(model):
    """The ledger's components are the JAX engine's names over the port's
    tensors (params, the pool by its live and evictable pages, the decode
    carry and operands), their total tracks the pool's pages, and an
    adopted manifest's total sets the drift and its verdict."""
    _, _, tcfg, tp = model
    eng = TEngine(tcfg, tp, TServing(**STREAMS), device="cpu")
    snap = tdevmon.get().hbm_snapshot()
    comp = snap["components"]
    assert set(comp) == {"params", "kv_pages", "kv_pages_evictable",
                         "sampler_carry", "operand_cache"}
    assert comp["params"] == sum(t.numel() * t.element_size()
                                 for t in eng.model.buffers())
    assert comp["kv_pages"] == 0.0 and snap["verdict"] == "ok"
    reqs = [eng.submit(TRequest(prompt_ids=p, max_tokens=30,
                                ignore_eos=True)) for p in _prompts(3)]
    for _ in range(6):
        eng.step()
    assert tdevmon.get().hbm_snapshot()["components"]["kv_pages"] > 0
    _run(eng)
    assert all(r.finish_reason == "length" for r in reqs)
    eng.aot = {"hbm_total_bytes": 1.0}
    # a server's configure() keeps the wiring the engine installed
    snap = tdevmon.configure(hbm_tolerance_mb=0.0).hbm_snapshot()
    assert snap["verdict"] == "warn"
    assert snap["drift_bytes"] == snap["live_bytes"] - 1.0


def test_run_forever_steps_under_the_step_lock(model):
    """Every step of the engine thread holds ``step_lock``, so another
    thread holding it (the server's profiler, as it starts and stops)
    acts between two steps."""
    import threading

    _, _, tcfg, tp = model
    eng = TEngine(tcfg, tp, TServing(**STREAMS), device="cpu")
    held, step = [], eng.step

    def watched():
        held.append(eng.step_lock.locked())
        return step()

    eng.step = watched
    stop = threading.Event()
    th = threading.Thread(target=eng.run_forever, args=(stop,), daemon=True)
    th.start()
    try:
        r = eng.submit(TRequest(prompt_ids=[70, 71, 72], max_tokens=5,
                                ignore_eos=True))
        r.wait(timeout=60)
        with eng.step_lock:           # the engine waits here, between steps
            n = len(held)
            time.sleep(0.2)
            assert len(held) == n
    finally:
        stop.set()
        th.join(10)
    assert len(r.generated) == 5 and held and all(held)


def test_the_process_monitors_do_not_keep_an_engine_alive(model):
    """The device monitor's HBM samplers and the capacity estimator's
    probes hold the engine weakly: a dropped engine (its cache, graphs and
    params) is freed although the process singletons outlive it, and the
    probes then read empty."""
    import gc
    import weakref

    _, _, tcfg, tp = model
    eng = TEngine(tcfg, tp, TServing(**STREAMS), device="cpu")
    ref = weakref.ref(eng)
    assert tdevmon.get().hbm_snapshot()["components"]
    del eng
    gc.collect()
    assert ref() is None
    assert tdevmon.get().hbm_snapshot()["components"] == {}
    assert tcapacity.get().snapshot()["queue_depth"] == 0


def test_hbm_ledger_of_a_mesh_has_one_component_a_shard(model):
    """Under a (dp, tp) mesh each mesh position's params (a tensor two
    positions hold counted once) and each pool partition's pages are
    components of their own."""
    from aws_k8s_ansible_provisioner_tpu_torch.config import tiny_qwen3
    from aws_k8s_ansible_provisioner_tpu_torch.models.layers import \
        init_params as tinit

    cfg = tiny_qwen3()                  # a vocabulary tp 2 divides
    params = tinit(cfg, torch.Generator().manual_seed(0), torch.float32)
    mesh = tmesh.make_mesh(MeshConfig(dp=2, tp=2), ["cpu"] * 4)
    eng = TEngine(cfg, params, TServing(**STREAMS), mesh=mesh)
    comp = tdevmon.get().hbm_snapshot()["components"]
    params = [k for k in comp if k.startswith("params[")]
    pages = [k for k in comp if k.startswith("kv_pages[")]
    # the tp shards of dp group 0; group 1's replicas are the same tensors
    # here (every position on the CPU), counted once
    assert sorted(params) == ["params[0,0,0,0,0]", "params[0,0,0,0,1]"]
    assert len(pages) == 4 and "params" not in comp, sorted(comp)
    r = eng.submit(TRequest(prompt_ids=[60, 61, 62], max_tokens=5,
                            ignore_eos=True))
    _run(eng)
    assert len(r.generated) == 5
    assert eng.metrics.device_busy_seconds.total() > 0
