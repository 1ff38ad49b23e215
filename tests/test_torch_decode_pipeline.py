"""The port's one-deep decode pipeline (``ServingConfig.decode_pipeline``)
against its synchronous path and the JAX engine's pipeline, on the CPU.

The scenarios of tests/test_decode_pipeline.py that the port serves, at
tiny sizes (tiny_qwen3 at float32, tiny_mistral for the window):

- seeded streams, greedy and sampled, are byte-identical with the pipeline
  on and off (paged and dense, bf16/f32 and int8 KV), and equal the JAX
  engine's with the pipeline on on both sides;
- a chunked prompt admitted mid-decode rides the pipeline (no chunk drain);
- a mid-stream cancel discards the surplus and leaves a neighbour's stream
  alone; a failed fetch discards the dispatch in flight un-emitted and the
  engine keeps serving;
- speculative decoding (prompt lookup and a draft model) gives the same
  streams with the pipeline on and off;
- a decode substep reads nothing from the device on the host: ``sample``
  with ``any_sampled`` and ``decode_steps`` run with the tensor's host
  reads patched to raise (the plain attention of the CPU is exempt: it
  reads lengths on the host by design), which is what lets a CUDA graph
  capture the horizon (``programs.DecodeGraphs``);
- ``DecodeGraphs`` without capture leaves the carry in its buffers and
  gives the eager ``decode_steps``' tokens.
"""

import dataclasses
import functools
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aws_k8s_ansible_provisioner_tpu.config import ServingConfig as JServing
from aws_k8s_ansible_provisioner_tpu.config import tiny_mistral as jax_mistral
from aws_k8s_ansible_provisioner_tpu.config import tiny_qwen3 as jax_qwen3
from aws_k8s_ansible_provisioner_tpu.models.layers import init_params
from aws_k8s_ansible_provisioner_tpu.serving.engine import Engine as JEngine
from aws_k8s_ansible_provisioner_tpu.serving.engine import Request as JRequest
from aws_k8s_ansible_provisioner_tpu_torch.config import ModelConfig
from aws_k8s_ansible_provisioner_tpu_torch.config import \
    ServingConfig as TServing
from aws_k8s_ansible_provisioner_tpu_torch.models.convert import \
    from_jax_params
from aws_k8s_ansible_provisioner_tpu_torch.models.layers import DecoderLM
from aws_k8s_ansible_provisioner_tpu_torch.ops import sampling
from aws_k8s_ansible_provisioner_tpu_torch.serving import kv_cache as kvc
from aws_k8s_ansible_provisioner_tpu_torch.serving import paged_kv as pkv
from aws_k8s_ansible_provisioner_tpu_torch.serving import programs
from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import \
    Engine as TEngine
from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import \
    Request as TRequest

torch.set_num_threads(2)

BASE = dict(max_decode_slots=4, max_cache_len=64, page_size=8,
            prefill_buckets=(8, 16, 32), dtype="float32", derived_seed=0)
SAMPLED = dict(temperature=0.9, top_k=20, top_p=0.9, ignore_eos=True)
LAYOUTS = pytest.mark.parametrize("paged,kv_dtype", [
    (True, "auto"), (True, "int8"), (False, "auto"), (False, "int8")])


def _scaled(params, by):
    """The JAX init scaled so that greedy streams do not collapse onto one
    repeated token."""
    def go(node):
        return {k: go(v) if isinstance(v, dict) else
                v * by if k == "kernel" else v for k, v in node.items()}

    out = go(params)
    out["embed"] = {"weight": out["embed"]["weight"] * by}
    return out


def _model(jcfg, seed, by):
    jp = init_params(jcfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    jp = _scaled(jp, by) if by else jp
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    return jcfg, jp, tcfg, from_jax_params(jax.tree.map(np.asarray, jp),
                                           tcfg)


@pytest.fixture(scope="module")
def qwen():
    return _model(jax_qwen3(), 0, 8)


@pytest.fixture(scope="module")
def mistral():
    return _model(jax_mistral(), 0, 8)


def _serving(kv_dtype="auto", **over):
    kw = {**BASE, **over, "kv_dtype": kv_dtype}
    if kv_dtype == "int8":
        kw["page_size"] = 32    # the JAX engine's int8 row write needs 32
    return kw


def _port(model, draft=None, **kw):
    _, _, tcfg, tparams = model
    return TEngine(tcfg, tparams, TServing(weights_dtype="bf16",
                                           prefix_cache=False, **kw),
                   device="cpu", draft=draft)


def _jax(model, **kw):
    jcfg, jparams, _, _ = model
    return JEngine(jcfg, jparams, JServing(weights_dtype="bf16",
                                           prefix_cache=False, **kw))


def _prompts(lengths, seed):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(2, 128, n)] for n in lengths]


def _specs(seed=1):
    """Six requests over four slots (admissions into freed slots while
    others decode): greedy ones and seeded sampled ones."""
    prompts = _prompts((5, 12, 3, 21, 9, 30), seed)
    out = []
    for i, p in enumerate(prompts):
        if i % 2:
            out.append(dict(prompt_ids=p, max_tokens=14, seed=40 + i,
                            **SAMPLED))
        else:
            out.append(dict(prompt_ids=p, max_tokens=16, ignore_eos=True))
    return out


def _run(engine, specs):
    cls = JRequest if isinstance(engine, JEngine) else TRequest
    reqs = [engine.submit(cls(**s)) for s in specs]
    for _ in range(20000):
        if not engine.step():
            break
    else:
        raise AssertionError("engine did not go idle")
    return reqs


def _streams(reqs):
    return [(tuple(r.generated), r.finish_reason) for r in reqs]


def _released(te):
    assert te._inflight is None and te.idle()
    if te.paged:
        assert te.allocator.free_pages == te.allocator.num_pages - 1


@LAYOUTS
def test_seeded_streams_identical_pipeline_on_off(qwen, paged, kv_dtype):
    """The pipeline changes when tokens reach the host, never which: greedy
    and seeded sampled streams over the paged pool and the dense cache."""
    kw = _serving(kv_dtype, paged=paged)
    on = _port(qwen, decode_pipeline=1, **kw)
    off = _port(qwen, decode_pipeline=0, **kw)
    got_on, got_off = _run(on, _specs()), _run(off, _specs())
    assert _streams(got_on) == _streams(got_off)
    assert all(r.finish_reason == "length" for r in got_on)
    assert len({r.generated[0] for r in got_on}) > 1
    assert on.counts["pipeline_dispatches"] > 0
    # admissions into freed slots: the paged engine takes them through the
    # chunk walk under the dispatch in flight, the dense one drains first
    assert (on.counts["pipeline_drains_prefill"] == 0) == paged
    assert off.counts["pipeline_drains_drain"] == 0
    assert off._inflight is None
    _released(on)
    _released(off)


@LAYOUTS
def test_pipelined_streams_match_jax(qwen, paged, kv_dtype):
    """The same requests through the JAX engine, both pipelined."""
    kw = _serving(kv_dtype, paged=paged, decode_pipeline=1)
    ref = _run(_jax(qwen, **kw), _specs(seed=3))
    te = _port(qwen, **kw)
    got = _run(te, _specs(seed=3))
    assert _streams(got) == _streams(ref)
    assert te.counts["pipeline_dispatches"] > 0
    _released(te)


@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
def test_windowed_streams_identical_pipeline_on_off_and_jax(mistral,
                                                           kv_dtype):
    """tiny_mistral (window 8): 30 tokens a request run several windows
    past the window; pipelined, synchronous and the JAX engine agree."""
    specs = [dict(s, max_tokens=30) for s in _specs(seed=5)]
    kw = _serving(kv_dtype)
    on = _run(_port(mistral, decode_pipeline=1, **kw), specs)
    off = _run(_port(mistral, decode_pipeline=0, **kw), specs)
    ref = _run(_jax(mistral, decode_pipeline=1, **kw), specs)
    assert _streams(on) == _streams(off) == _streams(ref)


def test_chunked_prompt_mid_decode_keeps_the_pipeline_open(qwen):
    """A long prompt admitted while a stream decodes walks its chunks in
    mixed dispatches that ride the pipeline: no chunk drain, and the
    streams equal the synchronous engine's (JAX
    test_mixed_traffic_pipeline_stays_open_and_byte_identical)."""
    long_prompt = _prompts((50,), 7)[0]

    def run(pipeline):
        te = _port(qwen, decode_pipeline=pipeline,
                   **_serving(prefill_chunk=16, max_cache_len=128,
                              decode_horizon=4))
        first = te.submit(TRequest(prompt_ids=[5, 9, 2], max_tokens=60,
                                   seed=42, **SAMPLED))
        for _ in range(4):
            te.step()
        if pipeline:
            assert te._inflight is not None
        late = te.submit(TRequest(prompt_ids=long_prompt, max_tokens=8,
                                  seed=7, **SAMPLED))
        te.run_until_idle()
        return te, first, late

    te1, f1, l1 = run(1)
    te0, f0, l0 = run(0)
    assert _streams([f1, l1]) == _streams([f0, l0])
    assert len(l1.generated) == 8 and len(f1.generated) == 60
    assert te1.counts["mixed_dispatches"] >= 4
    assert te1.counts["pipeline_drains_chunk"] == 0
    assert te1.counts["pipeline_drains_prefill"] == 0
    _released(te1)


def test_mid_stream_cancel_discards_surplus_neighbour_unchanged(qwen):
    """A cancel with a dispatch in flight: the victim's surplus tokens are
    never emitted, its slot and pages are released once, and the seeded
    neighbour's stream is the one it has alone (JAX :234)."""
    keeper_spec = dict(prompt_ids=[5, 9, 2], max_tokens=24, seed=42,
                       **SAMPLED)
    solo = _run(_port(qwen, **_serving()), [keeper_spec])[0]
    te = _port(qwen, **_serving())
    victim = te.submit(TRequest(prompt_ids=[9] * 4, max_tokens=50,
                                temperature=1.1, ignore_eos=True))
    keeper = te.submit(TRequest(**keeper_spec))
    for _ in range(1000):
        te.step()
        if len(victim.generated) >= 4:
            break
    assert te._inflight is not None
    n_at_cancel = len(victim.generated)
    te.cancel(victim)
    te.run_until_idle()
    assert victim.finish_reason == "cancelled"
    assert len(victim.generated) == n_at_cancel
    assert keeper.generated == solo.generated
    assert te.counts["finished"] == 2
    _released(te)


def test_failed_fetch_discards_inflight_and_recovers(qwen, monkeypatch):
    """The third fetch raises on the engine thread: the dispatch in flight
    is discarded un-emitted, the running requests fail with "error", their
    slots and pages are released once, and the same engine then serves a
    fresh request (JAX :335)."""
    te = _port(qwen, **_serving())
    fetch = TEngine._decode_fetch
    calls = {"n": 0, "emitted_at_fault": None}

    def failing(self, rec):
        calls["n"] += 1
        if calls["n"] == 3:
            calls["emitted_at_fault"] = self.counts["generated_tokens"]
            raise RuntimeError("injected fetch failure")
        return fetch(self, rec)

    monkeypatch.setattr(TEngine, "_decode_fetch", failing)
    stop = threading.Event()
    t = threading.Thread(target=te.run_forever, args=(stop,), daemon=True)
    t.start()
    try:
        doomed = [te.submit(TRequest(prompt_ids=[7 + i] * 4, max_tokens=48,
                                     temperature=1.0, ignore_eos=True))
                  for i in range(2)]
        for r in doomed:
            r.wait(timeout=60)
            assert r.finish_reason == "error", r.finish_reason
        assert te.counts["generated_tokens"] == calls["emitted_at_fault"]
        assert te.counts["pipeline_drains_fail"] == 1
        assert te._inflight is None
        assert "injected fetch failure" in te.last_error
        ok = te.submit(TRequest(prompt_ids=[2, 4, 6], max_tokens=6,
                                ignore_eos=True))
        assert len(ok.wait(timeout=60)) == 6
        assert ok.finish_reason == "length"
        deadline = time.monotonic() + 30
        while not te.idle() and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        stop.set()
        t.join(timeout=30)
    _released(te)


def _looping():
    """tiny_qwen3's unscaled init loops, so prompt lookup proposes."""
    rng = np.random.default_rng(1)
    pat = rng.integers(2, 128, 4).tolist()
    return [pat * 4, rng.integers(2, 128, 11).tolist() + pat * 2,
            _prompts((9,), 3)[0]]


@pytest.mark.parametrize("method", ["prompt_lookup", "draft"])
def test_spec_streams_identical_pipeline_on_off(qwen, method):
    """Prompt lookup and a self-draft: the verify settles the dispatch in
    flight (no spec drain) and the streams, a seeded sampled one among
    them, equal the synchronous engine's."""
    model = _model(jax_qwen3(), 0, 0)
    draft = (model[2], model[3]) if method == "draft" else None
    kw = _serving(spec_decode=True, spec_k=4, spec_ngram=3,
                  spec_method=method, max_cache_len=128, decode_horizon=4)
    specs = [dict(prompt_ids=p, max_tokens=24, ignore_eos=True)
             for p in _looping()]
    specs.append(dict(prompt_ids=_looping()[1], max_tokens=20, seed=3,
                      **SAMPLED))
    on_engine = _port(model, draft=draft, decode_pipeline=1, **kw)
    on = _run(on_engine, specs)
    off = _run(_port(model, draft=draft, decode_pipeline=0, **kw), specs)
    assert _streams(on) == _streams(off)
    assert on_engine.counts["spec_dispatches"] > 0
    assert on_engine.counts["spec_accepted_tokens"] > 0
    assert on_engine.counts["pipeline_drains_spec"] == 0
    _released(on_engine)


class _HostRead(RuntimeError):
    pass


_READS = ("__bool__", "item", "tolist", "cpu", "numpy", "__int__",
          "__float__")


def _forbid_host_reads(monkeypatch):
    """Patch the tensor's host reads to raise; returns a context manager
    that lifts the patch (for the plain attention, which reads lengths on
    the host)."""
    saved = {name: getattr(torch.Tensor, name) for name in _READS}

    def raiser(name):
        def read(self, *a, **kw):
            raise _HostRead(f"Tensor.{name} in a decode substep")
        return read

    for name in _READS:
        monkeypatch.setattr(torch.Tensor, name, raiser(name))

    class Lifted:
        def __enter__(self):
            for name, fn in saved.items():
                setattr(torch.Tensor, name, fn)

        def __exit__(self, *exc):
            for name in _READS:
                setattr(torch.Tensor, name, raiser(name))

    return Lifted


def test_sample_with_any_sampled_reads_nothing_on_the_host(monkeypatch):
    """Rows that sample: the same ids as without the flag, and no host read
    with it."""
    rng = np.random.default_rng(0)
    B, V = 6, 300
    logits = torch.from_numpy(rng.standard_normal((B, V)).astype(
        np.float32) * 3)
    temps = torch.tensor([0.0, 0.8, 1.2, 0.0, 0.7, 0.5])
    top_k = torch.tensor([0, 20, 0, 5, 64, 3], dtype=torch.int32)
    top_p = torch.tensor([1.0, 0.9, 0.8, 1.0, 1.0, 0.5])
    seeds = torch.arange(B, dtype=torch.int64) * 7919
    ctrs = torch.arange(B, dtype=torch.int32) + 30
    ref = sampling.sample(logits, temps, top_k, top_p, seeds, ctrs)
    _forbid_host_reads(monkeypatch)
    with pytest.raises(_HostRead):
        sampling.sample(logits, temps, top_k, top_p, seeds, ctrs)
    got = sampling.sample(logits, temps, top_k, top_p, seeds, ctrs,
                          any_sampled=True)
    monkeypatch.undo()
    assert torch.equal(got, ref)
    assert (ref[torch.tensor([1, 2, 4])] != logits.argmax(-1)[
        torch.tensor([1, 2, 4])].int()).any()


def _decode_inputs(tcfg, paged, quant, B=3):
    rng = np.random.default_rng(2)
    if paged:
        cache = pkv.init_pool(tcfg, 1 + B * 4, 8, torch.float32,
                              torch.device("cpu"), quant=quant)
        table = torch.from_numpy(
            (rng.permutation(B * 4) + 1).reshape(B, 4).astype(np.int32))
    else:
        cache = kvc.init_cache(tcfg, B, 32, torch.float32,
                               torch.device("cpu"), quant=quant)
        table = None
    for leaf in cache.values():
        leaf.copy_(torch.from_numpy(rng.standard_normal(leaf.shape).astype(
            np.float32)).to(leaf.dtype) if leaf.dtype != torch.int8 else
            torch.from_numpy(rng.integers(-127, 128, leaf.shape).astype(
                np.int8)))
        if leaf.dtype == torch.float32 and quant:
            leaf.abs_().mul_(0.01)
    tokens = torch.from_numpy(rng.integers(2, 128, B).astype(np.int32))
    lengths = torch.tensor([3, 17, 9], dtype=torch.int32)
    return cache, tokens, lengths, table


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_decode_substep_reads_nothing_on_the_host(qwen, monkeypatch, paged,
                                                  quant):
    """A horizon of 3 with rows that sample: no host read outside the
    plain attention (whose factory is wrapped to lift the patch around its
    callback), and the same tokens and cache as the unpatched run."""
    tcfg, tparams = qwen[2], qwen[3]
    model = DecoderLM(tcfg, tparams)
    B = 3
    operands = (torch.tensor([0.0, 0.9, 1.1]),
                torch.tensor([0, 20, 4], dtype=torch.int32),
                torch.tensor([1.0, 0.9, 0.7]),
                torch.tensor([5, 2**32 - 1, 77], dtype=torch.int64))

    def run(cache, tokens, lengths, table):
        return programs.decode_steps(model, 3, cache, tokens, lengths, table,
                                     *operands, any_sampled=True)

    inputs = _decode_inputs(tcfg, paged, quant, B)
    ref_cache = {k: v.clone() for k, v in inputs[0].items()}
    ref_cache, ref_out = run(ref_cache, *inputs[1:])
    lifted = _forbid_host_reads(monkeypatch)
    name = ("make_decode_attend_carry_paged" if paged
            else "make_decode_attend_carry")
    factory = getattr(programs, name)

    def exempt(*a, **kw):
        attend = factory(*a, **kw)

        @functools.wraps(attend)         # keeps its fuses_qk_prep mark
        def plain(*args):
            with lifted():
                return attend(*args)
        return plain

    monkeypatch.setattr(programs, name, exempt)
    cache, out = run(*inputs)
    monkeypatch.undo()
    assert torch.equal(out, ref_out)
    for k in cache:
        assert torch.equal(cache[k], ref_cache[k])


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_decode_graphs_carry_in_place(qwen, paged):
    """``DecodeGraphs.run`` without capture: eager ``decode_steps`` on its
    buffers, the carry left in them, so two runs of 2 and 3 substeps give
    the tokens and cache of one eager run of 5."""
    tcfg, tparams = qwen[2], qwen[3]
    model = DecoderLM(tcfg, tparams)
    cache, tokens, lengths, table = _decode_inputs(tcfg, paged, False)
    ref_cache = {k: v.clone() for k, v in cache.items()}
    sampled = (torch.tensor([0.0, 0.9, 1.1]),
               torch.tensor([0, 20, 4], dtype=torch.int32),
               torch.tensor([1.0, 0.9, 0.7]),
               torch.tensor([5, 6, 7], dtype=torch.int64))
    ref_cache, ref_out = programs.decode_steps(model, 5, ref_cache, tokens,
                                               lengths, table, *sampled)
    graphs = programs.DecodeGraphs(model, cache, 3,
                                   None if table is None else table.shape[1],
                                   (2, 3))
    assert not graphs.graphs
    for dst, src in zip((graphs.tokens, graphs.lengths, graphs.temps,
                         graphs.top_ks, graphs.top_ps, graphs.seeds),
                        (tokens, lengths) + sampled):
        dst.copy_(src)
    if table is not None:
        graphs.table.copy_(table)
    out = torch.cat([graphs.run(2, True), graphs.run(3, True)])
    assert torch.equal(out, ref_out)
    assert torch.equal(graphs.tokens, ref_out[-1])
    assert torch.equal(graphs.lengths, lengths + 5)
    for k in cache:
        assert torch.equal(cache[k], ref_cache[k])
