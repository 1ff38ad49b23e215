"""The port's serving engine against the JAX ``Engine`` on the same weights.

tiny_qwen3 at float32 with unquantized weights: the JAX parameters (scaled
so that greedy streams do not collapse onto one repeated token) reach the
port through ``from_jax_params``, both engines get the same concurrent
requests, and every request's token stream must be identical. Without
chunking, prompts go through batched prefill and the fused decode horizon;
with ``prefill_chunk`` long prompts go through ``mixed_step`` (the ragged
paged kernel path); a small pool forces preemption and resume. Each runs
with the bf16/f32 pool (``kv_dtype="auto"``) and the int8 pool. Seeded
sampled streams (per-request ``seed``, or the engine's draw under a pinned
``derived_seed``) must be identical too, and must not depend on the batch
around the request.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aws_k8s_ansible_provisioner_tpu.config import ServingConfig as JServing
from aws_k8s_ansible_provisioner_tpu.config import tiny_qwen3 as jax_tiny
from aws_k8s_ansible_provisioner_tpu.models.layers import init_params
from aws_k8s_ansible_provisioner_tpu.serving.engine import Engine as JEngine
from aws_k8s_ansible_provisioner_tpu.serving.engine import Request as JRequest
from aws_k8s_ansible_provisioner_tpu_torch.config import ModelConfig
from aws_k8s_ansible_provisioner_tpu_torch.config import \
    ServingConfig as TServing
from aws_k8s_ansible_provisioner_tpu_torch.models.convert import \
    from_jax_params
from aws_k8s_ansible_provisioner_tpu_torch.ops import paged_attention as tpa
from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import \
    Engine as TEngine
from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import \
    Request as TRequest

torch.set_num_threads(2)

BASE = dict(max_decode_slots=4, max_cache_len=64, page_size=8,
            prefill_buckets=(8, 16, 32), dtype="float32")


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


def _prompts(lengths, seed):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(2, 128, n)] for n in lengths]


KV_DTYPES = pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
# the JAX engine's int8 row-write kernel needs pages of 32 rows
INT8_PAGE = 32


def _engines(model, **serving):
    jcfg, jparams, tcfg, tparams = model
    serving = {**BASE, **serving}
    if serving.get("kv_dtype") == "int8":
        serving["page_size"] = INT8_PAGE
    je = JEngine(jcfg, jparams, JServing(weights_dtype="bf16",
                                         prefix_cache=False, **serving))
    te = TEngine(tcfg, tparams, TServing(weights_dtype="bf16", **serving),
                 device="cpu")
    return je, te


def _run_jax(je):
    while (any(s is not None for s in je.slot_req) or je.pending
           or je._chunk is not None):
        je.step()


def _run_both(model, prompts, max_tokens, **serving):
    je, te = _engines(model, **serving)
    jr = [je.submit(JRequest(prompt_ids=p, max_tokens=max_tokens,
                             ignore_eos=True)) for p in prompts]
    tr = [te.submit(TRequest(prompt_ids=p, max_tokens=max_tokens,
                             ignore_eos=True)) for p in prompts]
    _run_jax(je)
    te.run_until_idle()
    assert ("ks" in te.cache) == (serving.get("kv_dtype") == "int8")
    for p, a, b in zip(prompts, jr, tr):
        assert b.generated == a.generated, (len(p), a.generated, b.generated)
        assert b.finish_reason == a.finish_reason == "length"
    assert len(set(tuple(r.generated) for r in tr)) > 1
    assert te.allocator.free_pages == te.allocator.num_pages - 1
    return te


@KV_DTYPES
def test_concurrent_greedy_streams_match_jax(model, kv_dtype):
    """Six requests over four slots: batched prefill, decode horizon,
    admission into freed slots."""
    te = _run_both(model, _prompts((5, 12, 3, 21, 9, 30), seed=1), 16,
                   kv_dtype=kv_dtype)
    assert te.counts["prefill_dispatches"] >= 2
    assert te.counts["decode_dispatches"] > 0
    # an admission into a freed slot while a decode dispatch is in flight
    # takes the chunk walk (one mixed dispatch), as in the JAX engine,
    # and leaves the pipeline open
    assert te.counts["mixed_dispatches"] > 0
    assert te.counts["pipeline_drains_prefill"] == 0


@KV_DTYPES
def test_chunked_prefill_streams_match_jax(model, kv_dtype):
    """prefill_chunk 16: the prompts of 30 and 40 tokens are walked in
    chunks packed beside the decode rows of the running requests."""
    before = tpa.launch_counts()
    te = _run_both(model, _prompts((5, 30, 12, 3, 40, 9), seed=2), 14,
                   prefill_chunk=16, kv_dtype=kv_dtype)
    assert te.counts["mixed_dispatches"] >= 4
    assert tpa.launch_counts() == before                   # CPU: plain


@KV_DTYPES
def test_streams_match_jax_under_page_pressure(model, kv_dtype):
    """A pool of 12 pages for 4 slots of 8-page windows (3 of 2-page
    windows with int8's 32-row pages): admission waits on free pages and
    running requests are preempted and resumed."""
    te = _run_both(model, _prompts((20, 14, 25, 9, 17), seed=3), 24,
                   kv_pool_pages=3 if kv_dtype == "int8" else 12,
                   kv_dtype=kv_dtype)
    assert te.counts["preemptions"] > 0


SAMPLED = dict(temperature=0.8, top_p=0.9, top_k=20, ignore_eos=True)


@KV_DTYPES
def test_seeded_sampled_streams_match_jax(model, kv_dtype):
    """Sampled requests (temperature 0.8, top-p 0.9, top-k 20) with their
    own seeds, one without a seed under a pinned derived_seed, and a greedy
    one; the prompts of 30 and 40 tokens walk through mixed_step, so the
    chunk row's draw is keyed too. Streams byte-identical to the JAX
    engine's."""
    je, te = _engines(model, prefill_chunk=16, derived_seed=1234,
                      kv_dtype=kv_dtype)
    prompts = _prompts((5, 30, 12, 40, 9, 7), seed=5)
    seeds = [11, 2**32 + 5, None, 2**31, 0, 77]
    greedy = 4
    reqs = []
    for eng, cls in ((je, JRequest), (te, TRequest)):
        reqs.append([eng.submit(cls(
            prompt_ids=p, max_tokens=12, seed=s,
            **(dict(ignore_eos=True) if i == greedy else SAMPLED)))
            for i, (p, s) in enumerate(zip(prompts, seeds))])
    _run_jax(je)
    te.run_until_idle()
    jr, tr = reqs
    for a, b in zip(jr, tr):
        assert b.eff_seed == a.eff_seed
        assert b.generated == a.generated, (a.seed, a.generated, b.generated)
    assert tr[1].eff_seed == 5 and tr[2].eff_seed != 0
    assert te.counts["mixed_dispatches"] >= 4
    # the draws really sample: not every stream is its greedy twin
    assert len({t for r in tr for t in r.generated}) > 12


def test_seeded_stream_does_not_depend_on_the_batch(model):
    """The same seeded request alone, then admitted while three other
    requests decode beside it in other slots: the same stream."""
    _, te = _engines(model, kv_dtype="int8")
    prompt = _prompts((11,), seed=6)[0]
    alone = te.submit(TRequest(prompt_ids=prompt, max_tokens=16, seed=4242,
                               **SAMPLED))
    te.run_until_idle()
    others = [te.submit(TRequest(prompt_ids=p, max_tokens=20, seed=i,
                                 **SAMPLED))
              for i, p in enumerate(_prompts((6, 20, 13), seed=7))]
    while te.pending or len(te._active_slots()) < len(others):
        te.step()
    crowded = te.submit(TRequest(prompt_ids=prompt, max_tokens=16,
                                 seed=4242, **SAMPLED))
    te.run_until_idle()
    assert crowded.generated == alone.generated
    assert all(len(r.generated) == 20 for r in others)
    assert len(set(alone.generated)) > 1
    # released slots are greedy again: an idle batch draws no noise
    assert not te.temps.any()
