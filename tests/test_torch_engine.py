"""The port's serving engine against the JAX ``Engine`` on the same weights.

tiny_qwen3 at float32 with unquantized weights: the JAX parameters (scaled
so that greedy streams do not collapse onto one repeated token) reach the
port through ``from_jax_params``, both engines get the same concurrent
greedy requests, and every request's token stream must be identical.
Without chunking, prompts go through batched prefill and the fused decode
horizon; with ``prefill_chunk`` long prompts go through ``mixed_step`` (the
ragged paged kernel path); a small pool forces preemption and resume.
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


def _run_both(model, prompts, max_tokens, **serving):
    jcfg, jparams, tcfg, tparams = model
    je = JEngine(jcfg, jparams, JServing(weights_dtype="bf16",
                                         prefix_cache=False, **BASE,
                                         **serving))
    te = TEngine(tcfg, tparams, TServing(weights_dtype="bf16", **BASE,
                                         **serving), device="cpu")
    jr = [je.submit(JRequest(prompt_ids=p, max_tokens=max_tokens,
                             ignore_eos=True)) for p in prompts]
    tr = [te.submit(TRequest(prompt_ids=p, max_tokens=max_tokens,
                             ignore_eos=True)) for p in prompts]
    while (any(s is not None for s in je.slot_req) or je.pending
           or je._chunk is not None):
        je.step()
    te.run_until_idle()
    for p, a, b in zip(prompts, jr, tr):
        assert b.generated == a.generated, (len(p), a.generated, b.generated)
        assert b.finish_reason == a.finish_reason == "length"
    assert len(set(tuple(r.generated) for r in tr)) > 1
    assert te.allocator.free_pages == te.allocator.num_pages - 1
    return te


def test_concurrent_greedy_streams_match_jax(model):
    """Six requests over four slots: batched prefill, decode horizon,
    admission into freed slots."""
    te = _run_both(model, _prompts((5, 12, 3, 21, 9, 30), seed=1), 16)
    assert te.counts["prefill_dispatches"] >= 2
    assert te.counts["decode_dispatches"] > 0
    assert te.counts["mixed_dispatches"] == 0


def test_chunked_prefill_streams_match_jax(model):
    """prefill_chunk 16: the prompts of 30 and 40 tokens are walked in
    chunks packed beside the decode rows of the running requests."""
    before = tpa.cache_write_rows_paged.launches
    te = _run_both(model, _prompts((5, 30, 12, 3, 40, 9), seed=2), 14,
                   prefill_chunk=16)
    assert te.counts["mixed_dispatches"] >= 4
    assert tpa.cache_write_rows_paged.launches == before   # CPU: plain


def test_streams_match_jax_under_page_pressure(model):
    """A pool of 12 pages for 4 slots of 8-page windows: admission waits on
    free pages and running requests are preempted and resumed."""
    te = _run_both(model, _prompts((20, 14, 25, 9, 17), seed=3), 24,
                   kv_pool_pages=12)
    assert te.counts["preemptions"] > 0
