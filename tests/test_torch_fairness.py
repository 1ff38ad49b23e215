"""The prefill/decode fairness floor (``ServingConfig.prefill_fairness``)
of the port's engine against the JAX ``Engine``.

tiny_qwen3 at float32 on the same weights (as ``test_torch_engine.py``):
the order in which each engine dispatches prefills (P), decodes (D) and
chunks (C) under a stream of arrivals must be the same, paged and dense,
with the floor at its default 4 and off (0), and the streams byte-identical.
Both sides run with ``admission_preempt_after_s=0``: the admission-
pressure preemption is a wall-clock rule (``tests/test_torch_lifecycle.py``
holds it).
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
from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import \
    Engine as TEngine
from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import \
    Request as TRequest

torch.set_num_threads(2)

BASE = dict(max_cache_len=64, page_size=8, prefill_buckets=(8, 16, 32),
            dtype="float32", weights_dtype="bf16", prefix_cache=False)


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


def _engines(model, **serving):
    jcfg, jparams, tcfg, tparams = model
    serving = {**BASE, **serving}
    je = JEngine(jcfg, jparams, JServing(admission_preempt_after_s=0,
                                         **serving))
    te = TEngine(tcfg, tparams, TServing(admission_preempt_after_s=0,
                                         **serving), device="cpu")
    return je, te


def _record(engine, kinds: dict) -> list:
    """Wrap the engine's dispatch methods ({name: letter}) so that each call
    appends its letter to the returned list."""
    seq = []
    for name, kind in kinds.items():
        orig = getattr(engine, name)

        def wrapped(*args, _orig=orig, _kind=kind, **kw):
            seq.append(_kind)
            return _orig(*args, **kw)

        setattr(engine, name, wrapped)
    return seq


def _jax_busy(je) -> bool:
    return (any(s is not None for s in je.slot_req) or je.pending
            or je._chunk is not None or je._inflight is not None)


@pytest.mark.parametrize("fairness", [4, 0])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_dispatch_order_matches_jax_under_arrivals(model, paged, fairness):
    """8 slots, one prompt a prefill dispatch: one slot decoding, then 6
    arrivals. With the floor at 4 both engines force a decode dispatch
    after the fourth prefill in a row (paged: the next admission, under the
    decode in flight, walks one chunk); off, they admit all six first."""
    je, te = _engines(model, paged=paged, max_decode_slots=8,
                      max_prefill_batch=1, prefill_fairness=fairness)
    jseq = _record(je, {"_do_prefill": "P", "_do_prefill_batch": "P",
                        "_do_decode": "D", "_advance_chunk": "C"})
    tseq = _record(te, {"_prefill_batch": "P", "_decode": "D",
                        "_advance_chunk": "C"})
    rng = np.random.default_rng(7)
    prompts = [[int(t) for t in rng.integers(2, 128, n)]
               for n in (5, 7, 3, 9, 6, 4, 8)]
    jr = [je.submit(JRequest(prompt_ids=prompts[0], max_tokens=30,
                             ignore_eos=True))]
    tr = [te.submit(TRequest(prompt_ids=prompts[0], max_tokens=30,
                             ignore_eos=True))]
    je.step()
    te.step()
    jr += [je.submit(JRequest(prompt_ids=p, max_tokens=6, ignore_eos=True))
           for p in prompts[1:]]
    tr += [te.submit(TRequest(prompt_ids=p, max_tokens=6, ignore_eos=True))
           for p in prompts[1:]]
    while _jax_busy(je):
        je.step()
    te.run_until_idle()
    assert "".join(tseq) == "".join(jseq)
    head = "".join(tseq)[:6]
    if fairness:
        assert head == ("PPPPDC" if paged else "PPPPDP"), tseq
    else:
        assert head == "PPPPPP", tseq
    for a, b in zip(jr, tr):
        assert b.generated == a.generated
        assert b.finish_reason == a.finish_reason == "length"


def _long_request_progress(engine, Request, steps=30):
    """tests/test_paged_engine.py's scenario: a long request, then one
    one-token arrival per step; the long request's tokens after ``steps``
    steps."""
    long = engine.submit(Request(prompt_ids=[5, 4, 3], max_tokens=40,
                                 ignore_eos=True))
    for i in range(steps):
        engine.submit(Request(prompt_ids=[7 + i % 9] * 4, max_tokens=1,
                              ignore_eos=True))
        engine.step()
    return len(long.generated)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_fairness_floor_keeps_decode_flowing(model, paged):
    """The shape of the JAX test ``test_prefill_fairness_floor_keeps_decode_
    flowing``: two slots, a decode horizon of 8, a new arrival every step.
    Off (0), the long request advances at a trickle; at the default 4,
    every fifth dispatch is a full-horizon decode. The port's progress
    equals the JAX engine's at both settings."""
    got = {}
    for fairness in (0, 4):
        je, te = _engines(model, paged=paged, max_decode_slots=2,
                          decode_horizon=8, prefill_fairness=fairness)
        got[fairness] = (_long_request_progress(te, TRequest),
                         _long_request_progress(je, JRequest))
        assert got[fairness][0] == got[fairness][1], got
    assert got[4][0] >= got[0][0] + 8, got


def test_prefill_fairness_defaults_to_the_jax_value():
    assert TServing().prefill_fairness == JServing().prefill_fairness == 4
