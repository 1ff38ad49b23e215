"""The Llama, Gemma, Phi and OPT families in the port against the JAX
package, on the CPU.

For each of ``tiny_llama`` (GQA, llama3 RoPE scaling), ``tiny_gemma``
(MQA, zero-centred RMSNorm, scaled embedding, GeGLU), ``tiny_phi``
(LayerNorm with biases, the parallel block, RoPE over 8 of 16 columns,
gelu_new, an lm_head bias) and ``tiny_opt`` (learned positions at
``positions + 2``, no RoPE, ReLU, biases) the JAX ``init_params``
(float32, numpy-seeded through its key) reach the port through
``from_jax_params``, and:

- ``model_forward``'s float32 logits agree within 1e-5 (projections and
  the embedding scaled by 4, so that the logits are of order 1 to 6;
  XLA's and PyTorch's CPU matmuls sum in their own orders, which moves a
  logit by about 1e-6 at that size);
- ``quantize_params`` gives the JAX package's int8 weights and scales bit
  for bit, biases, norms and ``pos_embed`` left as they are;
- greedy and seeded engine streams are byte-identical to the JAX
  ``Engine``'s: paged and dense, float32 and int8 KV, with the chunk walk
  and the decode horizon, prompt lookup and a self-draft;
- greedy streams equal HF ``generate`` on a model built in process by
  ``tests/test_model_parity.py``'s builders and converted by the port's
  own ``convert_state_dict`` (no download);
- an OPT request that reaches ``max_seq_len`` (its learned table's end)
  stops where the JAX engine's does;
- an adapter on ``tiny_opt``'s up and down projections (its MLP has no
  gate) gives the JAX engine's streams.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aws_k8s_ansible_provisioner_tpu import config as jconfig
from aws_k8s_ansible_provisioner_tpu.config import ServingConfig as JServing
from aws_k8s_ansible_provisioner_tpu.models import layers as jl
from aws_k8s_ansible_provisioner_tpu.models import quant as jq
from aws_k8s_ansible_provisioner_tpu.serving.engine import Engine as JEngine
from aws_k8s_ansible_provisioner_tpu.serving.engine import Request as JRequest
from aws_k8s_ansible_provisioner_tpu_torch import config as tconfig
from aws_k8s_ansible_provisioner_tpu_torch.config import \
    ServingConfig as TServing
from aws_k8s_ansible_provisioner_tpu_torch.models import hf_loader as thf
from aws_k8s_ansible_provisioner_tpu_torch.models import layers as tl
from aws_k8s_ansible_provisioner_tpu_torch.models import quant as tq
from aws_k8s_ansible_provisioner_tpu_torch.models.convert import \
    from_jax_params
from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import \
    Engine as TEngine
from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import \
    Request as TRequest
from test_lora import _write_adapter
from test_model_parity import _hf_gemma, _hf_llama, _hf_opt, _hf_phi

torch.set_num_threads(2)

FAMILIES = ["llama", "gemma", "phi", "opt"]
HF_BUILDERS = {"llama": _hf_llama, "gemma": _hf_gemma, "phi": _hf_phi,
               "opt": _hf_opt}
LOGIT_TOL = 1e-5

BASE = dict(max_decode_slots=4, max_cache_len=64, page_size=8,
            prefill_buckets=(8, 16, 32), dtype="float32", decode_horizon=4)
# the JAX engine's int8 row-write kernel needs pages of 32 rows
INT8_PAGE = 32
SAMPLED = dict(temperature=0.8, top_p=0.9, top_k=20, ignore_eos=True)


def _configs(fam, **over):
    name = f"tiny_{fam}"
    return (getattr(jconfig, name)(**over), getattr(tconfig, name)(**over))


def _scaled(tree, factor):
    """Projection kernels and the embedding times ``factor`` (norms,
    biases and learned positions stay), so that activations and logits are
    far from zero and greedy streams do not collapse onto one token."""
    def go(node):
        return {k: go(v) if isinstance(v, dict) else
                v * factor if k == "kernel" else v for k, v in node.items()}
    out = go(tree)
    out["embed"] = {"weight": tree["embed"]["weight"] * factor}
    return out


def _model(fam, factor=4.0, seed=0, **over):
    jcfg, tcfg = _configs(fam, **over)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jparams = _scaled(jl.init_params(jcfg, jax.random.PRNGKey(seed),
                                     dtype=jnp.float32), factor)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg)
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module", params=FAMILIES)
def model(request):
    return (request.param,) + _model(request.param, factor=8.0)


def _prompts(lengths, seed, vocab=128):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(2, vocab, n)] for n in lengths]


def _engines(model, draft=False, **serving):
    _, jcfg, jparams, tcfg, tparams = model
    serving = {**BASE, **serving}
    if serving.get("kv_dtype") == "int8" and serving.get("paged", True):
        serving["page_size"] = INT8_PAGE
    je = JEngine(jcfg, jparams, JServing(weights_dtype="bf16",
                                         prefix_cache=False, **serving),
                 draft=(jcfg, jparams) if draft else None)
    te = TEngine(tcfg, tparams, TServing(weights_dtype="bf16",
                                         prefix_cache=False, **serving),
                 device="cpu", draft=(tcfg, tparams) if draft else None)
    return je, te


def _drive(engine):
    for _ in range(10000):
        if not engine.step():
            return
    raise AssertionError("engine did not go idle")


def _run_both(model, prompts, max_tokens, req=None, draft=False, **serving):
    """The same requests through both engines; returns (JAX requests, port
    requests, port engine)."""
    req = req or dict(ignore_eos=True)
    je, te = _engines(model, draft=draft, **serving)
    out = []
    for eng, cls in ((je, JRequest), (te, TRequest)):
        out.append([eng.submit(cls(prompt_ids=list(p), max_tokens=max_tokens,
                                   **req)) for p in prompts])
        _drive(eng)
    return out[0], out[1], te


# -- the model -----------------------------------------------------------------


@pytest.mark.parametrize("fam", FAMILIES)
def test_logits_match_jax_float32(fam):
    """``model_forward`` over two rows at different positions (the second
    from position 5: OPT's learned rows and the llama3 frequencies at
    other positions) within 1e-5 of the JAX forward."""
    jcfg, jparams, tcfg, tparams = _model(fam)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 11)).astype(np.int32)
    positions = np.stack([np.arange(11), np.arange(5, 16)]).astype(np.int32)
    want, _ = jl.model_forward(jparams, jcfg, jnp.asarray(tokens),
                               jnp.asarray(positions))
    with torch.no_grad():
        got = tl.DecoderLM(tcfg, tparams)(torch.from_numpy(tokens),
                                          torch.from_numpy(positions))
    want = np.asarray(want)
    assert np.abs(want).max() > 1.0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_TOL)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("fam", FAMILIES)
def test_quantize_params_bit_identical(fam):
    """int8 weights and scales of every projection, the embedding and an
    untied lm_head bit for bit against the JAX ``quantize_params``; the
    biases, norms and learned positions carried unchanged, and no leaf
    more or less."""
    jcfg, jparams, tcfg, tparams = _model(fam)
    want = dict(_leaves(jax.tree.map(np.asarray,
                                     jq.quantize_params(jparams, jcfg))))
    got = dict(_leaves(tq.quantize_params(tparams, tcfg)))
    assert set(got) == set(want)
    for path, w in want.items():
        g = got[path].numpy()
        assert g.dtype == w.dtype, path
        assert np.array_equal(g.view(np.uint8), w.view(np.uint8)), path
    assert any(p[-1] == "bias" for p in got) == (fam in ("phi", "opt"))
    with torch.no_grad():
        tokens = torch.tensor([[3, 9, 27, 81, 5]])
        logits = tl.DecoderLM(tcfg, tq.quantize_params(tparams, tcfg))(
            tokens, torch.arange(5)[None])
    assert torch.isfinite(logits).all()


# -- the engines ---------------------------------------------------------------

LAYOUTS = {"paged": {}, "dense": {"paged": False}}


@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_greedy_streams_match_jax(model, layout, kv_dtype):
    """Six requests over four slots (batched prefill, the decode horizon,
    admission into freed slots), prompts of 30 and 40 tokens walked in
    chunks of 16 beside the decode rows: every stream byte-identical to
    the JAX engine's."""
    prompts = _prompts((5, 30, 12, 3, 40, 9), seed=1)
    jr, tr, te = _run_both(model, prompts, 14, prefill_chunk=16,
                           kv_dtype=kv_dtype, **LAYOUTS[layout])
    for p, a, b in zip(prompts, jr, tr):
        assert b.generated == a.generated, (len(p), a.generated, b.generated)
        assert b.finish_reason == a.finish_reason == "length"
    assert len(set(tuple(r.generated) for r in tr)) > 1
    assert ("ks" in te.cache) == (kv_dtype == "int8")
    assert te.counts["decode_dispatches"] > 0


@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
def test_seeded_sampled_streams_match_jax(model, kv_dtype):
    """Sampled requests with their own seeds and one under a pinned
    derived seed, through the chunk walk: byte-identical streams."""
    prompts = _prompts((5, 30, 12, 9), seed=5)
    seeds = [11, 2**32 + 5, None, 77]
    je, te = _engines(model, prefill_chunk=16, derived_seed=1234,
                      kv_dtype=kv_dtype)
    reqs = []
    for eng, cls in ((je, JRequest), (te, TRequest)):
        reqs.append([eng.submit(cls(prompt_ids=p, max_tokens=12, seed=s,
                                    **SAMPLED))
                     for p, s in zip(prompts, seeds)])
        _drive(eng)
    for a, b in zip(*reqs):
        assert b.eff_seed == a.eff_seed
        assert b.generated == a.generated, (a.generated, b.generated)


def _lookup_prompts(seed):
    rng = np.random.default_rng(seed)
    pat = rng.integers(2, 128, 4).tolist()
    return [pat * 4, rng.integers(2, 128, 11).tolist() + pat * 2]


@pytest.mark.parametrize("fam", FAMILIES)
@pytest.mark.parametrize("method", ["prompt_lookup", "draft"])
def test_speculative_streams_match_jax(fam, method):
    """Prompt lookup and a self-draft of the same family: greedy streams
    equal the JAX engine's with the same method, and drafts were verified
    (the unscaled weights: their greedy streams repeat, so that the
    context's trailing n-grams recur and prompt lookup proposes)."""
    model = (fam,) + _model(fam, factor=1.0)
    prompts = _lookup_prompts(1) + _prompts((7,), seed=2)
    spec = dict(spec_decode=True, spec_k=4, spec_ngram=3,
                spec_method=method)
    jr, tr, te = _run_both(model, prompts, 20, draft=method == "draft",
                           **spec)
    assert [r.generated for r in tr] == [r.generated for r in jr]
    assert te.counts["spec_dispatches"] > 0
    assert te.counts["spec_drafted_tokens"] > 0
    if method == "draft":
        assert te.counts["spec_accepted_tokens"] == \
            te.counts["spec_drafted_tokens"]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_opt_stops_at_max_seq_len_like_jax(layout):
    """tiny_opt with a learned table of 48 + 2 rows behind a cache of 64:
    the engines cap their window at 48, so requests that would run past it
    stop there, as the JAX engine's do (finish reason and stream), and one
    that fits runs its course."""
    model = ("opt",) + _model("opt", factor=8.0, max_seq_len=48)
    prompts = _prompts((30, 10, 4), seed=3)
    jr, tr, te = _run_both(model, prompts, 40, **LAYOUTS[layout])
    assert te.max_len == 48
    for p, a, b in zip(prompts, jr, tr):
        assert b.generated == a.generated
        assert b.finish_reason == a.finish_reason
        assert len(p) + len(b.generated) <= 48
    assert len(tr[0].generated) < 40 and len(tr[2].generated) == 40


def test_opt_up_down_adapter_streams_match_jax(tmp_path):
    """An adapter on ``up_proj`` and ``down_proj`` of tiny_opt (a plain
    MLP: the port's ``lora_gu`` group holds ``w_up`` alone) beside base
    rows: each stream equals the JAX engine's, and the adapter's differs
    from the base."""
    _, jcfg, jparams, tcfg, tparams = ("opt",) + _model("opt", factor=8.0)
    path = str(_write_adapter(tmp_path, "mlp", jcfg, rank=4, seed=1,
                              targets=("up_proj", "down_proj")))
    serving = {**BASE, "max_cache_len": 64}
    je = JEngine(jcfg, jparams, JServing(weights_dtype="bf16",
                                         attention_impl="xla", **serving),
                 lora={"mlp": path})
    te = TEngine(tcfg, tparams, TServing(weights_dtype="bf16", **serving),
                 device="cpu", lora={"mlp": path})
    assert "lora_gu" in te.model.params["layers"]
    prompts = _prompts((6, 11, 6, 11), seed=4)
    names = [None, "mlp", "mlp", None]
    out = []
    for eng, cls in ((je, JRequest), (te, TRequest)):
        out.append([eng.submit(cls(prompt_ids=p, max_tokens=12,
                                   ignore_eos=True, lora=n))
                    for p, n in zip(prompts, names)])
        _drive(eng)
    jr, tr = out
    assert [r.generated for r in tr] == [r.generated for r in jr]
    base = _run_both(("opt", jcfg, jparams, tcfg, tparams), prompts[1:2],
                     12)[1][0]
    assert tr[1].generated != base.generated


# -- HF generate -----------------------------------------------------------------


@pytest.mark.parametrize("fam", FAMILIES)
def test_greedy_stream_equals_hf_generate(fam):
    """A tiny HF model of the family built in process, its state dict
    converted by the port's ``convert_state_dict``, served greedily by the
    port's engine (float32 weights and activations): each stream equals HF
    ``generate``'s until HF's eos."""
    jcfg, tcfg = _configs(fam)
    hf = HF_BUILDERS[fam](jcfg)
    state = {k: v.detach() for k, v in hf.state_dict().items()}
    params = thf.convert_state_dict(tcfg, state, torch.float32, device="cpu")
    te = TEngine(tcfg, params, TServing(weights_dtype="auto", **BASE),
                 device="cpu")
    prompts = _prompts((4, 9, 17), seed=6, vocab=tcfg.vocab_size)
    reqs = [te.submit(TRequest(prompt_ids=p, max_tokens=10, ignore_eos=True))
            for p in prompts]
    te.run_until_idle()
    with torch.no_grad():
        for p, r in zip(prompts, reqs):
            ids = torch.tensor([p])
            gen = hf.generate(ids, max_new_tokens=10, do_sample=False,
                              num_beams=1, pad_token_id=0)
            want = gen[0, len(p):].tolist()
            n = min(len(want), len(r.generated))
            assert n > 0 and r.generated[:n] == want[:n], (fam, p)


def test_unknown_moe_impl_raises_the_jax_value_error():
    """Nothing in the port refuses a MoE config any more; an unknown
    ``moe_impl`` raises the JAX package's ValueError at the MoE MLP, from
    both packages alike."""
    from aws_k8s_ansible_provisioner_tpu.ops import moe as jmoe
    from aws_k8s_ansible_provisioner_tpu_torch.ops import moe as tmoe

    jcfg = jconfig.tiny_qwen3_moe(moe_impl="dense")
    tcfg = tconfig.tiny_qwen3_moe(moe_impl="dense")
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg)
    layer = {k: {kk: vv[0] for kk, vv in v.items()}
             for k, v in tparams["layers"].items()}
    x = np.zeros((3, tcfg.hidden_size), np.float32)
    with pytest.raises(ValueError) as want:
        jmoe.moe_mlp(jcfg, jnp.asarray(x), jax.tree.map(
            lambda a: a[0], jparams["layers"]))
    with pytest.raises(ValueError) as got:
        tmoe.moe_mlp(tcfg, torch.from_numpy(x), layer)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="moe_impl='dense'"):
        tl.DecoderLM(tcfg, tparams)(torch.tensor([[3, 4]]),
                                    torch.arange(2)[None])
    for cfg in tconfig.MODEL_REGISTRY.values():
        assert cfg.moe_impl in ("ragged", "gshard")
