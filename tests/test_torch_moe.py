"""The Qwen3-MoE MLP in the port against the JAX package, on the CPU.

On ``tiny_qwen3_moe`` (8 experts, top 2, expert width 32), with the JAX
``init_params`` (float32, seeded through its key; projections and the
embedding scaled by 4 so that logits are of order 1) converted by
``from_jax_params``, and numpy-seeded activations:

- ``route`` gives the JAX indices and weights, with exact router ties (two
  identical router columns: the lower expert index first) and with
  ``norm_topk_prob=False``; the route-and-sort's plain version gives
  ``torch.argsort(stable=True)``'s order;
- ``moe_mlp_ragged`` within 1e-5 of the JAX one in float32 and with int8
  experts (float32 activations: products, scales, combine); in bf16
  within one bf16 ulp of the output's largest value (XLA rounds its bf16
  ``logistic`` inside ``silu`` by another rule than ``F.silu``);
- ``moe_mlp_gshard`` within 1e-5, with capacity 2.0 and with drops at
  ``moe_capacity_factor=0.01``;
- int8 expert quantization bit-identical to the JAX ``quantize_params``,
  and the seeded int8 tree drawn layer by layer equal to the whole tree
  quantized, holding no more than one layer's matrix (or the embedding) in
  bf16 at a time;
- ``model_forward`` logits within 1e-5, both implementations;
- greedy and seeded streams byte-identical to the JAX ``Engine``: paged
  and dense, float32 and int8 KV, int8 weights, prompt lookup, a dense
  tiny draft of the same vocabulary; under an sp mesh the forced gshard;
- an attention-only adapter's streams, and the expert-target refusal;
- the port's greedy stream equal to HF ``generate`` with engineered
  router ties (two experts with identical gate rows).
"""

import dataclasses
import logging
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aws_k8s_ansible_provisioner_tpu import config as jconfig
from aws_k8s_ansible_provisioner_tpu.config import MeshConfig as JMesh
from aws_k8s_ansible_provisioner_tpu.config import ServingConfig as JServing
from aws_k8s_ansible_provisioner_tpu.models import layers as jl
from aws_k8s_ansible_provisioner_tpu.models import quant as jq
from aws_k8s_ansible_provisioner_tpu.ops import moe as jmoe
from aws_k8s_ansible_provisioner_tpu.parallel import mesh as jmesh
from aws_k8s_ansible_provisioner_tpu.serving.engine import Engine as JEngine
from aws_k8s_ansible_provisioner_tpu.serving.engine import Request as JRequest
from aws_k8s_ansible_provisioner_tpu_torch import config as tconfig
from aws_k8s_ansible_provisioner_tpu_torch.config import MeshConfig
from aws_k8s_ansible_provisioner_tpu_torch.config import \
    ServingConfig as TServing
from aws_k8s_ansible_provisioner_tpu_torch.models import hf_loader as thf
from aws_k8s_ansible_provisioner_tpu_torch.models import layers as tl
from aws_k8s_ansible_provisioner_tpu_torch.models import quant as tq
from aws_k8s_ansible_provisioner_tpu_torch.models.convert import \
    from_jax_params
from aws_k8s_ansible_provisioner_tpu_torch.ops import moe as tmoe
from aws_k8s_ansible_provisioner_tpu_torch.parallel import mesh as tmesh
from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import \
    Engine as TEngine
from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import \
    Request as TRequest
from test_lora import _write_adapter
from test_moe import _hf_qwen3_moe

torch.set_num_threads(2)

TOL = 1e-5
BASE = dict(max_decode_slots=4, max_cache_len=64, page_size=8,
            prefill_buckets=(8, 16, 32), dtype="float32", decode_horizon=4)
# the JAX engine's int8 row-write kernel needs pages of 32 rows
INT8_PAGE = 32
SAMPLED = dict(temperature=0.8, top_p=0.9, top_k=20, ignore_eos=True)


def _scaled(tree, factor):
    """Projection and expert kernels and the embedding times ``factor``
    (norms and the router stay)."""
    def go(node, key=None):
        return {k: go(v, k) if isinstance(v, dict) else
                v * factor if k == "kernel" and key != "router" else v
                for k, v in node.items()}
    out = go(tree)
    out["embed"] = {"weight": tree["embed"]["weight"] * factor}
    return out


def _model(factor=4.0, seed=0, **over):
    jcfg = jconfig.tiny_qwen3_moe(**over)
    tcfg = tconfig.tiny_qwen3_moe(**over)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jparams = _scaled(jl.init_params(jcfg, jax.random.PRNGKey(seed),
                                     dtype=jnp.float32), factor)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg)
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def model():
    return _model(factor=8.0)


def _layer(tree, layer=0):
    return {k: {kk: vv[layer] for kk, vv in v.items()}
            for k, v in tree["layers"].items()}


def _torch_tree(tree, dtype=None):
    """A JAX layer tree as torch tensors; ``dtype``: the float leaves cast
    (int8 kernels and float32 scales kept)."""
    def leaf(k, a):
        a = np.array(a)
        if a.dtype.name == "bfloat16":
            a = a.astype(np.float32)          # exact; cast back below
        t = torch.from_numpy(a)
        if dtype is None or t.dtype == torch.int8 or k == "scale":
            return t
        return t.to(dtype)
    return {k: {kk: leaf(kk, vv) for kk, vv in v.items()}
            for k, v in tree.items()}


def _x(n=40, h=64, seed=0):
    return np.random.default_rng(seed).normal(size=(n, h)).astype(np.float32)


# -- the MLP --------------------------------------------------------------------


@pytest.mark.parametrize("norm", [True, False])
def test_route_matches_jax_with_ties(norm):
    """Router columns 1 and 5 copied from 0: every token's three tied
    probabilities order by expert index, as ``jax.lax.top_k`` orders them;
    indices equal, weights within 1e-6; the route-and-sort's plain
    version's sorted rows are ``argsort(stable=True)``'s."""
    jcfg = jconfig.tiny_qwen3_moe(norm_topk_prob=norm, num_experts_per_tok=3)
    tcfg = tconfig.tiny_qwen3_moe(norm_topk_prob=norm, num_experts_per_tok=3)
    rng = np.random.default_rng(1)
    router = rng.normal(size=(64, 8)).astype(np.float32)
    router[:, 1] = router[:, 0]
    router[:, 5] = router[:, 0]
    x = _x(32, seed=2)
    x[:8] = np.abs(x[:8]) * np.sign(router[:, 0])   # expert 0's group tops
    wj, ij = jmoe.route(jcfg, jnp.asarray(x), jnp.asarray(router))
    wt, it = tmoe.route(tcfg, torch.from_numpy(x), torch.from_numpy(router))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=0,
                               atol=1e-6)
    assert (it[:8, :3] == torch.tensor([0, 1, 5])).all()
    r = tmoe.route_sort(tmoe.router_logits(torch.from_numpy(x),
                                           torch.from_numpy(router)),
                        3, norm, torch.float32)
    flat = r.experts.reshape(-1).long()
    order = torch.argsort(flat, stable=True)
    assert torch.equal(r.row_token.long(), order // 3)
    assert torch.equal(r.row_expert.long(), flat[order])
    assert torch.equal(r.pos.reshape(-1).long()[order],
                       torch.arange(flat.numel()))
    assert torch.equal(r.offsets.long(), torch.cat([
        torch.zeros(1, dtype=torch.long),
        torch.cumsum(torch.bincount(flat, minlength=8), 0)]))
    if not norm:
        assert (wt.sum(-1) < 0.999).any()


@pytest.mark.parametrize("kind", ["float32", "int8"])
def test_moe_mlp_ragged_matches_jax(model, kind):
    """One layer's ragged MLP over 40 tokens: float32 weights, and int8
    experts (quantized by the JAX package) under float32 activations,
    within 1e-5 of the JAX ``moe_mlp_ragged``."""
    jcfg, jparams, tcfg, _ = model
    if kind == "int8":
        jparams = jq.quantize_params(jparams, jcfg)
    p = _layer(jparams)
    x = _x()
    want = np.asarray(jmoe.moe_mlp_ragged(jcfg, jnp.asarray(x), p))
    got = tmoe.moe_mlp_ragged(tcfg, torch.from_numpy(x), _torch_tree(p))
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_moe_mlp_ragged_bf16_within_one_ulp(model):
    """bf16 weights and activations: within one bf16 ulp of the output's
    largest value of the JAX result (the two frameworks round silu's
    logistic differently)."""
    jcfg, jparams, tcfg, _ = model
    p = jax.tree.map(lambda a: a.astype(jnp.bfloat16), _layer(jparams))
    x = _x()
    want = np.asarray(jmoe.moe_mlp_ragged(
        jcfg, jnp.asarray(x).astype(jnp.bfloat16), p).astype(jnp.float32))
    got = tmoe.moe_mlp_ragged(tcfg, torch.from_numpy(x).bfloat16(),
                              _torch_tree(p, torch.bfloat16)).float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(got - want).max() <= ulp


@pytest.mark.parametrize("cf", [2.0, 0.01])
def test_moe_mlp_gshard_matches_jax(cf):
    """The fixed-capacity dispatch within 1e-5 of the JAX one; at 0.01
    every expert keeps 4 tokens of 32 and the rest drop to zero rows."""
    jcfg, jparams, tcfg, tparams = _model(moe_capacity_factor=cf)
    p = _layer(jparams)
    x = _x(32, seed=3)
    want = np.asarray(jmoe.moe_mlp_gshard(jcfg, jnp.asarray(x), p))
    got = tmoe.moe_mlp_gshard(tcfg, torch.from_numpy(x), _torch_tree(p))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    zero_rows = int((np.abs(want).max(-1) == 0).sum())
    if cf < 1:
        assert tmoe.gshard_capacity(tcfg, 32) == 4
        assert zero_rows > 0
    else:
        assert zero_rows == 0
        ragged = tmoe.moe_mlp_ragged(tcfg, torch.from_numpy(x),
                                     _torch_tree(p))
        np.testing.assert_allclose(got.numpy(), ragged.numpy(), rtol=0,
                                   atol=TOL)


def test_quantize_params_bit_identical(model):
    """int8 experts [L, E, in, out] with scales [L, E, out], the attention
    projections, the embedding: bit for bit the JAX ``quantize_params``;
    the router and norms unchanged."""
    jcfg, jparams, tcfg, tparams = model
    want = jax.tree.map(np.asarray, jq.quantize_params(jparams, jcfg))
    got = tq.quantize_params(tparams, tcfg)

    def leaves(t, pre=()):
        for k, v in t.items():
            if isinstance(v, dict):
                yield from leaves(v, pre + (k,))
            else:
                yield pre + (k,), v
    w, g = dict(leaves(want)), dict(leaves(got))
    assert set(w) == set(g)
    for path, a in w.items():
        b = g[path].numpy()
        assert b.dtype == a.dtype, path
        assert np.array_equal(b.view(np.uint8), a.view(np.uint8)), path
    assert g[("layers", "w_down", "scale")].shape == (2, 8, 64)
    assert g[("layers", "router", "kernel")].dtype == torch.float32


def test_seeded_int8_tree_holds_one_layer_in_bf16(monkeypatch):
    """``init_params(quantize=True)`` equals the whole bf16 tree quantized,
    bit for bit, and holds at most one drawn matrix (a layer's expert
    stack, or the embedding) in bf16 at a time: the bf16 bytes alive at
    once are counted through the draws."""
    cfg = tconfig.tiny_qwen3_moe(tie_embeddings=False)
    live = {"now": 0, "peak": 0}

    def track(t):
        live["now"] += t.nbytes
        live["peak"] = max(live["peak"], live["now"])
        weakref.finalize(t, lambda n=t.nbytes: live.__setitem__(
            "now", live["now"] - n))
        return t

    whole = tl.init_params(cfg, torch.Generator().manual_seed(3),
                           torch.bfloat16)
    whole_bytes = sum(t.nbytes for _, t in tl._flatten(whole)
                      if t.dtype == torch.bfloat16)
    real = tl._draw
    monkeypatch.setattr(tl, "_draw", lambda *a: track(real(*a)))
    got = tl.init_params(cfg, torch.Generator().manual_seed(3),
                         torch.bfloat16, quantize=True)
    want = tq.quantize_params(whole, cfg)
    for key in ("w_gate", "w_up", "w_down", "wq"):
        for leaf in ("kernel", "scale"):
            assert torch.equal(got["layers"][key][leaf],
                               want["layers"][key][leaf])
    assert torch.equal(got["embed"]["weight"], want["embed"]["weight"])
    assert torch.equal(got["lm_head"]["scale"], want["lm_head"]["scale"])
    one = max(cfg.num_experts * cfg.hidden_size * cfg.moe_intermediate_size,
              cfg.vocab_size * cfg.hidden_size) * 2
    assert 0 < live["peak"] <= one < whole_bytes / 4
    assert got["layers"]["router"]["kernel"].dtype == torch.bfloat16


@pytest.mark.parametrize("impl", ["ragged", "gshard"])
def test_logits_match_jax(impl):
    """``model_forward`` over two rows at different positions within 1e-5
    of the JAX forward."""
    jcfg, jparams, tcfg, tparams = _model(moe_impl=impl)
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
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


# -- the engines ---------------------------------------------------------------


def _prompts(lengths, seed, vocab=128):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(2, vocab, n)] for n in lengths]


def _drive(engine):
    for _ in range(10000):
        if not engine.step():
            return
    raise AssertionError("engine did not go idle")


def _run_both(model, prompts, max_tokens, req=None, draft=None, jmesh_=None,
              tmesh_=None, weights="bf16", seeds=None, **serving):
    """The same requests through both engines; returns (JAX requests, port
    requests, port engine)."""
    jcfg, jparams, tcfg, tparams = model
    serving = {**BASE, **serving}
    if serving.get("kv_dtype") == "int8" and serving.get("paged", True):
        serving["page_size"] = INT8_PAGE
    je = JEngine(jcfg, jparams, JServing(weights_dtype=weights,
                                         prefix_cache=False, **serving),
                 draft=None if draft is None else draft[:2], mesh=jmesh_)
    te = TEngine(tcfg, tparams, TServing(weights_dtype=weights,
                                         prefix_cache=False, **serving),
                 device="cpu", draft=None if draft is None else draft[2:],
                 mesh=tmesh_)
    out = []
    for eng, cls in ((je, JRequest), (te, TRequest)):
        reqs = []
        for i, p in enumerate(prompts):
            kw = dict(req or dict(ignore_eos=True))
            if seeds is not None and seeds[i] is not None:
                kw = dict(seed=seeds[i], **SAMPLED)
            reqs.append(eng.submit(cls(prompt_ids=list(p),
                                       max_tokens=max_tokens, **kw)))
        _drive(eng)
        out.append(reqs)
    return out[0], out[1], te


LAYOUTS = {"paged": {}, "dense": {"paged": False}}


@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_greedy_streams_match_jax(model, layout, kv_dtype):
    """Five requests over four slots (batched prefill, the decode horizon,
    admission into a freed slot), prompts of 30 and 40 tokens walked in
    chunks of 16 beside the decode rows: byte-identical streams."""
    prompts = _prompts((5, 30, 12, 40, 9), seed=1)
    jr, tr, te = _run_both(model, prompts, 12, prefill_chunk=16,
                           kv_dtype=kv_dtype, **LAYOUTS[layout])
    for a, b in zip(jr, tr):
        assert b.generated == a.generated, (a.generated, b.generated)
    assert len(set(tuple(r.generated) for r in tr)) > 1
    assert te.counts["decode_dispatches"] > 0


def test_int8_weights_and_seeded_streams_match_jax(model):
    """int8 weights (experts quantized per (expert, out channel)) and
    sampled requests with their own seeds beside a greedy one, under a
    pinned derived seed: byte-identical streams."""
    prompts = _prompts((5, 30, 12, 9), seed=5)
    seeds = [11, 2**32 + 5, None, 77]
    jr, tr, te = _run_both(model, prompts, 12, weights="int8",
                           seeds=seeds, prefill_chunk=16, derived_seed=1234)
    assert "scale" in te.model.params["layers"]["w_up"]
    for a, b in zip(jr, tr):
        assert b.generated == a.generated, (a.generated, b.generated)


def _lookup_prompts(seed):
    rng = np.random.default_rng(seed)
    pat = rng.integers(2, 128, 4).tolist()
    return [pat * 4, rng.integers(2, 128, 11).tolist() + pat * 2]


@pytest.mark.parametrize("method", ["prompt_lookup", "draft"])
def test_speculative_streams_match_jax(method):
    """Prompt lookup, and a dense tiny_qwen3 draft of the same vocabulary
    for the MoE target: greedy streams equal the JAX engine's with the
    same method, and drafts were verified (the unscaled weights: their
    greedy streams repeat, so that prompt lookup proposes)."""
    model = _model(factor=1.0)
    draft = None
    if method == "draft":
        jd = jconfig.tiny_qwen3()
        td = tconfig.tiny_qwen3()
        jdp = jl.init_params(jd, jax.random.PRNGKey(7), dtype=jnp.float32)
        draft = (jd, jdp, td, from_jax_params(jax.tree.map(np.asarray, jdp),
                                              td))
    prompts = _lookup_prompts(1) + _prompts((7,), seed=2)
    jr, tr, te = _run_both(model, prompts, 16, draft=draft,
                           spec_decode=True, spec_k=4, spec_ngram=3,
                           spec_method=method)
    assert [r.generated for r in tr] == [r.generated for r in jr]
    assert te.counts["spec_dispatches"] > 0
    assert te.counts["spec_drafted_tokens"] > 0


def test_sp_mesh_forces_gshard_like_jax(model, caplog):
    """Under an sp mesh of 2 (dense shards on the CPU) the engine serves
    the gshard formulation with the JAX warning, and its greedy streams
    equal the JAX sp engine's (the same rows reach the capacity rule)."""
    prompts = _prompts((5, 21, 9), seed=8)
    with caplog.at_level(logging.WARNING):
        jr, tr, te = _run_both(
            model, prompts, 10, prefill_buckets=(8, 16), prefill_chunk=16,
            jmesh_=jmesh.make_mesh(JMesh(sp=2), devices=jax.devices("cpu")),
            tmesh_=tmesh.make_mesh(MeshConfig(sp=2), ["cpu"] * 2))
    assert te.cfg.moe_impl == "gshard"
    assert any("switching moe_impl ragged -> gshard" in r.getMessage()
               for r in caplog.records)
    assert [r.generated for r in tr] == [r.generated for r in jr]


def test_attention_adapter_streams_match_jax_and_experts_refused(
        model, tmp_path):
    """An adapter on q_proj and v_proj beside base rows: each stream
    equals the JAX engine's; an adapter that targets the experts' up_proj
    is refused by both packages."""
    jcfg, jparams, tcfg, tparams = model
    path = str(_write_adapter(tmp_path, "attn", jcfg, rank=4, seed=1,
                              targets=("q_proj", "v_proj")))
    serving = {**BASE, "max_cache_len": 64}
    je = JEngine(jcfg, jparams, JServing(weights_dtype="bf16",
                                         attention_impl="xla", **serving),
                 lora={"attn": path})
    te = TEngine(tcfg, tparams, TServing(weights_dtype="bf16", **serving),
                 device="cpu", lora={"attn": path})
    prompts = _prompts((6, 11, 6), seed=4)
    names = [None, "attn", "attn"]
    out = []
    for eng, cls in ((je, JRequest), (te, TRequest)):
        out.append([eng.submit(cls(prompt_ids=p, max_tokens=10,
                                   ignore_eos=True, lora=n))
                    for p, n in zip(prompts, names)])
        _drive(eng)
    assert [r.generated for r in out[1]] == [r.generated for r in out[0]]
    assert out[1][0].generated != out[1][2].generated or \
        prompts[0] != prompts[2]
    bad = str(_write_adapter(tmp_path, "mlp", dataclasses.replace(
        jcfg, intermediate_size=jcfg.moe_intermediate_size), rank=4,
        targets=("up_proj",)))
    with pytest.raises(ValueError, match="expert"):
        TEngine(tcfg, tparams, TServing(weights_dtype="bf16", **serving),
                device="cpu", lora={"mlp": bad})


def test_greedy_stream_equals_hf_generate_with_router_ties():
    """HF ``Qwen3MoeForCausalLM`` with experts 0 and 1 given identical gate
    rows in every layer (exact router ties), converted by the port's
    ``convert_state_dict``: the port's greedy stream equals HF
    ``generate``'s (the tie goes to the lower expert in both)."""
    cfg = tconfig.tiny_qwen3_moe()
    hf = _hf_qwen3_moe(jconfig.tiny_qwen3_moe())
    with torch.no_grad():
        for layer in hf.model.layers:
            layer.mlp.gate.weight[1].copy_(layer.mlp.gate.weight[0])
    state = {k: v.detach() for k, v in hf.state_dict().items()}
    params = thf.convert_state_dict(cfg, state, torch.float32, device="cpu")
    te = TEngine(cfg, params, TServing(weights_dtype="auto", **BASE),
                 device="cpu")
    prompt = np.random.default_rng(7).integers(2, cfg.vocab_size,
                                               9).tolist()
    req = te.submit(TRequest(prompt_ids=prompt, max_tokens=12,
                             ignore_eos=True))
    te.run_until_idle()
    with torch.no_grad():
        gen = hf.generate(torch.tensor([prompt]), max_new_tokens=12,
                          do_sample=False, num_beams=1, pad_token_id=0)
    want = gen[0, len(prompt):].tolist()
    n = min(len(want), len(req.generated))
    assert n > 0 and req.generated[:n] == want[:n]
