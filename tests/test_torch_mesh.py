"""Tensor, data and expert parallel serving in the port against the JAX
package, on the CPU (every mesh position ``torch.device("cpu")``; the JAX
side over the 8 virtual CPU devices of tests/conftest.py).

The same float32 ``tiny_qwen3(num_heads=4, num_kv_heads=2,
vocab_size=256)`` weights (JAX ``init_params``, projections and the
embedding times 8 so that greedy streams do not collapse onto one token)
go through the JAX meshed engine and the port's:

- greedy streams of the port's meshed engine equal the JAX meshed
  engine's and the port's single-device engine's at (dp, tp) = (2, 2),
  (1, 2), (4, 1), (4, 2), with prompt-lookup speculation off and on (the
  prompts of tests/test_engine_mesh.py, and a chunked one);
- the paged pool under tp (per-shard head counts) and under dp
  (``dp_groups``, ``_group_pages``), allocated per shard, and the AOT
  fingerprint's mesh and pages a group;
- dp admission and preemption group-local over a tiny pool, every slot's
  pages in its own partition at every step, streams equal to the JAX
  engine's (tests/test_engine_mesh.py's scenario);
- guided JSON under dp x tp (tests/test_engine_mesh.py's pressure biases),
  the same tokens as the JAX meshed engine;
- the divisibility errors with the JAX engine's messages;
- int8 weights: a column-parallel slice of the quantized tree is the
  quantization of that slice bit for bit, a row-parallel one keeps the
  whole kernel's scale;
- the collectives' sum order and dtype;
- a tp forward against tests/test_parallel.py::test_tp_forward_parity's
  setup (the JAX forward sharded over (dp, tp) = (2, 2)), within 1e-5;
- ``tiny_qwen3_moe`` under ep 2 and ep 2 x tp 2 against the JAX gshard
  forward and engine: logits within 1e-5, equal greedy tokens;
- the sharded load of a tiny HF directory written here
  (tests/test_sharded_load.py's checks): every tp-split leaf 1/tp on each
  shard and bit-identical to the whole load's slice (bf16 and int8),
  never sharing the whole leaf's storage, the cached restore alike, and
  an engine of the sharded tree serving the unmeshed engine's tokens.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aws_k8s_ansible_provisioner_tpu.config import MeshConfig as JMesh
from aws_k8s_ansible_provisioner_tpu.config import ServingConfig as JServing
from aws_k8s_ansible_provisioner_tpu.config import tiny_qwen3 as jax_tiny
from aws_k8s_ansible_provisioner_tpu.config import \
    tiny_qwen3_moe as jax_tiny_moe
from aws_k8s_ansible_provisioner_tpu.models.layers import init_params
from aws_k8s_ansible_provisioner_tpu.models.layers import \
    model_forward as jax_forward
from aws_k8s_ansible_provisioner_tpu.parallel import mesh as jmesh
from aws_k8s_ansible_provisioner_tpu.parallel.sharding import \
    shard_params as jax_shard_params
from aws_k8s_ansible_provisioner_tpu.serving.engine import Engine as JEngine
from aws_k8s_ansible_provisioner_tpu.serving.engine import Request as JRequest
from aws_k8s_ansible_provisioner_tpu_torch.config import (MeshConfig,
                                                          ModelConfig)
from aws_k8s_ansible_provisioner_tpu_torch.config import \
    ServingConfig as TServing
from aws_k8s_ansible_provisioner_tpu_torch.models import layers as tl
from aws_k8s_ansible_provisioner_tpu_torch.models.checkpoint import \
    load_checkpoint_cached
from aws_k8s_ansible_provisioner_tpu_torch.models.convert import \
    from_jax_params
from aws_k8s_ansible_provisioner_tpu_torch.models.hf_loader import \
    load_checkpoint
from aws_k8s_ansible_provisioner_tpu_torch.models.quant import (
    quant_kernel, quantize_params)
from aws_k8s_ansible_provisioner_tpu_torch.parallel import collectives
from aws_k8s_ansible_provisioner_tpu_torch.parallel import mesh as tmesh
from aws_k8s_ansible_provisioner_tpu_torch.parallel import sharding
from aws_k8s_ansible_provisioner_tpu_torch.serving.aot import \
    engine_fingerprint
from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import \
    Engine as TEngine
from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import \
    Request as TRequest

torch.set_num_threads(2)

TOL = 1e-5
JCFG = jax_tiny(num_heads=4, num_kv_heads=2, vocab_size=256)
TCFG = ModelConfig(**dataclasses.asdict(JCFG))
BASE = dict(weights_dtype="bf16", max_decode_slots=4, max_cache_len=64,
            prefill_buckets=(8, 16), dtype="float32", page_size=8,
            prefill_chunk=8)
MESHES = [(2, 2), (1, 2), (4, 1), (4, 2)]


def _scaled(params):
    """Projection kernels and the embedding times 8 (tests/
    test_torch_sp_decode.py's weights)."""
    def go(node):
        return {k: go(v) if isinstance(v, dict) else
                v * 8 if k == "kernel" else v for k, v in node.items()}

    out = go(params)
    out["embed"] = {"weight": params["embed"]["weight"] * 8}
    return out


@pytest.fixture(scope="module")
def weights():
    jp = _scaled(init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32))
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), TCFG)


def _jmesh(dp=1, tp=1, ep=1):
    return jmesh.make_mesh(JMesh(dp=dp, tp=tp, ep=ep),
                           devices=jax.devices("cpu"))


def _tmesh(dp=1, tp=1, ep=1):
    return tmesh.make_mesh(MeshConfig(dp=dp, tp=tp, ep=ep),
                           ["cpu"] * (dp * tp * ep))


def _run(engine, prompts, max_tokens=8, check=None):
    """Greedy requests stepped to the end (``check(engine)`` after every
    step); returns their streams."""
    cls = JRequest if isinstance(engine, JEngine) else TRequest
    reqs = [engine.submit(cls(prompt_ids=list(p), max_tokens=max_tokens,
                              ignore_eos=True)) for p in prompts]
    for _ in range(10000):
        busy = engine.step()
        if check is not None:
            check(engine)
        if not busy:
            break
    return [r.generated for r in reqs]


def _prompts(spec: bool):
    rng = np.random.default_rng(3)
    if not spec:
        return [rng.integers(2, JCFG.vocab_size, n).tolist()
                for n in (3, 7, 12, 20)]
    # repeating prompts, so that prompt lookup drafts tokens
    return [(rng.integers(2, JCFG.vocab_size, w).tolist() * 6)[:n]
            for w, n in ((3, 13), (2, 7), (4, 16), (5, 22))]


@pytest.fixture(scope="module")
def single_streams(weights):
    """The port's single-device engine's streams, spec off and on."""
    _, tp = weights
    out = {}
    for spec in (False, True):
        eng = TEngine(TCFG, tp, TServing(spec_decode=spec, **BASE),
                      device="cpu")
        out[spec] = _run(eng, _prompts(spec))
    return out


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
@pytest.mark.parametrize("dp,tp", MESHES)
def test_mesh_streams_match_jax(weights, single_streams, dp, tp, spec):
    """The meshed engine's greedy streams equal the JAX meshed engine's
    and the single-device engine's; speculation stays on under the mesh."""
    jparams, tparams = weights
    prompts = _prompts(spec)
    te = TEngine(TCFG, tparams, TServing(spec_decode=spec, **BASE),
                 mesh=_tmesh(dp, tp))
    je = JEngine(JCFG, jparams, JServing(spec_decode=spec, **BASE),
                 mesh=_jmesh(dp, tp))
    got = _run(te, prompts)
    assert got == _run(je, prompts)
    assert got == single_streams[spec]
    assert te.paged and te.dp_groups == dp and te.spec_decode == spec
    assert isinstance(te.model, tl.MeshLM)
    assert te.counts["mixed_dispatches"] > 0
    if spec:
        assert te.counts["spec_dispatches"] > 0


@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 1), (2, 2)])
def test_mesh_pool_layout(weights, dp, tp):
    """tp shards the pool's kv heads, dp its pages into per-group
    partitions with one allocator each, as the JAX pool_pspecs lay them
    out: the port allocates [L, group_pages, Hkv / tp, page, D] per
    (group, shard) and holds the same page counts as the JAX engine."""
    jparams, tparams = weights
    te = TEngine(TCFG, tparams, TServing(**BASE), mesh=_tmesh(dp, tp))
    je = JEngine(JCFG, jparams, JServing(**BASE), mesh=_jmesh(dp, tp))
    assert te._group_pages == je._group_pages
    # the AOT manifest's fingerprint records the mesh and the pages a group
    fp = engine_fingerprint(te)
    assert (fp["dp"], fp["tp"], fp["group_pages"]) == (dp, tp,
                                                       te._group_pages)
    assert te.dp_groups == je.dp_groups == dp
    assert len(te.allocators) == dp
    assert (te.allocator is None) == (dp > 1)
    pool = te.cache
    assert isinstance(pool, sharding.ShardedPool)
    assert len(pool.parts) == dp and all(len(r) == tp for r in pool.parts)
    want = (TCFG.num_layers, te._group_pages, TCFG.num_kv_heads // tp,
            BASE["page_size"], TCFG.head_dim)
    for row in pool.parts:
        for part in row:
            assert tuple(part["k"].shape) == want
            assert tuple(part["v"].shape) == want
    assert je.cache["k"].shape[1] == dp * te._group_pages
    # idle slots point at their own group's scratch page
    for slot in range(te.num_slots):
        assert (te.table[slot] == te._gbase(slot)).all()
    # a quantized pool shards its scale leaves alike
    q = TEngine(TCFG, tparams, TServing(**dict(BASE, kv_dtype="int8")),
                mesh=_tmesh(dp, tp))
    for row in q.cache.parts:
        for part in row:
            assert tuple(part["ks"].shape) == want[:-1]


def test_dp_admission_and_preemption_are_group_local(weights):
    """tests/test_engine_mesh.py's tiny per-group pool (8 pages over dp 2,
    4 + scratch a group): its 17-token prompts admit one a group (the
    gate), and 9-token prompts growing to 21 rows (two a group admitted,
    three pages each) preempt within their group. Every request
    completes, every active slot's pages lie in its own group's partition
    after every step, and the streams equal the JAX dp engine's."""
    jparams, tparams = weights
    small = dict(BASE, kv_pool_pages=8, max_cache_len=32,
                 prefill_buckets=(8, 16, 32), prefill_chunk=0)
    te = TEngine(TCFG, tparams, TServing(**small), mesh=_tmesh(2, 1))
    je = JEngine(JCFG, jparams, JServing(**small), mesh=_jmesh(2, 1))
    assert te._group_pages == je._group_pages == 5
    def own_partition(eng):
        for slot, req in enumerate(eng.slot_req):
            if req is None:
                continue
            lo = eng._gbase(slot)
            pages = eng._slot_pages[slot]
            assert all(1 <= p < eng._group_pages for p in pages)
            live = eng.table[slot, :len(pages)]
            assert ((live > lo) & (live < lo + eng._group_pages)).all()

    one = TEngine(TCFG, tparams, TServing(**dict(small, kv_pool_pages=4)),
                  device="cpu")
    for n, new in ((17, 4), (9, 12)):
        prompts = [[5 + i] * n for i in range(4)]
        before = te.counts["preemptions"]
        got = _run(te, prompts, new, own_partition)
        assert got == _run(je, prompts, new)
        assert all(len(g) == new for g in got)
        # the single-device engine over one group's pool serves the same
        assert _run(one, prompts, new) == got
    assert te.counts["preemptions"] > before


def test_mesh_guided_json(weights):
    """Guided decoding under dp x tp: the allow mask applies to the
    gathered full-vocabulary logits on the lead, the answer parses, and
    the tokens equal the JAX meshed engine's (tests/test_engine_mesh.py's
    pressure biases)."""
    from aws_k8s_ansible_provisioner_tpu.serving.guided import \
        grammar_for as jgrammar
    from aws_k8s_ansible_provisioner_tpu.utils.tokenizer import \
        ByteTokenizer as JTok
    from aws_k8s_ansible_provisioner_tpu_torch.serving.guided import \
        grammar_for as tgrammar
    from aws_k8s_ansible_provisioner_tpu_torch.utils.tokenizer import \
        ByteTokenizer as TTok

    tok = TTok()
    jcfg = jax_tiny(vocab_size=260, eos_token_id=tok.eos_token_id,
                    num_heads=4, num_kv_heads=2)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    jp = init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg)
    serving = dict(weights_dtype="bf16", max_decode_slots=4,
                   max_cache_len=128, prefill_buckets=(16, 32),
                   dtype="float32", decode_horizon=4)
    pressure = ((32, -50.0), (9, -50.0), (10, -50.0), (13, -50.0),
                (91, -20.0), (92, -100.0), (34, 30.0), (125, 20.0),
                (93, 15.0), (58, 20.0), (44, 5.0), (258, 100.0))
    fmt = {"type": "json_object"}
    outs = []
    for eng, req, grammar in (
            (TEngine(tcfg, tp, TServing(**serving), mesh=_tmesh(2, 2)),
             TRequest, tgrammar(tok, fmt, [tok.eos_token_id])),
            (JEngine(jcfg, jp, JServing(**serving), mesh=_jmesh(2, 2)),
             JRequest, jgrammar(JTok(), fmt, [tok.eos_token_id]))):
        g = eng.submit(req(prompt_ids=tok.encode("j:"), guided=grammar,
                           max_tokens=60, logit_bias=pressure))
        plain = eng.submit(req(prompt_ids=tok.encode("n"), max_tokens=12,
                               ignore_eos=True))
        for _ in range(10000):
            if not eng.step():
                break
        outs.append((g.generated, plain.generated, g.finish_reason))
    assert outs[0] == outs[1]
    gen, plain, reason = outs[0]
    assert reason == "stop"
    assert isinstance(json.loads(tok.decode(gen)), dict)
    assert len(plain) == 12


@pytest.mark.parametrize("case", ["slots", "tp", "pool", "group", "pp", "sp",
                                  "dense", "lora"])
def test_mesh_refusals_match_jax(weights, case):
    """The divisibility errors carry the JAX engine's messages; pp > 1,
    sp beside another axis, the dense engine under a mesh and LoRA under
    a mesh are refused."""
    jparams, tparams = weights
    serving, axes = dict(BASE), dict(dp=2, tp=2)
    if case == "slots":
        serving["max_decode_slots"] = 3
    elif case == "tp":
        axes = dict(tp=8)
    elif case == "pool":
        serving["kv_pool_pages"] = 33
    elif case == "group":
        serving.update(kv_pool_pages=12, max_cache_len=64)
    if case in ("slots", "tp", "pool", "group"):
        errs = []
        for eng, cfg, srv, params, mesh in (
                (JEngine, JCFG, JServing, jparams, _jmesh(**axes)),
                (TEngine, TCFG, TServing, tparams, _tmesh(**axes))):
            with pytest.raises(ValueError) as e:
                eng(cfg, params, srv(**serving), mesh=mesh)
            errs.append(str(e.value))
        assert errs[0] == errs[1]
        return
    match = {"pp": "training-only", "sp": "not ported", "dense": "not ported",
             "lora": "LoRA under a mesh"}[case]
    mesh = {"pp": lambda: tmesh.make_mesh(MeshConfig(pp=2), ["cpu"] * 2),
            "sp": lambda: tmesh.make_mesh(MeshConfig(sp=2, tp=2),
                                          ["cpu"] * 4)}.get(
        case, lambda: _tmesh(1, 2))()
    kw = {"lora": {"a": "/nonexistent"}} if case == "lora" else {}
    if case == "dense":
        serving["paged"] = False
    with pytest.raises(ValueError, match=match):
        TEngine(TCFG, tparams, TServing(**serving), mesh=mesh, **kw)


def test_int8_slices_quantize_like_their_slices(weights):
    """Shard after quantize_params: a column-parallel slice (wq, w_up, the
    vocab rows of the embedding and their scales) is bit-identical to
    quantizing that slice of the float tree; a row-parallel one (wo,
    w_down) keeps the whole kernel's scale, which quantizing the in-axis
    slice alone would not give."""
    _, tparams = weights
    q = quantize_params(tparams, TCFG)
    mesh = _tmesh(1, 2)
    sh = sharding.shard_params(q, mesh, TCFG)
    for t in range(2):
        pos = (0, 0, 0, 0, t)
        tree = sharding.position_tree(sh, pos)
        for name in ("wq", "wk", "wv", "w_gate", "w_up"):
            w = tparams["layers"][name]["kernel"]
            n = w.shape[-1] // 2
            for layer in range(TCFG.num_layers):
                want_q, want_s = quant_kernel(
                    w[layer, :, t * n:(t + 1) * n], 0)
                got = tree["layers"][name]
                assert torch.equal(got["kernel"][layer], want_q)
                assert torch.equal(got["scale"][layer], want_s)
        emb = tparams["embed"]["weight"]
        n = emb.shape[0] // 2
        want_q, want_s = quant_kernel(emb[t * n:(t + 1) * n], 1)
        assert torch.equal(tree["embed"]["weight"], want_q)
        assert torch.equal(tree["embed"]["scale"], want_s)
        for name in ("wo", "w_down"):
            whole = q["layers"][name]
            got = tree["layers"][name]
            assert torch.equal(got["scale"], whole["scale"])
            n = whole["kernel"].shape[1] // 2
            assert torch.equal(got["kernel"],
                               whole["kernel"][:, t * n:(t + 1) * n])
            alone = quant_kernel(
                tparams["layers"][name]["kernel"][0, t * n:(t + 1) * n], 0)
            assert not torch.equal(alone[1], whole["scale"][0])


def test_collectives_order_and_dtype():
    """all_reduce adds the partials in shard order in their own dtype, one
    rounding an add, and hands the sum back on every device; all_gather
    concatenates in shard order; the vocab-sharded lookup sums to the
    whole table's rows exactly (int8 rows dequantized)."""
    rng = np.random.default_rng(0)
    parts = [torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32))
             .to(torch.bfloat16) for _ in range(4)]
    got = collectives.all_reduce(parts, ["cpu"] * 4)
    want = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    assert all(g is got[0] for g in got)
    assert got[0].dtype == torch.bfloat16 and torch.equal(got[0], want)
    assert torch.equal(collectives.all_gather(parts, "cpu"),
                       torch.cat(parts, -1))
    table = torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32))
    toks = torch.tensor([[0, 3, 4, 7], [5, 1, 6, 2]])
    for quant in (False, True):
        emb = {"weight": table}
        if quant:
            w, s = quant_kernel(table, 1)
            emb = {"weight": w, "scale": s}
        whole = (emb["weight"][toks].float() * emb["scale"][toks][..., None]
                 ).to(torch.float32) if quant else table[toks]
        shards = [{k: v[t * 4:(t + 1) * 4] for k, v in emb.items()}
                  for t in range(2)]
        got = collectives.all_reduce(collectives.vocab_embed(
            shards, [toks, toks], torch.float32), ["cpu"] * 2)[0]
        assert torch.equal(got, whole)


def test_tp_forward_matches_jax():
    """tests/test_parallel.py::test_tp_forward_parity's setup: tiny_qwen3,
    PRNGKey(0) float32 weights, [2, 16] tokens; the port's MeshLM over
    (dp, tp) = (2, 2) against the JAX forward sharded over the same mesh
    and the JAX single-device forward, within 1e-5."""
    cfg = jax_tiny()
    params = init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    tokens = jax.random.randint(jax.random.PRNGKey(1), (2, 16), 0,
                                cfg.vocab_size)
    pos = jnp.broadcast_to(jnp.arange(16, dtype=jnp.int32), (2, 16))
    ref = np.asarray(jax_forward(params, cfg, tokens, pos)[0])
    jm = jmesh.make_mesh(JMesh(dp=2, tp=2, sp=1))
    jsharded = np.asarray(jax.jit(lambda p, t: jax_forward(
        p, cfg, t, pos)[0])(jax_shard_params(params, jm, cfg), tokens))
    tcfg = ModelConfig(**dataclasses.asdict(cfg))
    model = tl.MeshLM(tcfg, from_jax_params(jax.tree.map(np.asarray, params),
                                            tcfg), _tmesh(2, 2), 1)
    got = model.forward(torch.from_numpy(np.array(tokens)),
                        torch.from_numpy(np.array(pos))).numpy()
    np.testing.assert_allclose(got, jsharded, rtol=0, atol=TOL)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


@pytest.fixture(scope="module")
def moe_weights():
    cfg = jax_tiny_moe(moe_impl="gshard", moe_capacity_factor=8.0)
    jp = init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    tcfg = ModelConfig(**dataclasses.asdict(cfg))
    return cfg, jp, tcfg, from_jax_params(jax.tree.map(np.asarray, jp), tcfg)


@pytest.mark.parametrize("tp", [1, 2])
def test_moe_ep_matches_jax_gshard(moe_weights, tp):
    """tiny_qwen3_moe with its experts over ep 2 (and each over tp 2): the
    forward within 1e-5 of the JAX gshard forward, and the meshed engine's
    greedy tokens equal the JAX gshard engine's under the same mesh."""
    jcfg, jp, tcfg, tparams = moe_weights
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12))
    ref = np.asarray(jax_forward(jp, jcfg, jnp.asarray(tokens),
                                 jnp.asarray(pos))[0])
    model = tl.MeshLM(tcfg, tparams, _tmesh(1, tp, 2), 1)
    got = model.forward(torch.from_numpy(tokens),
                        torch.from_numpy(np.ascontiguousarray(pos))).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    serving = dict(BASE, prefill_chunk=0, prefix_cache=False)
    prompts = [rng.integers(2, jcfg.vocab_size, n).tolist() for n in (3, 9)]
    te = TEngine(tcfg, tparams, TServing(**serving), mesh=_tmesh(1, tp, 2))
    je = JEngine(jcfg, jp, JServing(**serving), mesh=_jmesh(1, tp, 2))
    assert te.cfg.moe_impl == "gshard"
    assert _run(te, prompts, 6) == _run(je, prompts, 6)


# -- the sharded load --------------------------------------------------------


LCFG = jax_tiny(num_heads=4, num_kv_heads=2, vocab_size=256, hidden_size=32,
                intermediate_size=64)


def _hf_tensors(cfg, seed: int = 0) -> dict:
    """A Qwen3 HF state dict of seeded normal weights (std 0.02; the norms
    around one), under the HF names."""
    gen = torch.Generator().manual_seed(seed)

    def w(*shape, mean=0.0):
        return torch.randn(shape, generator=gen) * 0.02 + mean

    H, D, I = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size
    sd = {"model.embed_tokens.weight": w(cfg.vocab_size, H),
          "model.norm.weight": w(H, mean=1.0)}
    if not cfg.tie_embeddings:
        sd["lm_head.weight"] = w(cfg.vocab_size, H)
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        sd.update({
            pre + "input_layernorm.weight": w(H, mean=1.0),
            pre + "post_attention_layernorm.weight": w(H, mean=1.0),
            pre + "self_attn.q_proj.weight": w(cfg.num_heads * D, H),
            pre + "self_attn.k_proj.weight": w(cfg.num_kv_heads * D, H),
            pre + "self_attn.v_proj.weight": w(cfg.num_kv_heads * D, H),
            pre + "self_attn.o_proj.weight": w(H, cfg.num_heads * D),
            pre + "self_attn.q_norm.weight": w(D, mean=1.0),
            pre + "self_attn.k_norm.weight": w(D, mean=1.0),
            pre + "mlp.gate_proj.weight": w(I, H),
            pre + "mlp.up_proj.weight": w(I, H),
            pre + "mlp.down_proj.weight": w(H, I)})
    return sd


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """A HF checkpoint directory of a Qwen3 (tests/test_sharded_load.py's
    config.json; seeded weights written here)."""
    from safetensors.torch import save_file

    d = tmp_path_factory.mktemp("hf_mesh")
    save_file(_hf_tensors(LCFG), str(d / "model.safetensors"))
    (d / "config.json").write_text(json.dumps({
        "model_type": "qwen3", "_name_or_path": "test-tiny-qwen3",
        "vocab_size": LCFG.vocab_size, "hidden_size": LCFG.hidden_size,
        "intermediate_size": LCFG.intermediate_size,
        "num_hidden_layers": LCFG.num_layers,
        "num_attention_heads": LCFG.num_heads,
        "num_key_value_heads": LCFG.num_kv_heads,
        "head_dim": LCFG.head_dim, "rms_norm_eps": LCFG.norm_eps,
        "rope_theta": LCFG.rope_theta,
        "tie_word_embeddings": LCFG.tie_embeddings,
        "eos_token_id": LCFG.eos_token_id}))
    return d


def _check_sharded(tree, whole, mesh, path=()):
    """Every part equals its slice of the whole leaf bit for bit; a split
    part is 1/size of its axis and owns its storage. Returns the number
    of split leaves."""
    n = 0
    for key, node in tree.items():
        if isinstance(node, dict):
            n += _check_sharded(node, whole[key], mesh, path + (key,))
            continue
        w = whole[key]
        assert isinstance(node, sharding.ShardedLeaf), path + (key,)
        split = any(a is not None for a in node.spec)
        n += split
        for pos, part in node.parts.items():
            index = sharding._slice_index(node.spec, mesh, pos)
            want = sharding._slice(w, node.spec, mesh, index)
            assert part.dtype == w.dtype and torch.equal(part, want), \
                path + (key,)
            if split:
                assert part.untyped_storage().nbytes() == \
                    part.numel() * part.element_size() < \
                    w.numel() * w.element_size()
    return n


@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "int8"])
def test_sharded_load_places_every_leaf(hf_dir, tmp_path, quantize,
                                        monkeypatch):
    """The loader hands every converted (quantized) leaf to the placement
    callback as it is produced: the sharded tree equals the whole load's
    slices bit for bit, tp-split leaves are 1/tp on each shard (at least
    the attention, MLP and embedding leaves), the cached restore places
    alike, and an engine of the sharded tree serves the unmeshed engine's
    greedy tokens."""
    monkeypatch.setenv("HOME", str(tmp_path))
    tcfg = ModelConfig(**dataclasses.asdict(LCFG))
    mesh = _tmesh(2, 2)
    put = sharding.make_sharded_put(mesh, tcfg)
    whole = load_checkpoint(str(hf_dir), tcfg, torch.bfloat16, "cpu",
                            quantize=quantize)
    calls = []

    def spy(path, arr):
        calls.append(path)
        return put(path, arr)

    placed = load_checkpoint(str(hf_dir), tcfg, torch.bfloat16,
                             quantize=quantize, place=spy)
    assert _check_sharded(placed, whole, mesh) >= 6
    paths = []
    sharding.map_tree(lambda p, _: paths.append(p), whole)
    assert len(calls) == len(paths) and sorted(calls) == sorted(paths)
    cached = [load_checkpoint_cached(str(hf_dir), tcfg, torch.bfloat16,
                                     "cpu", quantize=quantize, place=put)
              for _ in range(2)]
    for tree in cached:
        _check_sharded(tree, whole, mesh)
    serving = TServing(**dict(BASE, weights_dtype="int8" if quantize
                              else "bf16", dtype="bfloat16"))
    prompts = [np.random.default_rng(5).integers(2, 256, 7).tolist()]
    meshed = TEngine(tcfg, placed, serving, mesh=mesh)
    single = TEngine(tcfg, whole, serving, device="cpu")
    assert _run(meshed, prompts, 6) == _run(single, prompts, 6)
