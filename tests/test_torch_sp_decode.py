"""Sequence-parallel serving in the port against the JAX package.

The dense cache's sequence axis split over ``sp`` shards
(``parallel/sharding.init_cache_sharded``), K6 (the stats form of the dense
decode kernel) over each shard and the log-sum-exp merge, on the same
numpy-seeded inputs as the JAX package's Pallas kernels (interpret mode)
and its ``shard_map`` decode over virtual CPU devices:

- K6's plain version (the CPU side of ``decode_attend_dense_stats``)
  against ``decode_attend_pallas_layer(return_stats=True)``, float32 and
  bf16 q, float32 and int8 caches, local lengths 0, 1, a chunk edge and
  full: ``acc``, ``m`` and ``l`` within 1e-5 (both accumulate in float32
  and differ only in summation order), ``m`` exactly -1e30 for a shard
  with no row;
- the merge over 2 and 4 shards against ``dense_attention_plain`` over the
  unsharded cache, within 1e-5;
- one layer of the port's sp decode callback against JAX's under
  ``shard_map``: the context within 1e-5 and every shard's cache bits
  equal after the write (a non-owner shard's row drops);
- the port's ``Engine`` at meshes (1, 1, 2) and (1, 1, 4), float32 and
  int8 KV, byte-identical greedy and seeded streams to the JAX sp engine
  and the JAX single-device dense engine, decode and chunked prefill
  crossing shard edges;
- the JAX engine's sp gates, ``make_mesh`` and ``auto_mesh_config``.

tiny_qwen3(num_heads=4, num_kv_heads=2, vocab_size=256) at float32 with a
64-row window, as ``tests/test_engine_mesh.py`` sizes it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aws_k8s_ansible_provisioner_tpu.config import MeshConfig as JMesh
from aws_k8s_ansible_provisioner_tpu.config import ServingConfig as JServing
from aws_k8s_ansible_provisioner_tpu.config import tiny_mistral as jax_mistral
from aws_k8s_ansible_provisioner_tpu.config import tiny_qwen3 as jax_tiny
from aws_k8s_ansible_provisioner_tpu.models import layers as jl
from aws_k8s_ansible_provisioner_tpu.models.layers import init_params
from aws_k8s_ansible_provisioner_tpu.ops import attention as jattn
from aws_k8s_ansible_provisioner_tpu.ops import pallas_attention as pa
from aws_k8s_ansible_provisioner_tpu.parallel import mesh as jmesh
from aws_k8s_ansible_provisioner_tpu.serving.engine import Engine as JEngine
from aws_k8s_ansible_provisioner_tpu.serving.engine import Request as JRequest
from aws_k8s_ansible_provisioner_tpu_torch.config import (MeshConfig,
                                                          ModelConfig)
from aws_k8s_ansible_provisioner_tpu_torch.config import \
    ServingConfig as TServing
from aws_k8s_ansible_provisioner_tpu_torch.models.convert import \
    from_jax_params
from aws_k8s_ansible_provisioner_tpu_torch.models import layers as tl
from aws_k8s_ansible_provisioner_tpu_torch.ops import attention as tattn
from aws_k8s_ansible_provisioner_tpu_torch.ops import dense_attention as tda
from aws_k8s_ansible_provisioner_tpu_torch.parallel import mesh as tmesh
from aws_k8s_ansible_provisioner_tpu_torch.parallel import sharding
from aws_k8s_ansible_provisioner_tpu_torch.serving import kv_cache as tkvc
from aws_k8s_ansible_provisioner_tpu_torch.serving import server as tserver
from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import \
    Engine as TEngine
from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import \
    Request as TRequest

torch.set_num_threads(2)

TOL = 1e-5
L, HKV, HQ, D, S = 2, 2, 4, 16, 64
JCFG = jax_tiny(num_heads=4, num_kv_heads=2, vocab_size=256)
TCFG = ModelConfig(**dataclasses.asdict(JCFG))
SP = pytest.mark.parametrize("sp", [2, 4])
KV_DTYPES = pytest.mark.parametrize("kv_dtype", ["auto", "int8"])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cache(B, quant, seed, s=S):
    """A random dense cache [L, B, HKV, s, D]: float32, or int8 with
    positive float32 scales (numpy)."""
    rng = np.random.default_rng(seed)
    shape = (L, B, HKV, s, D)
    if not quant:
        return {n: rng.standard_normal(shape).astype(np.float32)
                for n in ("k", "v")}
    return {"k": rng.integers(-127, 128, shape).astype(np.int8),
            "v": rng.integers(-127, 128, shape).astype(np.int8),
            "ks": rng.uniform(1e-3, 0.1, shape[:-1]).astype(np.float32),
            "vs": rng.uniform(1e-3, 0.1, shape[:-1]).astype(np.float32)}


def _scales(cache, conv):
    if "ks" not in cache:
        return {}
    return {"cache_ks": conv(cache["ks"]), "cache_vs": conv(cache["vs"])}


def _split(cache, sp):
    """The numpy cache split along S into ``sp`` shards."""
    return [{n: np.ascontiguousarray(np.split(a, sp, axis=3)[i])
             for n, a in cache.items()} for i in range(sp)]


# -- K6 against the Pallas stats kernel --------------------------------------


@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quant", [False, True])
def test_k6_plain_matches_pallas_stats(qdtype, quant):
    """Local lengths 0 (a shard with none of the slot's rows), 1, the
    chunk edge (16, 17 with chunk 16) and full: the flash triple within
    1e-5 of the Pallas kernel's; the empty shard's (0, -1e30, 0) exact on
    both sides. A bf16 q is the same bits on both sides (float32 rounded
    to nearest even); the caches are float32 or int8, as the kernels take
    them beside a float32 q."""
    cache = _cache(5, quant, seed=1)
    if not quant and qdtype == "bfloat16":
        cache = {n: a.astype(jnp.bfloat16) for n, a in cache.items()}
    lengths = np.array([0, 1, 16, 17, S], np.int32)
    q = np.random.default_rng(2).standard_normal((5, 1, HQ, D)) \
        .astype(np.float32)
    jq = jnp.asarray(q).astype(qdtype)
    tq = _t(q).to(getattr(torch, qdtype))
    for layer in range(L):
        jacc, jm, jl = pa.decode_attend_pallas_layer(
            jq, jnp.asarray(cache["k"]), jnp.asarray(cache["v"]),
            jnp.asarray(lengths), jnp.int32(layer), chunk=16, interpret=True,
            return_stats=True, **_scales(cache, jnp.asarray))
        tc = {n: (_t(a.astype(np.float32)).to(torch.bfloat16)
                  if a.dtype == jnp.bfloat16 else _t(a))
              for n, a in cache.items()}
        acc, m, l_sum = tda.decode_attend_dense_stats(
            tq, tc["k"], tc["v"], _t(lengths), layer,
            **_scales(tc, lambda x: x))
        for got, ref in ((acc, jacc), (m, jm), (l_sum, jl)):
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       rtol=TOL, atol=TOL)
        assert (m[0] == -1e30).all() and (np.asarray(jm)[0] == -1e30).all()
        assert not acc[0].any() and not l_sum[0].any()
        assert (m[1:] > -1e29).all() and (l_sum[1:] >= 1.0).all()


@SP
@pytest.mark.parametrize("quant", [False, True])
def test_merge_over_shards_matches_dense_plain(sp, quant):
    """K6 over each shard at its local lengths clip(lengths - off, 0,
    S_local), merged: the unsharded dense attention within 1e-5, a slot of
    length 0 zeros, slots ending on and either side of shard edges."""
    B = 7
    cache = _cache(B, quant, seed=3)
    s_local = S // sp
    lengths = np.array([0, 1, s_local - 1, s_local, s_local + 1, S - 3, S],
                       np.int32)
    q = _t(np.random.default_rng(4).standard_normal((B, 1, HQ, D))
           .astype(np.float32))
    full = {n: _t(a) for n, a in cache.items()}
    for layer in range(L):
        parts = []
        for i, shard in enumerate(_split(cache, sp)):
            local = np.clip(lengths - i * s_local, 0, s_local)
            sh = {n: _t(a) for n, a in shard.items()}
            parts.append(tda.decode_attend_dense_stats(
                q, sh["k"], sh["v"], _t(local), layer,
                **_scales(sh, lambda x: x)))
        ctx = tattn.merge_stats(*zip(*parts), torch.device("cpu"))
        ref = tda.dense_attention_plain(q, full["k"], full["v"],
                                        _t(lengths), layer, 0,
                                        full.get("ks"), full.get("vs"))
        np.testing.assert_allclose(ctx.numpy(), ref[:, 0].numpy(), rtol=TOL,
                                   atol=TOL)
        assert not ctx[0].any()


def test_cpu_k6_counts_no_launch():
    """On the CPU the wrapper takes the plain version and counts nothing."""
    before = tda.launch_counts()
    cache = _cache(2, True, seed=5)
    tc = {n: _t(a) for n, a in cache.items()}
    tda.decode_attend_dense_stats(torch.zeros(2, 1, HQ, D), tc["k"], tc["v"],
                                  torch.tensor([3, 0]), 0,
                                  tc["ks"], tc["vs"])
    assert tda.launch_counts() == before
    assert "decode_attend_dense stats" in before
    assert "decode_attend_dense quant stats" in before
    assert "decode_attend_dense stats window" not in before
    assert tda.instance_name("decode_attend_dense", True, stats=True) == \
        "decode_attend_dense quant stats"


# -- the decode callback against JAX's shard_map ----------------------------


def _jax_mesh(sp):
    return jmesh.make_mesh(JMesh(sp=sp), devices=jax.devices("cpu"))


def _cpu_mesh(sp):
    return tmesh.make_mesh(MeshConfig(sp=sp), ["cpu"] * sp)


@SP
@pytest.mark.parametrize("quant", [False, True])
def test_sp_decode_callback_matches_jax_shard_map(sp, quant):
    """One layer of the port's sp decode callback and JAX's (Pallas in
    interpret mode under shard_map): the new rows land in the owning shard
    only (the other shards' writes drop), every shard's cache bits equal
    JAX's after the write, and the merged context within 1e-5. Slots end
    before, on and after shard edges, one writes the window's last row.
    The port's callback takes the raw q/k and the layer's ``QKPrep`` (its
    row write applies the prologue); JAX's takes them after its
    ``apply_rope`` over the same float32 tables. RoPE only: at float32 the
    two packages' ``rms_norm`` differ in the last bit (their mean of
    squares sums in another order); tests/test_torch_dense_qk_prep.py holds
    the norm in bf16, where both round to the same values."""
    B = 6
    s_local = S // sp
    rng = np.random.default_rng(6)
    cache = _cache(B, False, seed=7)
    if quant:
        # a cache as the engine holds it: quantized rows and their scales
        k8, ks = tkvc.quantize_rows(_t(cache["k"]))
        v8, vs = tkvc.quantize_rows(_t(cache["v"]))
        cache = {"k": k8.numpy(), "v": v8.numpy(), "ks": ks.numpy(),
                 "vs": vs.numpy()}
    lengths = np.array([0, s_local - 1, s_local, s_local + 3, S - 2, S - 1],
                       np.int32)
    q = rng.standard_normal((B, 1, HQ, D)).astype(np.float32)
    k = rng.standard_normal((B, 1, HKV, D)).astype(np.float32)
    v = rng.standard_normal((B, 1, HKV, D)).astype(np.float32)
    cos, sin = tl.rope_cos_sin(torch.from_numpy(lengths)[:, None], D,
                               TCFG.rope_theta)
    prep = tl.QKPrep(None, None, TCFG.norm_eps, cos, sin)
    layer = 1
    jq, jk = (jl.apply_rope(jnp.asarray(x), jnp.asarray(cos.numpy()),
                            jnp.asarray(sin.numpy()), D) for x in (q, k))
    jmesh_ = _jax_mesh(sp)
    jfn = jattn.make_decode_attend_carry(jnp.asarray(lengths), impl="pallas",
                                         mesh=jmesh_)
    jctx, (jcache, _) = jax.jit(lambda c: jfn(
        jq, jk, jnp.asarray(v),
        (c, jnp.int32(layer))))({n: jnp.asarray(a) for n, a in cache.items()})

    shards = [{n: _t(a) for n, a in sh.items()} for sh in _split(cache, sp)]
    before = [{n: t.clone() for n, t in sh.items()} for sh in shards]
    tfn = tattn.make_decode_attend_carry(_t(lengths), mesh=_cpu_mesh(sp))
    assert tfn.fuses_qk_prep
    tctx, (out, _) = tfn(_t(q), _t(k), _t(v), (shards, layer), prep)
    assert out is shards
    np.testing.assert_allclose(tctx.numpy(), np.asarray(jctx), rtol=TOL,
                               atol=TOL)
    ref = _split({n: np.asarray(a) for n, a in jcache.items()}, sp)
    for i, (got, want, old) in enumerate(zip(shards, ref, before)):
        for name in want:
            np.testing.assert_array_equal(got[name].numpy(), want[name],
                                          err_msg=f"shard {i} {name}")
        changed = (got["k"] != old["k"]).any(-1).any(2)       # [L, B, S]
        for b, n in enumerate(lengths):
            rows = changed[layer, b].nonzero().flatten().tolist()
            own = 0 <= n - i * s_local < s_local
            assert rows == ([int(n) - i * s_local] if own else []), \
                (i, b, rows)


def test_sp_decode_refuses_a_window():
    with pytest.raises(ValueError, match="sliding-window"):
        tattn.make_decode_attend_carry(torch.zeros(2, dtype=torch.int32),
                                       window=8, mesh=_cpu_mesh(2))


def test_sharded_writes_and_gather_match_the_unsharded_cache():
    """write_prompts and write_chunk into shards, rows gathered back: the
    unsharded cache's rows bit for bit (int8 too; rows past the window
    drop), and the sharded cache allocated per shard on its device."""
    for quant in (False, True):
        whole = tkvc.init_cache(TCFG, 3, S, torch.float32, "cpu", quant)
        shards = sharding.init_cache_sharded(TCFG, 3, S, torch.float32,
                                             _cpu_mesh(4), quant)
        assert len(shards) == 4 and all(
            tuple(sh["k"].shape) == (TCFG.num_layers, 3, HKV, S // 4, D)
            for sh in shards)
        rng = np.random.default_rng(8)
        k, v = (_t(rng.standard_normal((2, 40, HKV, D)).astype(np.float32))
                for _ in range(2))
        slots = torch.tensor([2, 0])
        for c in (whole, shards):
            tkvc.write_prompts(c, 1, slots, k, v)
            tkvc.write_chunk(c, 0, 1, 50, k[:1, :20], v[:1, :20])
        for layer, slot in ((1, 2), (1, 0), (0, 1)):
            got = sharding.gather_rows(shards, layer, slot, S, "cpu")
            for name in whole:
                np.testing.assert_array_equal(
                    got[name].numpy(), whole[name][layer, slot].numpy())
        assert whole["k"][0, 1, :, 50:].any()


# -- engines against the JAX engines ----------------------------------------


def _scaled(params):
    """Projection kernels and the embedding times 8, so that greedy streams
    do not collapse onto one repeated token (as tests/test_torch_engine.py
    scales them)."""
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


BASE = dict(max_decode_slots=4, max_cache_len=64, prefill_buckets=(8, 16),
            dtype="float32", prefill_chunk=16)
SAMPLED = dict(temperature=0.8, top_p=0.9, top_k=20, ignore_eos=True)


def _run(engine, prompts, max_tokens, seeds=None):
    """Submit the prompts (greedy, or sampled with ``seeds``) and step to
    the end; returns the requests."""
    cls = JRequest if isinstance(engine, JEngine) else TRequest
    reqs = []
    for i, p in enumerate(prompts):
        kw = dict(ignore_eos=True) if seeds is None or seeds[i] is None \
            else dict(seed=seeds[i], **SAMPLED)
        reqs.append(engine.submit(cls(prompt_ids=list(p),
                                      max_tokens=max_tokens, **kw)))
    for _ in range(10000):
        if not engine.step():
            break
    return reqs


def _prompts(lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, JCFG.vocab_size, n).tolist() for n in lengths]


@SP
@KV_DTYPES
@pytest.mark.parametrize("case", ["mesh_prompts", "long_generation",
                                  "chunked", "seeded"])
def test_sp_engine_streams_match_jax(weights, sp, kv_dtype, case):
    """The port's sp engine against the JAX sp engine (Pallas in interpret
    mode under shard_map) and the JAX single-device dense engine:
    byte-identical streams for the prompts of tests/test_engine_mesh.py
    (3, 9, 14 tokens), a 40-token generation across the shard edges, a
    chunked prefill longer than one shard beside running requests, and
    seeded sampled requests (one greedy beside them)."""
    jparams, tparams = weights
    max_tokens, seeds = 8, None
    if case == "mesh_prompts":
        prompts = _prompts((3, 9, 14), 5)
    elif case == "long_generation":
        prompts, max_tokens = _prompts((4,), 6), 40
    elif case == "chunked":
        prompts, max_tokens = _prompts((5, 40, 12, 21), 7), 12
    else:
        prompts, max_tokens = _prompts((5, 36, 12), 8), 14
        seeds = [11, 2**32 + 5, None]
    serving = dict(BASE, kv_dtype=kv_dtype)
    jsp = JEngine(JCFG, jparams, JServing(
        weights_dtype="bf16", prefix_cache=False, attention_impl="pallas",
        **serving), mesh=_jax_mesh(sp))
    jone = JEngine(JCFG, jparams, JServing(
        weights_dtype="bf16", prefix_cache=False, paged=False, **serving))
    te = TEngine(TCFG, tparams, TServing(weights_dtype="bf16",
                                         prefix_cache=False, **serving),
                 device="cpu", mesh=_cpu_mesh(sp))
    got = [r.generated for r in _run(te, prompts, max_tokens, seeds)]
    assert got == [r.generated for r in _run(jsp, prompts, max_tokens,
                                             seeds)]
    assert got == [r.generated for r in _run(jone, prompts, max_tokens,
                                             seeds)]
    assert all(len(g) == max_tokens for g in got)
    assert isinstance(te.cache, list) and len(te.cache) == sp
    assert ("ks" in te.cache[0]) == (kv_dtype == "int8")
    assert te.counts["decode_substeps"] > 0
    if case == "chunked":
        assert te.counts["chunk_dispatches"] >= 3
    if case == "long_generation":
        assert te.lengths[0] > 64 // sp


# -- the gates ----------------------------------------------------------------


def test_sp_engine_gates(weights):
    """The JAX engine's sp gates: a sliding window and a window that does
    not split into 8-row-aligned shards are refused, the layout is dense
    whatever ``paged`` says, speculation is off; sp beside tp, and pp > 1,
    are refused rather than served as one device (dp and tp alone are
    served: tests/test_torch_mesh.py)."""
    _, tparams = weights
    serving = TServing(weights_dtype="bf16", **BASE)
    mcfg = ModelConfig(**dataclasses.asdict(jax_mistral()))
    mparams = from_jax_params(jax.tree.map(np.asarray, init_params(
        jax_mistral(), jax.random.PRNGKey(0), dtype=jnp.float32)), mcfg)
    with pytest.raises(ValueError, match="sliding-window"):
        TEngine(mcfg, mparams, serving, device="cpu", mesh=_cpu_mesh(2))
    with pytest.raises(ValueError, match="sequence shards"):
        TEngine(TCFG, tparams, dataclasses.replace(serving, max_cache_len=40),
                device="cpu", mesh=_cpu_mesh(2))
    for axes in (dict(sp=2, tp=2), dict(pp=2)):
        mesh = tmesh.make_mesh(MeshConfig(**axes), ["cpu"] * 4)
        with pytest.raises(ValueError, match="not ported"):
            TEngine(TCFG, tparams, serving, device="cpu", mesh=mesh)
    for axes in (dict(dp=2), dict(tp=2)):
        mesh = tmesh.make_mesh(MeshConfig(**axes), ["cpu"] * 4)
        assert TEngine(TCFG, tparams, serving, device="cpu",
                       mesh=mesh).paged
    te = TEngine(TCFG, tparams, dataclasses.replace(
        serving, paged=True, spec_decode=True), device="cpu",
        mesh=_cpu_mesh(2))
    assert not te.paged and not te.spec_decode and te.draft is None
    assert te.allocator is None and isinstance(te.cache, list)
    reqs = _run(te, [[5, 6, 7, 5, 6, 7, 5, 6, 7, 5, 6]], 10)
    assert len(reqs[0].generated) == 10
    assert te.counts["spec_dispatches"] == 0
    # an sp mesh of 1 is the single-device engine
    one = TEngine(TCFG, tparams, serving, device="cpu", mesh=_cpu_mesh(1))
    assert one.sp == 1 and one.paged and isinstance(one.cache, dict)
    with pytest.raises(ValueError, match="lead device"):
        TEngine(TCFG, tparams, serving, device="cuda", mesh=_cpu_mesh(2))


def test_make_mesh_needs_enough_devices(monkeypatch):
    """Without a device list the mesh takes the visible CUDA cards and
    raises when there are too few; an explicit list may repeat a device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="needs 2 devices, have 0"):
        tmesh.make_mesh(MeshConfig(sp=2))
    with pytest.raises(ValueError, match="needs 4 devices, have 2"):
        tmesh.make_mesh(MeshConfig(sp=4), ["cpu", "cpu"])
    with pytest.raises(ValueError, match="needs 2 devices"):
        TEngine(TCFG, {}, TServing(mesh=MeshConfig(sp=2)), device="cpu")
    mesh = tmesh.make_mesh(MeshConfig(dp=2, sp=2), ["cpu"] * 4)
    assert mesh.shape == {"dp": 2, "pp": 1, "sp": 2, "ep": 1, "tp": 1}
    assert mesh.axis_devices("sp") == [torch.device("cpu")] * 2
    assert mesh.lead == torch.device("cpu")
    assert mesh.devices.shape == (2, 1, 2, 1, 1)


@pytest.mark.parametrize("n", range(1, 9))
def test_auto_mesh_config_matches_jax(n):
    for want_sp in (True, False):
        for max_tp in (1, 2, 8):
            assert dataclasses.asdict(tmesh.auto_mesh_config(
                n, want_sp, max_tp)) == dataclasses.asdict(
                jmesh.auto_mesh_config(n, want_sp, max_tp))


def test_check_tp_divisibility_matches_jax():
    from aws_k8s_ansible_provisioner_tpu.parallel import sharding as jshard

    for tp in (1, 2, 3, 4):
        errs = []
        for fn, cfg in ((jshard.check_tp_divisibility, JCFG),
                        (sharding.check_tp_divisibility, TCFG)):
            try:
                fn(cfg, tp)
                errs.append(None)
            except ValueError as e:
                errs.append(str(e))
        assert errs[0] == errs[1]


def test_server_sp_flag_builds_the_mesh(monkeypatch):
    """--sp reaches ServingConfig.mesh (the JAX server's flag); on the CPU
    the server's engine runs every shard on the CPU."""
    seen = {}

    class Built(Exception):
        pass

    def build_state(serving, **kw):
        seen["serving"] = serving
        raise Built

    real = tserver.build_state
    monkeypatch.setattr(tserver, "build_state", build_state)
    with pytest.raises(Built):
        tserver.main(["--model", "tiny-qwen3", "--device", "cpu", "--sp",
                      "2"])
    assert seen["serving"].mesh == MeshConfig(sp=2)
    state = real(TServing(model="tiny-qwen3", max_decode_slots=2,
                          max_cache_len=64, prefill_buckets=(16, 32),
                          dtype="float32", kv_dtype="int8",
                          mesh=MeshConfig(sp=2)), device="cpu")
    engine = state.engine
    assert engine.sp == 2 and not engine.paged and len(engine.cache) == 2
    req = engine.submit(TRequest(prompt_ids=list(range(3, 30)),
                                 max_tokens=4, ignore_eos=True))
    engine.run_until_idle()
    assert len(req.generated) == 4
