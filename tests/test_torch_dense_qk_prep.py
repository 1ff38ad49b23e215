"""The fused q/k prologue and dense row write (K8 and K9 with the q/k
RMSNorm and RoPE fused in) against the JAX package.

``prep_write_rows_dense`` and ``prep_write_rows_quant_dense`` take a
layer's raw q, k and v rows [B, R, H, D]; their plain versions (what the
CUDA kernel is held to on the card) and the CPU path of their wrappers are
compared with the JAX composition they replace: ``models/layers.py``'s
``rms_norm`` (Qwen3 only) and ``apply_rope`` of q and k, then
``cache_write_row`` or ``cache_write_row_quant`` in Pallas interpret mode
for K and for V, one call per row of each slot (R calls in a verify, as
the JAX verify makes them), on the same numpy-seeded bf16 inputs and the
same float32 RoPE tables (the JAX and port ``rope_cos_sin`` differ in the
last float32 bit). The decode rows (0, mid-cache, S - 1, S and -1), the
verify's rows running past S and a sequence shard's ``lengths - off``
rows (a non-owner's rows drop) are covered, tiny Qwen3 and tiny Mistral
and the other families' head dims and rotary widths (D 80 with RoPE over
32 columns, no RoPE, D 256, llama3 tables), bf16 and int8 caches. The prepped q, the caches and the scales must be
bit-identical.

Then the serving callbacks: ``model_forward_carry`` and ``decoder_block``
through the fused dense decode (bblock 1 and 2), verify and
sequence-parallel decode callbacks give the bytes of the same forward
through the unfused form (the prologue in the block, then the standalone
K8 or K9 and the same attention).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aws_k8s_ansible_provisioner_tpu.models import layers as jl
from aws_k8s_ansible_provisioner_tpu.ops import pallas_attention as pa
from aws_k8s_ansible_provisioner_tpu_torch.config import (MeshConfig,
                                                          tiny_gemma,
                                                          tiny_llama,
                                                          tiny_mistral,
                                                          tiny_opt, tiny_phi,
                                                          tiny_qwen3)
from aws_k8s_ansible_provisioner_tpu_torch.models import layers as tl
from aws_k8s_ansible_provisioner_tpu_torch.ops import attention as tattn
from aws_k8s_ansible_provisioner_tpu_torch.ops import dense_attention as tda
from aws_k8s_ansible_provisioner_tpu_torch.parallel import sharding
from aws_k8s_ansible_provisioner_tpu_torch.parallel.mesh import make_mesh
from aws_k8s_ansible_provisioner_tpu_torch.serving import kv_cache as tkvc

torch.set_num_threads(2)

L, B, S = 2, 5, 32
# Qwen3 (q/k norm) and Mistral at D 16, and the other families' head dims
# and rotary widths: Phi-2's RoPE over 32 of 80 columns, OPT's none, Gemma's
# D 256, Llama's llama3 frequencies
CFGS = {"qwen3": tiny_qwen3(), "mistral": tiny_mistral(),
        "phi_d80_r32": tiny_phi(head_dim=80, rotary_pct=0.4),
        "opt_r0": tiny_opt(), "gemma_d256": tiny_gemma(head_dim=256),
        "llama": tiny_llama()}


def _rows(kind):
    """(rows [B, R], positions [B, R]) of a row layout over a cache of S
    rows. decode: one row per slot at 0, mid-cache, S - 1, S (past the
    cache) and -1 (a dead row at position 0); verify: 4 rows per slot from
    lengths 0, 9, S - 4, S - 2 and S - 1, the last two running past S;
    shard: the decode rows of slots at 3, 15, 16, 29 and 31 over a cache
    of 2 S rows seen from its second shard of S rows (rows ``lengths - S``:
    the first two slots' are the other shard's and drop)."""
    if kind == "decode":
        lengths = np.array([0, 13, S - 1, S, -1])
        rows = lengths[:, None]
        return rows, np.maximum(rows, 0)
    if kind == "verify":
        lengths = np.array([0, 9, S - 4, S - 2, S - 1])
        rows = lengths[:, None] + np.arange(4)
        return rows, rows
    lengths = np.array([3, 15, 16, 29, 31]) * 2
    return (lengths - S)[:, None], lengths[:, None]


def _inputs(cfg, kind, quant, seed):
    """Numpy-seeded bf16 q/k/v rows [B, R, H, D], norm weights (Qwen3), the
    float32 RoPE tables of the rows' positions, rows [B, R] int32 and a
    random dense cache [L, B, Hkv, S, D] (int8 with scales when
    ``quant``)."""
    rng = np.random.default_rng(seed)
    rows, positions = _rows(kind)
    R, D, hkv = rows.shape[1], cfg.head_dim, cfg.num_kv_heads

    def bf16(shape, scale=1.0):
        return torch.from_numpy(
            (scale * rng.standard_normal(shape)).astype(np.float32)).bfloat16()

    q = bf16((B, R, cfg.num_heads, D), 3.0)
    k, v = bf16((B, R, hkv, D), 3.0), bf16((B, R, hkv, D))
    norms = ((1.0 + 0.1 * bf16((D,)).float()).bfloat16(),
             (1.0 + 0.1 * bf16((D,)).float()).bfloat16()) \
        if cfg.qk_norm else (None, None)
    cos, sin = tl.rope_cos_sin(torch.from_numpy(positions), cfg.rotary_dim,
                               cfg.rope_theta, cfg)
    prep = tl.QKPrep(*norms, cfg.norm_eps, cos, sin)
    shape = (L, B, hkv, S, D)
    if quant:
        cache = {n: torch.from_numpy(rng.integers(-127, 128, shape)
                                     .astype(np.int8)) for n in ("k", "v")}
        cache.update({n: torch.from_numpy(rng.uniform(1e-3, 0.1, shape[:-1])
                                          .astype(np.float32))
                      for n in ("ks", "vs")})
    else:
        cache = {"k": bf16(shape), "v": bf16(shape)}
    return q, k, v, torch.from_numpy(rows.astype(np.int32)), prep, cache


def _j(t):
    """A torch tensor as a JAX array of the same type."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _t(a):
    """A JAX array as a torch tensor of the same type."""
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()
    return torch.from_numpy(np.array(a))


def _jax_prep_write(q, k, v, rows, prep, cache, layer):
    """The JAX composition: rms_norm (when the prep has weights) and
    apply_rope of q and k, then the Pallas dense row write (interpret mode)
    of K and of V, one call per row r of every slot, as the JAX verify
    calls it."""
    cos, sin = _j(prep.cos), _j(prep.sin)
    jq, jk = _j(q), _j(k)
    if prep.q_norm is not None:
        jq = jl.rms_norm(jq, _j(prep.q_norm), prep.eps)
        jk = jl.rms_norm(jk, _j(prep.k_norm), prep.eps)
    r = prep.rotary_dim
    if r:
        jq = jl.apply_rope(jq, cos, sin, r)
        jk = jl.apply_rope(jk, cos, sin, r)
    jv = _j(v)
    out = {n: _j(t) for n, t in cache.items()}
    for r in range(rows.shape[1]):
        args = (jnp.asarray(rows.numpy()[:, r]), jnp.int32(layer))
        for name, new in (("k", jk), ("v", jv)):
            if "ks" in out:
                out[name], out[name + "s"] = pa.cache_write_row_quant(
                    out[name], out[name + "s"], new[:, r], *args,
                    interpret=True)
            else:
                out[name] = pa.cache_write_row(out[name], new[:, r], *args,
                                               interpret=True)
    return _t(jq), {n: _t(a) for n, a in out.items()}


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("model", sorted(CFGS))
@pytest.mark.parametrize("kind", ["decode", "verify", "shard"])
def test_fused_dense_write_bit_identical_to_jax(kind, model, quant):
    """The plain versions and the CPU wrappers: q, every cache leaf and
    scale bit-identical to JAX's prologue and Pallas writes."""
    cfg = CFGS[model]
    q, k, v, rows, prep, cache = _inputs(cfg, kind, quant,
                                         seed=len(kind) + 2 * quant)
    layer = 1
    ref_q, ref = _jax_prep_write(q, k, v, rows, prep, cache, layer)
    fns = ((tda.prep_write_rows_quant_dense_plain,
            tda.prep_write_rows_quant_dense) if quant
           else (tda.prep_write_rows_dense_plain, tda.prep_write_rows_dense))
    for fn in fns:
        got = {n: t.clone() for n, t in cache.items()}
        got_q = fn(*got.values(), q, k, v, rows, layer, prep)
        assert got_q.dtype == q.dtype and got_q.shape == q.shape
        assert torch.equal(got_q, ref_q)
        for name in cache:
            assert torch.equal(got[name], ref[name]), name
    # kept rows landed, dropped rows did not touch the cache
    kept = (rows >= 0) & (rows < S)
    changed = (ref["v"] != cache["v"]).any(dim=(2, 4))[layer]     # [B, S]
    assert int(changed.sum()) == int(kept.sum()) > 0
    for b in range(B):
        want = sorted(set(rows[b][kept[b]].tolist()))
        assert changed[b].nonzero().flatten().tolist() == want, b
    assert torch.equal(ref["k"][0], cache["k"][0])      # other layer intact


def test_fused_dense_write_takes_the_raw_projection_views():
    """The wrappers take q, k and v as the block's projections leave them
    (views of one layout) and give the bytes of contiguous copies."""
    cfg = CFGS["qwen3"]
    q, k, v, rows, prep, cache = _inputs(cfg, "verify", False, seed=3)
    H = cfg.num_heads + 2 * cfg.num_kv_heads
    fused = torch.cat([q, k, v], dim=2)                  # [B, R, H, D]
    assert fused.shape[2] == H
    views = torch.split(fused, [cfg.num_heads, cfg.num_kv_heads,
                                cfg.num_kv_heads], dim=2)
    assert not views[1].is_contiguous()
    got = {n: t.clone() for n, t in cache.items()}
    want = {n: t.clone() for n, t in cache.items()}
    got_q = tda.prep_write_rows_dense(*got.values(), *views, rows, 1, prep)
    want_q = tda.prep_write_rows_dense(*want.values(), q, k, v, rows, 1, prep)
    assert torch.equal(got_q, want_q)
    for name in cache:
        assert torch.equal(got[name], want[name]), name


def test_cpu_wrappers_count_no_launch_and_other_devices_raise():
    cfg = CFGS["qwen3"]
    q, k, v, rows, prep, cache = _inputs(cfg, "decode", True, seed=9)
    before = tda.launch_counts()
    tda.prep_write_rows_quant_dense(*cache.values(), q, k, v, rows, 0, prep)
    assert tda.launch_counts() == before
    assert before["prep_write_rows_dense"] >= 0
    assert "prep_write_rows_quant_dense" in before
    meta = {n: t.to("meta") for n, t in cache.items()}
    with pytest.raises(ValueError, match="unsupported device"):
        tda.prep_write_rows_quant_dense(*meta.values(), q.to("meta"),
                                        k.to("meta"), v.to("meta"), rows, 0,
                                        prep)


# -- the serving callbacks ---------------------------------------------------


def _unfused(kind, lengths, window, bblock, mesh):
    """The dense callbacks as they were before the fusion: q/k prepped by
    the block, the standalone row write (K8, or K9 into an int8 cache),
    then the same attention entry (sp: K6 over each shard and the merge)."""

    def write(cache, k, v, rows, layer):
        if "ks" in cache:
            tda.cache_write_rows_quant_dense(*cache.values(), k, v, rows,
                                             layer)
            return {"cache_ks": cache["ks"], "cache_vs": cache["vs"]}
        tda.cache_write_rows_dense(cache["k"], cache["v"], k, v, rows, layer)
        return {}

    def decode(q, k, v, cache_l):
        cache, layer = cache_l
        scales = write(cache, k.contiguous(), v.contiguous(),
                       lengths[:, None], layer)
        return tda.decode_attend_dense(q, cache["k"], cache["v"],
                                       lengths + 1, layer, window, **scales,
                                       bblock=bblock), cache_l

    def spec(q, k, v, cache_l):
        cache, layer = cache_l
        R = k.shape[1]
        rows = lengths[:, None] + torch.arange(R, dtype=torch.int32)
        scales = write(cache, k.contiguous(), v.contiguous(), rows, layer)
        return tda.spec_attend_dense(q, cache["k"], cache["v"], lengths,
                                     layer, window, **scales), cache_l

    def sp(q, k, v, cache_l):
        shards, layer = cache_l
        s_local = shards[0]["k"].shape[3]
        parts = []
        for i, shard in enumerate(shards):
            scales = write(shard, k.contiguous(), v.contiguous(),
                           (lengths - i * s_local)[:, None], layer)
            parts.append(tda.decode_attend_dense_stats(
                q, shard["k"], shard["v"],
                (lengths + 1 - i * s_local).clamp(0, s_local), layer,
                **scales))
        ctx = tattn.merge_stats(*zip(*parts), q.device)
        return ctx[:, None].to(q.dtype), cache_l

    return {"decode": decode, "verify": spec, "sp": sp}[kind]


def _step(cfg, kind, quant, bblock=1):
    """(tokens, positions, fused callback, unfused callback, cache) of one
    forward of ``kind`` over a dense cache holding random earlier rows (sp:
    the cache split into 2 sequence shards)."""
    rng = np.random.default_rng(31)
    Bs, R, Sc = 4, 4, 48
    lengths = torch.tensor([5, 17, 30, 40], dtype=torch.int32)
    mesh = make_mesh(MeshConfig(sp=2), ["cpu"] * 2) if kind == "sp" else None
    if mesh is not None:
        cache = sharding.init_cache_sharded(cfg, Bs, Sc, torch.bfloat16, mesh,
                                            quant)
    else:
        cache = tkvc.init_cache(cfg, Bs, Sc, torch.bfloat16, "cpu", quant)
    for shard in cache if mesh is not None else [cache]:
        for name, t in shard.items():
            vals = torch.from_numpy(rng.standard_normal(t.shape).astype(
                np.float32))
            shard[name] = (vals * 40).round().clamp(-127, 127).to(torch.int8) \
                if t.dtype == torch.int8 else \
                (vals.abs() * 0.02 + 1e-3 if name in ("ks", "vs")
                 else vals.to(t.dtype))
    window = 0 if kind == "sp" else cfg.sliding_window
    tok = rng.integers(0, cfg.vocab_size, (Bs, R))
    if kind == "verify":
        tokens = tok
        positions = lengths.numpy()[:, None] + np.arange(R)
        fused = tattn.make_spec_attend_carry(lengths, window)
    else:
        tokens, positions = tok[:, :1], lengths.numpy()[:, None]
        fused = tattn.make_decode_attend_carry(lengths, window, bblock, mesh)
    plain = _unfused(kind, lengths, window, bblock, mesh)
    return (torch.from_numpy(np.asarray(tokens)),
            torch.from_numpy(np.asarray(positions)), fused, plain, cache)


def _model(cfg):
    gen = torch.Generator().manual_seed(3)
    return tl.DecoderLM(cfg, tl.init_params(cfg, gen, torch.bfloat16))


def _clone(cache):
    if isinstance(cache, list):
        return [_clone(shard) for shard in cache]
    return {n: t.clone() for n, t in cache.items()}


def _leaves(cache):
    shards = cache if isinstance(cache, list) else [cache]
    return [(f"{i} {n}", t) for i, sh in enumerate(shards)
            for n, t in sh.items()]


CALLBACKS = pytest.mark.parametrize("kind,bblock", [
    ("decode", 1), ("decode", 2), ("verify", 1), ("sp", 1)])


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("model", sorted(CFGS))
@CALLBACKS
def test_fused_dense_callbacks_forward_byte_identical(kind, bblock, model,
                                                      quant):
    """model_forward_carry through the fused dense callback against the
    unfused form: the same logits and cache, to the byte."""
    cfg = CFGS[model]
    tokens, positions, fused, plain, cache = _step(cfg, kind, quant, bblock)
    assert fused.fuses_qk_prep and not hasattr(plain, "fuses_qk_prep")
    lm = _model(cfg)
    cache_f, cache_p = _clone(cache), _clone(cache)
    logits_f, _ = lm.forward_carry(tokens, positions, cache_f, fused)
    logits_p, _ = lm.forward_carry(tokens, positions, cache_p, plain)
    assert torch.equal(logits_f, logits_p)
    assert torch.isfinite(logits_f.float()).all()
    for (name, got), (_, want), (_, old) in zip(
            _leaves(cache_f), _leaves(cache_p), _leaves(cache)):
        assert torch.equal(got, want), name
    assert any(not torch.equal(got, old) for (_, got), (_, old) in zip(
        _leaves(cache_f), _leaves(cache)))


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@CALLBACKS
def test_fused_dense_callbacks_decoder_block_byte_identical(kind, bblock,
                                                            quant):
    """One Qwen3 block through the fused dense callback against the
    unfused one: the same hidden state and cache, to the byte."""
    cfg = CFGS["qwen3"]
    tokens, positions, fused, plain, cache = _step(cfg, kind, quant, bblock)
    lm = _model(cfg)
    params, layers = lm._cached()
    x, cos, sin = tl._embed_inputs(params, cfg, tokens, positions)
    outs = []
    for attend in (fused, plain):
        c = _clone(cache)
        h, _ = tl.decoder_block(cfg, layers[1], x, cos, sin, attend, (c, 1))
        outs.append((h, c))
    (h_f, c_f), (h_p, c_p) = outs
    assert torch.equal(h_f, h_p)
    for (name, got), (_, want) in zip(_leaves(c_f), _leaves(c_p)):
        assert torch.equal(got, want), name


def test_sp_shard_rows_through_the_fused_write():
    """The sp callback's write of each shard is the fused write at the
    shard's local rows: the shard that owns a slot's row holds it, the
    other shard is untouched (one layer, int8 shards)."""
    cfg = CFGS["qwen3"]
    tokens, positions, fused, _, cache = _step(cfg, "sp", True)
    before = _clone(cache)
    lm = _model(cfg)
    lm.forward_carry(tokens, positions, cache, fused)
    s_local = cache[0]["k"].shape[3]
    lengths = positions[:, 0]
    for i, (shard, old) in enumerate(zip(cache, before)):
        changed = (shard["k"] != old["k"]).any(-1).any(2)    # [L, B, S]
        for b, n in enumerate(lengths.tolist()):
            own = 0 <= n - i * s_local < s_local
            rows = changed[0, b].nonzero().flatten().tolist()
            assert rows == ([n - i * s_local] if own else []), (i, b, rows)


def test_packed_prep_is_the_blocks_own():
    """The wrappers flatten the block's [B, R, D] tables to one row per
    packed row: the plain version equals ``prep_qk_plain`` on [B, R, H, D]
    rows, to the bit."""
    cfg = CFGS["qwen3"]
    q, k, v, rows, prep, cache = _inputs(cfg, "verify", False, seed=5)
    want_q, want_k = tl.prep_qk_plain(q, k, prep)
    c = {n: t.clone() for n, t in cache.items()}
    got_q = tda.prep_write_rows_dense(*c.values(), q, k, v, rows, 1, prep)
    assert torch.equal(got_q, want_q)
    ref = {n: t.clone() for n, t in cache.items()}
    tda.cache_write_rows_dense_plain(ref["k"], ref["v"], want_k, v, rows, 1)
    for name in cache:
        assert torch.equal(c[name], ref[name]), name
    flat = dataclasses.replace(prep, cos=prep.cos.reshape(-1, cfg.head_dim),
                               sin=prep.sin.reshape(-1, cfg.head_dim))
    fq, _ = tl.prep_qk_plain(q.reshape(-1, *q.shape[2:]),
                             k.reshape(-1, *k.shape[2:]), flat)
    assert torch.equal(fq.reshape(q.shape), got_q)
