"""The fused q/k prologue and paged row write (K2 and K3 with the q/k
RMSNorm and RoPE fused in) against the JAX package.

``prep_write_rows_paged`` and ``prep_write_rows_quant_paged`` take a
layer's raw q, k and v rows; their plain versions (what the CUDA kernel is
held to on the card) and the CPU path of their wrappers are compared with
the JAX composition they replace: ``models/layers.py``'s ``rms_norm`` (Qwen3
only) and ``apply_rope`` of q and k, then ``cache_write_row_paged`` or
``cache_write_row_quant_paged`` in Pallas interpret mode for K and for V,
on the same numpy-seeded bf16 inputs and the same float32 RoPE tables. The
decode, verify (B * R rows) and mixed-step row layouts are covered, with
dropped rows (-1, past the window, OOB_PAGE tables). The Pallas kernels
run one packed row per call in packed order: in interpret mode each grid
step reads its 8-row (int8: 32-row) block, and its scale page, as it was
before the call, so rows of one call that share a block keep only the last
(ROADMAP C4, C6), where the JAX engine's path and the port keep every row.
The prepped q, the pools and the scales must be bit-identical. Besides
tiny_qwen3 and tiny_mistral the cases take the other families' head dims
and rotary widths: D 80 with RoPE over 32 columns (Phi-2), no RoPE (OPT),
D 256 (Gemma) and Llama's llama3 tables.

Then the serving callbacks: ``decoder_block`` and ``model_forward_carry``
through the fused decode, verify and mixed callbacks give the bytes of the
same forward through the unfused form (the prologue in the block, then the
standalone K2 or K3 and the same attention), over bf16 and int8 pools.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aws_k8s_ansible_provisioner_tpu.models import layers as jl
from aws_k8s_ansible_provisioner_tpu.ops import pallas_attention as pa
from aws_k8s_ansible_provisioner_tpu_torch.config import (tiny_gemma,
                                                          tiny_llama,
                                                          tiny_mistral,
                                                          tiny_opt, tiny_phi,
                                                          tiny_qwen3)
from aws_k8s_ansible_provisioner_tpu_torch.models import layers as tl
from aws_k8s_ansible_provisioner_tpu_torch.ops import attention as tattn
from aws_k8s_ansible_provisioner_tpu_torch.ops import paged_attention as tpa
from aws_k8s_ansible_provisioner_tpu_torch.serving import paged_kv as tkv
from aws_k8s_ansible_provisioner_tpu_torch.serving.paged_kv import OOB_PAGE

torch.set_num_threads(2)

L, PS, MAXP = 2, 8, 4
# Qwen3 (q/k norm) and Mistral at D 16, and the other families' head dims
# and rotary widths: Phi-2's RoPE over 32 of 80 columns, OPT's none, Gemma's
# D 256, Llama's llama3 frequencies
CFGS = {"qwen3": tiny_qwen3(), "mistral": tiny_mistral(),
        "phi_d80_r32": tiny_phi(head_dim=80, rotary_pct=0.4),
        "opt_r0": tiny_opt(), "gemma_d256": tiny_gemma(head_dim=256),
        "llama": tiny_llama()}


def _layout(kind, rng):
    """(rows [N], tables [N, MAXP], positions [N]) of a row layout; each
    slot's table holds pages of its own, shuffled.

    decode: one row per slot at page starts, ends and mid-page, a dead row
    (-1, OOB_PAGE table) and a row past the window; verify: 3 slots of 4
    rows, one crossing a page edge and one running past the window; mixed:
    4 decode rows (slot 1 is the dead passenger, -1 at position 0) then 6
    chunk rows of slot 1 across a page edge on slot 1's table."""
    table = (rng.permutation(8 * MAXP) + 1).reshape(8, MAXP)
    if kind == "decode":
        rows = np.array([0, 7, 8, 13, -1, MAXP * PS, MAXP * PS - 1])
        tables = table[:len(rows)].copy()
        tables[4] = OOB_PAGE
        tables[5] = OOB_PAGE
        positions = np.maximum(rows, 0)
    elif kind == "verify":
        R = 4
        lengths = np.array([5, 17, MAXP * PS - 2])
        rows = (lengths[:, None] + np.arange(R)).reshape(-1)
        tables = np.repeat(table[:3], R, axis=0)
        positions = rows
    else:
        B, C, pslot, pstart = 4, 6, 1, 13
        lengths = np.array([3, 0, 9, 20])
        rows = np.concatenate([lengths, pstart + np.arange(C)])
        rows[pslot] = -1
        tables = np.concatenate([table[:B],
                                 np.repeat(table[pslot][None], C, 0)])
        positions = np.concatenate([np.where(np.arange(B) == pslot, 0,
                                             lengths), pstart + np.arange(C)])
    return rows.astype(np.int32), tables.astype(np.int32), positions


def _inputs(cfg, kind, quant, seed):
    """Numpy-seeded bf16 q/k/v rows, norm weights (Qwen3), the float32
    RoPE tables of the rows' positions, and a random pool."""
    rng = np.random.default_rng(seed)
    rows, tables, positions = _layout(kind, rng)
    N, D = len(rows), cfg.head_dim

    def bf16(shape, scale=1.0):
        return torch.from_numpy(
            (scale * rng.standard_normal(shape)).astype(np.float32)).bfloat16()

    q = bf16((N, cfg.num_heads, D), 3.0)
    k, v = bf16((N, cfg.num_kv_heads, D), 3.0), bf16((N, cfg.num_kv_heads, D))
    norms = ((1.0 + 0.1 * bf16((D,)).float()).bfloat16(),
             (1.0 + 0.1 * bf16((D,)).float()).bfloat16()) \
        if cfg.qk_norm else (None, None)
    cos, sin = tl.rope_cos_sin(torch.from_numpy(positions), cfg.rotary_dim,
                               cfg.rope_theta, cfg)
    prep = tl.QKPrep(*norms, cfg.norm_eps, cos, sin)
    P = int(tables[tables != OOB_PAGE].max()) + 2
    shape = (L, P, cfg.num_kv_heads, PS, D)
    if quant:
        pool = {"k": torch.from_numpy(rng.integers(-127, 128, shape)
                                      .astype(np.int8)),
                "v": torch.from_numpy(rng.integers(-127, 128, shape)
                                      .astype(np.int8)),
                "ks": torch.from_numpy(rng.uniform(1e-3, 0.1, shape[:-1])
                                       .astype(np.float32)),
                "vs": torch.from_numpy(rng.uniform(1e-3, 0.1, shape[:-1])
                                       .astype(np.float32))}
    else:
        pool = {"k": bf16(shape), "v": bf16(shape)}
    return q, k, v, torch.from_numpy(rows), torch.from_numpy(tables), prep, \
        pool


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


def _jax_prep_write(q, k, v, rows, tables, prep, pool, layer):
    """The JAX composition: rms_norm (when the prep has weights) and
    apply_rope of q and k, then the Pallas row write (interpret mode) of K
    and of V, one packed row per call in packed order."""
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
    out = {n: _j(t) for n, t in pool.items()}
    for n in range(len(rows)):
        args = (jnp.asarray(rows.numpy()[n:n + 1]),
                jnp.asarray(tables.numpy()[n:n + 1]), jnp.int32(layer))
        for name, new in (("k", jk), ("v", jv)):
            if "ks" in out:
                out[name], out[name + "s"] = pa.cache_write_row_quant_paged(
                    out[name], out[name + "s"], new[n:n + 1], *args,
                    interpret=True)
            else:
                out[name] = pa.cache_write_row_paged(
                    out[name], new[n:n + 1], *args, interpret=True)
    return _t(jq), {n: _t(a) for n, a in out.items()}


def _port(fn, q, k, v, rows, tables, prep, pool, layer):
    got = {n: t.clone() for n, t in pool.items()}
    qp = fn(*got.values(), q, k, v, rows, layer, tables, prep)
    return qp, got


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("model", sorted(CFGS))
@pytest.mark.parametrize("kind", ["decode", "verify", "mixed"])
def test_fused_write_bit_identical_to_jax(kind, model, quant):
    """The plain versions and the CPU wrappers: q, every pool leaf and
    scale bit-identical to JAX's prologue and Pallas writes."""
    cfg = CFGS[model]
    q, k, v, rows, tables, prep, pool = _inputs(cfg, kind, quant,
                                                seed=len(kind) + quant)
    layer = 1
    ref_q, ref = _jax_prep_write(q, k, v, rows, tables, prep, pool, layer)
    fns = ((tpa.prep_write_rows_quant_paged_plain,
            tpa.prep_write_rows_quant_paged) if quant
           else (tpa.prep_write_rows_paged_plain, tpa.prep_write_rows_paged))
    for fn in fns:
        got_q, got = _port(fn, q, k, v, rows, tables, prep, pool, layer)
        assert got_q.dtype == q.dtype and torch.equal(got_q, ref_q)
        for name in pool:
            assert torch.equal(got[name], ref[name]), name
    # kept rows landed, dropped rows did not touch the pool
    kept = int(((rows >= 0) & (rows < MAXP * PS)).sum())
    changed = (ref["v"] != pool["v"]).any(dim=(2, 4)).sum()
    assert 0 < int(changed) <= kept
    assert torch.equal(ref["k"][0], pool["k"][0])       # other layer intact


@pytest.mark.parametrize("model", sorted(CFGS))
def test_prologue_is_the_blocks_own(model):
    """``prep_qk_plain`` is the composition decoder_block applied before the
    fusion: rms_norm (Qwen3) then apply_rope, on [B, T, H, D] as on packed
    [N, H, D] rows with their tables flattened, to the bit."""
    cfg = CFGS[model]
    q, k, _, _, _, prep, _ = _inputs(cfg, "verify", False, seed=7)
    B, R = 3, 4
    want_q, want_k = q, k
    if cfg.qk_norm:
        want_q = tl.rms_norm(q, prep.q_norm, cfg.norm_eps)
        want_k = tl.rms_norm(k, prep.k_norm, cfg.norm_eps)
    want_q = tl.apply_rope(want_q, prep.cos, prep.sin)
    want_k = tl.apply_rope(want_k, prep.cos, prep.sin)
    got_q, got_k = tl.prep_qk_plain(q, k, prep)
    assert torch.equal(got_q, want_q) and torch.equal(got_k, want_k)
    batched = dataclasses.replace(prep, cos=prep.cos.reshape(B, R, -1),
                                  sin=prep.sin.reshape(B, R, -1))
    bq, bk = tl.prep_qk_plain(q.reshape(B, R, *q.shape[1:]),
                              k.reshape(B, R, *k.shape[1:]), batched)
    assert torch.equal(bq.reshape(q.shape), got_q)
    assert torch.equal(bk.reshape(k.shape), got_k)


def test_cpu_wrappers_count_no_launch_and_other_devices_raise():
    cfg = CFGS["qwen3"]
    q, k, v, rows, tables, prep, pool = _inputs(cfg, "decode", False, seed=9)
    before = tpa.launch_counts()
    tpa.prep_write_rows_paged(*pool.values(), q, k, v, rows, 0, tables, prep)
    assert tpa.launch_counts() == before
    meta = {n: t.to("meta") for n, t in pool.items()}
    with pytest.raises(ValueError, match="unsupported device"):
        tpa.prep_write_rows_paged(*meta.values(), q.to("meta"), k.to("meta"),
                                  v.to("meta"), rows, 0, tables, prep)


# -- the serving callbacks ---------------------------------------------------


def _unfused(kind, lengths, table, window, extra):
    """The callbacks as they were before the fusion: q/k prepped by the
    block, the standalone row write (K2, or K3 into an int8 pool), then the
    same attention entry."""

    def write(pool, k, v, rows, layer, tables):
        if "ks" in pool:
            tpa.cache_write_rows_quant_paged(*pool.values(), k, v, rows,
                                             layer, tables)
            return {"pool_ks": pool["ks"], "pool_vs": pool["vs"]}
        tpa.cache_write_rows_paged(pool["k"], pool["v"], k, v, rows, layer,
                                   tables)
        return {}

    def decode(q, k, v, cache_l):
        pool, layer = cache_l
        scales = write(pool, k[:, 0].contiguous(), v[:, 0].contiguous(),
                       lengths, layer, table)
        return tpa.decode_attend_paged(q, pool["k"], pool["v"], lengths + 1,
                                       layer, table, **scales,
                                       window=window), cache_l

    def spec(q, k, v, cache_l):
        pool, layer = cache_l
        B, R = k.shape[:2]
        rows = (lengths[:, None] + torch.arange(R, dtype=torch.int32)
                ).reshape(B * R)
        scales = write(pool, k.reshape(B * R, *k.shape[2:]),
                       v.reshape(B * R, *v.shape[2:]), rows, layer,
                       table.repeat_interleave(R, dim=0))
        return tpa.decode_attend_spec_paged(q, pool["k"], pool["v"], lengths,
                                            layer, table, **scales,
                                            window=window), cache_l

    def mixed(q, k, v, cache_l):
        pool, layer = cache_l
        write_rows, limits, chunk_start = extra
        scales = write(pool, k[0].contiguous(), v[0].contiguous(),
                       write_rows, layer, table)
        ctx = tpa.ragged_attend_paged(q[0], pool["k"], pool["v"], limits,
                                      layer, table, **scales, window=window,
                                      chunk_start=chunk_start)
        return ctx[None], cache_l

    return {"decode": decode, "verify": spec, "mixed": mixed}[kind]


def _step(cfg, kind, quant):
    """(tokens, positions, fused callback, unfused callback, pool) of one
    forward of ``kind`` over a pool holding random earlier rows."""
    rng = np.random.default_rng(31)
    B, R = 3, 4
    maxp, ps = 6, 8
    table = torch.from_numpy((rng.permutation(B * maxp) + 1)
                             .reshape(B, maxp).astype(np.int32))
    lengths = torch.tensor([5, 17, 30], dtype=torch.int32)
    pool = tkv.init_pool(cfg, B * maxp + 1, ps, torch.bfloat16, "cpu", quant)
    for name, t in pool.items():
        vals = torch.from_numpy(rng.standard_normal(t.shape).astype(
            np.float32))
        pool[name] = (vals * 40).round().clamp(-127, 127).to(torch.int8) \
            if t.dtype == torch.int8 else \
            (vals.abs() * 0.02 + 1e-3 if name in ("ks", "vs")
             else vals.to(t.dtype))
    window = cfg.sliding_window
    tok = rng.integers(0, cfg.vocab_size, (B, R))
    if kind == "decode":
        tokens, positions = tok[:, :1], lengths.numpy()[:, None]
        fused = tattn.make_decode_attend_carry_paged(lengths, table, window)
        plain = _unfused(kind, lengths, table, window, None)
    elif kind == "verify":
        tokens = tok
        positions = lengths.numpy()[:, None] + np.arange(R)
        fused = tattn.make_spec_attend_carry_paged(lengths, table, window)
        plain = _unfused(kind, lengths, table, window, None)
    else:
        C, pslot, pstart = 6, 1, 13
        write_rows = torch.cat([torch.tensor([5, -1, 30], dtype=torch.int32),
                                pstart + torch.arange(C, dtype=torch.int32)])
        limits = torch.cat([torch.tensor([6, 0, 31], dtype=torch.int32),
                            pstart + 1 + torch.arange(C, dtype=torch.int32)])
        tables = torch.cat([table, table[pslot][None].expand(C, -1)]) \
            .contiguous()
        tokens = np.concatenate([tok[:, 0], tok.reshape(-1)[:C]])[None]
        positions = np.concatenate([[5, 0, 30], pstart + np.arange(C)])[None]
        fused = tattn.make_mixed_attend_carry_paged(write_rows, limits,
                                                    tables, window,
                                                    chunk_start=B)
        plain = _unfused(kind, None, tables, window,
                         (write_rows, limits, B))
    return (torch.from_numpy(np.asarray(tokens)),
            torch.from_numpy(np.asarray(positions)), fused, plain, pool)


def _model(cfg):
    gen = torch.Generator().manual_seed(3)
    return tl.DecoderLM(cfg, tl.init_params(cfg, gen, torch.bfloat16))


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("model", sorted(CFGS))
@pytest.mark.parametrize("kind", ["decode", "verify", "mixed"])
def test_fused_callbacks_forward_byte_identical(kind, model, quant):
    """model_forward_carry through the fused callback against the unfused
    form: the same logits and pool, to the byte."""
    cfg = CFGS[model]
    tokens, positions, fused, plain, pool = _step(cfg, kind, quant)
    assert fused.fuses_qk_prep and not hasattr(plain, "fuses_qk_prep")
    lm = _model(cfg)
    pool_f = {n: t.clone() for n, t in pool.items()}
    pool_p = {n: t.clone() for n, t in pool.items()}
    logits_f, _ = lm.forward_carry(tokens, positions, pool_f, fused)
    logits_p, _ = lm.forward_carry(tokens, positions, pool_p, plain)
    assert torch.equal(logits_f, logits_p)
    assert torch.isfinite(logits_f.float()).all()
    for name in pool:
        assert torch.equal(pool_f[name], pool_p[name]), name
        assert not torch.equal(pool_f[name], pool[name]), name


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("kind", ["decode", "verify", "mixed"])
def test_fused_callbacks_decoder_block_byte_identical(kind, quant):
    """One Qwen3 block through the fused callback against the unfused one:
    the same hidden state and pool, to the byte."""
    cfg = CFGS["qwen3"]
    tokens, positions, fused, plain, pool = _step(cfg, kind, quant)
    lm = _model(cfg)
    params, layers = lm._cached()
    x, cos, sin = tl._embed_inputs(params, cfg, tokens, positions)
    outs = []
    for attend in (fused, plain):
        p = {n: t.clone() for n, t in pool.items()}
        h, _ = tl.decoder_block(cfg, layers[1], x, cos, sin, attend, (p, 1))
        outs.append((h, p))
    (h_f, p_f), (h_p, p_p) = outs
    assert torch.equal(h_f, h_p)
    for name in pool:
        assert torch.equal(p_f[name], p_p[name]), name


def test_only_the_paged_serving_callbacks_fuse():
    """The row-write callbacks fuse: the paged decode, verify and mixed
    ones and the dense decode, verify and sequence-parallel decode. The
    batched prefills, the dense chunk prefill and the default keep the
    unfused form (the block preps q and k for them)."""
    from aws_k8s_ansible_provisioner_tpu_torch.config import MeshConfig
    from aws_k8s_ansible_provisioner_tpu_torch.parallel.mesh import make_mesh

    lengths = torch.tensor([3, 4], dtype=torch.int32)
    table = torch.ones((2, 3), dtype=torch.int32)
    mesh = make_mesh(MeshConfig(sp=2), ["cpu"] * 2)
    unfused = (tattn.make_prefill_attend_batch(lengths, lengths),
               tattn.make_prefill_attend_batch_paged_carry(table, lengths),
               tattn.make_chunk_prefill_attend(0, 0),
               tl.make_default_attend(CFGS["qwen3"]))
    assert not any(getattr(a, "fuses_qk_prep", False) for a in unfused)
    fused = (tattn.make_decode_attend_carry_paged(lengths, table),
             tattn.make_spec_attend_carry_paged(lengths, table),
             tattn.make_mixed_attend_carry_paged(lengths, lengths, table),
             tattn.make_decode_attend_carry(lengths),
             tattn.make_decode_attend_carry(lengths, bblock=2),
             tattn.make_decode_attend_carry(lengths, mesh=mesh),
             tattn.make_spec_attend_carry(lengths))
    assert all(a.fuses_qk_prep for a in fused)
