"""Int8 KV in the port against the JAX package: the quantizer, the int8
pool and its prefill scatters, the quantizing row write (K3) and the
scale-folding paged attention (K1-int8).

``quantize_rows`` must give the bits of the JAX engine's compiled programs,
where XLA multiplies the row maximum by float32(1/127) instead of dividing
by 127 (the eager JAX function divides). So the JAX writers here run under
``jax.jit``, as the engine runs them. The K3 plain version is held
bit-identical to the Pallas kernel in interpret mode with rows on distinct
pages, and to the JAX engine's XLA row write with rows that share pages.
K1-int8's plain version is held to the Pallas kernel within 1e-5 at
float32 on live rows (both accumulate in float32 and differ in summation
order). The last test pins ROADMAP C6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aws_k8s_ansible_provisioner_tpu.config import tiny_qwen3 as jax_tiny
from aws_k8s_ansible_provisioner_tpu.ops import pallas_attention as pa
from aws_k8s_ansible_provisioner_tpu.serving import kv_cache as jkvc
from aws_k8s_ansible_provisioner_tpu.serving import paged_kv as jkv
from aws_k8s_ansible_provisioner_tpu_torch.config import ModelConfig
from aws_k8s_ansible_provisioner_tpu_torch.models.convert import from_jax_pool
from aws_k8s_ansible_provisioner_tpu_torch.ops import paged_attention as tpa
from aws_k8s_ansible_provisioner_tpu_torch.serving import kv_cache as tkvc
from aws_k8s_ansible_provisioner_tpu_torch.serving import paged_kv as tkv

torch.set_num_threads(2)

TOL = 1e-5
L, HKV, HQ, D, PS, MAXP = 2, 2, 4, 16, 8, 4
JCFG = jax_tiny()
TCFG = ModelConfig(**dataclasses.asdict(JCFG))


def _rows(shape, seed):
    """float32 rows with row maxima spread over six decades, some zero."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * 10.0 ** rng.uniform(-4, 2,
                                                         shape[:-1] + (1,))
    x = x.astype(np.float32)
    x.reshape(-1, shape[-1])[:3] = 0.0
    return x


def _int8_pool(B, seed, P=None):
    """Random int8 pools and positive scales; shuffled per-row tables."""
    rng = np.random.default_rng(seed)
    P = P or B * MAXP + 1
    shape = (L, P, HKV, PS, D)
    pool = {"k": rng.integers(-127, 128, shape).astype(np.int8),
            "v": rng.integers(-127, 128, shape).astype(np.int8),
            "ks": rng.uniform(1e-3, 0.1, shape[:-1]).astype(np.float32),
            "vs": rng.uniform(1e-3, 0.1, shape[:-1]).astype(np.float32)}
    table = (rng.permutation(P - 1)[:B * MAXP] + 1).reshape(B, MAXP) \
        .astype(np.int32)
    return rng, pool, table


def _assert_pool_equal(got: dict, ref: dict):
    assert sorted(got) == sorted(ref)
    for name in ref:
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(ref[name]),
                                      err_msg=name)


@pytest.mark.parametrize("form", ["jit", "eager"])
def test_quantize_rows_matches_the_jax_engine(form):
    """Bit-identical to the jitted quantizer (the engine's programs). The
    eager JAX function divides by 127 and so differs in the last bit of
    some scales; its int8 values agree on these rows."""
    x = _rows((4000, D), seed=1)
    q, s = tkvc.quantize_rows(torch.from_numpy(x))
    fn = jax.jit(jkvc.quantize_rows) if form == "jit" else jkvc.quantize_rows
    jq, js = (np.asarray(a) for a in fn(jnp.asarray(x)))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), jq)
    if form == "jit":
        np.testing.assert_array_equal(s.numpy().view(np.uint32),
                                      js.view(np.uint32))
    else:
        ulps = np.abs(s.numpy().view(np.int32).astype(np.int64)
                      - js.view(np.int32).astype(np.int64))
        assert ulps.max() == 1 and (ulps > 0).sum() > 0
    back = tkvc.dequantize(q, s)
    ref = jkvc.dequantize(jnp.asarray(q.numpy()), jnp.asarray(s.numpy()))
    np.testing.assert_array_equal(back.numpy(), np.asarray(ref))
    assert float((back - torch.from_numpy(x)).abs().max()) <= \
        float(s.max()) / 2 * 1.0001


def test_int8_pool_and_its_bytes_match_jax():
    ref = jkv.init_pool(JCFG, 13, PS, quant=True)
    got = tkv.init_pool(TCFG, 13, PS, device="cpu", quant=True)
    assert sorted(got) == sorted(ref) == ["k", "ks", "v", "vs"]
    for name in ref:
        assert tuple(got[name].shape) == ref[name].shape
        assert str(got[name].dtype).split(".")[-1] == str(ref[name].dtype)
        assert not got[name].any()
    for quant in (False, True):
        assert tkv.pool_bytes(TCFG, 13, PS, torch.bfloat16, quant) == \
            jkv.pool_bytes(JCFG, 13, PS, jnp.bfloat16, quant)
        assert tkvc.cache_bytes(TCFG, 3, 64, torch.float32, quant) == \
            jkvc.cache_bytes(JCFG, 3, 64, jnp.float32, quant)


def test_engine_allocates_the_int8_pool_and_refuses_unknown_kv_dtypes():
    from aws_k8s_ansible_provisioner_tpu_torch.config import (ServingConfig,
                                                              tiny_qwen3)
    from aws_k8s_ansible_provisioner_tpu_torch.models.layers import \
        init_params
    from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import Engine

    cfg = tiny_qwen3()
    params = init_params(cfg, torch.Generator().manual_seed(0), torch.float32)
    base = dict(max_decode_slots=2, max_cache_len=32, page_size=8,
                prefill_buckets=(8, 16), dtype="float32")
    eng = Engine(cfg, params, ServingConfig(kv_dtype="int8", **base),
                 device="cpu")
    assert sorted(eng.cache) == ["k", "ks", "v", "vs"]
    assert eng.cache["k"].dtype == torch.int8
    assert eng.allocator.num_pages == eng.cache["ks"].shape[1]
    for bad in ("fp8", "INT8", "bf16"):
        with pytest.raises(ValueError, match="kv_dtype"):
            Engine(cfg, params, ServingConfig(kv_dtype=bad, **base),
                   device="cpu")


def test_from_jax_pool_round_trips_every_leaf():
    _, pool, _ = _int8_pool(2, seed=2)
    got = from_jax_pool({n: jnp.asarray(a) for n, a in pool.items()})
    _assert_pool_equal(got, pool)
    assert got["k"].dtype == torch.int8 and got["ks"].dtype == torch.float32


@pytest.mark.parametrize("layer", [0, 1])
def test_quantized_prompt_scatter_matches_jitted_jax(layer):
    """Batched prompt write into the int8 pool: quantized rows and their
    scales at the same (page, head, offset); an OOB_PAGE padding row drops.
    The scratch page takes padding rows of two prompts at one offset, so it
    is left out of the comparison."""
    _, pool, _ = _int8_pool(3, seed=3, P=13)
    tables = np.zeros((3, MAXP), np.int32)
    tables[0, :2] = [5, 2]
    tables[1, :1] = [9]
    tables[2, :] = tkv.OOB_PAGE
    k, v = _rows((3, 16, HKV, D), seed=4), _rows((3, 16, HKV, D), seed=5)
    ref = jax.jit(jkv.write_prompts_paged_layer, static_argnums=(5,))(
        {n: jnp.asarray(a) for n, a in pool.items()}, layer,
        jnp.asarray(tables), jnp.asarray(k), jnp.asarray(v), PS)
    got = tkv.write_prompts_paged_layer(
        from_jax_pool(pool), layer, torch.from_numpy(tables),
        torch.from_numpy(k), torch.from_numpy(v), PS)
    for name in ref:
        np.testing.assert_array_equal(got[name].numpy()[:, 1:],
                                      np.asarray(ref[name])[:, 1:])
    q8, scale = tkvc.quantize_rows(torch.from_numpy(k[0, 11]))
    assert torch.equal(got["k"][layer, 2, :, 3], q8)
    assert torch.equal(got["ks"][layer, 2, :, 3], scale)


@pytest.mark.parametrize("start", [0, 5, 27])
def test_quantized_chunk_scatter_matches_jitted_jax(start):
    _, pool, _ = _int8_pool(3, seed=6, P=13)
    pages = np.array([4, 11, 7, 1], np.int32)
    k, v = _rows((1, 8, HKV, D), seed=7), _rows((1, 8, HKV, D), seed=8)
    ref = jax.jit(jkv.write_chunk_paged_layer, static_argnums=(6,))(
        {n: jnp.asarray(a) for n, a in pool.items()}, 1, jnp.asarray(pages),
        start, jnp.asarray(k), jnp.asarray(v), PS)
    got = tkv.write_chunk_paged_layer(
        from_jax_pool(pool), 1, torch.from_numpy(pages), start,
        torch.from_numpy(k), torch.from_numpy(v), PS)
    _assert_pool_equal(got, ref)


def test_gather_layer_dense_carries_the_scales():
    _, pool, table = _int8_pool(2, seed=9)
    ref = jkv.gather_layer_dense({n: jnp.asarray(a) for n, a in pool.items()},
                                 1, jnp.asarray(table))
    got = tkv.gather_layer_dense(from_jax_pool(pool), 1,
                                 torch.from_numpy(table))
    _assert_pool_equal(got, ref)
    assert tuple(got["ks"].shape) == (2, HKV, MAXP * PS)


# -- K3: the quantizing row write -------------------------------------------


def _port_quant_write(fn, pool, k_new, v_new, rows, table, layer):
    p = from_jax_pool(pool)
    fn(p["k"], p["v"], p["ks"], p["vs"], torch.from_numpy(k_new),
       torch.from_numpy(v_new), torch.from_numpy(rows), layer,
       torch.from_numpy(table))
    return p


@pytest.mark.parametrize("layer", [0, 1])
def test_quant_row_write_bit_identical_to_pallas_on_distinct_pages(layer):
    """One row per slot, each on a page of its own: page starts and ends,
    mid-page rows, a dropped row (-1) and one past the window."""
    N = 6
    _, pool, table = _int8_pool(N, seed=10 + layer)
    rows = np.array([0, 7, 12, MAXP * PS - 1, -1, MAXP * PS], np.int32)
    k_new, v_new = _rows((N, HKV, D), seed=12), _rows((N, HKV, D), seed=13)
    args = (jnp.asarray(rows), jnp.asarray(table), jnp.int32(layer))
    ck, ks = pa.cache_write_row_quant_paged(
        jnp.asarray(pool["k"]), jnp.asarray(pool["ks"]), jnp.asarray(k_new),
        *args, interpret=True)
    cv, vs = pa.cache_write_row_quant_paged(
        jnp.asarray(pool["v"]), jnp.asarray(pool["vs"]), jnp.asarray(v_new),
        *args, interpret=True)
    ref = {"k": ck, "v": cv, "ks": ks, "vs": vs}
    for fn in (tpa.cache_write_rows_quant_paged_plain,
               tpa.cache_write_rows_quant_paged):
        got = _port_quant_write(fn, pool, k_new, v_new, rows, table, layer)
        _assert_pool_equal(got, ref)
    assert not np.array_equal(np.asarray(ks), pool["ks"])


def _xla_row_write(pool, k_new, v_new, rows, table, layer):
    """The JAX engine's CPU row write: paged_kv.write_token_layer_paged in a
    compiled program."""
    fn = jax.jit(jkv.write_token_layer_paged, static_argnums=(6,))
    return fn({n: jnp.asarray(a) for n, a in pool.items()}, jnp.int32(layer),
              jnp.asarray(rows), jnp.asarray(table),
              jnp.asarray(k_new)[:, None], jnp.asarray(v_new)[:, None], PS)


def test_quant_row_write_bit_identical_to_xla_with_shared_pages():
    """Decode rows of slots whose tables share pages (rows at different
    offsets of one page) all land, with their scales."""
    N = 5
    _, pool, table = _int8_pool(N, seed=14)
    table[1:3] = table[0]
    rows = np.array([3, 4, 9, 20, 30], np.int32)
    k_new, v_new = _rows((N, HKV, D), seed=15), _rows((N, HKV, D), seed=16)
    ref = _xla_row_write(pool, k_new, v_new, rows, table, 0)
    got = _port_quant_write(tpa.cache_write_rows_quant_paged, pool, k_new,
                            v_new, rows, table, 0)
    _assert_pool_equal(got, ref)


def test_quant_row_write_mixed_step_layout_bit_identical_to_xla():
    """mixed_step's packed rows: B decode rows (the chunking slot's own row
    is the dead passenger, -1), then C chunk rows of that slot across a page
    boundary, several in each page."""
    B, C, pslot, pstart = 4, 10, 1, 5
    _, pool, table = _int8_pool(B + C, seed=17)
    lengths = np.array([3, 0, 9, 20], np.int32)
    rows = np.concatenate([lengths, pstart + np.arange(C)]).astype(np.int32)
    rows[pslot] = -1
    tables = np.concatenate([table[:B], np.repeat(table[pslot][None], C, 0)])
    k_new = _rows((B + C, HKV, D), seed=18)
    v_new = _rows((B + C, HKV, D), seed=19)
    ref = _xla_row_write(pool, k_new, v_new, rows, tables, 1)
    for fn in (tpa.cache_write_rows_quant_paged_plain,
               tpa.cache_write_rows_quant_paged):
        got = _port_quant_write(fn, pool, k_new, v_new, rows, tables, 1)
        _assert_pool_equal(got, ref)
    q8, scale = tkvc.quantize_rows(torch.from_numpy(k_new[B]))
    assert torch.equal(got["k"][1, tables[B, 0], :, pstart], q8)
    assert torch.equal(got["ks"][1, tables[B, 0], :, pstart], scale)


def test_cpu_quant_wrappers_count_no_launch():
    _, pool, table = _int8_pool(2, seed=20)
    before = tpa.launch_counts()
    _port_quant_write(tpa.cache_write_rows_quant_paged, pool,
                      _rows((2, HKV, D), 21), _rows((2, HKV, D), 22),
                      np.array([1, 2], np.int32), table, 0)
    p = from_jax_pool(pool)
    tpa.paged_attention_quant(torch.zeros(2, HQ, D), p["k"], p["v"], p["ks"],
                              p["vs"], torch.tensor([3, 9], dtype=torch.int32),
                              0, torch.from_numpy(table))
    assert tpa.launch_counts() == before


def test_pallas_quant_write_keeps_one_scale_per_page_in_interpret_mode():
    """ROADMAP C6 (reference, interpret mode): the Pallas K3's scale block
    spans a whole page, and each grid step reads it as it was before the
    call, so of two rows in one page (here in different 32-row blocks of a
    64-row page, whose int8 rows both land) only the last row's scale
    lands. The port, like the JAX engine's XLA path, keeps both."""
    ps = 64
    rng = np.random.default_rng(23)
    shape = (1, 3, HKV, ps, D)
    pool = {"k": np.zeros(shape, np.int8), "v": np.zeros(shape, np.int8),
            "ks": np.zeros(shape[:-1], np.float32),
            "vs": np.zeros(shape[:-1], np.float32)}
    table = np.array([[2], [2]], np.int32)
    rows = np.array([3, 40], np.int32)
    k_new = rng.standard_normal((2, HKV, D)).astype(np.float32)
    ck, ks = pa.cache_write_row_quant_paged(
        jnp.asarray(pool["k"]), jnp.asarray(pool["ks"]), jnp.asarray(k_new),
        jnp.asarray(rows), jnp.asarray(table), jnp.int32(0), interpret=True)
    q8, scale = tkvc.quantize_rows(torch.from_numpy(k_new))
    ck, ks = np.asarray(ck), np.asarray(ks)
    np.testing.assert_array_equal(ck[0, 2, :, 3], q8[0].numpy())
    np.testing.assert_array_equal(ck[0, 2, :, 40], q8[1].numpy())
    np.testing.assert_array_equal(ks[0, 2, :, 40], scale[1].numpy())
    assert not ks[0, 2, :, 3].any()               # row 3's scale was lost
    got = from_jax_pool(pool)
    tpa.cache_write_rows_quant_paged(
        got["k"], got["v"], got["ks"], got["vs"], torch.from_numpy(k_new),
        torch.from_numpy(k_new), torch.from_numpy(rows), 0,
        torch.from_numpy(table))
    assert torch.equal(got["ks"][0, 2, :, 3], scale[0])
    assert torch.equal(got["ks"][0, 2, :, 40], scale[1])


# -- K1-int8: the scale-folding paged attention -----------------------------


def _jpool(pool):
    return [jnp.asarray(pool[n]) for n in ("k", "v", "ks", "vs")]


def _port_attend(fn, q, pool, limits, table, layer):
    p = from_jax_pool(pool)
    return fn(torch.from_numpy(q), p["k"], p["v"], torch.from_numpy(limits),
              layer, torch.from_numpy(table), pool_ks=p["ks"],
              pool_vs=p["vs"]).numpy()


@pytest.mark.parametrize("layer", [0, 1])
def test_quant_decode_attention_matches_pallas(layer):
    """Ragged lengths over several pages, one-row and full-window rows,
    garbage table entries past each row's live range."""
    B = 6
    rng, pool, table = _int8_pool(B, seed=30 + layer)
    lengths = np.array([1, 8, 9, 17, 32, 25], np.int32)
    for n, lim in enumerate(lengths):
        live = -(-int(lim) // PS)
        table[n, live:] = rng.integers(0, B * MAXP + 1, MAXP - live)
    q = rng.standard_normal((B, 1, HQ, D)).astype(np.float32)
    k, v, ks, vs = _jpool(pool)
    ref = pa.decode_attend_pallas_paged(
        jnp.asarray(q), k, v, jnp.asarray(lengths), jnp.int32(layer),
        jnp.asarray(table), interpret=True, pool_ks=ks, pool_vs=vs)
    got = _port_attend(tpa.decode_attend_paged, q, pool, lengths, table,
                       layer)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=TOL)


def test_quant_ragged_attention_matches_pallas_on_live_rows():
    """Decode rows of five slots (one the dead passenger, limit 0), then
    eight chunk rows of one slot sharing its table."""
    B, C, pslot, pstart = 5, 8, 2, 13
    rng, pool, table = _int8_pool(B, seed=40)
    lengths = np.array([4, 30, 0, 11, 16], np.int32)
    limits = np.concatenate([lengths, pstart + np.arange(C) + 1]) \
        .astype(np.int32)
    tables = np.concatenate([table, np.repeat(table[pslot][None], C, 0)])
    q = rng.standard_normal((B + C, HQ, D)).astype(np.float32)
    k, v, ks, vs = _jpool(pool)
    ref = np.asarray(pa.ragged_attend_pallas_paged(
        jnp.asarray(q), k, v, jnp.asarray(limits), jnp.int32(1),
        jnp.asarray(tables), interpret=True, pool_ks=ks, pool_vs=vs))
    got = _port_attend(tpa.ragged_attend_paged, q, pool, limits, tables, 1)
    live = limits > 0
    np.testing.assert_allclose(got[live], ref[live], rtol=0, atol=TOL)
    assert np.all(np.isfinite(got))


def test_quant_attention_equals_attention_over_the_dequantized_pool():
    """Folding the scales is attention over K*ks and V*vs: the plain int8
    form against the float32 form on the dequantized pool."""
    B = 4
    rng, pool, table = _int8_pool(B, seed=50)
    lengths = np.array([3, 9, 16, 30], np.int32)
    q = torch.from_numpy(rng.standard_normal((B, HQ, D)).astype(np.float32))
    p = from_jax_pool(pool)
    lim, tab = torch.from_numpy(lengths), torch.from_numpy(table)
    folded = tpa.paged_attention_plain(q, p["k"], p["v"], lim, 0, tab,
                                       p["ks"], p["vs"])
    dense = tpa.paged_attention_plain(
        q, tkvc.dequantize(p["k"], p["ks"]), tkvc.dequantize(p["v"], p["vs"]),
        lim, 0, tab)
    np.testing.assert_allclose(folded.numpy(), dense.numpy(), rtol=0,
                               atol=TOL)
