"""The port's paged-attention contract against the JAX Pallas kernel.

``paged_attention_plain`` (the plain version the CUDA kernel is held to on
the card) and the CPU path of its wrappers are compared with
``decode_attend_pallas_paged`` / ``ragged_attend_pallas_paged`` run in
Pallas interpret mode, on the same numpy-seeded float32 inputs. Tolerance:
max abs 1e-5 — both sides accumulate in float32 and differ only in
summation order (the Pallas body folds pages one at a time with an online
softmax; the plain version takes one softmax over the gathered row).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aws_k8s_ansible_provisioner_tpu.ops import pallas_attention as pa
from aws_k8s_ansible_provisioner_tpu_torch.ops import paged_attention as tpa

torch.set_num_threads(2)

TOL = 1e-5
L, HKV, HQ, D, PS, MAXP = 2, 2, 4, 16, 8, 4


def _layout(B, seed):
    """Pool with a shuffled physical page order (page 0 = scratch, unused
    by any live range) and per-row tables; entries past each row's live
    range are garbage (random valid ids, scratch included)."""
    rng = np.random.default_rng(seed)
    P = B * MAXP + 1
    pool_k = rng.standard_normal((L, P, HKV, PS, D)).astype(np.float32)
    pool_v = rng.standard_normal((L, P, HKV, PS, D)).astype(np.float32)
    table = (rng.permutation(B * MAXP) + 1).reshape(B, MAXP).astype(np.int32)
    return rng, pool_k, pool_v, table


def _garbage_past_live(rng, table, limits):
    out = table.copy()
    P = table.size + 1
    for n, lim in enumerate(limits):
        live = max(-(-int(lim) // PS), 1)
        out[n, live:] = rng.integers(0, P, MAXP - live)
    return out


def _port(fn, *arrays, layer):
    q, pk, pv, lim, tab = (torch.from_numpy(np.ascontiguousarray(a))
                           for a in arrays)
    return fn(q, pk, pv, lim, layer, tab).numpy()


@pytest.mark.parametrize("layer", [0, 1])
def test_decode_matches_pallas(layer):
    """Ragged lengths spanning several pages, one-row and full-window
    rows, shuffled pages, garbage past the live range."""
    B = 6
    rng, pk, pv, table = _layout(B, seed=10 + layer)
    lengths = np.array([1, 8, 9, 17, 32, 25], np.int32)
    table = _garbage_past_live(rng, table, lengths)
    q = rng.standard_normal((B, 1, HQ, D)).astype(np.float32)
    ref = pa.decode_attend_pallas_paged(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(lengths), jnp.int32(layer), jnp.asarray(table),
        interpret=True)
    got = _port(tpa.decode_attend_paged, q, pk, pv, lengths, table,
                layer=layer)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=TOL)


def test_ragged_chunk_rows_share_one_table():
    """Decode rows of five slots, then eight chunk rows of one slot with
    increasing limits (plain causality over that slot's table)."""
    B, C, pslot, pstart = 5, 8, 2, 13
    rng, pk, pv, table = _layout(B, seed=21)
    lengths = np.array([4, 30, 0, 11, 16], np.int32)
    limits = np.concatenate([lengths, pstart + np.arange(C) + 1]) \
        .astype(np.int32)
    tables = np.concatenate([table, np.repeat(table[pslot][None], C, 0)])
    tables = _garbage_past_live(rng, tables, limits)
    q = rng.standard_normal((B + C, HQ, D)).astype(np.float32)
    ref = pa.ragged_attend_pallas_paged(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(limits), jnp.int32(1), jnp.asarray(tables),
        interpret=True)
    got = _port(tpa.ragged_attend_paged, q, pk, pv, limits, tables, layer=1)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=TOL)


def test_limit_zero_row_returns_mean_of_first_page():
    """mixed_step's dead passenger (limit 0): every column masked, so the
    row returns the finite mean of V over page table[n, 0] — what the TPU
    kernel returns — not zeros."""
    rng, pk, pv, table = _layout(3, seed=33)
    limits = np.array([0, 5, 0], np.int32)
    q = rng.standard_normal((3, HQ, D)).astype(np.float32)
    ref = np.asarray(pa.ragged_attend_pallas_paged(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(limits), jnp.int32(0), jnp.asarray(table),
        interpret=True))
    got = _port(tpa.ragged_attend_paged, q, pk, pv, limits, table, layer=0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    for n in (0, 2):
        mean_v = pv[0, table[n, 0]].mean(axis=1)            # [Hkv, D]
        expect = np.repeat(mean_v, HQ // HKV, axis=0)
        np.testing.assert_allclose(got[n], expect, rtol=0, atol=TOL)
        assert np.all(np.isfinite(got[n])) and np.abs(got[n]).sum() > 0


def test_poisoned_pages_past_live_range_never_read():
    """Pages past every row's live range hold huge values; results must not
    move (the kernel's contract: no page past a row's range is read)."""
    B = 4
    rng, pk, pv, table = _layout(B, seed=44)
    lengths = np.array([3, 9, 16, 1], np.int32)
    q = rng.standard_normal((B, HQ, D)).astype(np.float32)
    base = _port(tpa.paged_attention, q, pk, pv, lengths, table, layer=0)
    pk2, pv2 = pk.copy(), pv.copy()
    for n in range(B):
        for c in range(-(-int(lengths[n]) // PS), MAXP):
            pk2[0, table[n, c]] = 1e4
            pv2[0, table[n, c]] = -1e4
    got = _port(tpa.paged_attention, q, pk2, pv2, lengths, table, layer=0)
    np.testing.assert_array_equal(got, base)


def test_cpu_wrapper_takes_plain_version_and_counts_nothing():
    rng, pk, pv, table = _layout(2, seed=55)
    lengths = np.array([5, 12], np.int32)
    q = rng.standard_normal((2, HQ, D)).astype(np.float32)
    before = tpa.paged_attention.launches
    got = _port(tpa.paged_attention, q, pk, pv, lengths, table, layer=1)
    plain = _port(tpa.paged_attention_plain, q, pk, pv, lengths, table,
                  layer=1)
    np.testing.assert_array_equal(got, plain)
    assert tpa.paged_attention.launches == before


def test_bf16_plain_matches_float32_within_bf16_rounding():
    """The card runs bf16 pools; the plain version upcasts to float32, so
    its bf16 result is the float32 result rounded (one bf16 ulp)."""
    rng, pk, pv, table = _layout(3, seed=66)
    lengths = np.array([7, 20, 31], np.int32)
    q = rng.standard_normal((3, HQ, D)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (q, pk, pv)]
    bf = [a.to(torch.bfloat16) for a in args]
    lim, tab = torch.from_numpy(lengths), torch.from_numpy(table)
    out_bf = tpa.paged_attention_plain(*bf, lim, 0, tab)
    out_32 = tpa.paged_attention_plain(*[a.float() for a in bf], lim, 0, tab)
    assert out_bf.dtype == torch.bfloat16
    np.testing.assert_allclose(out_bf.float().numpy(), out_32.numpy(),
                               rtol=2 ** -8, atol=1e-6)



def test_dense_decode_attend_matches_jax_and_the_paged_path():
    """The plain dense attention with one row per slot
    (``decode_attend_multi`` at ``lengths - 1``) against the JAX
    ``decode_attend``, and against the paged entry over the same rows
    gathered dense through the table."""
    from aws_k8s_ansible_provisioner_tpu.ops import attention as jatt
    from aws_k8s_ansible_provisioner_tpu_torch.ops import attention as tatt
    from aws_k8s_ansible_provisioner_tpu_torch.serving.paged_kv import \
        gather_layer_dense

    B = 4
    rng, pk, pv, table = _layout(B, seed=88)
    lengths = np.array([1, 9, 20, 32], np.int32)
    q = rng.standard_normal((B, 1, HQ, D)).astype(np.float32)
    dense = gather_layer_dense({"k": torch.from_numpy(pk),
                                "v": torch.from_numpy(pv)}, 1,
                               torch.from_numpy(table))
    ref = np.asarray(jatt.decode_attend(
        jnp.asarray(q), jnp.asarray(dense["k"].numpy()),
        jnp.asarray(dense["v"].numpy()), jnp.asarray(lengths)))
    got = tatt.decode_attend_multi(torch.from_numpy(q), dense["k"],
                                   dense["v"],
                                   torch.from_numpy(lengths) - 1).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    paged = _port(tpa.decode_attend_paged, q, pk, pv, lengths, table,
                  layer=1)
    np.testing.assert_allclose(paged, got, rtol=0, atol=TOL)


# -- the ragged entry's chunk layout (``chunk_start``) ------------------------


def _chunk_layout(B, C, pslot, pstart, G, seed, quant):
    """mixed_step's packing over MAXP-page tables: B decode
    rows (``pslot``'s the dead passenger, limit 0), then C chunk rows of
    ``pslot`` at limits pstart + 1 .. pstart + C on its table row; table
    entries outside the rows' pages are garbage page ids."""
    rng = np.random.default_rng(seed)
    hkv, hq = 2, 2 * G
    P = B * MAXP + 1
    shape = (L, P, hkv, PS, D)
    if quant:
        pool = {"k": rng.integers(-127, 128, shape).astype(np.int8),
                "v": rng.integers(-127, 128, shape).astype(np.int8),
                "ks": rng.uniform(1e-3, 0.1, shape[:-1]).astype(np.float32),
                "vs": rng.uniform(1e-3, 0.1, shape[:-1]).astype(np.float32)}
    else:
        pool = {n: rng.standard_normal(shape).astype(np.float32)
                for n in ("k", "v")}
    table = (rng.permutation(B * MAXP) + 1).reshape(B, MAXP).astype(np.int32)
    lengths = rng.integers(1, MAXP * PS + 1, B).astype(np.int32)
    lengths[pslot] = 0
    limits = np.concatenate([lengths, pstart + 1 + np.arange(C)]) \
        .astype(np.int32)
    tables = np.concatenate([table, np.repeat(table[pslot][None], C, 0)])
    for n, lim in enumerate(limits):
        live = min(max(-(-int(lim) // PS), 1), MAXP)
        tables[n, live:] = rng.integers(0, P, MAXP - live)
    q = rng.standard_normal((B + C, hq, D)).astype(np.float32)
    return pool, limits, tables, q


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("window", [0, 12])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
def test_ragged_chunk_layout_matches_pallas(G, window, quant):
    """The ragged entry with the chunk layout (``chunk_start`` = B) and
    without it against ``ragged_attend_pallas_paged`` in interpret mode:
    a chunk that starts inside a page (row 13 of pages of 8), the dead
    passenger, G = 1, 2, 4, 8 query heads a kv head, window 0 and 12, a
    float32 and an int8 pool. Both port calls are the plain version, row
    for row the same; the int8 dead passenger is held to be finite (the
    int8 Pallas body folds no scale into a row without a live column)."""
    from aws_k8s_ansible_provisioner_tpu_torch.models.convert import \
        from_jax_pool

    B, C, pslot, pstart = 5, 9, 2, 13
    pool, limits, tables, q = _chunk_layout(B, C, pslot, pstart, G,
                                            seed=200 + G + window, quant=quant)
    jkw = {"pool_ks": jnp.asarray(pool["ks"]),
           "pool_vs": jnp.asarray(pool["vs"])} if quant else {}
    ref = np.asarray(pa.ragged_attend_pallas_paged(
        jnp.asarray(q), jnp.asarray(pool["k"]), jnp.asarray(pool["v"]),
        jnp.asarray(limits), jnp.int32(1), jnp.asarray(tables),
        interpret=True, window=window, **jkw))
    tp = from_jax_pool(pool)
    kw = {"pool_ks": tp["ks"], "pool_vs": tp["vs"]} if quant else {}

    def port(chunk_start):
        return tpa.ragged_attend_paged(
            torch.from_numpy(q), tp["k"], tp["v"], torch.from_numpy(limits),
            1, torch.from_numpy(tables), **kw, window=window,
            chunk_start=chunk_start).numpy()

    got, per_row = port(B), port(None)
    np.testing.assert_array_equal(got, per_row)
    live = limits > 0 if quant else np.ones(B + C, bool)
    np.testing.assert_allclose(got[live], ref[live], rtol=0, atol=TOL)
    assert np.all(np.isfinite(got))


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("window", [0, 12])
def test_ragged_chunk_layout_padded_tail_matches_pallas(window, quant):
    """A padded tail: a chunk of 16 rows at row 10 with 6 valid (plen < C),
    whose slot has pages for rows up to 16 only; its table entries past
    them point at the scratch page 0, as the engine's do, and the tail's
    limits (up to 26) run past the allocated pages. The chunk layout and
    the per-row entry alike, against the Pallas kernel."""
    from aws_k8s_ansible_provisioner_tpu_torch.models.convert import \
        from_jax_pool

    B, C, pslot, pstart, plen, G = 3, 16, 0, 10, 6, 2
    pool, limits, tables, q = _chunk_layout(B, C, pslot, pstart, G,
                                            seed=230 + window, quant=quant)
    allocated = -(-(pstart + plen) // PS)
    tables[B:, allocated:] = 0
    assert limits.max() > allocated * PS
    jkw = {"pool_ks": jnp.asarray(pool["ks"]),
           "pool_vs": jnp.asarray(pool["vs"])} if quant else {}
    ref = np.asarray(pa.ragged_attend_pallas_paged(
        jnp.asarray(q), jnp.asarray(pool["k"]), jnp.asarray(pool["v"]),
        jnp.asarray(limits), jnp.int32(0), jnp.asarray(tables),
        interpret=True, window=window, **jkw))
    tp = from_jax_pool(pool)
    kw = {"pool_ks": tp["ks"], "pool_vs": tp["vs"]} if quant else {}
    got = {cs: tpa.ragged_attend_paged(
        torch.from_numpy(q), tp["k"], tp["v"], torch.from_numpy(limits), 0,
        torch.from_numpy(tables), **kw, window=window,
        chunk_start=cs).numpy() for cs in (B, None)}
    np.testing.assert_array_equal(got[B], got[None])
    live = limits > 0 if quant else np.ones(B + C, bool)
    np.testing.assert_allclose(got[B][live], ref[live], rtol=0, atol=TOL)


@pytest.mark.parametrize("plen", [16, 5, 1])
def test_mixed_step_packs_the_chunk_layout_it_claims(plen):
    """mixed_step hands the ragged entry chunk_start = B, and its packed rows
    from B on share pslot's table row with limits rising by one from
    pstart + 1 (a padded tail, plen < C, included); the rows before B are
    the decode rows (pslot's own the dead passenger, limit 0)."""
    import dataclasses

    from aws_k8s_ansible_provisioner_tpu_torch.config import tiny_qwen3
    from aws_k8s_ansible_provisioner_tpu_torch.models.layers import (
        DecoderLM, init_params)
    from aws_k8s_ansible_provisioner_tpu_torch.ops import attention
    from aws_k8s_ansible_provisioner_tpu_torch.serving import programs
    from aws_k8s_ansible_provisioner_tpu_torch.serving.paged_kv import \
        init_pool

    cfg = dataclasses.replace(tiny_qwen3(), num_layers=2)
    model = DecoderLM(cfg, init_params(cfg, torch.Generator().manual_seed(0),
                                       torch.float32))
    B, C, pslot, pstart, maxp = 4, 16, 1, 21, 8
    pool = init_pool(cfg, B * maxp + 1, PS, torch.float32, device="cpu")
    table = torch.arange(1, B * maxp + 1, dtype=torch.int32).reshape(B, maxp)
    lengths = torch.tensor([9, 0, 30, 17], dtype=torch.int32)
    seen = []
    orig = attention.ragged_attend_paged

    def spy(q, pool_k, pool_v, row_limits, layer, row_tables, **kw):
        seen.append((row_limits.clone(), row_tables.clone(),
                     kw["chunk_start"]))
        return orig(q, pool_k, pool_v, row_limits, layer, row_tables, **kw)

    attention.ragged_attend_paged = spy
    try:
        zeros = torch.zeros(B)
        programs.mixed_step(
            model, pool, torch.full((B,), 3, dtype=torch.int32), lengths,
            torch.full((1, C), 5, dtype=torch.int32), pslot, pstart, plen,
            table, zeros, torch.zeros(B, dtype=torch.int32), zeros + 1,
            torch.zeros(B, dtype=torch.int64), 0.0, 0, 1.0, 0)
    finally:
        attention.ragged_attend_paged = orig
    assert len(seen) == cfg.num_layers
    for limits, tables, chunk_start in seen:
        assert chunk_start == B
        assert torch.equal(limits[B:], tables.new_tensor(
            pstart + 1 + np.arange(C)))
        assert torch.equal(tables[B:], table[pslot][None].expand(C, -1))
        assert torch.equal(tables[:B], table)
        assert limits[pslot] == 0
        assert torch.equal(limits[:B][torch.arange(B) != pslot],
                           lengths[torch.arange(B) != pslot] + 1)
