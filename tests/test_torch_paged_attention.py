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
