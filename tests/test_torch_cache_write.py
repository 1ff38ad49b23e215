"""The port's paged K/V row write against the JAX Pallas kernel.

``cache_write_rows_paged_plain`` (the plain version the CUDA kernel is held
to on the card) and the CPU path of its wrapper are compared with
``cache_write_row_paged`` run in Pallas interpret mode, once for K and once
for V, on the same numpy-seeded inputs. A write is a copy, so the pools must
come out bit-identical.

Two behaviours where the port deliberately differs from the reference are
pinned at the end (both off the serving path; see ROADMAP.md, queue C).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aws_k8s_ansible_provisioner_tpu.ops import pallas_attention as pa
from aws_k8s_ansible_provisioner_tpu_torch.ops import paged_attention as tpa
from aws_k8s_ansible_provisioner_tpu_torch.serving.paged_kv import OOB_PAGE

torch.set_num_threads(2)

L, HKV, D, PS, MAXP = 2, 2, 16, 8, 3


def _inputs(N, seed):
    rng = np.random.default_rng(seed)
    P = N * MAXP + 2
    pool_k = rng.standard_normal((L, P, HKV, PS, D)).astype(np.float32)
    pool_v = rng.standard_normal((L, P, HKV, PS, D)).astype(np.float32)
    k_new = rng.standard_normal((N, HKV, D)).astype(np.float32)
    v_new = rng.standard_normal((N, HKV, D)).astype(np.float32)
    # shuffled physical pages, none shared between rows' tables
    table = (rng.permutation(N * MAXP) + 1).reshape(N, MAXP).astype(np.int32)
    return pool_k, pool_v, k_new, v_new, table


def _jax_write(pool_k, pool_v, k_new, v_new, rows, table, layer):
    args = (jnp.asarray(rows), jnp.asarray(table), jnp.int32(layer))
    out_k = pa.cache_write_row_paged(jnp.asarray(pool_k), jnp.asarray(k_new),
                                     *args, interpret=True)
    out_v = pa.cache_write_row_paged(jnp.asarray(pool_v), jnp.asarray(v_new),
                                     *args, interpret=True)
    return np.asarray(out_k), np.asarray(out_v)


def _port_write(fn, pool_k, pool_v, k_new, v_new, rows, table, layer):
    pk, pv = torch.from_numpy(pool_k.copy()), torch.from_numpy(pool_v.copy())
    fn(pk, pv, torch.from_numpy(k_new), torch.from_numpy(v_new),
       torch.from_numpy(rows), layer, torch.from_numpy(table))
    return pk.numpy(), pv.numpy()


def _assert_same_as_jax(pool_k, pool_v, k_new, v_new, rows, table, layer):
    ref_k, ref_v = _jax_write(pool_k, pool_v, k_new, v_new, rows, table,
                              layer)
    for fn in (tpa.cache_write_rows_paged_plain, tpa.cache_write_rows_paged):
        got_k, got_v = _port_write(fn, pool_k, pool_v, k_new, v_new, rows,
                                   table, layer)
        np.testing.assert_array_equal(got_k, ref_k)
        np.testing.assert_array_equal(got_v, ref_v)
    return ref_k, ref_v


@pytest.mark.parametrize("layer", [0, 1])
def test_decode_rows_bit_identical(layer):
    """One row per slot: page starts, page ends, mid-page rows, the last
    row of the window."""
    N = 5
    pool_k, pool_v, k_new, v_new, table = _inputs(N, seed=layer)
    rows = np.array([0, 7, 8, 13, MAXP * PS - 1], np.int32)
    ref_k, _ = _assert_same_as_jax(pool_k, pool_v, k_new, v_new, rows, table,
                                   layer)
    assert not np.array_equal(ref_k, pool_k)          # something was written


def test_dropped_rows_and_oob_tables_bit_identical():
    """Rows -1 and max_pages * page drop, also when their table rows hold
    OOB_PAGE (a dropped row never reads its table); kept rows beside them
    still land."""
    N = 6
    pool_k, pool_v, k_new, v_new, table = _inputs(N, seed=3)
    table[0, :] = OOB_PAGE
    table[1, :] = OOB_PAGE
    rows = np.array([-1, MAXP * PS, MAXP * PS, -1, 5, 17], np.int32)
    ref_k, ref_v = _assert_same_as_jax(pool_k, pool_v, k_new, v_new, rows,
                                       table, 1)
    changed = np.argwhere((ref_k != pool_k).any(axis=(2, 4)))
    assert sorted(map(tuple, changed.tolist())) == sorted(
        [(1, int(table[4, 0]), 5), (1, int(table[5, 2]), 1)])
    np.testing.assert_array_equal(ref_v[0], pool_v[0])  # other layer intact


def test_mixed_step_layout_bit_identical():
    """mixed_step's packed rows: B decode rows (the chunking slot's own row
    is the dead passenger, row -1), then C chunk rows of that slot sharing
    its table and crossing a page boundary.

    Chunk rows share 8-row blocks of one page. In interpret mode each grid
    step of the Pallas kernel reads its block from the pool as it was
    before the call, so of several rows in one block only the last lands;
    the reference here is therefore the Pallas kernel applied one row per
    call, in packed order (every write lands, as in the JAX engine's XLA
    scatter path)."""
    B, C, pslot, pstart = 4, 6, 1, 5
    pool_k, pool_v, k_new, v_new, table = _inputs(B + C, seed=4)
    lengths = np.array([3, 0, 9, 20], np.int32)
    rows = np.concatenate([lengths, pstart + np.arange(C)]).astype(np.int32)
    rows[pslot] = -1
    tables = np.concatenate([table[:B], np.repeat(table[pslot][None], C, 0)])
    ref_k, ref_v = pool_k, pool_v
    for n in range(B + C):
        ref_k, ref_v = _jax_write(ref_k, ref_v, k_new[n:n + 1],
                                  v_new[n:n + 1], rows[n:n + 1],
                                  tables[n:n + 1], 0)
    for fn in (tpa.cache_write_rows_paged_plain, tpa.cache_write_rows_paged):
        got_k, got_v = _port_write(fn, pool_k, pool_v, k_new, v_new, rows,
                                   tables, 0)
        np.testing.assert_array_equal(got_k, ref_k)
        np.testing.assert_array_equal(got_v, ref_v)
    np.testing.assert_array_equal(ref_k[0, tables[B, 0], :, pstart],
                                  k_new[B])


def test_cpu_wrapper_counts_no_launch():
    pool_k, pool_v, k_new, v_new, table = _inputs(2, seed=5)
    before = tpa.cache_write_rows_paged.launches
    _port_write(tpa.cache_write_rows_paged, pool_k, pool_v, k_new, v_new,
                np.array([1, 2], np.int32), table, 0)
    assert tpa.cache_write_rows_paged.launches == before


def test_kept_row_with_oob_page_drops():
    """Port boundary: a row inside the window whose table entry lies outside
    the pool (OOB_PAGE) drops. The Pallas reference clamps the block index
    and writes the pool's last page instead; the serving path never builds
    such a table for the kernel (engine tables hold real or scratch pages)."""
    pool_k, pool_v, k_new, v_new, table = _inputs(2, seed=6)
    table[0, :] = OOB_PAGE
    table[1, 0] = -3
    rows = np.array([3, 2], np.int32)
    got_k, got_v = _port_write(tpa.cache_write_rows_paged, pool_k, pool_v,
                               k_new, v_new, rows, table, 0)
    np.testing.assert_array_equal(got_k, pool_k)
    np.testing.assert_array_equal(got_v, pool_v)


def test_dropped_row_after_kept_row_on_same_page_keeps_the_write():
    """Port boundary: every kept row lands, whatever the dropped rows' tables
    point at. In the Pallas reference a dropped row still maps a block (its
    row clamped into the window) and writes that block back; in interpret
    mode, when that block holds an earlier row's write, the earlier write is
    lost."""
    pool_k, pool_v, k_new, v_new, table = _inputs(2, seed=7)
    # row 1 drops; clamped to the window's last row (23) its block is page
    # table[1, 2], rows 0..7: the block row 0 writes at offset 5
    rows = np.array([5, MAXP * PS], np.int32)
    table[1, 2] = table[0, 0]
    got_k, got_v = _port_write(tpa.cache_write_rows_paged, pool_k, pool_v,
                               k_new, v_new, rows, table, 1)
    np.testing.assert_array_equal(got_k[1, table[0, 0], :, 5], k_new[0])
    np.testing.assert_array_equal(got_v[1, table[0, 0], :, 5], v_new[0])
    got_k[1, table[0, 0], :, 5] = pool_k[1, table[0, 0], :, 5]
    np.testing.assert_array_equal(got_k, pool_k)

