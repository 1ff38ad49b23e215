"""The port's paged KV pool (``serving/paged_kv.py``) against the JAX one.

Pool layout, the prefill scatters and the dense gather are compared on the
same numpy-seeded inputs (bit-identical: they copy values); the host
allocator runs one operation sequence on both sides and must report the same
pages and counts after every step.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aws_k8s_ansible_provisioner_tpu.config import tiny_qwen3 as jax_tiny
from aws_k8s_ansible_provisioner_tpu.serving import paged_kv as jkv
from aws_k8s_ansible_provisioner_tpu_torch.config import ModelConfig
from aws_k8s_ansible_provisioner_tpu_torch.serving import paged_kv as tkv

torch.set_num_threads(2)

PS, P, MAXP = 8, 13, 4
JCFG = jax_tiny()
TCFG = ModelConfig(**dataclasses.asdict(JCFG))
HKV, D = JCFG.num_kv_heads, JCFG.head_dim


def _pools(seed):
    rng = np.random.default_rng(seed)
    shape = (JCFG.num_layers, P, HKV, PS, D)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    return rng, k, v


def _port_pool(k, v):
    return {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}


def _assert_pools_equal(got, ref):
    for name in ("k", "v"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(ref[name]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_pool_matches_jax(dtype):
    ref = jkv.init_pool(JCFG, P, PS, getattr(jnp, dtype))
    got = tkv.init_pool(TCFG, P, PS, getattr(torch, dtype), device="cpu")
    assert sorted(got) == sorted(ref) == ["k", "v"]
    for name in ("k", "v"):
        assert tuple(got[name].shape) == ref[name].shape
        assert got[name].dtype == getattr(torch, dtype)
        assert not got[name].any()


def test_init_pool_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("the check is for a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        tkv.init_pool(TCFG, P, PS)


@pytest.mark.parametrize("layer", [0, 1])
def test_write_prompts_paged_layer_matches_jax(layer):
    """Three right-padded prompts in a 16-row bucket: two own pages, one is
    a padding row of the batch (OOB_PAGE table); padding rows past a
    prompt's pages land on scratch page 0."""
    rng, k0, v0 = _pools(layer)
    N, T = 3, 16
    tables = np.zeros((N, MAXP), np.int32)
    tables[0, :2] = [5, 2]
    tables[1, :1] = [9]
    tables[2, :] = tkv.OOB_PAGE
    k = rng.standard_normal((N, T, HKV, D)).astype(np.float32)
    v = rng.standard_normal((N, T, HKV, D)).astype(np.float32)
    # the scratch page takes padding rows of two prompts at the same
    # offsets; compare every page but that one
    ref = jkv.write_prompts_paged_layer(
        {"k": jnp.asarray(k0), "v": jnp.asarray(v0)}, layer,
        jnp.asarray(tables), jnp.asarray(k), jnp.asarray(v), PS)
    got = tkv.write_prompts_paged_layer(
        _port_pool(k0, v0), layer, torch.from_numpy(tables),
        torch.from_numpy(k), torch.from_numpy(v), PS)
    for name in ("k", "v"):
        np.testing.assert_array_equal(got[name].numpy()[:, 1:],
                                      np.asarray(ref[name])[:, 1:])
    np.testing.assert_array_equal(got["k"].numpy()[layer, 2, :, 3], k[0, 11])
    np.testing.assert_array_equal(got["k"].numpy()[layer, 9, :, 7], k[1, 7])


@pytest.mark.parametrize("start", [0, 5, 27])
def test_write_chunk_paged_layer_matches_jax(start):
    """A chunk of 8 rows at ``start``: inside a page, across a page
    boundary, and running past the slot's last page (those rows drop)."""
    rng, k0, v0 = _pools(10 + start)
    pages = np.array([4, 11, 7, 1], np.int32)
    k = rng.standard_normal((1, 8, HKV, D)).astype(np.float32)
    v = rng.standard_normal((1, 8, HKV, D)).astype(np.float32)
    ref = jkv.write_chunk_paged_layer(
        {"k": jnp.asarray(k0), "v": jnp.asarray(v0)}, 1, jnp.asarray(pages),
        start, jnp.asarray(k), jnp.asarray(v), PS)
    got = tkv.write_chunk_paged_layer(
        _port_pool(k0, v0), 1, torch.from_numpy(pages), start,
        torch.from_numpy(k), torch.from_numpy(v), PS)
    _assert_pools_equal(got, ref)


def test_gather_layer_dense_matches_jax():
    _, k0, v0 = _pools(20)
    table = np.array([[3, 1, 0, 0], [12, 6, 2, 8]], np.int32)
    ref = jkv.gather_layer_dense({"k": jnp.asarray(k0), "v": jnp.asarray(v0)},
                                 1, jnp.asarray(table))
    got = tkv.gather_layer_dense(_port_pool(k0, v0), 1,
                                 torch.from_numpy(table))
    _assert_pools_equal(got, ref)
    assert tuple(got["k"].shape) == (2, HKV, MAXP * PS, D)


def test_page_pool_matches_jax_on_one_sequence():
    """alloc / retain / release / release_all on both allocators: the same
    page ids and the same free / in-use / live counts after every step."""
    ref, got = jkv.PagePool(10, PS, first_page=1), \
        tkv.PagePool(10, PS, first_page=1)
    held = []

    def check():
        assert got.free_pages == ref.free_pages
        assert got.pages_in_use == ref.pages_in_use
        for key in ("pages_free", "pages_total"):
            assert got.stats()[key] == ref.stats()[key]

    check()
    for n in (3, 2, 4):
        a, b = ref.alloc(n), got.alloc(n)
        assert a == b
        held.append(a)
        check()
    assert ref.alloc(1) is None and got.alloc(1) is None   # 9 pages, 9 held
    for pid in held[1]:
        ref.retain(pid)
        got.retain(pid)
    ref.release_all(held[1])
    got.release_all(held[1])
    check()                                      # retained: still live
    ref.release_all(held[0] + held[1])
    got.release_all(held[0] + held[1])
    check()
    assert ref.alloc(4) == got.alloc(4)          # FIFO reuse order
    check()
    assert got.stats()["pages_live"] == 8


def test_page_pool_refuses_double_release_and_bad_geometry():
    pool = tkv.PagePool(4, PS, first_page=1)
    (pid,) = pool.alloc(1)
    pool.release(pid)
    with pytest.raises(ValueError):
        pool.release(pid)
    with pytest.raises(ValueError):
        pool.retain(pid)
    with pytest.raises(ValueError):
        tkv.PagePool(1, PS, first_page=1)
