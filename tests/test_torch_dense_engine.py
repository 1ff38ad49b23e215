"""The dense slot-contiguous engine (``ServingConfig.paged=False``) in the
port against the JAX package.

Kernels (plain versions, the CPU side of their wrappers and what the CUDA
kernels are held to on the card) against the Pallas kernels run in
interpret mode on the same numpy-seeded inputs:

- K9 (``cache_write_row_quant``): int8 rows and float32 scales bit for
  bit, kept rows at the window's edges and dropped ones, one row per slot
  and the verify's R rows (the TPU writes them one call per row); and the
  dense int8 writers (prompt, chunk, row) against the JAX engine's jitted
  XLA writers, bit for bit;
- K4-int8 and K7-int8 (``decode_attend_pallas_layer`` and
  ``decode_attend_pallas_spec`` with ``cache_ks``/``cache_vs``) at windows
  0, 8 and 12, and K5 (``decode_attend_pallas_layer(bblock=2 or 4)``),
  float32 and int8, window 0 and 12: max abs 1e-5 (both sides accumulate in
  float32 and differ only in summation order) on every row with a live
  column. ROADMAP C11 is pinned: a row with no live column in its block
  gets the mean of V over the block's chunks from the Pallas K5, zeros from
  the port at every block size.

Programs and engines, tiny_qwen3 and tiny_mistral at float32: one
``prefill_chunk_step`` against the JAX program (the cache after it and the
sampled token), and the dense engine's greedy streams byte-identical to the
JAX ``Engine(paged=False, prefix_cache=False)`` with float32 and int8 KV:
batched prefill, the chunk walk, ``decode_bblock`` 2, prompt lookup, a
self-draft, tiny_mistral's window; seeded sampled streams identical too,
and independent of the batch around them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aws_k8s_ansible_provisioner_tpu.config import ServingConfig as JServing
from aws_k8s_ansible_provisioner_tpu.config import tiny_mistral as jax_mistral
from aws_k8s_ansible_provisioner_tpu.config import tiny_qwen3 as jax_tiny
from aws_k8s_ansible_provisioner_tpu.models.layers import init_params
from aws_k8s_ansible_provisioner_tpu.ops import pallas_attention as pa
from aws_k8s_ansible_provisioner_tpu.serving import kv_cache as jkvc
from aws_k8s_ansible_provisioner_tpu.serving.engine import Engine as JEngine
from aws_k8s_ansible_provisioner_tpu.serving.engine import Request as JRequest
from aws_k8s_ansible_provisioner_tpu.serving.programs import \
    prefill_chunk_step as jax_chunk_step
from aws_k8s_ansible_provisioner_tpu_torch.config import ModelConfig
from aws_k8s_ansible_provisioner_tpu_torch.config import \
    ServingConfig as TServing
from aws_k8s_ansible_provisioner_tpu_torch.models.convert import \
    from_jax_params
from aws_k8s_ansible_provisioner_tpu_torch.models.layers import DecoderLM
from aws_k8s_ansible_provisioner_tpu_torch.ops import dense_attention as tda
from aws_k8s_ansible_provisioner_tpu_torch.serving import kv_cache as tkvc
from aws_k8s_ansible_provisioner_tpu_torch.serving import server as tserver
from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import \
    Engine as TEngine
from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import \
    Request as TRequest
from aws_k8s_ansible_provisioner_tpu_torch.serving.programs import \
    prefill_chunk_step as port_chunk_step

torch.set_num_threads(2)

TOL = 1e-5
L, HKV, HQ, D, S = 2, 2, 4, 16, 64
WINDOWS = pytest.mark.parametrize("window", [0, 8, 12])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rows(shape, seed):
    """float32 rows with row maxima spread over six decades, some zero."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * 10.0 ** rng.uniform(-4, 2,
                                                         shape[:-1] + (1,))
    x = x.astype(np.float32)
    x.reshape(-1, shape[-1])[:3] = 0.0
    return x


def _cache(B, quant, seed):
    """A random dense cache [L, B, HKV, S, D]: float32, or int8 with
    positive float32 scales."""
    rng = np.random.default_rng(seed)
    shape = (L, B, HKV, S, D)
    if not quant:
        return rng, {n: rng.standard_normal(shape).astype(np.float32)
                     for n in ("k", "v")}
    return rng, {"k": rng.integers(-127, 128, shape).astype(np.int8),
                 "v": rng.integers(-127, 128, shape).astype(np.int8),
                 "ks": rng.uniform(1e-3, 0.1, shape[:-1]).astype(np.float32),
                 "vs": rng.uniform(1e-3, 0.1, shape[:-1]).astype(np.float32)}


def _jkw(cache):
    """The Pallas kernels' scale operands of an int8 cache."""
    if "ks" not in cache:
        return {}
    return {"cache_ks": jnp.asarray(cache["ks"]),
            "cache_vs": jnp.asarray(cache["vs"])}


def _tkw(cache):
    if "ks" not in cache:
        return {}
    return {"cache_ks": _t(cache["ks"]), "cache_vs": _t(cache["vs"])}


def _assert_cache_equal(got: dict, ref: dict):
    assert sorted(got) == sorted(ref)
    for name in ref:
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(ref[name]),
                                      err_msg=name)


# -- the int8 dense cache and its writers -----------------------------------

JCFG = jax_tiny()
TCFG = ModelConfig(**dataclasses.asdict(JCFG))


def test_dense_int8_cache_matches_jax():
    for quant in (False, True):
        ref = jkvc.init_cache(JCFG, 3, S, jnp.float32, quant=quant)
        got = tkvc.init_cache(TCFG, 3, S, torch.float32, device="cpu",
                              quant=quant)
        assert sorted(got) == sorted(ref)
        assert tkvc.is_quantized(got) == jkvc.is_quantized(ref) == quant
        for name in ref:
            assert tuple(got[name].shape) == ref[name].shape
            assert str(got[name].dtype).split(".")[-1] == \
                str(ref[name].dtype)
            assert not got[name].any()


@pytest.mark.parametrize("layer", [0, 1])
def test_dense_int8_writers_match_jitted_jax(layer):
    """The prompt scatter (a padding row's slot out of range drops), a
    chunk whose tail pokes past the window (dropped, not shifted) and the
    row write (rows S and past it drop; the XLA scatter would wrap a
    negative row, which the Pallas K9 drops, so that case is K9's test):
    int8 rows and scales bit for bit against the JAX engine's compiled
    writers."""
    _, cache = _cache(4, True, seed=1)
    jc = {n: jnp.asarray(a) for n, a in cache.items()}

    def port():
        return {n: _t(a.copy()) for n, a in cache.items()}

    def layer_of(c):
        return {n: c[n][layer] for n in c}

    # prompts of 20 rows into slots 2 and 0; the third is padding
    k, v = _rows((3, 20, HKV, D), 2), _rows((3, 20, HKV, D), 3)
    slots = np.array([2, 0, 4], np.int32)
    ref = jax.jit(jkvc.write_prompts)(layer_of(jc), jnp.asarray(slots),
                                      jnp.asarray(k), jnp.asarray(v))
    got = tkvc.write_prompts(port(), layer, _t(slots), _t(k), _t(v))
    _assert_cache_equal(layer_of(got), ref)
    # a chunk of 16 rows at 56: rows 64.. drop
    k, v = _rows((1, 16, HKV, D), 4), _rows((1, 16, HKV, D), 5)
    ref = jax.jit(jkvc.write_chunk)(layer_of(jc), jnp.int32(1),
                                    jnp.int32(56), jnp.asarray(k),
                                    jnp.asarray(v))
    got = tkvc.write_chunk(port(), layer, 1, 56, _t(k), _t(v))
    _assert_cache_equal(layer_of(got), ref)
    # one row per slot, at the window's edges and past it
    rows = np.array([0, S - 1, S + 5, S], np.int32)
    k, v = _rows((4, 1, HKV, D), 6), _rows((4, 1, HKV, D), 7)
    ref = jax.jit(jkvc.write_token_layer)(jc, jnp.int32(layer),
                                          jnp.asarray(rows), jnp.asarray(k),
                                          jnp.asarray(v))
    got = tkvc.write_token_layer(port(), layer, _t(rows[:, None]), _t(k),
                                 _t(v))
    _assert_cache_equal(got, ref)


# -- K9: the quantizing row write -------------------------------------------


def _port_write(cache, k_new, v_new, rows, layer):
    c = {n: _t(a.copy()) for n, a in cache.items()}
    tda.cache_write_rows_quant_dense(c["k"], c["v"], c["ks"], c["vs"],
                                     _t(k_new), _t(v_new), _t(rows), layer)
    return c


def _pallas_write(cache, k_new, v_new, rows, layer):
    """R rows per slot as the JAX verify writes them: one Pallas call per
    row, for K and for V."""
    out = {n: jnp.asarray(a) for n, a in cache.items()}
    for r in range(rows.shape[1]):
        for name, new in (("k", k_new), ("v", v_new)):
            out[name], out[name + "s"] = pa.cache_write_row_quant(
                out[name], out[name + "s"], jnp.asarray(new[:, r]),
                jnp.asarray(rows[:, r]), jnp.int32(layer), interpret=True)
    return out


@pytest.mark.parametrize("layer", [0, 1])
def test_k9_bit_identical_to_pallas(layer):
    """One row per slot: the window's first and last rows, a mid row, a
    dropped row (-1) and one past the window."""
    B = 5
    _, cache = _cache(B, True, seed=10 + layer)
    rows = np.array([[0], [S - 1], [33], [-1], [S]], np.int32)
    k_new, v_new = _rows((B, 1, HKV, D), 12), _rows((B, 1, HKV, D), 13)
    ref = _pallas_write(cache, k_new, v_new, rows, layer)
    got = _port_write(cache, k_new, v_new, rows, layer)
    _assert_cache_equal(got, ref)
    assert not np.array_equal(np.asarray(ref["ks"]), cache["ks"])
    q8, scale = tkvc.quantize_rows(_t(k_new[1, 0]))
    assert torch.equal(got["k"][layer, 1, :, S - 1], q8)
    assert torch.equal(got["ks"][layer, 1, :, S - 1], scale)


def test_k9_r_rows_in_one_call_equal_r_pallas_calls():
    """The verify's R = 3 rows per slot in one launch, rows crossing the
    window's end (the last ones drop)."""
    B, R = 3, 3
    _, cache = _cache(B, True, seed=14)
    rows = np.array([[0, 1, 2], [30, 31, 32], [S - 2, S - 1, S]], np.int32)
    k_new, v_new = _rows((B, R, HKV, D), 15), _rows((B, R, HKV, D), 16)
    _assert_cache_equal(_port_write(cache, k_new, v_new, rows, 1),
                        _pallas_write(cache, k_new, v_new, rows, 1))


def test_cpu_dense_wrappers_count_no_launch():
    _, cache = _cache(2, True, seed=17)
    before = tda.launch_counts()
    _port_write(cache, _rows((2, 1, HKV, D), 18), _rows((2, 1, HKV, D), 19),
                np.array([[1], [2]], np.int32), 0)
    c = {n: _t(a) for n, a in cache.items()}
    tda.decode_attend_dense(torch.zeros(2, 1, HQ, D), c["k"], c["v"],
                            torch.tensor([3, 9], dtype=torch.int32), 0,
                            cache_ks=c["ks"], cache_vs=c["vs"], bblock=2)
    tda.spec_attend_dense(torch.zeros(2, 3, HQ, D), c["k"], c["v"],
                          torch.tensor([3, 9], dtype=torch.int32), 0,
                          cache_ks=c["ks"], cache_vs=c["vs"])
    assert tda.launch_counts() == before
    for name in ("decode_attend_dense quant", "decode_attend_dense bblock",
                 "decode_attend_dense quant bblock window",
                 "spec_attend_dense quant window",
                 "cache_write_rows_quant_dense"):
        assert name in before


# -- K4-int8, K7-int8 ---------------------------------------------------------


@WINDOWS
def test_k4_int8_matches_pallas(window):
    """Lengths 0 (zeros, C8), one row, below, at and past the window, a
    chunk edge and the full window, over 16-row chunks."""
    lengths = np.array([0, 1, 8, 13, 16, 30, 47, S], np.int32)
    B = len(lengths)
    _, cache = _cache(B, True, seed=20 + window)
    rng = np.random.default_rng(21)
    q = rng.standard_normal((B, 1, HQ, D)).astype(np.float32)
    ref = np.asarray(pa.decode_attend_pallas_layer(
        jnp.asarray(q), jnp.asarray(cache["k"]), jnp.asarray(cache["v"]),
        jnp.asarray(lengths), jnp.int32(1), chunk=16, interpret=True,
        window=window, bblock=1, **_jkw(cache)))
    got = tda.decode_attend_dense(_t(q), _t(cache["k"]), _t(cache["v"]),
                                  _t(lengths), 1, window,
                                  **_tkw(cache)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    assert not got[0].any() and np.abs(got[1:]).sum(axis=(1, 2, 3)).all()


@WINDOWS
def test_k7_int8_matches_pallas(window):
    """R = 5 rows per slot from length 0 to the window's last rows, row
    r's window off its own limit."""
    R = 5
    lengths = np.array([0, 4, 7, 21, 40, S - R], np.int32)
    B = len(lengths)
    _, cache = _cache(B, True, seed=30 + window)
    rng = np.random.default_rng(31)
    q = rng.standard_normal((B, R, HQ, D)).astype(np.float32)
    ref = np.asarray(pa.decode_attend_pallas_spec(
        jnp.asarray(q), jnp.asarray(cache["k"]), jnp.asarray(cache["v"]),
        jnp.asarray(lengths), jnp.int32(0), chunk=16, interpret=True,
        window=window, **_jkw(cache)))
    got = tda.spec_attend_dense(_t(q), _t(cache["k"]), _t(cache["v"]),
                                _t(lengths), 0, window,
                                **_tkw(cache)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


def test_int8_plain_folds_the_scales_as_attention_over_the_dequantized():
    """Folding the scales is attention over K*ks and V*vs: the int8 plain
    form against the float32 form on the dequantized cache (on the CPU at
    float32 the Pallas contract and the JAX XLA fallback agree)."""
    lengths = np.array([3, 20, 40, S], np.int32)
    _, cache = _cache(4, True, seed=35)
    q = _t(np.random.default_rng(36).standard_normal(
        (4, 2, HQ, D)).astype(np.float32))
    c = {n: _t(a) for n, a in cache.items()}
    folded = tda.dense_attention_plain(q, c["k"], c["v"], _t(lengths), 1, 12,
                                       c["ks"], c["vs"])
    dense = tda.dense_attention_plain(
        q, tkvc.dequantize(c["k"], c["ks"]), tkvc.dequantize(c["v"], c["vs"]),
        _t(lengths), 1, 12)
    np.testing.assert_allclose(folded.numpy(), dense.numpy(), rtol=0,
                               atol=TOL)


# -- K5: the batch-blocked decode -------------------------------------------


@pytest.mark.parametrize("bb", [2, 4])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("window", [0, 12])
def test_k5_matches_pallas_bblock(bb, quant, window):
    """Blocks mixing long and short slots (the union range covers the
    longest and, with a window, the lowest window start; tests/
    test_pallas_attention.py:190-247): every row has a live column."""
    lengths = np.array([1, S, 7, 40, 33, 57, 2, S], np.int32)
    B = len(lengths)
    _, cache = _cache(B, quant, seed=40 + bb + window)
    q = np.random.default_rng(41).standard_normal(
        (B, 1, HQ, D)).astype(np.float32)
    ref = np.asarray(pa.decode_attend_pallas_layer(
        jnp.asarray(q), jnp.asarray(cache["k"]), jnp.asarray(cache["v"]),
        jnp.asarray(lengths), jnp.int32(1), chunk=16, interpret=True,
        window=window, bblock=bb, **_jkw(cache)))
    one = np.asarray(pa.decode_attend_pallas_layer(
        jnp.asarray(q), jnp.asarray(cache["k"]), jnp.asarray(cache["v"]),
        jnp.asarray(lengths), jnp.int32(1), chunk=16, interpret=True,
        window=window, bblock=1, **_jkw(cache)))
    got = tda.decode_attend_dense(_t(q), _t(cache["k"]), _t(cache["v"]),
                                  _t(lengths), 1, window, **_tkw(cache),
                                  bblock=bb).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    np.testing.assert_allclose(ref, one, rtol=0, atol=TOL)


def test_k5_row_without_live_column_c11():
    """ROADMAP C11: a slot of length 0 in a block beside a slot of 40. The
    Pallas K5 visits the block's chunks 0..2 (16 rows each) with every
    column of that row masked, so p = exp(0) = 1 and the row is the mean
    of V over rows [0, 48); K4 (bblock 1) gives zeros (C8), and so does
    the port at every block size. The engine never builds such a row: a
    decode row attends its length + 1 >= 1 rows."""
    lengths = np.array([0, 40, 5, 9], np.int32)
    _, cache = _cache(4, False, seed=45)
    q = np.random.default_rng(46).standard_normal(
        (4, 1, HQ, D)).astype(np.float32)

    def pallas(bb):
        return np.asarray(pa.decode_attend_pallas_layer(
            jnp.asarray(q), jnp.asarray(cache["k"]), jnp.asarray(cache["v"]),
            jnp.asarray(lengths), jnp.int32(0), chunk=16, interpret=True,
            bblock=bb))

    blocked, single = pallas(2), pallas(1)
    mean_v = cache["v"][0, 0, :, :48].mean(axis=1)                # [HKV, D]
    np.testing.assert_allclose(blocked[0, 0].reshape(HKV, HQ // HKV, D),
                               np.broadcast_to(mean_v[:, None],
                                               (HKV, HQ // HKV, D)),
                               rtol=0, atol=TOL)
    assert not single[0].any()
    for bb in (1, 2, 4):
        got = tda.decode_attend_dense(_t(q), _t(cache["k"]),
                                      _t(cache["v"]), _t(lengths), 0,
                                      bblock=bb).numpy()
        assert not got[0].any()
        np.testing.assert_allclose(got[1:], blocked[1:], rtol=0, atol=TOL)


def test_bblock_fits_down_to_a_divisor_of_the_slots():
    """tests/test_pallas_attention.py::test_bblock_non_divisible_batch_shrinks:
    a block size that does not divide the slots resolves to the largest
    divisor below it, on the port's side as on the Pallas kernel's."""
    assert [tda.fit_bblock(r, 6) for r in (0, 1, 4, 5, 6, 9)] == \
        [1, 1, 3, 3, 6, 6]
    assert [tda.fit_bblock(r, 32) for r in (3, 4, 8, 12)] == [2, 4, 8, 8]
    lengths = np.array([5, 60, 17, 1, 33, 64], np.int32)
    _, cache = _cache(6, True, seed=47)
    q = np.random.default_rng(48).standard_normal(
        (6, 1, HQ, D)).astype(np.float32)
    ref = np.asarray(pa.decode_attend_pallas_layer(
        jnp.asarray(q), jnp.asarray(cache["k"]), jnp.asarray(cache["v"]),
        jnp.asarray(lengths), jnp.int32(0), chunk=16, interpret=True,
        bblock=4, **_jkw(cache)))
    got = tda.decode_attend_dense(_t(q), _t(cache["k"]), _t(cache["v"]),
                                  _t(lengths), 0, **_tkw(cache),
                                  bblock=4).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


# -- prefill_chunk_step against the JAX program ------------------------------


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
    """(JAX params, port params) of tiny_qwen3 at float32: scaled, and the
    JAX init as it is (whose greedy streams loop, so prompt lookup fires)."""
    out = {}
    for name, scale in (("scaled", True), ("plain", False)):
        jp = init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
        jp = _scaled(jp) if scale else jp
        out[name] = (jp, from_jax_params(jax.tree.map(np.asarray, jp), TCFG))
    return out


@pytest.mark.parametrize("quant", [False, True])
def test_prefill_chunk_step_matches_jax(weights, quant):
    """A prompt of 27 tokens in chunks of 16 into slot 1 of a 3-slot
    cache: after the final (partial) chunk, the slot's rows [0, 27) within
    1e-5 (int8: the int8 values within one step, the scales within 1e-5)
    and untouched slots unchanged; the chunks' tokens equal the JAX
    program's, greedy and seeded sampled (keyed at start + chunk_len)."""
    jparams, tparams = weights["scaled"]
    model = DecoderLM(TCFG, tparams)
    ids = np.random.default_rng(50).integers(2, 128, 27).astype(np.int32)
    C, slot = 16, 1
    jc = jkvc.init_cache(JCFG, 3, S, jnp.float32, quant=quant)
    tc = tkvc.init_cache(TCFG, 3, S, torch.float32, device="cpu",
                         quant=quant)
    for temp, seed in ((0.0, 0), (0.8, 12345)):
        for start in (0, C):
            chunk = ids[start:start + C]
            tokens = np.zeros((1, C), np.int32)
            tokens[0, :len(chunk)] = chunk
            jc, jtok = jax_chunk_step(
                JCFG, jparams, jc, jnp.asarray(tokens), jnp.int32(start),
                jnp.int32(slot), jnp.int32(len(chunk)),
                jax.random.PRNGKey(0), jnp.float32(temp), jnp.int32(20),
                jnp.float32(0.9), seed=jnp.uint32(seed))
            tc, ttok = port_chunk_step(
                model, tc, _t(tokens), start, slot, len(chunk),
                torch.tensor([temp]), torch.tensor([20], dtype=torch.int32),
                torch.tensor([0.9]), torch.tensor([seed]))
            assert int(ttok[0]) == int(jtok)
    for name in jc:
        ref = np.asarray(jc[name])[:, slot, :, :27]
        got = tc[name].numpy()[:, slot, :, :27]
        if name in ("k", "v") and quant:
            assert np.abs(got.astype(np.int32) - ref).max() <= 1
            assert (got == ref).mean() > 0.99
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
        assert not tc[name][:, [0, 2]].any()


# -- the engines ---------------------------------------------------------------

BASE = dict(max_decode_slots=4, max_cache_len=64, prefill_buckets=(8, 16, 32),
            dtype="float32", paged=False)
SAMPLED = dict(temperature=0.8, top_p=0.9, top_k=20, ignore_eos=True)
SPEC = dict(spec_decode=True, spec_k=4, spec_ngram=3)
KV_DTYPES = pytest.mark.parametrize("kv_dtype", ["auto", "int8"])


def _prompts(lengths, seed):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(2, 128, n)] for n in lengths]


def _engines(jcfg, jparams, tcfg, tparams, draft=False, **serving):
    serving = {**BASE, **serving}
    je = JEngine(jcfg, jparams, JServing(weights_dtype="bf16",
                                         prefix_cache=False, **serving),
                 draft=(jcfg, jparams) if draft else None)
    te = TEngine(tcfg, tparams, TServing(weights_dtype="bf16",
                                         prefix_cache=False, **serving),
                 device="cpu", draft=(tcfg, tparams) if draft else None)
    return je, te


def _run(engine, prompts, max_tokens, **req):
    cls = JRequest if isinstance(engine, JEngine) else TRequest
    req = req or dict(ignore_eos=True)
    reqs = [engine.submit(cls(prompt_ids=list(p), max_tokens=max_tokens,
                              **req)) for p in prompts]
    for _ in range(10000):
        if not engine.step():
            break
    return reqs


def _run_both(weights, prompts, max_tokens, name="scaled", **serving):
    jparams, tparams = weights[name]
    je, te = _engines(JCFG, jparams, TCFG, tparams, **serving)
    jr, tr = _run(je, prompts, max_tokens), _run(te, prompts, max_tokens)
    for a, b in zip(jr, tr):
        assert b.generated == a.generated, (a.generated, b.generated)
        assert b.finish_reason == a.finish_reason
    assert te.allocator is None and te.table is None
    assert ("ks" in te.cache) == (serving.get("kv_dtype") == "int8")
    return je, te, tr


@KV_DTYPES
def test_dense_greedy_streams_match_jax(weights, kv_dtype):
    """Six requests over four slots: batched prefill, the decode horizon,
    admission into freed slots (whose lengths stay, as in the JAX engine),
    and a request that runs into the end of its slot's window."""
    je, te, tr = _run_both(weights, _prompts((5, 12, 3, 21, 9, 30), seed=1),
                           40, kv_dtype=kv_dtype)
    assert te.counts["prefill_dispatches"] >= 2
    assert te.counts["decode_dispatches"] > 0
    assert te.counts["chunk_dispatches"] == 0
    assert [r.finish_reason for r in tr].count("length") == 6
    assert len(tr[5].generated) == te.max_len - 30 - 1
    assert len(set(tuple(r.generated) for r in tr)) > 1
    assert tuple(te.cache["k"].shape) == (TCFG.num_layers, 4,
                                          TCFG.num_kv_heads, 64,
                                          TCFG.head_dim)
    np.testing.assert_array_equal(te.lengths, je.lengths)
    assert te.lengths.any()


@KV_DTYPES
def test_dense_chunk_walk_streams_match_jax(weights, kv_dtype):
    """prefill_chunk 16: the prompts of 30 and 40 tokens walk in chunks
    through prefill_chunk_step, one horizon-1 decode dispatch of the
    running requests between two chunks."""
    before = tda.launch_counts()
    _, te, _ = _run_both(weights, _prompts((5, 30, 12, 3, 40, 9), seed=2), 14,
                         prefill_chunk=16, kv_dtype=kv_dtype)
    assert te.counts["chunk_dispatches"] >= 5
    assert te.counts["mixed_dispatches"] == 0
    assert tda.launch_counts() == before                   # CPU: plain


def test_dense_chunk_walk_alternates_chunks_and_decode_steps(weights):
    """The walk's order decides which dispatch samples when: with a slot
    running, chunk, horizon-1 decode, chunk, ... as the JAX engine walks."""
    _, tparams = weights["scaled"]
    te = TEngine(TCFG, tparams, TServing(weights_dtype="bf16", **BASE,
                                         prefill_chunk=8), device="cpu")
    order = []
    for name in ("_advance_chunk_dense", "_decode"):
        fn = getattr(te, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            order.append((_name, kw.get("max_horizon")))
            return _fn(*a, **kw)

        setattr(te, name, wrapped)
    te.submit(TRequest(prompt_ids=_prompts((5,), 3)[0], max_tokens=40,
                       ignore_eos=True))
    te.step()                                      # batched prefill
    te.submit(TRequest(prompt_ids=_prompts((30,), 4)[0], max_tokens=4,
                       ignore_eos=True))
    while te._chunk is not None or te.pending:
        te.step()
    assert order == [("_advance_chunk_dense", None), ("_decode", 1)] * 3 \
        + [("_advance_chunk_dense", None)]


@KV_DTYPES
def test_dense_bblock_streams_match_jax(weights, kv_dtype):
    """decode_bblock 2 (and 3, fitted down to 2 over four slots) with the
    chunk walk: the same streams as the JAX engine's."""
    for bb in (2, 3):
        _, te, _ = _run_both(weights, _prompts((5, 30, 12, 3, 21, 9),
                                               seed=5), 16,
                             prefill_chunk=16, decode_bblock=bb,
                             kv_dtype=kv_dtype)
        assert te.decode_bblock == 2


def _lookup_prompts(seed):
    """A repetitive prompt and a random one ending in a repeat: the
    proposer fires (as tests/test_torch_spec_decode.py builds them)."""
    rng = np.random.default_rng(seed)
    pat = rng.integers(2, 128, 4).tolist()
    return [pat * 4, rng.integers(2, 128, 11).tolist() + pat * 2]


@KV_DTYPES
def test_dense_prompt_lookup_streams_match_jax_and_plain(weights, kv_dtype):
    """Prompt lookup over the dense cache (K9 writes the verify's R rows in
    one launch, K7 attends them): greedy streams equal the JAX dense
    engine's with prompt lookup and the port's without, drafts accepted."""
    prompts = _lookup_prompts(1)
    jparams, tparams = weights["plain"]
    je, te = _engines(JCFG, jparams, TCFG, tparams, kv_dtype=kv_dtype,
                      **SPEC)
    _, plain = _engines(JCFG, jparams, TCFG, tparams, kv_dtype=kv_dtype)
    got = [r.generated for r in _run(te, prompts, 24)]
    assert got == [r.generated for r in _run(je, prompts, 24)] \
        == [r.generated for r in _run(plain, prompts, 24)]
    assert te.counts["spec_dispatches"] > 0
    assert 0 < te.counts["spec_accepted_tokens"] \
        <= te.counts["spec_drafted_tokens"]


def test_dense_self_draft_streams_match_jax(weights):
    """A self-draft beside the dense target cache (the draft keeps its own
    unquantized dense cache): streams equal to the JAX dense draft engine's
    and to plain decode, drafts accepted."""
    jparams, tparams = weights["scaled"]
    prompts = [[5, 6, 7, 8, 9, 10], [11, 3, 2, 13, 2, 7, 9]]
    kw = dict(kv_dtype="int8", decode_horizon=6, spec_decode=True, spec_k=4,
              spec_method="draft")
    je, te = _engines(JCFG, jparams, TCFG, tparams, draft=True, **kw)
    _, plain = _engines(JCFG, jparams, TCFG, tparams, kv_dtype="int8")
    got = [r.generated for r in _run(te, prompts, 24)]
    assert got == [r.generated for r in _run(je, prompts, 24)] \
        == [r.generated for r in _run(plain, prompts, 24)]
    assert te.counts["spec_accepted_tokens"] > 0
    assert "ks" in te.cache and "ks" not in te.draft.cache


@KV_DTYPES
def test_dense_windowed_streams_match_jax(kv_dtype):
    """tiny_mistral (window 8) on the dense engine: batched prefill, the
    chunk walk and decode_bblock 2, 30 tokens per request (several windows
    past the window)."""
    jcfg = jax_mistral()
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    jparams = _scaled(init_params(jcfg, jax.random.PRNGKey(0),
                                  dtype=jnp.float32))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg)
    je, te = _engines(jcfg, jparams, tcfg, tparams, kv_dtype=kv_dtype,
                      prefill_chunk=16, decode_bblock=2)
    prompts = _prompts((5, 30, 12, 21, 40), seed=6)
    got = [r.generated for r in _run(te, prompts, 30)]
    assert got == [r.generated for r in _run(je, prompts, 30)]
    assert len(set(map(tuple, got))) > 1 and te.cfg.sliding_window == 8
    assert te.counts["chunk_dispatches"] >= 4


@KV_DTYPES
def test_dense_seeded_sampled_streams_match_jax(weights, kv_dtype):
    """Sampled requests with their own seeds, one under a pinned
    derived_seed, and a greedy one; the prompts of 30 and 40 tokens walk in
    chunks, so the final chunk's draw is keyed too."""
    jparams, tparams = weights["scaled"]
    je, te = _engines(JCFG, jparams, TCFG, tparams, prefill_chunk=16,
                      derived_seed=1234, kv_dtype=kv_dtype)
    prompts = _prompts((5, 30, 12, 40, 9, 7), seed=7)
    seeds = [11, 2**32 + 5, None, 2**31, 0, 77]
    out = []
    for eng, cls in ((je, JRequest), (te, TRequest)):
        reqs = [eng.submit(cls(prompt_ids=p, max_tokens=12, seed=s,
                               **(dict(ignore_eos=True) if i == 4
                                  else SAMPLED)))
                for i, (p, s) in enumerate(zip(prompts, seeds))]
        for _ in range(10000):
            if not eng.step():
                break
        out.append(reqs)
    for a, b in zip(*out):
        assert b.eff_seed == a.eff_seed
        assert b.generated == a.generated, (a.seed, a.generated, b.generated)
    assert len({t for r in out[1] for t in r.generated}) > 12
    assert te.counts["chunk_dispatches"] >= 4


def test_dense_seeded_stream_does_not_depend_on_the_batch(weights):
    """The same seeded request alone, then admitted while three others run
    and one walks in chunks beside it (int8 KV, decode_bblock 2): the
    same stream."""
    _, tparams = weights["scaled"]
    te = TEngine(TCFG, tparams, TServing(weights_dtype="bf16", **BASE,
                                         kv_dtype="int8", decode_bblock=2,
                                         prefill_chunk=16), device="cpu")
    prompt = _prompts((11,), seed=8)[0]
    alone = te.submit(TRequest(prompt_ids=prompt, max_tokens=16, seed=4242,
                               **SAMPLED))
    te.run_until_idle()
    others = [te.submit(TRequest(prompt_ids=p, max_tokens=20, seed=i,
                                 **SAMPLED))
              for i, p in enumerate(_prompts((6, 20, 13), seed=9))]
    while te.pending or len(te._active_slots()) < len(others):
        te.step()
    crowded = te.submit(TRequest(prompt_ids=prompt, max_tokens=16,
                                 seed=4242, **SAMPLED))
    te.run_until_idle()
    assert crowded.generated == alone.generated
    assert all(len(r.generated) == 20 for r in others)
    assert not te.temps.any()


def test_dense_engine_needs_cuda_unless_asked_for_the_cpu(monkeypatch,
                                                          weights):
    _, tparams = weights["scaled"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TEngine(TCFG, tparams, TServing(**BASE))
    te = TEngine(TCFG, tparams, TServing(**BASE, kv_dtype="int8"),
                 device="cpu")
    assert te.cache["k"].dtype == torch.int8 and te.cache["ks"].dim() == 4


def test_server_takes_decode_bblock_and_no_paged_flag(monkeypatch):
    """--decode-bblock reaches ServingConfig (the JAX server's flag); the
    dense engine has no flag of its own, as in the JAX server."""
    seen = {}

    class Built(Exception):
        pass

    def build_state(serving, **kw):
        seen["serving"] = serving
        raise Built

    monkeypatch.setattr(tserver, "build_state", build_state)
    with pytest.raises(Built):
        tserver.main(["--model", "tiny-qwen3", "--device", "cpu",
                      "--decode-bblock", "4"])
    assert seen["serving"].decode_bblock == 4 and seen["serving"].paged
    with pytest.raises(SystemExit):
        tserver.main(["--model", "tiny-qwen3", "--paged"])
