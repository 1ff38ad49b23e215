"""Sliding-window attention in the port against the JAX package.

Kernels: the plain versions (the CPU side of every wrapper, and what the
CUDA kernels are held to on the card) against the Pallas kernels run in
interpret mode on the same numpy-seeded inputs, with windows of 8 and 12
over pages of 8 rows (12 starts windows mid-page) at lengths past the window
by more than two pages, so that pages below the window start are skipped:
K1 (``decode_attend_pallas_paged``, ``ragged_attend_pallas_paged``,
``decode_attend_pallas_spec_paged``; float32 and int8 pools), K4
(``decode_attend_pallas_layer``) and K7 (``decode_attend_pallas_spec``).
Tolerance: max abs 1e-5; both sides accumulate in float32 and differ only
in summation order. The JAX verify starts all R rows at row 0's window
start, the port each packed row at its own: the same result (see
``ops/paged_attention.paged_attention_spec_plain``).

Model and engine: ``causal_attend`` with a window and the tiny_mistral
forward within 1e-5 of JAX; the engine's greedy streams (float32 and int8
KV, chunked prefill, prompt-lookup speculation, a windowed self-draft) and
seeded sampled streams byte-identical to the JAX engine's on tiny_mistral
(window 8), generating several windows past the window.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aws_k8s_ansible_provisioner_tpu.config import ServingConfig as JServing
from aws_k8s_ansible_provisioner_tpu.config import tiny_mistral as jax_tiny
from aws_k8s_ansible_provisioner_tpu.models import layers as jl
from aws_k8s_ansible_provisioner_tpu.ops import pallas_attention as pa
from aws_k8s_ansible_provisioner_tpu.serving.engine import Engine as JEngine
from aws_k8s_ansible_provisioner_tpu.serving.engine import Request as JRequest
from aws_k8s_ansible_provisioner_tpu_torch.config import (ModelConfig,
                                                          tiny_mistral)
from aws_k8s_ansible_provisioner_tpu_torch.config import \
    ServingConfig as TServing
from aws_k8s_ansible_provisioner_tpu_torch.models import layers as tl
from aws_k8s_ansible_provisioner_tpu_torch.models.convert import \
    from_jax_params
from aws_k8s_ansible_provisioner_tpu_torch.ops import dense_attention as tda
from aws_k8s_ansible_provisioner_tpu_torch.ops import paged_attention as tpa
from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import \
    Engine as TEngine
from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import \
    Request as TRequest

torch.set_num_threads(2)

TOL = 1e-5
L, HKV, HQ, D, PS, MAXP = 2, 2, 4, 16, 8, 6
WINDOWS = pytest.mark.parametrize("window", [8, 12])
QUANT = pytest.mark.parametrize("quant", [False, True])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pool(n_rows, quant, seed):
    """A pool of shuffled pages (page 0 = scratch) and one table row per
    row; float32 or int8 with scales."""
    rng = np.random.default_rng(seed)
    shape = (L, n_rows * MAXP + 1, HKV, PS, D)
    if quant:
        pool = {"k": rng.integers(-127, 128, shape).astype(np.int8),
                "v": rng.integers(-127, 128, shape).astype(np.int8),
                "ks": rng.uniform(1e-3, 0.1, shape[:-1]).astype(np.float32),
                "vs": rng.uniform(1e-3, 0.1, shape[:-1]).astype(np.float32)}
    else:
        pool = {n: rng.standard_normal(shape).astype(np.float32)
                for n in ("k", "v")}
    table = (rng.permutation(n_rows * MAXP) + 1).reshape(
        n_rows, MAXP).astype(np.int32)
    return rng, pool, table


def _garbage_outside(rng, table, lo, hi):
    """Table entries below each row's first visited page and past its last
    one: random valid page ids (neither side may depend on them)."""
    out = table.copy()
    P = table.size + 1
    for n in range(len(out)):
        out[n, :lo[n]] = rng.integers(0, P, lo[n])
        out[n, hi[n] + 1:] = rng.integers(0, P, MAXP - hi[n] - 1)
    return out


def _pages(limits, window):
    lo, hi = tpa._live_pages(_t(np.asarray(limits, np.int32)), PS, MAXP,
                             window)
    return lo.numpy(), hi.numpy()


def _jax_kw(pool, window):
    kw = {"interpret": True, "window": window}
    if "ks" in pool:
        kw.update(pool_ks=jnp.asarray(pool["ks"]),
                  pool_vs=jnp.asarray(pool["vs"]))
    return kw


def _port_kw(pool):
    return ({"pool_ks": _t(pool["ks"]), "pool_vs": _t(pool["vs"])}
            if "ks" in pool else {})


def _window_matters(port_fn, got, window):
    """The window-0 result differs from the windowed one at these lengths."""
    full = port_fn(0).numpy()
    assert np.abs(full - got).max() > 1e-3, window


# -- K1: paged decode, ragged and verify ---------------------------------------


@QUANT
@WINDOWS
def test_paged_decode_window_matches_pallas(quant, window):
    """Rows below, at and beyond the window, window starts on and off page
    edges; pages below each row's window start hold garbage table ids."""
    lengths = np.array([1, 5, window, window + 1, 20, 29, 33, 48], np.int32)
    B = len(lengths)
    rng, pool, table = _pool(B, quant, seed=10 + window + quant)
    table = _garbage_outside(rng, table, *_pages(lengths, window))
    q = rng.standard_normal((B, 1, HQ, D)).astype(np.float32)
    ref = pa.decode_attend_pallas_paged(
        jnp.asarray(q), jnp.asarray(pool["k"]), jnp.asarray(pool["v"]),
        jnp.asarray(lengths), jnp.int32(1), jnp.asarray(table),
        **_jax_kw(pool, window))

    def port(w):
        return tpa.decode_attend_paged(
            _t(q), _t(pool["k"]), _t(pool["v"]), _t(lengths), 1, _t(table),
            **_port_kw(pool), window=w)

    got = port(window).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=TOL)
    _window_matters(port, got, window)


@QUANT
@WINDOWS
def test_paged_ragged_window_matches_pallas(quant, window):
    """mixed_step's layout: decode rows of five slots (one the dead
    passenger, limit 0: the mean of V over its first page, C2), then ten
    chunk rows of one slot crossing the window's page edges."""
    B, C, pslot, pstart = 5, 10, 2, 26
    lengths = np.array([4, 30, 0, 11, 45], np.int32)
    limits = np.concatenate([lengths, pstart + np.arange(C) + 1]) \
        .astype(np.int32)
    rng, pool, table = _pool(B, quant, seed=30 + window + quant)
    tables = np.concatenate([table, np.repeat(table[pslot][None], C, 0)])
    tables = _garbage_outside(rng, tables, *_pages(limits, window))
    q = rng.standard_normal((B + C, HQ, D)).astype(np.float32)
    ref = np.asarray(pa.ragged_attend_pallas_paged(
        jnp.asarray(q), jnp.asarray(pool["k"]), jnp.asarray(pool["v"]),
        jnp.asarray(limits), jnp.int32(0), jnp.asarray(tables),
        **_jax_kw(pool, window)))

    def port(w):
        return tpa.ragged_attend_paged(
            _t(q), _t(pool["k"]), _t(pool["v"]), _t(limits), 0, _t(tables),
            **_port_kw(pool), window=w)

    got = port(window).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    _window_matters(port, got, window)
    assert np.all(np.isfinite(got[pslot])) and np.abs(got[pslot]).sum() > 0


@QUANT
@WINDOWS
def test_paged_verify_window_matches_pallas(quant, window):
    """R = 5 rows per slot: the JAX verify walks every row from row 0's
    window start, the port each packed row from its own; lengths whose R
    rows move the window start across a page edge."""
    R = 5
    lengths = np.array([0, 3, 6, window - 1, 14, 20, 27, 43], np.int32)
    B = len(lengths)
    rng, pool, table = _pool(B, quant, seed=50 + window + quant)
    lo0, _ = _pages(lengths + 1, window)
    _, hi = _pages(lengths + R, window)
    table = _garbage_outside(rng, table, lo0, hi)
    q = rng.standard_normal((B, R, HQ, D)).astype(np.float32)
    ref = pa.decode_attend_pallas_spec_paged(
        jnp.asarray(q), jnp.asarray(pool["k"]), jnp.asarray(pool["v"]),
        jnp.asarray(lengths), jnp.int32(1), jnp.asarray(table),
        **_jax_kw(pool, window))

    def port(w):
        return tpa.decode_attend_spec_paged(
            _t(q), _t(pool["k"]), _t(pool["v"]), _t(lengths), 1, _t(table),
            **_port_kw(pool), window=w)

    got = port(window).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=TOL)
    _window_matters(port, got, window)


@QUANT
def test_plain_version_reads_no_page_below_the_window(quant):
    """Table entries below each row's window start point at a page of NaN
    (int8: NaN scales): the plain version gathers only its rows' pages
    lo..hi, so its output stays finite and equal to the clean table's."""
    window = 12
    lengths = np.array([3, 13, 20, 31, 48], np.int32)
    B = len(lengths)
    rng, pool, table = _pool(B, quant, seed=70 + quant)
    lo, _ = _pages(lengths, window)
    assert lo.max() >= 2
    poisoned = {n: a.copy() for n, a in pool.items()}
    nan = 0                                  # the scratch page, unused
    for n in (("ks", "vs") if quant else ("k", "v")):
        poisoned[n][:, nan] = np.nan
    bad = table.copy()
    for n in range(B):
        bad[n, :lo[n]] = nan
    q = _t(rng.standard_normal((B, 1, HQ, D)).astype(np.float32))

    def run(p, tab):
        return tpa.decode_attend_paged(q, _t(p["k"]), _t(p["v"]),
                                       _t(lengths), 0, _t(tab),
                                       **_port_kw(p), window=window)

    clean, dirty = run(pool, table), run(poisoned, bad)
    assert torch.isfinite(dirty).all()
    assert torch.equal(clean, dirty)


# -- K4 and K7: the dense cache ----------------------------------------------


def _dense(B, S, seed):
    rng = np.random.default_rng(seed)
    ck, cv = (rng.standard_normal((L, B, HKV, S, D)).astype(np.float32)
              for _ in range(2))
    return rng, ck, cv


@WINDOWS
def test_dense_decode_window_matches_pallas(window):
    """K4: lengths 0 (zeros, C8), below, at and beyond the window, with
    whole 16-row chunks below the window start skipped by the Pallas
    kernel."""
    S = 64
    lengths = np.array([0, 1, window, window + 3, 30, 47, 64], np.int32)
    B = len(lengths)
    rng, ck, cv = _dense(B, S, seed=80 + window)
    q = rng.standard_normal((B, 1, HQ, D)).astype(np.float32)
    ref = np.asarray(pa.decode_attend_pallas_layer(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
        jnp.asarray(lengths), jnp.int32(1), chunk=16, interpret=True,
        window=window))

    def port(w):
        return tda.decode_attend_dense(_t(q), _t(ck), _t(cv), _t(lengths),
                                       1, w)

    got = port(window).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    assert not got[0].any()
    _window_matters(port, got, window)


@WINDOWS
def test_dense_verify_window_matches_pallas(window):
    """K7: R = 5 rows per slot, row r's window off its own limit."""
    S, R = 64, 5
    lengths = np.array([0, 4, window - 1, 21, 40, S - R], np.int32)
    B = len(lengths)
    rng, ck, cv = _dense(B, S, seed=90 + window)
    q = rng.standard_normal((B, R, HQ, D)).astype(np.float32)
    ref = np.asarray(pa.decode_attend_pallas_spec(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
        jnp.asarray(lengths), jnp.int32(0), chunk=16, interpret=True,
        window=window))

    def port(w):
        return tda.spec_attend_dense(_t(q), _t(ck), _t(cv), _t(lengths), 0,
                                     w)

    got = port(window).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    _window_matters(port, got, window)


# -- the model -----------------------------------------------------------------

JCFG = jax_tiny()
TCFG = ModelConfig(**dataclasses.asdict(JCFG))


def _scaled(params):
    """Projection kernels and the embedding times 8, so that greedy streams
    do not collapse onto one repeated token and logits are of order one."""
    def go(node):
        return {k: go(v) if isinstance(v, dict) else
                v * 8 if k == "kernel" else v for k, v in node.items()}

    out = go(params)
    out["embed"] = {"weight": params["embed"]["weight"] * 8}
    return out


def test_tiny_mistral_is_the_jax_config():
    assert dataclasses.asdict(tiny_mistral()) == dataclasses.asdict(JCFG)
    assert TCFG.sliding_window == 8


@pytest.mark.parametrize("window", [0, 5, 8])
def test_causal_attend_window_matches_jax(window):
    """Right-padded rows; each query sees its last ``window`` keys."""
    rng = np.random.default_rng(window)
    q = rng.standard_normal((2, 13, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 13, 2, 16)).astype(np.float32)
            for _ in range(2))
    lens = np.array([13, 9], np.int32)
    ref = jl.causal_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           seq_lens=jnp.asarray(lens), window=window)
    got = tl.causal_attend(_t(q), _t(k), _t(v), seq_lens=_t(lens),
                           window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=TOL)


@pytest.fixture(scope="module")
def weights():
    """(JAX params, port params), tiny_mistral at float32: the JAX init
    scaled by 8, and the JAX init as it is (whose greedy streams loop, so
    prompt lookup fires)."""
    out = {}
    for name, seed, scale in (("scaled", 0, True), ("plain", 4, False)):
        jp = jl.init_params(JCFG, jax.random.PRNGKey(seed),
                            dtype=jnp.float32)
        jp = _scaled(jp) if scale else jp
        out[name] = (jp, from_jax_params(jax.tree.map(np.asarray, jp), TCFG))
    return out


def test_tiny_mistral_logits_match_jax(weights):
    """20 tokens (2.5 windows): the default attend honours the window."""
    jparams, tparams = weights["scaled"]
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, JCFG.vocab_size, (2, 20)).astype(np.int32)
    positions = np.stack([np.arange(20), np.arange(7, 27)]).astype(np.int32)
    ref, _ = jl.model_forward(jparams, JCFG, jnp.asarray(tokens),
                              jnp.asarray(positions))
    got = tl.model_forward(tparams, TCFG, _t(tokens).long(),
                           _t(positions).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=TOL)
    full = tl.model_forward(tparams, TCFG.scaled(sliding_window=0),
                            _t(tokens).long(), _t(positions).long())
    assert np.abs(full.numpy() - got.numpy()).max() > 1e-2


# -- the engines ---------------------------------------------------------------

BASE = dict(max_decode_slots=4, max_cache_len=64, page_size=8,
            prefill_buckets=(8, 16, 32), dtype="float32")
SAMPLED = dict(temperature=0.8, top_p=0.9, top_k=20, ignore_eos=True)


def _serving(kv_dtype="auto", **over):
    kw = {**BASE, **over, "kv_dtype": kv_dtype}
    if kv_dtype == "int8":
        kw["page_size"] = 32    # the JAX engine's int8 row write needs 32
    return kw


def _jax_engine(jparams, draft=None, **kw):
    return JEngine(JCFG, jparams, JServing(weights_dtype="bf16",
                                           prefix_cache=False, **kw),
                   draft=draft)


def _port_engine(tparams, draft=None, **kw):
    return TEngine(TCFG, tparams, TServing(weights_dtype="bf16",
                                           prefix_cache=False, **kw),
                   device="cpu", draft=draft)


def _run(engine, prompts, max_tokens, **req):
    cls = JRequest if isinstance(engine, JEngine) else TRequest
    req = req or dict(ignore_eos=True)
    reqs = [engine.submit(cls(prompt_ids=list(p), max_tokens=max_tokens,
                              **req)) for p in prompts]
    for _ in range(10000):
        if not engine.step():
            break
    return [r.generated for r in reqs]


def _prompts(lengths, seed):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(2, 128, n)] for n in lengths]


@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
def test_windowed_greedy_streams_match_jax(weights, kv_dtype):
    """Six requests over four slots, 30 tokens each: the decode horizon
    runs up to five windows past the window of 8."""
    jparams, tparams = weights["scaled"]
    prompts = _prompts((5, 12, 3, 21, 9, 30), seed=1)
    ref = _run(_jax_engine(jparams, **_serving(kv_dtype)), prompts, 30)
    te = _port_engine(tparams, **_serving(kv_dtype))
    got = _run(te, prompts, 30)
    assert got == ref
    assert all(len(g) == 30 for g in got) and len(set(map(tuple, got))) > 1
    assert ("ks" in te.cache) == (kv_dtype == "int8")


@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
def test_windowed_chunked_prefill_streams_match_jax(weights, kv_dtype):
    """prefill_chunk 16: prompts of 30 and 40 tokens (four and five
    windows) walk in chunks beside the decode rows; the chunk rows attend
    through the ragged kernel's window."""
    jparams, tparams = weights["scaled"]
    prompts = _prompts((5, 30, 12, 40), seed=2)
    kw = _serving(kv_dtype, prefill_chunk=16)
    ref = _run(_jax_engine(jparams, **kw), prompts, 20)
    te = _port_engine(tparams, **kw)
    assert _run(te, prompts, 20) == ref
    assert te.counts["mixed_dispatches"] >= 4


SPEC = dict(spec_decode=True, spec_k=4, spec_ngram=3)


def test_windowed_prompt_lookup_stream_matches_jax(weights):
    """The stream of the JAX package's
    test_spec_decode_windowed_stream_identity (a looping prompt, spec_k 4,
    24 tokens): the same as the JAX engine's and the port's without
    speculation. Its model's stream does not repeat itself, so the proposer
    finds few n-grams; the next test makes one that does."""
    jparams, tparams = weights["plain"]
    pat = [3, 4, 5, 6] * 4
    kw = dict(max_decode_slots=2, max_cache_len=64, page_size=8,
              prefill_buckets=(16,), dtype="float32", decode_horizon=4)
    ref = _run(_port_engine(tparams, **kw), [pat], 24)
    jgot = _run(_jax_engine(jparams, **kw, **SPEC), [pat], 24)
    assert _run(_port_engine(tparams, **kw, **SPEC), [pat], 24) \
        == jgot == ref


@pytest.fixture(scope="module")
def looping():
    """tiny_mistral with tied embeddings, the JAX init scaled by 4: greedy
    streams that run a token for a few steps and then move on, so prompt
    lookup proposes drafts that are accepted and drafts that are not."""
    jcfg = jax_tiny(tie_embeddings=True)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    jp = jl.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)

    def go(node):
        return {k: go(v) if isinstance(v, dict) else
                v * 4 if k == "kernel" else v for k, v in node.items()}

    jp = go(jp)
    jp["embed"] = {"weight": jp["embed"]["weight"] * 4}
    return jcfg, jp, tcfg, from_jax_params(jax.tree.map(np.asarray, jp),
                                           tcfg)


@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
def test_windowed_verify_streams_match_jax(looping, kv_dtype):
    """Prompt lookup on repeated-pattern prompts, 40 tokens (up to 56 rows,
    seven windows): the verify's R rows attend through the window; streams
    equal to the JAX spec engine's and to the port's without speculation,
    with drafts both accepted and rejected."""
    jcfg, jparams, tcfg, tparams = looping
    rng = np.random.default_rng(0)
    pat = rng.integers(2, 128, 4).tolist()
    prompts = [pat * 4, rng.integers(2, 128, 11).tolist() + pat * 2]
    kw = _serving(kv_dtype, max_cache_len=128, prefill_buckets=(32,),
                  decode_horizon=4)
    ref = _run(TEngine(tcfg, tparams, TServing(weights_dtype="bf16",
                                               prefix_cache=False, **kw),
                       device="cpu"), prompts, 40)
    jgot = _run(JEngine(jcfg, jparams, JServing(
        weights_dtype="bf16", prefix_cache=False, **kw, **SPEC)),
        prompts, 40)
    te = TEngine(tcfg, tparams, TServing(weights_dtype="bf16",
                                         prefix_cache=False, **kw,
                                         **SPEC), device="cpu")
    assert _run(te, prompts, 40) == jgot == ref
    drafted = te.counts["spec_drafted_tokens"]
    assert 0 < te.counts["spec_accepted_tokens"] < drafted


def test_windowed_self_draft_streams_match_jax(weights):
    """A self-draft with the window over its dense cache (K4 rollout, K7
    catch-up): streams equal to the JAX draft engine's and to plain decode,
    drafts accepted; 30 tokens past prompts of 6 and 7."""
    jparams, tparams = weights["scaled"]
    prompts = [[5, 6, 7, 8, 9, 10], [11, 3, 2, 13, 2, 7, 9]]
    kw = _serving(max_cache_len=128, decode_horizon=6)
    draft = dict(spec_decode=True, spec_k=4, spec_method="draft")
    ref = _run(_port_engine(tparams, **kw), prompts, 30)
    jgot = _run(_jax_engine(jparams, draft=(JCFG, jparams), **kw, **draft),
                prompts, 30)
    te = _port_engine(tparams, draft=(TCFG, tparams), **kw, **draft)
    assert _run(te, prompts, 30) == jgot == ref
    assert te.counts["spec_accepted_tokens"] > 0
    assert te.draft.cfg.sliding_window == 8


def test_windowed_seeded_sampled_streams_match_jax(weights):
    """Sampled requests with their own seeds (one prompt chunked) and a
    greedy one: streams byte-identical to the JAX engine's."""
    jparams, tparams = weights["scaled"]
    prompts = _prompts((5, 30, 12), seed=5)
    kw = _serving(prefill_chunk=16)
    out = []
    for engine in (_jax_engine(jparams, **kw), _port_engine(tparams, **kw)):
        cls = JRequest if isinstance(engine, JEngine) else TRequest
        reqs = [engine.submit(cls(prompt_ids=p, max_tokens=24, seed=s,
                                  **SAMPLED))
                for p, s in zip(prompts, (11, 2**31, 7))]
        reqs.append(engine.submit(cls(prompt_ids=prompts[0], max_tokens=24,
                                      ignore_eos=True)))
        for _ in range(10000):
            if not engine.step():
                break
        out.append([r.generated for r in reqs])
    assert out[1] == out[0]
    assert out[1][0] != out[1][3]       # the draws really sample
