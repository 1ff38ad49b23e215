"""Speculative decoding in the port against the JAX package.

Kernels (plain versions, the CPU side of their wrappers) against the Pallas
kernels run in interpret mode on the same numpy-seeded float32 inputs:
K1-spec (``decode_attend_pallas_spec_paged``, bf16/f32-type and int8
pools), K4 (``decode_attend_pallas_layer``), K7
(``decode_attend_pallas_spec``) within 2e-5 (both sides accumulate in
float32 and differ only in summation order), and K8 (``cache_write_row``)
bit for bit. Then ``spec_decode_step`` against the JAX program on one pool
and one set of drafts (``out`` and ``accepted`` identical), and the engines:
prompt lookup (float32 and int8 KV) and the draft model (a self-draft and a
divergent one) give greedy streams byte-identical to the JAX engine's and
to the port's own without speculation, on tiny_qwen3 at float32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aws_k8s_ansible_provisioner_tpu.config import ServingConfig as JServing
from aws_k8s_ansible_provisioner_tpu.config import tiny_qwen3 as jax_tiny
from aws_k8s_ansible_provisioner_tpu.models.layers import init_params
from aws_k8s_ansible_provisioner_tpu.ops import pallas_attention as pa
from aws_k8s_ansible_provisioner_tpu.serving.engine import Engine as JEngine
from aws_k8s_ansible_provisioner_tpu.serving.engine import Request as JRequest
from aws_k8s_ansible_provisioner_tpu.serving.engine import \
    spec_decode_step as jax_spec_step
from aws_k8s_ansible_provisioner_tpu_torch.config import ModelConfig
from aws_k8s_ansible_provisioner_tpu_torch.config import \
    ServingConfig as TServing
from aws_k8s_ansible_provisioner_tpu_torch.models.convert import (
    from_jax_params, from_jax_pool)
from aws_k8s_ansible_provisioner_tpu_torch.models.layers import DecoderLM
from aws_k8s_ansible_provisioner_tpu_torch.ops import dense_attention as tda
from aws_k8s_ansible_provisioner_tpu_torch.ops import paged_attention as tpa
from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import \
    Engine as TEngine
from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import \
    Request as TRequest
from aws_k8s_ansible_provisioner_tpu_torch.serving.programs import \
    spec_decode_step as port_spec_step

torch.set_num_threads(2)

TOL = 2e-5
L, HKV, HQ, D, PS, MAXP = 2, 2, 4, 16, 8, 4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- K1-spec: R query rows per slot over the paged pool ---------------------


def _pool(B, quant, seed):
    rng = np.random.default_rng(seed)
    shape = (L, B * MAXP + 1, HKV, PS, D)
    if quant:
        pool = {"k": rng.integers(-127, 128, shape).astype(np.int8),
                "v": rng.integers(-127, 128, shape).astype(np.int8),
                "ks": rng.uniform(1e-3, 0.1, shape[:-1]).astype(np.float32),
                "vs": rng.uniform(1e-3, 0.1, shape[:-1]).astype(np.float32)}
    else:
        pool = {n: rng.standard_normal(shape).astype(np.float32)
                for n in ("k", "v")}
    table = (rng.permutation(B * MAXP) + 1).reshape(B, MAXP).astype(np.int32)
    return rng, pool, table


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("layer", [0, 1])
def test_spec_paged_attention_matches_pallas(quant, layer):
    """R = 5 rows per slot; lengths whose R rows cross a page edge, fill a
    page, or reach the window's last row; garbage table entries past each
    slot's pages (cdiv(lengths + R, page))."""
    B, R = 6, 5
    rng, pool, table = _pool(B, quant, seed=50 + layer + 2 * quant)
    lengths = np.array([0, 3, 6, 11, 20, MAXP * PS - R], np.int32)
    for b, n in enumerate(lengths):
        live = -(-(int(n) + R) // PS)
        table[b, live:] = rng.integers(0, B * MAXP + 1, MAXP - live)
    q = rng.standard_normal((B, R, HQ, D)).astype(np.float32)
    jp = {n: jnp.asarray(a) for n, a in pool.items()}
    kw = dict(pool_ks=jp["ks"], pool_vs=jp["vs"]) if quant else {}
    ref = pa.decode_attend_pallas_spec_paged(
        jnp.asarray(q), jp["k"], jp["v"], jnp.asarray(lengths),
        jnp.int32(layer), jnp.asarray(table), interpret=True, **kw)
    tp = from_jax_pool(pool)
    tkw = dict(pool_ks=tp["ks"], pool_vs=tp["vs"]) if quant else {}
    before = tpa.launch_counts()
    got = tpa.decode_attend_spec_paged(_t(q), tp["k"], tp["v"], _t(lengths),
                                       layer, _t(table), **tkw).numpy()
    assert tpa.launch_counts() == before                     # CPU: plain
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=TOL)


# -- K4, K7, K8: the dense slot cache ---------------------------------------

S = 128


def _dense(B, seed):
    rng = np.random.default_rng(seed)
    shape = (L, B, HKV, S, D)
    return rng, {n: rng.standard_normal(shape).astype(np.float32)
                 for n in ("k", "v")}


@pytest.mark.parametrize("layer", [0, 1])
def test_dense_decode_attention_matches_pallas(layer):
    """K4: lengths of one row, a tile edge, the full window."""
    B = 6
    rng, cache = _dense(B, seed=60 + layer)
    lengths = np.array([1, 31, 32, 64, 100, S], np.int32)
    q = rng.standard_normal((B, 1, HQ, D)).astype(np.float32)
    ref = pa.decode_attend_pallas_layer(
        jnp.asarray(q), jnp.asarray(cache["k"]), jnp.asarray(cache["v"]),
        jnp.asarray(lengths), jnp.int32(layer), chunk=32, interpret=True,
        bblock=1)
    got = tda.decode_attend_dense(_t(q), _t(cache["k"]), _t(cache["v"]),
                                  _t(lengths), layer).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=TOL)


def test_dense_decode_length_zero_returns_zeros():
    """ROADMAP C8: a dense decode row of length 0 accumulates nothing and
    returns zeros (the Pallas kernel's 0 / 1e-9), where the paged kernel
    returns the mean of V over its first page (C2)."""
    rng, cache = _dense(3, seed=63)
    lengths = np.array([0, 5, 0], np.int32)
    q = rng.standard_normal((3, 1, HQ, D)).astype(np.float32)
    ref = np.asarray(pa.decode_attend_pallas_layer(
        jnp.asarray(q), jnp.asarray(cache["k"]), jnp.asarray(cache["v"]),
        jnp.asarray(lengths), jnp.int32(0), chunk=32, interpret=True,
        bblock=1))
    got = tda.decode_attend_dense(_t(q), _t(cache["k"]), _t(cache["v"]),
                                  _t(lengths), 0).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    assert not got[0].any() and not got[2].any() and not ref[0].any()
    assert np.abs(got[1]).sum() > 0


@pytest.mark.parametrize("layer", [0, 1])
def test_dense_spec_attention_matches_pallas(layer):
    """K7: R = 5 rows per slot from length 0 to the window's last rows."""
    B, R = 6, 5
    rng, cache = _dense(B, seed=70 + layer)
    lengths = np.array([0, 2, 27, 31, 64, S - R], np.int32)
    q = rng.standard_normal((B, R, HQ, D)).astype(np.float32)
    ref = pa.decode_attend_pallas_spec(
        jnp.asarray(q), jnp.asarray(cache["k"]), jnp.asarray(cache["v"]),
        jnp.asarray(lengths), jnp.int32(layer), chunk=32, interpret=True)
    before = tda.launch_counts()
    got = tda.spec_attend_dense(_t(q), _t(cache["k"]), _t(cache["v"]),
                                _t(lengths), layer).numpy()
    assert tda.launch_counts() == before                     # CPU: plain
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=TOL)


@pytest.mark.parametrize("layer", [0, 1])
def test_dense_row_write_bit_identical_to_pallas(layer):
    """K8: kept rows at the window's edges and dropped rows (-1, S, far
    past S), one row per slot, K and V."""
    B = 6
    rng, cache = _dense(B, seed=80 + layer)
    rows = np.array([0, 7, S - 1, -1, S, 10**6], np.int32)
    new = rng.standard_normal((2, B, HKV, D)).astype(np.float32)
    ref = [np.asarray(pa.cache_write_row(
        jnp.asarray(cache[n]), jnp.asarray(new[i]), jnp.asarray(rows),
        jnp.int32(layer), interpret=True)) for i, n in enumerate("kv")]
    ck, cv = _t(cache["k"].copy()), _t(cache["v"].copy())
    tda.cache_write_rows_dense(ck, cv, _t(new[0][:, None]),
                               _t(new[1][:, None]), _t(rows[:, None]), layer)
    np.testing.assert_array_equal(ck.numpy(), ref[0])
    np.testing.assert_array_equal(cv.numpy(), ref[1])
    assert not np.array_equal(ref[0], cache["k"])


def test_dense_row_write_of_r_rows_equals_r_single_writes():
    """The verify writes R rows per slot in one call; the TPU kernel is
    called once per row. Both land the same rows."""
    B, R = 3, 4
    rng, cache = _dense(B, seed=85)
    rows = np.array([[0, 1, 2, 3], [60, 61, 62, 63], [S - 2, S - 1, S,
                                                      S + 1]], np.int32)
    new = rng.standard_normal((2, B, R, HKV, D)).astype(np.float32)
    ck, cv = _t(cache["k"].copy()), _t(cache["v"].copy())
    tda.cache_write_rows_dense(ck, cv, _t(new[0]), _t(new[1]), _t(rows), 1)
    refs = [jnp.asarray(cache[n]) for n in "kv"]
    for r in range(R):
        refs = [pa.cache_write_row(refs[i], jnp.asarray(new[i][:, r]),
                                   jnp.asarray(rows[:, r]), jnp.int32(1),
                                   interpret=True) for i in range(2)]
    np.testing.assert_array_equal(ck.numpy(), np.asarray(refs[0]))
    np.testing.assert_array_equal(cv.numpy(), np.asarray(refs[1]))


# -- spec_decode_step against the JAX program --------------------------------

JCFG = jax_tiny()
TCFG = ModelConfig(**dataclasses.asdict(JCFG))


def _scaled(params):
    """Weights scaled up so that greedy streams do not collapse onto one
    repeated token (as in tests/test_torch_engine.py)."""
    def scale(node):
        return {k: scale(v) if isinstance(v, dict) else
                v * 8 if k == "kernel" else v for k, v in node.items()}

    params = scale(params)
    params["embed"] = {"weight": params["embed"]["weight"] * 8}
    return params


@pytest.fixture(scope="module")
def weights():
    """(JAX params, port params): the JAX package's tiny_qwen3 init (whose
    greedy streams loop, so prompt lookup fires) and the same scaled."""
    out = {}
    for name, scale in (("plain", False), ("scaled", True)):
        jp = init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
        jp = _scaled(jp) if scale else jp
        out[name] = (jp, from_jax_params(jax.tree.map(np.asarray, jp), TCFG))
    return out


@pytest.mark.parametrize("quant", [False, True])
def test_spec_decode_step_matches_jax(weights, quant):
    """One verify over a random pool: slots whose drafts are the model's
    own argmax chain (all accepted), a chain broken at draft 2, random
    drafts, and a seeded sampled slot (accepts nothing, draws at
    lengths + 1). ``out`` and ``accepted`` identical to the JAX program."""
    jparams, tparams = weights["scaled"]
    B, R = 4, 5
    rng, pool, table = _pool(B, quant, seed=90 + quant)
    if not quant:
        pool = {n: a * 0.5 for n, a in pool.items()}
    lengths = np.array([3, 9, 14, 20], np.int32)
    temps = np.array([0.0, 0.0, 0.0, 0.8], np.float32)
    seeds = np.array([1, 2, 3, 7], np.uint32)
    top_k = np.zeros(B, np.int32)
    top_p = np.ones(B, np.float32)

    def run_jax(tokens):
        _, out, acc = jax_spec_step(
            JCFG, R, jparams, {n: jnp.asarray(a) for n, a in pool.items()},
            jnp.asarray(tokens), jnp.asarray(lengths),
            jax.random.PRNGKey(0), jnp.asarray(temps), jnp.asarray(top_k),
            jnp.asarray(top_p), impl="xla", table=jnp.asarray(table),
            seeds=jnp.asarray(seeds))
        return np.asarray(out), np.asarray(acc)

    tokens = rng.integers(2, 128, (B, R)).astype(np.int32)
    for i in range(R - 1):          # grow slots 0 and 1 to the argmax chain
        out, acc = run_jax(tokens)
        for b in (0, 1):
            if acc[b] == i + 1:
                tokens[b, i + 1] = out[b, i]
    tokens[1, 3] = (tokens[1, 3] + 1) % 128
    out, acc = run_jax(tokens)
    assert acc[0] == R and acc[1] == 3 and acc[3] == 1
    tpool = from_jax_pool(pool)
    _, got_out, got_acc = port_spec_step(
        DecoderLM(TCFG, tparams), R, tpool, _t(tokens), _t(lengths),
        _t(table), _t(temps), _t(top_k), _t(top_p), _t(seeds.astype(
            np.int64)))
    np.testing.assert_array_equal(got_acc.numpy(), acc)
    np.testing.assert_array_equal(got_out.numpy(), out)


# -- the engines --------------------------------------------------------------

BASE = dict(max_decode_slots=4, max_cache_len=128, page_size=8,
            prefill_buckets=(32,), dtype="float32", decode_horizon=4)
SPEC = dict(spec_decode=True, spec_k=4, spec_ngram=3)


def _serving(kv_dtype="auto", **over):
    kw = {**BASE, **over, "kv_dtype": kv_dtype}
    if kv_dtype == "int8":
        kw["page_size"] = 32    # the JAX engine's int8 row write needs 32
    return kw


def _run(engine, prompts, max_tokens=24, **req):
    cls = JRequest if isinstance(engine, JEngine) else TRequest
    reqs = [engine.submit(cls(prompt_ids=list(p), max_tokens=max_tokens,
                              ignore_eos=True, **req)) for p in prompts]
    for _ in range(10000):
        if not engine.step():
            break
    return [r.generated for r in reqs]


def _jax_engine(jparams, draft=None, **kw):
    return JEngine(JCFG, jparams, JServing(weights_dtype="bf16",
                                           prefix_cache=False, **kw),
                   draft=draft)


def _port_engine(tparams, draft=None, **kw):
    return TEngine(TCFG, tparams, TServing(weights_dtype="bf16",
                                           prefix_cache=False, **kw),
                   device="cpu", draft=draft)


def _lookup_prompts(seed):
    """A repetitive prompt and a random one ending in a repeat, as
    tests/test_spec_decode.py builds them: the proposer fires."""
    rng = np.random.default_rng(seed)
    pat = rng.integers(2, 128, 4).tolist()
    return [pat * 4, rng.integers(2, 128, 11).tolist() + pat * 2]


@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
@pytest.mark.parametrize("name", ["plain", "scaled"])
def test_prompt_lookup_streams_match_jax_and_plain(weights, kv_dtype, name):
    """Greedy streams with prompt lookup equal the JAX engine's with prompt
    lookup and the port's without (tests/test_spec_decode.py:45)."""
    jparams, tparams = weights[name]
    prompts = _lookup_prompts(1)
    serving = _serving(kv_dtype, **SPEC)
    ref = _run(_port_engine(tparams, **_serving(kv_dtype)), prompts)
    je = _jax_engine(jparams, **serving)
    jgot = _run(je, prompts)
    te = _port_engine(tparams, **serving)
    got = _run(te, prompts)
    assert got == jgot == ref
    assert ("ks" in te.cache) == (kv_dtype == "int8")
    assert te.counts["spec_dispatches"] > 0
    assert te.counts["spec_drafted_tokens"] > 0
    assert 0 <= te.counts["spec_accepted_tokens"] \
        <= te.counts["spec_drafted_tokens"]
    if name == "plain":       # the looping stream accepts its drafts
        assert te.counts["spec_accepted_tokens"] > 0
        assert je.metrics.spec_accepted_tokens.total() > 0


def test_verify_accepts_correct_drafts_and_rejects_wrong(weights):
    """The true greedy continuation as drafts: all accepted plus a bonus
    token; garbage drafts: exactly one token, the plain one
    (tests/test_spec_decode.py:65)."""
    _, tparams = weights["scaled"]
    # the synchronous path: each step's tokens are emitted by that step
    kw = _serving(max_decode_slots=2, decode_horizon=1, decode_pipeline=0)
    prompt = np.random.default_rng(3).integers(2, 128, 7).tolist()
    true_cont = _run(_port_engine(tparams, **kw), [prompt], max_tokens=12)[0]
    eng = _port_engine(tparams, **kw)
    req = eng.submit(TRequest(prompt_ids=prompt, max_tokens=40,
                              ignore_eos=True))
    eng.step()
    assert req.generated == true_cont[:1]
    K = 4
    drafts = np.zeros((eng.num_slots, K), np.int32)
    drafts[0] = true_cont[1:1 + K]
    eng._ensure_pages(K + 1)
    eng._do_spec_decode([0], drafts, {0: K})
    assert req.generated == true_cont[:2 + K]
    assert eng.counts["spec_accepted_tokens"] == K
    drafts[0] = [(t + 1) % 128 for t in true_cont[2 + K:2 + 2 * K]]
    eng._ensure_pages(K + 1)
    eng._do_spec_decode([0], drafts, {0: K})
    assert req.generated == true_cont[:3 + K]
    # a skipped slot emits nothing, and the next dispatch is a plain one
    eng._ensure_pages(K + 1)
    eng._do_spec_decode([0], drafts, {0: K}, skip={0})
    assert req.generated == true_cont[:3 + K] and eng._spec_plain_due
    eng.step()
    assert eng.counts["decode_dispatches"] == 1
    assert req.generated == true_cont[:4 + K]


@pytest.mark.parametrize("method", ["prompt_lookup", "draft"])
def test_sampled_slot_keeps_its_seeded_stream(weights, method):
    """A sampled request beside drafted greedy ones is never drafted,
    accepts nothing and draws at lengths + 1: its seeded stream is the one
    without spec, and the JAX engine's (tests/test_spec_decode.py:99,
    tests/test_draft_spec.py:107)."""
    jparams, tparams = weights["plain"]
    prompts = _lookup_prompts(4)
    sampled = dict(temperature=0.8, top_p=0.9, top_k=20, seed=11)
    spec = _serving(**SPEC, spec_method=method)
    drafts = dict(draft=(JCFG, jparams)), dict(draft=(TCFG, tparams))
    if method == "prompt_lookup":
        drafts = {}, {}

    def both(engine):
        cls = JRequest if isinstance(engine, JEngine) else TRequest
        reqs = [engine.submit(cls(prompt_ids=p, max_tokens=20,
                                  ignore_eos=True)) for p in prompts]
        reqs.append(engine.submit(cls(prompt_ids=prompts[0], max_tokens=20,
                                      ignore_eos=True, **sampled)))
        for _ in range(10000):
            if not engine.step():
                break
        return [r.generated for r in reqs]

    ref = both(_port_engine(tparams, **_serving()))
    te = _port_engine(tparams, **drafts[1], **spec)
    got = both(te)
    assert got == ref == both(_jax_engine(jparams, **drafts[0], **spec))
    assert te.counts["spec_dispatches"] > 0
    assert te.counts["spec_drafted_tokens"] > 0
    assert len(set(got[2])) > 1


def test_verify_serves_no_sampled_slot(weights):
    """A sampled slot beside a drafted greedy one: the verify emits nothing
    for it and the next dispatch is a plain one that does, so its seeded
    stream comes from the plain step alone (ROADMAP C9; the JAX engine
    draws it from the verify's row 0)."""
    _, tparams = weights["plain"]
    # the synchronous path: each step's tokens are emitted by that step
    te = _port_engine(tparams, **_serving(max_decode_slots=2,
                                          decode_pipeline=0, **SPEC))
    prompts = _lookup_prompts(4)
    greedy = te.submit(TRequest(prompt_ids=prompts[0], max_tokens=60,
                                ignore_eos=True))
    sampled = te.submit(TRequest(prompt_ids=prompts[1], max_tokens=60,
                                 ignore_eos=True, temperature=0.8, top_p=0.9,
                                 top_k=20, seed=11))
    for _ in range(20):                          # up to the first verify
        n_greedy, n_sampled = len(greedy.generated), len(sampled.generated)
        te.step()
        if te.counts["spec_dispatches"]:
            break
    assert te.counts["spec_dispatches"] == 1
    assert len(greedy.generated) > n_greedy
    assert len(sampled.generated) == n_sampled and te._spec_plain_due
    plain = te.counts["decode_dispatches"]
    te.step()
    assert te.counts["decode_dispatches"] == plain + 1
    assert len(sampled.generated) == n_sampled + te.serving.decode_horizon


def test_spec_near_window_edge_falls_back(weights):
    """Within spec_k + 1 rows of the window the engine decodes plainly and
    runs to the edge (tests/test_spec_decode.py:226)."""
    jparams, tparams = weights["plain"]
    kw = _serving(max_decode_slots=2, max_cache_len=32, spec_decode=True,
                  spec_k=4, spec_ngram=2, prefill_buckets=(16,))
    pat = [3, 4] * 8
    te = _port_engine(tparams, **kw)
    got = _run(te, [pat], max_tokens=30)
    assert len(got[0]) == te.max_len - len(pat) - 1
    assert got == _run(_jax_engine(jparams, **kw), [pat], max_tokens=30)
    assert te.counts["spec_dispatches"] > 0
    assert te.counts["decode_dispatches"] > 0


def test_verify_rows_across_a_page_edge_land_in_the_slots_pages(weights):
    """A slot of 6 rows in 8-row pages verifies rows 6..10: the engine
    grows its pages to cover lengths + R before the dispatch, so rows 8..10
    land in its second page and the verify leaves the scratch page 0 as the
    prefill's padding rows left it (one slot, so no idle slot writes there
    either)."""
    _, tparams = weights["plain"]
    te = _port_engine(tparams, **_serving(max_decode_slots=1, **SPEC))
    prompt = [5, 6, 7, 5, 6, 7]
    req = te.submit(TRequest(prompt_ids=prompt, max_tokens=20,
                             ignore_eos=True))
    te.step()                                    # prefill: 1 page
    assert len(te._slot_pages[0]) == 1 and te.lengths[0] == 6
    te._propose_drafts = lambda active: (np.array([[7, 5, 6, 7]], np.int32),
                                         {0: 4})
    scratch = {n: te.cache[n][:, 0].clone() for n in ("k", "v")}
    te._decode()                                 # the verify dispatch
    assert te.counts["spec_dispatches"] == 1
    assert len(te._slot_pages[0]) == 2
    page1 = te.table[0, 1]
    assert page1 != 0
    for n in ("k", "v"):
        assert torch.equal(te.cache[n][:, 0], scratch[n])
        assert te.cache[n][:, page1, :, :3].abs().sum(dim=-1).all()
        assert not te.cache[n][:, page1, :, 3:].any()
    te.run_until_idle()
    ref = _run(_port_engine(tparams, **_serving(max_decode_slots=1)),
               [prompt], max_tokens=20)
    assert req.generated == ref[0]


# -- the draft model ----------------------------------------------------------

DRAFT_PROMPTS = [[5, 6, 7, 8, 9, 10], [11, 3, 2, 13, 2, 7, 9]]
DRAFT = dict(spec_decode=True, spec_k=4, spec_method="draft",
             decode_horizon=6)


def _divergent(jparams):
    """A draft whose lm_head maps every argmax one vocab row off the
    target's (tests/test_draft_spec.py:80): untied, embedding rolled."""
    jcfg = jax_tiny(tie_embeddings=False)
    jd = dict(jparams)
    jd["lm_head"] = {"kernel": jnp.roll(jd["embed"]["weight"], 1, axis=0).T}
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    return (jcfg, jd), (tcfg, from_jax_params(jax.tree.map(np.asarray, jd),
                                              tcfg))


@pytest.mark.parametrize("which", ["self", "divergent"])
@pytest.mark.parametrize("name", ["plain", "scaled"])
def test_draft_streams_match_jax_and_plain(weights, which, name):
    """Self-draft: every draft token verifies (acceptance 1.0); divergent
    draft: rejections. Both streams byte-identical to the JAX draft engine
    and to plain decode (tests/test_draft_spec.py:62, :80)."""
    jparams, tparams = weights[name]
    if which == "self":
        jdraft, tdraft = (JCFG, jparams), (TCFG, tparams)
    else:
        jdraft, tdraft = _divergent(jparams)
    ref = _run(_port_engine(tparams, **_serving(decode_horizon=6)),
               DRAFT_PROMPTS)
    jgot = _run(_jax_engine(jparams, draft=jdraft, **_serving(**DRAFT)),
                DRAFT_PROMPTS)
    te = _port_engine(tparams, draft=tdraft, **_serving(**DRAFT))
    got = _run(te, DRAFT_PROMPTS)
    assert got == jgot == ref
    drafted = te.counts["spec_drafted_tokens"]
    accepted = te.counts["spec_accepted_tokens"]
    assert drafted > 0
    if which == "self":
        assert accepted == drafted
    else:
        assert accepted < drafted


def test_draft_catches_up_after_plain_dispatches(weights):
    """A second wave walks a long prompt in chunks (mixed dispatches that
    advance the running slots past their draft rows); the drafted slots
    teacher-force the gap through the verify program (K7) and the streams
    stay those of the JAX draft engine and of plain decode
    (tests/test_draft_spec.py:127)."""
    jparams, tparams = weights["scaled"]
    wave2 = np.random.default_rng(6).integers(2, 128, 30).tolist()
    kw = _serving(prefill_chunk=16, **DRAFT)

    def drive(engine):
        cls = JRequest if isinstance(engine, JEngine) else TRequest
        first = [engine.submit(cls(prompt_ids=p, max_tokens=30,
                                   ignore_eos=True)) for p in DRAFT_PROMPTS]
        for _ in range(3):
            engine.step()
        second = engine.submit(cls(prompt_ids=wave2, max_tokens=12,
                                   ignore_eos=True))
        for _ in range(10000):
            if not engine.step():
                break
        return [r.generated for r in first + [second]]

    te = _port_engine(tparams, draft=(TCFG, tparams), **kw)
    calls = []
    catch_up = te.draft._catch_up
    te.draft._catch_up = lambda *a: (calls.append(a[1]), catch_up(*a))
    got = drive(te)
    assert calls and te.counts["mixed_dispatches"] > 0
    assert got == drive(_jax_engine(jparams, draft=(JCFG, jparams), **kw))
    assert got == drive(_port_engine(tparams,
                                     **_serving(prefill_chunk=16,
                                                decode_horizon=6)))
    assert te.counts["spec_accepted_tokens"] == \
        te.counts["spec_drafted_tokens"] > 0


def test_draft_recycled_slots_reprefill(weights):
    """A finished slot's draft rows are garbage for its next occupant; the
    draft prefill at re-admission restores them (tests/test_draft_spec.py:
    151): the second wave equals plain decode, fully accepted."""
    _, tparams = weights["scaled"]
    te = _port_engine(tparams, draft=(TCFG, tparams),
                      **_serving(max_decode_slots=2, **DRAFT))
    _run(te, DRAFT_PROMPTS)
    te.counts.clear()
    got = _run(te, DRAFT_PROMPTS[::-1])
    ref = _run(_port_engine(tparams, **_serving(max_decode_slots=2,
                                                decode_horizon=6)),
               DRAFT_PROMPTS[::-1])
    assert got == ref
    assert te.counts["spec_accepted_tokens"] == \
        te.counts["spec_drafted_tokens"] > 0


def test_draft_cache_holds_the_context_at_its_positions(weights):
    """ROADMAP C7: after a few verify rounds the port's draft cache rows
    [0, lens) equal a fresh dense prefill of the context, and lens is the
    target's length (the newest token rides the next dispatch). The JAX
    draft keeps lens one short and its rollout writes the newest token one
    row early."""
    _, tparams = weights["scaled"]
    te = _port_engine(tparams, draft=(TCFG, tparams),
                      **_serving(max_decode_slots=1, **DRAFT))
    req = te.submit(TRequest(prompt_ids=DRAFT_PROMPTS[0], max_tokens=40,
                             ignore_eos=True))
    for _ in range(4):
        te.step()
    d = te.draft
    n = int(d.lens[0])
    assert te.counts["spec_dispatches"] >= 2
    assert n == te.lengths[0] or n == te.lengths[0] - 1
    ctx = (req.prompt_ids + req.generated)[:n]
    fresh = {k: torch.zeros_like(v) for k, v in d.cache.items()}
    from aws_k8s_ansible_provisioner_tpu_torch.serving.programs import \
        prefill_batch_step
    prefill_batch_step(d.model, fresh, torch.tensor([ctx], dtype=torch.int32),
                       torch.tensor([n], dtype=torch.int32), None,
                       *d._greedy(1), slots=torch.tensor([0]))
    for name in ("k", "v"):
        np.testing.assert_allclose(d.cache[name][:, 0, :, :n].numpy(),
                                   fresh[name][:, 0, :, :n].numpy(),
                                   rtol=0, atol=1e-4)
    # the reference: one row short in its steady state
    jparams, _ = weights["scaled"]
    je = _jax_engine(jparams, draft=(JCFG, jparams),
                     **_serving(max_decode_slots=1, **DRAFT))
    je.submit(JRequest(prompt_ids=DRAFT_PROMPTS[0], max_tokens=40,
                       ignore_eos=True))
    for _ in range(4):
        je.step()
    assert je.draft.lens[0] == je.lengths[0] - 1


def test_draft_requires_a_model_and_a_known_method(weights):
    _, tparams = weights["plain"]
    with pytest.raises(ValueError, match="draft"):
        _port_engine(tparams, **_serving(spec_decode=True,
                                         spec_method="draft"))
    with pytest.raises(ValueError, match="spec_method"):
        _port_engine(tparams, **_serving(spec_method="beam"))
    small = (ModelConfig(**{**dataclasses.asdict(TCFG), "vocab_size": 64}),
             tparams)
    with pytest.raises(ValueError, match="vocab"):
        _port_engine(tparams, draft=small,
                     **_serving(spec_decode=True, spec_method="draft"))
