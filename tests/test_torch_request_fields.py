"""The request fields that process the logits (penalties, logit bias,
min_tokens with stop ids, logprobs and prompt logprobs) in the port against
the JAX package, on the CPU.

The helpers (``apply_penalties``, ``_apply_logit_bias``, ``_mask_banned``,
``_apply_prefill_repetition``) must be bit-identical to the JAX ones on the
same logits; ``_logprob_topk`` and ``_prompt_logprobs`` within 1e-5, with
equal ids where the values are not tied (``torch.topk`` and
``jax.lax.top_k`` need not order ties alike). A bias or ban row padded with
the JAX pad id (or an id past the vocabulary) indexes nothing outside it.

Then the engines, on tiny_qwen3 in float32 (the JAX weights, scaled as
tests/test_torch_engine.py scales them, carried across by
``from_jax_params``; the JAX engine with ``attention_impl="xla"``): the
same requests, each setting fields, give byte-identical greedy and seeded
streams, finish reasons and logprob records, in the paged and the dense
engine, with the pipeline on and a horizon of 4 (a repeat inside a horizon
is penalized), through the chunk walk (``mixed_step`` paged, the dense
walk), through a preemption and resume of penalized seeded streams, and with
speculation on beside slots that the verify must skip.
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
from aws_k8s_ansible_provisioner_tpu.ops import sampling as jsampling
from aws_k8s_ansible_provisioner_tpu.serving import programs as jprograms
from aws_k8s_ansible_provisioner_tpu.serving.engine import Engine as JEngine
from aws_k8s_ansible_provisioner_tpu.serving.engine import Request as JRequest
from aws_k8s_ansible_provisioner_tpu_torch.config import ModelConfig
from aws_k8s_ansible_provisioner_tpu_torch.config import \
    ServingConfig as TServing
from aws_k8s_ansible_provisioner_tpu_torch.models.convert import \
    from_jax_params
from aws_k8s_ansible_provisioner_tpu_torch.ops import sampling as tsampling
from aws_k8s_ansible_provisioner_tpu_torch.serving import programs
from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import \
    Engine as TEngine
from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import \
    Request as TRequest

torch.set_num_threads(2)

B, V = 4, 97


def _bits(a):
    return np.asarray(a).view(np.int32)


def _logit_inputs(seed=0):
    rng = np.random.default_rng(seed)
    return rng, (rng.normal(size=(B, V)) * 3).astype(np.float32)


# -- the helpers ---------------------------------------------------------------


def test_apply_penalties_bit_identical_to_jax():
    rng, logits = _logit_inputs()
    counts = rng.integers(0, 3, (B, V)).astype(np.int32)
    mask = rng.random((B, V)) < 0.2
    pres = np.array([0.5, 0.0, -1.3, 2.0], np.float32)
    freq = np.array([0.25, 0.7, 0.0, -0.4], np.float32)
    rep = np.array([1.3, 1.0, 0.7, 1.9], np.float32)
    for r, m in ((None, None), (rep, None), (rep, mask)):
        want = jsampling.apply_penalties(
            jnp.asarray(logits), jnp.asarray(counts), jnp.asarray(pres),
            jnp.asarray(freq), None if r is None else jnp.asarray(r),
            None if m is None else jnp.asarray(m))
        got = tsampling.apply_penalties(
            torch.from_numpy(logits), torch.from_numpy(counts),
            torch.from_numpy(pres), torch.from_numpy(freq),
            None if r is None else torch.from_numpy(r),
            None if m is None else torch.from_numpy(m))
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def _bias_rows():
    ids = np.full((B, programs.BIAS_K), programs.NO_TOKEN, np.int32)
    vals = np.zeros((B, programs.BIAS_K), np.float32)
    ids[0, :3], vals[0, :3] = [5, 9, -1], [3.5, -100.0, 7.0]
    ids[1, :2], vals[1, :2] = [V + 5, 0], [50.0, 1.25]     # past V: dropped
    ids[2, :1], vals[2, :1] = [V - 1], [100.0]
    return ids, vals                                       # row 3: padding


def test_logit_bias_bit_identical_to_jax():
    _, logits = _logit_inputs(1)
    ids, vals = _bias_rows()
    want = jprograms._apply_logit_bias(jnp.asarray(logits), jnp.asarray(ids),
                                       jnp.asarray(vals))
    got = programs._apply_logit_bias(torch.from_numpy(logits),
                                     torch.from_numpy(ids),
                                     torch.from_numpy(vals))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    np.testing.assert_array_equal(_bits(got[3].numpy()), _bits(logits[3]))


def _ban_rows():
    ids = np.full((B, programs.BAN_K), programs.NO_TOKEN, np.int32)
    ids[0, :2] = [3, 0]
    ids[2, :3] = [7, V + 1, -2]
    ids[3, :1] = [4]
    return ids, np.array([10, 10, 10, 2], np.int32), \
        np.array([5, 5, 9, 5], np.int32)


def test_mask_banned_bit_identical_to_jax():
    """Rows 0 and 2 ban (row 2's past-vocabulary id dropped, its negative
    id counted from the end), row 1 is padding, row 3's ban has expired
    (its length reached ban_until)."""
    _, logits = _logit_inputs(2)
    ids, until, lens = _ban_rows()
    want = jprograms._mask_banned(jnp.asarray(logits), jnp.asarray(ids),
                                  jnp.asarray(until), jnp.asarray(lens))
    got = programs._mask_banned(torch.from_numpy(logits),
                                torch.from_numpy(ids),
                                torch.from_numpy(until),
                                torch.from_numpy(lens)).numpy()
    np.testing.assert_array_equal(got, np.asarray(want))
    assert np.isinf(got[0, [0, 3]]).all() and np.isinf(got[2, [7, V - 2]]) \
        .all()
    np.testing.assert_array_equal(got[[1, 3]], logits[[1, 3]])


def test_prefill_repetition_bit_identical_to_jax():
    rng, logits = _logit_inputs(3)
    tokens = rng.integers(0, V, (B, 6)).astype(np.int32)
    true_lens = np.array([6, 2, 4, 1], np.int32)
    reps = np.array([1.3, 1.0, 0.6, 2.5], np.float32)
    want = jprograms._apply_prefill_repetition(
        jnp.asarray(logits), jnp.asarray(tokens), jnp.asarray(true_lens),
        jnp.asarray(reps))
    got = programs._apply_prefill_repetition(
        torch.from_numpy(logits), torch.from_numpy(tokens),
        torch.from_numpy(true_lens), torch.from_numpy(reps))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("helper", ["bias", "ban"])
def test_padded_rows_index_nothing_out_of_range(monkeypatch, helper):
    """Every index that reaches a scatter lies in [0, V), whatever the row
    holds (the JAX pad id, an id past the vocabulary, a negative one): on
    a card an index outside it is a device-side assert."""
    seen = []
    for name in ("scatter_add", "scatter_reduce"):
        orig = getattr(torch.Tensor, name)

        def spy(self, dim, index, *args, _orig=orig, **kwargs):
            seen.append((int(index.min()), int(index.max())))
            return _orig(self, dim, index, *args, **kwargs)

        monkeypatch.setattr(torch.Tensor, name, spy)
    _, logits = _logit_inputs(4)
    if helper == "bias":
        ids, vals = _bias_rows()
        programs._apply_logit_bias(torch.from_numpy(logits),
                                   torch.from_numpy(ids),
                                   torch.from_numpy(vals))
    else:
        ids, until, lens = _ban_rows()
        programs._mask_banned(torch.from_numpy(logits),
                              torch.from_numpy(ids), torch.from_numpy(until),
                              torch.from_numpy(lens))
    assert seen and all(0 <= lo and hi < V for lo, hi in seen)


def _ids_equal_where_untied(got_vals, got_ids, want_vals, want_ids,
                            tol=1e-5):
    """Top-k ids equal at every rank whose value is not tied (within tol)
    with a neighbour's."""
    if want_vals.shape[-1] == 0:
        assert got_vals.shape == want_vals.shape
        return
    for gv, gi, wv, wi in zip(got_vals.reshape(-1, got_vals.shape[-1]),
                              got_ids.reshape(-1, got_ids.shape[-1]),
                              want_vals.reshape(-1, want_vals.shape[-1]),
                              want_ids.reshape(-1, want_ids.shape[-1])):
        for j in range(len(wv)):
            tied = (j > 0 and wv[j - 1] - wv[j] < tol) or \
                (j + 1 < len(wv) and wv[j] - wv[j + 1] < tol)
            if not tied:
                assert gi[j] == wi[j], (j, gv, wv)


def test_logprob_topk_matches_jax():
    _, logits = _logit_inputs(5)
    logits[1, [3, 8]] = logits[1].max() + 1.0            # a tie at the top
    chosen = np.array([0, 3, 50, 96], np.int32)
    want = [np.asarray(a) for a in jprograms._logprob_topk(
        jnp.asarray(logits), jnp.asarray(chosen))]
    got = [a.numpy() for a in programs._logprob_topk(
        torch.from_numpy(logits), torch.from_numpy(chosen))]
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[1], want[1], atol=1e-5, rtol=0)
    assert got[2].dtype == np.int32
    _ids_equal_where_untied(got[1], got[2], want[1], want[2])


@pytest.mark.parametrize("block_bytes", [4 * 2 * V, 1 << 26],
                         ids=["one-position-a-block", "one-block"])
def test_prompt_logprobs_matches_jax(block_bytes):
    rng = np.random.default_rng(6)
    logits = (rng.normal(size=(2, 9, V)) * 3).astype(np.float32)
    tokens = rng.integers(0, V, (2, 9)).astype(np.int32)
    want = [np.asarray(a) for a in jprograms._prompt_logprobs(
        jnp.asarray(logits), jnp.asarray(tokens))]
    got = [a.numpy() for a in programs._prompt_logprobs(
        torch.from_numpy(logits), torch.from_numpy(tokens), 9,
        block_bytes=block_bytes)]
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
    _ids_equal_where_untied(got[1], got[2], want[1], want[2])
    empty = programs._prompt_logprobs(torch.from_numpy(logits),
                                      torch.from_numpy(tokens), 1)
    assert [tuple(a.shape) for a in empty] == [(2, 0), (2, 0, 8), (2, 0, 8)]


# -- the engines ---------------------------------------------------------------


BASE = dict(max_decode_slots=4, max_cache_len=64, page_size=8,
            prefill_buckets=(8, 16, 32), dtype="float32", decode_horizon=4)


@pytest.fixture(scope="module")
def model():
    jcfg = jax_tiny()
    params = init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)

    def scale(node):
        return {k: scale(v) if isinstance(v, dict) else
                v * 8 if k == "kernel" else v for k, v in node.items()}

    params = scale(params)
    params["embed"] = {"weight": params["embed"]["weight"] * 8}
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    tparams = from_jax_params(jax.tree.map(np.asarray, params), tcfg)
    return jcfg, params, tcfg, tparams


def _engines(model, prefix_cache=False, **serving):
    jcfg, jparams, tcfg, tparams = model
    serving = {**BASE, **serving}
    je = JEngine(jcfg, jparams, JServing(
        weights_dtype="bf16", prefix_cache=prefix_cache,
        attention_impl="xla", **serving))
    te = TEngine(tcfg, tparams, TServing(
        weights_dtype="bf16", prefix_cache=prefix_cache, **serving),
        device="cpu")
    return je, te


def _run_jax(je):
    while (any(s is not None for s in je.slot_req) or je.pending
           or je._chunk is not None or je._inflight is not None):
        je.step()


def _prompts(lengths, seed):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(2, 128, n)] for n in lengths]


def _same_records(got, want, tol=1e-5):
    """Two lists of logprob records alike: None where the other is None,
    own logprobs and top values within tol, ids equal where untied."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is None:
            continue
        assert abs(g[0] - w[0]) <= tol
        gv = np.array([[v for _, v in g[1]]])
        wv = np.array([[v for _, v in w[1]]])
        np.testing.assert_allclose(gv, wv, atol=tol, rtol=0)
        _ids_equal_where_untied(gv, np.array([[t for t, _ in g[1]]]), wv,
                                np.array([[t for t, _ in w[1]]]))


def _run_both(model, prompts, fields, max_tokens=12, **serving):
    """Submit the same requests (prompt i with fields i) to both engines,
    run both until idle; every stream, finish reason and logprob record
    must match. Returns the two engines and the port's requests."""
    je, te = _engines(model, **serving)
    jr = [je.submit(JRequest(prompt_ids=list(p), max_tokens=max_tokens,
                             **{"ignore_eos": True, **f}))
          for p, f in zip(prompts, fields)]
    tr = [te.submit(TRequest(prompt_ids=list(p), max_tokens=max_tokens,
                             **{"ignore_eos": True, **f}))
          for p, f in zip(prompts, fields)]
    _run_jax(je)
    te.run_until_idle()
    for a, b, f in zip(jr, tr, fields):
        assert b.generated == a.generated, (f, a.generated, b.generated)
        assert b.finish_reason == a.finish_reason, f
        _same_records(b.logprob_data, a.logprob_data)
        _same_records(b.prompt_logprob_data, a.prompt_logprob_data)
    return je, te, tr


def _bare(model, prompt, **serving):
    """The port engine's plain greedy stream of ``prompt``."""
    _, te = _engines(model, **serving)
    r = te.submit(TRequest(prompt_ids=list(prompt), max_tokens=12,
                           ignore_eos=True))
    te.run_until_idle()
    return r.generated


SEEDED = dict(temperature=0.9, top_p=0.95, top_k=20)


def _fields(stop_id):
    """One request per field (and a neutral one); every field greedy and,
    where it matters, seeded."""
    return [
        dict(presence_penalty=1.5, frequency_penalty=0.5),
        dict(repetition_penalty=1.8),
        dict(logit_bias=((7, 3.0), (9, -100.0), (programs.NO_TOKEN, 5.0))),
        dict(logit_bias=((11, 100.0),)),
        dict(min_tokens=5, stop_token_ids=(stop_id,)),
        dict(logprobs=3),
        dict(prompt_logprobs=2, logprobs=0),
        dict(presence_penalty=0.0, frequency_penalty=0.0,
             repetition_penalty=1.0, logit_bias=(), min_tokens=0,
             stop_token_ids=()),
        dict(SEEDED, seed=7, presence_penalty=0.8, repetition_penalty=1.3),
        dict(SEEDED, seed=8, logprobs=2, logit_bias=((5, -100.0),)),
        dict(SEEDED, seed=9, min_tokens=6, stop_token_ids=(stop_id,)),
    ]


PAGED = pytest.mark.parametrize("paged", [True, False],
                                ids=["paged", "dense"])


@PAGED
def test_field_streams_match_jax(model, paged):
    """Eleven requests over four slots (batched prefill, decode horizon 4
    with the pipeline on, admissions into freed slots under a dispatch in
    flight): each field's stream and records equal the JAX engine's; the
    forced token fills its stream, the banned one never shows, no stop id
    ends a stream before min_tokens, the neutral request is the bare one,
    and every logprob record of a greedy stream has its token on top."""
    prompts = _prompts((5, 12, 3, 21, 9, 14, 7, 16, 11, 6, 13), seed=11)
    stop_id = _bare(model, prompts[4], paged=paged)[1]
    fields = _fields(stop_id)
    _, te, tr = _run_both(model, prompts, fields, paged=paged)
    assert tr[3].generated == [11] * 12
    assert 9 not in tr[2].generated and 5 not in tr[9].generated
    for r in (tr[4], tr[10]):
        assert stop_id not in r.generated[:r.min_tokens]
    assert tr[7].generated == _bare(model, prompts[7], paged=paged)
    assert len(tr[5].logprob_data) == 12 and all(
        d[1][0][0] == t or d[1][0][1] == d[1][1][1]
        for t, d in zip(tr[5].generated, tr[5].logprob_data))
    assert len(tr[6].prompt_logprob_data) == len(prompts[6])
    assert te.counts["decode_dispatches"] > 0


@PAGED
def test_decode_variants_follow_the_running_requests(model, paged):
    """A plain batch takes the default decode variant, a penalized one the
    penalties variant, a logprob one the logprobs variant, both both."""
    _, te = _engines(model, paged=paged)
    seen = []
    run = te.decoder.run

    def spy(h, sampled, penalties=False, logprobs=False):
        seen.append((penalties, logprobs))
        return run(h, sampled, penalties, logprobs)

    te.decoder.run = spy
    p = _prompts((6,), seed=12)[0]
    for fields, want in (({}, (False, False)),
                         ({"presence_penalty": 0.5}, (True, False)),
                         ({"logprobs": 1}, (False, True)),
                         ({"repetition_penalty": 1.1, "logprobs": 0},
                          (True, True))):
        seen.clear()
        te.submit(TRequest(prompt_ids=p, max_tokens=6, ignore_eos=True,
                           **fields))
        te.run_until_idle()
        assert seen and set(seen) == {want}, (fields, seen)


@PAGED
def test_chunked_field_streams_match_jax(model, paged):
    """prefill_chunk 8: the long prompts walk in chunks (paged: mixed_step
    beside the running decode rows; dense: the chunk walk with horizon-1
    decodes between), and their first tokens take the repetition penalty
    over the whole prompt, the bias, the ban and the logprobs of the final
    chunk."""
    prompts = _prompts((21, 5, 26, 9, 19, 30), seed=13)
    fields = [dict(repetition_penalty=2.0), dict(logprobs=2),
              dict(logit_bias=((prompts[2][0], 100.0),)),
              dict(presence_penalty=1.0),
              dict(min_tokens=4, stop_token_ids=(
                  _bare(model, prompts[4], paged=paged,
                        prefill_chunk=8)[0],)),
              dict(SEEDED, seed=21, logprobs=1, frequency_penalty=0.7)]
    _, te, tr = _run_both(model, prompts, fields, prefill_chunk=8,
                          paged=paged)
    walks = te.counts["mixed_dispatches"] if paged \
        else te.counts["chunk_dispatches"]
    assert walks >= 6
    assert tr[2].generated == [prompts[2][0]] * 12


def test_penalized_seeded_streams_resume_after_preemption(model):
    """A pool of 12 pages for four slots of 8: penalized (and seeded)
    requests are preempted and resumed; the resume restores each count row
    from the tokens generated before, so every stream equals the JAX
    engine's and the stream the same request gives alone, unpreempted."""
    prompts = _prompts((20, 14, 25, 9, 17), seed=14)
    fields = [dict(presence_penalty=1.2, frequency_penalty=0.4),
              dict(SEEDED, seed=31, presence_penalty=0.9),
              dict(repetition_penalty=1.6),
              dict(SEEDED, seed=32, frequency_penalty=1.1, logprobs=1),
              dict(SEEDED, seed=33, repetition_penalty=1.4)]
    _, te, tr = _run_both(model, prompts, fields, max_tokens=24,
                          kv_pool_pages=12, admission_preempt_after_s=0)
    assert te.counts["preemptions"] > 0
    for p, f, r in zip(prompts, fields, tr):
        _, alone = _engines(model)
        a = alone.submit(TRequest(prompt_ids=list(p), max_tokens=24,
                                  ignore_eos=True, **f))
        alone.run_until_idle()
        assert a.generated == r.generated, f


@PAGED
def test_spec_skips_ineligible_neighbours(model, paged):
    """Prompt-lookup speculation beside slots with logprobs, a penalty, a
    live min_tokens ban and a bias: the verify serves them no token (they
    advance on the plain step), every stream equals the JAX spec engine's
    and the stream without speculation, and the eligible slots still
    accept drafts."""
    rng = np.random.default_rng(3)
    pat = rng.integers(2, 128, 4).tolist()
    prompts = [pat * 4, pat * 3, pat * 4, pat * 3, pat * 4]
    fields = [{}, dict(logprobs=1), dict(presence_penalty=0.6),
              dict(min_tokens=8, stop_token_ids=(pat[0],)),
              dict(logit_bias=((pat[1], -2.0),))]
    spec = dict(spec_decode=True, spec_k=4, spec_ngram=3, paged=paged,
                max_cache_len=128, prefill_buckets=(32,))
    _, te, tr = _run_both(model, prompts, fields, max_tokens=16, **spec)
    assert te.counts["spec_dispatches"] > 0
    assert te.counts["spec_accepted_tokens"] > 0
    _, plain, plain_r = _run_both(model, prompts, fields, max_tokens=16,
                                  **{**spec, "spec_decode": False})
    assert [r.generated for r in tr] == [r.generated for r in plain_r]
    assert all(d is not None for d in tr[1].logprob_data)


@PAGED
def test_prompt_logprobs_bypass_the_prefix_cache(model, paged):
    """With the prompt's rows resident, a prompt_logprobs request still
    prefills every row (no hit) and its records equal the JAX engine's."""
    prompt = _prompts((14,), seed=15)[0]
    je, te = _engines(model, prefix_cache=True, paged=paged,
                      prefix_reuse_min_pages=1, max_prefill_batch=1)
    for eng, Req, run in ((je, JRequest, _run_jax),
                          (te, TRequest, TEngine.run_until_idle)):
        eng.submit(Req(prompt_ids=list(prompt), max_tokens=3,
                       ignore_eos=True))
        run(eng)
    hits = te.metrics.prefix_cache_hits.total()
    jr = je.submit(JRequest(prompt_ids=list(prompt), max_tokens=3,
                            ignore_eos=True, prompt_logprobs=3))
    tr = te.submit(TRequest(prompt_ids=list(prompt), max_tokens=3,
                            ignore_eos=True, prompt_logprobs=3))
    _run_jax(je)
    te.run_until_idle()
    assert te.metrics.prefix_cache_hits.total() == hits
    assert tr.generated == jr.generated
    assert len(tr.prompt_logprob_data) == len(prompt)
    _same_records(tr.prompt_logprob_data, jr.prompt_logprob_data)


def test_prompt_logprobs_through_the_walk_under_a_dispatch_in_flight(model):
    """ROADMAP C21: the paged engine admits a request under a dispatch in
    flight through the chunk walk. The JAX walk computes no prompt
    logprobs there; the port's one chunk does, equal to what an isolated
    admission (batch prefill, the JAX engine's too) computes."""
    prompts = _prompts((9, 12), seed=16)
    _, te = _engines(model)
    first = te.submit(TRequest(prompt_ids=prompts[0], max_tokens=12,
                               ignore_eos=True))
    te.step()
    te.step()
    assert te._inflight is not None
    walked = te.submit(TRequest(prompt_ids=prompts[1], max_tokens=3,
                                ignore_eos=True, prompt_logprobs=2))
    te.run_until_idle()
    assert te.counts["mixed_dispatches"] > 0 and first.generated
    je, _ = _engines(model)
    alone = je.submit(JRequest(prompt_ids=prompts[1], max_tokens=3,
                               ignore_eos=True, prompt_logprobs=2))
    _run_jax(je)
    assert walked.generated == alone.generated
    _same_records(walked.prompt_logprob_data, alone.prompt_logprob_data)


def test_submit_checks_the_fields_as_the_jax_engine(model):
    _, te = _engines(model, prefill_chunk=8)
    p = _prompts((5,), seed=17)[0]
    bad = [dict(min_tokens=2, stop_token_ids=tuple(range(3, 12))),
           dict(logit_bias=tuple((t, 1.0) for t in range(65))),
           dict(repetition_penalty=0.0), dict(repetition_penalty=-1.0),
           dict(prompt_logprobs=9), dict(prompt_logprobs=-1)]
    for f in bad:
        with pytest.raises(ValueError):
            te.submit(TRequest(prompt_ids=p, **f))
    with pytest.raises(ValueError, match="chunk"):
        te.submit(TRequest(prompt_ids=list(range(2, 20)), prompt_logprobs=1))
    te.submit(TRequest(prompt_ids=p, min_tokens=2,
                       stop_token_ids=tuple(range(3, 9)), max_tokens=2))
    te.run_until_idle()


@PAGED
def test_penalty_count_row_resets_for_the_next_request(model, paged):
    """One slot, the same penalized request twice: the second does not
    see the first's counts (its row is reset at its activation)."""
    _, te = _engines(model, paged=paged, max_decode_slots=1)
    p = _prompts((7,), seed=18)[0]
    runs = []
    for _ in range(2):
        r = te.submit(TRequest(prompt_ids=p, max_tokens=10, ignore_eos=True,
                               presence_penalty=2.0, frequency_penalty=2.0))
        te.run_until_idle()
        runs.append(r.generated)
    assert runs[0] == runs[1]
    assert len(set(runs[0])) == len(runs[0])
