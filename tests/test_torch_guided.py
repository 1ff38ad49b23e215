"""Guided decoding in the port against the JAX package, on the CPU.

The grammar module (``serving/guided.py``, a copy in the port) runs the JAX
package's unit cases once per package: the JSON machine, the schema
compiler, the regex language and its refusals, the nested-quantifier
budget, the token masks, the byte tables of a byte-level BPE and of a
sentencepiece byte-fallback tokenizer; then the two modules give the same
words and byte tables on one tokenizer. ``apply_allow`` over int32 words
is exact against the JAX one over uint32 words (bit 31 set, V not a
multiple of 32).

Then the engines, on tiny_qwen3 over the byte vocabulary (the JAX weights
scaled by 8, as tests/test_torch_request_fields.py scales them, carried
across by ``from_jax_params``; float32; the JAX engine with
``attention_impl="xla"``): json_object, json_schema, regex and choice
requests, greedy and seeded, beside an unguided neighbour, give the JAX
engine's token streams, paged and dense, with the pipeline on and off, with
prompt-lookup speculation, with a penalized guided request and with two
requests on one grammar (n = 2). A guided slot beside unguided ones at a
horizon above 1 is held against the JAX engine without the pipeline: the
JAX pipeline feeds the slot its discarded substeps' carry (ROADMAP C26),
which :func:`test_c26_jax_pipeline_feeds_guided_surplus` pins.

Then the HTTP servers (both in process on the same weights): the guided
fields, whole, streamed and with n = 2, answered alike, and every 400 with
the JAX message.
"""

import dataclasses
import json
import re
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_server import _post, jax_server, twin_server  # noqa: F401

from aws_k8s_ansible_provisioner_tpu.config import ServingConfig as JServing
from aws_k8s_ansible_provisioner_tpu.config import tiny_qwen3 as jax_tiny
from aws_k8s_ansible_provisioner_tpu.models.layers import init_params
from aws_k8s_ansible_provisioner_tpu.ops import sampling as jsampling
from aws_k8s_ansible_provisioner_tpu.serving import guided as jguided
from aws_k8s_ansible_provisioner_tpu.serving.engine import Engine as JEngine
from aws_k8s_ansible_provisioner_tpu.serving.engine import Request as JRequest
from aws_k8s_ansible_provisioner_tpu.utils import tokenizer as jtok
from aws_k8s_ansible_provisioner_tpu_torch.config import ModelConfig
from aws_k8s_ansible_provisioner_tpu_torch.config import \
    ServingConfig as TServing
from aws_k8s_ansible_provisioner_tpu_torch.models.convert import \
    from_jax_params
from aws_k8s_ansible_provisioner_tpu_torch.ops import sampling as tsampling
from aws_k8s_ansible_provisioner_tpu_torch.serving import guided as tguided
from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import \
    Engine as TEngine
from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import \
    Request as TRequest
from aws_k8s_ansible_provisioner_tpu_torch.utils import tokenizer as ttok

torch.set_num_threads(2)

# (the package's guided module, its byte tokenizer)
PACKAGES = [pytest.param((jguided, jtok.ByteTokenizer), id="jax"),
            pytest.param((tguided, ttok.ByteTokenizer), id="port")]


def _walk(m, s: str):
    st = m.start()
    for c in s.encode():
        st = m.step(st, c)
        if st is None:
            return None
    return st


def _accepts(m, s: str) -> bool:
    st = _walk(m, s)
    return st is not None and m.accepting(st)


def _allowed(words, V):
    v = np.arange(V)
    return set(v[((words[v >> 5] >> (v & 31)) & 1).astype(bool)].tolist())


# -- the grammar module, in both packages -------------------------------------


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("text,ok", [
    ('{"a": 1}', True),
    ('{"a": [1, 2.5e-3, true, false, null, "x"]}', True),
    ('{"a": {"b": {"c": [{"d": 1}]}}}', True),
    ('  {"a":1}  ', True),
    ('{"k": "\\u00e9 \\n \\" \\\\"}', True),
    ('{}', True),
    ('{"a": -0.5}', True),
    ('[1, 2]', False),
    ('"str"', False),
    ('{"a": 01}', False),
    ('{"a": 1,}', False),
    ('{"a" 1}', False),
    ('{"a": "x}', False),
    ('{"a": tru}', False),
    ('{"a": 1} x', False),
    ('{"a": .5}', False),
    ('{"a": 1.}', False),
    ('{"a": "\\x"}', False),
])
def test_json_machine(pkg, text, ok):
    g, _ = pkg
    assert _accepts(g.JsonMachine(top="object"), text) == ok


@pytest.mark.parametrize("pkg", PACKAGES)
def test_json_machine_top_value_and_depth_cap(pkg):
    g, _ = pkg
    m = g.JsonMachine(top="value")
    for s in ('42', '-1.5e3', '"hi"', 'true', '[1, [2]]', 'null'):
        assert _accepts(m, s), s
    assert not _accepts(m, '1 2')
    m = g.JsonMachine(top="value", max_depth=2)
    assert _accepts(m, '[[1]]')
    assert _walk(m, '[[[') is None


SCHEMA = {
    "type": "object",
    "properties": {
        "name": {"type": "string"},
        "age": {"type": "integer"},
        "tags": {"type": "array", "items": {"type": "string"}},
    },
    "required": ["name", "age"],
}


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("text,ok", [
    ('{"name": "bo", "age": 3}', True),
    ('{"name": "bo", "age": -7, "tags": ["x", "y"]}', True),
    ('{"name": "bo", "age": 3, "tags": []}', True),
    ('{"age": 3, "name": "bo"}', False),
    ('{"name": "bo"}', False),
    ('{"name": "bo", "age": 3.5}', False),
    ('{"name": "bo", "age": 3, "extra": 1}', False),
])
def test_schema_machine(pkg, text, ok):
    g, _ = pkg
    assert _accepts(g.NfaMachine(g.schema_to_rx(SCHEMA)), text) == ok


@pytest.mark.parametrize("pkg", PACKAGES)
def test_schema_enum_anyof_const_and_optional_subsets(pkg):
    g, _ = pkg
    s = {"type": "object",
         "properties": {"kind": {"enum": ["cat", "dog"]},
                        "v": {"anyOf": [{"type": "number"},
                                        {"type": "null"}]},
                        "ok": {"const": True}},
         "required": ["kind", "v", "ok"]}
    m = g.NfaMachine(g.schema_to_rx(s))
    assert _accepts(m, '{"kind": "cat", "v": -1.5e2, "ok": true}')
    assert _accepts(m, '{"kind": "dog", "v": null, "ok": true}')
    assert not _accepts(m, '{"kind": "cow", "v": 1, "ok": true}')
    assert not _accepts(m, '{"kind": "cat", "v": 1, "ok": false}')
    s = {"type": "object",
         "properties": {"a": {"type": "integer"}, "b": {"type": "integer"},
                        "c": {"type": "integer"}},
         "required": []}
    m = g.NfaMachine(g.schema_to_rx(s))
    for ok in ('{}', '{"a": 1}', '{"b": 2}', '{"c": 3}', '{"a": 1, "c": 3}',
               '{"b": 2, "c": 3}', '{"a": 1, "b": 2, "c": 3}'):
        assert _accepts(m, ok), ok
    for bad in ('{"b": 2, "a": 1}', '{"a": 1,}'):
        assert not _accepts(m, bad), bad


_BAD_SCHEMAS = [{"$ref": "#/x"},
                {"type": "object", "properties": {"a": {"type": "string"}},
                 "additionalProperties": {"type": "number"}},
                {"type": "object"}, {"type": "array"}, {"enum": [{"a": 1}]}]


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("i", range(len(_BAD_SCHEMAS)))
def test_schema_unsupported_keywords_raise_like_jax(pkg, i):
    g, _ = pkg
    with pytest.raises(ValueError) as got:
        g.schema_to_rx(_BAD_SCHEMAS[i])
    with pytest.raises(ValueError) as want:
        jguided.schema_to_rx(_BAD_SCHEMAS[i])
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("pattern,ok,bad", [
    (r"[a-c]+\d{2}", ["ab12", "c00", "abc99"], ["ab1", "d12", "ab123"]),
    (r"(foo|ba[rz])?-x", ["-x", "foo-x", "bar-x", "baz-x"], ["bax-x", "f-x"]),
    (r"\w+@\w+\.(com|org)", ["a_1@b.com", "x@y.org"], ["a@b.net", "@b.com"]),
    (r"yes|no", ["yes", "no"], ["yesno", " yes", "maybe"]),
    (r"a{2,3}", ["aa", "aaa"], ["a", "aaaa"]),
    (r"^[^,]+$", ["abc", "x y"], ["a,b"]),
    (r"\x41.\n?", ["AB", "Az\n"], ["BA", "A\nz"]),
])
def test_parse_regex_language(pkg, pattern, ok, bad):
    g, _ = pkg
    m = g.NfaMachine(g.parse_regex(pattern), pad_ws=False)
    for s in ok:
        assert _accepts(m, s), (pattern, s)
    for s in bad:
        assert not _accepts(m, s), (pattern, s)


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("bad", [r"(?=x)y", r"a{9999}", r"[z-a]",
                                 r"(unclosed", r"a\q", "a{5,2}", "foo$bar",
                                 "a^b"])
def test_parse_regex_refusals_like_jax(pkg, bad):
    g, _ = pkg
    with pytest.raises(ValueError) as got:
        g.parse_regex(bad)
    with pytest.raises(ValueError) as want:
        jguided.parse_regex(bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_regex_nested_quantifier_budget(pkg):
    g, _ = pkg
    t0 = time.monotonic()
    with pytest.raises(ValueError, match="budget"):
        g.parse_regex("((((a{256}){256}){256}){256})")
    assert time.monotonic() - t0 < 2.0, "rejection must be cheap"
    g.parse_regex("^[A-Z]{8}-[0-9]{8}$")


@pytest.mark.parametrize("pkg", PACKAGES)
def test_token_grammar_masks_follow_state(pkg):
    g, Tok = pkg
    tok = Tok()
    gr = g.TokenGrammar(g.JsonMachine(top="object"), tok, [tok.eos_token_id])
    gs = g.GuidedState(gr)
    a = _allowed(gs.mask_words(), gr.vocab_size)
    assert ord('{') in a and ord(' ') in a
    assert ord('[') not in a and ord('a') not in a
    assert tok.eos_token_id not in a
    for c in b'{"k": 1':
        gs.advance(c)
        assert not gs.dead
    a = _allowed(gs.mask_words(), gr.vocab_size)
    assert {ord('}'), ord(','), ord('0'), ord('e'), ord('.')} <= a
    assert ord('"') not in a
    gs.advance(ord('}'))
    assert gs.complete
    a = _allowed(gs.mask_words(), gr.vocab_size)
    assert tok.eos_token_id in a and ord(' ') in a and ord('x') not in a
    dead = g.GuidedState(gr)
    dead.advance(ord('x'))          # not a valid first byte
    assert dead.dead
    a = _allowed(dead.mask_words(), gr.vocab_size)
    assert tok.eos_token_id in a and ord('{') not in a


@pytest.mark.parametrize("pkg", PACKAGES)
def test_grammar_for_request_modes_caches_and_errors(pkg):
    g, Tok = pkg
    tok = Tok()
    eos = [tok.eos_token_id]
    assert g.grammar_for(tok, {"type": "json_object"}, eos) is \
        g.grammar_for(tok, {"type": "json_object"}, eos)
    s = {"type": "json_schema", "json_schema": {"schema": SCHEMA}}
    assert g.grammar_for(tok, s, eos) is g.grammar_for(tok, s, eos)
    assert g.grammar_for_request(tok, {}, eos) is None
    assert g.grammar_for_request(tok, {"response_format": {"type": "text"}},
                                 eos) is None
    assert g.grammar_for_request(tok, {"response_format": None}, eos) is None
    assert g.grammar_for_request(tok, {"response_format": None,
                                       "guided_choice": ["a"]}, eos)
    c = g.grammar_for_request(tok, {"guided_choice": ["cat", "dog"]}, eos)
    assert c is g.grammar_for_request(tok, {"guided_choice": ["cat", "dog"]},
                                      eos)
    assert c.exact
    for body in ({"guided_regex": "a+", "guided_choice": ["x"]},
                 {"guided_choice": []}, {"guided_json": "not-a-dict"},
                 {"guided_regex": ""}, {"response_format": {"type": "xml"}},
                 {"response_format": {"type": "json_schema"}}):
        with pytest.raises(ValueError) as got:
            g.grammar_for_request(tok, body, eos)
        with pytest.raises(ValueError) as want:
            jguided.grammar_for_request(jtok.ByteTokenizer(), body, eos)
        assert str(got.value) == str(want.value)


def _byte_level_bpe():
    """A byte-level BPE tokenizer (the GPT-2 byte alphabet, as the Qwen
    vocabularies store it) with multi-byte merges, '{"' among them; returns
    (the transformers tokenizer, its vocab, the byte -> stand-in map)."""
    tokenizers = pytest.importorskip("tokenizers")
    from transformers import PreTrainedTokenizerFast

    bs = list(range(0x21, 0x7F)) + list(range(0xA1, 0xAD)) + \
        list(range(0xAE, 0x100))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    byte2uni = {b: chr(c) for b, c in zip(bs, cs)}
    vocab = {byte2uni[b]: b for b in range(256)}
    merges = []
    for pair in [('{', '"'), ('"', ':'), ('t', 'r'), ('tr', 'u')]:
        vocab[pair[0] + pair[1]] = len(vocab)
        merges.append(pair)
    tk = tokenizers.Tokenizer(tokenizers.models.BPE(vocab=vocab,
                                                    merges=merges))
    tk.pre_tokenizer = tokenizers.pre_tokenizers.ByteLevel(
        add_prefix_space=False)
    tk.decoder = tokenizers.decoders.ByteLevel()
    return PreTrainedTokenizerFast(tokenizer_object=tk), vocab, byte2uni


@pytest.mark.parametrize("pkg", PACKAGES)
def test_token_byte_table_byte_level_bpe(pkg):
    g, _ = pkg
    fast, vocab, byte2uni = _byte_level_bpe()

    class Wrap:
        _tok = fast
        vocab_size = len(fast)
        eos_token_id = None

    tb = g.token_byte_table(Wrap())
    assert tb == jguided.token_byte_table(Wrap())
    assert tb[vocab['{']] == b"{" and tb[vocab['{"']] == b'{"'
    assert tb[vocab[byte2uni[0x20]]] == b" "
    assert tb[vocab[byte2uni[0xE2]]] == b"\xe2"
    gs = g.GuidedState(g.TokenGrammar(g.JsonMachine(top="object"), Wrap(),
                                      []))
    a = _allowed(gs.mask_words(), len(fast))
    assert vocab['{'] in a and vocab['{"'] in a and vocab['"'] not in a
    gs.advance(vocab['{"'])                        # two bytes at once
    assert not gs.dead
    assert vocab['"'] in _allowed(gs.mask_words(), len(fast))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_token_byte_table_sentencepiece_byte_fallback(pkg):
    g, _ = pkg

    class FakeSP:
        class _tok:
            all_special_ids = [0]

            @staticmethod
            def convert_ids_to_tokens(ids):
                return ["<s>", "▁the", "<0x22>", "<0x0A>", "x"][:len(ids)]

        vocab_size = 5
        eos_token_id = 0

    tb = g.token_byte_table(FakeSP())
    assert tb == [None, b" the", b'"', b"\n", b"x"]
    assert tb == jguided.token_byte_table(FakeSP())


def test_token_byte_table_both_tokenizer_branches_like_jax(tmp_path):
    """The port's tokenizers against the JAX ones on the same files: the
    byte tokenizer (no ``_tok``: id = byte) and a checkpoint's
    ``HFTokenizer`` (its ``_tok``, a byte-level BPE) give the JAX table,
    and a json_object grammar over each gives the JAX words."""
    from test_real_checkpoint import _write_byte_level_tokenizer

    _write_byte_level_tokenizer(tmp_path)
    pairs = [(ttok.ByteTokenizer(), jtok.ByteTokenizer()),
             (ttok.HFTokenizer(str(tmp_path)),
              jtok.HFTokenizer(str(tmp_path)))]
    assert not hasattr(pairs[0][0], "_tok") and hasattr(pairs[1][0], "_tok")
    for t, j in pairs:
        assert tguided.token_byte_table(t) == jguided.token_byte_table(j)
        tg = tguided.GuidedState(tguided.TokenGrammar(
            tguided.JsonMachine(top="object"), t, [t.eos_token_id]))
        jg = jguided.GuidedState(jguided.TokenGrammar(
            jguided.JsonMachine(top="object"), j, [j.eos_token_id]))
        for tid in t.encode('{"a": [1, "x"]}'):
            np.testing.assert_array_equal(tg.mask_words(), jg.mask_words())
            tg.advance(tid)
            jg.advance(tid)
        assert (tg.complete, tg.dead) == (jg.complete, jg.dead)
        assert tg.complete or not isinstance(t, ttok.ByteTokenizer)
        np.testing.assert_array_equal(tg.mask_words(), jg.mask_words())


# -- apply_allow --------------------------------------------------------------


@pytest.mark.parametrize("V", [64, 97, 259])
def test_apply_allow_exact_against_jax(V):
    """int32 words carry the uint32 bits: bit 31 set (a negative word) and a
    last word past V give the JAX result, element for element."""
    rng = np.random.default_rng(V)
    W = (V + 31) // 32
    words = rng.integers(0, 2**32, (5, W), dtype=np.uint64).astype(np.uint32)
    words[0] = 0xFFFFFFFF                   # all allowed: no change
    words[1] = np.uint32(1 << 31)           # only bit 31 of each word
    words[2] = 0x80000001
    words[3, -1] = 0xFFFFFFFF               # bits past V set
    logits = rng.normal(size=(5, V)).astype(np.float32)
    want = np.asarray(jsampling.apply_allow(jnp.asarray(logits),
                                            jnp.asarray(words)))
    got = tsampling.apply_allow(torch.from_numpy(logits),
                                torch.from_numpy(words.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[0].numpy(), logits[0])
    banned = tsampling.allow_banned(torch.from_numpy(words.view(np.int32)),
                                    V)
    assert banned.shape == (5, V)
    np.testing.assert_array_equal(
        ~banned[1].numpy(), (np.arange(V) & 31) == 31)


# -- the engines --------------------------------------------------------------

BASE = dict(max_decode_slots=4, max_cache_len=128, page_size=8,
            prefill_buckets=(16, 32), dtype="float32", decode_horizon=4,
            prefix_cache=False)
EOS = jtok.ByteTokenizer.EOS
# whitespace banned (a random model would pad JSON with it forever), closing
# bytes and eos favoured, so that guided answers finish within the budget
PRESSURE = ((ord(' '), -100.0), (ord('\t'), -100.0), (ord('\n'), -100.0),
            (ord('\r'), -100.0), (ord('\\'), -100.0), (ord('"'), 6.0),
            (ord('}'), 6.0), (ord(']'), 4.0), (EOS, 30.0))
SCHEMA_ENUM = {"type": "object",
               "properties": {"kind": {"enum": ["cat", "dog"]},
                              "n": {"type": "integer"}},
               "required": ["kind", "n"]}
SPECS = {
    "json_object": {"response_format": {"type": "json_object"}},
    "json_schema": {"response_format": {"type": "json_schema", "json_schema":
                                        {"schema": SCHEMA_ENUM}}},
    "regex": {"guided_regex": r"[A-Z]{3}-\d{2}"},
    "choice": {"guided_choice": ["alpha", "beta", "gamma"]},
}


@pytest.fixture(scope="module")
def model():
    tok = jtok.ByteTokenizer()
    jcfg = jax_tiny(vocab_size=tok.vocab_size, eos_token_id=tok.eos_token_id)
    params = init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)

    def scale(node):
        return {k: scale(v) if isinstance(v, dict) else
                v * 8 if k == "kernel" else v for k, v in node.items()}

    params = scale(params)
    params["embed"] = {"weight": params["embed"]["weight"] * 8}
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    tparams = from_jax_params(jax.tree.map(np.asarray, params), tcfg)
    return jcfg, params, tcfg, tparams


def _engines(model, jax_pipeline=None, **serving):
    """(JAX engine, port engine) on the same weights; the JAX engine's
    pipeline is ``jax_pipeline`` (default: the port's)."""
    jcfg, jparams, tcfg, tparams = model
    serving = {**BASE, **serving}
    jserving = dict(serving)
    if jax_pipeline is not None:
        jserving["decode_pipeline"] = jax_pipeline
    je = JEngine(jcfg, jparams, JServing(weights_dtype="bf16",
                                         attention_impl="xla", **jserving))
    te = TEngine(tcfg, tparams, TServing(weights_dtype="bf16", **serving),
                 device="cpu")
    return je, te


def _grammars(kind):
    """(JAX grammar, port grammar) of a SPECS entry, each over its
    package's byte tokenizer."""
    jt, tt = jtok.ByteTokenizer(), ttok.ByteTokenizer()
    return (jguided.grammar_for_request(jt, SPECS[kind], [EOS]),
            tguided.grammar_for_request(tt, SPECS[kind], [EOS]))


def _run_jax(je):
    while (any(s is not None for s in je.slot_req) or je.pending
           or je._chunk is not None or je._inflight is not None):
        je.step()


def _submit_both(je, te, specs):
    """Submit (prompt, fields) pairs to both engines; a ``guided`` field is
    a (JAX grammar, port grammar) pair. Returns (JAX requests, port
    requests) after running both until idle."""
    jr, tr = [], []
    for prompt, f in specs:
        jf, tf = dict(f), dict(f)
        if "guided" in f:
            jf["guided"], tf["guided"] = f["guided"]
        jr.append(je.submit(JRequest(prompt_ids=list(prompt), **jf)))
        tr.append(te.submit(TRequest(prompt_ids=list(prompt), **tf)))
    _run_jax(je)
    te.run_until_idle()
    return jr, tr


def _check_answer(kind, req):
    """A finished guided answer parses, or matches its regex or choice."""
    if req.finish_reason != "stop":
        return
    text = bytes(t for t in req.generated if t < 256).decode("utf-8",
                                                            "replace")
    if kind == "json_object":
        assert isinstance(json.loads(text), dict), text
    elif kind == "json_schema":
        obj = json.loads(text)
        assert obj["kind"] in ("cat", "dog") and isinstance(obj["n"], int)
    elif kind == "regex":
        assert re.fullmatch(SPECS["regex"]["guided_regex"], text), text
    else:
        assert text in SPECS["choice"]["guided_choice"], text


LAYOUTS = {"paged": dict(), "paged-sync": dict(decode_pipeline=0),
           "dense": dict(paged=False)}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("kind", sorted(SPECS))
def test_guided_streams_like_jax(model, kind, layout):
    """A greedy and a seeded guided request beside an unguided neighbour:
    every stream is the JAX engine's (without its pipeline, C26), each
    finished guided answer parses, and the neighbour's stream is its stream
    without the guided requests."""
    je, te = _engines(model, jax_pipeline=0, **LAYOUTS[layout])
    g = _grammars(kind)
    neighbour = (b"hello there", dict(max_tokens=20, ignore_eos=True))
    specs = [(b"answer:", dict(guided=g, max_tokens=40,
                               logit_bias=PRESSURE)),
             (b"again:", dict(guided=g, max_tokens=40, temperature=0.9,
                              top_p=0.95, seed=7, logit_bias=PRESSURE)),
             neighbour]
    jr, tr = _submit_both(je, te, specs)
    for a, b in zip(jr, tr):
        assert b.generated == a.generated, (kind, a.generated, b.generated)
        assert b.finish_reason == a.finish_reason
    for r in tr[:2]:
        assert isinstance(r.guided, tguided.GuidedState)
        _check_answer(kind, r)
    solo = te.submit(TRequest(prompt_ids=list(neighbour[0]), **neighbour[1]))
    te.run_until_idle()
    assert solo.generated == tr[2].generated
    if layout != "paged-sync" and kind in ("json_object", "json_schema"):
        assert te.counts["allow_words_hits"] > 0 or \
            te.counts["allow_host_ns"] > 0


@pytest.mark.parametrize("kind", ["json_object", "choice"])
def test_guided_alone_like_jax_with_its_pipeline(model, kind):
    """Guided slots alone decode at horizon 1, where the JAX pipeline is
    sound: two guided requests on one grammar (the n = 2 of the server:
    each takes a cursor of its own) give the JAX engine's streams with the
    pipeline on both sides."""
    je, te = _engines(model)
    g = _grammars(kind)
    specs = [(b"pick:", dict(guided=g, max_tokens=30, temperature=0.8,
                             seed=s, logit_bias=PRESSURE)) for s in (3, 4)]
    jr, tr = _submit_both(je, te, specs)
    assert [r.generated for r in tr] == [r.generated for r in jr]
    assert tr[0].guided is not tr[1].guided
    assert te.counts["decode_substeps"] == te.counts["decode_dispatches"]


def test_c26_jax_pipeline_feeds_guided_surplus(model):
    """ROADMAP C26, pinned: beside an unguided neighbour at horizon 4, the
    JAX pipeline keeps the device carry after a guided slot emitted
    substep 0 alone, so the guided slot's next token is drawn after the
    discarded substeps' rows; its stream then differs from the JAX engine
    without the pipeline, which the port's equals with the pipeline on and
    off."""
    g = _grammars("json_object")
    specs = [(b"json please:", dict(guided=g, max_tokens=40,
                                    logit_bias=PRESSURE[:4])),
             (b"hello", dict(max_tokens=20, ignore_eos=True))]
    j_on, t_on = _engines(model)
    j_off, t_off = _engines(model, decode_pipeline=0)
    on = _submit_both(j_on, t_on, specs)
    off = _submit_both(j_off, t_off, specs)
    assert on[0][0].generated != off[0][0].generated
    assert on[1][0].generated == off[1][0].generated == off[0][0].generated
    assert on[0][1].generated == off[0][1].generated == on[1][1].generated


def test_guided_chunk_walk_like_jax(model):
    """A guided prompt longer than the chunk walks ``mixed_step`` (paged)
    with its own ``pallow`` row beside a guided decode row; the chunk row's
    mask is uploaded once for the walk."""
    je, te = _engines(model, jax_pipeline=0, prefill_chunk=16,
                      prefill_buckets=(16,))
    g = _grammars("json_schema")
    specs = [(b"short:", dict(guided=g, max_tokens=30, logit_bias=PRESSURE)),
             (bytes(range(40, 100)), dict(guided=g, max_tokens=30,
                                          logit_bias=PRESSURE))]
    jr, tr = _submit_both(je, te, specs)
    assert [r.generated for r in tr] == [r.generated for r in jr]
    assert te.counts["mixed_dispatches"] >= 4
    assert te.counts["allow_words_hits"] > 0


def test_allow_words_write_only_changed_rows(model):
    """The decode operand's allow words: a dispatch writes the rows of the
    guided slots whose cursor moved (one row here, never the whole
    operand) and leaves every other row all ones; once the guided request
    has left, its slot's row is all ones again."""
    _, _, tcfg, tparams = model
    te = TEngine(tcfg, tparams, TServing(weights_dtype="bf16", **BASE),
                 device="cpu")
    g = _grammars("choice")[1]
    near = te.submit(TRequest(prompt_ids=list(b"hello"), max_tokens=40,
                              ignore_eos=True))
    guided = te.submit(TRequest(prompt_ids=list(b"pick:"), guided=g,
                                max_tokens=30, logit_bias=PRESSURE))
    shapes = []
    upload = te._upload

    def spy(dst, arr):
        if arr.shape[-1] == 1 + te.decoder.allow.shape[1]:
            shapes.append(arr.shape)
        upload(dst, arr)

    te._upload = spy
    while not guided.finish_reason:
        te.step()
        rows = te.decoder.allow.numpy()
        gslots = set(te._allow_key)
        assert all((rows[s] == -1).all() for s in range(len(rows))
                   if s not in gslots)
        assert all((rows[s] != -1).any() for s in gslots)
    assert guided.generated and shapes
    assert all(n == 1 for n, _ in shapes)
    te.step()
    assert not te._allow_key and (te.decoder.allow.numpy() == -1).all()
    te.run_until_idle()
    assert len(near.generated) == 40
    _check_answer("choice", guided)


def test_penalized_guided_keeps_counts_exact(model):
    """A penalized guided slot beside an unguided one rides the horizon of 4
    and emits substep 0 alone: its count row is restored from its stream,
    so its tokens are its solo run's and the JAX engine's."""
    g = _grammars("json_object")
    kw = dict(guided=g, max_tokens=40, frequency_penalty=0.8,
              presence_penalty=0.3, logit_bias=PRESSURE)
    je, te = _engines(model, jax_pipeline=0)
    jr, tr = _submit_both(je, te, [(b"alone:", kw),
                                   (b"n", dict(max_tokens=30,
                                               ignore_eos=True))])
    assert [r.generated for r in tr] == [r.generated for r in jr]
    _, solo_eng = _engines(model)
    solo = solo_eng.submit(TRequest(prompt_ids=list(b"alone:"),
                                    **{**kw, "guided": g[1]}))
    solo_eng.run_until_idle()
    assert solo.generated == tr[0].generated


def test_guided_neighbour_keeps_speculation_like_jax(model):
    """Prompt-lookup speculation skips the guided slot (its mask needs the
    cursor between every two tokens) and keeps drafting for its repetitive
    neighbour; every stream is the JAX engine's."""
    je, te = _engines(model, jax_pipeline=0, spec_decode=True, spec_k=4,
                      spec_ngram=3, prefill_buckets=(32,))
    g = _grammars("json_object")
    specs = [([5, 6, 7] * 5, dict(max_tokens=20, ignore_eos=True)),
             (b"x:", dict(guided=g, max_tokens=30, logit_bias=PRESSURE))]
    jr, tr = _submit_both(je, te, specs)
    assert [r.generated for r in tr] == [r.generated for r in jr]
    assert te.counts["spec_drafted_tokens"] > 0


def test_guided_submit_refusals_like_jax(model):
    _, te = _engines(model)
    tt = ttok.ByteTokenizer()
    choice = tguided.grammar_for_request(tt, SPECS["choice"], [EOS])
    with pytest.raises(ValueError, match="min_tokens"):
        te.submit(TRequest(prompt_ids=[1, 2], guided=choice, min_tokens=3))
    with pytest.raises(ValueError, match="TokenGrammar or GuidedState"):
        te.submit(TRequest(prompt_ids=[1, 2], guided="not-a-grammar"))
    big = tguided.TokenGrammar(tguided.JsonMachine(top="object"),
                               type("Big", (), {"vocab_size": 300})(), [EOS])
    with pytest.raises(ValueError, match="exceeds model vocab"):
        te.submit(TRequest(prompt_ids=[1, 2], guided=big))
    # a json grammar keeps whitespace open when it accepts: allowed
    js = tguided.grammar_for_request(tt, SPECS["json_object"], [EOS])
    r = te.submit(TRequest(prompt_ids=[1, 2], guided=js, min_tokens=2,
                           max_tokens=12, logit_bias=PRESSURE))
    te.run_until_idle()
    assert len(r.generated) >= 2


# -- HTTP ---------------------------------------------------------------------

_BIAS = {str(t): v for t, v in PRESSURE}
_HTTP = {
    "json_object": ("/v1/chat/completions",
                    {"messages": [{"role": "user", "content": "json please"}],
                     **SPECS["json_object"], "max_tokens": 60,
                     "temperature": 0.0, "logit_bias": _BIAS}),
    "json_schema-n2": ("/v1/completions",
                       {"prompt": "v:", "n": 2, "seed": 3,
                        "temperature": 0.7, **SPECS["json_schema"],
                        "max_tokens": 48, "logit_bias": _BIAS}),
    "guided_json": ("/v1/completions",
                    {"prompt": "j:", "guided_json": {
                        "type": "object",
                        "properties": {"ok": {"type": "boolean"}},
                        "required": ["ok"]},
                     "max_tokens": 32, "logit_bias": _BIAS}),
    "regex": ("/v1/completions", {"prompt": "code:", **SPECS["regex"],
                                  "max_tokens": 16}),
    "choice": ("/v1/completions", {"prompt": "pick:", **SPECS["choice"],
                                   "max_tokens": 16}),
    "text": ("/v1/completions", {"prompt": "hi", "max_tokens": 6,
                                 "response_format": {"type": "text"}}),
}


@pytest.mark.parametrize("case", sorted(_HTTP))
def test_http_guided_like_the_jax_server(twin_server, jax_server, case):
    (base, _), (jbase, _) = twin_server, jax_server
    url, body = _HTTP[case]
    got, want = _post(base + url, body), _post(jbase + url, body)
    assert got[0] == want[0] == 200, (got, want)
    key = "message" if "chat" in url else "text"
    texts = [c[key]["content"] if key == "message" else c[key]
             for c in got[1]["choices"]]
    assert texts == [c[key]["content"] if key == "message" else c[key]
                     for c in want[1]["choices"]]
    assert [c["finish_reason"] for c in got[1]["choices"]] == \
        [c["finish_reason"] for c in want[1]["choices"]]
    if case == "regex":
        assert re.fullmatch(SPECS["regex"]["guided_regex"], texts[0])
    if case == "choice":
        assert texts[0] in SPECS["choice"]["guided_choice"]


def _sse_text(base, url, body):
    import urllib.request

    req = urllib.request.Request(base + url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        raw = r.read().decode()
    text = {}
    for line in raw.splitlines():
        if line.startswith("data: ") and line != "data: [DONE]":
            ch = json.loads(line[6:])["choices"]
            for c in ch:
                piece = c.get("text") if "text" in c else \
                    c.get("delta", {}).get("content")
                text[c["index"]] = text.get(c["index"], "") + (piece or "")
    return text


@pytest.mark.parametrize("n", [1, 2])
def test_http_guided_stream_like_the_jax_server(twin_server, jax_server, n):
    (base, _), (jbase, _) = twin_server, jax_server
    body = {"prompt": "stream json:", "stream": True, "n": n, "seed": 5,
            "temperature": 0.6, **SPECS["json_object"], "max_tokens": 60,
            "logit_bias": _BIAS}
    got = _sse_text(base, "/v1/completions", body)
    assert got == _sse_text(jbase, "/v1/completions", body)
    assert len(got) == n


_GUIDED_400 = {
    "rf-string": {"response_format": "json"},
    "rf-type": {"response_format": {"type": "grammar"}},
    "rf-no-schema": {"response_format": {"type": "json_schema"}},
    "rf-ref": {"response_format": {"type": "json_schema", "json_schema": {
        "schema": {"$ref": "#/a"}}}},
    "regex-lookahead": {"guided_regex": "(?=bad)"},
    "regex-empty": {"guided_regex": ""},
    "choice-empty": {"guided_choice": []},
    "json-not-object": {"guided_json": "x"},
    "two-specs": {"guided_regex": "a+", "guided_choice": ["a"]},
    "min-tokens-exact": {"guided_choice": ["a", "b"], "min_tokens": 2},
}


@pytest.mark.parametrize("case", sorted(_GUIDED_400))
def test_http_guided_400_like_the_jax_server(twin_server, jax_server, case):
    (base, _), (jbase, _) = twin_server, jax_server
    body = {"prompt": "x", "max_tokens": 4, **_GUIDED_400[case]}
    got = _post(base + "/v1/completions", body)
    want = _post(jbase + "/v1/completions", body)
    assert got[0] == want[0] == 400, (got, want)
    assert got[1]["error"]["message"] == want[1]["error"]["message"]
