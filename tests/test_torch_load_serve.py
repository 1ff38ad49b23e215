"""Serving a checkpoint directory with the port, on the CPU: ``build_state``
from a tiny HF checkpoint (config, safetensors, a byte-level BPE tokenizer
with a chat template) against the JAX server built on the same directory;
a draft model from its own directory; ``Engine.warmup`` leaving the engine
as it found it; the memory-fit manifest (``serving/aot.py``) and the
server's ``--aot-manifest``, ``--no-warmup`` and checkpoint flags."""

import dataclasses
import json
import re
import socket
import threading

import numpy as np
import pytest
import torch

from aws_k8s_ansible_provisioner_tpu_torch.config import (ServingConfig,
                                                          tiny_qwen3)
from aws_k8s_ansible_provisioner_tpu_torch.models.layers import init_params
from aws_k8s_ansible_provisioner_tpu_torch.serving import aot
from aws_k8s_ansible_provisioner_tpu_torch.serving import server as tserver
from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import (Engine,
                                                                  Request)
from test_torch_server import _post
from test_torch_tokenizer import _CHAT_TEMPLATE

torch.set_num_threads(2)

SERVE = dict(max_decode_slots=4, max_cache_len=128, page_size=8,
             prefill_buckets=(16, 32, 64), dtype="float32", prefill_chunk=16,
             weights_dtype="bf16", derived_seed=0)


def _write_checkpoint(path, seed: int, layers: int = 2):
    """A tiny Qwen3 HF directory: random weights from ``seed``, the
    byte-level BPE tokenizer with a chat template."""
    from test_model_parity import _hf_qwen3
    from test_real_checkpoint import _write_byte_level_tokenizer

    from aws_k8s_ansible_provisioner_tpu.config import tiny_qwen3 as jtiny

    torch.manual_seed(seed)
    model = _hf_qwen3(jtiny(vocab_size=256, num_layers=layers))
    if seed:
        with torch.no_grad():
            for p in model.parameters():
                p.add_(0.01 * torch.randn_like(p))
    model.save_pretrained(path, safe_serialization=True)
    _write_byte_level_tokenizer(path)
    cfg = json.loads((path / "tokenizer_config.json").read_text())
    cfg["chat_template"] = _CHAT_TEMPLATE
    (path / "tokenizer_config.json").write_text(json.dumps(cfg))
    return str(path)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return _write_checkpoint(tmp_path_factory.mktemp("serve") / "tiny-hf", 0)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def servers(ckpt):
    """The JAX and the port server, each built by its ``build_state`` from
    the checkpoint directory, in process on free ports."""
    from aws_k8s_ansible_provisioner_tpu.config import \
        ServingConfig as JServing
    from aws_k8s_ansible_provisioner_tpu.serving import server as jserver

    jstate = jserver.build_state(JServing(model="tiny", checkpoint_dir=ckpt,
                                          **SERVE))
    jport = _free_port()
    ready, stop = threading.Event(), threading.Event()
    jth = threading.Thread(target=jserver.serve,
                           args=(jstate, "127.0.0.1", jport, ready, stop),
                           daemon=True)
    jth.start()
    assert ready.wait(60)
    state = tserver.build_state(ServingConfig(model="tiny",
                                              checkpoint_dir=ckpt, **SERVE),
                                device="cpu")
    srv = tserver.make_server(state, "127.0.0.1", 0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    state.start_engine()
    yield ((f"http://127.0.0.1:{srv.server_address[1]}", state),
           (f"http://127.0.0.1:{jport}", jstate))
    srv.shutdown()
    srv.server_close()
    state.stop_engine()
    th.join(10)
    stop.set()
    jth.join(30)


def test_build_state_reads_the_checkpoint(servers, ckpt):
    """The port's state: the directory's config (as the JAX server's), its
    HF tokenizer and its eos, its weights as converted."""
    from aws_k8s_ansible_provisioner_tpu_torch.models.hf_loader import \
        load_checkpoint
    from aws_k8s_ansible_provisioner_tpu_torch.utils.tokenizer import \
        HFTokenizer

    (_, state), (_, jstate) = servers
    eng = state.engine
    assert dataclasses.asdict(eng.cfg) == dataclasses.asdict(jstate.engine.cfg)
    assert isinstance(state.tokenizer, HFTokenizer)
    assert eng.eos_token_id == state.tokenizer.eos_token_id == \
        jstate.engine.eos_token_id
    want = load_checkpoint(ckpt, eng.cfg, torch.float32, device="cpu")
    got = eng.model.params
    for key in ("wq", "w_down", "q_norm"):
        name = "kernel" if key != "q_norm" else "weight"
        assert torch.equal(got["layers"][key][name],
                           want["layers"][key][name])
    assert torch.equal(got["embed"]["weight"], want["embed"]["weight"])


_BODIES = {
    "greedy": {"prompt": "hello,world", "max_tokens": 10},
    "greedy-ignore-eos": {"prompt": "abc", "max_tokens": 12,
                          "ignore_eos": True},
    "seeded": {"prompt": "xyz!", "max_tokens": 10, "temperature": 0.9,
               "top_p": 0.9, "seed": 7, "ignore_eos": True},
    "logprobs": {"prompt": "q=1", "max_tokens": 6, "logprobs": 2,
                 "ignore_eos": True},
}


@pytest.mark.parametrize("case", sorted(_BODIES))
def test_completions_answer_like_the_jax_server(servers, case):
    (base, _), (jbase, _) = servers
    body = _BODIES[case]
    got, want = _post(base + "/v1/completions", body), \
        _post(jbase + "/v1/completions", body)
    assert got[0] == want[0] == 200, (got, want)
    g, w = got[1]["choices"][0], want[1]["choices"][0]
    assert (g["text"], g["finish_reason"]) == (w["text"], w["finish_reason"])
    counts = ("prompt_tokens", "completion_tokens", "total_tokens")
    assert [got[1]["usage"][k] for k in counts] == \
        [want[1]["usage"][k] for k in counts]
    if body.get("logprobs"):
        assert g["logprobs"]["tokens"] == w["logprobs"]["tokens"]
        np.testing.assert_allclose(g["logprobs"]["token_logprobs"],
                                   w["logprobs"]["token_logprobs"],
                                   atol=1e-4)


@pytest.mark.parametrize("gen", [True, False])
def test_chat_answers_like_the_jax_server_with_the_tokenizer_template(
        servers, gen):
    """/v1/chat/completions renders with the tokenizer's own template on
    both servers: the same answer."""
    (base, state), (jbase, _) = servers
    messages = [{"role": "system", "content": "Be brief."},
                {"role": "user", "content": "hi there"}]
    if not gen:
        messages.append({"role": "assistant", "content": "ok"})
    body = {"messages": messages, "max_tokens": 8, "temperature": 0.0,
            "ignore_eos": True}
    got, want = _post(base + "/v1/chat/completions", body), \
        _post(jbase + "/v1/chat/completions", body)
    assert got[0] == want[0] == 200, (got, want)
    assert got[1]["choices"][0]["message"] == want[1]["choices"][0]["message"]
    assert got[1]["usage"] == {k: want[1]["usage"][k]
                               for k in got[1]["usage"]}
    rendered = state.templater.render(messages)
    assert rendered.startswith("<|system|>Be brief.\n<|user|>hi there")


@pytest.mark.parametrize("sampled", [False, True])
def test_engine_token_ids_equal_the_jax_engine(servers, sampled):
    """The token ids themselves, greedy and seeded, through both engines
    built from the directory."""
    from aws_k8s_ansible_provisioner_tpu.serving.engine import \
        Request as JRequest

    (_, state), (_, jstate) = servers
    kw = dict(temperature=0.8, top_k=20, seed=3) if sampled else {}
    prompts = [state.tokenizer.encode(p) for p in
               ("hello,world", "a" * 40, "0123456789")]
    got = [state.engine.submit(Request(prompt_ids=list(p), max_tokens=12,
                                       ignore_eos=True, **kw))
           for p in prompts]
    want = [jstate.engine.submit(JRequest(prompt_ids=list(p), max_tokens=12,
                                          ignore_eos=True, **kw))
            for p in prompts]
    assert [r.wait(120) for r in got] == [r.wait(120) for r in want]


# -- the draft model from its directory ---------------------------------------


def test_draft_from_its_checkpoint_gives_the_greedy_stream(tmp_path, ckpt):
    """``--spec-method draft --draft-checkpoint-dir``: the draft loads from
    its own directory (another model, one layer), drafts and is verified;
    the greedy streams equal those with speculation off. Without the
    directory ``build_state`` raises, as the JAX one does."""
    draft_dir = _write_checkpoint(tmp_path / "draft-hf", 1, layers=1)
    args = tserver.build_parser().parse_args([
        "--device", "cpu", "--checkpoint-dir", ckpt, "--spec-decode",
        "--spec-method", "draft", "--draft-checkpoint-dir", draft_dir,
        "--max-decode-slots", "4", "--max-cache-len", "128",
        "--page-size", "8", "--dtype", "float32", "--weights-dtype", "bf16"])
    serving = dataclasses.replace(tserver.serving_config(args),
                                  prefill_buckets=(16, 32, 64))
    assert (serving.spec_method, serving.draft_checkpoint_dir,
            serving.checkpoint_dir) == ("draft", draft_dir, ckpt)
    spec = tserver.build_state(serving, device="cpu")
    assert spec.engine.draft is not None
    assert spec.engine.draft.cfg.num_layers == 1
    plain = tserver.build_state(dataclasses.replace(serving,
                                                    spec_decode=False),
                                device="cpu")
    prompts = [[5, 6, 7, 5, 6, 7, 5, 6], list(range(30, 70)), [9] * 12]
    streams = []
    for st in (spec, plain):
        reqs = [st.engine.submit(Request(prompt_ids=p, max_tokens=20,
                                         ignore_eos=True)) for p in prompts]
        st.engine.run_until_idle()
        streams.append([r.generated for r in reqs])
    assert streams[0] == streams[1]
    assert spec.engine.counts["spec_dispatches"] > 0
    assert spec.engine.counts["draft_rollout_substeps"] > 0
    with pytest.raises(ValueError, match="draft-checkpoint-dir"):
        tserver.build_state(dataclasses.replace(serving,
                                                draft_checkpoint_dir=""),
                            device="cpu")


# -- warmup -------------------------------------------------------------------


_WARM_CASES = {
    "paged-auto": dict(),
    "paged-int8": dict(kv_dtype="int8"),
    "paged-spec": dict(spec_decode=True),
    "paged-draft": dict(spec_decode=True, spec_method="draft"),
    "dense-auto": dict(paged=False),
    "dense-int8-spec": dict(paged=False, kv_dtype="int8", spec_decode=True),
}


def _snapshot(engine) -> dict:
    """Everything warmup must leave as it found it (the paged pool without
    its scratch page 0; the dense cache's prefix-source rows)."""
    snap = {
        "counts": dict(engine.counts),
        "metrics": [ln for ln in engine.metrics.registry.render().splitlines()
                    if "compile_seconds" not in ln],
        "host": [engine.lengths.tolist(), engine.last_token.tolist(),
                 list(engine._free), list(engine._slot_tokens),
                 engine._seq_counter, engine._admit_seq.tolist(),
                 engine._py_rng.getstate()],
        "decoder": [t.clone() for t in (engine.decoder.tokens,
                                        engine.decoder.lengths,
                                        engine.decoder.counts)],
    }
    if engine.paged:
        a = engine.allocator
        snap["alloc"] = [list(a._free), a._ref.tolist(), dict(a._page_key),
                         dict(a._hash_to_page), list(a._evictable),
                         engine.table.tolist()]
        tier = engine.host_tier
        snap["tier"] = (None if tier is None else
                        [list(tier._entries), tier.used_bytes,
                         list(tier._free_slots)])
        snap["pool"] = {k: v[:, 1:].clone() for k, v in engine.cache.items()}
    else:
        snap["pool"] = {
            (k, s): v[:, s, :, :len(toks)].clone()
            for k, v in engine.cache.items()
            for s, toks in enumerate(engine._slot_tokens) if toks}
    if engine.draft is not None:
        snap["draft"] = [engine.draft.lens.tolist(),
                         engine.draft.stale.tolist()]
    return snap


def _same(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("case", sorted(_WARM_CASES))
def test_warmup_leaves_the_engine_as_it_found_it(case):
    """Two engines serve the same first wave (prefix pages indexed, pages
    spilled to the host tier, dense prefix sources); one then warms up. The
    warmup changes no count, metric but the compile seconds, page, table,
    prefix index, tier entry, seed draw or cache row that a request reads;
    the second wave (prefix hits, chunk walks, seeded and greedy) then
    streams alike on both."""
    cfg = tiny_qwen3(max_seq_len=128)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         torch.float32)
    kw = dict(SERVE, kv_pool_pages=24, **_WARM_CASES[case])
    serving = ServingConfig(**kw)
    draft = (cfg, params) if kw.get("spec_method") == "draft" else None
    engines = [Engine(cfg, params, serving, device="cpu", draft=draft)
               for _ in range(2)]
    rng = np.random.default_rng(0)
    base = rng.integers(2, cfg.vocab_size, 60).tolist()
    wave1 = [base[:40], base[:20] + [3] * 5, rng.integers(
        2, cfg.vocab_size, 50).tolist(), [7, 8, 9, 7, 8, 9, 7, 8]]
    wave2 = [base[:56], base[:40] + [4] * 9, [7, 8, 9, 7, 8, 9, 7, 8, 9],
             rng.integers(2, cfg.vocab_size, 33).tolist()]
    for eng in engines:
        for p in wave1:
            eng.submit(Request(prompt_ids=p, max_tokens=9, ignore_eos=True))
        eng.run_until_idle()
    warm, cold = engines
    before = _snapshot(warm)
    record = []
    secs = warm.warmup(record)
    _same(before, _snapshot(warm))
    names = [r["name"] for r in record]
    assert warm.metrics.compile_seconds.total() == pytest.approx(secs)
    assert secs > 0 and all(r["peak_bytes"] is None for r in record)
    assert {f"prefill_b{b}" for b in warm.buckets} <= set(names)
    assert (f"mixed_c16" in names) == warm.paged
    assert (f"chunk_c16" in names) == (not warm.paged)
    assert ("spec_verify_r5" in names) == bool(kw.get("spec_decode"))
    assert ("draft_rollout_k4" in names) == (draft is not None)
    streams = []
    for eng in engines:
        reqs = [eng.submit(Request(prompt_ids=p, max_tokens=11,
                                   ignore_eos=True,
                                   **(dict(temperature=0.9, seed=5)
                                      if i == 3 else {})))
                for i, p in enumerate(wave2)]
        eng.run_until_idle()
        streams.append([r.generated for r in reqs])
    assert streams[0] == streams[1]
    assert dict(warm.counts) == dict(cold.counts)
    if warm.paged and not kw.get("spec_decode"):
        assert warm.counts["prefix_cache_hits"] > 0


def test_warmup_refuses_a_busy_engine():
    cfg = tiny_qwen3(max_seq_len=128)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         torch.float32)
    eng = Engine(cfg, params, ServingConfig(**SERVE), device="cpu")
    eng.submit(Request(prompt_ids=[1, 2, 3], max_tokens=4))
    with pytest.raises(RuntimeError, match="idle"):
        eng.warmup()


# -- the memory-fit manifest --------------------------------------------------


@pytest.fixture(scope="module")
def tiny_engines():
    """The port engine and the JAX engine of one tiny configuration."""
    from aws_k8s_ansible_provisioner_tpu.config import ModelConfig as JCfg
    from aws_k8s_ansible_provisioner_tpu.config import \
        ServingConfig as JServing
    from aws_k8s_ansible_provisioner_tpu.serving.engine import \
        Engine as JEngine
    import jax
    import jax.numpy as jnp

    from aws_k8s_ansible_provisioner_tpu.models.layers import \
        init_params as jinit

    cfg = tiny_qwen3(max_seq_len=128)
    kw = dict(SERVE)
    del kw["derived_seed"]
    eng = Engine(cfg, init_params(cfg, torch.Generator().manual_seed(0),
                                  torch.float32),
                 ServingConfig(**kw), device="cpu")
    jcfg = JCfg(**dataclasses.asdict(cfg))
    jserving = JServing(**kw)
    jeng = JEngine(jcfg, jinit(jcfg, jax.random.PRNGKey(0), jnp.float32),
                   jserving)
    return eng, jeng, jcfg, jserving


def _jax_manifest(jcfg, jserving) -> dict:
    """A structurally valid JAX manifest of the JAX engine's program set
    (its checks read the fingerprint, the ledger and the schema)."""
    from aws_k8s_ansible_provisioner_tpu.serving import aot as jaot

    plan = jaot.ProgramPlan(jcfg, jserving)
    return {"schema": jaot.MANIFEST_SCHEMA, "platform": "host",
            "config": plan.fingerprint(),
            "programs": [dict({f: 0 for f in jaot.PROGRAM_FIELDS},
                              name="prefill_b16")],
            "hbm_ledger": dict({f: 1 for f in jaot.LEDGER_FIELDS}, fit=True),
            "total_compile_seconds": 0.0}


_MUTATIONS = {
    "max_len": (lambda m: m["config"].update(max_len=256), ValueError,
                "max_len"),
    "page_size": (lambda m: m["config"].update(page_size=16), ValueError,
                  "page_size"),
    "model": (lambda m: m["config"].update(model="other"), ValueError,
              "model"),
    "no-fit": (lambda m: m["hbm_ledger"].update(fit=False), RuntimeError,
               "NO-FIT"),
    "schema": (lambda m: m.update(schema="v0"), ValueError, "schema"),
    "no-programs": (lambda m: m.update(programs=[]), ValueError,
                    "no programs"),
    "ledger-field": (lambda m: m["hbm_ledger"].pop("total_bytes"),
                     ValueError, "total_bytes"),
}


def test_manifest_of_an_engine_verifies_and_is_adopted(tiny_engines,
                                                       tmp_path):
    """``build_manifest`` warms the idle engine and writes every program
    with its first-run seconds, and the ledger (params, pool, graphs, the
    largest peak against the capacity); the engine adopts it and puts the
    total on ``tpu_serve_hbm_compiled_bytes``."""
    eng = tiny_engines[0]
    m = aot.build_manifest(eng, capacity_bytes=2**30)
    aot.verify_manifest(m)
    led = m["hbm_ledger"]
    assert led["params_bytes_per_chip"] == sum(
        t.numel() * t.element_size() for t in eng.model.buffers())
    assert led["kv_bytes_per_chip"] == sum(
        t.numel() * t.element_size() for t in eng.cache.values())
    assert led["total_bytes"] == led["params_bytes_per_chip"] + \
        led["kv_bytes_per_chip"] + led["graph_pool_bytes"] + \
        led["max_temp_bytes"]
    assert led["fit"] and led["headroom_bytes"] == 2**30 - led["total_bytes"]
    assert {p["name"] for p in m["programs"]} >= {"prefill_b16",
                                                  "mixed_c16"}
    assert m["config"]["max_len"] == eng.max_len == 128
    path = tmp_path / "m.json"
    path.write_text(json.dumps(m))
    got = eng.load_aot_manifest(str(path))
    assert got["fit"] and got["programs"] == len(m["programs"])
    assert eng.metrics.hbm_compiled_bytes.value() == led["total_bytes"]
    assert aot.build_manifest(eng, capacity_bytes=1)["hbm_ledger"]["fit"] \
        is False


@pytest.mark.parametrize("case", sorted(_MUTATIONS))
def test_load_aot_manifest_refuses_like_the_jax_engine(tiny_engines,
                                                       tmp_path, case):
    """Each damage to a manifest is refused by the port's engine with the
    exception the JAX engine raises for the same damage to its own."""
    eng, jeng, jcfg, jserving = tiny_engines
    mutate, exc, match = _MUTATIONS[case]
    jm = _jax_manifest(jcfg, jserving)
    jpath = tmp_path / "jax.json"
    jpath.write_text(json.dumps(jm))
    jeng.load_aot_manifest(str(jpath))          # the undamaged one adopts
    mutate(jm)
    jpath.write_text(json.dumps(jm))
    with pytest.raises(exc, match=match):
        jeng.load_aot_manifest(str(jpath))
    m = aot.build_manifest(eng, capacity_bytes=2**30)
    mutate(m)
    path = tmp_path / "port.json"
    path.write_text(json.dumps(m))
    with pytest.raises(exc, match=match):
        eng.load_aot_manifest(str(path))


@pytest.mark.parametrize("spec", ["prompt_lookup", "draft"])
def test_load_aot_manifest_binds_the_speculation_setup(tiny_engines,
                                                       tmp_path, spec):
    """The port's ledger counts a draft's parameters and cache and its
    program list the verify and draft programs, so a manifest built with
    speculation off is refused by an engine that speculates, and the other
    way round; a manifest naming another draft model is refused too."""
    eng = tiny_engines[0]
    kw = dict(SERVE, spec_decode=True, spec_method=spec)
    del kw["derived_seed"]
    params = init_params(eng.cfg, torch.Generator().manual_seed(0),
                         torch.float32)
    draft = (eng.cfg, params) if spec == "draft" else None
    spec_eng = Engine(eng.cfg, params, ServingConfig(**kw), device="cpu",
                      draft=draft)
    off, on = tmp_path / "off.json", tmp_path / "on.json"
    off.write_text(json.dumps(aot.build_manifest(eng, capacity_bytes=2**30)))
    m = aot.build_manifest(spec_eng, capacity_bytes=2**30)
    on.write_text(json.dumps(m))
    spec_eng.load_aot_manifest(str(on))
    with pytest.raises(ValueError, match="spec_decode"):
        spec_eng.load_aot_manifest(str(off))
    with pytest.raises(ValueError, match="spec_decode"):
        eng.load_aot_manifest(str(on))
    m["config"]["draft"] = "other" if spec == "draft" else eng.cfg.name
    on.write_text(json.dumps(m))
    with pytest.raises(ValueError, match="draft"):
        spec_eng.load_aot_manifest(str(on))


def _tiny_argv(*extra):
    return ["--device", "cpu", "--model", "tiny-qwen3", "--max-cache-len",
            "128", "--max-decode-slots", "4", "--page-size", "8",
            "--prefill-chunk", "32", *extra]


def test_aot_cli_and_server_flags(tmp_path, monkeypatch):
    """``python -m ...serving.aot`` writes the configuration's manifest;
    the server adopts it and warms up before serving; ``--no-warmup``
    skips the warmup; a manifest whose ``max_len`` was edited stops the
    server before warmup."""
    out = tmp_path / "aot.json"
    assert aot.main(_tiny_argv("--out", str(out))) == 0
    m = json.loads(out.read_text())
    aot.verify_manifest(m)
    assert m["config"]["model"] == "tiny-qwen3" and m["platform"] == "cpu"
    calls = []
    real_warmup = Engine.warmup

    def warmup(self, record=None):
        calls.append("warmup")
        return real_warmup(self, record)

    def serve(state, host, port):
        calls.append(("serve", state.engine.metrics.compile_seconds.total(),
                      state.engine.metrics.hbm_compiled_bytes.value()))

    monkeypatch.setattr(Engine, "warmup", warmup)
    monkeypatch.setattr(tserver, "serve", serve)
    tserver.main(_tiny_argv("--aot-manifest", str(out)))
    assert calls[0] == "warmup" and calls[1][0] == "serve"
    assert calls[1][1] > 0
    assert calls[1][2] == m["hbm_ledger"]["total_bytes"]
    calls.clear()
    tserver.main(_tiny_argv("--no-warmup"))
    assert [c[0] for c in calls] == ["serve"] and calls[0][1] == 0
    calls.clear()
    m["config"]["max_len"] = 256
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(m))
    with pytest.raises(ValueError, match="max_len"):
        tserver.main(_tiny_argv("--aot-manifest", str(bad)))
    assert calls == []


def test_build_state_stops_on_the_tokenizers_eos():
    """Without a checkpoint the engine also stops on the tokenizer's eos,
    as the JAX server's engine does (the byte tokenizer's 258 beside the
    model's own)."""
    from aws_k8s_ansible_provisioner_tpu_torch.utils.tokenizer import \
        ByteTokenizer

    cfg = tiny_qwen3(vocab_size=300, eos_token_id=7, max_seq_len=128)
    state = tserver.build_state(ServingConfig(**SERVE), model_cfg=cfg,
                                tokenizer=ByteTokenizer(), device="cpu")
    assert state.engine.eos_token_id == ByteTokenizer.EOS
    assert {7, ByteTokenizer.EOS} <= state.engine._eos_set


def test_random_weights_path_still_warns(caplog):
    import logging

    with caplog.at_level(logging.WARNING):
        state = tserver.build_state(ServingConfig(model="tiny-qwen3",
                                                  **SERVE), device="cpu")
    assert "RANDOM weights" in caplog.text
    assert re.search(r"tiny-qwen3", caplog.text)
    assert state.engine.cfg.name == "tiny-qwen3"


# -- the other families -------------------------------------------------------


def test_registry_and_tiny_builders_equal_the_jax_ones():
    """Every port registry entry and tiny builder equals its JAX
    counterpart field by field, and the port registers every JAX entry,
    Qwen3-30B-A3B (MoE) among them. Mistral-7B-v0.1's ``norm_eps`` is the
    one field apart: the port takes the checkpoint's 1e-5 where the JAX
    registry leaves 1e-6 (ROADMAP C10)."""
    from aws_k8s_ansible_provisioner_tpu import config as jconfig
    from aws_k8s_ansible_provisioner_tpu_torch import config as tconfig

    assert set(tconfig.MODEL_REGISTRY) == set(jconfig.MODEL_REGISTRY)
    assert tconfig.MODEL_REGISTRY["Qwen/Qwen3-30B-A3B"].num_experts == 128
    for name, cfg in tconfig.MODEL_REGISTRY.items():
        want = dataclasses.asdict(jconfig.MODEL_REGISTRY[name])
        if name == "mistralai/Mistral-7B-v0.1":
            want["norm_eps"] = 1e-5
        assert dataclasses.asdict(cfg) == want, name
    for builder in ("tiny_qwen3", "tiny_qwen3_moe", "tiny_mistral",
                    "tiny_llama", "tiny_gemma", "tiny_opt", "tiny_phi"):
        assert dataclasses.asdict(getattr(tconfig, builder)()) == \
            dataclasses.asdict(getattr(jconfig, builder)()), builder
        assert dataclasses.asdict(getattr(tconfig, builder)(num_layers=3)) \
            == dataclasses.asdict(getattr(jconfig, builder)(num_layers=3))


def _write_family_checkpoint(path, fam: str) -> str:
    """A tiny HF directory of ``fam`` (``tests/test_model_parity.py``'s
    builder, or ``tests/test_moe.py``'s for qwen3_moe; seeded) with the
    byte-level BPE tokenizer."""
    from test_model_parity import _hf_gemma, _hf_phi
    from test_moe import _hf_qwen3_moe
    from test_real_checkpoint import _write_byte_level_tokenizer

    from aws_k8s_ansible_provisioner_tpu import config as jconfig

    build = {"phi": _hf_phi, "gemma": _hf_gemma,
             "qwen3_moe": _hf_qwen3_moe}[fam]
    torch.manual_seed(5)
    model = build(getattr(jconfig, f"tiny_{fam}")(vocab_size=256))
    model.save_pretrained(path, safe_serialization=True)
    _write_byte_level_tokenizer(path)
    return str(path)


@pytest.mark.parametrize("fam", ["phi", "gemma", "qwen3_moe"])
def test_family_checkpoint_serves_the_hf_greedy_stream(tmp_path, fam):
    """A tiny phi (LayerNorm, parallel block, partial RoPE, biases), a
    tiny gemma (MQA, zero-centred norms, GeGLU, scaled embedding) and a
    tiny qwen3_moe (router and experts, written by ``save_pretrained``)
    directory served through the server's ``--checkpoint-dir`` flag on the
    CPU (``build_parser`` -> ``serving_config`` -> ``build_state``, as
    ``main`` does): each greedy completion over HTTP is HF ``generate``'s
    greedy stream, decoded by the directory's tokenizer."""
    from transformers import AutoModelForCausalLM

    ckpt = _write_family_checkpoint(tmp_path / f"tiny-{fam}", fam)
    args = tserver.build_parser().parse_args(
        ["--checkpoint-dir", ckpt, "--device", "cpu", "--dtype", "float32",
         "--weights-dtype", "auto", "--max-decode-slots", "4",
         "--max-cache-len", "128", "--page-size", "8"])
    state = tserver.build_state(tserver.serving_config(args),
                                device=args.device)
    cfg = state.engine.cfg
    assert (cfg.parallel_block, cfg.norm_zero_centered,
            cfg.num_experts) == {"phi": (True, False, 0),
                                 "gemma": (False, True, 0),
                                 "qwen3_moe": (False, False, 8)}[fam]
    srv = tserver.make_server(state, "127.0.0.1", 0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    state.start_engine()
    hf = AutoModelForCausalLM.from_pretrained(
        ckpt, local_files_only=True, torch_dtype=torch.float32).eval()
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        for prompt in ("hello w", "The capital of", "12345678"):
            ids = state.tokenizer.encode(prompt)
            with torch.no_grad():
                gen = hf.generate(torch.tensor([ids]), max_new_tokens=8,
                                  do_sample=False, num_beams=1,
                                  eos_token_id=None, pad_token_id=0)
            want = state.tokenizer.decode(gen[0, len(ids):].tolist())
            code, body = _post(base + "/v1/completions",
                               {"prompt": prompt, "max_tokens": 8,
                                "temperature": 0.0, "ignore_eos": True})
            assert code == 200, body
            assert body["choices"][0]["text"] == want, (prompt, body)
            assert body["usage"]["completion_tokens"] == 8
    finally:
        srv.shutdown()
        srv.server_close()
        state.stop_engine()
        th.join(10)


@pytest.mark.parametrize("fam", ["llama", "gemma", "phi", "opt"])
def test_family_chat_templates_render_like_the_jax_server(tmp_path, fam):
    """``--chat-template`` with the family template shipped in
    ``templates/`` (the ConfigMap's ``template.jinja``, as the deploy layer
    mounts it): the port's templater renders every conversation as the JAX
    server's does, with and without the generation prompt."""
    import os

    import yaml

    from aws_k8s_ansible_provisioner_tpu.serving.chat_template import \
        ChatTemplater as JTemplater
    from aws_k8s_ansible_provisioner_tpu_torch.serving.chat_template import \
        ChatTemplater

    src = os.path.join(os.path.dirname(__file__), "..", "templates",
                       f"{fam}-chat-template.yaml")
    with open(src) as fh:
        [(_, tpl)] = yaml.safe_load(fh)["data"].items()
    path = tmp_path / "template.jinja"
    path.write_text(tpl)
    model = {"llama": "meta-llama/Llama-3.2-1B", "gemma": "google/gemma-2b",
             "phi": "microsoft/phi-2", "opt": "facebook/opt-1.3b"}[fam]
    serving = tserver.serving_config(tserver.build_parser().parse_args(
        ["--model", model, "--chat-template", str(path), "--device", "cpu"]))
    assert serving.chat_template == str(path) and serving.model == model
    ours = ChatTemplater(serving.model, template_path=serving.chat_template)
    theirs = JTemplater(serving.model, template_path=serving.chat_template)
    turns = [{"role": "user", "content": "hi"},
             {"role": "assistant", "content": "yo"},
             {"role": "user", "content": "bye?"}]
    for messages in (turns[:1], turns):
        for gen in (True, False):
            got = ours.render(messages, add_generation_prompt=gen)
            assert got == theirs.render(messages, add_generation_prompt=gen)
            assert "bye?" in got or len(messages) == 1


def test_int8_checkpoint_load_quantizes_layer_by_layer(tmp_path):
    """A qwen3_moe directory loaded for an int8 engine
    (``load_checkpoint_cached(quantize=True)``, as ``build_state`` loads
    it): every leaf bit for bit the bf16 tree's ``quantize_params``, the
    int8 tree cached in a directory of its own and restored from it."""
    from aws_k8s_ansible_provisioner_tpu_torch.config import tiny_qwen3_moe
    from aws_k8s_ansible_provisioner_tpu_torch.models import checkpoint as ck
    from aws_k8s_ansible_provisioner_tpu_torch.models.hf_loader import \
        load_checkpoint
    from aws_k8s_ansible_provisioner_tpu_torch.models.quant import \
        quantize_params

    ckpt = _write_family_checkpoint(tmp_path / "tiny-moe", "qwen3_moe")
    cfg = tiny_qwen3_moe(vocab_size=256)
    want = quantize_params(load_checkpoint(ckpt, cfg, torch.bfloat16,
                                           device="cpu"), cfg)
    for attempt in ("miss", "hit"):
        got = ck.load_checkpoint_cached(ckpt, cfg, torch.bfloat16,
                                        device="cpu", quantize=True)
        flat = dict(_leaves(got))
        assert flat.keys() == dict(_leaves(want)).keys()
        for path, t in _leaves(want):
            assert flat[path].dtype == t.dtype, (attempt, path)
            assert torch.equal(flat[path], t), (attempt, path)
    assert (tmp_path / "tiny-moe" / "torch_cache" / "bfloat16-int8").is_dir()
    assert got["layers"]["w_up"]["kernel"].dtype == torch.int8
    assert got["layers"]["router"]["kernel"].dtype == torch.bfloat16


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_tiny_qwen3_moe_server_answers_like_the_jax_server():
    """``--model tiny-qwen3-moe --device cpu``: the port's server builds
    the JAX server's dry-run MoE config (4 layers, hidden 128, the byte
    vocabulary) and, over the JAX server's random weights converted,
    answers a greedy and a seeded completion as the JAX server does."""
    import jax

    from aws_k8s_ansible_provisioner_tpu.config import \
        ServingConfig as JServing
    from aws_k8s_ansible_provisioner_tpu.serving import server as jserver
    from aws_k8s_ansible_provisioner_tpu_torch.models.convert import \
        from_jax_params

    serve = {**SERVE, "prefix_cache": False}
    jstate = jserver.build_state(JServing(model="tiny-qwen3-moe", **serve))
    jport = _free_port()
    ready, stop = threading.Event(), threading.Event()
    jth = threading.Thread(target=jserver.serve,
                           args=(jstate, "127.0.0.1", jport, ready, stop),
                           daemon=True)
    jth.start()
    assert ready.wait(60)
    args = tserver.build_parser().parse_args(
        ["--model", "tiny-qwen3-moe", "--device", "cpu"])
    assert args.model == "tiny-qwen3-moe"
    jcfg = jstate.engine.cfg
    params = from_jax_params(jax.tree.map(np.asarray, jstate.engine.params),
                             jcfg)
    state = tserver.build_state(ServingConfig(model=args.model, **serve),
                                params=params, device=args.device)
    assert dataclasses.asdict(state.engine.cfg) == dataclasses.asdict(jcfg)
    assert (jcfg.num_layers, jcfg.hidden_size, jcfg.num_experts) == \
        (4, 128, 8)
    srv = tserver.make_server(state, "127.0.0.1", 0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    state.start_engine()
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        for body in (_BODIES["greedy-ignore-eos"], _BODIES["seeded"]):
            got = _post(base + "/v1/completions", body)
            want = _post(f"http://127.0.0.1:{jport}/v1/completions", body)
            assert got[0] == want[0] == 200
            assert got[1]["choices"][0]["text"] == \
                want[1]["choices"][0]["text"], body
    finally:
        srv.shutdown()
        srv.server_close()
        state.stop_engine()
        th.join(10)
        stop.set()
        jth.join(30)
