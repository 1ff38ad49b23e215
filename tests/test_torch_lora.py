"""Multi-LoRA in the port against the JAX package, on the CPU.

Adapters are written in the peft format from numpy seeds (the JAX
tests/test_lora.py writer, and once by peft itself) and loaded by both
packages from the same directory. The port's loader gives the JAX
loader's factors and refusals; a zero-B adapter is the base model; an
adapter row's float32 logits lie within 1e-5 of the JAX forward's on the
same directory and of a forward over the merged weights (W + A.B); a mixed
batch (base and two adapters of different ranks and targets) gives every
slot its JAX stream, paged and dense, pipelined and not, through the chunk
walk; the prefix cache never crosses adapters; the verify carries each
slot's adapter; the peft-written adapter follows the peft-wrapped HF
model; the server lists the adapters as models and answers them like the
JAX server; the AOT fingerprint binds their names.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_lora import _write_adapter
from test_torch_server import _get, _jax_params, _post

from aws_k8s_ansible_provisioner_tpu.config import ServingConfig as JServing
from aws_k8s_ansible_provisioner_tpu.config import tiny_qwen3 as jax_tiny
from aws_k8s_ansible_provisioner_tpu.models import lora as jlora
from aws_k8s_ansible_provisioner_tpu.models.layers import init_params
from aws_k8s_ansible_provisioner_tpu.models.layers import \
    lora_context as jlora_context
from aws_k8s_ansible_provisioner_tpu.models.layers import \
    model_forward as jforward
from aws_k8s_ansible_provisioner_tpu.serving.engine import Engine as JEngine
from aws_k8s_ansible_provisioner_tpu.serving.engine import Request as JRequest
from aws_k8s_ansible_provisioner_tpu_torch.config import ModelConfig
from aws_k8s_ansible_provisioner_tpu_torch.config import \
    ServingConfig as TServing
from aws_k8s_ansible_provisioner_tpu_torch.models import lora as tlora
from aws_k8s_ansible_provisioner_tpu_torch.models.convert import \
    from_jax_params
from aws_k8s_ansible_provisioner_tpu_torch.models.layers import (DecoderLM,
                                                                 LoraRows)
from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import \
    Engine as TEngine
from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import \
    Request as TRequest

torch.set_num_threads(2)

JCFG = jax_tiny()
TCFG = ModelConfig(**dataclasses.asdict(JCFG))
ALL = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
       "down_proj")
PROMPT = [5, 9, 2, 11, 7]


def _scaled(params):
    def scale(node):
        return {k: scale(v) if isinstance(v, dict) else
                v * 8 if k == "kernel" else v for k, v in node.items()}

    out = scale(params)
    out["embed"] = {"weight": params["embed"]["weight"] * 8}
    return out


@pytest.fixture(scope="module")
def weights():
    """(JAX params, port params) of tiny_qwen3: float32, seeded."""
    params = init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    return params, from_jax_params(jax.tree.map(np.asarray, params), TCFG)


@pytest.fixture(scope="module")
def scaled():
    """The same weights scaled by 8, so that greedy streams do not collapse
    onto one token."""
    params = _scaled(init_params(JCFG, jax.random.PRNGKey(0),
                                 dtype=jnp.float32))
    return params, from_jax_params(jax.tree.map(np.asarray, params), TCFG)


@pytest.fixture(scope="module")
def adapters(tmp_path_factory):
    """{name: dir}: "a" (r 4, q/v/up), "b" (r 2, q/o/down), "c" (r 3, all
    seven targets, rslora), "zero" (B = 0)."""
    tmp = tmp_path_factory.mktemp("adapters")
    out = {"a": _write_adapter(tmp, "a", JCFG, seed=1),
           "b": _write_adapter(tmp, "b", JCFG, seed=2, rank=2,
                               targets=("q_proj", "o_proj", "down_proj")),
           "c": _write_adapter(tmp, "c", JCFG, seed=3, rank=3, targets=ALL),
           "zero": _write_adapter(tmp, "zero", JCFG, zero_b=True)}
    cfg_path = os.path.join(out["c"], "adapter_config.json")
    acfg = json.load(open(cfg_path))
    acfg["use_rslora"] = True
    json.dump(acfg, open(cfg_path, "w"))
    return out


# -- the loader ---------------------------------------------------------------


def test_load_adapter_like_jax(adapters):
    for path in adapters.values():
        want, got = jlora.load_adapter(path), tlora.load_adapter(path)
        assert got["r"] == want["r"]
        assert sorted(got["targets"]) == sorted(want["targets"])
        for t, (a, b) in want["targets"].items():
            np.testing.assert_array_equal(got["targets"][t][0], a)
            np.testing.assert_array_equal(got["targets"][t][1], b)


def test_stack_adapters_like_jax(adapters):
    loaded = [jlora.load_adapter(adapters[n]) for n in ("a", "b", "c")]
    want = jlora.stack_adapters(loaded, JCFG.num_layers, jnp.float32)
    got = tlora.stack_adapters([tlora.load_adapter(adapters[n])
                                for n in ("a", "b", "c")], JCFG.num_layers)
    assert sorted(got) == sorted(want)
    for t in want:
        for leaf in ("lora_A", "lora_B"):
            np.testing.assert_array_equal(got[t][leaf],
                                          np.asarray(want[t][leaf]))
        assert not got[t]["lora_A"][:, 0].any()        # the base adapter


def _refusal_dirs(tmp_path, adapters):
    """{case: adapter dir} of every adapter the loaders refuse."""
    import shutil

    from safetensors import numpy as st_np

    def variant(case, cfg_over=None, tensors=None):
        d = tmp_path / case
        shutil.copytree(adapters["a"], d)
        if cfg_over:
            cfg = json.load(open(d / "adapter_config.json"))
            cfg.update(cfg_over)
            json.dump(cfg, open(d / "adapter_config.json", "w"))
        if tensors is not None:
            raw = st_np.load_file(str(d / "adapter_model.safetensors"))
            st_np.save_file(tensors(raw), str(d / "adapter_model.safetensors"))
        return str(d)

    def rename(old, new):
        return lambda raw: {k.replace(old, new): v for k, v in raw.items()}

    return {
        "use_dora": variant("use_dora", {"use_dora": True}),
        "lora_bias": variant("lora_bias", {"lora_bias": True}),
        "alpha_pattern": variant("alpha_pattern",
                                 {"alpha_pattern": {"q_proj": 4}}),
        "rank_pattern": variant("rank_pattern",
                                {"rank_pattern": {"q_proj": 2}}),
        "unknown-module": variant("unknown_module",
                                  tensors=rename("up_proj", "embed_tokens")),
        "unknown-tensor": variant("unknown_tensor",
                                  tensors=rename("lora_B.weight",
                                                 "lora_magnitude.weight")),
        "no-layer-index": variant("no_layer", tensors=rename("layers.",
                                                             "blocks.")),
        "missing-layer": variant("missing_layer", tensors=lambda raw: {
            k: v for k, v in raw.items() if ".layers.0." not in k
            or "v_proj" not in k}),
        "no-tensors": variant("no_tensors", tensors=lambda raw: {}),
    }


REFUSALS = ["use_dora", "lora_bias", "alpha_pattern", "rank_pattern",
            "unknown-module", "unknown-tensor", "no-layer-index",
            "missing-layer", "no-tensors"]


@pytest.mark.parametrize("case", REFUSALS)
def test_load_adapter_refusals_like_jax(tmp_path, adapters, case):
    path = _refusal_dirs(tmp_path, adapters)[case]
    with pytest.raises(ValueError) as want:
        jlora.load_adapter(path)
    with pytest.raises(ValueError) as got:
        tlora.load_adapter(path)
    assert str(got.value) == str(want.value)


def test_attach_and_engine_refusals(weights, adapters, tmp_path):
    _, tparams = weights
    stacked = tlora.stack_adapters([tlora.load_adapter(adapters["a"])],
                                   TCFG.num_layers)
    bad = dict(stacked)
    bad["w_nope"] = stacked["wq"]
    with pytest.raises(ValueError, match="model has no target"):
        tlora.attach(tparams, bad, torch.float32)
    short = dataclasses.replace(TCFG, num_layers=TCFG.num_layers + 1)
    with pytest.raises(ValueError, match="adapter layer count"):
        tlora.stack_adapters([tlora.load_adapter(adapters["a"])],
                             short.num_layers)
    from aws_k8s_ansible_provisioner_tpu_torch.config import MeshConfig
    from aws_k8s_ansible_provisioner_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(MeshConfig(sp=2), ["cpu"] * 2)
    with pytest.raises(ValueError, match="multi-LoRA under a mesh"):
        TEngine(TCFG, tparams, TServing(weights_dtype="bf16", paged=False,
                                        max_decode_slots=2,
                                        max_cache_len=64, dtype="float32",
                                        prefill_buckets=(16,)),
                device="cpu", mesh=mesh, lora={"a": adapters["a"]})
    eng = TEngine(TCFG, tparams, TServing(weights_dtype="bf16",
                                          **_serving()),
                  device="cpu", lora={"a": adapters["a"]})
    with pytest.raises(ValueError, match="unknown LoRA adapter"):
        eng.submit(TRequest(prompt_ids=PROMPT, lora="nope"))


# -- the forward --------------------------------------------------------------


def _port_model(tparams, adapters, names, dtype=torch.float32):
    params = tlora.load_attached(tparams, [(n, adapters[n]) for n in names],
                                 TCFG.num_layers, dtype)
    return DecoderLM(TCFG, params)


def _jax_logits(params, adapters, names, idx, tokens):
    loaded = [jlora.load_adapter(adapters[n]) for n in names]
    p = jlora.attach(params, jlora.stack_adapters(loaded, JCFG.num_layers,
                                                  jnp.float32))
    T = tokens.shape[1]
    pos = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32), tokens.shape)
    with jlora_context(jnp.asarray(idx)):
        logits, _ = jforward(p, JCFG, jnp.asarray(tokens), pos)
    return np.asarray(logits)


def test_adapter_logits_like_jax_and_merged_weights(weights, adapters):
    """Rows on the base and on each of three adapters (ranks 2-4, different
    targets, one rslora) in one forward: float32 logits within 1e-5 of the
    JAX forward's (its per-row gather) and of a plain forward over W + A.B
    merged into the base kernels."""
    jparams, tparams = weights
    names = ("a", "b", "c")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, JCFG.vocab_size, (4, 9)).astype(np.int32)
    idx = np.array([0, 1, 2, 3], np.int32)
    model = _port_model(tparams, adapters, names)
    assert model.has_lora
    pos = torch.arange(9, dtype=torch.int32)[None].expand(4, 9)
    got = model(torch.from_numpy(tokens), pos,
                lora=model.lora_rows(torch.from_numpy(idx))).detach().numpy()
    want = _jax_logits(jparams, adapters, names, idx, tokens)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    for row, name in enumerate((None,) + names):
        merged = {**tparams, "layers": dict(tparams["layers"])}
        if name is not None:
            for t, (a, b) in tlora.load_adapter(
                    adapters[name])["targets"].items():
                sub = dict(merged["layers"][t])
                sub["kernel"] = sub["kernel"] + torch.from_numpy(
                    np.einsum("lir,lro->lio", a, b))
                merged["layers"][t] = sub
        ref = DecoderLM(TCFG, merged)(torch.from_numpy(tokens[row:row + 1]),
                                      pos[:1]).detach().numpy()
        np.testing.assert_allclose(got[row:row + 1], ref, atol=1e-5, rtol=0)


def test_per_token_indices_like_per_row(weights, adapters):
    """The mixed dispatch's per-token indices ([1, T]) give each token the
    logits of its row under the per-row form: a packed sequence of two
    adapters' tokens equals, token for token, the batch of one row each
    (the tokens attend alone: one token per row)."""
    _, tparams = weights
    model = _port_model(tparams, adapters, ("a", "c"))
    toks = torch.tensor([[3, 8, 13, 21]], dtype=torch.int32)
    idx = torch.tensor([[0, 1, 2, 1]], dtype=torch.int32)
    pos = torch.zeros((1, 4), dtype=torch.int32)

    def alone(q, k, v, cache_l):
        return v.repeat_interleave(q.shape[2] // v.shape[2], dim=2), cache_l

    packed = model(toks, pos, alone, lora=model.lora_rows(idx)).detach()
    rows = model(toks.T, pos.T, alone, lora=model.lora_rows(idx[0])).detach()
    np.testing.assert_allclose(packed[0].numpy(), rows[:, 0].numpy(),
                               atol=1e-6, rtol=0)


def test_no_adapter_runs_no_lora_operation(weights):
    """Without adapters the model builds no rows from indices and its
    forward ignores rows it is given; the parameters carry no LoRA leaf."""
    _, tparams = weights
    model = DecoderLM(TCFG, tparams)
    assert not model.has_lora and model.lora_rows(torch.zeros(2)) is None
    toks = torch.tensor([[1, 2, 3]], dtype=torch.int32)
    pos = torch.arange(3, dtype=torch.int32)[None]
    rows = LoraRows(torch.tensor([0, 2]), torch.tensor([1, 1, 2, 2]),
                    torch.float32)
    np.testing.assert_array_equal(
        model(toks, pos, lora=LoraRows(torch.tensor([1]),
                                       torch.tensor([1, 1]),
                                       torch.float32)).detach().numpy(),
        model(toks, pos).detach().numpy())
    np.testing.assert_array_equal(rows.mask[:, 0].numpy(),
                                  [[0, 0, 0, 0], [0, 0, 1, 1]])


# -- the engines --------------------------------------------------------------


def _serving(**over):
    base = dict(max_decode_slots=4, max_cache_len=64, page_size=8,
                prefill_buckets=(16,), dtype="float32", prefix_cache=False,
                decode_horizon=4)
    base.update(over)
    return base


def _engines(scaled, adapters, names=("a", "b"), jax_over=None, **over):
    jparams, tparams = scaled
    if over.get("dtype") == "bfloat16":
        jparams = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams)
        tparams = _tree(tparams, lambda t: t.to(torch.bfloat16))
    lora = {n: adapters[n] for n in names}
    s = _serving(**over)
    je = JEngine(JCFG, jparams, JServing(weights_dtype="bf16",
                                         attention_impl="xla",
                                         **{**s, **(jax_over or {})}),
                 lora=lora)
    te = TEngine(TCFG, tparams, TServing(weights_dtype="bf16", **s),
                 device="cpu", lora=lora)
    return je, te


def _tree(tree, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _run(je, te, reqs):
    """Submit ``(prompt, fields)`` pairs to both engines and run them until
    idle; returns (JAX streams, port streams)."""
    jr = [je.submit(JRequest(prompt_ids=list(p), max_tokens=16,
                             ignore_eos=True, **f)) for p, f in reqs]
    tr = [te.submit(TRequest(prompt_ids=list(p), max_tokens=16,
                             ignore_eos=True, **f)) for p, f in reqs]
    while (any(s is not None for s in je.slot_req) or je.pending
           or je._chunk is not None or je._inflight is not None):
        je.step()
    te.run_until_idle()
    return [r.generated for r in jr], [r.generated for r in tr]


def test_zero_b_adapter_equals_base(scaled, adapters):
    _, te = _engines(scaled, adapters, names=("zero",))
    _, tr = None, [te.submit(TRequest(prompt_ids=PROMPT, max_tokens=16,
                                      ignore_eos=True, lora=n))
                   for n in (None, "zero")]
    te.run_until_idle()
    assert tr[0].generated == tr[1].generated


MIXES = {"paged": {}, "paged-sync": {"decode_pipeline": 0},
         "dense": {"paged": False}, "paged-chunked": {"prefill_chunk": 8},
         "bf16": {"dtype": "bfloat16"}}


@pytest.mark.parametrize("layout", sorted(MIXES))
def test_mixed_batch_each_slot_its_jax_stream(scaled, adapters, layout):
    """Base, adapter a and adapter b (twice each over 4 slots, so that the
    queue admits under a dispatch in flight): every slot's stream is the
    JAX engine's and its one-adapter run's."""
    over = MIXES[layout]
    names = [None, "a", "b", None, "a", "b"]
    reqs = [(PROMPT if i % 2 == 0 else PROMPT[::-1] + [3] * 9, {"lora": n})
            for i, n in enumerate(names)]
    je, te = _engines(scaled, adapters, **over)
    want, got = _run(je, te, reqs)
    if over.get("dtype") != "bfloat16":
        assert got == want
    solo = {}
    for p, f in reqs:
        key = (tuple(p), f["lora"])
        if key not in solo:
            _, t1 = _engines(scaled, adapters, **over)
            solo[key] = _run_port(t1, [(p, f)])[0]
    assert got == [solo[(tuple(p), f["lora"])] for p, f in reqs]
    assert len({tuple(s) for s in got}) > 2


def _run_port(te, reqs):
    tr = [te.submit(TRequest(prompt_ids=list(p), max_tokens=16,
                             ignore_eos=True, **f)) for p, f in reqs]
    te.run_until_idle()
    return [r.generated for r in tr]


@pytest.mark.parametrize("paged", [True, False])
def test_prefix_cache_never_crosses_adapters(scaled, adapters, paged):
    """A shared prompt on adapter a, then b, then the base, then a again,
    with the prefix cache on: each stream is its cold run's and the JAX
    engine's; only the same adapter's reuse hits (paged), and the dense
    cache matches no row of another adapter."""
    shared = list(range(2, 42))
    over = dict(prefix_cache=True, paged=paged, page_size=16,
                max_cache_len=128, prefill_buckets=(16, 64),
                prefix_reuse_min_pages=1)
    order = ["a", "b", None, "a"]
    je, te = _engines(scaled, adapters, **over)
    want, got = [], []
    hits = []
    for n in order:
        w, g = _run(je, te, [(shared, {"lora": n})])
        want += w
        got += g
        hits.append(te.counts["prefix_cache_hits"])
    assert got == want
    cold = {}
    for n in ("a", "b", None):
        _, t1 = _engines(scaled, adapters, **{**over, "prefix_cache": False})
        cold[n] = _run_port(t1, [(shared, {"lora": n})])[0]
    assert got == [cold[n] for n in order]
    assert hits[1] == hits[0] and hits[2] == hits[1]
    if paged:
        assert hits[3] > hits[2], "same-adapter reuse should still hit"


def test_spec_verify_carries_the_adapter(scaled, adapters):
    """Prompt-lookup speculation over adapter slots gives the spec-off
    streams (and the JAX engine's), with drafts proposed: the verify runs
    each slot through its adapter."""
    pat = [5, 6, 7] * 5
    reqs = [(pat, {"lora": "a"}), (pat[1:] + [5], {"lora": "b"}),
            (pat, {"lora": None})]
    over = dict(spec_decode=True, spec_k=4, spec_ngram=3,
                prefill_buckets=(16, 32))
    je, te = _engines(scaled, adapters, **over)
    want, got = _run(je, te, reqs)
    assert got == want
    assert te.counts["spec_drafted_tokens"] > 0
    _, plain = _engines(scaled, adapters, prefill_buckets=(16, 32))
    assert got == _run_port(plain, reqs)


def test_peft_written_adapter_follows_the_peft_model(tmp_path):
    """peft writes the adapter over the HF model; the port's loader and
    engine give the greedy stream whose every token is the peft-wrapped
    model's teacher-forced argmax."""
    from peft import LoraConfig, get_peft_model
    from test_model_parity import _hf_qwen3

    from aws_k8s_ansible_provisioner_tpu_torch.models.hf_loader import \
        convert_state_dict

    model = _hf_qwen3(JCFG)
    params = convert_state_dict(TCFG, dict(model.state_dict()),
                                dtype=torch.float32, device="cpu")
    lcfg = LoraConfig(r=4, lora_alpha=16, lora_dropout=0.0,
                      target_modules=list(ALL), init_lora_weights=False)
    torch.manual_seed(7)
    pm = get_peft_model(model, lcfg)
    pm.save_pretrained(str(tmp_path / "peft_ad"))
    path = tmp_path / "peft_ad"
    if (path / "default").exists():
        path = path / "default"
    eng = TEngine(TCFG, params, TServing(weights_dtype="bf16",
                                         **_serving()),
                  device="cpu", lora={"tuned": str(path)})
    got = _run_port(eng, [(PROMPT, {"lora": "tuned"})])[0]
    with torch.no_grad():
        out = pm(torch.tensor([PROMPT + got[:-1]])).logits
    assert got == out[0, len(PROMPT) - 1:].argmax(-1).tolist()


def test_warmup_runs_the_lora_path_and_fingerprint_binds_names(
        scaled, adapters, tmp_path):
    """Warmup over an adapter engine (paged, spec on) leaves the engine as
    it was and serves after; the AOT fingerprint names the adapters, so a
    manifest of the adapter-free engine is refused."""
    from aws_k8s_ansible_provisioner_tpu_torch.serving import aot

    over = dict(spec_decode=True, prefill_chunk=8)
    _, te = _engines(scaled, adapters, **over)
    before = dict(te.counts)
    te.warmup()
    assert dict(te.counts) == before
    _, ref = _engines(scaled, adapters, **over)
    reqs = [(PROMPT, {"lora": "a"}), (PROMPT, {"lora": None})]
    assert _run_port(te, reqs) == _run_port(ref, reqs)
    fp = aot.engine_fingerprint(te)
    assert fp["lora"] == ["a", "b"]
    _, tparams = scaled
    plain = TEngine(TCFG, tparams, TServing(weights_dtype="bf16",
                                            **_serving(**over)), device="cpu")
    path = tmp_path / "m.json"
    path.write_text(json.dumps(aot.build_manifest(plain)))
    with pytest.raises(ValueError, match="lora"):
        te.load_aot_manifest(str(path))


# -- the servers --------------------------------------------------------------


@pytest.fixture(scope="module")
def lora_servers(tmp_path_factory):
    """The JAX server and the port's over the same weights (scaled
    tiny_qwen3 over the byte vocabulary) with ``--lora styl=<dir>``."""
    import socket
    import threading

    from aws_k8s_ansible_provisioner_tpu.config import tiny_qwen3
    from aws_k8s_ansible_provisioner_tpu.serving import server as jserver
    from aws_k8s_ansible_provisioner_tpu.utils.tokenizer import ByteTokenizer
    from aws_k8s_ansible_provisioner_tpu_torch.serving import server
    from aws_k8s_ansible_provisioner_tpu_torch.utils.tokenizer import \
        ByteTokenizer as TByte

    tok = ByteTokenizer()
    cfg = tiny_qwen3(vocab_size=tok.vocab_size, eos_token_id=tok.eos_token_id)
    path = _write_adapter(tmp_path_factory.mktemp("srv"), "styl", cfg,
                          seed=5)
    params = _jax_params(cfg)
    common = dict(model="base-model", max_decode_slots=2, max_cache_len=64,
                  prefill_buckets=(16,), dtype="float32",
                  lora_adapters=(f"styl={path}",))
    jstate = jserver.build_state(JServing(weights_dtype="bf16", **common),
                                 model_cfg=cfg, params=params, tokenizer=tok)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ready, stop = threading.Event(), threading.Event()
    th = threading.Thread(target=jserver.serve,
                          args=(jstate, "127.0.0.1", port, ready, stop),
                          daemon=True)
    th.start()
    assert ready.wait(30)
    tcfg = ModelConfig(**dataclasses.asdict(cfg))
    state = server.build_state(
        TServing(weights_dtype="bf16", **common), model_cfg=tcfg,
        params=from_jax_params(jax.tree.map(np.asarray, params), tcfg),
        tokenizer=TByte(), device="cpu")
    srv = server.make_server(state, "127.0.0.1", 0)
    th2 = threading.Thread(target=srv.serve_forever, daemon=True)
    th2.start()
    state.start_engine()
    yield (f"http://127.0.0.1:{srv.server_address[1]}",
           f"http://127.0.0.1:{port}")
    srv.shutdown()
    srv.server_close()
    state.stop_engine()
    stop.set()
    th.join(30)


def test_http_models_list_the_adapters_like_jax(lora_servers):
    base, jbase = lora_servers
    got, want = _get(base + "/v1/models")[1], _get(jbase + "/v1/models")[1]
    assert [m["id"] for m in got["data"]] == \
        [m["id"] for m in want["data"]] == ["base-model", "styl"]
    assert got["data"][1]["parent"] == want["data"][1]["parent"] \
        == "base-model"


@pytest.mark.parametrize("model", ["styl", "base-model", "nope"])
@pytest.mark.parametrize("route", ["/v1/completions",
                                   "/v1/chat/completions"])
def test_http_adapter_answers_like_jax(lora_servers, model, route):
    base, jbase = lora_servers
    body = {"model": model, "max_tokens": 6, "ignore_eos": True}
    if "chat" in route:
        body["messages"] = [{"role": "user", "content": "hi"}]
        body["temperature"] = 0.0
    else:
        body["prompt"] = "hi"
    got, want = _post(base + route, body), _post(jbase + route, body)
    assert got[0] == want[0], (got, want)
    if want[0] != 200:
        assert got[1]["error"]["type"] == want[1]["error"]["type"]
        assert got[1]["error"]["message"] == want[1]["error"]["message"]
        return
    assert got[1]["model"] == want[1]["model"] == model
    key = "message" if "chat" in route else "text"
    assert got[1]["choices"][0][key] == want[1]["choices"][0][key]


def test_http_adapter_stream_and_guided_json(lora_servers):
    """An adapter stream, and a json_object answer through the adapter,
    whole and streamed: the JAX server's text."""
    from test_torch_guided import _BIAS, _sse_text

    base, jbase = lora_servers
    for body in ({"model": "styl", "prompt": "hi", "max_tokens": 8,
                  "ignore_eos": True, "stream": True},
                 {"model": "styl", "prompt": "json:", "max_tokens": 40,
                  "response_format": {"type": "json_object"},
                  "logit_bias": _BIAS, "stream": True}):
        assert _sse_text(base, "/v1/completions", body) == \
            _sse_text(jbase, "/v1/completions", body)
    body = {"model": "styl", "prompt": "json:", "max_tokens": 40,
            "response_format": {"type": "json_object"}, "logit_bias": _BIAS}
    got = _post(base + "/v1/completions", body)
    want = _post(jbase + "/v1/completions", body)
    assert got[0] == want[0] == 200
    assert got[1]["choices"][0]["text"] == want[1]["choices"][0]["text"]


@pytest.mark.parametrize("spec,match", [
    ("styl", "expects name=path"), ("=x", "expects name=path"),
    ("a=", "expects name=path"), ("base-model=/x", "shadow")])
def test_lora_flag_refusals_like_jax(spec, match):
    from aws_k8s_ansible_provisioner_tpu.serving import server as jserver
    from aws_k8s_ansible_provisioner_tpu_torch.serving import server

    over = dict(model="base-model", max_decode_slots=2, max_cache_len=64,
                prefill_buckets=(16,), dtype="float32",
                lora_adapters=(spec,))
    with pytest.raises(ValueError, match=match) as got:
        server.build_state(TServing(weights_dtype="bf16", **over),
                           model_cfg=TCFG, device="cpu",
                           params=from_jax_params(jax.tree.map(
                               np.asarray, init_params(
                                   JCFG, jax.random.PRNGKey(0),
                                   dtype=jnp.float32)), TCFG))
    with pytest.raises(ValueError) as want:
        jserver.build_state(JServing(weights_dtype="bf16", **over),
                            model_cfg=JCFG, params=init_params(
                                JCFG, jax.random.PRNGKey(0),
                                dtype=jnp.float32))
    assert str(got.value) == str(want.value)


def test_lora_flag_duplicate_and_parse(adapters):
    from aws_k8s_ansible_provisioner_tpu_torch.serving import server

    args = server.build_parser().parse_args(
        ["--lora", f"a={adapters['a']}", "--lora", f"b={adapters['b']}"])
    cfg = server.serving_config(args)
    assert cfg.lora_adapters == (f"a={adapters['a']}", f"b={adapters['b']}")
    dup = dataclasses.replace(cfg, lora_adapters=(f"a={adapters['a']}",
                                                  f"a={adapters['b']}"),
                              max_cache_len=64, max_decode_slots=2,
                              prefill_buckets=(16,), dtype="float32",
                              weights_dtype="bf16", model="base")
    with pytest.raises(ValueError, match="duplicate LoRA adapter name"):
        server.build_state(dup, model_cfg=TCFG, device="cpu")
