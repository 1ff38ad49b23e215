"""The port's HTTP server on the CPU: ``/v1/models``, ``/v1/completions``
(the OpenAI ``seed`` included; the neutral values of the request fields
served as the bare request) and ``/health`` over a real socket, with
tiny_qwen3 and the byte tokenizer. Streaming, chat and the continuation
are held in ``test_torch_stream.py``, ``test_torch_chat.py`` and
``test_torch_failover.py``, which share this file's JAX server fixtures.
"""

import json
import threading
import urllib.error
import urllib.request

import pytest
import torch

from aws_k8s_ansible_provisioner_tpu_torch.config import ServingConfig
from aws_k8s_ansible_provisioner_tpu_torch.serving.server import (build_state,
                                                                  main,
                                                                  make_server)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def server():
    serving = ServingConfig(model="tiny-qwen3", max_decode_slots=4,
                            max_cache_len=128, page_size=8,
                            prefill_buckets=(16, 32, 64), dtype="float32",
                            prefill_chunk=16)
    state = build_state(serving, device="cpu")
    srv = make_server(state, "127.0.0.1", 0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    state.start_engine()
    yield f"http://127.0.0.1:{srv.server_address[1]}", state
    srv.shutdown()
    srv.server_close()
    state.stop_engine()
    th.join(10)


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, json.loads(r.read())


def _post(url, body):
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_models_lists_the_served_model(server):
    base, state = server
    status, out = _get(base + "/v1/models")
    assert status == 200
    assert out["object"] == "list"
    assert out["data"][0]["id"] == "tiny-qwen3"
    assert out["data"][0]["max_model_len"] == state.engine.max_len


@pytest.mark.parametrize("prompt", ["Hello", "a longer prompt that the "
                                    "engine walks in chunks of sixteen"])
def test_completion_returns_text_and_usage(server, prompt):
    base, _ = server
    status, out = _post(base + "/v1/completions",
                        {"prompt": prompt, "max_tokens": 7})
    assert status == 200
    assert out["object"] == "text_completion"
    choice = out["choices"][0]
    assert isinstance(choice["text"], str)
    assert choice["finish_reason"] in ("length", "stop")
    usage = out["usage"]
    assert usage["prompt_tokens"] == len(prompt.encode())
    assert 1 <= usage["completion_tokens"] <= 7
    assert usage["total_tokens"] == usage["prompt_tokens"] + \
        usage["completion_tokens"]


def test_token_id_prompt_and_greedy_repeatability(server):
    base, _ = server
    body = {"prompt": [72, 105, 33], "max_tokens": 5, "ignore_eos": True}
    first = _post(base + "/v1/completions", body)
    second = _post(base + "/v1/completions", body)
    assert first[0] == second[0] == 200
    assert first[1]["choices"][0]["text"] == second[1]["choices"][0]["text"]
    assert first[1]["usage"]["completion_tokens"] == 5


def test_seed_makes_a_sampled_completion_repeatable(server):
    """``seed`` reaches the engine: the same seeded sampled request gives
    the same text every time (the engine's stream for that seed), while
    unseeded ones draw fresh seeds."""
    base, state = server
    body = {"prompt": [40, 41, 42, 43], "max_tokens": 12, "temperature": 1.5,
            "ignore_eos": True, "seed": 31337}
    texts = [_post(base + "/v1/completions", body)[1]["choices"][0]["text"]
             for _ in range(2)]
    assert texts[0] == texts[1]
    unseeded = {_post(base + "/v1/completions",
                      {**body, "seed": None})[1]["choices"][0]["text"]
                for _ in range(3)}
    assert len(unseeded | {texts[0]}) > 1
    status, out = _post(base + "/v1/completions", {**body, "seed": "x"})
    assert status == 400 and "seed" in out["error"]["message"]


_BARE = {"prompt": [72, 105, 33], "max_tokens": 5, "ignore_eos": True}
# neutral values: served as the bare request is (the JAX server's fields
# that the port did not serve were refused unless neutral; each refused
# case left with its refusal when its field was served, the guided-decoding
# fields last, which test_torch_guided.py holds)
_NEUTRAL = [{"n": 1}, {"echo": False}, {"logprobs": None}, {"stop": None},
            {"stop": []}, {"stop_token_ids": []}, {"presence_penalty": 0.0},
            {"frequency_penalty": 0}, {"repetition_penalty": 1.0},
            {"min_tokens": 0}, {"best_of": 1}, {"n": 1, "best_of": 1},
            {"logit_bias": {}}, {"top_logprobs": 0},
            {"response_format": {"type": "text"}}, {"stream": False},
            {"resume_token_ids": None}, {"stream_options": None}]


@pytest.mark.parametrize("extra", [
    pytest.param(extra, id="neutral-" + "-".join(extra) + f"-{i}")
    for i, extra in enumerate(_NEUTRAL)])
def test_unserved_fields_are_refused_unless_neutral(server, extra):
    """A request field at its neutral value is served, with the bare
    request's text."""
    base, _ = server
    status, out = _post(base + "/v1/completions", {**_BARE, **extra})
    assert status == 200, out
    bare_status, bare = _post(base + "/v1/completions", _BARE)
    assert bare_status == 200
    assert out["choices"][0]["text"] == bare["choices"][0]["text"]
    assert out["usage"] == bare["usage"]


def test_bad_requests_get_4xx(server):
    base, _ = server
    assert _post(base + "/v1/completions", b"{not json")[0] == 400
    assert _post(base + "/v1/completions", {"prompt": 3})[0] == 400
    assert _post(base + "/v1/completions", {"prompt": "x" * 500})[0] == 400
    assert _post(base + "/v1/nothing", {})[0] == 404


def test_health_reports_ok(server):
    base, _ = server
    status, out = _get(base + "/health")
    assert status == 200 and out["status"] == "ok"
    # C16: no string-valued ``device`` key (the JAX answer's ``device`` is
    # the device monitor's dict, a module not ported yet)
    assert "device" not in out and out["last_error"] is None
    assert out["paged"] is True and out["kv_pages_total"] > 0


def test_cli_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("the check is for a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--model", "tiny-qwen3", "--port", "0"])
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--model", "tiny-qwen3", "--port", "0", "--kv-dtype", "int8"])
    with pytest.raises(SystemExit):
        main(["--model", "tiny-qwen3", "--kv-dtype", "fp8"])


def test_int8_kv_server_answers_on_the_cpu():
    serving = ServingConfig(model="tiny-qwen3", max_decode_slots=2,
                            max_cache_len=64, page_size=8,
                            prefill_buckets=(16, 32), dtype="float32",
                            kv_dtype="int8")
    state = build_state(serving, device="cpu")
    assert state.engine.cache["k"].dtype == torch.int8
    srv = make_server(state, "127.0.0.1", 0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    state.start_engine()
    try:
        status, out = _post(f"http://127.0.0.1:{srv.server_address[1]}"
                            "/v1/completions",
                            {"prompt": "int8", "max_tokens": 4,
                             "ignore_eos": True})
        assert status == 200 and out["usage"]["completion_tokens"] == 4
    finally:
        srv.shutdown()
        srv.server_close()
        state.stop_engine()
        th.join(10)


def test_mesh_flags_build_a_meshed_engine_that_answers_alike():
    """``--tp 2 --dp 2 --device cpu``: the state's engine serves the
    (dp, tp) = (2, 2) mesh (every position on the CPU), and its answer to
    a greedy completion is the unmeshed server's. The dry-run model's
    vocabulary is padded to 260 rows (the byte tokenizer's 259 does not
    split over tp 2)."""
    from aws_k8s_ansible_provisioner_tpu_torch.config import tiny_qwen3
    from aws_k8s_ansible_provisioner_tpu_torch.models.layers import MeshLM
    from aws_k8s_ansible_provisioner_tpu_torch.serving.server import (
        build_parser, serving_config)
    from aws_k8s_ansible_provisioner_tpu_torch.utils.tokenizer import \
        ByteTokenizer

    cfg = tiny_qwen3(vocab_size=260, eos_token_id=ByteTokenizer().eos_token_id,
                     num_layers=4, hidden_size=128, intermediate_size=256)

    flags = ["--model", "tiny-qwen3", "--max-decode-slots", "4",
             "--max-cache-len", "64", "--page-size", "8", "--dtype",
             "float32", "--weights-dtype", "bf16", "--device", "cpu"]
    answers = []
    for mesh in ([], ["--tp", "2", "--dp", "2"]):
        args = build_parser().parse_args(flags + mesh)
        state = build_state(serving_config(args), model_cfg=cfg,
                            device=args.device)
        eng = state.engine
        if mesh:
            assert eng.mesh.shape["tp"] == 2 and eng.mesh.shape["dp"] == 2
            assert isinstance(eng.model, MeshLM) and eng.dp_groups == 2
        else:
            assert eng.mesh is None
        srv = make_server(state, "127.0.0.1", 0)
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        state.start_engine()
        try:
            status, out = _post(
                f"http://127.0.0.1:{srv.server_address[1]}/v1/completions",
                {"prompt": "mesh", "max_tokens": 6, "temperature": 0,
                 "ignore_eos": True})
            assert status == 200
            answers.append((out["choices"][0]["text"], out["usage"]))
        finally:
            srv.shutdown()
            srv.server_close()
            state.stop_engine()
            th.join(10)
    assert answers[0] == answers[1]


# -- the answers of the JAX server (the same bodies to both, on the CPU) ------


def _jax_params(cfg):
    """tiny_qwen3's seeded JAX weights, scaled (as tests/test_torch_engine.py
    scales them) so that greedy streams do not collapse onto one token."""
    import jax
    import jax.numpy as jnp

    from aws_k8s_ansible_provisioner_tpu.models.layers import init_params

    def scale(node):
        return {k: scale(v) if isinstance(v, dict) else
                v * 8 if k == "kernel" else v for k, v in node.items()}

    params = scale(init_params(cfg, jax.random.PRNGKey(0),
                               dtype=jnp.float32))
    params["embed"] = {"weight": params["embed"]["weight"] * 8}
    return params


@pytest.fixture(scope="module")
def jax_server():
    """The JAX package's server over tiny_qwen3 and the byte tokenizer, in
    process on a free port, shaped as the port's ``server`` fixture."""
    import socket

    import jax
    import jax.numpy as jnp

    from aws_k8s_ansible_provisioner_tpu.config import \
        ServingConfig as JServing
    from aws_k8s_ansible_provisioner_tpu.config import tiny_qwen3
    from aws_k8s_ansible_provisioner_tpu.serving import server as jserver
    from aws_k8s_ansible_provisioner_tpu.utils.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    cfg = tiny_qwen3(vocab_size=tok.vocab_size, eos_token_id=tok.eos_token_id)
    params = _jax_params(cfg)
    serving = JServing(weights_dtype="bf16", model="tiny-qwen3",
                       max_decode_slots=4, max_cache_len=128, page_size=8,
                       prefill_buckets=(16, 32, 64), dtype="float32",
                       prefill_chunk=16)
    state = jserver.build_state(serving, model_cfg=cfg, params=params,
                                tokenizer=tok)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ready, stop = threading.Event(), threading.Event()
    th = threading.Thread(target=jserver.serve,
                          args=(state, "127.0.0.1", port, ready, stop),
                          daemon=True)
    th.start()
    assert ready.wait(30)
    yield f"http://127.0.0.1:{port}", state
    stop.set()
    th.join(30)


# C15: bodies the two servers must answer alike (status and error type);
# ``max_tokens`` None stands for the engine's max_len + 1
_LIKE_JAX = {
    "unknown-model": {"model": "no-such-model", "prompt": "x",
                      "max_tokens": 2},
    "served-model": {"model": "tiny-qwen3", "prompt": "x", "max_tokens": 2},
    "empty-prompt": {"prompt": "", "max_tokens": 2},
    "list-of-strings": {"prompt": ["abc", "de"], "max_tokens": 2},
    "empty-list": {"prompt": [], "max_tokens": 2},
    "max-tokens-past-max-len": {"prompt": "x", "max_tokens": None},
    "max-tokens-at-max-len": {"prompt": "x", "max_tokens": 0},
    "max-tokens-zero": {"prompt": "x", "max_tokens": -1},
}


@pytest.mark.parametrize("case", sorted(_LIKE_JAX))
def test_answers_like_the_jax_server(server, jax_server, case):
    """An unknown ``model`` gets 404 ``model_not_found``; an empty prompt
    and an empty list are served as the EOS token; a list of strings
    serves its first; ``max_tokens`` above the engine's max_len gets 400
    (at max_len it is served, clamped by the engine): the port's status and
    error type are the JAX server's, and a served prompt counts the same
    prompt tokens."""
    (base, state), (jbase, jstate) = server, jax_server
    assert state.engine.max_len == jstate.engine.max_len
    body = dict(_LIKE_JAX[case])
    max_len = state.engine.max_len
    body["max_tokens"] = {None: max_len + 1, 0: max_len,
                          -1: 0}.get(body["max_tokens"], body["max_tokens"])
    got, want = _post(base + "/v1/completions", body), \
        _post(jbase + "/v1/completions", body)
    assert got[0] == want[0], (got, want)
    if want[0] != 200:
        assert got[1]["error"]["type"] == want[1]["error"]["type"]
        return
    assert got[1]["model"] == want[1]["model"] == "tiny-qwen3"
    assert got[1]["usage"]["prompt_tokens"] == \
        want[1]["usage"]["prompt_tokens"]


def test_token_id_prompt_stays_served_beyond_the_jax_server(server,
                                                            jax_server):
    """By design the port serves a list of token ids as the prompt, where
    the JAX server answers 400."""
    body = {"prompt": [72, 105, 33], "max_tokens": 2}
    assert _post(server[0] + "/v1/completions", body)[0] == 200
    assert _post(jax_server[0] + "/v1/completions", body)[0] == 400


# -- the request fields, served as the JAX server serves them ----------------


@pytest.fixture(scope="module")
def twin_server(jax_server):
    """The port's server over the JAX server's weights (converted), config
    and byte tokenizer, shaped as the ``server`` fixture."""
    import dataclasses

    import jax
    import numpy as np

    from aws_k8s_ansible_provisioner_tpu_torch.config import ModelConfig
    from aws_k8s_ansible_provisioner_tpu_torch.models.convert import \
        from_jax_params
    from aws_k8s_ansible_provisioner_tpu_torch.utils.tokenizer import \
        ByteTokenizer

    jstate = jax_server[1]
    cfg = ModelConfig(**dataclasses.asdict(jstate.engine.cfg))
    params = from_jax_params(jax.tree.map(np.asarray, _jax_params(
        jstate.engine.cfg)), cfg)
    serving = ServingConfig(weights_dtype="bf16", model="tiny-qwen3",
                            max_decode_slots=4, max_cache_len=128,
                            page_size=8, prefill_buckets=(16, 32, 64),
                            dtype="float32", prefill_chunk=16)
    state = build_state(serving, model_cfg=cfg, params=params,
                        tokenizer=ByteTokenizer(), device="cpu")
    srv = make_server(state, "127.0.0.1", 0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    state.start_engine()
    yield f"http://127.0.0.1:{srv.server_address[1]}", state
    srv.shutdown()
    srv.server_close()
    state.stop_engine()
    th.join(10)


_FIELDS_BASE = {"prompt": "Hi! How are you?", "max_tokens": 12,
                "ignore_eos": True}


def _bare_ids(state):
    """The port engine's greedy stream of ``_FIELDS_BASE``."""
    from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import Request

    req = state.engine.submit(Request(
        prompt_ids=state.tokenizer.encode(_FIELDS_BASE["prompt"]),
        max_tokens=_FIELDS_BASE["max_tokens"], ignore_eos=True))
    return req.wait(timeout=120)


# each served field (the cases that were refused before they were served),
# as a function of the bare greedy stream's token ids and text: a stop
# string or a stop id the stream reaches
_SERVED = {
    "stop-list": lambda ids, text: {"stop": [text[4:6], "never"]},
    "stop-string": lambda ids, text: {"stop": text[7:8]},
    "stop_token_ids": lambda ids, text: {"stop_token_ids": [ids[5]]},
    "min_tokens": lambda ids, text: {"min_tokens": 4,
                                     "stop_token_ids": [ids[1]]},
    "n": lambda ids, text: {"n": 3, "seed": 5, "temperature": 0.9},
    "best_of": lambda ids, text: {"best_of": 3, "seed": 11,
                                  "temperature": 1.2},
    "best_of-n": lambda ids, text: {"n": 2, "best_of": 4, "seed": 3,
                                    "temperature": 1.0, "logprobs": 1},
    "echo": lambda ids, text: {"echo": True},
    "echo-logprobs": lambda ids, text: {"echo": True, "logprobs": 2},
    "prompt_logprobs": lambda ids, text: {"prompt_logprobs": 1},
    "logprobs-2": lambda ids, text: {"logprobs": 2},
    "logprobs-0": lambda ids, text: {"logprobs": 0},
    "top_logprobs": lambda ids, text: {"top_logprobs": 2},
    "logit_bias-ban": lambda ids, text: {"logit_bias": {str(ids[0]): -100}},
    "logit_bias-force": lambda ids, text: {"logit_bias": {"100": 100,
                                                          "7": 2.5}},
    "presence_penalty": lambda ids, text: {"presence_penalty": 2.0},
    "frequency_penalty": lambda ids, text: {"frequency_penalty": 0.5},
    "repetition_penalty": lambda ids, text: {"repetition_penalty": 1.2},
}


def _same_logprobs(got, want):
    """Two completions logprobs payloads (or prompt_logprobs lists) alike:
    tokens and offsets equal, logprobs within 1e-4 (the JAX and torch
    log-softmax round apart), a top entry's token equal where its value
    is not tied with another's."""
    if want is None or got is None:
        return got == want
    if isinstance(want, list):
        return len(got) == len(want) and all(
            _same_top(g, w) for g, w in zip(got, want))
    if got["tokens"] != want["tokens"] or \
            got["text_offset"] != want["text_offset"]:
        return False
    own = zip(got["token_logprobs"], want["token_logprobs"])
    return all((g is None) == (w is None) and
               (g is None or abs(g - w) < 1e-4) for g, w in own) and all(
        _same_top(g, w) for g, w in zip(got["top_logprobs"],
                                        want["top_logprobs"]))


def _same_top(got, want):
    if got is None or want is None:
        return got == want
    vals = sorted(want.values())
    tied = any(b - a < 1e-4 for a, b in zip(vals, vals[1:]))
    if not tied and set(got) != set(want):
        return False
    return sorted(got.values()) == pytest.approx(vals, abs=1e-4)


@pytest.mark.parametrize("case", sorted(_SERVED))
def test_served_field_answers_like_the_jax_server(twin_server, jax_server,
                                                  case):
    """Every request field that the port used to refuse is served, and on
    the same weights the port's answer is the JAX server's: status, each
    choice's text and finish reason (stop strings cut, best_of ranked, the
    prompt echoed), usage, and the logprobs payloads within 1e-4."""
    (base, state), (jbase, _) = twin_server, jax_server
    ids = _bare_ids(state)
    text = state.tokenizer.decode(ids)
    body = {**_FIELDS_BASE, **_SERVED[case](ids, text)}
    got, want = _post(base + "/v1/completions", body), \
        _post(jbase + "/v1/completions", body)
    assert got[0] == want[0] == 200, (got, want)
    g, w = got[1], want[1]
    counts = ("prompt_tokens", "completion_tokens", "total_tokens")
    assert [g["usage"][k] for k in counts] == [w["usage"][k] for k in counts]
    assert len(g["choices"]) == len(w["choices"]) == body.get("n", 1)
    for gc, wc in zip(g["choices"], w["choices"]):
        assert (gc["index"], gc["text"], gc["finish_reason"]) == \
            (wc["index"], wc["text"], wc["finish_reason"]), (gc, wc)
        assert _same_logprobs(gc["logprobs"], wc["logprobs"]), (gc, wc)
        assert _same_logprobs(gc.get("prompt_logprobs"),
                              wc.get("prompt_logprobs")), (gc, wc)
    if case.startswith("stop"):
        assert g["choices"][0]["finish_reason"] == "stop"
    if case == "min_tokens":
        assert len(g["choices"][0]["text"].encode()) >= 4
