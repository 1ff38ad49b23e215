"""The port's HTTP server on the CPU: ``/v1/models``, ``/v1/completions``
(the OpenAI ``seed`` included; the request fields the port does not serve
yet refused unless neutral) and ``/health`` over a real socket, with
tiny_qwen3 and the byte tokenizer.
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
# the JAX server's completions fields the port does not serve yet: a value
# other than the neutral one is refused, naming the field
_REFUSED = [({"stop": ["d"]}, "stop"), ({"stop": "x"}, "stop"),
            ({"stop_token_ids": [5]}, "stop_token_ids"),
            ({"min_tokens": 3}, "min_tokens"), ({"n": 3}, "n"),
            ({"best_of": 2}, "best_of"), ({"echo": True}, "echo"),
            ({"prompt_logprobs": 1}, "prompt_logprobs"),
            ({"logprobs": 2}, "logprobs"), ({"logprobs": 0}, "logprobs"),
            ({"top_logprobs": 2}, "top_logprobs"),
            ({"logit_bias": {"100": -100}}, "logit_bias"),
            ({"presence_penalty": 2.0}, "presence_penalty"),
            ({"frequency_penalty": 0.5}, "frequency_penalty"),
            ({"repetition_penalty": 1.2}, "repetition_penalty"),
            ({"resume_token_ids": [1, 2]}, "resume_token_ids"),
            ({"response_format": {"type": "json_object"}},
             "response_format"),
            ({"guided_json": {"type": "object"}}, "guided_json"),
            ({"guided_regex": "a+"}, "guided_regex"),
            ({"guided_choice": ["a", "b"]}, "guided_choice")]
# neutral values: served as the bare request is
_NEUTRAL = [{"n": 1}, {"echo": False}, {"logprobs": None}, {"stop": None},
            {"stop": []}, {"stop_token_ids": []}, {"presence_penalty": 0.0},
            {"frequency_penalty": 0}, {"repetition_penalty": 1.0},
            {"min_tokens": 0}, {"best_of": 1}, {"n": 1, "best_of": 1},
            {"logit_bias": {}}, {"top_logprobs": 0},
            {"response_format": {"type": "text"}}]


@pytest.mark.parametrize("extra,refused", [
    pytest.param(extra, field, id=f"refused-{field}-{i}")
    for i, (extra, field) in enumerate(_REFUSED)] + [
    pytest.param(extra, None, id="neutral-" + "-".join(extra) + f"-{i}")
    for i, extra in enumerate(_NEUTRAL)])
def test_unserved_fields_are_refused_unless_neutral(server, extra, refused):
    """A field the JAX server honours and the port does not serve yet gets
    400 naming it, never a completion that ignores it; at its neutral value
    the request is served, with the bare request's text."""
    base, _ = server
    status, out = _post(base + "/v1/completions", {**_BARE, **extra})
    if refused is not None:
        assert status == 400, out
        assert f"'{refused}'" in out["error"]["message"]
        return
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


# -- the answers of the JAX server (the same bodies to both, on the CPU) ------


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
    from aws_k8s_ansible_provisioner_tpu.models.layers import init_params
    from aws_k8s_ansible_provisioner_tpu.serving import server as jserver
    from aws_k8s_ansible_provisioner_tpu.utils.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    cfg = tiny_qwen3(vocab_size=tok.vocab_size, eos_token_id=tok.eos_token_id)
    params = init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
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
