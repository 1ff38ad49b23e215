"""The port's ``/v1/chat/completions`` and the streaming API's refusals on the
CPU, against the JAX server on the same weights (tiny_qwen3 scaled by 8, the
byte tokenizer; both servers in process on free ports, the same bodies to
both): chat answers, whole and streamed, with the ``opt`` style (the
tiny model's default), the ``phi`` style and a template file; chat
logprobs; and every 400 that the streaming API and the continuation add,
with the JAX server's status, type and message.
"""

import pytest
import torch
from test_torch_server import (_post, jax_server,  # noqa: F401
                               twin_server)
from test_torch_stream import (_same_chat_lp, _stream, assert_same_events,
                               stream_text)

torch.set_num_threads(2)

_MESSAGES = [{"role": "system", "content": "Be brief."},
             {"role": "user", "content": "Hi! How are you?"}]
_CHAT = {"messages": _MESSAGES, "max_tokens": 10, "temperature": 0.0,
         "ignore_eos": True}

_CHAT_CASES = {
    "greedy": {},
    "sampled-default-temperature": {"temperature": None, "seed": 3},
    "n-2": {"n": 2, "seed": 9, "temperature": 0.8},
    "logprobs": {"logprobs": True, "top_logprobs": 2},
    "logprobs-no-top": {"logprobs": True},
    "logprobs-false": {"logprobs": False, "top_logprobs": 3},
    "stop": {"stop": ["��", "never"]},
    "best_of-ignored": {"best_of": 3, "seed": 2, "temperature": 0.9},
    "one-user-message": {"messages": [{"role": "user", "content": "hey"}]},
}


def _body(case, stream):
    body = {**_CHAT, **_CHAT_CASES[case]}
    body = {k: v for k, v in body.items() if v is not None}
    if stream:
        body["stream"] = True
    return body


def _same_chat_answer(got, want):
    assert got["object"] == want["object"] == "chat.completion"
    assert got["id"].startswith("chatcmpl-")
    counts = ("prompt_tokens", "completion_tokens", "total_tokens")
    assert [got["usage"][k] for k in counts] == \
        [want["usage"][k] for k in counts]
    assert len(got["choices"]) == len(want["choices"])
    for g, w in zip(got["choices"], want["choices"]):
        assert (g["index"], g["message"], g["finish_reason"]) == \
            (w["index"], w["message"], w["finish_reason"]), (g, w)
        assert set(g) == set(w)
        assert _same_chat_lp(g.get("logprobs"), w.get("logprobs")), (g, w)


@pytest.mark.parametrize("stream", [False, True], ids=["whole", "stream"])
@pytest.mark.parametrize("case", sorted(_CHAT_CASES))
def test_chat_like_the_jax_server(twin_server, jax_server, case, stream):
    """A chat completion, whole or streamed (a role chunk first on each
    choice, then ``delta.content`` chunks with ``token_ids``, chat logprob
    records), answered as the JAX server answers it; a streamed chat's
    text equals the whole answer's."""
    (base, _), (jbase, _) = twin_server, jax_server
    url = "/v1/chat/completions"
    body = _body(case, stream)
    if not stream:
        got, want = _post(base + url, body), _post(jbase + url, body)
        assert got[0] == want[0] == 200, (got, want)
        _same_chat_answer(got[1], want[1])
        return
    got, want = _stream(base + url, body), _stream(jbase + url, body)
    assert got[0] == want[0] == 200, (got, want)
    assert_same_events(got[2], want[2])
    events = got[2]
    assert all(ev["object"] == "chat.completion.chunk" for ev in events[:-1])
    whole = _post(base + url, {**body, "stream": False})[1]
    for c in whole["choices"]:
        first = next(ev for ev in events[:-1]
                     if ev["choices"][0]["index"] == c["index"])
        assert first["choices"][0]["delta"] == {"role": "assistant"}
        text, ids, finish = stream_text(events, c["index"])
        if not (body.get("stop") and body.get("logprobs")):
            assert (text, finish) == (c["message"]["content"],
                                      c["finish_reason"])


@pytest.fixture
def template_file(tmp_path):
    path = tmp_path / "template.jinja"
    path.write_text("{% for m in messages %}<{{ m.role }}>{{ m.content }}"
                    "{% endfor %}{% if add_generation_prompt %}<assistant>"
                    "{% endif %}")
    return str(path)


@pytest.mark.parametrize("style", ["phi", "opt", "file"])
def test_chat_templates_like_the_jax_server(twin_server, jax_server, style,
                                            template_file):
    """The ``phi`` and ``opt`` styles and a ``--chat-template`` file render
    the messages as the JAX templater does (the port keeps a copy of it):
    the same prompt (its token count) and the same answer, whole and
    streamed."""
    from aws_k8s_ansible_provisioner_tpu.serving.chat_template import \
        ChatTemplater as JaxTemplater

    from aws_k8s_ansible_provisioner_tpu_torch.serving.chat_template import \
        ChatTemplater

    (base, state), (jbase, jstate) = twin_server, jax_server
    kw = {"template_path": template_file} if style == "file" \
        else {"style": style}
    old = state.templater, jstate.templater
    state.templater = ChatTemplater(state.engine.cfg.name, state.tokenizer,
                                    **kw)
    jstate.templater = JaxTemplater(jstate.engine.cfg.name, jstate.tokenizer,
                                    **kw)
    try:
        rendered = state.templater.render(_MESSAGES)
        assert rendered == jstate.templater.render(_MESSAGES)
        if style == "file":
            assert rendered.startswith("<system>Be brief.<user>")
        url = "/v1/chat/completions"
        got, want = _post(base + url, _CHAT), _post(jbase + url, _CHAT)
        assert got[0] == want[0] == 200
        _same_chat_answer(got[1], want[1])
        assert got[1]["usage"]["prompt_tokens"] == len(rendered.encode())
        body = {**_CHAT, "stream": True}
        got, want = _stream(base + url, body), _stream(jbase + url, body)
        assert_same_events(got[2], want[2])
    finally:
        state.templater, jstate.templater = old


def test_chat_template_flag_reaches_the_templater(template_file):
    """``--chat-template`` (``ServingConfig.chat_template``) is the file
    that ``build_state``'s templater renders with."""
    from aws_k8s_ansible_provisioner_tpu_torch.config import ServingConfig
    from aws_k8s_ansible_provisioner_tpu_torch.serving.server import \
        build_state

    serving = ServingConfig(model="tiny-qwen3", max_decode_slots=1,
                            max_cache_len=64, page_size=8,
                            prefill_buckets=(16, 32), dtype="float32",
                            chat_template=template_file)
    state = build_state(serving, device="cpu")
    assert state.templater.render([{"role": "user", "content": "x"}]) == \
        "<user>x<assistant>"


# the bodies of every 400 that streaming, chat and the continuation add
# (the JAX tests/test_server.py scenarios among them), each on a route
_REFUSALS = {
    "stream_options-without-stream": (
        "/v1/completions", {"prompt": "a", "stream_options":
                            {"include_usage": True}}),
    "stream_options-not-an-object": (
        "/v1/completions", {"prompt": "a", "stream": True,
                            "stream_options": [1]}),
    "best_of-above-n-streamed": (
        "/v1/completions", {"prompt": "a", "stream": True, "n": 1,
                            "best_of": 3}),
    "prompt_logprobs-streamed": (
        "/v1/completions", {"prompt": "a", "stream": True,
                            "prompt_logprobs": 1}),
    "chat-echo": ("/v1/chat/completions",
                  {"messages": _MESSAGES, "echo": True}),
    "chat-no-messages": ("/v1/chat/completions", {"prompt": "a"}),
    "chat-empty-messages": ("/v1/chat/completions", {"messages": []}),
    "chat-messages-not-a-list": ("/v1/chat/completions",
                                 {"messages": "hello"}),
    "chat-logprobs-out-of-range": (
        "/v1/chat/completions", {"messages": _MESSAGES, "logprobs": True,
                                 "top_logprobs": 9}),
    "resume-not-a-list": ("/v1/completions", {
        "prompt": "a", "stream": True, "resume_token_ids": 5}),
    "resume-not-integers": ("/v1/completions", {
        "prompt": "a", "stream": True, "resume_token_ids": ["x"]}),
    "resume-negative-chars": ("/v1/completions", {
        "prompt": "a", "stream": True, "resume_token_ids": [1],
        "resume_text_chars": -1}),
    "resume-not-streamed": ("/v1/completions", {
        "prompt": "a", "resume_token_ids": [1, 2]}),
    "resume-n-2": ("/v1/completions", {
        "prompt": "a", "stream": True, "n": 2, "resume_token_ids": [1]}),
    "resume-best_of-2": ("/v1/completions", {
        "prompt": "a", "stream": True, "best_of": 2,
        "resume_token_ids": [1]}),
    "resume-echo": ("/v1/completions", {
        "prompt": "a", "stream": True, "echo": True,
        "resume_token_ids": [1]}),
    "resume-prompt_logprobs": ("/v1/completions", {
        "prompt": "a", "stream": True, "prompt_logprobs": 0,
        "resume_token_ids": [1]}),
    "max_tokens-zero-without-resume": ("/v1/completions", {
        "prompt": "a", "stream": True, "max_tokens": 0}),
    "resume-max_tokens-negative": ("/v1/completions", {
        "prompt": "a", "stream": True, "max_tokens": -1,
        "resume_token_ids": [1]}),
}


@pytest.mark.parametrize("case", sorted(_REFUSALS))
def test_refusals_like_the_jax_server(twin_server, jax_server, case):
    """Each body is refused with 400, by both servers alike: status, error
    type and message."""
    (base, _), (jbase, _) = twin_server, jax_server
    url, body = _REFUSALS[case]
    got, want = _post(base + url, body), _post(jbase + url, body)
    assert got[0] == want[0] == 400, (got, want)
    assert got[1]["error"]["type"] == want[1]["error"]["type"]
    assert got[1]["error"]["message"] == want[1]["error"]["message"]


def test_response_format_and_guided_stay_refused_on_chat(twin_server,
                                                        jax_server):
    """The guided-decoding fields are served on the chat route (held by
    test_torch_guided.py); a malformed or conflicting spec stays refused
    there, with the JAX server's 400 and message."""
    (base, _), (jbase, _) = twin_server, jax_server
    for extra in ({"response_format": {"type": "xml"}},
                  {"response_format": "json"},
                  {"guided_regex": ""},
                  {"guided_regex": "a+", "guided_choice": ["a"]}):
        got = _post(base + "/v1/chat/completions", {**_CHAT, **extra})
        want = _post(jbase + "/v1/chat/completions", {**_CHAT, **extra})
        assert got[0] == want[0] == 400, (extra, got, want)
        assert got[1]["error"]["message"] == want[1]["error"]["message"]
