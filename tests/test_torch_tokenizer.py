"""The port's tokenizer module against the JAX package's: the byte
tokenizer and the incremental detokenizer give the same ids and the same
streamed text, ``load_tokenizer`` without a checkpoint is the byte
tokenizer, and with one the checkpoint's HF tokenizer (a byte-level BPE
written in process, with a chat template), which encodes, decodes and
renders chats as the JAX ``HFTokenizer`` does; a directory without
tokenizer files gives the byte tokenizer and a logged warning."""

import json
import logging

import pytest

from aws_k8s_ansible_provisioner_tpu.utils import tokenizer as jtok
from aws_k8s_ansible_provisioner_tpu_torch.utils import tokenizer as ttok

TEXTS = ["Hello, world", "naïve café — 東京 🙂", ""]


@pytest.mark.parametrize("text", TEXTS)
def test_byte_tokenizer_matches_jax(text):
    ref, got = jtok.ByteTokenizer(), ttok.ByteTokenizer()
    for bos in (False, True):
        assert got.encode(text, add_bos=bos) == ref.encode(text, add_bos=bos)
    ids = got.encode(text) + [got.EOS, got.PAD]
    assert got.decode(ids) == ref.decode(ids) == text
    assert (got.vocab_size, got.eos_token_id, got.bos_token_id) == \
        (ref.vocab_size, ref.eos_token_id, ref.bos_token_id)


@pytest.mark.parametrize("text", TEXTS[:2])
def test_incremental_detokenizer_streams_like_jax(text):
    """Token by token, a multi-byte character is held back until it is
    whole; the concatenated deltas equal the full decode."""
    ids = ttok.ByteTokenizer().encode(text * 5)
    ref = jtok.IncrementalDetokenizer(jtok.ByteTokenizer())
    got = ttok.IncrementalDetokenizer(ttok.ByteTokenizer())
    deltas = []
    for t in ids:
        d = got.push(t)
        assert d == ref.push(t)
        assert "�" not in d
        deltas.append(d)
    deltas.append(got.finish())
    assert deltas[-1] == ref.finish()
    assert "".join(deltas) == text * 5 == got.text


def test_load_tokenizer_without_checkpoint_is_bytes():
    assert isinstance(ttok.load_tokenizer(), ttok.ByteTokenizer)
    assert type(jtok.load_tokenizer(None)) is jtok.ByteTokenizer


_CHAT_TEMPLATE = (
    "{% for m in messages %}<|{{ m.role }}|>{{ m.content }}\n{% endfor %}"
    "{% if add_generation_prompt %}<|assistant|>{% endif %}")
_MESSAGES = [{"role": "system", "content": "Be brief."},
             {"role": "user", "content": "hello, world 42"}]


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """A byte-level BPE tokenizer directory with a chat template."""
    from test_real_checkpoint import _write_byte_level_tokenizer

    d = tmp_path_factory.mktemp("tok") / "bpe"
    d.mkdir()
    _write_byte_level_tokenizer(d)
    cfg = json.loads((d / "tokenizer_config.json").read_text())
    cfg["chat_template"] = _CHAT_TEMPLATE
    (d / "tokenizer_config.json").write_text(json.dumps(cfg))
    return str(d)


@pytest.mark.parametrize("text", ["hello,world42", "abc def\n", ""])
def test_hf_tokenizer_matches_jax(hf_dir, text):
    ref, got = jtok.HFTokenizer(hf_dir), ttok.HFTokenizer(hf_dir)
    assert (got.vocab_size, got.eos_token_id, got.bos_token_id,
            got.pad_token_id) == (ref.vocab_size, ref.eos_token_id,
                                  ref.bos_token_id, ref.pad_token_id)
    for bos in (False, True):
        assert got.encode(text, add_bos=bos) == ref.encode(text, add_bos=bos)
    ids = got.encode(text) + [got.eos_token_id]
    for skip in (True, False):
        assert got.decode(ids, skip_special_tokens=skip) == \
            ref.decode(ids, skip_special_tokens=skip)


def test_hf_tokenizer_chat_template_matches_jax(hf_dir):
    """The tokenizer's own template renders a chat as the JAX
    ``HFTokenizer`` renders it, and the port's chat templater takes it
    (no ``--chat-template`` file) as the JAX templater does."""
    from aws_k8s_ansible_provisioner_tpu.serving.chat_template import \
        ChatTemplater as JTemplater
    from aws_k8s_ansible_provisioner_tpu_torch.serving.chat_template import \
        ChatTemplater

    ref, got = jtok.HFTokenizer(hf_dir), ttok.HFTokenizer(hf_dir)
    for gen in (True, False):
        want = ref.apply_chat_template(_MESSAGES, add_generation_prompt=gen)
        assert got.apply_chat_template(_MESSAGES,
                                       add_generation_prompt=gen) == want
        rendered = ChatTemplater("tiny", got).render(
            _MESSAGES, add_generation_prompt=gen)
        assert rendered == want == JTemplater("tiny", ref).render(
            _MESSAGES, add_generation_prompt=gen)
    assert want.startswith("<|system|>Be brief.")


def test_load_tokenizer_from_a_checkpoint(hf_dir):
    tok = ttok.load_tokenizer(hf_dir)
    assert isinstance(tok, ttok.HFTokenizer)
    assert tok.encode("hi") == jtok.load_tokenizer(hf_dir).encode("hi")


def test_load_tokenizer_without_tokenizer_files_warns(tmp_path, caplog,
                                                     monkeypatch):
    """A checkpoint directory without tokenizer files (what the card's
    checkpoints here have) gets the byte tokenizer and a logged warning,
    as the JAX ``load_tokenizer`` does, without reaching ``transformers``
    (some of its versions build an empty tokenizer from a bare
    config.json)."""
    (tmp_path / "config.json").write_text(json.dumps({"model_type": "qwen3"}))

    def no_hf(path):
        raise AssertionError("transformers was asked for a tokenizer")

    monkeypatch.setattr(ttok, "HFTokenizer", no_hf)
    with caplog.at_level(logging.WARNING):
        tok = ttok.load_tokenizer(str(tmp_path))
    assert type(tok) is ttok.ByteTokenizer
    assert type(jtok.load_tokenizer(str(tmp_path))) is jtok.ByteTokenizer
    assert "falling back to byte-level tokenizer" in caplog.text
    assert str(tmp_path) in caplog.text


def test_load_tokenizer_with_broken_files_warns(tmp_path, caplog):
    """Tokenizer files that do not load: the byte tokenizer and the
    reference's warning, naming the error."""
    (tmp_path / "tokenizer.json").write_text("{ not json")
    with caplog.at_level(logging.WARNING):
        tok = ttok.load_tokenizer(str(tmp_path))
    assert type(tok) is ttok.ByteTokenizer
    assert type(jtok.load_tokenizer(str(tmp_path))) is jtok.ByteTokenizer
    assert "failed to load tokenizer from" in caplog.text
