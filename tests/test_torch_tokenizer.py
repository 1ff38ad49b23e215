"""The port's tokenizer module against the JAX package's: the byte
tokenizer and the incremental detokenizer give the same ids and the same
streamed text, and ``load_tokenizer`` without a checkpoint is the byte
tokenizer."""

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
