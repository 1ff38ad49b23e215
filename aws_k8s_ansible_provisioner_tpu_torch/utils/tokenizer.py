"""Tokenizers: a checkpoint's HF tokenizer, the byte-level tokenizer, and
the streaming detokenizer.

The port keeps its own copy of the JAX package's tokenizer module so that it
imports nothing from that package. :func:`load_tokenizer` gives a checkpoint
directory's own tokenizer (``transformers.AutoTokenizer``, local files
only) and falls back, with a logged warning, to :class:`ByteTokenizer` when
the directory has no tokenizer files or they do not load; ``transformers``
is imported only to load them, so the port imports on a machine without
it.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional, Sequence

log = logging.getLogger(__name__)


class ByteTokenizer:
    """Byte-level tokenizer: token id = byte value; specials live above 255.

    Deterministic, vocabulary 256 + 3 specials. Round-trips arbitrary UTF-8.
    """

    PAD = 256
    BOS = 257
    EOS = 258

    vocab_size = 259
    pad_token_id = PAD
    bos_token_id = BOS
    eos_token_id = EOS
    name = "byte-fallback"

    def encode(self, text: str, add_bos: bool = False) -> List[int]:
        ids = list(text.encode("utf-8"))
        return ([self.BOS] + ids) if add_bos else ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        data = bytes(i for i in ids if i < 256)
        return data.decode("utf-8", errors="replace")


class HFTokenizer:
    """A checkpoint directory's ``transformers`` tokenizer behind the byte
    tokenizer's interface (the JAX package's ``HFTokenizer``); its chat
    template, when it has one, is what ``serving/chat_template.py``
    renders with."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
        self.vocab_size = len(self._tok)
        self.pad_token_id = self._tok.pad_token_id
        self.bos_token_id = self._tok.bos_token_id
        self.eos_token_id = self._tok.eos_token_id
        self.name = path

    def encode(self, text: str, add_bos: bool = False) -> List[int]:
        ids = self._tok.encode(text, add_special_tokens=False)
        if add_bos and self.bos_token_id is not None:
            ids = [self.bos_token_id] + ids
        return ids

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        return self._tok.decode(ids, skip_special_tokens=skip_special_tokens)

    def apply_chat_template(self, messages, add_generation_prompt=True, **kw):
        return self._tok.apply_chat_template(
            messages, tokenize=False,
            add_generation_prompt=add_generation_prompt, **kw)


class IncrementalDetokenizer:
    """Streaming detokenization in O(window) per token.

    Keeps a committed prefix and re-decodes only a small tail window where BPE
    merges or multi-byte characters can still change. ``push`` returns newly
    stable text (may be empty); ``finish`` flushes the remainder. A trailing
    U+FFFD is withheld, since the next token may complete the character.
    """

    WINDOW = 8  # tokens that may still interact with future tokens

    def __init__(self, tokenizer):
        self._tok = tokenizer
        self._ids: list = []
        self._committed = ""      # text for ids[:_prefix]
        self._prefix = 0          # number of ids folded into _committed
        self._emitted = 0         # chars of stable text handed to the caller

    def _stable_text(self) -> str:
        return self._committed + self._tok.decode(self._ids[self._prefix:])

    def push(self, token_id: int) -> str:
        self._ids.append(token_id)
        if len(self._ids) - self._prefix > 2 * self.WINDOW:
            # fold the older half of the window into the committed prefix,
            # at a split point that provably round-trips
            end = len(self._ids)
            whole = self._tok.decode(self._ids[self._prefix:end])
            for cut in range(end - self.WINDOW, self._prefix, -1):
                head = self._tok.decode(self._ids[self._prefix:cut])
                tailtxt = self._tok.decode(self._ids[cut:end])
                if head + tailtxt == whole:
                    self._committed += head
                    self._prefix = cut
                    break
        text = self._stable_text()
        while text and text[-1] == "�":
            text = text[:-1]
        delta = text[self._emitted:]
        self._emitted = len(text)
        return delta

    def finish(self) -> str:
        """Flush any held-back tail (including genuine replacement chars)."""
        text = self._stable_text()
        delta = text[self._emitted:]
        self._emitted = len(text)
        return delta

    @property
    def text(self) -> str:
        return self._stable_text()


# the files a HF tokenizer is built from (one of them names the rest)
TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json",
                   "tokenizer.model", "vocab.json", "vocab.txt",
                   "spiece.model")


def load_tokenizer(checkpoint_dir: Optional[str] = None):
    """The checkpoint's tokenizer when ``checkpoint_dir`` holds tokenizer
    files that load, else the byte tokenizer. The downgrade of a
    checkpoint is logged: a real model served with byte ids generates
    garbage (its eos id can never come out), so it must show. A directory
    without tokenizer files does not reach ``transformers``, some versions
    of which build an empty tokenizer from a bare ``config.json`` (and
    importing it costs seconds of a start)."""
    if checkpoint_dir:
        if not any(os.path.exists(os.path.join(checkpoint_dir, f))
                   for f in TOKENIZER_FILES):
            log.warning(
                "no tokenizer files in %s; falling back to byte-level "
                "tokenizer — generations from a real checkpoint will be "
                "wrong", checkpoint_dir)
            return ByteTokenizer()
        try:
            return HFTokenizer(checkpoint_dir)
        # the reference's downgrade: files that do not load, no transformers
        except Exception as e:  # noqa: BLE001
            log.warning(
                "failed to load tokenizer from %s (%s: %s); falling back to "
                "byte-level tokenizer — generations from a real checkpoint "
                "will be wrong", checkpoint_dir, type(e).__name__, e)
    return ByteTokenizer()
