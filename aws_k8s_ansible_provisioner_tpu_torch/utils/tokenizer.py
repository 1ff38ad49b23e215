"""Tokenizers: the byte-level tokenizer and the streaming detokenizer.

The port keeps its own copy of the JAX package's tokenizer module so that it
imports nothing from that package. The checkpoint's HF tokenizer comes over
with checkpoint loading.
"""

from __future__ import annotations

from typing import List, Sequence


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


def load_tokenizer():
    """The tokenizer the port serves with: the byte tokenizer, since the
    port loads no checkpoint yet (the JAX server without
    ``--checkpoint-dir`` serves the same one)."""
    return ByteTokenizer()
