"""Guided decoding: OpenAI ``response_format`` (json_object / json_schema)
plus vLLM's ``guided_json`` / ``guided_regex`` / ``guided_choice`` extensions
(:func:`grammar_for_request`; regex subset compiled by :func:`parse_regex`).

A copy of the JAX package's ``serving/guided.py`` (which is free of JAX but
lives in that package, so the port keeps its own): numpy and the standard
library only, the same languages, masks and caches, so that both engines
constrain a request alike.

- A **character-level machine** defines the language: either the exact JSON
  pushdown machine (``json_object`` — arbitrary nesting via an explicit
  context stack folded into the state, depth-capped so the state space stays
  finite) or a schema-compiled NFA (``json_schema`` — the schema tree is
  finite, so Thompson construction + lazy subset stepping never blows up).
- A **token-level wrapper** (:class:`TokenGrammar`) lifts the char machine to
  the tokenizer's vocabulary: for a machine state, a token is *allowed* iff
  walking its bytes does not dead-end (partial progress is fine — the token
  need not complete the value). Masks are computed lazily per visited state,
  vectorized over the whole vocab with numpy (grouping by unique state per
  byte position), packed to uint32 bitmask words, and cached.
- The engine uploads the words as int32 (the same bits) and the programs
  apply them on the device (``ops/sampling.apply_allow``) after the
  penalties, the bias and the ban, before the draw; the host-side state
  advances with each emitted token. A batch of guided slots alone decodes
  at horizon 1 (the host must see token N before it can mask token N+1); in
  a batch with unguided slots the guided ones emit substep 0's token only.

EOS policy: the eos bit is set iff the machine is in an accepting state (the
JSON value is complete), so generation can only stop on valid output; in the
accepting state whitespace remains allowed so ``min_tokens`` can never wedge
a slot with an all-banned row.

Schema subset (validated at compile): types object / array / string /
number / integer / boolean / null, ``enum`` / ``const`` of scalars,
``anyOf`` / ``oneOf``, type lists, nested to any (finite) schema depth.
Object properties are emitted **in schema order**; properties listed in
``required`` (or all, when ``required`` is absent — the OpenAI structured-
outputs contract) are mandatory, trailing non-required properties become
optional comma-groups. Unsupported keywords that would silently change
semantics (``$ref``, ``patternProperties``, ``additionalProperties: {...}``)
raise ``ValueError`` → HTTP 400.
"""

from __future__ import annotations

import json
import re
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Character-level machine interface
# ---------------------------------------------------------------------------
#
# A char machine is any object with:
#   start() -> state            (hashable)
#   step(state, byte:int) -> state | None
#   accepting(state) -> bool
# States are interned by TokenGrammar, so tuples/frozensets are fine.

_WS = frozenset(b" \t\n\r")
_DIGITS = frozenset(b"0123456789")
_HEX = frozenset(b"0123456789abcdefABCDEF")
# String-body bytes: anything >= 0x20 except '"' and '\'. Continuation bytes
# of multi-byte UTF-8 chars fall in 0x80-0xFF and are allowed — the machine
# runs on bytes, so it accepts any UTF-8 content like JSON itself does.
_STR_BODY = frozenset(b for b in range(0x20, 0x100) if b not in (0x22, 0x5C))
_ESC_ONE = frozenset(b'"\\/bfnrt')

# Modes where a number may implicitly end (next char re-dispatches in parent)
_NUM_ENDABLE = {"num_zero", "num_int", "num_frac", "num_exp"}
_NUM_CONT = {
    "num_zero": frozenset(b".eE"),
    "num_int": _DIGITS | frozenset(b".eE"),
    "num_frac": _DIGITS | frozenset(b"eE"),
    "num_exp": _DIGITS,
}


class JsonMachine:
    """Exact JSON over bytes: state = (mode, context-stack).

    The stack (tuple of 'O'/'A') makes nesting exact to ``max_depth``; a
    '{'/'[' beyond the cap rejects, keeping the reachable state space finite
    so TokenGrammar's caches stay bounded. ``top='object'`` is the OpenAI
    ``json_object`` contract (top level must be an object); ``top='value'``
    accepts any JSON value (used for schema-less array/scalar tests).
    """

    def __init__(self, top: str = "object", max_depth: int = 32):
        assert top in ("object", "value")
        self._top = top
        self._max_depth = max_depth

    def start(self):
        return ("top", ())

    def accepting(self, st) -> bool:
        mode, stack = st
        if mode == "done":
            return True
        return not stack and mode in _NUM_ENDABLE and self._top == "value"

    # -- helpers ------------------------------------------------------------

    def _value_done(self, stack):
        if not stack:
            return ("done", ())
        return (("obj_post_val", stack) if stack[-1] == "O"
                else ("arr_post_val", stack))

    def _dispatch_value(self, stack, c):
        """Transition for a byte seen where a value may start."""
        if c == 0x22:                                   # '"'
            return ("str", stack)
        if c == 0x7B:                                   # '{'
            if len(stack) >= self._max_depth:
                return None
            return ("obj_open", stack + ("O",))
        if c == 0x5B:                                   # '['
            if len(stack) >= self._max_depth:
                return None
            return ("arr_open", stack + ("A",))
        if c == 0x2D:                                   # '-'
            return ("num_neg", stack)
        if c == 0x30:                                   # '0'
            return ("num_zero", stack)
        if c in _DIGITS:
            return ("num_int", stack)
        if c == 0x74:                                   # 't'
            return (("lit", "true", 1), stack)
        if c == 0x66:                                   # 'f'
            return (("lit", "false", 1), stack)
        if c == 0x6E:                                   # 'n'
            return (("lit", "null", 1), stack)
        return None

    # -- the transition function --------------------------------------------

    def step(self, st, c: int):
        mode, stack = st
        # number end-and-redispatch: ',' after "12" closes the number first
        if mode in _NUM_ENDABLE and c not in _NUM_CONT[mode]:
            return self.step(self._value_done(stack), c)

        if mode == "top":
            if c in _WS:
                return st
            if self._top == "object":
                return ("obj_open", ("O",)) if c == 0x7B else None
            return self._dispatch_value(stack, c)
        if mode == "done":
            return st if c in _WS else None

        # strings (value and object-key variants share shapes)
        if mode in ("str", "key"):
            if c == 0x22:
                return (self._value_done(stack) if mode == "str"
                        else ("post_key", stack))
            if c == 0x5C:
                return (mode + "_esc", stack)
            return st if c in _STR_BODY else None
        if mode in ("str_esc", "key_esc"):
            base = mode[:-4]
            if c in _ESC_ONE:
                return (base, stack)
            if c == 0x75:                               # 'u'
                return (base + "_u4", stack)
            return None
        if isinstance(mode, str) and mode.endswith(("_u1", "_u2", "_u3",
                                                    "_u4")):
            if c not in _HEX:
                return None
            base, n = mode.rsplit("_u", 1)
            left = int(n) - 1
            return ((base, stack) if left == 0
                    else (f"{base}_u{left}", stack))

        # numbers
        if mode == "num_neg":
            if c == 0x30:
                return ("num_zero", stack)
            return ("num_int", stack) if c in _DIGITS else None
        if mode in _NUM_ENDABLE:                        # continuation chars
            if c == 0x2E:                               # '.'
                return ("num_dot", stack)
            if c in (0x65, 0x45):                       # e E
                return ("num_e", stack)
            return (mode, stack) if c in _DIGITS else None
        if mode == "num_dot":
            return ("num_frac", stack) if c in _DIGITS else None
        if mode == "num_e":
            if c in (0x2B, 0x2D):
                return ("num_esign", stack)
            return ("num_exp", stack) if c in _DIGITS else None
        if mode == "num_esign":
            return ("num_exp", stack) if c in _DIGITS else None

        # literals true/false/null
        if isinstance(mode, tuple) and mode[0] == "lit":
            _, word, i = mode
            if c != ord(word[i]):
                return None
            if i + 1 == len(word):
                return self._value_done(stack)
            return (("lit", word, i + 1), stack)

        # objects
        if mode == "obj_open":
            if c in _WS:
                return st
            if c == 0x22:
                return ("key", stack)
            if c == 0x7D:                               # '}'
                return self._value_done(stack[:-1])
            return None
        if mode == "post_key":
            if c in _WS:
                return st
            return ("obj_val_expect", stack) if c == 0x3A else None
        if mode == "obj_val_expect":
            if c in _WS:
                return st
            return self._dispatch_value(stack, c)
        if mode == "obj_post_val":
            if c in _WS:
                return st
            if c == 0x2C:                               # ','
                return ("obj_key_expect", stack)
            if c == 0x7D:
                return self._value_done(stack[:-1])
            return None
        if mode == "obj_key_expect":
            if c in _WS:
                return st
            return ("key", stack) if c == 0x22 else None

        # arrays
        if mode == "arr_open":
            if c in _WS:
                return st
            if c == 0x5D:                               # ']'
                return self._value_done(stack[:-1])
            return self._dispatch_value(stack, c)
        if mode == "arr_post_val":
            if c in _WS:
                return st
            if c == 0x2C:
                return ("arr_val_expect", stack)
            if c == 0x5D:
                return self._value_done(stack[:-1])
            return None
        if mode == "arr_val_expect":
            if c in _WS:
                return st
            return self._dispatch_value(stack, c)

        return None


# ---------------------------------------------------------------------------
# Schema → char NFA (Thompson construction, lazily determinized by stepping
# on frozensets of NFA nodes)
# ---------------------------------------------------------------------------


class _Nfa:
    """A mutable NFA under construction: nodes hold byte-transitions +
    epsilon edges."""

    def __init__(self):
        self.trans: List[Dict[int, set]] = []
        self.eps: List[set] = []

    def node(self) -> int:
        self.trans.append({})
        self.eps.append(set())
        return len(self.trans) - 1

    def edge(self, a: int, c: int, b: int):
        self.trans[a].setdefault(c, set()).add(b)

    def eedge(self, a: int, b: int):
        self.eps[a].add(b)


def _build(nfa: _Nfa, rx, a: int, b: int):
    """Wire regex AST ``rx`` between nodes a → b."""
    kind = rx[0]
    if kind == "lit":
        cur = a
        data = rx[1]
        for i, c in enumerate(data):
            nxt = b if i == len(data) - 1 else nfa.node()
            nfa.edge(cur, c, nxt)
            cur = nxt
        if not data:
            nfa.eedge(a, b)
    elif kind == "cls":
        for c in rx[1]:
            nfa.edge(a, c, b)
    elif kind == "seq":
        parts = rx[1]
        if not parts:
            nfa.eedge(a, b)
        else:
            cur = a
            for i, p in enumerate(parts):
                nxt = b if i == len(parts) - 1 else nfa.node()
                _build(nfa, p, cur, nxt)
                cur = nxt
    elif kind == "alt":
        for p in rx[1]:
            _build(nfa, p, a, b)
    elif kind == "star":
        mid = nfa.node()
        nfa.eedge(a, mid)
        _build(nfa, rx[1], mid, mid)
        nfa.eedge(mid, b)
    elif kind == "opt":
        nfa.eedge(a, b)
        _build(nfa, rx[1], a, b)
    else:  # pragma: no cover
        raise AssertionError(kind)


def _lit(s: bytes):
    return ("lit", s)


def _cls(s):
    return ("cls", frozenset(s if not isinstance(s, (bytes, bytearray))
                             else bytes(s)))


def _seq(*parts):
    return ("seq", tuple(parts))


def _alt(*parts):
    return ("alt", tuple(parts))


def _star(p):
    return ("star", p)


def _plus(p):
    return _seq(p, _star(p))


def _opt(p):
    return ("opt", p)


_RX_WS = _star(_cls(b" \t\n\r"))
_RX_STRING = _seq(
    _lit(b'"'),
    _star(_alt(
        _cls(_STR_BODY),
        _seq(_lit(b"\\"), _alt(
            _cls(_ESC_ONE),
            _seq(_lit(b"u"), _cls(_HEX), _cls(_HEX), _cls(_HEX),
                 _cls(_HEX)))))),
    _lit(b'"'))
_RX_INT = _seq(_opt(_lit(b"-")),
               _alt(_lit(b"0"), _seq(_cls(b"123456789"), _star(_cls(_DIGITS)))))
_RX_NUMBER = _seq(_RX_INT,
                  _opt(_seq(_lit(b"."), _plus(_cls(_DIGITS)))),
                  _opt(_seq(_cls(b"eE"), _opt(_cls(b"+-")),
                            _plus(_cls(_DIGITS)))))
_RX_BOOL = _alt(_lit(b"true"), _lit(b"false"))
_RX_NULL = _lit(b"null")

_UNSUPPORTED = ("$ref", "patternProperties", "allOf", "not",
                "if", "then", "else")


def schema_to_rx(schema) -> tuple:
    """Compile a JSON-schema subtree to a regex AST. Raises ValueError on
    constructs outside the documented subset."""
    if schema is True or schema == {}:
        # any value: approximate with the scalar types + flat containers is
        # wrong; instead reject — callers wanting "any JSON" should use
        # json_object mode's exact machine.
        raise ValueError("unconstrained subschema ({} / true) is not "
                         "supported inside json_schema; give it a type")
    if not isinstance(schema, dict):
        raise ValueError(f"schema must be an object, got {type(schema)}")
    for k in _UNSUPPORTED:
        if k in schema:
            raise ValueError(f"unsupported json_schema keyword: {k}")
    if isinstance(schema.get("additionalProperties"), dict):
        raise ValueError("additionalProperties with a schema is unsupported")
    if "enum" in schema or "const" in schema:
        vals = schema.get("enum", [schema.get("const")])
        outs = []
        for v in vals:
            if isinstance(v, (dict, list)):
                raise ValueError("enum/const of containers is unsupported")
            outs.append(_lit(json.dumps(v).encode()))
        return _alt(*outs)
    if "anyOf" in schema or "oneOf" in schema:
        subs = schema.get("anyOf") or schema.get("oneOf")
        return _alt(*[schema_to_rx(s) for s in subs])

    t = schema.get("type")
    if isinstance(t, list):
        return _alt(*[schema_to_rx({**schema, "type": one}) for one in t])
    if t == "string":
        return _RX_STRING
    if t == "number":
        return _RX_NUMBER
    if t == "integer":
        return _RX_INT
    if t == "boolean":
        return _RX_BOOL
    if t == "null":
        return _RX_NULL
    if t == "array":
        items = schema.get("items")
        if items is None:
            raise ValueError("array schema requires items")
        item = schema_to_rx(items)
        more = _star(_seq(_RX_WS, _lit(b","), _RX_WS, item))
        body = _seq(item, more)
        if int(schema.get("minItems", 0)) == 0:
            body = _opt(body)
        return _seq(_lit(b"["), _RX_WS, body, _RX_WS, _lit(b"]"))
    if t == "object":
        props = schema.get("properties")
        if not props:
            raise ValueError("object schema requires properties")
        required = set(schema.get("required", list(props.keys())))
        entries = [(k, _seq(_lit(json.dumps(k).encode()), _RX_WS,
                            _lit(b":"), _RX_WS, schema_to_rx(v)))
                   for k, v in props.items()]
        req = [(k, e) for k, e in entries if k in required]
        opt = [(k, e) for k, e in entries if k not in required]
        if req:
            body = req[0][1]
            for _, e in req[1:]:
                body = _seq(body, _RX_WS, _lit(b","), _RX_WS, e)
            for _, e in opt:
                body = _seq(body, _opt(_seq(_RX_WS, _lit(b","), _RX_WS, e)))
        else:
            # no required props: any non-empty SUBSET in schema order must
            # be reachable — alternate over which property appears FIRST,
            # each later one an optional comma-group (a linear
            # optional chain made the first property a prerequisite,
            # e.g. '{"b": 1}' was unreachable beside '{"a": 1}')
            alts = []
            for i, (_, first) in enumerate(opt):
                tail = first
                for _, later in opt[i + 1:]:
                    tail = _seq(tail, _opt(_seq(_RX_WS, _lit(b","),
                                               _RX_WS, later)))
                alts.append(tail)
            body = _opt(_alt(*alts))
        return _seq(_lit(b"{"), _RX_WS, body, _RX_WS, _lit(b"}"))
    raise ValueError(f"unsupported schema type: {t!r}")


class NfaMachine:
    """Char machine over a compiled NFA; states are frozensets of nodes.

    ``pad_ws`` (the json_schema default) wraps the language in optional
    whitespace; exact-match modes (guided_regex / guided_choice) keep the
    language as written."""

    def __init__(self, rx, pad_ws: bool = True):
        nfa = _Nfa()
        self._start_node = nfa.node()
        self._accept = nfa.node()
        if pad_ws:
            rx = _seq(_RX_WS, rx, _RX_WS)
        _build(nfa, rx, self._start_node, self._accept)
        self._nfa = nfa

    def _closure(self, nodes) -> frozenset:
        out, work = set(nodes), list(nodes)
        while work:
            n = work.pop()
            for m in self._nfa.eps[n]:
                if m not in out:
                    out.add(m)
                    work.append(m)
        return frozenset(out)

    def start(self):
        return self._closure({self._start_node})

    def step(self, st, c: int):
        nxt = set()
        for n in st:
            nxt.update(self._nfa.trans[n].get(c, ()))
        if not nxt:
            return None
        return self._closure(nxt)

    def accepting(self, st) -> bool:
        return self._accept in st


# ---------------------------------------------------------------------------
# Regex → AST (vLLM ``guided_regex``)
# ---------------------------------------------------------------------------

_CLASS_SHORTCUTS = {
    "d": frozenset(b"0123456789"),
    "w": frozenset(b"abcdefghijklmnopqrstuvwxyz"
                   b"ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_"),
    "s": frozenset(b" \t\n\r\f\v"),
}
_ANY = frozenset(b for b in range(256) if b != 0x0A)   # '.' excludes \n
_REP_CAP = 256      # per-quantifier {m,n} bound
# TOTAL expanded-AST atom budget: counted quantifiers compose
# MULTIPLICATIVELY under nesting ("((a{256}){256})" is 65k atoms from 12
# chars), and grammars compile synchronously in the request handler — the
# per-quantifier cap alone would let one request stall the server
_RX_NODE_CAP = 10_000


def _rx_size(rx) -> int:
    kind = rx[0]
    if kind in ("lit", "cls"):
        return max(1, len(rx[1])) if kind == "lit" else 1
    if kind in ("seq", "alt"):
        return 1 + sum(_rx_size(p) for p in rx[1])
    return 1 + _rx_size(rx[1])                     # star / opt


def parse_regex(pattern: str) -> tuple:
    """Parse a practical regex subset into the NFA-combinator AST.

    Supported: literals, escapes (incl. \\d \\w \\s and their negations),
    ``.``, ``[...]`` classes with ranges/negation, ``|``, ``(...)`` and
    ``(?:...)`` groups, ``* + ? {m} {m,} {m,n}`` (also non-greedy suffix
    ``?``, which constrains the same language). Anchors ``^``/``$`` at the
    ends are accepted and ignored (the whole output matches by
    construction). Unsupported constructs (backrefs, lookaround) raise
    ``ValueError`` → HTTP 400. ASCII/byte semantics: multi-byte UTF-8
    literals work byte-wise; classes are byte classes.
    """
    data = pattern.encode()
    pos = 0

    def err(msg):
        raise ValueError(f"guided_regex: {msg} at offset {pos} in "
                         f"{pattern!r}")

    def peek():
        return data[pos] if pos < len(data) else None

    def parse_alt():
        nonlocal pos
        parts = [parse_seq()]
        while peek() == 0x7C:                      # '|'
            pos += 1
            parts.append(parse_seq())
        return parts[0] if len(parts) == 1 else _alt(*parts)

    def parse_seq():
        nonlocal pos
        out = []
        while True:
            c = peek()
            if c is None or c in (0x7C, 0x29):     # '|' ')'
                break
            out.append(parse_repeat())
        return _seq(*out) if len(out) != 1 else out[0]

    def parse_repeat():
        nonlocal pos
        atom = parse_atom()
        while True:
            c = peek()
            if c == 0x2A:                          # '*'
                atom, pos = _star(atom), pos + 1
            elif c == 0x2B:                        # '+'
                atom, pos = _plus(atom), pos + 1
            elif c == 0x3F:                        # '?'
                atom, pos = _opt(atom), pos + 1
            elif c == 0x7B:                        # '{'
                end = data.find(b"}", pos)
                if end < 0:
                    err("unterminated {quantifier}")
                spec = data[pos + 1:end].decode()
                pos = end + 1
                m, _, n = spec.partition(",")
                try:
                    lo = int(m)
                    hi = None if _ and not n else (lo if not _ else int(n))
                except ValueError:
                    err(f"bad quantifier {{{spec}}}")
                if lo > _REP_CAP or (hi is not None and hi > _REP_CAP):
                    err(f"quantifier beyond the {_REP_CAP} bound")
                if hi is not None and hi < lo:
                    err(f"reversed quantifier {{{spec}}}")
                reps = lo + (1 if hi is None else hi - lo)
                if _rx_size(atom) * max(1, reps) > _RX_NODE_CAP:
                    err(f"pattern expansion beyond the {_RX_NODE_CAP}-node "
                        f"budget")
                rep = [atom] * lo
                if hi is None:
                    rep.append(_star(atom))
                else:
                    rep += [_opt(atom)] * (hi - lo)
                atom = _seq(*rep)
            else:
                break
            if peek() == 0x3F:                     # non-greedy: same language
                pos += 1
        return atom

    def parse_class_escape():
        """One escape inside or outside a class → (set|byte)."""
        nonlocal pos
        pos += 1
        c = peek()
        if c is None:
            err("dangling backslash")
        pos += 1
        ch = chr(c)
        if ch in _CLASS_SHORTCUTS:
            return _CLASS_SHORTCUTS[ch]
        if ch.upper() in _CLASS_SHORTCUTS and ch.isupper():
            return frozenset(range(256)) - _CLASS_SHORTCUTS[ch.lower()]
        mapped = {"n": 0x0A, "t": 0x09, "r": 0x0D, "f": 0x0C, "v": 0x0B,
                  "0": 0x00}.get(ch)
        if mapped is not None:
            return mapped
        if ch == "x":
            hx = data[pos:pos + 2].decode()
            pos += 2
            try:
                return int(hx, 16)
            except ValueError:
                err(f"bad \\x escape {hx!r}")
        if ch.isalnum():
            err(f"unsupported escape \\{ch}")
        return c                                   # escaped punctuation

    def parse_atom():
        nonlocal pos
        c = peek()
        if c == 0x28:                              # '('
            pos += 1
            if data[pos:pos + 2] == b"?:":
                pos += 2
            elif peek() == 0x3F:
                err("unsupported (?...) construct")
            inner = parse_alt()
            if peek() != 0x29:
                err("unterminated group")
            pos += 1
            return inner
        if c == 0x5B:                              # '['
            return _cls(parse_class())
        if c == 0x2E:                              # '.'
            pos += 1
            return _cls(_ANY)
        if c == 0x5E:                              # '^' only valid leading
            if pos != 0:
                err("mid-pattern '^' anchors are unsupported")
            pos += 1
            return _seq()
        if c == 0x24:                              # '$' only valid trailing
            if pos != len(data) - 1:
                err("mid-pattern '$' anchors are unsupported")
            pos += 1
            return _seq()
        if c == 0x5C:
            got = parse_class_escape()
            return _cls(got) if isinstance(got, frozenset) else \
                _lit(bytes([got]))
        if c in (0x2A, 0x2B, 0x3F, 0x7B):
            err("quantifier with nothing to repeat")
        pos += 1
        return _lit(bytes([c]))

    def parse_class():
        nonlocal pos
        pos += 1                                   # consume '['
        negate = peek() == 0x5E
        if negate:
            pos += 1
        out = set()
        first = True
        while True:
            c = peek()
            if c is None:
                err("unterminated character class")
            if c == 0x5D and not first:            # ']'
                pos += 1
                break
            first = False
            if c == 0x5C:
                got = parse_class_escape()
                if isinstance(got, frozenset):
                    out |= got
                    continue
                lo = got
            else:
                lo = c
                pos += 1
            if peek() == 0x2D and pos + 1 < len(data) \
                    and data[pos + 1] != 0x5D:     # range a-b
                pos += 1
                hi = peek()
                if hi == 0x5C:
                    hi = parse_class_escape()
                    if isinstance(hi, frozenset):
                        err("class shortcut cannot end a range")
                else:
                    pos += 1
                if hi < lo:
                    err("reversed class range")
                out |= set(range(lo, hi + 1))
            else:
                out.add(lo)
        return frozenset(range(256)) - frozenset(out) if negate \
            else frozenset(out)

    rx = parse_alt()
    if pos != len(data):
        err("unbalanced ')'")
    return rx


# ---------------------------------------------------------------------------
# Token-level wrapper
# ---------------------------------------------------------------------------


def token_byte_table(tokenizer) -> List[Optional[bytes]]:
    """token id → exact byte string, or None (never allowed: specials,
    unrepresentable artifacts). Handles our ByteTokenizer, byte-level-BPE HF
    tokenizers (GPT-2 unicode-to-byte map — Qwen/Llama-3/OPT/Phi), and
    sentencepiece-style '▁' tokenizers (Gemma/Mistral); falls back to
    per-token decode when no token-string view exists."""
    V = tokenizer.vocab_size
    inner = getattr(tokenizer, "_tok", None)
    out: List[Optional[bytes]] = [None] * V
    if inner is None:
        # ByteTokenizer: id == byte for < 256; specials stay None
        for i in range(min(256, V)):
            out[i] = bytes([i])
        return out

    specials = set(getattr(inner, "all_special_ids", []) or [])
    # GPT-2 byte-level unicode map (the printable stand-ins byte-level BPE
    # tokenizers store token strings in)
    bs = list(range(0x21, 0x7F)) + list(range(0xA1, 0xAD)) + \
        list(range(0xAE, 0x100))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    uni2byte = {chr(c): b for b, c in zip(bs, cs)}

    try:
        toks = inner.convert_ids_to_tokens(list(range(V)))
    # a capability probe: a tokenizer without convert_ids_to_tokens takes
    # the decode-based byte table below
    except Exception:
        toks = None
    if toks is not None:
        sample = [t for t in toks[:2000] if t]
        byte_level = sample and all(ch in uni2byte for t in sample[:50]
                                    for ch in t)
        bytefb = re.compile(r"^<0x([0-9A-Fa-f]{2})>$")
        for i, t in enumerate(toks):
            if i in specials or not t:
                continue
            if byte_level:
                try:
                    out[i] = bytes(uni2byte[ch] for ch in t)
                    continue
                except KeyError:
                    pass
            m = bytefb.match(t)
            if m:
                # sentencepiece byte-fallback: "<0x22>" DECODES to one raw
                # byte — mapping the literal 6-char string would desync the
                # FSM from the emitted text
                out[i] = bytes([int(m.group(1), 16)])
                continue
            out[i] = t.replace("▁", " ").encode("utf-8")
        return out
    for i in range(V):                    # last-resort: lossy single decodes
        if i in specials:
            continue
        s = inner.decode([i])
        if s and "�" not in s:
            out[i] = s.encode("utf-8")
    return out


class TokenGrammar:
    """A char machine lifted to token-level masks over one vocabulary.

    States are interned to dense ids; per-state artifacts are cached:
    ``_rows[sid]`` = 256-wide next-sid table (-1 = reject) and
    ``_masks[sid]`` = packed uint32 allow-bitmask over the vocab (bit v of
    word v>>5). The mask computation walks ALL tokens in parallel with
    numpy, grouping by unique live state per byte position — cost is
    O(L × unique_states × V) elementwise, a few ms for a 152k vocab, paid
    once per distinct grammar state ever visited.
    """

    def __init__(self, machine, tokenizer, eos_ids, exact: bool = False):
        self._m = machine
        # exact-match grammars (guided_regex / guided_choice) allow NOTHING
        # in their final accepting states — not even whitespace — so a
        # device-side min_tokens eos-ban would leave an all-masked logits
        # row; engine.submit rejects that combination
        self.exact = exact
        self._eos = [e for e in (eos_ids or []) if e is not None]
        tb = token_byte_table(tokenizer)
        self.vocab_size = len(tb)
        self.n_words = (self.vocab_size + 31) // 32
        L = max((len(b) for b in tb if b), default=1)
        self._tbmat = np.zeros((self.vocab_size, L), np.uint8)
        self._tlen = np.zeros(self.vocab_size, np.int32)
        self._no_bytes = np.ones(self.vocab_size, bool)
        for i, b in enumerate(tb):
            if b:
                self._tbmat[i, :len(b)] = np.frombuffer(b, np.uint8)
                self._tlen[i] = len(b)
                self._no_bytes[i] = False
        self._tb = tb
        # strong tokenizer ref: the grammar cache keys on id(tokenizer), so
        # the tokenizer must outlive the grammar or a recycled address could
        # alias a different vocab
        self._tokenizer = tokenizer
        # BOUNDED caches keyed by the (hashable) machine STATE itself:
        # per-state masks at ~V/8 bytes leak for the
        # server's lifetime unbounded, and an earlier fix that LRU'd masks
        # but permanently interned every state in an id table just moved
        # the leak down a level. No global interning exists now; evicted
        # entries recompute from the state object, so eviction can never
        # invalidate a live request's cursor.
        self._rows: "OrderedDict[object, tuple]" = OrderedDict()
        self._masks: "OrderedDict[object, np.ndarray]" = OrderedDict()
        self._rows_cap = 1024
        self._masks_cap = 2048
        # whitespace token ids: allowed in accepting states alongside eos so
        # a min_tokens-banned eos can never leave an all-masked row
        self._ws_ids = [i for i, b in enumerate(tb)
                        if b and all(c in _WS for c in b)]
        self.start_state = machine.start()

    def _row(self, st) -> tuple:
        """256-entry tuple of next states (None = reject) for ``st``."""
        row = self._rows.get(st)
        if row is None:
            row = tuple(self._m.step(st, c) for c in range(256))
            self._rows[st] = row
            if len(self._rows) > self._rows_cap:
                self._rows.popitem(last=False)
        else:
            self._rows.move_to_end(st)
        return row

    def accepting(self, st) -> bool:
        return self._m.accepting(st)

    def advance(self, st, token_id: int):
        """State after emitting ``token_id``; None = rejected."""
        if token_id in self._eos:
            return st if self.accepting(st) else None
        if token_id >= self.vocab_size or self._no_bytes[token_id]:
            return None
        for c in self._tbmat[token_id, :self._tlen[token_id]]:
            st = self._row(st)[c]
            if st is None:
                return None
        return st

    def mask_words(self, st) -> np.ndarray:
        """Packed uint32 allow-bitmask for machine state ``st``.

        The vocab walk vectorizes with WALK-LOCAL state ids (a dict built
        per computation) — nothing outlives the call except the LRU'd
        result."""
        m = self._masks.get(st)
        if m is not None:
            self._masks.move_to_end(st)
            return m
        V = self.vocab_size
        local: Dict[object, int] = {st: 0}
        states: List[object] = [st]

        def lid(s) -> int:
            i = local.get(s)
            if i is None:
                i = len(states)
                local[s] = i
                states.append(s)
            return i

        row_ids_memo: Dict[int, np.ndarray] = {}

        def row_ids(u: int) -> np.ndarray:
            r = row_ids_memo.get(u)
            if r is None:
                r = np.fromiter(
                    (-1 if s is None else lid(s)
                     for s in self._row(states[u])), np.int64, 256)
                row_ids_memo[u] = r
            return r

        cur = np.zeros(V, np.int64)
        cur[self._no_bytes] = -1
        for p in range(self._tbmat.shape[1]):
            act = (p < self._tlen) & (cur >= 0)
            if not act.any():
                break
            nxt = cur.copy()
            for u in np.unique(cur[act]):
                sel = act & (cur == u)
                nxt[sel] = row_ids(int(u))[self._tbmat[sel, p]]
            cur = nxt
        allowed = cur >= 0
        if self.accepting(st):
            for e in self._eos:
                if e < V:
                    allowed[e] = True
        if not allowed.any():
            # unreachable by construction (accepting states allow ws + eos;
            # others always have a continuation) — but a vocab missing the
            # needed bytes must finish, not wedge
            for e in self._eos:
                if e < V:
                    allowed[e] = True
        words = np.zeros(self.n_words, np.uint32)
        idx = np.nonzero(allowed)[0]
        np.bitwise_or.at(words, idx >> 5,
                         (np.uint32(1) << (idx & 31).astype(np.uint32)))
        self._masks[st] = words
        if len(self._masks) > self._masks_cap:
            self._masks.popitem(last=False)
        return words


class GuidedState:
    """Per-request cursor over a shared TokenGrammar."""

    __slots__ = ("grammar", "state", "dead")

    def __init__(self, grammar: TokenGrammar):
        self.grammar = grammar
        self.state = grammar.start_state
        self.dead = False

    def clone(self) -> "GuidedState":
        return GuidedState(self.grammar)

    def mask_words(self) -> np.ndarray:
        if self.dead:
            # force-finish: only eos (and ws) remain
            g = self.grammar
            words = np.zeros(g.n_words, np.uint32)
            for e in g._eos + g._ws_ids:
                if e < g.vocab_size:
                    words[e >> 5] |= np.uint32(1) << np.uint32(e & 31)
            return words
        return self.grammar.mask_words(self.state)

    def advance(self, token_id: int) -> None:
        if self.dead:
            return
        nxt = self.grammar.advance(self.state, token_id)
        if nxt is None:
            self.dead = True
        else:
            self.state = nxt

    def fingerprint(self):
        """Hashable identity of the current mask: two cursors with equal
        fingerprints produce bit-identical ``mask_words()`` (machine states
        are the TokenGrammar mask cache's own keys). The engine's
        device-mask caches (Engine._allow_row / _allow_words) key on
        this to skip rebuilding + re-uploading an allow operand whose FSM
        did not advance between dispatches."""
        return (self.state, self.dead)

    @property
    def complete(self) -> bool:
        return (not self.dead) and self.grammar.accepting(self.state)


# ---------------------------------------------------------------------------
# Server-facing entry
# ---------------------------------------------------------------------------

_GRAMMAR_CACHE: Dict[Tuple[int, str], TokenGrammar] = {}
_CACHE_CAP = 64


def grammar_for(tokenizer, response_format: dict, eos_ids) -> TokenGrammar:
    """Resolve an OpenAI ``response_format`` dict to a (cached) TokenGrammar.

    Accepts {"type": "json_object"} and {"type": "json_schema",
    "json_schema": {"schema": {...}}} (also tolerates the schema directly
    under "schema" — the vLLM extension shape). Raises ValueError for
    malformed input; the server maps that to HTTP 400.
    """
    t = response_format.get("type")
    if t == "json_object":
        key = (id(tokenizer), "json_object")
        g = _GRAMMAR_CACHE.get(key)
        if g is None:
            g = TokenGrammar(JsonMachine(top="object"), tokenizer, eos_ids)
            _cache_put(key, g)
        return g
    if t == "json_schema":
        spec = response_format.get("json_schema", response_format)
        schema = spec.get("schema") if isinstance(spec, dict) else None
        if not isinstance(schema, dict):
            raise ValueError("json_schema response_format requires "
                             "json_schema.schema to be an object")
        key = (id(tokenizer), json.dumps(schema, sort_keys=True))
        g = _GRAMMAR_CACHE.get(key)
        if g is None:
            g = TokenGrammar(NfaMachine(schema_to_rx(schema)), tokenizer,
                             eos_ids)
            _cache_put(key, g)
        return g
    raise ValueError(f"unsupported response_format type: {t!r} "
                     "(expected json_object or json_schema)")


def _cache_put(key, g):
    if len(_GRAMMAR_CACHE) >= _CACHE_CAP:
        _GRAMMAR_CACHE.pop(next(iter(_GRAMMAR_CACHE)))
    _GRAMMAR_CACHE[key] = g


def _cached(tokenizer, key_tail: str, build) -> TokenGrammar:
    key = (id(tokenizer), key_tail)
    g = _GRAMMAR_CACHE.get(key)
    if g is None:
        g = build()
        _cache_put(key, g)
    return g


def grammar_for_request(tokenizer, body: dict, eos_ids):
    """Resolve a request body's constrained-output spec to a TokenGrammar.

    Beside OpenAI ``response_format``, accepts vLLM's sampling-params
    extensions: ``guided_json`` (a JSON schema), ``guided_regex`` (compiled
    by :func:`parse_regex`), and ``guided_choice`` (list of exact strings).
    At most one spec may be present. Returns None when unconstrained;
    raises ValueError (→ HTTP 400) on conflicts or malformed specs.
    """
    specs = [k for k in ("response_format", "guided_json", "guided_regex",
                         "guided_choice") if body.get(k) is not None]
    if not specs:
        return None
    # a present-but-null response_format is "unset" (OpenAI SDKs serialize
    # it that way) — body.get's default doesn't cover that, hence `or {}`
    rf = body.get("response_format") or {}
    if rf.get("type") in (None, "text") and specs == ["response_format"]:
        return None
    if len(specs) > 1:
        raise ValueError(f"at most one guided-decoding spec allowed, got "
                         f"{specs}")
    kind = specs[0]
    if kind == "response_format":
        return grammar_for(tokenizer, body["response_format"], eos_ids)
    if kind == "guided_json":
        schema = body["guided_json"]
        if not isinstance(schema, dict):
            raise ValueError("guided_json must be a JSON schema object")
        return _cached(
            tokenizer, "json:" + json.dumps(schema, sort_keys=True),
            lambda: TokenGrammar(NfaMachine(schema_to_rx(schema)),
                                 tokenizer, eos_ids))
    if kind == "guided_regex":
        pattern = body["guided_regex"]
        if not isinstance(pattern, str) or not pattern:
            raise ValueError("guided_regex must be a non-empty string")
        return _cached(
            tokenizer, "re:" + pattern,
            lambda: TokenGrammar(
                NfaMachine(parse_regex(pattern), pad_ws=False),
                tokenizer, eos_ids, exact=True))
    choices = body["guided_choice"]
    if not isinstance(choices, list) or not choices \
            or not all(isinstance(c, str) for c in choices):
        raise ValueError("guided_choice must be a non-empty list of strings")
    return _cached(
        tokenizer, "choice:" + json.dumps(choices),
        lambda: TokenGrammar(
            NfaMachine(_alt(*[_lit(c.encode()) for c in choices]),
                       pad_ws=False),
            tokenizer, eos_ids, exact=True))
