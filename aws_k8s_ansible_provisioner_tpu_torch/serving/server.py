"""OpenAI-compatible HTTP server of the PyTorch port.

Routes, over a ``ThreadingHTTPServer`` with the engine stepping on its own
thread:

- ``GET /v1/models``; ``POST /v1/completions`` and ``POST
  /v1/chat/completions`` (``messages``, a non-empty list, rendered by the
  chat templater: the ``--chat-template`` file, else the tokenizer's
  template, else the model family's ``phi`` or ``opt`` style), answered
  whole or, with ``stream``, as server-sent events; the JSON fields of the
  JAX server's answers;
- ``GET /health``, ``/healthz``, ``/ping``: one answer, status ``ok``,
  ``degraded`` (a step failed; ``last_error``), ``draining`` or
  ``stalled`` (a step has run past ``watchdog_stall_s``: 503, the liveness
  probe's cue), with the JAX server's keys, its ``slo``, ``slo_burning``,
  ``flight``, ``device``, ``hbm_drift`` and ``capacity`` blocks among them;
- ``GET /readyz``: 200, or 503 while draining (``X-TPU-Draining: 1``) or
  stalled; ``GET /load``: active, queued, slots, draining (the router's
  poller); ``GET /metrics``: the engine's ``tpu_serve_*`` and ``vllm_*``
  families, tracing's, the flight recorder's, the SLO engine's, the
  device monitor's (``tpu_device_*``), the capacity estimator's
  (``tpu_capacity_*``), the autoscaler's (``tpu_autoscale_*``, at its
  defaults: a replica runs no controller) and the decode pipeline's,
  Prometheus text or OpenMetrics by ``Accept`` (the per-card gauges of the
  node exporter's source come with the training slice);
- ``GET /debug/roofline`` (the device monitor's per-program table and HBM
  ledger), ``/debug/capacity``, ``/debug/events?last=N`` (the flight
  recorder's ring), ``/debug/flight/<request id>`` (an anomaly's
  timeline) and ``/debug/profile?ms=N`` (a ``torch.profiler`` capture
  written as a Chrome trace, its path returned);
- ``POST`` (or ``GET``) ``/admin/drain`` (``timeout_s``, default
  ``--drain-timeout``; ``exit``, default true: stop the server once the
  drain is done) and ``POST /admin/undrain``. SIGTERM drains as
  ``/admin/drain`` does and the process exits 0 when the requests in
  flight have finished (a stream once it has sent its ``[DONE]``).

A completions request reads ``model``, ``prompt``, ``max_tokens``,
``temperature``, ``top_k``, ``top_p``, ``ignore_eos``, ``seed``,
``deadline_ms`` (or the ``X-Request-Deadline-Ms`` header; the body wins)
and the JAX server's request fields: ``stop`` (a string or a list; the
text is cut at the earliest, finish ``stop``), ``stop_token_ids`` and
``min_tokens``, ``n`` in [1, 8] (choice i draws with seed + i; choice 0
equals the n=1 answer when they are prefilled alike: on a card a batch
prefill of n prompts rounds apart from a batch of one, ROADMAP C22),
``best_of`` in [n, 8] (the n best by cumulative chosen-token logprob),
``echo`` (with ``logprobs``, the payload covers the prompt), ``logprobs``
(an integer in [0, 8]; ``top_logprobs`` is ignored on completions, as
there), ``prompt_logprobs``, ``logit_bias`` and the presence, frequency
and repetition penalties. A chat request reads the same fields but
``prompt`` and ``echo`` (refused), with ``temperature`` 1.0 by default,
``best_of`` = ``n`` and ``logprobs: true`` with ``top_logprobs``. Both
read the guided-decoding fields (``serving/guided.py``): OpenAI
``response_format`` (``json_object``, ``json_schema``; ``text`` or null is
no grammar) or one of vLLM's ``guided_json``, ``guided_regex`` and
``guided_choice``; each choice of ``n`` > 1 gets a cursor of its own, and
a malformed or conflicting spec gets 400 ``guided decoding: ...``.

``model`` names the served model or one of the LoRA adapters registered
with ``--lora NAME=PATH`` (``/v1/models`` lists them with their
``parent``); the answer carries the name asked for.

A completion continues an incoming W3C ``traceparent`` (or starts a
trace) in a ``server.request`` span with the five phase children of the
JAX server (``_completions``), exported by the tracer ``build_state``
configures (``--otlp-endpoint``); the span's ids ride ``usage`` and error
bodies. The flight recorder, the SLO engine, the device monitor and the
capacity estimator are configured from the same ``ServingConfig``
(:func:`configure_observability`), and the chaos faults of
``serving/chaos.py`` arm from ``$TPU_SERVE_CHAOS``.

``stream`` answers with ``text/event-stream`` over chunked transfer
encoding: ``data: {...}`` events, one per ready piece of text and choice
(``index``), each with the generated ``token_ids`` it covers; text is held
back while it may be an incomplete UTF-8 sequence or a stop string's
prefix; with ``logprobs`` one event per token and its record; a chat
stream starts each choice with its role, an echoed one with the prompt;
``stream_options.include_usage`` puts ``usage: null`` on every event and a
usage-only event last; then ``data: [DONE]``. ``best_of`` > ``n`` and
``prompt_logprobs`` are refused with ``stream``. A continuation
(``resume_token_ids``, the ids a client already has, and
``resume_text_chars``, the characters; ``stream``, one choice, no
``echo``, no ``prompt_logprobs``; ``max_tokens`` the budget left) is
the router's failover of a dying stream: the engine rebuilds prompt +
resume and the stream sends only what the client lacks, so that the
spliced stream is the undisturbed one; relayed ids that already end it get
the finish alone.

It answers as the JAX server does: another model than the served one gets
404 ``model_not_found``; a prompt is a string, a list of strings (the first
is served; an empty list is the empty string) or, beyond the JAX server, a
list of token ids; an empty prompt is served as the EOS token;
``max_tokens`` must lie in [1, the engine's ``max_len``] (the engine then
clamps it to the room the prompt leaves); a field out of its range gets
400; a deadline that is not a positive number of milliseconds gets 400, an
expired one 408 (``deadline_exceeded``); a request the engine sheds gets
429 ``engine_overloaded:<reason>`` with ``Retry-After``, or 503
``draining`` with ``Retry-After`` and ``X-TPU-Draining: 1``.

With ``--checkpoint-dir`` it serves a local HF checkpoint directory
(``build_state``: the directory's config, its weights through the
converted-params cache, its tokenizer when it has tokenizer files), after
running every program once (``Engine.warmup``; ``--no-warmup`` skips it)
and, with ``--aot-manifest``, after checking the memory-fit manifest of
``serving/aot.py`` against the engine::

    python -m aws_k8s_ansible_provisioner_tpu_torch.serving.server \\
        --checkpoint-dir /models/Qwen/Qwen3-0.6B --device cuda

Without a checkpoint it runs seeded random weights and the byte
tokenizer, as the JAX server does without ``--checkpoint-dir``::

    python -m aws_k8s_ansible_provisioner_tpu_torch.serving.server \\
        --model Qwen/Qwen3-0.6B --device cuda

Any model of ``config.MODEL_REGISTRY`` serves this way, e.g. ``--model
mistralai/Mistral-7B-v0.1`` (sliding-window attention; with int8 weights
about 7.3 GB on the card), ``meta-llama/Llama-3.2-1B``, ``google/gemma-2b``,
``microsoft/phi-2`` or ``facebook/opt-1.3b``; ``--chat-template`` takes a
family's Jinja template (the ``template.jinja`` of
``templates/<family>-chat-template.yaml``).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import queue
import signal
import tempfile
import threading
import time
import urllib.parse
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from aws_k8s_ansible_provisioner_tpu_torch.serving import (autoscaler,
                                                           capacity, chaos,
                                                           devmon, flightrec,
                                                           metrics, slo,
                                                           tracing)

log = logging.getLogger(__name__)


def _bubble_pct(eng) -> Optional[float]:
    """The host bubble's share of the decode timeline: bubble / (bubble +
    device busy time)."""
    bubble = eng.metrics.decode_bubble_seconds.total()
    busy = eng.metrics.device_busy_seconds.total()
    if bubble + busy <= 0:
        return None
    return round(100.0 * bubble / (bubble + busy), 2)


def _device_health() -> dict:
    """The /healthz device block: the HBM ledger's drift verdict and
    totals, the duty cycle and the decode program's roofline shares (the
    whole table is /debug/roofline)."""
    snap = devmon.get().snapshot()
    hbm = snap["hbm"]
    dec = snap["programs"].get("decode") or {}
    return {
        "hbm_drift": hbm["verdict"],
        "hbm_live_bytes": int(hbm["live_bytes"]),
        "hbm_compiled_bytes": int(hbm["compiled_bytes"]),
        "hbm_drift_bytes": int(hbm["drift_bytes"]),
        "duty_cycle": round(snap["duty_cycle"], 4),
        "mfu": round(dec.get("mfu", 0.0), 4),
        "membw_util": round(dec.get("membw_util", 0.0), 4),
        "dma_wait_fraction": round(snap["dma_wait_fraction"], 4),
    }


def _parse_fields(body: dict, engine, ids, header_deadline=None,
                  chat: bool = False):
    """The completions (or, with ``chat``, chat completions) request's
    fields, checked as the JAX server checks them (its
    ``_completions_impl``): a dict of the engine request's arguments plus
    ``n``, ``best_of``, ``stop`` (a list), ``echo``, ``logprobs`` (the
    client's, or None), ``seed``, ``include_usage``, ``resume_chars`` and
    ``is_resume``; or the message of a 400. On completions ``logprobs`` is
    an integer and ``top_logprobs`` is ignored, as the JAX server ignores
    it there; chat takes ``logprobs: true`` with ``top_logprobs``, defaults
    ``temperature`` to 1.0, refuses ``echo`` and takes ``best_of = n``.
    ``echo`` with ``logprobs`` asks for the prompt's logprobs too when the
    prompt fits a prefill bucket and the answer is not streamed. A
    continuation (``resume_token_ids`` with ``resume_text_chars``) needs
    ``stream``, one choice, no ``echo`` and no ``prompt_logprobs``; its
    ``max_tokens`` (0 allowed) is the budget left, to which the relayed
    length is added back when the body sets it."""
    from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import (
        BIAS_K, LOGPROB_K)

    try:
        f = dict(
            max_tokens=int(body.get("max_tokens",
                                    engine.serving.max_tokens_default)),
            temperature=float(body.get("temperature", 1.0 if chat else 0.0)),
            top_p=float(body.get("top_p", 1.0)),
            top_k=int(body.get("top_k", 0) or 0),
            presence_penalty=float(body.get("presence_penalty", 0.0)),
            frequency_penalty=float(body.get("frequency_penalty", 0.0)),
            repetition_penalty=float(body.get("repetition_penalty", 1.0)))
    except (TypeError, ValueError):
        return "sampling parameters must be numeric"
    if not (-2.0 <= f["presence_penalty"] <= 2.0
            and -2.0 <= f["frequency_penalty"] <= 2.0):
        return "penalties must be in [-2, 2]"
    if not 0.0 < f["repetition_penalty"] <= 10.0:
        return "'repetition_penalty' must be in (0, 10]"
    # a continuation's max_tokens is the budget left, so 0 is legal there
    min_mt = 0 if body.get("resume_token_ids") is not None else 1
    if not min_mt <= f["max_tokens"] <= engine.max_len:
        return f"max_tokens must be in [{min_mt}, {engine.max_len}]"
    stops = body.get("stop") or []
    f["stop"] = [stops] if isinstance(stops, str) else stops
    raw_stop_ids = body.get("stop_token_ids") or []
    if not isinstance(raw_stop_ids, list):
        return "'stop_token_ids' must be a list of integers"
    try:
        f["stop_token_ids"] = tuple(int(t) for t in raw_stop_ids)
        f["min_tokens"] = int(body.get("min_tokens", 0))
    except (TypeError, ValueError):
        return ("'stop_token_ids' must be integers and 'min_tokens' an "
                "integer")
    if f["min_tokens"] < 0:
        return "'min_tokens' must be >= 0"
    # the end-to-end deadline, relative milliseconds (the body wins); the
    # engine caps it at request_timeout_s and reaps it (408)
    raw_deadline = body.get(DEADLINE_FIELD, header_deadline)
    f["deadline_s"] = None
    if raw_deadline is not None:
        try:
            f["deadline_s"] = float(raw_deadline) / 1000.0
        except (TypeError, ValueError):
            return f"'{DEADLINE_FIELD}' must be a number of milliseconds"
        if f["deadline_s"] <= 0:
            return f"'{DEADLINE_FIELD}' must be > 0"
    f["ignore_eos"] = bool(body.get("ignore_eos", False))
    f["stream"] = stream = bool(body.get("stream", False))
    try:
        f["n"] = int(body.get("n", 1))
    except (TypeError, ValueError):
        return "'n' must be an integer"
    if not 1 <= f["n"] <= 8:
        return "'n' must be in [1, 8]"
    f["seed"] = body.get("seed")
    if f["seed"] is not None:
        try:
            f["seed"] = int(f["seed"])
        except (TypeError, ValueError):
            return "'seed' must be an integer"
    f["echo"] = echo = bool(body.get("echo", False))
    if echo and chat:
        return "'echo' is not supported on chat completions"
    try:
        f["best_of"] = int(body.get("best_of", f["n"]))
    except (TypeError, ValueError):
        return "'best_of' must be an integer"
    if chat:
        f["best_of"] = f["n"]
    if not f["n"] <= f["best_of"] <= 8:
        return f"'best_of' must be in [n, 8], got {f['best_of']}"
    if stream and f["best_of"] > f["n"]:
        return ("best_of > n with stream=true is not supported (ranking "
                "needs complete candidates)")
    raw_plp = body.get("prompt_logprobs")
    try:
        plp = None if raw_plp is None else int(raw_plp)
    except (TypeError, ValueError):
        return "'prompt_logprobs' must be an integer"
    try:
        if chat:
            lp_n = int(body.get("top_logprobs", 0)) \
                if bool(body.get("logprobs", False)) else None
        else:
            raw_lp = body.get("logprobs")
            if raw_lp is False:
                raw_lp = None          # an explicit false means off
            elif isinstance(raw_lp, bool):
                return "completions 'logprobs' is an integer, not a boolean"
            lp_n = None if raw_lp is None else int(raw_lp)
    except (TypeError, ValueError):
        return "'logprobs' must be numeric"
    if lp_n is not None and not 0 <= lp_n <= LOGPROB_K:
        return f"logprobs must be in [0, {LOGPROB_K}]"
    if plp is not None:
        if not 0 <= plp <= LOGPROB_K:
            return f"prompt_logprobs must be in [0, {LOGPROB_K}]"
        if stream:
            return "prompt_logprobs with stream=true is not supported"
    f["logprobs"] = lp_n
    raw_bias = body.get("logit_bias") or {}
    if not isinstance(raw_bias, dict):
        return ("'logit_bias' must be an object mapping token ids to bias "
                "values")
    try:
        bias = tuple(sorted((int(k), float(v)) for k, v in raw_bias.items()))
    except (TypeError, ValueError):
        return "'logit_bias' keys must be token ids and values numbers"
    if len(bias) > BIAS_K:
        return f"'logit_bias' supports at most {BIAS_K} entries"
    if any(t < 0 for t, _ in bias):
        return "'logit_bias' token ids must be >= 0"
    if any(not -100.0 <= v <= 100.0 for _, v in bias):
        return "'logit_bias' values must be in [-100, 100]"
    f["logit_bias"] = bias
    # OpenAI stream_options: include_usage adds a usage: null to every
    # chunk and a usage-only chunk before [DONE]
    so = body.get("stream_options") or {}
    if not isinstance(so, dict):
        return "'stream_options' must be an object"
    if so and not stream:
        return "'stream_options' requires stream=true"
    f["include_usage"] = bool(so.get("include_usage", False))
    raw_resume = body.get("resume_token_ids")
    f["resume_ids"], f["resume_chars"] = (), 0
    f["is_resume"] = raw_resume is not None
    if raw_resume is not None:
        if not isinstance(raw_resume, list):
            return "'resume_token_ids' must be a list of token ids"
        try:
            f["resume_ids"] = tuple(int(t) for t in raw_resume)
            f["resume_chars"] = int(body.get("resume_text_chars", 0))
        except (TypeError, ValueError):
            return ("'resume_token_ids' must be integers and "
                    "'resume_text_chars' an integer")
        if f["resume_chars"] < 0:
            return "'resume_text_chars' must be >= 0"
        if not stream:
            return "'resume_token_ids' requires stream=true"
        if f["n"] != 1 or f["best_of"] != 1:
            return "continuation supports a single choice (n=1, best_of=1)"
        if echo:
            return ("continuation cannot combine with 'echo' (the prompt "
                    "was already streamed)")
        if plp is not None:
            return "continuation cannot carry prompt_logprobs"
        if "max_tokens" in body:
            f["max_tokens"] += len(f["resume_ids"])
    if echo and lp_n is not None and plp is None and not stream \
            and len(ids) <= max(engine.buckets or (0,)):
        # the OpenAI echo with logprobs covers the prompt: its logprobs,
        # where the request can have them (a prompt that fits a bucket, not
        # streamed)
        plp = lp_n
    f["prompt_logprobs"] = plp
    return f


def _apply_stop_strings(text: str, stops) -> Optional[str]:
    """``text`` cut at the earliest of the stop strings, or None when none
    occurs (the JAX server's)."""
    cut = None
    for s in stops:
        if s:
            i = text.find(s)
            if i >= 0 and (cut is None or i < cut):
                cut = i
    return text[:cut] if cut is not None else None


def _format_logprobs(tokenizer, ids, lp_data, k: int, text_len: int = -1,
                     base_offset: int = 0, chat: bool = False) -> dict:
    """The ``logprobs`` payload (the JAX server's), each token decoded
    alone. Completions: tokens, token_logprobs, top_logprobs (decoded token
    -> logprob, k of them) and text_offset; chat: ``content``, one {token,
    logprob, top_logprobs: [{token, logprob}]} per token. ``text_len``
    (>= 0 after a stop-string cut) keeps the tokens whose text survived it;
    ``base_offset`` shifts the offsets past an echoed prompt."""
    toks = [tokenizer.decode([t]) for t in ids]
    offsets, pos = [], base_offset
    for t in toks:
        offsets.append(pos)
        pos += len(t)
    n = len(toks)
    if text_len >= 0:
        n = sum(1 for o in offsets if o - base_offset < text_len) \
            if text_len else 0
    toks, offsets, lp_data = toks[:n], offsets[:n], lp_data[:n]
    if chat:
        return {"content": [
            {"token": t, "logprob": None if d is None else d[0],
             "top_logprobs": [] if d is None else [
                 {"token": tokenizer.decode([tid]), "logprob": v}
                 for tid, v in d[1][:k]]}
            for t, d in zip(toks, lp_data)]}
    return {"tokens": toks,
            "token_logprobs": [None if d is None else d[0] for d in lp_data],
            "top_logprobs": [dict((tokenizer.decode([tid]), v)
                                  for tid, v in d[1][:k]) if d is not None
                             else {} for d in lp_data],
            "text_offset": offsets}


def _echo_logprobs(tokenizer, req, lp_obj: dict) -> dict:
    """The echo's logprobs payload: the prompt's tokens first (position 0
    with null), then the generated ones of ``lp_obj``."""
    ptoks = [tokenizer.decode([i]) for i in req.prompt_ids]
    poffs, p0 = [], 0
    for t in ptoks:
        poffs.append(p0)
        p0 += len(t)
    tail = req.prompt_logprob_data[1:]
    k = req.logprobs or 0
    return {"tokens": ptoks + lp_obj["tokens"],
            "token_logprobs": [None] + [d[0] for d in tail]
            + lp_obj["token_logprobs"],
            "top_logprobs": [None] + [
                {tokenizer.decode([tid]): v for tid, v in d[1][:k]}
                for d in tail] + lp_obj["top_logprobs"],
            "text_offset": poffs + lp_obj["text_offset"]}


def _prompt_logprobs_field(tokenizer, req) -> list:
    """vLLM's ``prompt_logprobs`` field: null for position 0, then per
    position the decoded token -> logprob of the prompt's own token and
    its best ``prompt_logprobs``."""
    out = [None]
    for t, d in enumerate(req.prompt_logprob_data[1:], start=1):
        entry = {tokenizer.decode([req.prompt_ids[t]]): d[0]}
        for tid, v in d[1][:req.prompt_logprobs or 0]:
            entry.setdefault(tokenizer.decode([tid]), v)
        out.append(entry)
    return out


# Wire names of the end-to-end deadline (relative milliseconds), the JAX
# server's: a router forwards the header, a client may set either
DEADLINE_HEADER = "X-Request-Deadline-Ms"
DEADLINE_FIELD = "deadline_ms"


class _NotifyQueue(queue.Queue):
    """A request's ``out_queue`` that sets a shared event on every put: the
    handler of a streamed ``n`` > 1 request waits on that one event instead
    of polling the n choices' queues."""

    def __init__(self, event: threading.Event):
        super().__init__()
        self.event = event

    def put(self, item, *a, **kw):
        super().put(item, *a, **kw)
        self.event.set()


class ServerState:
    """What the request handlers share: engine, tokenizer, chat templater
    (by default the model family's style, or the tokenizer's template),
    served name, the stop event of the engine thread (and of
    :func:`serve`), the count of ``/v1`` requests inside a handler (a
    stream counts until its ``[DONE]``), and the drain watcher."""

    def __init__(self, engine, tokenizer, model_name: str, templater=None):
        from aws_k8s_ansible_provisioner_tpu_torch.serving.chat_template \
            import ChatTemplater

        self.engine = engine
        self.tokenizer = tokenizer
        self.templater = templater or ChatTemplater(engine.cfg.name,
                                                    tokenizer)
        self.model_name = model_name
        self.started = int(time.time())
        self.stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._drain_lock = threading.Lock()
        self._drain_watcher: Optional[threading.Thread] = None
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        # the request spans' tracer (build_state's; None: no spans) and the
        # lock that lets one /debug/profile capture run at a time
        self.tracer: Optional[tracing.Tracer] = None
        self.profile_lock = threading.Lock()

    def start_engine(self):
        self._thread = threading.Thread(target=self.engine.run_forever,
                                        args=(self.stop,), daemon=True,
                                        name="engine-step")
        self._thread.start()

    def stop_engine(self, timeout: float = 10.0):
        self.stop.set()
        if self._thread is not None:
            self._thread.join(timeout)

    def inflight_inc(self):
        with self._inflight_lock:
            self._inflight += 1

    def inflight_dec(self):
        with self._inflight_lock:
            self._inflight -= 1

    @property
    def inflight(self) -> int:
        """``/v1`` requests inside a handler thread (parsing, waiting on
        the engine or writing the answer)."""
        with self._inflight_lock:
            return self._inflight

    def begin_drain(self, timeout_s: Optional[float] = None,
                    exit_when_idle: bool = True) -> float:
        """Drain the engine (:meth:`Engine.begin_drain`) and, unless
        ``exit_when_idle`` is false (a replica taken out of rotation but
        kept; ``end_drain`` reverses it), start the watcher that sets the
        stop event once the drain is done. Returns the seconds left until
        the drain deadline."""
        t = self.engine.begin_drain(timeout_s)
        if not exit_when_idle:
            return t
        with self._drain_lock:
            if self._drain_watcher is None:
                self._drain_watcher = threading.Thread(
                    target=self._drain_watch, daemon=True,
                    name="drain-watcher")
                self._drain_watcher.start()
        return t

    def end_drain(self):
        self.engine.end_drain()

    def _drain_watch(self):
        """Set the stop event once the engine is idle (no active slot, no
        queue, no chunk walk) and no ``/v1`` handler is still answering,
        or 5 s past the drain deadline (the reap has then answered the
        stragglers); return without stopping when the drain is cancelled."""
        eng = self.engine
        while True:
            if not eng.draining:
                with self._drain_lock:
                    self._drain_watcher = None
                return
            idle = (not eng._active_slots() and not eng.pending
                    and eng._chunk is None and self.inflight == 0)
            if idle or time.monotonic() > eng._drain_deadline + 5.0:
                break
            time.sleep(0.05)
        log.info("drain complete (inflight=%d active=%d queued=%d); "
                 "stopping server", self.inflight,
                 len(eng._active_slots()), eng.pending)
        self.stop.set()


def _wait_budget_s(engine, req) -> Optional[float]:
    """The handler's cap on its wait for the engine: the request's deadline
    plus 30 s of grace (the engine reaps the deadline itself; this only
    keeps a handler from hanging on a wedged engine loop), else
    ``request_timeout_s`` plus the grace, else none."""
    if req.t_deadline:
        return max(1.0, req.t_deadline - time.monotonic()) + 30.0
    cap = float(engine.serving.request_timeout_s or 0)
    return cap + 30.0 if cap > 0 else None


def build_state(serving=None, model_cfg=None, params=None, tokenizer=None,
                device=None, seed: int = 0) -> ServerState:
    """Wire tokenizer, params, engine and chat templater (``--chat-template``'s
    file, else the tokenizer's template, else the model family's style)
    into a ServerState, as the JAX ``build_state`` does. With
    ``serving.checkpoint_dir``: the directory's config, its tokenizer (the
    byte tokenizer when it has none that loads, logged) and its weights
    through the converted-params cache, onto the engine's device. Without:
    random weights from ``seed`` and the byte tokenizer. With
    ``spec_method="draft"`` the draft model comes from
    ``serving.draft_checkpoint_dir`` (required). ``serving.lora_adapters``
    (``"name=path"`` each) registers the adapters, in order; a malformed
    spec, a duplicate name or one that shadows ``serving.model`` raises
    ValueError. The engine stops on the
    tokenizer's eos beside the model's. A ``serving.mesh`` of more than one
    device takes that many CUDA cards (``parallel/mesh.make_mesh``), or on
    the CPU repeats the CPU; with dp, tp or ep > 1 a checkpoint loads
    sharded (``parallel/sharding.make_sharded_put``: each converted leaf
    sliced onto its mesh positions as it is produced, staged on the
    host)."""
    import torch

    from aws_k8s_ansible_provisioner_tpu_torch.config import (
        MODEL_REGISTRY, ServingConfig, tiny_qwen3, tiny_qwen3_moe)
    from aws_k8s_ansible_provisioner_tpu_torch.device import resolve_device
    from aws_k8s_ansible_provisioner_tpu_torch.models.checkpoint import \
        load_checkpoint_cached
    from aws_k8s_ansible_provisioner_tpu_torch.models.hf_loader import \
        config_from_hf_dir
    from aws_k8s_ansible_provisioner_tpu_torch.models.layers import init_params
    from aws_k8s_ansible_provisioner_tpu_torch.parallel.mesh import make_mesh
    from aws_k8s_ansible_provisioner_tpu_torch.parallel.sharding import \
        make_sharded_put
    from aws_k8s_ansible_provisioner_tpu_torch.serving.chat_template import \
        ChatTemplater
    from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import Engine
    from aws_k8s_ansible_provisioner_tpu_torch.utils.tokenizer import (
        load_tokenizer)

    serving = serving or ServingConfig()
    dev = resolve_device(device)
    ckpt = serving.checkpoint_dir or None
    tokenizer = tokenizer or load_tokenizer(ckpt)
    if model_cfg is None:
        if ckpt:
            model_cfg = config_from_hf_dir(ckpt)
        elif serving.model in MODEL_REGISTRY:
            model_cfg = MODEL_REGISTRY[serving.model]
        elif serving.model == "tiny-qwen3":
            # offline dry-run model sized to the byte tokenizer
            model_cfg = tiny_qwen3(vocab_size=tokenizer.vocab_size,
                                   eos_token_id=tokenizer.eos_token_id,
                                   num_layers=4, hidden_size=128,
                                   intermediate_size=256)
        elif serving.model == "tiny-qwen3-moe":
            # the MoE dry-run model (router + experts), byte tokenizer
            model_cfg = tiny_qwen3_moe(vocab_size=tokenizer.vocab_size,
                                       eos_token_id=tokenizer.eos_token_id,
                                       num_layers=4, hidden_size=128)
        else:
            raise ValueError(f"unknown model {serving.model!r} and no "
                             f"checkpoint")
    dtype = torch.bfloat16 if serving.dtype == "bfloat16" else torch.float32
    mesh = None
    if serving.mesh.num_devices > 1:
        # a dry run on the CPU: every shard of the mesh on the CPU
        mesh = make_mesh(serving.mesh, [dev] * serving.mesh.num_devices
                         if dev.type == "cpu" else None)
    m = serving.mesh
    place = make_sharded_put(mesh, model_cfg) \
        if max(m.dp, m.tp, m.ep) > 1 else None
    if params is None:
        # an int8 engine's weights are quantized layer by layer as they
        # are converted or drawn: the unquantized tree is never held
        # (Qwen3-30B-A3B's bf16 tree, 61 GB, would not leave room)
        quantize = serving.weights_dtype == "int8"
        if ckpt:
            # the first start converts the shards and caches the tree
            # beside them; a restart restores it
            params = load_checkpoint_cached(ckpt, model_cfg, dtype,
                                            device=dev, quantize=quantize,
                                            place=place)
        else:
            log.warning("no checkpoint: serving RANDOM weights (%s, seed %d)",
                        model_cfg.name, seed)
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
            params = init_params(model_cfg, gen, dtype, quantize=quantize)
    draft = None
    if serving.spec_decode and serving.spec_method == "draft":
        if not serving.draft_checkpoint_dir:
            raise ValueError("spec_method='draft' requires "
                             "--draft-checkpoint-dir")
        draft_cfg = config_from_hf_dir(serving.draft_checkpoint_dir)
        draft = (draft_cfg, load_checkpoint_cached(
            serving.draft_checkpoint_dir, draft_cfg, dtype, device=dev))
        log.info("draft model: %s (%s)", draft_cfg.name,
                 serving.draft_checkpoint_dir)
    lora = None
    if serving.lora_adapters:
        lora = {}
        for spec in serving.lora_adapters:
            name, sep, path = spec.partition("=")
            if not sep or not name or not path:
                raise ValueError(f"--lora expects name=path, got {spec!r}")
            if name in lora:
                raise ValueError(f"duplicate LoRA adapter name {name!r}")
            if name == serving.model:
                raise ValueError(f"LoRA adapter name {name!r} would shadow "
                                 f"the served base model id")
            lora[name] = path
    engine = Engine(model_cfg, params, serving,
                    eos_token_id=tokenizer.eos_token_id, device=dev,
                    draft=draft, mesh=mesh, lora=lora)
    templater = ChatTemplater(model_cfg.name, tokenizer,
                              template_path=serving.chat_template or None)
    state = ServerState(engine, tokenizer, serving.model, templater)
    configure_observability(state, serving)
    return state


def configure_observability(state: ServerState, serving) -> None:
    """The JAX ``build_state``'s configuration of the observability
    modules from ``serving``: the request spans' tracer (the config's OTLP
    endpoint, else ``$OTEL_EXPORTER_OTLP_ENDPOINT``; with neither, spans
    are made but not exported), the flight recorder's spool, the SLO
    objectives, the device monitor's peaks and the capacity estimator's
    windows. The monitor and the estimator keep the wiring the engine
    installed when it was built."""
    state.tracer = tracing.build_tracer(
        "tpu-serve-engine", endpoint=serving.otlp_endpoint or None,
        sample=serving.trace_sample)
    flightrec.configure(spool_dir=serving.flight_spool_dir or "")
    slo.configure(ttft_p95_ms=serving.slo_ttft_p95_ms,
                  error_rate=serving.slo_error_rate)
    devmon.configure(enabled=serving.devmon_enabled,
                     peak_tflops=serving.devmon_peak_tflops,
                     hbm_gbps=serving.devmon_peak_hbm_gbps,
                     hbm_tolerance_mb=serving.devmon_hbm_tolerance_mb)
    capacity.configure(enabled=serving.capacity_enabled,
                       headroom_s=serving.capacity_headroom_s,
                       window_s=serving.capacity_window_s,
                       trend_window_s=serving.capacity_trend_window_s)


class Handler(BaseHTTPRequestHandler):
    state: ServerState = None          # set by make_server
    protocol_version = "HTTP/1.1"
    # the request span's context (a class default, so that a keep-alive
    # connection never hands one request's ids to the next)
    _trace_ctx: Optional[tracing.SpanContext] = None
    _trace_reqs = None

    def log_message(self, fmt, *args):
        log.debug("%s " + fmt, self.address_string(), *args)

    def _json(self, code: int, obj: dict, headers: Optional[dict] = None):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(body)

    def _error(self, code: int, message: str,
               etype: str = "invalid_request_error",
               err_code: Optional[str] = None,
               headers: Optional[dict] = None):
        err = {"message": message, "type": etype, "code": err_code or code}
        if self._trace_ctx is not None:
            # the ids to look the failed request up by
            err["trace_id"] = self._trace_ctx.trace_id
            err["span_id"] = self._trace_ctx.span_id
        if code >= 500:
            # a ring-only breadcrumb beside the engine's events
            flightrec.record("http_error", None, code=code, type=etype)
        self._json(code, {"error": err}, headers=headers)

    def _overloaded(self, e):
        """A shed request (:class:`EngineOverloaded`): 503 ``draining``
        with ``Retry-After`` and ``X-TPU-Draining`` (the replica is
        leaving; a router re-routes without marking it dead), else 429
        ``engine_overloaded:<reason>`` with ``Retry-After``."""
        retry = str(int(e.retry_after_s + 0.5))
        if e.reason == "draining":
            return self._error(503, str(e), "unavailable_error",
                               err_code="draining",
                               headers={"Retry-After": retry,
                                        "X-TPU-Draining": "1"})
        self._error(429, str(e), "overloaded_error",
                    err_code=f"engine_overloaded:{e.reason}",
                    headers={"Retry-After": retry})

    def do_GET(self):
        path = self.path.split("?")[0]
        st = self.state
        eng = st.engine
        if path == "/v1/models":
            base = {"id": st.model_name, "object": "model",
                    "created": st.started, "owned_by": "torch-serve",
                    "max_model_len": eng.max_len}
            # the adapters are served as model ids (vLLM --enable-lora)
            adapters = [{**base, "id": name, "parent": st.model_name}
                        for name in eng.lora_names]
            self._json(200, {"object": "list", "data": [base] + adapters})
        elif path in ("/health", "/healthz", "/ping"):
            self._health()
        elif path == "/readyz":
            # ready, not live: a draining replica finishes its requests
            # (liveness must not kill it) but takes no new ones
            if eng.draining:
                self._json(503, {"status": "draining"},
                           headers={"X-TPU-Draining": "1"})
            elif eng.stalled_for_s:
                self._json(503, {"status": "stalled"})
            else:
                self._json(200, {"status": "ready"})
        elif path == "/load":
            self._json(200, {"active": len(eng._active_slots()),
                             "queued": eng.pending,
                             "slots": eng.num_slots,
                             "draining": bool(eng.draining)})
        elif path == "/metrics":
            self._metrics()
        elif path == "/admin/drain":
            # a lifecycle httpGet hook can only GET: the POST's defaults
            self._admin_drain({})
        elif path == "/debug/profile":
            self._profile()
        elif path == "/debug/roofline":
            # the device monitor's per-program table and HBM ledger
            self._json(200, devmon.get().snapshot())
        elif path == "/debug/capacity":
            self._json(200, capacity.get().snapshot())
        elif path == "/debug/events":
            # the flight recorder's ring, oldest first (?last=N, <= 4096)
            vals = self._query().get("last")
            n = min(int(vals[0]), 4096) if vals and vals[0].isdigit() \
                else 100
            self._json(200, {"events": flightrec.get().tail(n)})
        elif path.startswith("/debug/flight/"):
            # one request's anomaly dump, or its live timeline
            rid = path[len("/debug/flight/"):]
            dump = flightrec.get().dump_for(rid)
            if dump is None and rid.isdigit():
                dump = flightrec.get().dump_for(int(rid))
            if dump is None:
                return self._error(404, f"no flight timeline for {rid!r} "
                                        "(snapshots keep the last anomalies "
                                        "only; see /debug/events)")
            self._json(200, dump)
        else:
            self._error(404, f"no route {path}")

    def _query(self) -> dict:
        q = self.path.split("?", 1)
        return urllib.parse.parse_qs(q[1]) if len(q) == 2 else {}

    def _profile(self):
        """``/debug/profile?ms=N``: a ``torch.profiler`` capture of the
        device and the host while the engine serves (N ms, default 1000,
        at most 30000), written server-side as a Chrome trace (the JAX
        server writes a JAX trace); answers with its path. The profiler
        starts and stops between two engine steps (``Engine.step_lock``):
        turning the device tracer on or off while the engine thread
        launches its work could wedge the process."""
        from torch.profiler import ProfilerActivity, profile

        vals = self._query().get("ms")
        ms = min(int(vals[0]), 30000) if vals and vals[0].isdigit() else 1000
        out_dir = os.path.join(tempfile.gettempdir(), "torch-serve-profile")
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{time.strftime('%Y%m%d-%H%M%S')}-"
                                     f"{uuid.uuid4().hex[:8]}.json")
        eng = self.state.engine
        acts = [ProfilerActivity.CPU]
        if eng.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with self.state.profile_lock:
            prof = profile(activities=acts)
            with eng.step_lock:
                prof.start()
            try:
                time.sleep(ms / 1000.0)
            finally:
                with eng.step_lock:
                    prof.stop()
            prof.export_chrome_trace(path)
        self._json(200, {"trace_path": path, "window_ms": ms,
                         "view": "chrome://tracing or perfetto"})

    def _health(self):
        """The JAX server's health answer: 503 only when stalled. The
        ``slo``, ``flight``, ``device`` (``hbm_drift`` its verdict) and
        ``capacity`` blocks come from the observability modules."""
        st = self.state
        eng = st.engine
        m = eng.metrics
        stalled = eng.stalled_for_s
        status = "ok"
        if eng.last_error:
            status = "degraded"
        if eng.draining:
            status = "draining"
        if stalled:
            status = "stalled"
        dev = _device_health()
        self._json(503 if stalled else 200, {
            "status": status,
            "draining": bool(eng.draining),
            "model": st.model_name,
            "uptime_s": int(time.time()) - st.started,
            "active_requests": len(eng._active_slots()),
            "queue_depth": eng.pending,
            "inflight": st.inflight,
            "stalled_for_s": round(stalled, 1) or None,
            "last_error": eng.last_error or None,
            "decode_bblock": eng.decode_bblock,
            "decode_pipeline": eng.serving.decode_pipeline,
            "decode_bubble_pct": _bubble_pct(eng),
            "ragged_attention": eng.serving.ragged_attention,
            "ragged_features": eng.serving.ragged_features,
            "pipeline": metrics.pipeline.snapshot(),
            "weights_dtype": eng.serving.weights_dtype,
            "kv_dtype": eng.serving.kv_dtype,
            "paged": bool(eng.paged),
            "aot": eng.aot,
            "shed_total": int(m.requests_shed.total()),
            "deadline_expired_total": int(m.deadline_expired.total()),
            "watchdog_stalls_total": int(m.watchdog_stalls.total()),
            "preemptions_total": int(m.preemptions.total()),
            "max_queue_depth": eng.serving.max_queue_depth or None,
            "request_timeout_s": eng.serving.request_timeout_s or None,
            "tokens_per_second": round(m.tokens_per_second.value(), 2),
            "kv_pages_total": int(m.kv_pages_total.value()),
            "kv_pages_in_use": int(m.kv_pages_in_use.value()),
            "kv_pages_free": int(m.kv_pages_free.value()),
            "kv_pages_evictable": int(m.kv_pages_evictable.value()),
            "prefix_tier_hits": {
                t: int(m.prefix_tier_hits.value(tier=t))
                for t in ("hbm", "host", "miss")},
            "kv_host_tier": (eng.host_tier.stats()
                             if eng.host_tier is not None else None),
            "slo": slo.get().snapshot(),
            "slo_burning": slo.get().burning(),
            "flight": flightrec.get().summary(),
            "device": dev,
            "hbm_drift": dev["hbm_drift"],
            "capacity": capacity.get().snapshot(),
        })

    def _metrics(self):
        """The engine's registry, then tracing's, the flight recorder's,
        the SLO engine's, the device monitor's, the capacity estimator's and
        the autoscaler's (each gauge family refreshed by its ``export()``
        first; the capacity estimator's and the autoscaler's drop rather
        than fail, and the replica process has no controller, so the
        autoscaler's family renders at its defaults, as on the router),
        then the decode pipeline's: Prometheus text, or OpenMetrics (with
        its ``# EOF``) when ``Accept`` asks for it. The per-card gauges of
        the node exporter's source (``render_engine_chips`` in the JAX
        package) come with the training slice."""
        slo.get().export()
        devmon.get().export()
        capacity.get().export()
        autoscaler.get().export()
        om = "application/openmetrics-text" in (self.headers.get("Accept")
                                                or "")
        text = (self.state.engine.metrics.registry.render(om)
                + tracing.metrics.registry.render(om)
                + flightrec.metrics.registry.render(om)
                + slo.metrics.registry.render(om)
                + devmon.metrics.registry.render(om)
                + capacity.metrics.registry.render(om)
                + autoscaler.metrics.registry.render(om)
                + metrics.pipeline.registry.render(om))
        if om:
            text += "# EOF\n"
            ctype = ("application/openmetrics-text; version=1.0.0; "
                     "charset=utf-8")
        else:
            ctype = "text/plain; version=0.0.4"
        body = text.encode()
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):
        self._trace_ctx = None      # keep-alive: not the last request's
        path = self.path.split("?")[0]
        try:
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
        except (ValueError, json.JSONDecodeError):
            return self._error(400, "request body is not valid JSON")
        if not isinstance(body, dict):
            return self._error(400, "request body must be a JSON object")
        if path == "/admin/drain":
            return self._admin_drain(body)
        if path == "/admin/undrain":
            self.state.end_drain()
            return self._json(200, {"status": "ok", "draining": False})
        if path not in ("/v1/completions", "/v1/chat/completions"):
            return self._error(404, f"no route {path}")
        # the drain watcher waits for every answer still being written, a
        # stream until its [DONE]
        self.state.inflight_inc()
        try:
            self._completions(body, chat=path == "/v1/chat/completions")
        except (BrokenPipeError, ConnectionResetError):
            # the client went away; a stream has cancelled its requests
            self.close_connection = True
        finally:
            self.state.inflight_dec()

    def _admin_drain(self, body: dict):
        """Begin a drain (the preStop hook's target; SIGTERM takes the same
        path): stop admitting, let the requests in flight finish within
        ``timeout_s`` (default ``drain_timeout_s``), then stop the server,
        unless ``exit`` is false (out of rotation only; ``/admin/undrain``
        reverses it)."""
        eng = self.state.engine
        timeout_s = body.get("timeout_s")
        if timeout_s is not None:
            try:
                timeout_s = float(timeout_s)
            except (TypeError, ValueError):
                return self._error(400, "'timeout_s' must be a number")
        exit_when_idle = bool(body.get("exit", True))
        t = self.state.begin_drain(timeout_s, exit_when_idle=exit_when_idle)
        log.info("drain requested (timeout %.1fs, exit=%s): %d active, "
                 "%d queued", t, exit_when_idle, len(eng._active_slots()),
                 eng.pending)
        self._json(200, {"status": "draining", "drain_timeout_s": t,
                         "exit_when_idle": exit_when_idle,
                         "active_requests": len(eng._active_slots()),
                         "queue_depth": eng.pending})

    def _completions(self, body: dict, chat: bool = False):
        """The request's span (the JAX server's): a ``server.request``
        span of kind SERVER continues an incoming ``traceparent`` (or
        starts a trace), and once the answer is written its five phase
        children are made from the engine Request's own timestamps
        (:meth:`_emit_phase_spans`); the engine never holds the tracer."""
        tracer = self.state.tracer
        if tracer is None:
            return self._completions_impl(body, chat)
        t0 = time.monotonic()
        parent = tracing.parse_traceparent(
            self.headers.get(tracing.TRACEPARENT_HEADER))
        span = tracer.start_span(
            "server.request", parent=parent, kind=tracing.KIND_SERVER,
            start_ns=tracing.mono_ns(t0),
            attributes={"http.route": ("/v1/chat/completions" if chat
                                       else "/v1/completions"),
                        "request.stream": bool(body.get("stream", False))})
        raw = body.get(DEADLINE_FIELD, self.headers.get(DEADLINE_HEADER))
        if raw is not None:
            try:
                span.set_attribute("deadline.remaining_ms", int(float(raw)))
            except (TypeError, ValueError):
                pass
        self._trace_ctx = span.context
        self._trace_reqs = None
        try:
            return self._completions_impl(body, chat)
        except Exception as e:
            span.error(f"{type(e).__name__}: {e}")
            raise
        finally:
            self._emit_phase_spans(tracer, span, t0)

    def _emit_phase_spans(self, tracer, span, t0: float):
        """The phase children (``admission``, ``queue_wait``, ``prefill``,
        ``decode``, ``stream_out``) between the handler's start, choice 0's
        ``t_submit``, ``t_prefill_start``, ``t_first_token`` and
        ``t_done``, and the handler's end, clamped to a non-decreasing chain
        (an unset time makes its phase zero-wide), then the request span's
        finish."""
        end = time.monotonic()
        reqs = self._trace_reqs
        if reqs:
            r = reqs[0]
            bounds = [t0, r.t_submit, r.t_prefill_start, r.t_first_token,
                      r.t_done, end]
            for i in range(1, len(bounds)):
                if bounds[i] <= 0.0 or bounds[i] < bounds[i - 1]:
                    bounds[i] = bounds[i - 1]
            for name, lo, hi in zip(("admission", "queue_wait", "prefill",
                                     "decode", "stream_out"),
                                    bounds, bounds[1:]):
                tracer.emit_span(name, span.context, tracing.mono_ns(lo),
                                 tracing.mono_ns(hi),
                                 attributes={"phase.ms":
                                             round((hi - lo) * 1e3, 3)})
            span.set_attribute("request.n_choices", len(reqs))
            if r.finish_reason:
                span.set_attribute("request.finish_reason", r.finish_reason)
        tracer.finish(span, end_ns=tracing.mono_ns(end))

    def _completions_impl(self, body: dict, chat: bool):
        from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import (
            ContextLengthExceeded, EngineOverloaded, Request)

        from aws_k8s_ansible_provisioner_tpu_torch.serving.guided import \
            grammar_for_request

        st = self.state
        model = body.get("model") or st.model_name
        lora_name = model if model in st.engine.lora_names else None
        if model != st.model_name and lora_name is None:
            return self._error(404, f"model {model!r} not found; serving "
                                    f"{st.model_name!r} (adapters: "
                                    f"{st.engine.lora_names})",
                               "model_not_found")
        # the answer names the model id asked for (an adapter's)
        self._model = model
        if chat:
            messages = body.get("messages")
            if not isinstance(messages, list) or not messages:
                return self._error(400, "'messages' must be a non-empty list")
            prompt_text = st.templater.render(messages,
                                              add_generation_prompt=True)
            ids = st.tokenizer.encode(prompt_text) or [st.engine.eos_token_id]
        else:
            prompt = body.get("prompt", "")
            if isinstance(prompt, list) and prompt and all(
                    isinstance(t, int) and not isinstance(t, bool)
                    for t in prompt):
                ids = list(prompt)
                prompt_text = st.tokenizer.decode(ids)
            else:
                if isinstance(prompt, list):
                    # a list of strings: its first, as the JAX server
                    # serves it
                    prompt = prompt[0] if prompt else ""
                if not isinstance(prompt, str):
                    return self._error(400, "prompt must be a string, a list "
                                            "of strings or a list of token "
                                            "ids")
                prompt_text = prompt
                # an empty prompt is served as the EOS token alone
                ids = st.tokenizer.encode(prompt) or [st.engine.eos_token_id]
        fields = _parse_fields(body, st.engine, ids,
                               self.headers.get(DEADLINE_HEADER), chat)
        if isinstance(fields, str):
            return self._error(400, fields)
        rf = body.get("response_format")
        if rf is not None and not isinstance(rf, dict):
            return self._error(400, "'response_format' must be an object")
        try:
            # a cached grammar; the engine gives each choice its own cursor
            guided = grammar_for_request(st.tokenizer, body,
                                         sorted(st.engine._eos_set))
        except ValueError as e:
            return self._error(400, f"guided decoding: {e}")
        n_choices, best_of, stops, echo, lp_n, seed, include_usage, \
            resume_chars, is_resume = (
                fields.pop(k) for k in (
                    "n", "best_of", "stop", "echo", "logprobs", "seed",
                    "include_usage", "resume_chars", "is_resume"))
        stream = fields["stream"]
        resume = fields["resume_ids"]
        rid = ("chatcmpl-" if chat else "cmpl-") + uuid.uuid4().hex[:24]
        if is_resume:
            # relayed tokens that already meet a stop condition: only the
            # finish chunk was lost with the replica that sent them, and
            # nothing more may be generated (the engine's stop rule)
            fin = None
            eos = set() if fields["ignore_eos"] else st.engine._eos_set
            if resume and (resume[-1] in eos
                           or resume[-1] in fields["stop_token_ids"]) \
                    and len(resume) > fields["min_tokens"]:
                fin = "stop"
            if fin is None and len(resume) >= fields["max_tokens"]:
                fin = "length"
            if fin is not None:
                return self._finished_stream(rid, chat, fin, len(ids),
                                             len(resume), include_usage)
        reqs = []
        try:
            # best_of ranks its candidates by their chosen tokens'
            # logprobs: asked of the engine when the client did not
            eng_lp = lp_n if lp_n is not None else \
                (0 if best_of > n_choices else None)
            # a streamed n > 1 request's choices share one wake-up event
            notify = threading.Event() if stream and best_of > 1 else None
            for i in range(best_of):
                # choice i draws with seed + i
                extra = {"out_queue": _NotifyQueue(notify)} if notify else {}
                reqs.append(st.engine.submit(Request(
                    prompt_ids=list(ids), logprobs=eng_lp,
                    seed=None if seed is None else seed + i, guided=guided,
                    lora=lora_name, **fields, **extra)))
        except ContextLengthExceeded as e:
            self._cancel(reqs)
            return self._error(400, str(e))
        except EngineOverloaded as e:
            # a later sibling can shed as the queue fills: the queued ones
            # are cancelled, not stranded
            self._cancel(reqs)
            return self._overloaded(e)
        except (TypeError, ValueError) as e:
            self._cancel(reqs)
            return self._error(400, str(e))
        # the span wrapper makes the phase spans of these requests' times
        self._trace_reqs = reqs
        if self._trace_ctx is not None:
            for r in reqs:
                # the exemplar of the engine's histograms, and the ids an
                # anomaly dump of /debug/flight/<id> hoists
                r.trace_id = self._trace_ctx.trace_id
                flightrec.record("trace", r.id,
                                 trace_id=self._trace_ctx.trace_id,
                                 span_id=self._trace_ctx.span_id,
                                 api_id=rid)
        if stream:
            return self._stream_response(
                reqs, rid, chat, stops, len(ids), include_usage,
                prompt_text if echo else None, lp_n, resume, resume_chars,
                is_resume)
        self._full_response(reqs, rid, chat, ids, stops, n_choices,
                            lp_n is not None, prompt_text if echo else None)

    def _cancel(self, reqs):
        for r in reqs:
            self.state.engine.cancel(r)

    def _full_response(self, reqs, rid: str, chat: bool, ids, stops,
                       n_choices: int, lp_requested: bool,
                       echo_text: Optional[str]):
        """The JAX server's (chat) completions answer over finished
        candidates: with ``best_of`` (more candidates than ``n_choices``)
        the n best by cumulative chosen-token logprob; each choice cut at
        its earliest stop string (finish ``stop``), its logprobs payload
        (only when the client asked) cut with it, the prompt echoed before
        it (with logprobs, the payload covers the prompt too), and a
        ``prompt_logprobs`` field when asked. Chat choices carry
        ``message: {role, content}`` and the chat logprobs shape."""
        st = self.state
        tok = st.tokenizer
        done = []
        for req in reqs:
            try:
                req.wait(timeout=_wait_budget_s(st.engine, req))
            except TimeoutError:
                # the backstop: the engine normally reaps the deadline
                self._cancel(reqs)
                return self._error(408, "request timed out awaiting the "
                                        "engine", "timeout",
                                   err_code="deadline_exceeded")
            if req.finish_reason in ("error", "timeout", "cancelled"):
                self._cancel(r for r in reqs if r is not req)
                if req.finish_reason == "timeout":
                    return self._error(
                        408, "request deadline exceeded before completion "
                             "(slot and pages released)", "timeout",
                        err_code="deadline_exceeded")
                return self._error(500, "engine failure: "
                                   + (st.engine.last_error
                                      or req.finish_reason),
                                   "internal_error")
            done.append(req)
        completion_tokens = sum(len(r.generated) for r in done)
        if len(done) > n_choices:
            done.sort(key=lambda r: sum(d[0] for d in r.logprob_data
                                        if d is not None), reverse=True)
            done = done[:n_choices]
        choices = []
        for idx, req in enumerate(done):
            text = tok.decode(req.generated)
            finish = req.finish_reason
            cut = _apply_stop_strings(text, stops)
            if cut is not None:
                text, finish = cut, "stop"
            lp_obj = None
            if req.logprobs is not None and lp_requested:
                lp_obj = _format_logprobs(
                    tok, req.generated, req.logprob_data, req.logprobs,
                    text_len=len(text) if cut is not None else -1,
                    base_offset=len(echo_text) if echo_text else 0,
                    chat=chat)
            if echo_text is not None and req.prompt_logprob_data \
                    and lp_obj is not None:
                lp_obj = _echo_logprobs(tok, req, lp_obj)
            if echo_text is not None:
                text = echo_text + text
            if chat:
                choice = {"index": idx, "message": {"role": "assistant",
                                                    "content": text},
                          "finish_reason": finish}
                if lp_obj is not None:
                    choice["logprobs"] = lp_obj
            else:
                choice = {"index": idx, "text": text, "logprobs": lp_obj,
                          "finish_reason": finish}
            if req.prompt_logprob_data:
                choice["prompt_logprobs"] = _prompt_logprobs_field(tok, req)
            choices.append(choice)
        n_prompt = len(ids)
        self._json(200, {
            "id": rid, "object": "chat.completion" if chat
            else "text_completion",
            "created": int(time.time()), "model": self._model,
            "choices": choices,
            "usage": self._usage(n_prompt, completion_tokens)})

    def _usage(self, n_prompt: int, n_gen: int) -> dict:
        """The usage object, with the request span's ids when traced."""
        usage = {"prompt_tokens": n_prompt, "completion_tokens": n_gen,
                 "total_tokens": n_prompt + n_gen}
        if self._trace_ctx is not None:
            usage["trace_id"] = self._trace_ctx.trace_id
            usage["span_id"] = self._trace_ctx.span_id
        return usage

    # -- the SSE stream ------------------------------------------------------

    def _sse_start(self):
        """The stream's headers: SSE over chunked transfer encoding."""
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

    def _sse_write(self, data: bytes):
        """One chunk of the chunked body, flushed."""
        self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
        self.wfile.flush()

    def _sse_end(self):
        """``data: [DONE]`` and the terminating chunk."""
        self._sse_write(b"data: [DONE]\n\n")
        self.wfile.write(b"0\r\n\r\n")
        self.wfile.flush()

    def _sse_usage(self, rid: str, obj: str, n_prompt: int, n_gen: int,
                   failover: bool):
        """The usage-only chunk of ``stream_options.include_usage`` (after a
        continuation marked ``failover: true``)."""
        final = {"id": rid, "object": obj, "created": int(time.time()),
                 "model": self._model, "choices": [],
                 "usage": self._usage(n_prompt, n_gen)}
        if failover:
            final["failover"] = True
        self._sse_write(("data: " + json.dumps(final) + "\n\n").encode())

    def _finished_stream(self, rid: str, chat: bool, finish: str,
                         n_prompt: int, n_gen: int, include_usage: bool):
        """A continuation whose relayed tokens already meet a stop
        condition: the finish chunk, the usage chunk and ``[DONE]``, with
        nothing admitted to the engine."""
        obj = "chat.completion.chunk" if chat else "text_completion"
        self._sse_start()
        payload = {"index": 0, "finish_reason": finish}
        if chat:
            payload["delta"] = {}
        else:
            payload["text"] = ""
        body = {"id": rid, "object": obj, "created": int(time.time()),
                "model": self._model, "choices": [payload]}
        if include_usage:
            body["usage"] = None
        self._sse_write(f"data: {json.dumps(body)}\n\n".encode())
        if include_usage:
            self._sse_usage(rid, obj, n_prompt, n_gen, True)
        self._sse_end()

    def _stream_response(self, reqs, rid: str, chat: bool, stops,
                         n_prompt: int, include_usage: bool,
                         echo_text: Optional[str], lp_k: Optional[int],
                         resume_ids: tuple, resume_chars: int,
                         is_resume: bool):
        """The JAX server's SSE stream of ``reqs`` (the n choices), with
        incremental detokenization.

        Text is held back while it may still be the head of an incomplete
        UTF-8 sequence (the detokenizer withholds it) or a prefix of a stop
        string (``hold`` characters), so that no byte a later token would
        change reaches the client. A stop string cuts the text, finishes
        the choice with ``stop`` and cancels its request (its slot frees).
        Every content chunk carries the generated ``token_ids`` it covers,
        which a router accumulates to fail a dying stream over. With
        ``logprobs`` each token is a chunk of its own with its record (the
        vLLM shape). A continuation (``is_resume``) feeds the detokenizer
        the relayed ``resume_ids`` first, skips the ``resume_chars``
        characters the client already has and sends no role or echo chunk.
        A broken pipe or reset cancels every choice's request; any other
        error once the headers are out cancels them too and drops the
        connection."""
        from aws_k8s_ansible_provisioner_tpu_torch.utils.tokenizer import \
            IncrementalDetokenizer

        st = self.state
        tok = st.tokenizer
        self._sse_start()
        obj = "chat.completion.chunk" if chat else "text_completion"
        sent = [0]          # content chunks sent (the kill_stream fault's)

        def chunk(idx: int, delta_text: Optional[str],
                  finish_reason: Optional[str], role: bool = False,
                  lp: Optional[dict] = None, tok_ids=None):
            payload = {"index": idx, "finish_reason": finish_reason}
            if chat:
                d = {}
                if role:
                    d["role"] = "assistant"
                if delta_text:
                    d["content"] = delta_text
                payload["delta"] = d
            else:
                payload["text"] = delta_text or ""
            if lp is not None:
                payload["logprobs"] = lp
            if tok_ids:
                payload["token_ids"] = [int(t) for t in tok_ids]
            body = {"id": rid, "object": obj, "created": int(time.time()),
                    "model": self._model, "choices": [payload]}
            if include_usage:
                body["usage"] = None
            self._sse_write(f"data: {json.dumps(body)}\n\n".encode())
            if delta_text or tok_ids:
                sent[0] += 1
                ch = chaos.get()
                if ch.enabled:
                    # an armed kill_stream resets the connection here and
                    # raises: the replica dies mid-stream to its peer
                    ch.on_stream_chunk(self, sent[0])

        def consume_skip(s, text: str) -> str:
            """Drop the leading characters a failed-over client already
            has (a continuation only)."""
            if s["skip"] and text:
                k = min(s["skip"], len(text))
                s["skip"] -= k
                text = text[k:]
            return text

        # per choice: the n > 1 siblings' tokens arrive interleaved, and
        # each choice detokenizes, holds back and finishes on its own,
        # tagged by its chunk's index
        hold = max((len(s) for s in stops if s), default=1) - 1
        base_off = len(echo_text) if echo_text else 0
        states = [{"req": r, "detok": IncrementalDetokenizer(tok),
                   "pending": "", "finish": None, "n_lp": 0, "skip": 0,
                   "carry": "", "tok_pending": [], "acc": "",
                   "offset": base_off} for r in reqs]
        multi = len(states) > 1
        if is_resume and states:
            # the detokenizer rebuilt over the relayed tokens, so that the
            # first new token's text merges right; what it has flushed goes
            # through the hold (or, with logprobs, rides the first chunk)
            # minus the characters the client already has
            s = states[0]
            prior = "".join(s["detok"].push(int(t)) for t in resume_ids)
            s["acc"] = prior
            s["offset"] = base_off + len(prior)
            if lp_k is not None:
                s["carry"] = prior
            else:
                s["pending"] = prior
            s["skip"] = min(int(resume_chars), len(prior))

        def token_lp(s, token: int, delta: str):
            """The streamed record of one token: completions' one-element
            arrays, chat's one-element content list (the engine puts token
            k on the queue after its record k)."""
            data = s["req"].logprob_data
            d = data[s["n_lp"]] if s["n_lp"] < len(data) else None
            s["n_lp"] += 1
            tok_str = tok.decode([token])
            own = None if d is None else d[0]
            tops = [] if d is None else \
                [(tok.decode([tid]), v) for tid, v in d[1][:lp_k]]
            if chat:
                return {"content": [{
                    "token": tok_str, "logprob": own,
                    "top_logprobs": [{"token": t, "logprob": v}
                                     for t, v in tops]}]}
            off = s["offset"]
            s["offset"] += len(delta)
            return {"tokens": [tok_str], "token_logprobs": [own],
                    "top_logprobs": [dict(tops)], "text_offset": [off]}

        def drain(i: int, block_s: float) -> bool:
            """Take at most one item of choice i's queue and send what is
            ready; whether an item came."""
            s = states[i]
            try:
                item = s["req"].out_queue.get(timeout=block_s)
            except queue.Empty:
                return False
            if lp_k is not None:
                # a chunk per token, its logprob record beside its text (""
                # while a UTF-8 sequence is incomplete); a stop string cuts
                # the text with no hold (the chunks sent stand)
                if item is None:
                    tail = consume_skip(s, s["carry"] + s["detok"].finish())
                    s["finish"] = s["req"].finish_reason or "stop"
                    s["carry"] = ""
                    if tail:
                        chunk(i, tail, None)
                    chunk(i, None, s["finish"])
                    return True
                delta = s["detok"].push(item)
                # a new match can only end in the delta: scan it and the
                # longest stop's tail before it, never the whole text
                window = (s["acc"][-hold:] if hold else "") + delta
                s["acc"] += delta
                cut = _apply_stop_strings(window, stops)
                if cut is not None:
                    overshoot = len(window) - len(cut)
                    delta = delta[:len(delta) - overshoot] \
                        if overshoot <= len(delta) else ""
                    s["finish"] = "stop"
                    st.engine.cancel(s["req"])
                if s["carry"]:
                    delta, s["carry"] = s["carry"] + delta, ""
                delta = consume_skip(s, delta)
                chunk(i, delta, None, lp=token_lp(s, item, delta),
                      tok_ids=[int(item)])
                if s["finish"]:
                    chunk(i, None, s["finish"])
                return True
            if item is None:
                s["pending"] += s["detok"].finish()
                s["finish"] = s["req"].finish_reason or "stop"
            else:
                s["pending"] += s["detok"].push(item)
                s["tok_pending"].append(int(item))
            cut_text = _apply_stop_strings(s["pending"], stops)
            if cut_text is not None:
                s["pending"], s["finish"] = cut_text, "stop"
                st.engine.cancel(s["req"])      # its slot frees
            ready = s["pending"] if s["finish"] else (
                s["pending"][:len(s["pending"]) - hold] if hold
                else s["pending"])
            if ready:
                send = consume_skip(s, ready)
                if send or s["tok_pending"]:
                    chunk(i, send, None, tok_ids=s["tok_pending"])
                    s["tok_pending"] = []
                s["pending"] = s["pending"][len(ready):]
            if s["finish"]:
                chunk(i, None, s["finish"], tok_ids=s["tok_pending"])
                s["tok_pending"] = []
            return True

        # the no-progress backstop (the engine reaps deadlines and sends
        # the sentinels; this guards against a wedged engine loop); 0 means
        # unbounded, capped at threading's longest wait
        stall_s = float(st.engine.serving.request_timeout_s or 0)
        if stall_s <= 0:
            stall_s = threading.TIMEOUT_MAX
        try:
            if not is_resume:
                # a continuation's client got these from the first replica
                for i in range(len(states)):
                    if chat:
                        chunk(i, "", None, role=True)
                    elif echo_text:
                        chunk(i, echo_text, None)
            last_progress = time.monotonic()
            while any(s["finish"] is None for s in states):
                progressed = False
                for i, s in enumerate(states):
                    if s["finish"] is not None:
                        continue
                    if multi:
                        # take every item there is without blocking; the
                        # shared event below is the only wait
                        while s["finish"] is None and drain(i, 0.0):
                            progressed = True
                    else:
                        progressed |= drain(i, stall_s)
                if progressed:
                    last_progress = time.monotonic()
                elif time.monotonic() - last_progress > stall_s:
                    raise TimeoutError(f"no stream progress in "
                                       f"{stall_s:.0f}s")
                elif multi:
                    # wait, clear, drain again: a put racing the clear
                    # leaves its item for the sweep, and a put after it sets
                    # the event again
                    ev = states[0]["req"].out_queue.event
                    ev.wait(timeout=1.0)
                    ev.clear()
            if include_usage:
                # a continuation's generated tokens include the relayed
                # ones, so usage is the undisturbed run's
                self._sse_usage(rid, obj, n_prompt,
                                sum(len(s["req"].generated) for s in states),
                                is_resume)
            self._sse_end()
        except (BrokenPipeError, ConnectionResetError, chaos.InjectedFault):
            self._cancel(s["req"] for s in states)
            raise BrokenPipeError
        except Exception:
            # the headers are out: no JSON error can follow; free the
            # slots and drop the connection
            log.exception("stream failed mid-flight")
            self._cancel(s["req"] for s in states)
            raise BrokenPipeError


def make_server(state: ServerState, host: str, port: int
                ) -> ThreadingHTTPServer:
    handler = type("BoundHandler", (Handler,), {"state": state})
    server = ThreadingHTTPServer((host, port), handler)
    server.daemon_threads = True
    return server


def serve(state: ServerState, host: str, port: int,
          ready_event: Optional[threading.Event] = None,
          stop_event: Optional[threading.Event] = None):
    """Run the engine thread and the HTTP server (on a thread of its own)
    until the stop event is set (``stop_event``, else the state's own): by
    the caller, or by the drain watcher once a drain is done (SIGTERM,
    ``/admin/drain``). Then stop the HTTP server, close its socket (a
    stopped replica refuses connections) and join the engine thread before
    returning, so that the process exits with no step running."""
    if stop_event is not None:
        state.stop = stop_event
    server = make_server(state, host, port)
    state.start_engine()
    http = threading.Thread(target=server.serve_forever, daemon=True,
                            name="http")
    http.start()
    log.info("serving %s on %s:%d (%s, %d slots, cache %d)",
             state.model_name, host, server.server_address[1],
             state.engine.device, state.engine.num_slots,
             state.engine.max_len)
    if ready_event is not None:
        ready_event.set()
    try:
        # wake every 0.2 s: the kernel may deliver SIGTERM to another
        # thread, and Python runs the handler only on the main thread, which
        # an untimed wait would keep blocked until the stop event is set
        while not state.stop.wait(0.2):
            pass
    except KeyboardInterrupt:
        state.stop.set()
    server.shutdown()
    server.server_close()
    state.stop_engine(timeout=60.0)


def build_parser(**kw) -> argparse.ArgumentParser:
    """The server's flags (``serving/aot.py`` adds its own to them)."""
    kw.setdefault("description",
                  "OpenAI-compatible LLM server (PyTorch/CUDA port)")
    p = argparse.ArgumentParser(**kw)
    p.add_argument("--model", default="Qwen/Qwen3-0.6B",
                   help="the served model id; without --checkpoint-dir a "
                        "registered dense model (Qwen/Qwen3-0.6B, "
                        "Qwen/Qwen3-8B, mistralai/Mistral-7B-v0.1, "
                        "meta-llama/Llama-3.2-1B, meta-llama/Llama-3.1-8B, "
                        "TinyLlama/TinyLlama-1.1B-Chat-v1.0, "
                        "google/gemma-2b, microsoft/phi-2, "
                        "facebook/opt-125m, facebook/opt-1.3b) with random "
                        "weights, or tiny-qwen3 (byte-vocab dry run)")
    p.add_argument("--checkpoint-dir", default="",
                   help="local HF checkpoint directory (config.json, "
                        "*.safetensors, tokenizer files) to serve")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda by default; cpu for a dry run)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-decode-slots", type=int, default=32)
    p.add_argument("--max-cache-len", type=int, default=2048)
    p.add_argument("--page-size", type=int, default=64)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--weights-dtype", default="int8",
                   choices=["int8", "bf16", "auto"])
    p.add_argument("--kv-dtype", default="auto", choices=["auto", "int8"],
                   help="KV pool: auto = --dtype; int8 = per-row int8 with "
                        "float32 scales")
    p.add_argument("--prefill-chunk", type=int, default=0,
                   help="chunked prefill size; 0 disables")
    p.add_argument("--no-prefix-cache", action="store_true",
                   help="disable automatic prompt-prefix K/V reuse")
    p.add_argument("--kv-host-tier-bytes", type=int, default=256 * 2**20,
                   help="host-RAM tier of the prefix cache (bytes): pages "
                        "the pool reclaims spill to pinned host memory and "
                        "restore across PCIe on a later hit; 0 (or a "
                        "budget below one page) disables")
    p.add_argument("--decode-bblock", type=int, default=0,
                   help="slots per CTA of the dense cache's decode kernel "
                        "(fitted to a divisor of the slots; 0 = 1); the "
                        "paged engine's kernel takes none")
    p.add_argument("--decode-pipeline", type=int, default=1,
                   help="one-deep decode pipeline: dispatch N+1 is queued "
                        "before N's tokens are fetched (seeded streams "
                        "unchanged); 0 = synchronous dispatch then fetch")
    p.add_argument("--spec-decode", action="store_true",
                   help="prompt-lookup speculative decoding (greedy streams "
                        "unchanged)")
    p.add_argument("--spec-k", type=int, default=4,
                   help="draft tokens verified per speculative step")
    p.add_argument("--spec-method", default="prompt_lookup",
                   choices=["prompt_lookup", "draft"],
                   help="draft source: n-gram prompt lookup, or a small "
                        "draft LM (--draft-checkpoint-dir)")
    p.add_argument("--draft-checkpoint-dir", default="",
                   help="HF checkpoint dir of the draft model "
                        "(spec_method=draft)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel degree (shards heads/MLP over the "
                        "mesh; needs tp devices)")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel degree (shards decode slots)")
    p.add_argument("--ep", type=int, default=1,
                   help="expert-parallel degree (MoE models: shards experts "
                        "over the mesh)")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel degree: the dense KV cache's "
                        "sequence axis split over sp cards, decode merging "
                        "the shards' flash partials (needs sp cards; with "
                        "--device cpu every shard on the CPU)")
    p.add_argument("--lora", action="append", default=[],
                   metavar="NAME=PATH",
                   help="register a peft LoRA adapter dir, served as model "
                        "id NAME (repeatable; vLLM --enable-lora parity)")
    p.add_argument("--request-timeout", type=float, default=600.0,
                   help="default/maximum end-to-end deadline in seconds "
                        "(per-request X-Request-Deadline-Ms / deadline_ms "
                        "is capped by it; 0 disables)")
    p.add_argument("--max-queue-depth", type=int, default=256,
                   help="bounded engine queue: admissions past this depth "
                        "are shed with 429 + Retry-After (0 = unbounded)")
    p.add_argument("--drain-timeout", type=float, default=30.0,
                   help="graceful-drain budget in seconds: on SIGTERM or "
                        "POST /admin/drain, stop admitting (503 draining, "
                        "/readyz 503) and let in-flight requests finish up "
                        "to this long before exiting 0; stragglers are "
                        "cancelled through the deadline path")
    p.add_argument("--admission-max-wait", type=float, default=0.0,
                   help="shed admissions whose estimated queue wait "
                        "(seconds) exceeds this (0 disables)")
    p.add_argument("--chat-template", default="",
                   help="Jinja template file for /v1/chat/completions; empty "
                        "= the tokenizer's template, else the model "
                        "family's default style")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights")
    p.add_argument("--platform", default="",
                   help="the JAX server's platform switch: cpu means "
                        "--device cpu; any other value is refused")
    p.add_argument("--ragged-attention", type=int, default=1,
                   help="the ragged mixed dispatch (chunked prefill packed "
                        "beside the decode batch); the port always runs it: "
                        "0 is refused")
    p.add_argument("--ragged-features", type=int, default=1,
                   help="guided, LoRA and speculative rows riding the "
                        "ragged pipeline; the port always runs them: 0 is "
                        "refused")
    p.add_argument("--otlp-endpoint", default="",
                   help="OTLP/HTTP trace collector base URL (spans POST to "
                        "<endpoint>/v1/traces); empty falls back to "
                        "$OTEL_EXPORTER_OTLP_ENDPOINT, neither = spans are "
                        "not exported (their ids still echo in answers)")
    p.add_argument("--trace-sample", type=float, default=1.0,
                   help="root-span sampling probability in [0, 1]; a "
                        "propagated context keeps the caller's decision")
    p.add_argument("--slo-ttft-p95-ms", type=float, default=0.0,
                   help="TTFT p95 objective in milliseconds: slower first "
                        "tokens burn the 5%% latency budget "
                        "(tpu_serve_slo_burn_rate); 0 disables it")
    p.add_argument("--slo-error-rate", type=float, default=0.01,
                   help="error-rate SLO budget: the allowed fraction of "
                        "requests finishing error or timeout (0 disables)")
    p.add_argument("--flight-spool-dir", default="",
                   help="directory of the flight recorder's anomaly dumps "
                        "(capped JSONL); empty keeps them in memory only "
                        "(/debug/flight/<id>)")
    p.add_argument("--devmon-peak-tflops", type=float, default=989.0,
                   help="the card's peak TFLOP/s that tpu_device_mfu "
                        "divides by (default: H100 SXM dense bf16)")
    p.add_argument("--devmon-peak-hbm-gbps", type=float, default=3350.0,
                   help="the card's peak memory GB/s that "
                        "tpu_device_membw_util divides by (default: H100 "
                        "SXM HBM3)")
    p.add_argument("--devmon-hbm-tolerance-mb", type=float, default=64.0,
                   help="live-over-ledger HBM tolerance (MB) before "
                        "/healthz's hbm_drift says 'warn' (never fails a "
                        "probe)")
    p.add_argument("--no-devmon", action="store_true",
                   help="no device telemetry (the tpu_device_* gauges stay "
                        "at their defaults)")
    p.add_argument("--capacity-headroom-s", type=float,
                   default=capacity.DEFAULT_HEADROOM_S,
                   help="seconds ahead the recommended_replicas forecast "
                        "looks: a replica's ready time (default: the "
                        "default replica's on an H100 80GB HBM3 at 700 W)")
    p.add_argument("--capacity-window-s", type=float, default=60.0,
                   help="window of the offered-load and utilization rates")
    p.add_argument("--capacity-trend-window-s", type=float, default=300.0,
                   help="window the saturation forecast fits its trend over")
    p.add_argument("--no-capacity", action="store_true",
                   help="no capacity estimator (the tpu_capacity_* gauges "
                        "stay at their defaults)")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def check_args(p: argparse.ArgumentParser, args) -> None:
    """Refuse (``p.error``) the JAX flags' values the port does not
    serve, and map ``--platform cpu`` onto ``--device cpu``."""
    if args.platform:
        if args.platform != "cpu":
            p.error(f"--platform {args.platform}: the port runs on CUDA "
                    f"(--device cuda, the default) or, with --platform cpu "
                    f"or --device cpu, on the CPU")
        args.device = "cpu"
    for flag, val in (("--ragged-attention", args.ragged_attention),
                      ("--ragged-features", args.ragged_features)):
        if val != 1:
            p.error(f"{flag} {val}: the port always runs the ragged mixed "
                    f"dispatch and its feature paths; the serialized chunk "
                    f"walk and the per-feature fallbacks are not ported")


def serving_config(args):
    """The ServingConfig of parsed :func:`build_parser` flags."""
    from aws_k8s_ansible_provisioner_tpu_torch.config import (MeshConfig,
                                                              ServingConfig)

    return ServingConfig(
        model=args.model, port=args.port, host=args.host,
        max_decode_slots=args.max_decode_slots,
        max_cache_len=args.max_cache_len, page_size=args.page_size,
        dtype=args.dtype, weights_dtype=args.weights_dtype,
        kv_dtype=args.kv_dtype, prefill_chunk=args.prefill_chunk,
        prefix_cache=not args.no_prefix_cache,
        kv_host_tier_bytes=args.kv_host_tier_bytes,
        decode_bblock=args.decode_bblock,
        decode_pipeline=args.decode_pipeline, spec_decode=args.spec_decode,
        spec_k=args.spec_k, spec_method=args.spec_method,
        mesh=MeshConfig(dp=args.dp, tp=args.tp, sp=args.sp, ep=args.ep),
        request_timeout_s=args.request_timeout,
        max_queue_depth=args.max_queue_depth,
        drain_timeout_s=args.drain_timeout,
        admission_max_wait_s=args.admission_max_wait,
        chat_template=args.chat_template, checkpoint_dir=args.checkpoint_dir,
        draft_checkpoint_dir=args.draft_checkpoint_dir,
        lora_adapters=tuple(args.lora),
        ragged_attention=args.ragged_attention,
        ragged_features=args.ragged_features,
        otlp_endpoint=args.otlp_endpoint, trace_sample=args.trace_sample,
        slo_ttft_p95_ms=args.slo_ttft_p95_ms,
        slo_error_rate=args.slo_error_rate,
        flight_spool_dir=args.flight_spool_dir,
        devmon_enabled=not args.no_devmon,
        devmon_peak_tflops=args.devmon_peak_tflops,
        devmon_peak_hbm_gbps=args.devmon_peak_hbm_gbps,
        devmon_hbm_tolerance_mb=args.devmon_hbm_tolerance_mb,
        capacity_enabled=not args.no_capacity,
        capacity_headroom_s=args.capacity_headroom_s,
        capacity_window_s=args.capacity_window_s,
        capacity_trend_window_s=args.capacity_trend_window_s)


def main(argv=None):
    p = build_parser()
    p.add_argument("--no-warmup", action="store_true",
                   help="serve without running every program once first "
                        "(/readyz turns 200 sooner; the first requests pay "
                        "the first launches)")
    p.add_argument("--aot-manifest", default="",
                   help="memory-fit manifest (serving/aot.py) to adopt: a "
                        "manifest of another configuration or a no-fit "
                        "ledger stops the server before warmup")
    args = p.parse_args(argv)
    check_args(p, args)
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s "
                               "%(message)s")
    state = build_state(serving_config(args), device=args.device,
                        seed=args.seed)
    if args.aot_manifest:
        aot = state.engine.load_aot_manifest(args.aot_manifest)
        log.info("AOT manifest adopted: %d programs, %.1fs first runs on "
                 "%s, %.2f GiB accounted (headroom %.2f GiB)",
                 aot["programs"], aot["total_compile_seconds"],
                 aot["platform"], aot["hbm_total_bytes"] / 2**30,
                 aot["hbm_headroom_bytes"] / 2**30)
    if not args.no_warmup:
        log.info("warmup: %d prefill buckets and every other program ...",
                 len(state.engine.buckets))
        log.info("warmup done in %.1fs", state.engine.warmup())

    # SIGTERM (a pod's deletion, after the preStop hook's /admin/drain)
    # takes the drain path: new requests shed 503, /readyz 503, the requests
    # in flight finish within --drain-timeout, then serve() returns and the
    # process exits 0
    def _on_sigterm(signum, frame):
        log.info("SIGTERM: graceful drain (timeout %.1fs)",
                 args.drain_timeout)
        state.begin_drain()

    signal.signal(signal.SIGTERM, _on_sigterm)
    serve(state, args.host, args.port)
    log.info("drained and stopped; exiting 0")


if __name__ == "__main__":
    main()
