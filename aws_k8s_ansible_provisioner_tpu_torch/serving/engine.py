"""Continuous-batching serving engine over the paged KV pool or the dense
slot cache.

The host-side scheduler of the port: FCFS admission, batched prefill of
fresh prompts, decode of every active slot with a fused horizon, chunked
prefill of long prompts, and speculative decoding
(``ServingConfig.spec_decode``: prompt-lookup drafts, or a draft model's,
verified in one dispatch of spec_k + 1 rows per slot). It follows the JAX
package's ``serving/engine.py`` and ``programs.EnginePrograms`` wherever
this slice reaches. Two layouts of the KV cache, as in the JAX engine:

- paged (``ServingConfig.paged=True``, the default): a shared page pool
  with per-slot block tables, admission gated on free pages, preemption
  (recompute) when the pool runs dry; a chunked prefill packs each chunk
  beside the decode batch in one ragged dispatch (``programs.mixed_step``);
- dense (``paged=False``): ``kv_cache.init_cache``'s slot-contiguous cache,
  every slot reserving its whole window; admission gated on free slots, no
  pages, no preemption. A chunked prefill walks its chunks through
  ``programs.prefill_chunk_step``, one decode dispatch of horizon 1
  between two chunks while slots run (the JAX engine's dense walk; the
  chunking slot's garbage decode row lands at the walk's frontier, which
  the next chunk overwrites). Decode attends through the dense kernels
  with ``decode_bblock`` slots per CTA (K5 when > 1; the paged kernel
  takes no block);
- dense and sequence-parallel (a mesh with ``sp`` > 1: ``mesh=`` or
  ``ServingConfig.mesh``, the JAX engine's long-context layout): the dense
  cache's sequence axis split into ``sp`` shards
  (``parallel/sharding.init_cache_sharded``), each on its mesh device; the
  parameters whole on the mesh's lead device. Decode attends every shard
  through K6 and merges the shards' partial softmaxes with a log-sum-exp;
  the prefills write each row in the shard that holds it. As in the JAX
  engine the layout is dense whatever ``paged`` says, speculation is off,
  and a sliding window or a window that does not split into 8-row-aligned
  shards is refused;
- paged over a (dp, tp, ep) mesh (``dp``, ``tp`` or ``ep`` > 1, the JAX
  engine's multi-chip layout): the parameters Megatron-sharded over the
  mesh (``models/layers.MeshLM``, ``parallel/sharding.param_pspecs``; a
  MoE config switched to gshard with a warning, its experts over ``ep``),
  the pool one partition per (dp group, tp shard)
  (``parallel/sharding.ShardedPool``). Slots map to dp groups
  contiguously; each group has its own allocator (``allocators``) in
  local page ids and its own scratch page, the table holds global ids
  (local + group * ``_group_pages``, the JAX layout) and each group's
  forward rebases its rows' tables. Admission gates on the best group's
  headroom and takes a free slot of a group that holds the request;
  preemption victims come from the starving slot's own group; the prefix
  cache is group-local, the host tier shared. Speculation stays on, the
  decode runs eagerly (no graphs), the draft model stays whole on the
  lead device, and under dp > 1 the chunk walk's mixed dispatches settle
  at once (the JAX engine turns its ragged dispatch off there). ``pp`` >
  1 (the pipeline schedule is training-only), ``sp`` beside another axis,
  the dense engine and LoRA under such a mesh are refused.

Decode runs the JAX engine's one-deep pipeline
(``ServingConfig.decode_pipeline``, default 1): a decode dispatch, or a
non-final chunk's mixed dispatch, is left in flight and the next one is
queued before its tokens are fetched, with the sampled token and length
carry still on the device (``programs.DecodeGraphs``' operand buffers);
the operands are copied in from the host mirrors only when those changed
(dirty flags, and ``_carry_gen`` for the carry). On a CUDA device a
dispatch queues a copy of its tokens into pinned host memory and records
an event, and its fetch waits for that event, not for the stream. Every
transition that rewrites slot state drains or settles the pipeline first,
as in the JAX engine: an admission of the dense engine (the paged engine
admits under a dispatch in flight through the chunk walk), the dense
chunk walk, a verify (settled), a preemption, idleness and a failure.
``decode_pipeline=0`` is the synchronous path, and a mesh with ``sp`` > 1
turns the pipeline off. On a CUDA device without a mesh, a plain decode
dispatch is one replay of a CUDA graph of the horizon captured when the
engine is built (``programs.DecodeGraphs``); ``mixed_step``, the verify,
the draft model's dispatches and the prefills launch their kernels one by
one from Python.

The prefix cache (``ServingConfig.prefix_cache``, default on) has two
tiers on the paged engine, as in the JAX engine:

- HBM: the full pages of every prompt, at its activation, and of prompt +
  generated tokens at a finish or a preemption (up to the last row already
  written), are indexed by a chain hash (``paged_kv.PagePool``). An
  admission looks its sequence up page by page, retains the pages it
  matches (shared by refcount, not copied) and walks the chunk program from
  the reuse offset. A released indexed page goes to an evictable LRU and
  stays matchable until an allocation reclaims it;
- host RAM (``kv_host_tier_bytes``, default 256 MiB; a budget below one
  page, or the prefix cache off, means no tier): the
  pages an allocation reclaims are gathered on the stream before anything
  can write them and copied into the page slots of a host tier taken when
  the engine is built (``paged_kv.HostTier``, pinned memory on a card); a
  lookup whose chain runs past the resident
  pages restores the next ones from there into the request's fresh pages,
  in place, queued ahead of its first chunk (no wait on the host). An entry
  that fails verification is dropped and its span re-prefilled.

Under a burst a match is used only when it spans
``prefix_reuse_min_pages`` pages or the prompt chunks anyway. The dense
engine copies the prompt rows that another slot (active or freed) still
holds (``kv_cache.copy_prefix``, per shard under sp) for an isolated
arrival, when the hit pays for its dispatches (``_hit_pays``). The counts
stand in for the JAX metrics: ``prefix_cache_hits``,
``prefix_tokens_reused``, ``prefix_tier_hits_{hbm,host,miss}``,
``kv_spill_bytes``, ``kv_restore_bytes``, ``kv_restore_dropped``.

Differences from the JAX engine:

- every paged chunked prefill, and every preemption resume, goes through
  ``mixed_step``, also when no decode row is active;
- a guided slot's device carry is re-uploaded from the host mirrors after a
  dispatch of horizon > 1 that it rode beside unguided slots (it emitted
  substep 0's token only): the JAX pipeline feeds it the discarded
  substeps' token and length (ROADMAP C26);
- a request with ``prompt_logprobs`` admitted under a dispatch in flight
  takes the chunk walk, as in the JAX engine, and its one chunk computes
  the prompt's logprobs (the JAX walk computes none; ROADMAP C21);
- the scheduler's admission budget is the pool's pages for the whole
  context (a continuation's included), without the JAX scheduler's token
  budget;
- a verify dispatch serves greedy slots only: a sampled slot takes its
  tokens from the plain step that follows (the JAX engine draws it from the
  verify's row 0), so that its seeded stream does not depend on speculation;
- the draft model keeps its cache at the target's own positions (see
  ``serving/draft.py``), where the JAX draft runs one row behind.

Idle slots keep decoding, as in the JAX engine: into the scratch page 0
(paged: their tables point there), or past their rows (dense: a freed slot
keeps its length); their outputs are discarded. A config with a sliding
window (Mistral) is served by the same steps, the window applied inside the
attention kernels; as in the JAX engine, a paged slot keeps its pages below
the window until it finishes.

The replica lifecycle is the JAX engine's:

- admission control: :meth:`Engine.submit` sheds a request before it
  queues, with :class:`EngineOverloaded` and a reason: ``draining`` while
  the engine drains, ``est_wait`` when ``admission_max_wait_s`` > 0 and
  the estimated queue wait exceeds it, ``queue_full`` past
  ``max_queue_depth``;
- deadlines: a request's deadline (its own ``deadline_s``, capped by
  ``request_timeout_s``, or that default alone) is absolute from submit,
  so queue wait counts against it; each step reaps the expired running
  slots, chunk walk and queued requests (finish ``"timeout"``), through
  the teardowns a cancel takes;
- drain (:meth:`Engine.begin_drain`, :meth:`Engine.end_drain`): no
  admission while draining, and past the drain deadline every request
  expires through the same reap;
- the paged engine's admission-pressure preemption: when the queue head
  has waited ``admission_preempt_after_s`` for pages although a slot is
  free, the lowest-progress running request is preempted and requeued at
  the back;
- the stall watchdog of :meth:`Engine.run_forever` (``stalled_for_s``,
  ``watchdog_stall_s``), whose abort flag fails a stalled step's requests
  (the chaos ``stalled_decode`` fault), and the metrics of
  ``serving/metrics.py`` (``Engine.metrics``; ``Engine.counts`` keeps the
  port's own counts).

The replica's observability and fault layer is the JAX engine's, at the
JAX engine's sites, through the port's copies of its modules (process
singletons, configured by the server's ``build_state``):

- the flight recorder (``serving/flightrec.py``): ``queue``, ``shed``,
  ``failover_resume``, ``admit``, ``prefill_chunk``, ``pipeline_dispatch``,
  ``pipeline_fetch``, ``preempt``, ``drain``, ``deadline_reap``,
  ``cancel_reap``, ``watchdog_stall``, ``fail_all`` and each request's
  terminal ``finish`` (an anomalous one snapshots its timeline);
- the SLO engine (``serving/slo.py``: admissions, TTFTs, terminal
  statuses) and the capacity estimator (``serving/capacity.py``: every
  submit's token budget, shed or admitted; the queue depth);
- device time (:class:`BusyClock`): each dispatch's seconds, from CUDA
  timing events on a card (read where the engine already waits for the
  dispatch, adding no synchronization) or host time on the CPU, feed
  ``device_busy_seconds``, ``decode_step_duration`` and the device
  monitor (``serving/devmon.py``) under the JAX program kinds
  (``decode``, ``mixed_step``, ``prefill``, ``prefill_batch``,
  ``prefill_chunk``, ``spec_decode``, ``prefix_copy``, ``kv_restore``);
  the host gap between a fetch that left the device idle and the next
  dispatch feeds ``decode_bubble_seconds``; devmon's HBM ledger reads
  tensor metadata only (:meth:`Engine._install_devmon`);
- the faults of ``serving/chaos.py`` at their JAX sites:
  ``page_exhaustion`` (``PagePool.fail_next_allocs``; an admission whose
  allocation fails after the gate is requeued), ``stalled_decode``,
  ``pipeline_fetch_error``, ``ragged_dispatch_error``,
  ``ragged_feature_error`` and ``kv_offload_error``
  (``HostTier.corrupt``); each releases slots and pages once.

The request's logit fields are the JAX engine's: the presence,
frequency and repetition penalties (a [B, V] count carry on the device,
reset or restored when a penalized request takes a slot), ``logit_bias``,
``min_tokens`` with ``stop_token_ids`` (the stop tokens banned from the
draws until then), ``logprobs`` and ``prompt_logprobs`` (the prefix cache
bypassed). Decode dispatches take the penalties and logprobs variants of
the decode graphs while a running request needs them; a verify serves no
token to a slot that needs one of these (:meth:`Engine._spec_skip`).

A request with ``stream`` set gets each generated token on its
``out_queue`` as it is emitted (after its logprob record), then the None
that every request gets when it finishes. A request with ``resume_ids``
(the failover continuation: the tokens another replica already generated
for the same prompt, sampling fields and seed) starts with them as its
generated tokens and is admitted as a preemption resume is: the chunk
program rebuilds the rows of prompt + resume, its draw is discarded, and
decode goes on at the position the undisturbed stream would have drawn
next, so that only new tokens reach the queue (paged engine only, as in
the JAX engine).

Sampling is seeded per request as in the JAX engine: a request's OpenAI
``seed``, or else one drawn at submit from the engine's ``random.Random``
(seeded by ``ServingConfig.derived_seed``, or os.urandom), keys every draw
with its token position, so a seeded stream does not depend on the batch
around it and two engines with one ``derived_seed`` draw alike.
``ServingConfig.kv_dtype="int8"`` stores the pool or the dense cache int8
with per-row scales.

Guided decoding (``Request.guided``: a ``serving/guided.TokenGrammar``,
which submit wraps in a cursor of its own, or a ``GuidedState``) is the JAX
engine's: every draw of a guided slot is masked by its grammar's allow
words (the decode graphs' always-on ``allow`` operand, all ones for an
unguided slot; the prefills' and the chunk row's own words), and the
cursor advances at every emit. The in-flight dispatch is settled before a
decode dispatch with a guided slot, so that the mask is fresh; a batch of
guided slots alone decodes at horizon 1; beside unguided slots a guided one
emits substep 0's token only, and a penalized one gets its count row back
from its host stream. The verify skips guided slots (their neighbours keep
speculating). The device words are cached by the cursors' fingerprints
(``_allow_row``, ``_allow_words``; hits counted in
``counts["allow_words_hits"]``, the host's time building and uploading
them in ``counts["allow_host_ns"]``, the cursors' mask time within it in
``counts["allow_mask_ns"]``).

Multi-LoRA (``Engine(lora={name: adapter dir})``, ``Request.lora``) is the
JAX engine's: the adapters attach beside the base weights after the int8
quantization (``models/lora.py``), every program carries the slots'
adapter indices (the decode graphs as an operand buffer, only with
adapters), the prefix chain of an adapter's pages is salted with
``("lora", index)`` and the dense prefix cache matches only rows of the
same adapter; the draft model stays adapter-free. LoRA under a mesh is
refused.
"""

from __future__ import annotations

import collections
import itertools
import logging
import os
import queue
import random
import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from aws_k8s_ansible_provisioner_tpu_torch.config import (ModelConfig,
                                                          ServingConfig)
from aws_k8s_ansible_provisioner_tpu_torch.device import resolve_device
from aws_k8s_ansible_provisioner_tpu_torch.models.layers import (DecoderLM,
                                                                 MeshLM)
from aws_k8s_ansible_provisioner_tpu_torch.models.lora import load_attached
from aws_k8s_ansible_provisioner_tpu_torch.models.quant import (
    quantize_params, weights_quantized)
from aws_k8s_ansible_provisioner_tpu_torch.ops.dense_attention import \
    fit_bblock
from aws_k8s_ansible_provisioner_tpu_torch.parallel.mesh import make_mesh
from aws_k8s_ansible_provisioner_tpu_torch.parallel.sharding import (
    ShardedPool, axis_size, check_tp_divisibility, init_cache_sharded,
    init_pool_sharded, is_sharded, sp_size)
from aws_k8s_ansible_provisioner_tpu_torch.serving import capacity as _capacity
from aws_k8s_ansible_provisioner_tpu_torch.serving import chaos as _chaos
from aws_k8s_ansible_provisioner_tpu_torch.serving import devmon as _devmon
from aws_k8s_ansible_provisioner_tpu_torch.serving import flightrec as _flight
from aws_k8s_ansible_provisioner_tpu_torch.serving import kv_cache as kvc
from aws_k8s_ansible_provisioner_tpu_torch.serving import metrics as _metrics
from aws_k8s_ansible_provisioner_tpu_torch.serving import paged_kv as pkv
from aws_k8s_ansible_provisioner_tpu_torch.serving import slo as _slo
from aws_k8s_ansible_provisioner_tpu_torch.serving.draft import DraftModel
from aws_k8s_ansible_provisioner_tpu_torch.serving.guided import (
    GuidedState, TokenGrammar)
from aws_k8s_ansible_provisioner_tpu_torch.serving.programs import (
    BAN_K, BIAS_K, LOGPROB_K, NO_TOKEN, DecodeGraphs, _host_lp, allow_words,
    decode_steps, mixed_step, prefill_batch_step, prefill_chunk_step,
    spec_decode_step)

log = logging.getLogger(__name__)

_REQUEST_IDS = itertools.count()


class ContextLengthExceeded(ValueError):
    """The prompt does not fit the engine's context window (HTTP 400)."""

    def __init__(self, n_prompt: int, limit: int, max_len: int):
        self.n_prompt, self.limit, self.max_len = n_prompt, limit, max_len
        super().__init__(
            f"This model's maximum prompt length is {limit} tokens "
            f"(context window {max_len}); your prompt has {n_prompt} tokens.")


class EngineOverloaded(RuntimeError):
    """Admission control shed this request before it queued: nothing was
    generated, so the caller may retry elsewhere or later. ``reason`` is
    ``draining`` (HTTP 503), ``est_wait`` or ``queue_full`` (HTTP 429);
    ``retry_after_s`` (at least 1) is the ``Retry-After`` hint."""

    def __init__(self, reason: str, message: str, retry_after_s: float = 1.0):
        self.reason = reason
        self.retry_after_s = max(1.0, float(retry_after_s))
        super().__init__(message)


@dataclass
class Request:
    """One generation request."""

    prompt_ids: List[int]
    max_tokens: int = 256
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    # OpenAI presence and frequency penalties over the generated tokens
    # (0.0: off; subtracted from the logits, ops/sampling.apply_penalties)
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    # vLLM/HF repetition_penalty (1.0: off): divides a positive logit of
    # every token of the prompt or generated so far, multiplies any other
    repetition_penalty: float = 1.0
    ignore_eos: bool = False
    # put every generated token on out_queue as it is emitted (the SSE
    # stream), before the finish's None
    stream: bool = False
    # OpenAI ``logprobs``: None = off; N = the chosen token's logprob and
    # the N best (0 <= N <= LOGPROB_K) of every generated token
    logprobs: Optional[int] = None
    # vLLM ``stop_token_ids``: stop tokens beside the eos set (unless
    # ignore_eos)
    stop_token_ids: tuple = ()
    # vLLM ``min_tokens``: every stop token (eos set and stop_token_ids) is
    # masked from the draws until this many tokens are generated
    min_tokens: int = 0
    # OpenAI ``logit_bias``: ((token id, bias), ...), at most BIAS_K,
    # added to the logits before every draw
    logit_bias: tuple = ()
    # vLLM ``prompt_logprobs``: None = off; K = each prompt position's
    # logprob and the K best (position 0 has none); bypasses the prefix
    # cache, and a prompt that would chunk is refused
    prompt_logprobs: Optional[int] = None
    # OpenAI ``seed``: same seed + same prompt => same sampled stream
    seed: Optional[int] = None
    # resolved at submit: the seed's low 32 bits, or the engine's draw
    eff_seed: int = 0
    # Multi-LoRA: the name of an adapter registered at Engine construction,
    # or None for the base model
    lora: Optional[str] = None
    # guided decoding: a serving/guided.TokenGrammar (submit wraps it in a
    # GuidedState of this request's own) or a GuidedState; None = off
    guided: object = None
    # end-to-end deadline in seconds from submission (None: the engine's
    # request_timeout_s); submit resolves it into the absolute t_deadline
    # (time.monotonic(); 0.0 = none)
    deadline_s: Optional[float] = None
    t_deadline: float = 0.0
    # the failover continuation: token ids another replica already generated
    # (and relayed) for this prompt, sampling fields and seed; submit makes
    # them the first generated tokens and rebuilds prompt + resume as a
    # preemption resume (paged engine only)
    resume_ids: tuple = ()
    # the trace id of the server's request span (empty: no tracing): the
    # OpenMetrics exemplar of the ttft and request-duration buckets
    trace_id: str = ""
    cancelled: bool = False
    id: int = field(default_factory=lambda: next(_REQUEST_IDS))
    generated: List[int] = field(default_factory=list)
    # with logprobs: one (own logprob, [(token id, logprob) x k]) per
    # generated token
    logprob_data: List[tuple] = field(default_factory=list)
    # with prompt_logprobs: None (position 0), then one such record per
    # prompt position
    prompt_logprob_data: List = field(default_factory=list)
    # with ``stream``, each generated token; None when the request finishes
    out_queue: "queue.Queue" = field(default_factory=queue.Queue)
    # time.monotonic() at submit, at the first admission into a slot (kept
    # across a preemption), at the first token and at the finish
    t_submit: float = 0.0
    t_prefill_start: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0
    finish_reason: str = ""

    def wait(self, timeout: Optional[float] = None) -> List[int]:
        """Block until completion; returns the generated token ids."""
        deadline = time.monotonic() + timeout if timeout else None
        while True:
            remaining = (deadline - time.monotonic()) if deadline else None
            if remaining is not None and remaining <= 0:
                raise TimeoutError(f"request {self.id} timed out")
            if self.out_queue.get(timeout=remaining) is None:
                return self.generated


class BusyClock:
    """Device seconds of the engine's dispatches, for
    ``tpu_serve_device_busy_seconds_total`` and ``serving/devmon.py``.

    On a CUDA device a dispatch is bracketed by two timing events on the
    engine's stream (:meth:`start` before it is queued, :meth:`stop` right
    behind it), and its seconds are read only after the engine has waited
    for that dispatch or a later one (:meth:`settle`), so that reading them
    waits for nothing. On the CPU the work is done by the time the call
    returns, and the seconds are host time: from the dispatch to its
    settle, never before the previous settle (the JAX engine's busy
    watermark, so that pipelined dispatches are not counted twice).

    An entry stopped with a program ``kind`` is booked through ``book``
    (``book(kind, seconds, note)``): at once on the CPU, on a card by the
    first :meth:`settle` after it; an entry without one is the caller's to
    book with the seconds :meth:`settle` returns."""

    def __init__(self, device: torch.device, book):
        self.cuda = device.type == "cuda"
        self.device = device
        self._book = book
        self._pending: collections.deque = collections.deque()
        self.watermark = 0.0

    def _event(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def start(self) -> tuple:
        return (self._event() if self.cuda else None, time.monotonic())

    def stop(self, mark: tuple, kind: Optional[str] = None, **note) -> tuple:
        entry = (mark[0], self._event() if self.cuda else None, mark[1],
                 kind, note)
        if self.cuda or kind is None:
            self._pending.append(entry)
        else:
            self._book(kind, self._seconds(entry), note)
        return entry

    def _seconds(self, entry: tuple) -> float:
        if self.cuda:
            return entry[0].elapsed_time(entry[1]) / 1e3
        now = time.monotonic()
        dt = max(0.0, now - max(entry[2], self.watermark))
        self.watermark = now
        return dt

    def settle(self, entry: tuple) -> float:
        """After the engine has waited for ``entry``'s dispatch: book every
        entry queued before it and return its own seconds (0.0 when it was
        discarded)."""
        while self._pending:
            e = self._pending.popleft()
            dt = self._seconds(e)
            if e is entry:
                return dt
            if e[3] is not None:
                self._book(e[3], dt, e[4])
        return 0.0

    def discard(self) -> None:
        """Forget the entries not settled (a failure discards their
        dispatches, which the JAX engine never books either)."""
        self._pending.clear()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _label(pos) -> str:
    return "[" + ",".join(str(int(i)) for i in pos) + "]"


def _param_ledger(model) -> tuple:
    """(the model's bytes, one copy of every leaf: the cost model's weight
    stream; {component: bytes} of the parameters the devices hold:
    ``params``, or under a mesh ``params[pos]`` a mesh position, a tensor
    held by two positions counted once), from tensor metadata."""
    if not isinstance(model, MeshLM):
        n = sum(_nbytes(t) for t in model.buffers())
        return n, {"params": float(n)}
    held: collections.Counter = collections.Counter()
    seen = set()
    logical = 0

    def visit(node):
        nonlocal logical
        for leaf in node.values():
            if isinstance(leaf, dict):
                visit(leaf)
                continue
            parts = leaf.parts
            logical += int(np.prod(leaf.shape)) \
                * next(iter(parts.values())).element_size()
            for pos, t in parts.items():
                key = (t.device, t.data_ptr())
                if key not in seen:
                    seen.add(key)
                    held["params" + _label(pos)] += _nbytes(t)

    visit(model.params)
    return logical, {k: float(v) for k, v in held.items()}


class Engine:
    """Continuous-batching engine over a fixed set of decode slots."""

    # time.monotonic() at the start of the step executing (0.0: none); a
    # step running past STALL_AFTER_S (serving.watchdog_stall_s) makes
    # stalled_for_s positive
    last_step_start: float = 0.0
    STALL_AFTER_S: float = 120.0

    def __init__(self, cfg: ModelConfig, params: dict, serving: ServingConfig,
                 eos_token_id: Optional[int] = None, device=None,
                 draft: Optional[tuple] = None, mesh=None,
                 lora: Optional[dict] = None):
        """``draft=(draft_cfg, draft_params)`` is the draft model of
        ``spec_method="draft"``; its vocabulary must cover the target's.
        ``mesh`` (``parallel/mesh.make_mesh``; default: built from
        ``serving.mesh`` when that names more than one device) shards the
        dense cache over its ``sp`` axis, or the parameters and the paged
        pool over ``dp``, ``tp`` and ``ep`` (``params`` whole, or already
        sharded by ``parallel/sharding.make_sharded_put``, then loaded
        int8 when the weights are); the engine then runs on the mesh's
        lead device, and ``device`` may only name its type.
        ``lora`` ({name: peft adapter dir}, in index order) registers the
        adapters a request may name (refused under a mesh). A MoE
        config under a mesh serves the gshard formulation (``ops/moe.py``),
        switched with a warning as the JAX engine switches it."""
        if serving.weights_dtype not in ("auto", "bf16", "int8"):
            raise ValueError(f"weights_dtype={serving.weights_dtype!r}: "
                             f"expected 'int8', 'bf16' or 'auto'")
        if serving.dtype not in ("bfloat16", "float32"):
            raise ValueError(f"dtype={serving.dtype!r}")
        if serving.kv_dtype not in ("auto", "int8"):
            # an unknown value must not silently keep the unquantized pool
            raise ValueError(f"kv_dtype={serving.kv_dtype!r}: expected "
                             f"'auto' or 'int8'")
        self.mesh = mesh if mesh is not None else self._build_mesh(serving)
        self.sp = sp_size(self.mesh)
        self.dp, self.tp, self.ep = (axis_size(self.mesh, a)
                                     for a in ("dp", "tp", "ep"))
        # the Megatron-sharded path (models/layers.MeshLM): dp, tp or ep > 1
        self._sharded = max(self.dp, self.tp, self.ep) > 1
        if self.mesh is not None:
            if axis_size(self.mesh, "pp") > 1:
                raise ValueError(
                    f"mesh {self.mesh.shape}: pp > 1 is not served; the "
                    f"pipeline schedule is training-only (not ported yet)")
            if self.sp > 1 and self._sharded:
                raise ValueError(
                    f"mesh {self.mesh.shape}: sp > 1 beside dp, tp or ep > 1 "
                    f"is not ported yet")
            check_tp_divisibility(cfg, self.tp, self.ep)
            if cfg.num_experts > 0 and cfg.moe_impl != "gshard":
                # the JAX engine's switch under any mesh: the fixed-capacity
                # dispatch in place of the exact one, said loudly
                log.warning(
                    "MoE under a mesh: switching moe_impl ragged -> gshard "
                    "(capacity_factor=%s; tokens past an expert's capacity "
                    "fall back to the residual stream)",
                    cfg.moe_capacity_factor)
                cfg = cfg.scaled(moe_impl="gshard")
            lead = self.mesh.lead
            if device is not None and torch.device(device).type != lead.type:
                raise ValueError(f"device {device} is not the mesh's lead "
                                 f"device {lead}")
            device = lead
        self.device = resolve_device(device)
        self.cfg = cfg
        self.serving = serving
        self.dtype = (torch.bfloat16 if serving.dtype == "bfloat16"
                      else torch.float32)
        self.num_slots = serving.max_decode_slots
        if self.num_slots % self.dp:
            raise ValueError(f"max_decode_slots={self.num_slots} must be "
                             f"divisible by dp={self.dp}")
        if self._sharded and not (serving.paged and self.sp == 1):
            raise ValueError("the dense engine (paged=False) under dp, tp or "
                             "ep > 1 is not ported yet")
        if not self._sharded:
            params = _to_device(params, self.device)
        elif is_sharded(params) and serving.weights_dtype == "int8" and \
                not weights_quantized(params):
            raise ValueError("a tree loaded sharded is quantized as it "
                             "loads (load_checkpoint(quantize=True))")
        if serving.weights_dtype == "int8" and not weights_quantized(params):
            # whole, before any slicing (a column-parallel slice of the
            # quantized kernel is then the quantization of that slice)
            params = quantize_params(params, cfg)
        # adapters attach after the quantization: their factors stay in the
        # activation dtype (the parameters') beside int8 kernels
        self.lora_names: List[str] = []
        if lora:
            if self.mesh is not None:
                raise ValueError("multi-LoRA under a mesh is not wired yet "
                                 "(adapter-axis pspecs)")
            items = list(lora.items())
            params = load_attached(params, items, cfg.num_layers,
                                   params["final_norm"]["weight"].dtype)
            self.lora_names = [name for name, _ in items]
        # under dp, tp or ep the engine never keeps the whole tree: each
        # mesh position's slices live on its device
        self.model = MeshLM(cfg, params, self.mesh,
                            self.num_slots // self.dp) \
            if self._sharded else DecoderLM(cfg, params)
        del params
        self.eos_token_id = cfg.eos_token_id if eos_token_id is None \
            else eos_token_id
        self._eos_set = ({self.eos_token_id, cfg.eos_token_id}
                         | set(cfg.extra_eos_token_ids))
        # the JAX engine rounds the window up to a 256 multiple
        self.max_len = -(-serving.max_cache_len // 256) * 256 \
            if serving.max_cache_len > 256 else serving.max_cache_len
        self.max_len = min(self.max_len, cfg.max_seq_len)
        if self.sp > 1 and cfg.sliding_window > 0:
            raise ValueError(
                "sequence-parallel serving (sp > 1) does not compose with "
                "sliding-window attention: the window straddles shard "
                "boundaries (serve the model with full attention)")
        if self.sp > 1 and self.max_len % (self.sp * 8):
            raise ValueError(
                f"cache window {self.max_len} must split into 8-row-aligned "
                f"sequence shards; not divisible by sp={self.sp} * 8")
        self.buckets = tuple(b for b in serving.prefill_buckets
                             if b <= self.max_len)
        quant = serving.kv_dtype == "int8"
        # sp shards the sequence axis, which the paged pool does not have:
        # the dense layout, as in the JAX engine
        self.paged = bool(serving.paged) and self.sp == 1
        # slots per CTA of the dense cache's decode kernel (K5 when > 1)
        self.decode_bblock = fit_bblock(serving.decode_bblock,
                                        self.num_slots)
        # one allocator per dp group (allocator: the only one at dp 1)
        self.allocators: List[pkv.PagePool] = []
        self.allocator: Optional[pkv.PagePool] = None
        self.dp_groups = self.dp
        self._slots_per_group = self.num_slots // self.dp
        self.host_tier: Optional[pkv.HostTier] = None
        self.table: Optional[np.ndarray] = None
        if self.paged:
            ps = self.page_size = serving.page_size
            if ps <= 0 or ps % 8:
                raise ValueError(f"page_size={ps} must be a positive "
                                 f"multiple of 8")
            self.pages_per_slot = -(-self.max_len // ps)
            pool_pages = serving.kv_pool_pages \
                or self.num_slots * self.pages_per_slot
            if serving.kv_pool_pages and pool_pages % self.dp:
                raise ValueError(
                    f"kv_pool_pages={pool_pages} must be divisible by the dp "
                    f"group count ({self.dp})")
            group_pages = pool_pages // self.dp
            if group_pages < self.pages_per_slot:
                # a lone max-length request must be able to grow to the
                # window in its own group, or preemption would spin on it
                raise ValueError(
                    f"kv_pool_pages={pool_pages} over {self.dp} dp group(s) "
                    f"gives {group_pages}/group < pages for one full window "
                    f"({self.pages_per_slot})")
            # dp groups: slots over groups contiguously, each group one
            # partition of the pool with its own allocator working in local
            # ids; the table holds GLOBAL ids (local + group * _group_pages,
            # the JAX engine's layout) and each group's forward rebases its
            # rows' tables (ops/attention.RowSplit). +1 a group: local page
            # 0 is the group's scratch page its idle slots point at
            self._group_pages = group_pages + 1
            if self._sharded:
                self.cache = init_pool_sharded(cfg, self._group_pages, ps,
                                               self.dtype, self.mesh,
                                               quant=quant)
            else:
                self.cache = pkv.init_pool(cfg, self._group_pages, ps,
                                           self.dtype, self.device,
                                           quant=quant)
            self.allocators = [pkv.PagePool(self._group_pages, ps,
                                            first_page=1)
                               for _ in range(self.dp)]
            if self.dp == 1:
                self.allocator = self.allocators[0]
            # a page's payload over every leaf, and each leaf's per-page
            # shape [L, Hkv, page, (D)] (the tier's fetch check)
            self._page_bytes = pkv.page_bytes(self.cache)
            self._page_shapes = pkv.page_shapes(self.cache)
            # the host tier serves the prefix cache: without the cache, or
            # with a budget that holds no page, there is none (and no host
            # memory is taken); one tier for every group, whose chain-hash
            # keys do not depend on the group
            if serving.prefix_cache and \
                    serving.kv_host_tier_bytes >= self._page_bytes:
                self.host_tier = pkv.HostTier(serving.kv_host_tier_bytes)
                self.host_tier.reserve(self.cache)
                for a in self.allocators:
                    a.host_tier = self.host_tier
            self.table = np.zeros((self.num_slots, self.pages_per_slot),
                                  np.int32)
            for slot in range(self.num_slots):
                self.table[slot] = self._gbase(slot)
        elif self.sp > 1:
            # every slot reserves its whole window, split over the shards
            self.cache = init_cache_sharded(cfg, self.num_slots,
                                            self.max_len, self.dtype,
                                            self.mesh, quant=quant)
        else:
            # every slot reserves its whole window of rows
            self.cache = kvc.init_cache(cfg, self.num_slots, self.max_len,
                                        self.dtype, self.device, quant=quant)
        self._slot_pages: List[List[int]] = [[] for _ in
                                             range(self.num_slots)]
        # slot -> bytes of a restore queued for its pages, counted when its
        # walk starts
        self._restore_pending: dict = {}
        # dense: the prompt tokens whose rows each slot still holds (active
        # or freed), the prefix cache's sources
        self._slot_tokens: List[tuple] = [()] * self.num_slots
        self.lengths = np.zeros(self.num_slots, np.int32)
        self.last_token = np.zeros(self.num_slots, np.int32)
        self.temps = np.zeros(self.num_slots, np.float32)
        self.top_ks = np.zeros(self.num_slots, np.int32)
        self.top_ps = np.ones(self.num_slots, np.float32)
        self.seeds = np.zeros(self.num_slots, np.int64)       # uint32 values
        # the logit rows of the decode operands (programs.DecodeGraphs):
        # min_tokens ban, logit_bias (NO_TOKEN pads), penalties; a slot's
        # rows are neutral while no request that sets them holds it
        self.ban_ids = np.full((self.num_slots, BAN_K), NO_TOKEN, np.int32)
        self.ban_until = np.zeros(self.num_slots, np.int32)
        self.bias_ids = np.full((self.num_slots, BIAS_K), NO_TOKEN, np.int32)
        self.bias_vals = np.zeros((self.num_slots, BIAS_K), np.float32)
        self._bias_n = np.zeros(self.num_slots, np.int32)
        self.pres_pens = np.zeros(self.num_slots, np.float32)
        self.freq_pens = np.zeros(self.num_slots, np.float32)
        self.rep_pens = np.ones(self.num_slots, np.float32)
        # each slot's adapter index (0 = base); _slot_lora: the adapter that
        # projected a dense slot's retained prompt rows (the dense prefix
        # cache never crosses adapters)
        self.lora_idx = np.zeros(self.num_slots, np.int32)
        self._slot_lora = np.zeros(self.num_slots, np.int32)
        # the guided allow words: the one-entry device cache of a chunking
        # request's row (keyed by its cursor's fingerprint), and what the
        # decode operand's guided rows hold ({slot: (request id, cursor
        # fingerprint)}; every other row is all ones)
        self._allow_dev = None
        self._allow_key: dict = {}
        self.slot_req: List[Optional[Request]] = [None] * self.num_slots
        # free slots: admit from the front, release to the back
        self._free: collections.deque = collections.deque(
            range(self.num_slots))
        self._admit_seq = np.zeros(self.num_slots, np.int64)
        self._seq_counter = 0
        self._queue: collections.deque = collections.deque()
        # request id -> prompt + generated context of a preempted request
        self._resume_ctx: dict = {}
        self._lock = threading.Lock()
        # held by run_forever's steps (see there)
        self.step_lock = threading.Lock()
        self._work_event = threading.Event()
        self._chunk: Optional[dict] = None
        # the dense chunk walk alternates a chunk with a horizon-1 decode
        # dispatch of the running slots: True when the decode is due
        self._chunk_yield = False
        # consecutive batch-prefill dispatches since the last decode
        # dispatch (the fairness floor, ServingConfig.prefill_fairness)
        self._prefill_streak = 0
        # seeds of requests without one; a pinned derived_seed makes two
        # engines (this one and the JAX one too) draw the same sequence
        self._py_rng = random.Random(
            int.from_bytes(os.urandom(8), "little")
            if serving.derived_seed is None else int(serving.derived_seed))
        self.counts = collections.Counter()
        self.last_error = ""
        self.metrics = _metrics.EngineMetrics()
        # (dispatch time, tokens emitted) of the last 50 fetched dispatches:
        # the tokens_per_second gauge
        self._tok_times: collections.deque = collections.deque(maxlen=50)
        # the lifecycle: the stall threshold; the watchdog's abort flag;
        # since when the paged queue head has waited for pages with a slot
        # free; the drain state, written under _lock by the server's
        # threads and read by the engine thread
        if serving.watchdog_stall_s > 0:
            self.STALL_AFTER_S = float(serving.watchdog_stall_s)
        self._stall_abort = False
        self._admission_blocked_since = 0.0
        self.draining = False
        self._drain_deadline = 0.0
        if serving.spec_method not in ("prompt_lookup", "draft"):
            raise ValueError(f"spec_method={serving.spec_method!r}: expected "
                             f"'prompt_lookup' or 'draft'")
        # after a verify that skipped slots, the next dispatch is plain so
        # that they advance
        self._spec_plain_due = False
        self.draft: Optional[DraftModel] = None
        if serving.spec_method == "draft" and self.spec_decode:
            if draft is None:
                raise ValueError("spec_method='draft' requires draft="
                                 "(draft_cfg, draft_params)")
            dcfg, dparams = draft
            if dcfg.vocab_size < cfg.vocab_size:
                raise ValueError(
                    f"draft vocab ({dcfg.vocab_size}) must cover the target "
                    f"vocab ({cfg.vocab_size}): drafts are target token ids")
            self.draft = DraftModel(dcfg, _to_device(dparams, self.device),
                                    self.num_slots, self.max_len, self.device)
        # the one-deep pipeline (the JAX EnginePrograms' state): the
        # dispatched but unfetched record; the carry generation of the
        # device-resident token/length carry (None: the operand buffers do
        # not hold it), valid while it equals _carry_gen, which every
        # transition that rewrites a slot's state bumps; dirty flags of the
        # sampling and table operands
        self._inflight: Optional[dict] = None
        self._pipe_carry: Optional[int] = None
        self._carry_gen = 0
        self._op_dirty_sampling = True
        self._op_dirty_table = True
        horizons = {1, max(1, serving.decode_horizon)}
        if self.draft is not None:
            horizons.add(min(max(1, serving.decode_horizon),
                             serving.spec_k + 1))
        self.decoder = DecodeGraphs(
            self.model, self.cache, self.num_slots,
            self.pages_per_slot if self.paged else None, horizons,
            bblock=self.decode_bblock, mesh=self.mesh,
            capture=(self.device.type == "cuda" and self.sp == 1
                     and not self._sharded))
        self.metrics.decode_bblock.set(self.decode_bblock)
        self._pages_gauges()
        # device time (the JAX engine's busy sites, BusyClock); the host
        # time a fetch left the device idle with nothing queued behind it,
        # which the next dispatch books as the decode bubble
        self._busy = BusyClock(self.device, self._book_busy)
        self._last_ready = 0.0
        # the decode or mixed dispatch queued last (a fetch of it leaves
        # nothing queued behind)
        self._last_dispatch: Optional[dict] = None
        # the memory-fit manifest adopted (load_aot_manifest), or None
        self.aot: Optional[dict] = None
        # the device monitor's cost model and HBM samplers, the capacity
        # estimator's engine probes: pure wiring, the recording happens at
        # the busy and submit sites
        self._install_devmon()
        self._install_capacity()

    def _book_busy(self, kind: str, seconds: float, note: dict) -> None:
        self.metrics.device_busy_seconds.inc(seconds)
        _devmon.note(kind, seconds, **note)

    def _install_devmon(self):
        """Hand the device monitor (``serving/devmon.py``) the cost model
        and the samplers of its HBM ledger, from tensor metadata only (no
        device read). The JAX engine's components: ``params``, the paged
        pool's ``kv_pages`` and ``kv_pages_evictable`` by the allocators'
        page counts (the dense cache whole, ``kv_cache``),
        ``sampler_carry`` (the decode carry's token and length buffers) and
        ``operand_cache`` (the decode operand buffers). What the port holds
        beside them has components of its own: ``decode_graphs`` (the
        graphs' private pool), the draft model's ``draft_params`` and
        ``draft_kv_cache``, and under a mesh each
        shard apart (``params[pos]`` a mesh position, ``kv_pages[g,t]`` a
        pool partition, ``kv_cache[i]`` an sp shard). The compiled total is
        the adopted memory-fit manifest's (0 without one). The samplers
        hold the engine by a weak reference: the process's monitor must
        not keep a dropped engine's device memory alive."""
        mon = _devmon.get()
        ref = weakref.ref(self)
        logical, params = _param_ledger(self.model)
        mon.install_cost_model(_devmon.CostModel.from_config(
            self.cfg, kv_dtype=self.serving.kv_dtype, weight_bytes=logical))
        cache = self.cache
        if isinstance(cache, ShardedPool):
            kv = [(g, _label((g, t)), sum(_nbytes(a) for a in part.values()))
                  for g, row in enumerate(cache.parts)
                  for t, part in enumerate(row)]
        elif isinstance(cache, list):
            kv = [(0, _label((i,)), sum(_nbytes(a) for a in shard.values()))
                  for i, shard in enumerate(cache)]
        else:
            kv = [(0, "", sum(_nbytes(a) for a in cache.values()))]
        d = self.decoder
        graphs = float(d.pool_bytes)
        carry = float(_nbytes(d.tokens) + _nbytes(d.lengths))
        operands = float(sum(
            _nbytes(t) for t in (
                d.table, d.temps, d.top_ks, d.top_ps, d.seeds, d.ban_ids,
                d.ban_until, d.bias_ids, d.bias_vals, d.presence,
                d.frequency, d.repetition, d.counts, d.prompt_mask, d.allow,
                d.lora_idx) if t is not None))
        draft = {}
        if self.draft is not None:
            draft = {"draft_params": float(sum(
                _nbytes(t) for t in self.draft.model.buffers())),
                "draft_kv_cache": float(sum(
                    _nbytes(a) for a in self.draft.cache.values()))}

        def _live() -> dict:
            eng = ref()
            if eng is None:
                return {}
            comp = dict(params)
            for g, suffix, nbytes in kv:
                if eng.paged:
                    st = eng.allocators[g].stats()
                    total = st["pages_total"] or 1
                    comp["kv_pages" + suffix] = \
                        nbytes * st["pages_live"] / total
                    comp["kv_pages_evictable" + suffix] = \
                        nbytes * st["pages_evictable"] / total
                else:
                    comp["kv_cache" + suffix] = float(nbytes)
            comp["sampler_carry"] = carry
            comp["operand_cache"] = operands
            if graphs:
                comp["decode_graphs"] = graphs
            comp.update(draft)
            return comp

        def _compiled() -> float:
            eng = ref()
            return float(eng.aot["hbm_total_bytes"]) \
                if eng is not None and eng.aot else 0.0

        mon.install_hbm(_live, _compiled)

    def _install_capacity(self):
        """Hand the capacity estimator (``serving/capacity.py``) the queue
        depth (its Little's-law delay) and the tokens-per-second gauge (its
        ceiling until devmon has a decode window), through a weak reference
        to the engine (0 once it is gone)."""
        ref = weakref.ref(self)

        def depth() -> int:
            eng = ref()
            return eng.pending if eng is not None else 0

        def tps() -> float:
            eng = ref()
            return eng.metrics.tokens_per_second.value() \
                if eng is not None else 0.0

        _capacity.get().install_engine(depth, tps)

    @property
    def spec_decode(self) -> bool:
        """Whether decode speculates: ``serving.spec_decode``, except under
        sp, whose merge has no multi-row (verify) form (plain decode, as in
        the JAX engine)."""
        return bool(self.serving.spec_decode) and self.sp == 1

    @staticmethod
    def _build_mesh(serving: ServingConfig):
        """The serving mesh of ``serving.mesh`` over the visible cards (None
        for a single device; the JAX engine's ``_build_mesh``)."""
        if serving.mesh.num_devices <= 1:
            return None
        return make_mesh(serving.mesh)

    # -- submission ---------------------------------------------------------

    @property
    def prompt_limit(self) -> int:
        """Longest prompt a slot can hold: the largest bucket, or the window
        itself when chunked prefill is on."""
        if self.serving.prefill_chunk > 0:
            return self.max_len - 2
        return min(self.buckets[-1], self.max_len - 2)

    @property
    def _chunk_size(self) -> int:
        if self.serving.prefill_chunk > 0:
            return self.serving.prefill_chunk
        return self.buckets[-1]

    def _should_chunk(self, n: int) -> bool:
        return self.serving.prefill_chunk > 0 and (
            n > self.serving.prefill_chunk or n > self.buckets[-1])

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._queue)

    def submit(self, req: Request) -> Request:
        """Queue ``req``, or shed it with :class:`EngineOverloaded` before
        it queues: while draining (before any other check), past
        ``admission_max_wait_s`` of estimated wait, past
        ``max_queue_depth``. Resolves the request's seed and its absolute
        deadline; a deadline of <= 0 seconds raises ValueError. A
        continuation (``resume_ids``) is refused on the dense engine
        (ValueError) and when prompt + resume exceed ``max_len - 2``
        (:class:`ContextLengthExceeded`); its resume context is installed
        before the request is queued, where the engine thread may admit it
        at once."""
        req.t_submit = time.monotonic()
        if self.draining:
            self.metrics.requests_shed.inc(reason="draining")
            self._note_shed(req, "draining")
            raise EngineOverloaded(
                "draining", "engine is draining; not admitting new requests",
                retry_after_s=max(1.0, self._drain_deadline
                                  - time.monotonic()))
        n = len(req.prompt_ids)
        if n == 0:
            raise ValueError("empty prompt")
        if n > self.prompt_limit:
            raise ContextLengthExceeded(n, self.prompt_limit, self.max_len)
        if min(req.prompt_ids) < 0 or max(req.prompt_ids) >= \
                self.cfg.vocab_size:
            raise ValueError(f"prompt token ids must lie in "
                             f"[0, {self.cfg.vocab_size})")
        if req.resume_ids:
            # the continuation rides the preemption resume, which is paged
            if not self.paged:
                raise ValueError("continuation (resume_ids) requires the "
                                 "paged engine")
            if n + len(req.resume_ids) > self.max_len - 2:
                raise ContextLengthExceeded(n + len(req.resume_ids),
                                            self.max_len - 2, self.max_len)
            if min(req.resume_ids) < 0 or max(req.resume_ids) >= \
                    self.cfg.vocab_size:
                raise ValueError(f"resume token ids must lie in "
                                 f"[0, {self.cfg.vocab_size})")
            if req.prompt_logprobs is not None:
                raise ValueError("continuation cannot carry prompt_logprobs "
                                 "(computed at first prefill only)")
        self._check_fields(req)
        req.max_tokens = max(1, min(req.max_tokens, self.max_len - n - 1))
        with self._lock:
            req.eff_seed = (int(req.seed) & 0xffffffff) \
                if req.seed is not None else self._py_rng.getrandbits(32)
        # the client's deadline capped by request_timeout_s, or that default
        # alone (<= 0: no cap and no default); absolute, so that queue wait
        # counts against it
        cap = float(self.serving.request_timeout_s or 0)
        d = req.deadline_s
        if d is not None and d <= 0:
            raise ValueError(f"deadline must be > 0 seconds (got {d})")
        if d is None:
            d = cap if cap > 0 else None
        elif cap > 0:
            d = min(float(d), cap)
        req.t_deadline = (req.t_submit + d) if d else 0.0
        max_wait = float(self.serving.admission_max_wait_s or 0)
        if max_wait > 0:
            est = self._estimated_wait_s()
            if est > max_wait:
                self.metrics.requests_shed.inc(reason="est_wait")
                self._note_shed(req, "est_wait", est_wait_s=round(est, 3))
                raise EngineOverloaded(
                    "est_wait",
                    f"estimated queue wait {est:.1f}s exceeds the "
                    f"admission limit {max_wait:.1f}s",
                    retry_after_s=est - max_wait + 1)
        if req.resume_ids:
            # the relayed tokens are the first generated ones; the walk
            # rebuilds prompt + resume and the admission gate counts its
            # pages (both read _resume_ctx once the request is queued)
            req.generated = [int(t) for t in req.resume_ids]
            if req.guided is not None:
                # the cursor stands where the first replica's stood: past
                # every relayed token
                for t in req.generated:
                    req.guided.advance(t)
            self._resume_ctx[req.id] = list(req.prompt_ids) + req.generated
        with self._lock:
            depth = self.serving.max_queue_depth
            full = bool(depth) and len(self._queue) >= depth
            if not full:
                self._queue.append(req)
            waiting = len(self._queue)
            self.metrics.queue_depth.set(waiting)
        if full:
            self._resume_ctx.pop(req.id, None)
            self.metrics.requests_shed.inc(reason="queue_full")
            self._note_shed(req, "queue_full", queue_depth=waiting)
            raise EngineOverloaded(
                "queue_full",
                f"engine queue is full ({waiting} waiting, limit {depth})",
                retry_after_s=self._estimated_wait_s() or 1.0)
        _slo.get().observe_admission(shed=False)
        _capacity.get().observe_submit(tokens=max(1, req.max_tokens),
                                       shed=False)
        _flight.record("queue", req.id, n_prompt=len(req.prompt_ids),
                       max_tokens=req.max_tokens)
        if req.resume_ids:
            _flight.record("failover_resume", req.id,
                           n_resume=len(req.resume_ids))
        self._work_event.set()
        return req

    @staticmethod
    def _note_shed(req: Request, reason: str, **data) -> None:
        """A shed submission, as the JAX engine records it: a bad admission
        for the SLO engine, offered load for the capacity estimator, and a
        ``shed`` flight event closing the request's timeline."""
        _slo.get().observe_admission(shed=True)
        _capacity.get().observe_submit(tokens=max(1, req.max_tokens),
                                       shed=True)
        _flight.record("shed", req.id, reason=reason, **data)
        _flight.finish(req.id, "shed", ok=False)

    def _check_fields(self, req: Request) -> None:
        """The JAX engine's checks of the logit fields (ValueError): the
        min_tokens ban within BAN_K tokens, the bias within BIAS_K entries,
        a repetition penalty > 0 (a factor <= 0 would flip the logits'
        signs), the grammar (a TokenGrammar, wrapped here in a cursor of
        the request's own, or a GuidedState; its vocabulary within the
        model's; no min_tokens with an exact-match grammar, whose final
        state allows only eos), prompt_logprobs within [0, LOGPROB_K] and
        only on a prompt that does not chunk (the chunk walk computes none),
        a registered adapter."""
        if req.min_tokens > 0 and len(self._ban_set(req)) > BAN_K:
            raise ValueError(
                f"min_tokens suppression supports at most {BAN_K} stop "
                f"tokens (eos set + stop_token_ids = "
                f"{len(self._ban_set(req))})")
        if len(req.logit_bias) > BIAS_K:
            raise ValueError(f"logit_bias supports at most {BIAS_K} entries "
                             f"(got {len(req.logit_bias)})")
        if req.repetition_penalty is not None and req.repetition_penalty <= 0:
            raise ValueError(f"repetition_penalty must be > 0 "
                             f"(got {req.repetition_penalty})")
        if req.guided is not None:
            if isinstance(req.guided, TokenGrammar):
                req.guided = GuidedState(req.guided)
            elif not isinstance(req.guided, GuidedState):
                raise ValueError("guided must be a TokenGrammar or "
                                 "GuidedState (serving/guided.py)")
            if req.guided.grammar.vocab_size > self.cfg.vocab_size:
                raise ValueError(
                    f"guided grammar vocab ({req.guided.grammar.vocab_size}) "
                    f"exceeds model vocab ({self.cfg.vocab_size})")
            if req.min_tokens > 0 and req.guided.grammar.exact:
                # the min_tokens ban would mask the eos that an exact
                # grammar's final state allows alone: an all -inf row
                raise ValueError(
                    "min_tokens cannot combine with exact-match guided "
                    "decoding (guided_regex / guided_choice)")
        if req.prompt_logprobs is not None:
            if not 0 <= int(req.prompt_logprobs) <= LOGPROB_K:
                raise ValueError(f"prompt_logprobs must be in "
                                 f"[0, {LOGPROB_K}]")
            if self._should_chunk(len(req.prompt_ids)):
                raise ValueError(
                    "prompt_logprobs is not supported for prompts that "
                    "need chunked prefill (fits-in-bucket prompts only)")
        if req.lora is not None and req.lora not in self.lora_names:
            raise ValueError(f"unknown LoRA adapter {req.lora!r} "
                             f"(registered: {self.lora_names})")

    def _estimated_wait_s(self) -> float:
        """Coarse queue-wait estimate: queued requests x recent tokens per
        finished request / recent tokens per second; 0.0 without throughput
        history (a cold engine never sheds on an estimate)."""
        tps = self.metrics.tokens_per_second.value()
        depth = self.pending
        if tps <= 0 or depth <= 0:
            return 0.0
        avg_tokens = self.metrics.generated_tokens.total() \
            / max(1, self.counts["finished"])
        return depth * max(1.0, avg_tokens) / tps

    def cancel(self, req: Request):
        """Mark a request cancelled; its slot frees on the next step."""
        req.cancelled = True
        self._work_event.set()

    # -- drain, deadlines and admission pressure ----------------------------

    def begin_drain(self, timeout_s: Optional[float] = None) -> float:
        """Stop admitting (submit sheds with reason ``draining``) and give
        the requests in flight ``timeout_s`` (default
        ``serving.drain_timeout_s``) to finish; past that the deadline reap
        cancels them (finish ``"timeout"``). A second call while draining
        keeps the first deadline (the preStop hook and SIGTERM both call
        it). Returns the seconds left until the drain deadline."""
        with self._lock:
            now = time.monotonic()
            if self.draining:
                return max(0.0, self._drain_deadline - now)
            t = max(0.0, float(self.serving.drain_timeout_s
                               if timeout_s is None else timeout_s))
            self.draining = True
            self._drain_deadline = now + t
        self.metrics.draining.set(1)
        _flight.record("drain", None, state="begin", timeout_s=t)
        self._work_event.set()
        return t

    def end_drain(self):
        """Cancel a drain: admissions resume."""
        with self._lock:
            self.draining = False
            self._drain_deadline = 0.0
        self.metrics.draining.set(0)
        _flight.record("drain", None, state="end")
        self._work_event.set()

    def _effective_deadline(self, req: Request) -> float:
        """The request's deadline tightened by the drain deadline (0.0 =
        none): a drain never extends a request's budget."""
        d = req.t_deadline or 0.0
        if self.draining and self._drain_deadline:
            d = min(d or self._drain_deadline, self._drain_deadline)
        return d

    def _reap_expired(self):
        """Cancel every request whose deadline has passed, with finish
        ``"timeout"``, each counted once in ``deadline_expired``: a running
        slot through :meth:`_finish` (a dispatch in flight discards its
        tokens), the chunk walk through :meth:`_end_walk` (which settles
        its mixed dispatch in flight first), a queued request out of the
        queue with its resume context."""
        now = time.monotonic()
        for slot, r in enumerate(self.slot_req):
            if r is not None and 0 < self._effective_deadline(r) <= now:
                r.finish_reason = "timeout"
                self.metrics.deadline_expired.inc()
                _flight.record("deadline_reap", r.id, slot=slot,
                               phase="decode")
                self._finish(slot)
        st = self._chunk
        if st is not None and 0 < self._effective_deadline(st["req"]) <= now:
            self.metrics.deadline_expired.inc()
            self._end_walk("timeout")
        with self._lock:
            if not self._queue:
                return
            expired = [r for r in self._queue
                       if 0 < self._effective_deadline(r) <= now]
            if not expired:
                return
            gone = {r.id for r in expired}
            self._queue = collections.deque(
                r for r in self._queue if r.id not in gone)
            self.metrics.queue_depth.set(len(self._queue))
        for r in expired:
            self._resume_ctx.pop(r.id, None)
            r.finish_reason = "timeout"
            self.metrics.deadline_expired.inc()
            self.metrics.mark_request("timeout", now - r.t_submit)
            _flight.record("deadline_reap", r.id, phase="queued")
            _flight.finish(r.id, "timeout", ok=False)
            r.out_queue.put(None)

    def _relieve_admission_pressure(self) -> bool:
        """The paged queue head cannot be placed for want of pages although
        a slot is free: after ``admission_preempt_after_s`` of that, preempt
        the lowest-progress running request (the least recompute lost),
        requeued at the back so that the starved head takes its pages.
        Returns whether a request was preempted."""
        wait = float(self.serving.admission_preempt_after_s or 0)
        active = self._active_slots()
        if wait <= 0 or not self.pending or not self._free or not active:
            self._admission_blocked_since = 0.0
            return False
        now = time.monotonic()
        if not self._admission_blocked_since:
            self._admission_blocked_since = now
            return False
        if now - self._admission_blocked_since < wait:
            return False
        victim = min(active, key=lambda s: (len(self.slot_req[s].generated),
                                            -self._admit_seq[s]))
        self.metrics.admission_preemptions.inc()
        self._preempt(victim, front=False)
        self._admission_blocked_since = now
        return True

    # -- slots and pages ----------------------------------------------------

    def _active_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is not None]

    # dp groups: slots map to groups contiguously; each group's allocator
    # works in local page ids (0 = its scratch page), the table in global
    # ones (local + group * _group_pages); one group without dp

    def _group(self, slot: int) -> int:
        return slot // self._slots_per_group

    def _alloc(self, slot: int) -> pkv.PagePool:
        """The allocator of the slot's dp group's pool partition."""
        return self.allocators[self._group(slot)]

    def _gbase(self, slot: int) -> int:
        """Global page id of the slot's group's first page (its scratch)."""
        return self._group(slot) * self._group_pages

    def _free_slot_for(self, pages: int) -> Optional[int]:
        """The index in the free deque of the first slot whose group can
        take ``pages`` now (free or evictable), or None: the admission
        gate, on the best group's headroom."""
        for i, slot in enumerate(self._free):
            if self._alloc(slot).free_pages >= pages:
                return i
        return None

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _release_slot(self, slot: int):
        """Return the slot's pages, point its table at scratch, make it
        greedy (an idle slot must not make a greedy batch draw noise) and
        free it. A dense slot keeps its length, as in the JAX engine: its
        idle decode rows land past its rows, never over them. A release does
        not bump ``_carry_gen``: a dispatch in flight keeps decoding the
        slot as garbage (its emits are discarded), and only a reuse
        (:meth:`_activate`) invalidates the device carry."""
        if self.paged:
            # indexed pages go to the evictable LRU, still matchable
            self._alloc(slot).release_all(self._slot_pages[slot])
            self._slot_pages[slot] = []
            # a restore queued for a slot torn down before its walk must
            # not be settled against a later tenant's
            self._restore_pending.pop(slot, None)
            self.table[slot, :] = self._gbase(slot)
            self.lengths[slot] = 0
            self._op_dirty_table = True
            self._pages_gauges()
        self.temps[slot] = 0.0
        self._neutral_rows(slot)
        self._op_dirty_sampling = True
        self._free.append(slot)

    def _neutral_rows(self, slot: int):
        """The slot's ban, bias, penalty and adapter rows back to their
        neutral values (its count and prompt-mask rows stay: a neutral row
        ignores them, and a request that penalizes resets them)."""
        self.ban_ids[slot] = NO_TOKEN
        self.ban_until[slot] = 0
        self.bias_ids[slot] = NO_TOKEN
        self.bias_vals[slot] = 0.0
        self._bias_n[slot] = 0
        self.pres_pens[slot] = 0.0
        self.freq_pens[slot] = 0.0
        self.rep_pens[slot] = 1.0
        self.lora_idx[slot] = 0

    def _lora_index(self, req: Request) -> int:
        """The request's adapter index (0 = base)."""
        return self.lora_names.index(req.lora) + 1 \
            if req.lora is not None else 0

    @staticmethod
    def _lora_salt(idx: int):
        """The prefix chain's salt of an adapter's pages: rows projected
        under one adapter never match a request on another (None for the
        base keeps the base chain unsalted)."""
        return ("lora", int(idx)) if idx else None

    def _ban_set(self, req: Request) -> set:
        """The tokens a request's min_tokens suppresses: exactly those
        :meth:`_emit` stops on."""
        base = set() if req.ignore_eos else set(self._eos_set)
        return base | set(req.stop_token_ids)

    def _fill_sampling_rows(self, req: Request, slot: int):
        """The slot's min_tokens ban, logit_bias and adapter rows from the
        request (the JAX engine's): before the prefill dispatch, so that the
        first token honours them, and again at the activation (a
        resume)."""
        self._op_dirty_sampling = True
        self.lora_idx[slot] = self._lora_index(req)
        self.ban_ids[slot] = NO_TOKEN
        if req.min_tokens > 0:
            bs = sorted(self._ban_set(req))[:BAN_K]
            self.ban_ids[slot, :len(bs)] = bs
            self.ban_until[slot] = len(req.prompt_ids) + req.min_tokens
        else:
            self.ban_until[slot] = 0
        self.bias_ids[slot] = NO_TOKEN
        self.bias_vals[slot] = 0.0
        n = len(req.logit_bias)
        self._bias_n[slot] = n
        if n:
            self.bias_ids[slot, :n] = [t for t, _ in req.logit_bias]
            self.bias_vals[slot, :n] = [v for _, v in req.logit_bias]

    def _want_pen(self) -> bool:
        """Whether a decode dispatch takes the penalties variant: some slot
        penalizes."""
        return bool(self.pres_pens.any() or self.freq_pens.any()
                    or (self.rep_pens != 1.0).any())

    def _want_lp(self) -> bool:
        """Whether a decode dispatch takes the logprobs variant."""
        return any(r is not None and r.logprobs is not None
                   for r in self.slot_req)

    def _pages_gauges(self):
        """The pool's page gauges (total, live, free, evictable) and the
        host tier's, from the allocator (paged engine only)."""
        if not self.paged:
            return
        st = collections.Counter()
        for a in self.allocators:
            st.update({k: v for k, v in a.stats().items()
                       if isinstance(v, int)})
        m = self.metrics
        m.kv_pages_total.set(st["pages_total"])
        m.kv_pages_in_use.set(st["pages_live"])
        m.kv_pages_free.set(st["pages_free"])
        m.kv_pages_evictable.set(st["pages_evictable"])
        if self.host_tier is not None:
            m.kv_host_tier_used_bytes.set(self.host_tier.used_bytes)
            m.kv_host_tier_entries.set(len(self.host_tier))

    def _ensure_pages(self, new_rows: int) -> bool:
        """Grow every active slot's pages to cover rows
        [0, min(length + new_rows, window)) before a dispatch writes them;
        when the pool runs dry, preempt the newest admission (recompute
        later). Returns whether any slot is still active (the dense cache
        needs no pages)."""
        if not self.paged:
            return bool(self._active_slots())
        ps = self.page_size
        for slot in sorted(self._active_slots(),
                           key=lambda s: self._admit_seq[s]):
            if self.slot_req[slot] is None:         # preempted this round
                continue
            rows = min(int(self.lengths[slot]) + new_rows,
                       self.pages_per_slot * ps)
            pages = self._slot_pages[slot]
            while len(pages) < -(-rows // ps):
                need = -(-rows // ps) - len(pages)
                got = self._alloc(slot).alloc(need)
                if got is not None:
                    # spill what this allocation reclaimed before the
                    # dispatch that writes the pages is queued
                    self._spill_reclaimed()
                    self.table[slot, len(pages):len(pages) + need] = \
                        np.asarray(got, np.int32) + self._gbase(slot)
                    self._op_dirty_table = True
                    pages.extend(got)
                    break
                # the newest admission of this slot's own dp group yields:
                # pages are group-local, so another group's free nothing
                victim = max((s for s in self._active_slots()
                              if self._group(s) == self._group(slot)),
                             key=lambda s: self._admit_seq[s])
                self._preempt(victim)
                if victim == slot:
                    break
        self._pages_gauges()
        return bool(self._active_slots())

    def _preempt(self, slot: int, front: bool = True):
        """Release a running request's pages and requeue it at the front
        (``front=False``, the admission-pressure relief: at the back, so
        that the starved head admits first; a requeue is never shed by
        ``max_queue_depth``); it resumes by re-prefilling prompt +
        generated so far, past the full pages it still finds in the prefix
        cache."""
        req = self.slot_req[slot]
        ids = req.prompt_ids + req.generated
        # the resume hits its own pages, up to the last row written (the
        # last token's row is written by the next dispatch)
        self._index_prompt_pages(slot, ids, n_valid=len(ids) - 1)
        self._resume_ctx[req.id] = ids
        self.slot_req[slot] = None
        # the slot's host state leaves the device carry of a dispatch in
        # flight behind
        self._carry_gen += 1
        self._release_slot(slot)
        with self._lock:
            if front:
                self._queue.appendleft(req)
            else:
                self._queue.append(req)
            self.metrics.queue_depth.set(len(self._queue))
        self.counts["preemptions"] += 1
        self.metrics.preemptions.inc()
        _flight.record("preempt", req.id, slot=slot,
                       n_generated=len(req.generated), front=front)
        self.metrics.active_requests.set(len(self._active_slots()))

    # -- the step -----------------------------------------------------------

    def step(self) -> bool:
        """One scheduling step: advance a chunked prefill (paged: one mixed
        dispatch; dense: a chunk, or the horizon-1 decode dispatch that
        alternates with the chunks while slots run), else the fairness
        floor's decode dispatch when it is due, else admit waiting prompts
        (the paged engine: or, when the queue head starves for pages with a
        slot free, relieve the pressure), else decode; with nothing to do,
        settle a dispatch still in flight. Cancelled and then expired
        requests are reaped first. Returns whether any work was done. An
        armed ``page_exhaustion`` fault (``serving/chaos.py``) makes the
        allocators refuse their next allocations first."""
        ch = _chaos.get()
        if ch.enabled:
            ch.on_engine_step(self)
        for slot, r in enumerate(self.slot_req):
            if r is not None and r.cancelled:
                r.finish_reason = "cancelled"
                _flight.record("cancel_reap", r.id, slot=slot)
                self._finish(slot)
        # deadlines are enforced here, between dispatches
        self._reap_expired()
        if self._chunk is not None:
            if self._chunk_yield and self._active_slots():
                # the decode writes a row for every slot at its length: the
                # chunking slot's lands at the walk's frontier, which the
                # next chunk overwrites
                self._chunk_yield = False
                self._decode(max_horizon=1)
                return True
            self._advance_chunk()
            self._chunk_yield = not self.paged
            return True
        # the fairness floor: after prefill_fairness batch prefills in a row
        # while slots decode and prompts wait, one decode dispatch at the
        # full horizon before the next admission
        fair = max(0, self.serving.prefill_fairness)
        if fair and self._prefill_streak >= fair and self._active_slots() \
                and self.pending:
            self._prefill_streak = 0
            self._decode(fair_horizon=True)
            return True
        if self._inflight is not None and self.pending \
                and not self._ragged_on():
            # settle the dispatch in flight before admission can reuse a
            # slot it still decodes (its deferred emits would go to the new
            # request)
            self._drain_decode_pipeline("prefill")
        batch, chunk_next = self._admit()
        if batch or chunk_next is not None:
            self._admission_blocked_since = 0.0
        elif self.paged and self._relieve_admission_pressure():
            # the preemption is this step's work: a sole victim requeued
            # behind a False step would be stranded by an idle caller
            return True
        if batch:
            self._prefill_streak += 1
            try:
                self._prefill_batch(batch)
            except Exception:
                # the slots (and pages) were taken but no request activated:
                # release them and answer the requests here
                for req, slot in batch + ([chunk_next[:2]] if chunk_next
                                          else []):
                    if self.slot_req[slot] is req:
                        continue           # activated: run_forever fails it
                    self._release_slot(slot)
                    req.finish_reason = "error"
                    self.metrics.mark_request("error", 0.0)
                    _flight.finish(req.id, "error", ok=False,
                                   phase="prefill_batch")
                    req.out_queue.put(None)
                raise
        if chunk_next is not None:
            self._start_chunk(*chunk_next)
            self._chunk_yield = False
            if not batch:
                self._advance_chunk()
                self._chunk_yield = not self.paged
        if batch or chunk_next is not None:
            return True
        if self._active_slots():
            self._decode()
            return True
        if self._inflight is not None:
            # cancels emptied the batch with a dispatch in flight: settle it
            # (its emits are discarded) so nothing stays queued while idle
            self._drain_decode_pipeline()
            return True
        return False

    def _admit(self):
        """FCFS admission: pop queue heads while a slot is free and the pool
        holds the head's pages (the dense cache: while a slot is free);
        fresh fitting prompts form the prefill batch, a prompt that chunks
        (or a resume, a prefix hit, or any prompt of the paged engine while
        a dispatch is in flight) ends it. An arrival is isolated when the
        batch and the queue are empty: the dense engine consults its prefix
        cache only then. A cancelled head leaves the queue (finish
        ``cancelled``) whether or not a slot is free, as the JAX
        scheduler's admission pops it."""
        batch, chunk_next = [], None
        while len(batch) < max(1, self.serving.max_prefill_batch):
            with self._lock:
                if not self._queue:
                    break
                req = self._queue[0]
                if req.cancelled:
                    self._queue.popleft()
                    self.metrics.queue_depth.set(len(self._queue))
                    self._resume_ctx.pop(req.id, None)
                    req.finish_reason = "cancelled"
                    _flight.record("cancel_reap", req.id, phase="queued")
                    _flight.finish(req.id, "cancelled", ok=False)
                    req.out_queue.put(None)
                    continue
                if not self._free:
                    break
                ids = self._resume_ctx.get(req.id, req.prompt_ids)
                pick = 0
                if self.paged:
                    # the best group's headroom gates (FCFS head-of-line
                    # blocking); the slot comes from a group that holds it
                    pick = self._free_slot_for(
                        -(-(len(ids) + 1) // self.page_size))
                    if pick is None:
                        break
                self._queue.popleft()
                self.metrics.queue_depth.set(len(self._queue))
                isolated = not batch and not self._queue
            if not req.t_prefill_start:
                req.t_prefill_start = time.monotonic()
            slot = self._free[pick]
            del self._free[pick]
            if self.paged:
                prep = self._paged_admit(req, slot, isolated)
                if prep is None:
                    # the pages the gate counted are gone (an allocation
                    # refused, chaos's page_exhaustion): the slot goes back
                    # where it was, the request to the queue's head, and
                    # admission stops for this step
                    self._free.insert(pick, slot)
                    with self._lock:
                        self._queue.appendleft(req)
                        self.metrics.queue_depth.set(len(self._queue))
                    break
                ids, off, resumed = prep
                # a hit or a resume walks the chunk program from the reuse
                # offset; with a dispatch in flight every admission takes
                # the walk, whose mixed dispatches ride the pipeline, where
                # a batch prefill would activate a slot under the carry
                if (off > 0 or resumed or self._should_chunk(len(ids))
                        or (self._ragged_on() and self._inflight is not None)):
                    chunk_next = (req, slot, ids, resumed, off)
                    break
                batch.append((req, slot))
                continue
            # consulted before the slot's own tokens are cleared: a request
            # may match the slot it just got back (its rows in place)
            pref = self._find_prefix(req, slot) if isolated else None
            # this round overwrites the slot's rows: they stop being a
            # source at once
            self._slot_tokens[slot] = ()
            self._seq_counter += 1
            self._admit_seq[slot] = self._seq_counter
            if pref is not None:
                chunk_next = (req, slot, list(ids), False, pref[1], pref[0])
                break
            if self._should_chunk(len(ids)):
                chunk_next = (req, slot, list(ids), False)
                break
            batch.append((req, slot))
        return batch, chunk_next

    # -- the prefix cache ---------------------------------------------------

    def _find_prefix(self, req: Request, slot: int):
        """Dense: the longest prefix of ``req``'s prompt whose rows a slot
        still holds, as (source slot, n), or None. The reuse stops one token
        short of the prompt (its last token must run to give the first
        sampled one); ``slot`` is the slot just assigned (a match there
        needs no copy). A request that asks for its prompt's logprobs
        matches nothing: a reused row skips the prefill that computes
        them."""
        if not self.serving.prefix_cache or req.prompt_logprobs is not None:
            return None
        ids = req.prompt_ids
        cap = len(ids) - 1
        lidx = self._lora_index(req)
        best_n, best_s = 0, -1
        for s, toks in enumerate(self._slot_tokens):
            if self._slot_lora[s] != lidx:
                continue          # rows projected under another adapter
            m = min(len(toks), cap)
            if m <= best_n:
                continue
            n = 0
            while n < m and toks[n] == ids[n]:
                n += 1
            if n > best_n:
                best_n, best_s = n, s
        if best_n < max(1, self.serving.prefix_cache_min_len):
            return None
        if not self._hit_pays(req, best_s, slot, best_n):
            return None
        return best_s, best_n

    def _hit_pays(self, req: Request, src: int, slot: int, n: int) -> bool:
        """Dense: a hit costs a copy dispatch (none from the request's own
        slot) and the suffix's chunks, a miss one bucket dispatch (or the
        chunks of a prompt that chunks anyway); a hit that adds dispatches
        must reuse ``prefix_cache_payback_rows`` rows."""
        C = self._chunk_size
        ln = len(req.prompt_ids)
        hit_disp = (0 if src == slot else 1) + max(1, -(-(ln - n) // C))
        miss_disp = -(-ln // C) if self._should_chunk(ln) else 1
        if hit_disp <= miss_disp:
            return True
        return n >= max(1, self.serving.prefix_cache_payback_rows)

    def _paged_admit(self, req: Request, slot: int, isolated: bool):
        """Give an admitted request its pages: the resident pages of its
        longest indexed prefix (retained, shared), fresh pages for the rest,
        and a restore from the host tier into the first fresh pages where
        the chain continues there. Returns (ids, reuse offset, resumed),
        or None when the allocator refuses the fresh pages although the
        admission gate counted them (the retained match is let go again;
        the caller requeues).

        Under a burst (not ``isolated``) the match is dropped unless the
        prompt is a resume or would chunk anyway, or the match (resident
        plus host) spans ``prefix_reuse_min_pages`` pages: a hit forces the
        chunk walk, where the batch prefill would serve the burst at
        once."""
        tier = self.host_tier
        if tier is not None:
            tier.flush_to_host()
        ctx = self._resume_ctx.get(req.id)
        resumed = ctx is not None
        ids = list(ctx) if resumed else list(req.prompt_ids)
        ps = self.page_size
        alloc = self._alloc(slot)
        gbase = self._gbase(slot)
        matched: List[int] = []
        n = 0
        host_keys: List[tuple] = []
        if self.serving.prefix_cache and req.prompt_logprobs is None:
            # a prompt_logprobs request prefills every row (_find_prefix)
            matched, n, host_keys = alloc.lookup_prefix(
                ids, salt=self._lora_salt(self._lora_index(req)))
            # the last token runs through the walk to give the first sample
            while host_keys and n + len(host_keys) * ps > len(ids) - 1:
                host_keys.pop()
            while n > len(ids) - 1:
                matched.pop()
                n -= ps
            if not (isolated or resumed
                    or self._should_chunk(len(req.prompt_ids))
                    or n + len(host_keys) * ps
                    >= ps * max(1, self.serving.prefix_reuse_min_pages)):
                matched, n, host_keys = [], 0, []
        restore = self._host_entries(ids, n, host_keys)
        # queue the payloads' copies to the device before the allocation
        # below, whose spills may refill their host slots (the restore's
        # device time runs from here)
        mark = self._busy.start() if restore else None
        staged = pkv.upload_pages(restore, self.device) if restore else None
        for pid in matched:
            alloc.retain(pid)
        need = -(-len(ids) // ps) - len(matched)
        # the admission gate counted free and evictable pages for the whole
        # sequence; retaining the match takes at most len(matched) of them
        fresh = alloc.alloc(need) if need > 0 else []
        if fresh is None:
            alloc.release_all(matched)
            return None
        # gather what this allocation reclaimed before the restore or the
        # walk can overwrite it: stream order does the rest
        self._spill_reclaimed()
        self._resume_ctx.pop(req.id, None)
        pages = matched + list(fresh)
        self._slot_pages[slot] = pages
        self.table[slot, :] = gbase
        self.table[slot, :len(pages)] = np.asarray(pages, np.int32) + gbase
        self._op_dirty_table = True
        self._seq_counter += 1
        self._admit_seq[slot] = self._seq_counter
        off = n
        if restore:
            # the restored span starts at the first fresh page
            self._schedule_restore(slot, [p + gbase for p in
                                          fresh[:len(restore)]], staged,
                                   mark)
            off = n + len(restore) * ps
        if off > 0:
            self.counts["prefix_cache_hits"] += 1
            self.counts["prefix_tokens_reused"] += off
            self.metrics.prefix_cache_hits.inc()
            self.metrics.prefix_tokens_reused.inc(off)
        tier_hit = "host" if restore else "hbm" if n > 0 else "miss"
        self.counts["prefix_tier_hits_" + tier_hit] += 1
        self.metrics.prefix_tier_hits.inc(tier=tier_hit)
        self._pages_gauges()
        return ids, off, resumed

    def _host_entries(self, ids: List[int], n: int,
                      host_keys: List[tuple]) -> List[dict]:
        """Fetch and verify the host-tier payloads that extend a resident
        match, in chain order; the first that fails verification (it is
        dropped, counted in ``kv_restore_dropped``) ends the extension, and
        the walk prefills from there."""
        tier = self.host_tier
        if tier is None or not host_keys:
            return []
        ch = _chaos.get()
        if ch.enabled:
            # an armed kv_offload_error corrupts the entries' payloads here
            ch.on_kv_restore(tier, host_keys)
        ps = self.page_size
        p0 = n // ps
        entries: List[dict] = []
        for i, key in enumerate(host_keys):
            toks = tuple(ids[(p0 + i) * ps:(p0 + i + 1) * ps])
            data = tier.fetch(key, toks, self._page_shapes)
            if data is None:
                self.counts["kv_restore_dropped"] += 1
                self.metrics.kv_restore_dropped.inc()
                break
            entries.append(data)
        return entries

    def _schedule_restore(self, slot: int, pids: List[int], staged: dict,
                          mark: tuple):
        """Queue the restore of host payloads, already copied to the device
        (``staged``, :func:`paged_kv.upload_pages`), into the slot's fresh
        pages (global ids): one ``index_copy_`` a pool leaf, in place (the
        decode graphs captured the pool's storage). Stream order puts it
        ahead of every later dispatch; nothing waits here. Its device time,
        from ``mark`` (before the upload), is booked as ``kv_restore`` when
        the engine next waits for a dispatch."""
        pkv.restore_pages(self.cache, pids, staged)
        self._busy.stop(mark, "kv_restore",
                        tokens=len(pids) * self.page_size)
        nbytes = len(pids) * self._page_bytes
        self.host_tier.note_restored(len(pids), nbytes)
        self._restore_pending[slot] = nbytes

    def _settle_restore(self, slot: int):
        """Before the slot's first suffix chunk: count a restore queued for
        it and let go of the finished spills' device buffers (no wait: the
        stream orders the restore ahead of the chunk)."""
        nbytes = self._restore_pending.pop(slot, None)
        if nbytes is None:
            return
        self.counts["kv_restore_bytes"] += nbytes
        self.metrics.kv_restore_bytes.inc(nbytes)
        self.host_tier.flush_to_host()

    def _spill_reclaimed(self):
        """Move the pool's reclaim log into the host tier: one gather a
        leaf, queued right after the allocation that reclaimed the pages,
        and the copies into the tier's host slots behind it; nothing waits
        here."""
        tier = self.host_tier
        if tier is None:
            return
        for g, alloc in enumerate(self.allocators):
            log = alloc.evicted_log
            if not log:
                continue
            alloc.evicted_log = []
            base = g * self._group_pages
            tier.spill(log, pkv.gather_pages(
                self.cache, [pid + base for pid, _, _ in log]),
                self._page_bytes)
            self.counts["kv_spill_bytes"] += len(log) * self._page_bytes
            self.metrics.kv_spill_bytes.inc(len(log) * self._page_bytes)

    def _index_prompt_pages(self, slot: int, ids: List[int],
                            n_valid: Optional[int] = None):
        """Index the slot's full pages over ``ids`` in the pool's chain, so
        that later prompts (and resumes) share them. ``n_valid`` caps it to
        pages whose rows are all written: at a finish or a preemption the
        last token's row is not (the next dispatch writes it), and a
        dispatch still in flight writes a finished slot's garbage rows from
        there on through its stale table."""
        if not self.serving.prefix_cache:
            return
        ps = self.page_size
        pages = self._slot_pages[slot]
        n_valid = len(ids) if n_valid is None else n_valid
        key = self._lora_salt(self.lora_idx[slot])
        for p in range(min(n_valid // ps, len(pages))):
            key = self._alloc(slot).index_page(pages[p], key,
                                            tuple(ids[p * ps:(p + 1) * ps]))

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _lora_dev(self, idx: np.ndarray) -> Optional[torch.Tensor]:
        """Adapter indices on the device; None without adapters, which the
        programs take as no LoRA."""
        return self._dev(idx) if self.lora_names else None

    def _fill_allow(self, aw: np.ndarray, i: int, req: Request) -> None:
        """Row ``i`` of int32 allow words from the request's cursor (the
        uint32 words' bits); a grammar over a smaller vocabulary pads with
        zero bits, so no token past its tokenizer is ever drawn. The
        cursor's mask time goes to ``counts["allow_mask_ns"]``."""
        t0 = time.perf_counter_ns()
        words = req.guided.mask_words()
        self.counts["allow_mask_ns"] += time.perf_counter_ns() - t0
        aw[i, :] = 0
        aw[i, :len(words)] = words.view(np.int32)

    def _allow_row(self, req: Request) -> Optional[torch.Tensor]:
        """[1, ceil(V/32)] device allow words of a guided request (None when
        it is unguided), cached in one entry by (request, cursor
        fingerprint): the dispatches of a guided request's chunk walk reuse
        one upload (its cursor does not move before the walk ends)."""
        if req.guided is None:
            return None
        key = (req.id, req.guided.fingerprint())
        if self._allow_dev is not None and self._allow_dev[0] == key:
            self.counts["allow_words_hits"] += 1
            return self._allow_dev[1]
        t0 = time.perf_counter_ns()
        row = np.zeros((1, (self.cfg.vocab_size + 31) // 32), np.int32)
        self._fill_allow(row, 0, req)
        arr = torch.empty(row.shape, dtype=torch.int32, device=self.device)
        self._upload(arr, row)
        self.counts["allow_host_ns"] += time.perf_counter_ns() - t0
        self._allow_dev = (key, arr)
        return arr

    def _guided_slots(self, active: List[int]) -> frozenset:
        return frozenset(s for s in active
                         if self.slot_req[s] is not None
                         and self.slot_req[s].guided is not None)

    def _allow_words(self, gslots) -> bool:
        """Bring the decode operand's allow words (``decoder.allow``) in
        line with the guided slots' cursors, all ones elsewhere; returns
        whether a slot is guided. Only the rows that changed are written:
        those of a guided slot whose (request, cursor fingerprint) moved,
        and back to all ones those of a slot no longer guided; all of them
        in one upload of [G, 1 + ceil(V/32)] int32 (the row's slot, then
        its words) and one ``index_copy_``. With no row to write, a guided
        batch counts a hit in ``counts["allow_words_hits"]``."""
        key = {s: (self.slot_req[s].id, self.slot_req[s].guided.fingerprint())
               for s in gslots}
        rows = sorted([s for s, k in key.items()
                       if self._allow_key.get(s) != k]
                      + [s for s in self._allow_key if s not in key])
        self._allow_key = key
        if not rows:
            if key:
                self.counts["allow_words_hits"] += 1
            return bool(key)
        t0 = time.perf_counter_ns()
        aw = np.full((len(rows), 1 + self.decoder.allow.shape[1]), -1,
                     np.int32)
        aw[:, 0] = rows
        for i, s in enumerate(rows):
            if s in key:
                self._fill_allow(aw[:, 1:], i, self.slot_req[s])
        buf = torch.empty(aw.shape, dtype=torch.int32, device=self.device)
        self._upload(buf, aw)
        self.decoder.allow.index_copy_(0, buf[:, 0].long(), buf[:, 1:])
        self.counts["allow_host_ns"] += time.perf_counter_ns() - t0
        return bool(key)

    def _table_dev(self) -> Optional[torch.Tensor]:
        """The block table on the device; None for the dense cache, which
        the programs take as the dense path."""
        return self._dev(self.table) if self.paged else None

    def _upload(self, dst: torch.Tensor, arr: np.ndarray) -> None:
        """Copy a host mirror into a device buffer without waiting for the
        stream: on a CUDA device through a fresh pinned buffer and a
        non_blocking copy (the pinned allocator does not reuse the buffer
        until the copy has run, so the mirror may change at once; a pageable
        copy would wait for the dispatch in flight)."""
        src = torch.from_numpy(np.ascontiguousarray(arr))
        if dst.is_cuda:
            src = src.pin_memory()
        dst.copy_(src, non_blocking=True)

    def _stage(self, *tensors) -> tuple:
        """Host copies of a dispatch's outputs and the event to fetch them
        by: on a CUDA device pinned buffers filled by non_blocking copies
        queued right behind the dispatch, then an event, so that the fetch
        waits for this dispatch alone and not for the one queued after it
        (which also overwrites a graph's outputs); on the CPU the tensors
        themselves and no event."""
        if not tensors[0].is_cuda:
            return tensors, None
        host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                     for t in tensors)
        for h, t in zip(host, tensors):
            h.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def _stage_groups(self, *groups) -> tuple:
        """:meth:`_stage` over groups of tensors (a dispatch's tokens, its
        logprob records): (the host groups, each a tuple or None when
        empty, the event)."""
        host, event = self._stage(*(t for g in groups for t in g))
        out, i = [], 0
        for g in groups:
            out.append(tuple(host[i:i + len(g)]) or None)
            i += len(g)
        return out, event

    def _prefill_batch(self, batch):
        """One batch prefill of fresh prompts: each row's ban and bias rows
        filled first, its repetition penalty over its prompt, its first
        token's logprobs and its prompt's when asked; then each request
        activates."""
        N = len(batch)
        T = self._bucket_for(max(len(r.prompt_ids) for r, _ in batch))
        tokens = np.zeros((N, T), np.int32)
        true_lens = np.zeros(N, np.int32)
        for i, (req, _) in enumerate(batch):
            tokens[i, :len(req.prompt_ids)] = req.prompt_ids
            true_lens[i] = len(req.prompt_ids)
        slots = [s for _, s in batch]
        slots_np = np.array(slots, np.int32)
        for req, slot in batch:
            self._fill_sampling_rows(req, slot)
        reps = np.array([r.repetition_penalty or 1.0 for r, _ in batch],
                        np.float32)
        allow = None
        if any(r.guided is not None for r, _ in batch):
            aw = np.full((N, (self.cfg.vocab_size + 31) // 32), -1, np.int32)
            for i, (req, _) in enumerate(batch):
                if req.guided is not None:
                    self._fill_allow(aw, i, req)
            allow = self._dev(aw)
        want_lp = any(r.logprobs is not None for r, _ in batch)
        n_plp = max((len(r.prompt_ids) for r, _ in batch
                     if r.prompt_logprobs is not None), default=0)
        mark = self._busy.start()
        out = prefill_batch_step(
            self.model, self.cache, self._dev(tokens), self._dev(true_lens),
            self._dev(self.table[slots]) if self.paged else None,
            self._dev(np.array([r.temperature for r, _ in batch], np.float32)),
            self._dev(np.array([r.top_k for r, _ in batch], np.int32)),
            self._dev(np.array([r.top_p for r, _ in batch], np.float32)),
            self._dev(np.array([r.eff_seed for r, _ in batch], np.int64)),
            slots=None if self.paged else self._dev(slots_np),
            ban_ids=self._dev(self.ban_ids[slots]),
            ban_until=self._dev(self.ban_until[slots]),
            bias_ids=self._dev(self.bias_ids[slots]),
            bias_vals=self._dev(self.bias_vals[slots]),
            reps=self._dev(reps) if (reps != 1.0).any() else None,
            allow=allow, lora_idx=self._lora_dev(self.lora_idx[slots]),
            logprobs=want_lp, prompt_logprobs=n_plp, row_slots=slots_np)
        busy = self._busy.stop(mark)
        self.cache, toks = out[0], out[1].cpu().numpy()
        lp_t = tuple(a.cpu().numpy() for a in out[2]) if want_lp else None
        plp_t = tuple(a.cpu().numpy() for a in out[-1]) if n_plp else None
        # a batch of one is the JAX engine's prefill program
        self._book_busy("prefill" if N == 1 else "prefill_batch",
                        self._busy.settle(busy),
                        {"batch": N, "tokens": int(true_lens.sum())})
        self.counts["prefill_dispatches"] += 1
        if self.draft is not None:
            self.draft.prefill(tokens, true_lens, slots_np)
        for i, (req, slot) in enumerate(batch):
            lp = _host_lp(lp_t, i, req.logprobs) \
                if req.logprobs is not None else None
            if req.prompt_logprobs is not None:
                _host_prompt_lp(req, plp_t, i)
            self._activate(req, slot, int(toks[i]), req.prompt_ids, False,
                           lp)

    def _start_chunk(self, req: Request, slot: int, ids: List[int],
                     resumed: bool, off: int = 0, src: Optional[int] = None):
        """Begin the chunk walk of ``ids`` into ``slot`` at row ``off``: the
        paged engine's reused pages are in the slot's table (a restore into
        them already queued); the dense engine first copies rows [0, off)
        from slot ``src``'s prompt (none when ``src`` is the slot itself)."""
        if self.paged:
            self._settle_restore(slot)
        elif off:
            if src != slot:
                mark = self._busy.start()
                kvc.copy_prefix(self.cache, src, slot, off)
                self._busy.stop(mark, "prefix_copy", tokens=off)
            self.counts["prefix_cache_hits"] += 1
            self.counts["prefix_tokens_reused"] += off
            self.metrics.prefix_cache_hits.inc()
            self.metrics.prefix_tokens_reused.inc(off)
        self.lengths[slot] = off
        if not self.paged:
            # the dense walk rewrites the slot's length out of band of any
            # device carry; the paged walk's mixed dispatches set the
            # slot's carry lanes themselves
            self._carry_gen += 1
        if self.draft is not None:
            # the draft has no chunk walk; the slot serves the plain path
            self.draft.mark_stale(slot)
        # the walk's draws honour the request's ban and bias rows, and its
        # final chunk's the repetition penalty over the whole context it
        # has written ([V] bool on the device, uploaded once)
        self._fill_sampling_rows(req, slot)
        rep = float(req.repetition_penalty or 1.0)
        seen = None
        if rep != 1.0:
            idx = torch.empty(len(ids), dtype=torch.int64, device=self.device)
            self._upload(idx, np.asarray(ids, np.int64))
            seen = torch.zeros(self.cfg.vocab_size, dtype=torch.bool,
                               device=self.device).index_fill_(0, idx, True)
        self._chunk = {"req": req, "slot": slot, "ids": ids, "off": off,
                       "resumed": resumed, "rep": rep, "rep_seen": seen}

    def _advance_chunk(self):
        """The walk's next chunk: one mixed dispatch packing it beside a
        decode step of every active slot (paged), or one
        ``prefill_chunk_step`` (dense; the decode steps alternate with the
        chunks, see :meth:`step`)."""
        st = self._chunk
        req, slot, ids, off = st["req"], st["slot"], st["ids"], st["off"]
        if req.cancelled:
            self._end_walk("cancelled")
            return
        C = self._chunk_size
        chunk = ids[off:off + C]
        if not self.paged:
            self._advance_chunk_dense(st, chunk, C)
            return
        self._advance_chunk_mixed(st, chunk, C)

    def _end_walk(self, reason: str):
        """Tear down the chunk walk before its request activates (a cancel
        or an expired deadline): settle a mixed dispatch in flight before
        the slot's pages go, release the slot, finish the request with
        ``reason``."""
        self._drain_decode_pipeline("chunk")
        st, self._chunk = self._chunk, None
        self._release_slot(st["slot"])
        req = st["req"]
        req.finish_reason = reason
        self.metrics.mark_request(reason, time.monotonic() - req.t_submit)
        if reason == "timeout":
            _flight.record("deadline_reap", req.id, slot=st["slot"],
                           phase="prefill_chunk")
        else:
            _flight.record("cancel_reap", req.id, phase="prefill_chunk")
        _flight.finish(req.id, reason, ok=False)
        req.out_queue.put(None)

    def _advance_chunk_mixed(self, st: dict, chunk: List[int], C: int):
        """One mixed dispatch (the JAX engine's ``_advance_chunk_mixed``).
        A non-final chunk's dispatch rides the pipeline like a decode
        dispatch (with ``decode_pipeline=0`` it settles at once); the final
        chunk settles its predecessor and itself, since its token activates
        the slot. On a failure the walk's slot is
        released here, exactly once, before the error propagates."""
        req, slot, ids, off = st["req"], st["slot"], st["ids"], st["off"]
        final = off + len(chunk) >= len(ids)
        _flight.record("prefill_chunk", req.id, off=off, n=len(chunk),
                       mixed=True)
        prev = self._inflight
        if prev is not None and not self._carry_valid():
            self._drain_decode_pipeline("prefill")
            prev = None
        # page headroom for the decode rows' writes (those of the dispatch
        # in flight first); the chunking slot is not active, so it is never
        # the one preempted here
        self._ensure_pages(1 + (prev["horizon"] if prev is not None else 0))
        if prev is not None and not self._carry_valid():
            self._drain_decode_pipeline("prefill")      # a preemption
            prev = None
        if prev is not None and self._guided_slots(self._active_slots()):
            # a guided decode row's mask comes from its cursor, which moves
            # when the tokens in flight are emitted: settle them first (the
            # carry stays); the chunking request's own cursor does not move
            # before its walk ends
            self._settle_inflight()
            prev = None
        try:
            rec = self._mixed_dispatch(st, chunk, C)
            st["off"] = off + len(chunk)
            self.lengths[slot] = st["off"]
            if not final and self._ragged_on():
                self._inflight = rec
                if prev is not None:
                    self._decode_fetch(prev)
                return
            self._pipe_carry = None
            if prev is not None:
                self._inflight = None
                self._decode_fetch(prev)
            self._decode_fetch(rec)
        except Exception:
            self._chunk = None
            self._release_slot(slot)
            req.finish_reason = "error"
            self.metrics.mark_request("error", 0.0)
            _flight.finish(req.id, "error", ok=False, phase="prefill_chunk")
            req.out_queue.put(None)
            raise
        if final:
            self._chunk = None
            self._activate(req, slot, rec["chunk_token"], ids,
                           st["resumed"], rec.get("chunk_lp"))

    def _mixed_dispatch(self, st: dict, chunk: List[int], C: int) -> dict:
        """Queue one ``mixed_step`` on the device operands (the carry of the
        dispatch in flight included) and return its record; the chunking
        slot's carry lanes take the chunk's token and its new frontier. The
        decode rows take the penalties and logprobs variants as a decode
        dispatch would; the final chunk of a fresh request computes its
        token's logprobs and, when the chunk holds the whole prompt, its
        prompt's."""
        req, slot, off = st["req"], st["slot"], st["off"]
        d = self.decoder
        self._decode_operands()
        active = self._active_slots()
        ptokens = np.zeros((1, C), np.int32)
        ptokens[0, :len(chunk)] = chunk
        pdev = torch.empty((1, C), dtype=torch.int32, device=self.device)
        self._upload(pdev, ptokens)
        fresh_final = not st["resumed"] and off + len(chunk) >= len(st["ids"])
        want_lp, want_pen = self._want_lp(), self._want_pen()
        chunk_lp = req.logprobs is not None and fresh_final
        chunk_plp = len(chunk) if (req.prompt_logprobs is not None
                                   and fresh_final and off == 0) else 0
        pen = dict(counts=d.counts, presence=d.presence,
                   frequency=d.frequency, repetition=d.repetition,
                   prompt_mask=d.prompt_mask) if want_pen else {}
        gset = self._guided_slots(active)
        guided = self._allow_words(gset)
        mark = self._dispatch_mark()
        res = mixed_step(
            self.model, self.cache, d.tokens, d.lengths, pdev, slot, off,
            len(chunk), d.table, d.temps, d.top_ks, d.top_ps, d.seeds,
            req.temperature, req.top_k, req.top_p, req.eff_seed,
            any_sampled=bool((self.temps > 0).any()), ban_ids=d.ban_ids,
            ban_until=d.ban_until, bias_ids=d.bias_ids,
            bias_vals=d.bias_vals, prep=st["rep"], prep_seen=st["rep_seen"],
            allow=d.allow if guided else None, pallow=self._allow_row(req),
            lora_idx=d.lora_idx, logprobs=want_lp, chunk_logprobs=chunk_lp,
            chunk_prompt_logprobs=chunk_plp, **pen)
        self.cache, out, ptok = res[:3]
        lp = plp = clp = ()
        if want_lp:
            out, lp = out
        if chunk_lp:
            ptok, clp = ptok
        if chunk_plp:
            plp = res[3]
        is_p = torch.arange(self.num_slots, device=self.device) == slot
        tok = torch.where(is_p, ptok, out[0])
        lens = torch.where(is_p, torch.full_like(d.lengths, off + len(chunk)),
                           d.lengths + 1)
        d.tokens.copy_(tok)
        d.lengths.copy_(lens)
        busy = self._busy.stop(mark)
        (out, ptok, lp, clp, plp), event = self._stage_groups(
            (out,), (ptok,), lp, clp, plp)
        self._last_dispatch = rec = {
            "mixed": True, "out": out[0], "pout": ptok[0], "lp": lp,
            "chunk_lp_t": clp, "chunk_plp_t": plp, "chunk_req": req,
            "event": event, "busy": busy, "horizon": 1, "active": active,
            "gset": gset, "chunk_n": len(chunk),
            "reqs": [self.slot_req[s] for s in active]}
        self._pipe_carry = self._carry_gen
        self.counts["mixed_dispatches"] += 1
        self.counts["pipeline_dispatches"] += 1
        _metrics.pipeline.dispatches.inc()
        _flight.record("pipeline_dispatch", None, horizon=1,
                       batch=len(active), mixed=True)
        rec["t0"] = time.monotonic()
        return rec

    def _dispatch_mark(self) -> tuple:
        """Before a decode or mixed dispatch is queued: book the host
        bubble since a fetch left the device idle with nothing queued (the
        JAX engine's ``decode_bubble_seconds``) and start the dispatch's
        device time."""
        t0 = time.monotonic()
        if self._last_ready > 0.0:
            self.metrics.decode_bubble_seconds.inc(
                max(0.0, t0 - self._last_ready))
            self._last_ready = 0.0
        return self._busy.start()

    def _advance_chunk_dense(self, st: dict, chunk: List[int], C: int):
        """One chunk of the dense walk into rows [off, off + len(chunk)) of
        its slot; the slot's length follows the walk's frontier, where the
        interleaved decode dispatches write their garbage row for it (the
        next chunk overwrites it). The final chunk's token is the request's
        first. A dispatch in flight is drained first: the chunk rewrites
        the slot's state under its carry."""
        if self._inflight is not None:
            self._drain_decode_pipeline("chunk")
        req, slot, ids, off = st["req"], st["slot"], st["ids"], st["off"]
        _flight.record("prefill_chunk", req.id, off=off, n=len(chunk))
        ptokens = np.zeros((1, C), np.int32)
        ptokens[0, :len(chunk)] = chunk
        final = off + len(chunk) >= len(ids)
        want_lp = req.logprobs is not None and not st["resumed"] and final
        rows = slice(slot, slot + 1)
        mark = self._busy.start()
        out = prefill_chunk_step(
            self.model, self.cache, self._dev(ptokens), off, slot,
            len(chunk), self._dev(np.array([req.temperature], np.float32)),
            self._dev(np.array([req.top_k], np.int32)),
            self._dev(np.array([req.top_p], np.float32)),
            self._dev(np.array([req.eff_seed], np.int64)),
            ban_ids=self._dev(self.ban_ids[rows]),
            ban_until=self._dev(self.ban_until[rows]),
            bias_ids=self._dev(self.bias_ids[rows]),
            bias_vals=self._dev(self.bias_vals[rows]), rep=st["rep"],
            rep_seen=st["rep_seen"], allow=self._allow_row(req),
            lora_idx=self._lora_dev(self.lora_idx[rows]), logprobs=want_lp)
        busy = self._busy.stop(mark)
        self.cache, tok = out[0], int(out[1].cpu()[0])
        self._book_busy("prefill_chunk", self._busy.settle(busy),
                        {"tokens": len(chunk)})
        lp = _host_lp(tuple(a.cpu().numpy() for a in out[2]), 0,
                      req.logprobs) if want_lp else None
        self.counts["chunk_dispatches"] += 1
        st["off"] = off + len(chunk)
        self.lengths[slot] = st["off"]
        if final:
            self._chunk = None
            self._activate(req, slot, tok, ids, st["resumed"], lp)

    # -- the decode pipeline ------------------------------------------------

    def _pipeline_on(self) -> bool:
        """May a decode dispatch be left in flight after this step? Not
        during the dense chunk walk (its horizon-1 decodes alternate with
        synchronous chunks), not under an sp mesh, not with
        ``decode_pipeline=0``."""
        return (self.serving.decode_pipeline > 0 and self.sp == 1
                and self._chunk is None)

    def _ragged_on(self) -> bool:
        """May the paged chunk walk leave its mixed dispatches in flight
        (and admissions take the walk under a dispatch in flight)? Not
        under dp > 1, as the JAX engine turns its ragged dispatch off there:
        the walk's dispatches settle at once."""
        return (self.paged and self.serving.decode_pipeline > 0
                and self.dp == 1)

    def _carry_valid(self) -> bool:
        """Whether the operand buffers' token/length carry (the dispatch in
        flight's, or the last one's) still describes the batch: no slot was
        activated, preempted or rewritten since it was queued."""
        return self._pipe_carry is not None \
            and self._pipe_carry == self._carry_gen

    def _drain_decode_pipeline(self, reason: str = "drain") -> None:
        """Fetch and emit the dispatch in flight, if any, and drop the
        device carry (the next dispatch copies the mirrors in). Counted in
        ``counts["pipeline_drains_<reason>"]`` (prefill, chunk, spec, drain,
        fail)."""
        rec = self._inflight
        if rec is None:
            return
        self._count_drain(reason)
        self._inflight = None
        self._pipe_carry = None
        self._decode_fetch(rec)

    def _count_drain(self, reason: str) -> None:
        self.counts[f"pipeline_drains_{reason}"] += 1
        _metrics.pipeline.drains.inc(reason=reason)

    def _settle_inflight(self) -> None:
        """Fetch and emit the dispatch in flight, counting no drain and
        keeping the device carry: a finish does not bump ``_carry_gen``, so
        the next dispatch still feeds on the carry (before a verify, whose
        proposer reads the host mirrors)."""
        rec = self._inflight
        if rec is None:
            return
        self._inflight = None
        self._decode_fetch(rec)

    def _decode_operands(self) -> None:
        """Bring the device operands up to date: the sampling rows and the
        block table when their mirrors changed (dirty flags), the token and
        length carry when it no longer describes the batch."""
        d = self.decoder
        if self._op_dirty_sampling:
            for dst, arr in ((d.temps, self.temps), (d.top_ks, self.top_ks),
                             (d.top_ps, self.top_ps), (d.seeds, self.seeds),
                             (d.ban_ids, self.ban_ids),
                             (d.ban_until, self.ban_until),
                             (d.bias_ids, self.bias_ids),
                             (d.bias_vals, self.bias_vals),
                             (d.presence, self.pres_pens),
                             (d.frequency, self.freq_pens),
                             (d.repetition, self.rep_pens)):
                self._upload(dst, arr)
            if d.lora_idx is not None:
                self._upload(d.lora_idx, self.lora_idx)
            self._op_dirty_sampling = False
        if self.paged and self._op_dirty_table:
            self._upload(d.table, self.table)
            self._op_dirty_table = False
        if not self._carry_valid():
            self._upload(d.tokens, self.last_token)
            self._upload(d.lengths, self.lengths)

    def _decode(self, max_horizon: Optional[int] = None,
                fair_horizon: bool = False):
        """One decode dispatch of every slot (``max_horizon`` caps its
        horizon: 1 between the dense walk's chunks; ``fair_horizon``, the
        fairness floor's dispatch, takes the full horizon although a prompt
        could prefill next), or a verify dispatch when speculation proposes
        drafts; with the pipeline on, the new dispatch is left in flight and
        its predecessor fetched. Ends the prefill streak. An armed
        ``stalled_decode`` fault (``serving/chaos.py``) wedges the step here
        until the watchdog's abort flag (``_stall_abort``) fails it."""
        ch = _chaos.get()
        if ch.enabled:
            ch.on_decode_step(self)
        self._prefill_streak = 0
        prev = self._inflight
        if prev is not None and not self._carry_valid():
            # a slot changed under the dispatch in flight: fetch it first,
            # then dispatch from the refreshed mirrors
            self._drain_decode_pipeline("prefill")
            prev = None
        with self._lock:
            waiting = bool(self._queue)
        horizon = 1 if (waiting and self._free and not fair_horizon) \
            else max(1, self.serving.decode_horizon)
        if max_horizon is not None:
            horizon = min(horizon, max_horizon)
        spec, K = self.spec_decode, self.serving.spec_k
        if self.draft is not None:
            # one plain dispatch must fit one catch-up dispatch of K + 1 rows
            horizon = min(horizon, K + 1)
        # pages for every row this dispatch may write, the verify's K + 1
        # included, beyond the rows of the dispatch in flight
        grow = max(horizon, K + 1 if spec else 1)
        if prev is not None:
            grow += prev["horizon"]
        if not self._ensure_pages(grow):
            return
        if prev is not None and not self._carry_valid():
            self._drain_decode_pipeline("prefill")      # a preemption
            prev = None
        active = self._active_slots()
        if not active:
            self._drain_decode_pipeline()
            return
        # a verify only when no prompt could prefill next (horizon > 1)
        if spec and horizon > 1 and not self._spec_plain_due:
            if prev is not None:
                # the proposer and the bound below read the host mirrors:
                # settle the dispatch in flight (its carry stays valid)
                self._settle_inflight()
                prev = None
                active = self._active_slots()
                if not active:
                    return
            # it writes K + 1 rows for every slot, so the window bound is
            # global
            if self.lengths[active].max() + K + 1 < self.max_len:
                skip = self._spec_skip(active)
                proposal = self._propose_drafts([s for s in active
                                                 if s not in skip])
                if proposal is not None:
                    self._do_spec_decode(active, *proposal, skip=skip)
                    return
        self._spec_plain_due = False
        gset = self._guided_slots(active)
        if gset and prev is not None:
            # a guided slot's mask comes from its cursor, which moves when
            # the tokens in flight are emitted: settle them first (the carry
            # stays, no drain is counted)
            self._settle_inflight()
            prev = None
            active = self._active_slots()
            if not active:
                return
            gset = self._guided_slots(active)
        if gset and len(gset) == len(active):
            # guided slots alone: one token a dispatch, each under a fresh
            # mask (beside unguided slots the horizon stays, and the guided
            # ones emit substep 0's token only)
            horizon = 1
        rec = self._decode_dispatch(horizon, active, gset)
        if self._pipeline_on():
            self._inflight = rec
            if prev is not None:
                self._decode_fetch(prev)
            return
        self._pipe_carry = None
        if prev is not None:
            self._count_drain("chunk" if self._chunk is not None
                              else "spec" if spec else "drain")
            self._inflight = None
            self._decode_fetch(prev)
        self._decode_fetch(rec)

    def _decode_dispatch(self, horizon: int, active: List[int],
                         gset: frozenset = frozenset()) -> dict:
        """Queue one decode dispatch of ``horizon`` substeps (a graph
        replay on a CUDA device) and return its record; nothing here waits
        for the device. ``gset``: the guided slots, whose cursors' allow
        words the operand takes first."""
        self._decode_operands()
        self._allow_words(gset)
        want_lp, want_pen = self._want_lp(), self._want_pen()
        mark = self._dispatch_mark()
        out = self.decoder.run(horizon, bool((self.temps > 0).any()),
                               want_pen, want_lp)
        lp = ()
        if want_lp:
            out, lp = out
        busy = self._busy.stop(mark)
        (out, lp), event = self._stage_groups((out,), lp)
        self._pipe_carry = self._carry_gen
        self.counts["decode_dispatches"] += 1
        self.counts["decode_substeps"] += horizon
        self.counts["pipeline_dispatches"] += 1
        _metrics.pipeline.dispatches.inc()
        _flight.record("pipeline_dispatch", None, horizon=horizon,
                       batch=len(active))
        self._last_dispatch = rec = {
            "out": out[0], "lp": lp, "event": event, "busy": busy,
            "horizon": horizon, "active": list(active), "gset": gset,
            "want_pen": want_pen, "t0": time.monotonic(),
            "reqs": [self.slot_req[s] for s in active]}
        return rec

    def _decode_fetch(self, rec: dict) -> None:
        """Wait for a dispatch's tokens and emit them: substep by substep,
        to each slot that still serves the request it served when the
        dispatch was queued (a slot that finished since then was decoded as
        garbage; its surplus is discarded). A mixed dispatch's record also
        yields the chunk's token. A guided slot beside unguided ones emits
        substep 0's token only (the later substeps drew under a stale mask):
        its device carry and, when it penalizes, its count row no longer
        describe it, so the carry is invalidated (the next dispatch copies
        the mirrors in) and the count row restored from its stream.

        The wait books the dispatch's device time (``device_busy_seconds``,
        ``decode_step_duration`` a substep, devmon's ``decode`` or
        ``mixed_step``). When nothing is queued behind it (it is the last
        dispatch queued, the JAX fetch's ``tail``), the device goes idle
        here and the next dispatch books the gap as the decode bubble. The armed faults of the JAX fetch
        (``serving/chaos.py``) raise before the wait:
        ``pipeline_fetch_error``, ``ragged_dispatch_error`` on a mixed
        dispatch, ``ragged_feature_error`` (``kind=guided``) on one that
        carried guided rows."""
        ch = _chaos.get()
        if ch.enabled:
            ch.on_pipeline_fetch(self)
            if rec.get("mixed"):
                ch.on_mixed_fetch(self)
            if rec.get("gset"):
                ch.on_feature_path(self, kind="guided")
        if rec["event"] is not None:
            rec["event"].synchronize()
        t_ready = time.monotonic()
        tail = rec is self._last_dispatch
        dev_dt = self._busy.settle(rec["busy"])
        horizon, active = rec["horizon"], rec["active"]
        mixed = bool(rec.get("mixed"))
        self.metrics.device_busy_seconds.inc(dev_dt)
        self.metrics.decode_step_duration.observe(dev_dt / horizon)
        _devmon.note("mixed_step" if mixed else "decode", dev_dt,
                     batch=len(active) + mixed,
                     tokens=horizon * len(active) + rec.get("chunk_n", 0),
                     ctx_rows=float(np.mean(self.lengths[active]))
                     if active else 0.0,
                     steps=horizon, guided_rows=len(rec.get("gset", ())))
        out = rec["out"].numpy()
        lp_t = None if rec["lp"] is None else \
            tuple(a.numpy() for a in rec["lp"])
        if rec.get("mixed"):
            rec["chunk_token"] = int(rec["pout"].numpy()[0])
            req = rec["chunk_req"]
            if rec["chunk_lp_t"] is not None:
                rec["chunk_lp"] = _host_lp(
                    tuple(a.numpy() for a in rec["chunk_lp_t"]), 0,
                    req.logprobs)
            if rec["chunk_plp_t"] is not None:
                _host_prompt_lp(req, tuple(a.numpy()
                                           for a in rec["chunk_plp_t"]), 0)
        emitted = 0
        gset = rec.get("gset", ())
        for s in range(rec["horizon"]):
            for slot, req in zip(rec["active"], rec["reqs"]):
                if self.slot_req[slot] is not req:
                    continue             # finished earlier or since queued
                if s > 0 and slot in gset:
                    continue             # a guided slot's surplus substep
                lp = None
                if req.logprobs is not None and lp_t is not None:
                    lp = _host_lp(tuple(a[s] for a in lp_t), slot,
                                  req.logprobs)
                self.lengths[slot] += 1
                self._emit(slot, int(out[s, slot]), lp)
                emitted += 1
        if gset and rec["horizon"] > 1:
            self._resync_guided(rec)
        if tail and any(r is not None for r in self.slot_req):
            self._last_ready = t_ready
        _flight.record("pipeline_fetch", None, horizon=horizon,
                       emitted=emitted, tail=tail)
        self._note_tokens(rec["t0"], emitted)

    def _resync_guided(self, rec: dict) -> None:
        """After a dispatch of horizon > 1 whose guided slots emitted one
        token each: the carry's lanes of a guided slot still serving its
        request hold the discarded substeps' token and length (invalidate
        the carry), and a penalized one's count row counted them (restore
        it from the emitted stream)."""
        live = [s for s, r in zip(rec["active"], rec["reqs"])
                if s in rec["gset"] and self.slot_req[s] is r]
        if not live:
            return
        self._carry_gen += 1
        if not rec["want_pen"]:
            return
        d = self.decoder
        for slot in live:
            req = self.slot_req[slot]
            if self.pres_pens[slot] or self.freq_pens[slot] \
                    or self.rep_pens[slot] != 1.0:
                self._upload(d.counts[slot], np.bincount(
                    np.asarray(req.generated, np.int64),
                    minlength=self.cfg.vocab_size).astype(np.int32))

    def _note_tokens(self, t0: float, emitted: int) -> None:
        """The tokens_per_second gauge: tokens emitted by the last 50
        dispatches over the time since the oldest was queued."""
        self._tok_times.append((t0, emitted))
        if len(self._tok_times) >= 2:
            span = time.monotonic() - self._tok_times[0][0]
            if span > 0:
                self.metrics.tokens_per_second.set(
                    sum(n for _, n in self._tok_times) / span)

    # -- speculative decoding -----------------------------------------------

    def _propose_drafts(self, active: List[int]):
        """Drafts for the verify dispatch: the draft model's rollout
        (``spec_method="draft"``), else prompt lookup: the context's
        trailing spec_ngram tokens matched against its last 2048 tokens,
        the rightmost hit proposing the spec_k tokens after it. ``active``
        holds greedy slots only (:meth:`_spec_skip` leaves the sampled ones
        out). Returns (drafts [num_slots, spec_k] int32 zero-padded,
        {slot: real draft count}), or None when nothing was proposed."""
        K = self.serving.spec_k
        if self.draft is not None:
            return self.draft.propose(self, active, K)
        n = self.serving.spec_ngram
        drafts = np.zeros((self.num_slots, K), np.int32)
        proposed = {}
        for slot in active:
            req = self.slot_req[slot]
            ctx = req.prompt_ids + req.generated
            if len(ctx) < n + 2:
                continue
            arr = np.asarray(ctx[-2048:], np.int32)
            win = np.lib.stride_tricks.sliding_window_view(arr[:-1], n)
            hits = np.nonzero((win == arr[-n:]).all(axis=1))[0]
            if hits.size == 0:
                continue
            cont = arr[int(hits[-1]) + n:][:K]
            if cont.size == 0:
                continue
            drafts[slot, :cont.size] = cont
            proposed[slot] = int(cont.size)
        return (drafts, proposed) if proposed else None

    def _spec_skip(self, active: List[int]) -> set:
        """Slots a verify dispatch serves no token. The sampled ones take
        every token from the plain step, so a seeded stream is the same
        with speculation on or off: in bf16 the verify's R-row forward
        rounds apart from the one-row decode, enough to flip a near-tie of
        the draw (the JAX engine draws them from the verify's row 0; ROADMAP
        C9). The JAX engine's ineligible slots (``_slot_spec_ineligible``)
        need what only the plain step does: logprobs, a live penalty, a
        live min_tokens ban, a logit bias, a grammar (its mask needs the
        host's cursor between every two tokens)."""
        return {s for s in active
                if self.slot_req[s].temperature > 0.0
                or self.slot_req[s].logprobs is not None
                or self.slot_req[s].guided is not None
                or self.pres_pens[s] or self.freq_pens[s]
                or self.rep_pens[s] != 1.0
                or self.ban_until[s] > self.lengths[s]
                or self._bias_n[s] > 0}

    def _do_spec_decode(self, active: List[int], drafts: np.ndarray,
                        proposed: dict, skip=frozenset()):
        """One verify dispatch: up to spec_k + 1 tokens per slot. ``skip``
        slots take part (their surplus rows lie past their length) but emit
        nothing; the next dispatch is then a plain one. The accepted count
        is clamped to each slot's real draft count (a zero-padded draft can
        match the model's argmax)."""
        R = self.serving.spec_k + 1
        t0 = time.monotonic()
        tokens = np.concatenate([self.last_token[:, None], drafts], axis=1)
        mark = self._busy.start()
        self.cache, out, accepted = spec_decode_step(
            self.model, R, self.cache, self._dev(tokens),
            self._dev(self.lengths), self._table_dev(),
            self._dev(self.temps), self._dev(self.top_ks),
            self._dev(self.top_ps), self._dev(self.seeds),
            lora_idx=self._lora_dev(self.lora_idx))
        busy = self._busy.stop(mark)
        ch = _chaos.get()
        if ch.enabled:
            # an armed ragged_feature_error (kind=spec) stands in for a
            # corrupted verify row: nothing has been emitted, and the
            # failure path releases every slot once (_fail_all)
            ch.on_feature_path(self, kind="spec")
        out, accepted = out.cpu().numpy(), accepted.cpu().numpy()
        self._book_busy("spec_decode", self._busy.settle(busy), {
            "batch": len(active), "tokens": R * len(active),
            "ctx_rows": float(np.mean(self.lengths[active]))
            if active else 0.0})
        self.counts["spec_dispatches"] += 1
        m = self.metrics
        total = 0
        for slot in active:
            if slot in skip:
                continue
            acc = int(accepted[slot])
            if slot in proposed:
                n_drafted = proposed[slot]
                n_accepted = min(max(acc - 1, 0), n_drafted)
                self.counts["spec_drafted_tokens"] += n_drafted
                self.counts["spec_accepted_tokens"] += n_accepted
                m.spec_drafted_tokens.inc(n_drafted)
                m.spec_accepted_tokens.inc(n_accepted)
                m.spec_acceptance_rate.set(m.spec_accepted_tokens.total()
                                           / max(1.0,
                                                 m.spec_drafted_tokens.total()))
            emitted = 0
            for i in range(acc):
                if self.slot_req[slot] is None:
                    break                    # a stop condition mid-prefix
                self.lengths[slot] += 1
                self._emit(slot, int(out[slot, i]))
                emitted += 1
            if self.draft is not None and slot in proposed:
                self.draft.note_emitted(slot, emitted)
            total += emitted
        self._note_tokens(t0, total)
        self._spec_plain_due = bool(skip)
        # the verify advanced the mirrors on the host: the next dispatch
        # copies them in
        self._pipe_carry = None

    # -- slot lifecycle -----------------------------------------------------

    def _activate(self, req: Request, slot: int, token: int,
                  ids: List[int], resumed: bool, lp=None):
        """Post-prefill bookkeeping. A resume rebuilt the cache of
        prompt + generated: its sampled token is discarded and decode
        continues from the last real token, whose row it rewrites. The
        slot's logit rows take the request's values; a penalized request's
        count row is reset and counts its first token, or (a resume) is
        restored from the tokens generated before the preemption, so that
        the resumed stream is the one without the preemption."""
        # a device carry no longer describes the batch once the slot joins
        self._carry_gen += 1
        self._op_dirty_sampling = True
        now = time.monotonic()
        if not req.t_first_token:            # not again at a resume
            req.t_first_token = now
            self.metrics.ttft.observe(now - req.t_submit,
                                      trace_id=req.trace_id or None)
            _slo.get().observe_ttft(now - req.t_submit)
        _flight.record("admit", req.id, slot=slot, resumed=resumed,
                       queue_wait_s=round(max(0.0, (req.t_prefill_start
                                                    or now) - req.t_submit),
                                          6))
        if not resumed:
            # a resume's context was counted at its first admission
            self.metrics.prompt_tokens.inc(len(ids))
        if self.paged:
            self._index_prompt_pages(slot, ids)
        else:
            self._slot_tokens[slot] = tuple(req.prompt_ids)
            self._slot_lora[slot] = self._lora_index(req)
        self.slot_req[slot] = req
        self.lengths[slot] = len(ids) - 1 if resumed else len(ids)
        self.temps[slot] = req.temperature
        self.top_ks[slot] = req.top_k
        self.top_ps[slot] = req.top_p
        self.seeds[slot] = req.eff_seed
        self._fill_sampling_rows(req, slot)
        self.pres_pens[slot] = req.presence_penalty
        self.freq_pens[slot] = req.frequency_penalty
        self.rep_pens[slot] = req.repetition_penalty or 1.0
        self._penalty_rows(req, slot, token, resumed)
        self.metrics.active_requests.set(len(self._active_slots()))
        if resumed:
            self.last_token[slot] = ids[-1]
        else:
            self._emit(slot, token, lp)

    def _penalty_rows(self, req: Request, slot: int, token: int,
                      resumed: bool):
        """The slot's prompt-mask row (repetition) and count row (any
        penalty) on the device for a penalized request, queued on the
        stream behind every dispatch already queued (no wait): an unpenalized
        occupant leaves them stale, which its neutral rows ignore."""
        d = self.decoder
        rep = (req.repetition_penalty or 1.0) != 1.0
        if rep:
            idx = torch.empty(len(req.prompt_ids), dtype=torch.int64,
                              device=d.counts.device)
            self._upload(idx, np.asarray(req.prompt_ids, np.int64))
            d.prompt_mask[slot].zero_()
            d.prompt_mask[slot].index_fill_(0, idx, True)
        if not (rep or req.presence_penalty or req.frequency_penalty):
            return
        if resumed:
            # the resume's prefill token is discarded: it counts nothing
            self._upload(d.counts[slot], np.bincount(
                np.asarray(req.generated, np.int64),
                minlength=self.cfg.vocab_size).astype(np.int32))
        else:
            d.counts[slot].zero_()
            d.counts[slot, token:token + 1].add_(1)

    def _emit(self, slot: int, token: int, lp=None):
        """Record one generated token (and its logprob record; a streamed
        request also gets the token on its queue); handle stop conditions:
        a stop token (the eos set unless ignore_eos, and stop_token_ids)
        ends the request only past min_tokens."""
        req = self.slot_req[slot]
        if req.guided is not None:
            # the next mask comes from the state past this token; a token
            # the grammar rejects leaves only eos and whitespace
            req.guided.advance(token)
        req.generated.append(token)
        if req.logprobs is not None:
            req.logprob_data.append(lp)
        if req.stream:
            # after the logprob record: the stream handler reads record k
            # when token k arrives
            req.out_queue.put(token)
        self.last_token[slot] = token
        self.counts["generated_tokens"] += 1
        if req.guided is not None:
            self.counts["guided_tokens"] += 1
        self.metrics.generated_tokens.inc()
        hit_eos = ((token in self._eos_set and not req.ignore_eos)
                   or token in req.stop_token_ids) \
            and len(req.generated) > req.min_tokens
        out_of_budget = (len(req.generated) >= req.max_tokens
                         or self.lengths[slot] + 1 >= self.max_len)
        if hit_eos or out_of_budget:
            req.finish_reason = "stop" if hit_eos else "length"
            self._finish(slot)

    def _finish(self, slot: int):
        """Release a finished slot. The paged engine first indexes the full
        pages of prompt + generated, so that a follow-up turn hits the
        generated ones too (capped at the last written row, see
        :meth:`_index_prompt_pages`); a dense slot keeps its prompt rows as
        a prefix source until it is reused."""
        req = self.slot_req[slot]
        req.t_done = time.monotonic()
        status = ("success" if req.finish_reason in ("stop", "length")
                  else req.finish_reason or "success")
        self.metrics.mark_request(status, req.t_done - req.t_submit,
                                  trace_id=req.trace_id or None)
        # the terminal flight event: an OK finish frees the timeline, any
        # other (timeout, error, cancelled) snapshots it
        _flight.finish(req.id, reason=req.finish_reason or "stop",
                       ok=status == "success", slot=slot,
                       n_generated=len(req.generated))
        if self.paged:
            ids = req.prompt_ids + req.generated
            self._index_prompt_pages(slot, ids, n_valid=len(ids) - 1)
        self.slot_req[slot] = None
        self._release_slot(slot)
        self.counts["finished"] += 1
        self.metrics.active_requests.set(len(self._active_slots()))
        req.out_queue.put(None)

    # -- warmup and the AOT manifest ----------------------------------------

    def warmup(self, record: Optional[list] = None) -> float:
        """Run once every eager program the configuration can dispatch
        (the counterpart of the JAX ``EnginePrograms.warmup``), so that
        the first request does not pay their first launches: the kernels'
        libraries loading, cuBLAS picking its algorithms, the caching
        allocator growing. The decode graphs were captured when the engine
        was built and are not touched. Returns the wall seconds, which also
        go to ``tpu_serve_compile_seconds_total``; with ``record`` (a list),
        one ``{"name", "seconds", "peak_bytes"}`` per program is appended
        (peak device bytes above the allocation before the program; None on
        the CPU).

        The programs run on scratch operands and write nothing that a
        request reads: the paged prefills' tables drop every row, the
        kernels' writes land in the scratch page 0, the dense prefills
        target a slot outside the cache, the dense chunk writes a free
        slot's rows past those it holds as a prefix source, the dense copy
        copies a slot's rows onto themselves, the dense verify and decode
        write each slot's rows from its length on (where idle decoding
        writes), and the draft model writes its dead rows. The pool's pages
        and tables, the prefix index, the host tier, the slots, ``counts``,
        the other metrics and the seed draws are left as they were, which
        requires an idle engine (RuntimeError otherwise)."""
        if not self.idle():
            raise RuntimeError("warmup needs an idle engine (nothing queued, "
                               "running or in flight)")
        t0 = time.monotonic()
        try:
            for name, run in self._warmup_programs():
                cuda = self.device.type == "cuda"
                if cuda:
                    torch.cuda.synchronize(self.device)
                    base = torch.cuda.memory_allocated(self.device)
                    torch.cuda.reset_peak_memory_stats(self.device)
                t = time.monotonic()
                run()
                if cuda:
                    torch.cuda.synchronize(self.device)
                if record is not None:
                    record.append({
                        "name": name, "seconds": time.monotonic() - t,
                        "peak_bytes": (torch.cuda.max_memory_allocated(
                            self.device) - base) if cuda else None})
        finally:
            dt = time.monotonic() - t0
            self.metrics.compile_seconds.inc(dt)
        return dt

    def _warmup_ops(self, n: int, fields: bool = False) -> dict:
        """Scratch sampling and logit operands of ``n`` rows: greedy and
        neutral, or (``fields``) sampled with a logit bias, a live
        min_tokens ban, a repetition penalty and allow words (all ones), so
        that every branch of the logit processing runs; with adapters, base
        adapter indices (the LoRA path runs, adding nothing)."""
        dev = self.device
        ban_ids = torch.full((n, BAN_K), NO_TOKEN, dtype=torch.int32,
                             device=dev)
        bias_ids = torch.full((n, BIAS_K), NO_TOKEN, dtype=torch.int32,
                              device=dev)
        bias_vals = torch.zeros((n, BIAS_K), device=dev)
        if fields:
            ban_ids[:, 0] = self.eos_token_id
            bias_ids[:, 0] = 1
            bias_vals[:, 0] = 1.0
        return dict(
            temps=torch.full((n,), 0.7 if fields else 0.0, device=dev),
            top_ks=torch.full((n,), 20 if fields else 0, dtype=torch.int32,
                              device=dev),
            top_ps=torch.full((n,), 0.9 if fields else 1.0, device=dev),
            seeds=torch.arange(n, dtype=torch.int64, device=dev),
            ban_ids=ban_ids,
            ban_until=torch.full((n,), self.max_len if fields else 0,
                                 dtype=torch.int32, device=dev),
            bias_ids=bias_ids, bias_vals=bias_vals,
            reps=torch.full((n,), 1.1, device=dev) if fields else None,
            allow=allow_words(n, self.cfg.vocab_size, dev) if fields
            else None,
            lora_idx=torch.zeros(n, dtype=torch.int32, device=dev)
            if self.lora_names else None)

    def _warmup_tokens(self, n: int, T: int, seed: int) -> torch.Tensor:
        """[n, T] distinct token ids below the vocabulary."""
        ids = (np.arange(n * T, dtype=np.int64).reshape(n, T) * 7 + seed) \
            % max(1, self.cfg.vocab_size - 1)
        return self._dev(ids.astype(np.int32))

    def _warmup_scratch_rows(self, rows: int) -> Optional[tuple]:
        """Dense: (slot, first row) of ``rows`` dead rows of a free slot,
        past the prompt rows it still holds as a prefix source (the fewest
        such rows first); None when no free slot has room."""
        best = None
        for slot in self._free:
            start = len(self._slot_tokens[slot])
            if start + rows <= self.max_len and \
                    (best is None or start < best[1]):
                best = (slot, start)
        return best

    def _warmup_programs(self):
        """(name, thunk) for every eager program this configuration can
        dispatch, in the JAX warmup's order."""
        dev, B, V = self.device, self.num_slots, self.cfg.vocab_size
        model, limit = self.model, self.max_len - 2
        i32 = torch.int32
        progs = []

        def prefill(b: int, n: int, fields: bool):
            rows = min(b, limit)
            ops = self._warmup_ops(n, fields)
            tables = torch.full((n, self.pages_per_slot), int(pkv.OOB_PAGE),
                                dtype=i32, device=dev) if self.paged else None
            slots = None if self.paged else \
                torch.full((n,), B, dtype=i32, device=dev)   # drops
            prefill_batch_step(
                model, self.cache, self._warmup_tokens(n, b, b),
                torch.full((n,), rows, dtype=i32, device=dev), tables,
                ops["temps"], ops["top_ks"], ops["top_ps"], ops["seeds"],
                slots=slots, ban_ids=ops["ban_ids"],
                ban_until=ops["ban_until"], bias_ids=ops["bias_ids"],
                bias_vals=ops["bias_vals"], reps=ops["reps"],
                allow=ops["allow"], lora_idx=ops["lora_idx"],
                logprobs=fields, prompt_logprobs=LOGPROB_K if fields else 0)

        for b in self.buckets:
            progs.append((f"prefill_b{b}",
                          lambda b=b: prefill(b, 1, False)))
        b0 = self.buckets[0]
        progs.append((f"prefill_b{b0}_fields",
                      lambda: prefill(b0, 1, True)))
        nb = min(max(1, self.serving.max_prefill_batch), B)
        if nb > 1:
            progs.append((f"prefill_batch_n{nb}_b{b0}",
                          lambda: prefill(b0, nb, False)))
            progs.append((f"prefill_batch_n{nb}_b{b0}_fields",
                          lambda: prefill(b0, nb, True)))
        C = self._chunk_size
        # every slot's table at its group's scratch page
        table = self._dev(np.repeat(
            np.array([self._gbase(s) for s in range(B)], np.int32)[:, None],
            self.pages_per_slot, axis=1)) if self.paged else None
        if self.paged:
            def mixed(fields: bool):
                ops = self._warmup_ops(B, fields)
                pen = dict(counts=torch.zeros((B, V), dtype=i32, device=dev),
                           presence=torch.full((B,), 0.5, device=dev),
                           frequency=torch.full((B,), 0.5, device=dev),
                           repetition=ops["reps"],
                           prompt_mask=torch.zeros((B, V), dtype=torch.bool,
                                                   device=dev)) \
                    if fields else {}
                seen = torch.ones(V, dtype=torch.bool, device=dev) \
                    if fields else None
                mixed_step(
                    model, self.cache, torch.zeros(B, dtype=i32, device=dev),
                    torch.zeros(B, dtype=i32, device=dev),
                    self._warmup_tokens(1, C, 97), 0, 0, C, table,
                    ops["temps"], ops["top_ks"], ops["top_ps"], ops["seeds"],
                    0.7 if fields else 0.0, 20 if fields else 0,
                    0.9 if fields else 1.0, 5, any_sampled=fields,
                    ban_ids=ops["ban_ids"], ban_until=ops["ban_until"],
                    bias_ids=ops["bias_ids"], bias_vals=ops["bias_vals"],
                    prep=1.1 if fields else 1.0, prep_seen=seen,
                    allow=ops["allow"], pallow=self._warmup_ops(1, fields)[
                        "allow"], lora_idx=ops["lora_idx"],
                    logprobs=fields, chunk_logprobs=fields,
                    chunk_prompt_logprobs=LOGPROB_K if fields else 0, **pen)

            progs.append((f"mixed_c{C}", lambda: mixed(False)))
            progs.append((f"mixed_c{C}_fields", lambda: mixed(True)))
            if self.host_tier is not None:
                def restore():
                    data = pkv.gather_pages(self.cache, [0])
                    entry = {name: (a[:, 0].cpu().pin_memory()
                                    if dev.type == "cuda" else a[:, 0].cpu())
                             for name, a in data.items()}
                    pkv.restore_pages(self.cache, [0],
                                      pkv.upload_pages([entry], dev))

                progs.append(("prefix_spill_restore", restore))
        else:
            scratch = self._warmup_scratch_rows(C)
            if scratch is None:
                log.info("warmup: no free slot has %d dead rows; the dense "
                         "chunk program is not warmed", C)
            else:
                slot, start = scratch

                def chunk(fields: bool):
                    ops = self._warmup_ops(1, fields)
                    seen = torch.ones(V, dtype=torch.bool, device=dev) \
                        if fields else None
                    prefill_chunk_step(
                        model, self.cache, self._warmup_tokens(1, C, 97),
                        start, slot, C, ops["temps"], ops["top_ks"],
                        ops["top_ps"], ops["seeds"], ban_ids=ops["ban_ids"],
                        ban_until=ops["ban_until"], bias_ids=ops["bias_ids"],
                        bias_vals=ops["bias_vals"],
                        rep=1.1 if fields else 1.0, rep_seen=seen,
                        allow=ops["allow"], lora_idx=ops["lora_idx"],
                        logprobs=fields)

                progs.append((f"chunk_c{C}", lambda: chunk(False)))
                progs.append((f"chunk_c{C}_fields", lambda: chunk(True)))
            if self.serving.prefix_cache and self._free:
                # a slot's rows copied onto themselves: no value changes
                src = self._free[-1]
                progs.append(("prefix_copy", lambda: kvc.copy_prefix(
                    self.cache, src, src, min(C, self.max_len))))

        def lengths(rows: int) -> torch.Tensor:
            """Each slot's write row: 0 (the paged scratch page), else its
            length, capped so that ``rows`` rows fit the window."""
            if self.paged:
                return torch.zeros(B, dtype=i32, device=dev)
            return self._dev(np.minimum(self.lengths, self.max_len - rows)
                             .astype(np.int32))

        if not self.decoder.graphs:
            # the CPU and the sp mesh decode eagerly
            def decode():
                ops = self._warmup_ops(B)
                decode_steps(model, 1, self.cache,
                             torch.zeros(B, dtype=i32, device=dev),
                             lengths(1), table, ops["temps"], ops["top_ks"],
                             ops["top_ps"], ops["seeds"],
                             bblock=self.decode_bblock, mesh=self.mesh,
                             any_sampled=False, ban_ids=ops["ban_ids"],
                             ban_until=ops["ban_until"],
                             bias_ids=ops["bias_ids"],
                             bias_vals=ops["bias_vals"],
                             allow=allow_words(B, V, dev),
                             lora_idx=ops["lora_idx"])

            progs.append(("decode_h1", decode))
        if self.spec_decode:
            R = self.serving.spec_k + 1

            def verify():
                ops = self._warmup_ops(B)
                spec_decode_step(model, R, self.cache,
                                 torch.zeros((B, R), dtype=i32, device=dev),
                                 lengths(R), table, ops["temps"],
                                 ops["top_ks"], ops["top_ps"], ops["seeds"],
                                 lora_idx=ops["lora_idx"])

            progs.append((f"spec_verify_r{R}", verify))
        if self.draft is not None:
            dr, K = self.draft, self.serving.spec_k
            dlens = self._dev(np.minimum(dr.lens, self.max_len - K - 1)
                              .astype(np.int32))
            progs.append(("draft_prefill", lambda: prefill_batch_step(
                dr.model, dr.cache, self._warmup_tokens(1, b0, 3),
                torch.full((1,), min(b0, limit), dtype=i32, device=dev),
                None, *dr._greedy(1),
                slots=torch.full((1,), B, dtype=i32, device=dev))))
            progs.append((f"draft_catch_up_r{K + 1}", lambda: spec_decode_step(
                dr.model, K + 1, dr.cache,
                torch.zeros((B, K + 1), dtype=i32, device=dev), dlens, None,
                *dr._greedy(B))))
            progs.append((f"draft_rollout_k{K}", lambda: decode_steps(
                dr.model, K, dr.cache, torch.zeros(B, dtype=i32, device=dev),
                dlens, None, *dr._greedy(B), any_sampled=False)))
        return progs

    def load_aot_manifest(self, path: str) -> dict:
        """Adopt a memory-fit manifest (``serving/aot.py``) for this engine:
        check its schema, that it was built for this configuration (model,
        slots, window, page size, buckets, weights and KV dtype, paged: the
        JAX engine's fingerprint; sp and the speculation setup:
        ``aot.engine_fingerprint``) and that its ledger fits, then put the
        ledger's total on ``tpu_serve_hbm_compiled_bytes``. A bad schema or
        a mismatch raises ValueError, a no-fit ledger RuntimeError: the
        server calls this before warmup and exits."""
        import json

        from aws_k8s_ansible_provisioner_tpu_torch.serving.aot import (
            engine_fingerprint, verify_manifest)

        with open(path, encoding="utf-8") as f:
            manifest = json.load(f)
        verify_manifest(manifest)
        want = engine_fingerprint(self)
        got = manifest["config"]
        bad = {k: (got.get(k), v) for k, v in want.items()
               if got.get(k) != v}
        if bad:
            raise ValueError(
                f"AOT manifest {path} was built for a different program "
                "set: " + "; ".join(
                    f"{k}: manifest={a!r} engine={b!r}"
                    for k, (a, b) in sorted(bad.items())))
        ledger = manifest["hbm_ledger"]
        if not ledger["fit"]:
            raise RuntimeError(
                f"AOT manifest {path} verdict is NO-FIT: "
                f"{ledger['total_bytes']} accounted bytes/chip vs "
                f"{ledger['capacity_bytes_per_chip']} capacity "
                f"(headroom {ledger['headroom_bytes']})")
        aot = {
            "path": path,
            "platform": manifest["platform"],
            "programs": len(manifest["programs"]),
            "total_compile_seconds": manifest["total_compile_seconds"],
            "hbm_total_bytes": ledger["total_bytes"],
            "hbm_headroom_bytes": ledger["headroom_bytes"],
            "fit": True,
        }
        self.metrics.hbm_compiled_bytes.set(float(ledger["total_bytes"]))
        # devmon's HBM ledger reconciles its live total against this one
        self.aot = aot
        return aot

    # -- loop ---------------------------------------------------------------

    def idle(self) -> bool:
        return (self._chunk is None and not self._active_slots()
                and not self.pending and self._inflight is None)

    def run_until_idle(self, max_steps: int = 1_000_000):
        """Step until nothing is queued, chunking, active or in flight."""
        for _ in range(max_steps):
            if self.idle():
                return
            self.step()
        raise RuntimeError("engine did not go idle")

    def run_forever(self, stop: threading.Event):
        """Engine thread body: step until stopped, sleeping when idle, with
        the stall watchdog on a thread of its own. A failing step fails
        every in-flight and queued request (their waiters get the sentinel)
        and the loop keeps serving. Each step holds ``step_lock``, which
        another thread takes to act between two steps (the server's
        profiler starts and stops there)."""
        threading.Thread(target=self._watchdog_loop, args=(stop,),
                         daemon=True, name="engine-watchdog").start()
        while not stop.is_set():
            self.last_step_start = time.monotonic()
            try:
                with self.step_lock:
                    did_work = self.step()
            # boundary that must keep serving: record, fail the affected
            # requests, continue
            except Exception as e:  # noqa: BLE001
                log.exception("engine step failed; failing in-flight "
                              "requests")
                self.last_error = f"{type(e).__name__}: {e}"
                self._fail_all(self.last_error)
                did_work = False
            self.last_step_start = 0.0
            with self._lock:
                self._stall_abort = False
            if not did_work:
                self._work_event.wait(timeout=0.05)
                self._work_event.clear()

    def _watchdog_loop(self, stop: threading.Event):
        """The stall watchdog: a step executing past STALL_AFTER_S is
        counted once in ``watchdog_stalls`` (a ``watchdog_stall`` flight
        event) and arms ``_stall_abort``, the flag a cooperative wait inside
        the step checks to abort it: the chaos ``stalled_decode`` wait
        (``serving/chaos.py``) raises, run_forever fails the requests and
        the engine keeps serving. A wedged device call never sees the flag;
        it shows as ``stalled_for_s`` > 0, which the server answers with 503
        "stalled" until the liveness probe restarts the pod. This thread
        reads clocks only and never touches the device."""
        while not stop.is_set():
            if self.stalled_for_s > 0:
                with self._lock:
                    armed = not self._stall_abort
                    self._stall_abort = True
                if armed:
                    self.metrics.watchdog_stalls.inc()
                    _flight.record("watchdog_stall", None,
                                   stalled_for_s=round(self.stalled_for_s,
                                                       3))
            stop.wait(min(1.0, max(0.05, self.STALL_AFTER_S / 4)))

    @property
    def stalled_for_s(self) -> float:
        """Seconds the step executing has run, once past STALL_AFTER_S
        (0.0 = healthy or idle)."""
        t0 = self.last_step_start
        if not t0:
            return 0.0
        dt = time.monotonic() - t0
        return dt if dt >= self.STALL_AFTER_S else 0.0

    def _fail_all(self, reason: str = ""):
        _flight.record("fail_all", None, reason=reason)
        # discard the dispatch in flight un-emitted: its requests fail below
        # (one release each, through _finish), and fetching a dispatch that
        # may be the failure would raise again; its device time is not
        # booked
        if self._inflight is not None:
            self._count_drain("fail")
        self._inflight = None
        self._pipe_carry = None
        self._busy.discard()
        if self._chunk is not None:
            st, self._chunk = self._chunk, None
            self._release_slot(st["slot"])
            st["req"].finish_reason = "error"
            self.metrics.mark_request("error", 0.0)
            _flight.finish(st["req"].id, "error", ok=False, detail=reason)
            st["req"].out_queue.put(None)
        for slot, r in enumerate(self.slot_req):
            if r is not None:
                r.finish_reason = "error"
                self._finish(slot)
        with self._lock:
            queued, self._queue = list(self._queue), collections.deque()
            self.metrics.queue_depth.set(0)
        self._resume_ctx.clear()
        for r in queued:
            r.finish_reason = "error"
            self.metrics.mark_request("error", 0.0)
            _flight.finish(r.id, "error", ok=False, detail=reason)
            r.out_queue.put(None)


def _host_prompt_lp(req: Request, plp_t, row: int) -> None:
    """Fill ``req.prompt_logprob_data`` from row ``row`` of host prompt
    records (sel [N, n], vals and ids [N, n, K]): None for position 0,
    then (own logprob, [(token id, logprob) x prompt_logprobs])."""
    sel, vals, ids = plp_t
    k = min(int(req.prompt_logprobs), ids.shape[-1])
    data: List = [None]
    for t in range(1, len(req.prompt_ids)):
        data.append((float(sel[row, t - 1]),
                     [(int(ids[row, t - 1, j]), float(vals[row, t - 1, j]))
                      for j in range(k)]))
    req.prompt_logprob_data = data


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
