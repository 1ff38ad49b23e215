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
  shards is refused; a mesh with ``dp``, ``tp``, ``pp`` or ``ep`` > 1 is
  refused (not ported yet).

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

Differences from the JAX engine:

- every paged chunked prefill, and every preemption resume, goes through
  ``mixed_step``, also when no decode row is active;
- not ported yet: the prefix cache and host tier, guided decoding, LoRA,
  penalties, logit bias, min_tokens, logprobs, deadlines, drain and the
  admission-pressure preemption;
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

Sampling is seeded per request as in the JAX engine: a request's OpenAI
``seed``, or else one drawn at submit from the engine's ``random.Random``
(seeded by ``ServingConfig.derived_seed``, or os.urandom), keys every draw
with its token position, so a seeded stream does not depend on the batch
around it and two engines with one ``derived_seed`` draw alike.
``ServingConfig.kv_dtype="int8"`` stores the pool or the dense cache int8
with per-row scales.
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
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from aws_k8s_ansible_provisioner_tpu_torch.config import (ModelConfig,
                                                          ServingConfig)
from aws_k8s_ansible_provisioner_tpu_torch.device import resolve_device
from aws_k8s_ansible_provisioner_tpu_torch.models.layers import (
    DecoderLM, check_supported)
from aws_k8s_ansible_provisioner_tpu_torch.models.quant import (
    quantize_params, weights_quantized)
from aws_k8s_ansible_provisioner_tpu_torch.ops.dense_attention import \
    fit_bblock
from aws_k8s_ansible_provisioner_tpu_torch.parallel.mesh import make_mesh
from aws_k8s_ansible_provisioner_tpu_torch.parallel.sharding import (
    init_cache_sharded, sp_size)
from aws_k8s_ansible_provisioner_tpu_torch.serving import kv_cache as kvc
from aws_k8s_ansible_provisioner_tpu_torch.serving import paged_kv as pkv
from aws_k8s_ansible_provisioner_tpu_torch.serving.draft import DraftModel
from aws_k8s_ansible_provisioner_tpu_torch.serving.programs import (
    DecodeGraphs, mixed_step, prefill_batch_step, prefill_chunk_step,
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
    """The bounded queue is full; nothing was generated (HTTP 429)."""


@dataclass
class Request:
    """One generation request."""

    prompt_ids: List[int]
    max_tokens: int = 256
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    ignore_eos: bool = False
    # OpenAI ``seed``: same seed + same prompt => same sampled stream
    seed: Optional[int] = None
    # resolved at submit: the seed's low 32 bits, or the engine's draw
    eff_seed: int = 0
    cancelled: bool = False
    id: int = field(default_factory=lambda: next(_REQUEST_IDS))
    generated: List[int] = field(default_factory=list)
    # None is put here when the request finishes
    out_queue: "queue.Queue" = field(default_factory=queue.Queue)
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


class Engine:
    """Continuous-batching engine over a fixed set of decode slots."""

    def __init__(self, cfg: ModelConfig, params: dict, serving: ServingConfig,
                 eos_token_id: Optional[int] = None, device=None,
                 draft: Optional[tuple] = None, mesh=None):
        """``draft=(draft_cfg, draft_params)`` is the draft model of
        ``spec_method="draft"``; its vocabulary must cover the target's.
        ``mesh`` (``parallel/mesh.make_mesh``; default: built from
        ``serving.mesh`` when that names more than one device) shards the
        dense cache over its ``sp`` axis; the engine then runs on the
        mesh's lead device, and ``device`` may only name its type."""
        check_supported(cfg)
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
        if self.mesh is not None:
            unserved = {a: n for a, n in self.mesh.shape.items()
                        if a != "sp" and n > 1}
            if unserved:
                raise ValueError(
                    f"mesh {self.mesh.shape}: only the sp axis is served so "
                    f"far; " + ", ".join(f"{a}={n}" for a, n in
                                         unserved.items())
                    + " > 1 is not ported yet")
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
        params = _to_device(params, self.device)
        if serving.weights_dtype == "int8" and not weights_quantized(params):
            params = quantize_params(params, cfg)
        self.model = DecoderLM(cfg, params)
        self.eos_token_id = cfg.eos_token_id if eos_token_id is None \
            else eos_token_id
        self._eos_set = ({self.eos_token_id, cfg.eos_token_id}
                         | set(cfg.extra_eos_token_ids))
        self.num_slots = serving.max_decode_slots
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
        self.allocator: Optional[pkv.PagePool] = None
        self.table: Optional[np.ndarray] = None
        if self.paged:
            ps = self.page_size = serving.page_size
            if ps <= 0 or ps % 8:
                raise ValueError(f"page_size={ps} must be a positive "
                                 f"multiple of 8")
            self.pages_per_slot = -(-self.max_len // ps)
            pool_pages = serving.kv_pool_pages \
                or self.num_slots * self.pages_per_slot
            if pool_pages < self.pages_per_slot:
                raise ValueError(f"kv_pool_pages={pool_pages} < pages for "
                                 f"one full window ({self.pages_per_slot})")
            # +1: physical page 0 is the scratch page idle slots point at
            self.cache = pkv.init_pool(cfg, pool_pages + 1, ps, self.dtype,
                                       self.device, quant=quant)
            self.allocator = pkv.PagePool(pool_pages + 1, ps, first_page=1)
            self.table = np.zeros((self.num_slots, self.pages_per_slot),
                                  np.int32)
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
        self.lengths = np.zeros(self.num_slots, np.int32)
        self.last_token = np.zeros(self.num_slots, np.int32)
        self.temps = np.zeros(self.num_slots, np.float32)
        self.top_ks = np.zeros(self.num_slots, np.int32)
        self.top_ps = np.ones(self.num_slots, np.float32)
        self.seeds = np.zeros(self.num_slots, np.int64)       # uint32 values
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
        self._work_event = threading.Event()
        self._chunk: Optional[dict] = None
        # the dense chunk walk alternates a chunk with a horizon-1 decode
        # dispatch of the running slots: True when the decode is due
        self._chunk_yield = False
        # seeds of requests without one; a pinned derived_seed makes two
        # engines (this one and the JAX one too) draw the same sequence
        self._py_rng = random.Random(
            int.from_bytes(os.urandom(8), "little")
            if serving.derived_seed is None else int(serving.derived_seed))
        self.counts = collections.Counter()
        self.last_error = ""
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
            capture=self.device.type == "cuda" and self.sp == 1)

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
        n = len(req.prompt_ids)
        if n == 0:
            raise ValueError("empty prompt")
        if n > self.prompt_limit:
            raise ContextLengthExceeded(n, self.prompt_limit, self.max_len)
        if min(req.prompt_ids) < 0 or max(req.prompt_ids) >= \
                self.cfg.vocab_size:
            raise ValueError(f"prompt token ids must lie in "
                             f"[0, {self.cfg.vocab_size})")
        req.max_tokens = max(1, min(req.max_tokens, self.max_len - n - 1))
        with self._lock:
            req.eff_seed = (int(req.seed) & 0xffffffff) \
                if req.seed is not None else self._py_rng.getrandbits(32)
            depth = self.serving.max_queue_depth
            if depth and len(self._queue) >= depth:
                raise EngineOverloaded(f"engine queue is full "
                                       f"({len(self._queue)} waiting)")
            self._queue.append(req)
        self._work_event.set()
        return req

    def cancel(self, req: Request):
        """Mark a request cancelled; its slot frees on the next step."""
        req.cancelled = True
        self._work_event.set()

    # -- slots and pages ----------------------------------------------------

    def _active_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is not None]

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
            self.allocator.release_all(self._slot_pages[slot])
            self._slot_pages[slot] = []
            self.table[slot, :] = 0
            self.lengths[slot] = 0
            self._op_dirty_table = True
        self.temps[slot] = 0.0
        self._op_dirty_sampling = True
        self._free.append(slot)

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
                got = self.allocator.alloc(need)
                if got is not None:
                    self.table[slot, len(pages):len(pages) + need] = got
                    self._op_dirty_table = True
                    pages.extend(got)
                    break
                victim = max(self._active_slots(),
                             key=lambda s: self._admit_seq[s])
                self._preempt(victim)
                if victim == slot:
                    break
        return bool(self._active_slots())

    def _preempt(self, slot: int):
        """Release a running request's pages and requeue it at the front;
        it resumes by re-prefilling prompt + generated so far."""
        req = self.slot_req[slot]
        self._resume_ctx[req.id] = req.prompt_ids + req.generated
        self.slot_req[slot] = None
        # the slot's host state leaves the device carry of a dispatch in
        # flight behind
        self._carry_gen += 1
        self._release_slot(slot)
        with self._lock:
            self._queue.appendleft(req)
        self.counts["preemptions"] += 1

    # -- the step -----------------------------------------------------------

    def step(self) -> bool:
        """One scheduling step: advance a chunked prefill (paged: one mixed
        dispatch; dense: a chunk, or the horizon-1 decode dispatch that
        alternates with the chunks while slots run), else admit waiting
        prompts, else decode; with nothing to do, settle a dispatch still in
        flight. Returns whether any work was done."""
        for slot, r in enumerate(self.slot_req):
            if r is not None and r.cancelled:
                r.finish_reason = "cancelled"
                self._finish(slot)
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
        if self._inflight is not None and self.pending \
                and not self._ragged_on():
            # settle the dispatch in flight before admission can reuse a
            # slot it still decodes (its deferred emits would go to the new
            # request)
            self._drain_decode_pipeline("prefill")
        batch, chunk_next = self._admit()
        if batch:
            self._prefill_batch(batch)
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
        (or a resume, or any prompt of the paged engine while a dispatch is
        in flight) ends it."""
        batch, chunk_next = [], None
        while len(batch) < max(1, self.serving.max_prefill_batch) \
                and self._free:
            with self._lock:
                if not self._queue:
                    break
                req = self._queue[0]
                if req.cancelled:
                    self._queue.popleft()
                    self._resume_ctx.pop(req.id, None)
                    req.finish_reason = "cancelled"
                    req.out_queue.put(None)
                    continue
                ids = self._resume_ctx.get(req.id, req.prompt_ids)
                if self.paged and -(-(len(ids) + 1) // self.page_size) > \
                        self.allocator.free_pages:
                    break                  # head-of-line blocking: FCFS
                self._queue.popleft()
            slot = self._free.popleft()
            if self.paged:
                pages = self.allocator.alloc(-(-len(ids) // self.page_size))
                self._slot_pages[slot] = pages
                self.table[slot, :] = 0
                self.table[slot, :len(pages)] = pages
                self._op_dirty_table = True
            self._seq_counter += 1
            self._admit_seq[slot] = self._seq_counter
            resumed = self._resume_ctx.pop(req.id, None) is not None
            # with a dispatch in flight the paged engine admits through the
            # chunk walk, whose mixed dispatches ride the pipeline, where a
            # batch prefill would activate a slot under the in-flight carry
            if (resumed or self._should_chunk(len(ids))
                    or (self._ragged_on() and self._inflight is not None)):
                chunk_next = (req, slot, list(ids), resumed)
                break
            batch.append((req, slot))
        return batch, chunk_next

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

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

    def _prefill_batch(self, batch):
        N = len(batch)
        T = self._bucket_for(max(len(r.prompt_ids) for r, _ in batch))
        tokens = np.zeros((N, T), np.int32)
        true_lens = np.zeros(N, np.int32)
        for i, (req, _) in enumerate(batch):
            tokens[i, :len(req.prompt_ids)] = req.prompt_ids
            true_lens[i] = len(req.prompt_ids)
        slots = [s for _, s in batch]
        slots_np = np.array(slots, np.int32)
        self.cache, toks = prefill_batch_step(
            self.model, self.cache, self._dev(tokens), self._dev(true_lens),
            self._dev(self.table[slots]) if self.paged else None,
            self._dev(np.array([r.temperature for r, _ in batch], np.float32)),
            self._dev(np.array([r.top_k for r, _ in batch], np.int32)),
            self._dev(np.array([r.top_p for r, _ in batch], np.float32)),
            self._dev(np.array([r.eff_seed for r, _ in batch], np.int64)),
            slots=None if self.paged else self._dev(slots_np))
        toks = toks.cpu().numpy()
        self.counts["prefill_dispatches"] += 1
        if self.draft is not None:
            self.draft.prefill(tokens, true_lens, slots_np)
        for i, (req, slot) in enumerate(batch):
            self._activate(req, slot, int(toks[i]), req.prompt_ids, False)

    def _start_chunk(self, req: Request, slot: int, ids: List[int],
                     resumed: bool):
        self.lengths[slot] = 0
        if not self.paged:
            # the dense walk rewrites the slot's length out of band of any
            # device carry; the paged walk's mixed dispatches set the
            # slot's carry lanes themselves
            self._carry_gen += 1
        if self.draft is not None:
            # the draft has no chunk walk; the slot serves the plain path
            self.draft.mark_stale(slot)
        self._chunk = {"req": req, "slot": slot, "ids": ids, "off": 0,
                       "resumed": resumed}

    def _advance_chunk(self):
        """The walk's next chunk: one mixed dispatch packing it beside a
        decode step of every active slot (paged), or one
        ``prefill_chunk_step`` (dense; the decode steps alternate with the
        chunks, see :meth:`step`)."""
        st = self._chunk
        req, slot, ids, off = st["req"], st["slot"], st["ids"], st["off"]
        if req.cancelled:
            # settle a mixed dispatch in flight before the slot's pages go
            self._drain_decode_pipeline("chunk")
            self._chunk = None
            self._release_slot(slot)
            req.finish_reason = "cancelled"
            req.out_queue.put(None)
            return
        C = self._chunk_size
        chunk = ids[off:off + C]
        if not self.paged:
            self._advance_chunk_dense(st, chunk, C)
            return
        self._advance_chunk_mixed(st, chunk, C)

    def _advance_chunk_mixed(self, st: dict, chunk: List[int], C: int):
        """One mixed dispatch (the JAX engine's ``_advance_chunk_mixed``).
        A non-final chunk's dispatch rides the pipeline like a decode
        dispatch (with ``decode_pipeline=0`` it settles at once); the final
        chunk settles its predecessor and itself, since its token activates
        the slot. On a failure the walk's slot is
        released here, exactly once, before the error propagates."""
        req, slot, ids, off = st["req"], st["slot"], st["ids"], st["off"]
        final = off + len(chunk) >= len(ids)
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
            req.out_queue.put(None)
            raise
        if final:
            self._chunk = None
            self._activate(req, slot, rec["chunk_token"], ids,
                           st["resumed"])

    def _mixed_dispatch(self, st: dict, chunk: List[int], C: int) -> dict:
        """Queue one ``mixed_step`` on the device operands (the carry of the
        dispatch in flight included) and return its record; the chunking
        slot's carry lanes take the chunk's token and its new frontier."""
        req, slot, off = st["req"], st["slot"], st["off"]
        d = self.decoder
        self._decode_operands()
        active = self._active_slots()
        ptokens = np.zeros((1, C), np.int32)
        ptokens[0, :len(chunk)] = chunk
        pdev = torch.empty((1, C), dtype=torch.int32, device=self.device)
        self._upload(pdev, ptokens)
        self.cache, out, ptok = mixed_step(
            self.model, self.cache, d.tokens, d.lengths, pdev, slot, off,
            len(chunk), d.table, d.temps, d.top_ks, d.top_ps, d.seeds,
            req.temperature, req.top_k, req.top_p, req.eff_seed,
            any_sampled=bool((self.temps > 0).any()))
        is_p = torch.arange(self.num_slots, device=self.device) == slot
        tok = torch.where(is_p, ptok, out[0])
        lens = torch.where(is_p, torch.full_like(d.lengths, off + len(chunk)),
                           d.lengths + 1)
        d.tokens.copy_(tok)
        d.lengths.copy_(lens)
        (out, ptok), event = self._stage(out, ptok)
        self._pipe_carry = self._carry_gen
        self.counts["mixed_dispatches"] += 1
        self.counts["pipeline_dispatches"] += 1
        return {"mixed": True, "out": out, "pout": ptok, "event": event,
                "horizon": 1, "active": active,
                "reqs": [self.slot_req[s] for s in active]}

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
        ptokens = np.zeros((1, C), np.int32)
        ptokens[0, :len(chunk)] = chunk
        self.cache, tok = prefill_chunk_step(
            self.model, self.cache, self._dev(ptokens), off, slot,
            len(chunk), self._dev(np.array([req.temperature], np.float32)),
            self._dev(np.array([req.top_k], np.int32)),
            self._dev(np.array([req.top_p], np.float32)),
            self._dev(np.array([req.eff_seed], np.int64)))
        tok = int(tok.cpu()[0])
        self.counts["chunk_dispatches"] += 1
        st["off"] = off + len(chunk)
        self.lengths[slot] = st["off"]
        if st["off"] >= len(ids):
            self._chunk = None
            self._activate(req, slot, tok, ids, st["resumed"])

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
        (and admissions take the walk under a dispatch in flight)?"""
        return self.paged and self.serving.decode_pipeline > 0

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
        self.counts[f"pipeline_drains_{reason}"] += 1
        self._inflight = None
        self._pipe_carry = None
        self._decode_fetch(rec)

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
                             (d.top_ps, self.top_ps), (d.seeds, self.seeds)):
                self._upload(dst, arr)
            self._op_dirty_sampling = False
        if self.paged and self._op_dirty_table:
            self._upload(d.table, self.table)
            self._op_dirty_table = False
        if not self._carry_valid():
            self._upload(d.tokens, self.last_token)
            self._upload(d.lengths, self.lengths)

    def _decode(self, max_horizon: Optional[int] = None):
        """One decode dispatch of every slot (``max_horizon`` caps its
        horizon: 1 between the dense walk's chunks), or a verify dispatch
        when speculation proposes drafts; with the pipeline on, the new
        dispatch is left in flight and its predecessor fetched."""
        prev = self._inflight
        if prev is not None and not self._carry_valid():
            # a slot changed under the dispatch in flight: fetch it first,
            # then dispatch from the refreshed mirrors
            self._drain_decode_pipeline("prefill")
            prev = None
        with self._lock:
            waiting = bool(self._queue)
        horizon = 1 if (waiting and self._free) \
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
        rec = self._decode_dispatch(horizon, active)
        if self._pipeline_on():
            self._inflight = rec
            if prev is not None:
                self._decode_fetch(prev)
            return
        self._pipe_carry = None
        if prev is not None:
            self.counts["pipeline_drains_" + (
                "chunk" if self._chunk is not None
                else "spec" if spec else "drain")] += 1
            self._inflight = None
            self._decode_fetch(prev)
        self._decode_fetch(rec)

    def _decode_dispatch(self, horizon: int, active: List[int]) -> dict:
        """Queue one decode dispatch of ``horizon`` substeps (a graph
        replay on a CUDA device) and return its record; nothing here waits
        for the device."""
        self._decode_operands()
        out = self.decoder.run(horizon, bool((self.temps > 0).any()))
        (out,), event = self._stage(out)
        self._pipe_carry = self._carry_gen
        self.counts["decode_dispatches"] += 1
        self.counts["decode_substeps"] += horizon
        self.counts["pipeline_dispatches"] += 1
        return {"out": out, "event": event, "horizon": horizon,
                "active": list(active),
                "reqs": [self.slot_req[s] for s in active]}

    def _decode_fetch(self, rec: dict) -> None:
        """Wait for a dispatch's tokens and emit them: substep by substep,
        to each slot that still serves the request it served when the
        dispatch was queued (a slot that finished since then was decoded as
        garbage; its surplus is discarded). A mixed dispatch's record also
        yields the chunk's token."""
        if rec["event"] is not None:
            rec["event"].synchronize()
        out = rec["out"].numpy()
        if rec.get("mixed"):
            rec["chunk_token"] = int(rec["pout"].numpy()[0])
        for s in range(rec["horizon"]):
            for slot, req in zip(rec["active"], rec["reqs"]):
                if self.slot_req[slot] is not req:
                    continue             # finished earlier or since queued
                self.lengths[slot] += 1
                self._emit(slot, int(out[s, slot]))

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
        """Slots a verify dispatch serves no token: the sampled ones. They
        take every token from the plain step, so a seeded stream is the same
        with speculation on or off: in bf16 the verify's R-row forward
        rounds apart from the one-row decode, enough to flip a near-tie of
        the draw (the JAX engine draws them from the verify's row 0; ROADMAP
        C9). The JAX engine's other plain-only features (logprobs,
        penalties, min_tokens, logit bias, guided) are not ported yet."""
        return {s for s in active if self.slot_req[s].temperature > 0.0}

    def _do_spec_decode(self, active: List[int], drafts: np.ndarray,
                        proposed: dict, skip=frozenset()):
        """One verify dispatch: up to spec_k + 1 tokens per slot. ``skip``
        slots take part (their surplus rows lie past their length) but emit
        nothing; the next dispatch is then a plain one. The accepted count
        is clamped to each slot's real draft count (a zero-padded draft can
        match the model's argmax)."""
        R = self.serving.spec_k + 1
        tokens = np.concatenate([self.last_token[:, None], drafts], axis=1)
        self.cache, out, accepted = spec_decode_step(
            self.model, R, self.cache, self._dev(tokens),
            self._dev(self.lengths), self._table_dev(),
            self._dev(self.temps), self._dev(self.top_ks),
            self._dev(self.top_ps), self._dev(self.seeds))
        out, accepted = out.cpu().numpy(), accepted.cpu().numpy()
        self.counts["spec_dispatches"] += 1
        for slot in active:
            if slot in skip:
                continue
            acc = int(accepted[slot])
            if slot in proposed:
                n_drafted = proposed[slot]
                self.counts["spec_drafted_tokens"] += n_drafted
                self.counts["spec_accepted_tokens"] += \
                    min(max(acc - 1, 0), n_drafted)
            emitted = 0
            for i in range(acc):
                if self.slot_req[slot] is None:
                    break                    # a stop condition mid-prefix
                self.lengths[slot] += 1
                self._emit(slot, int(out[slot, i]))
                emitted += 1
            if self.draft is not None and slot in proposed:
                self.draft.note_emitted(slot, emitted)
        self._spec_plain_due = bool(skip)
        # the verify advanced the mirrors on the host: the next dispatch
        # copies them in
        self._pipe_carry = None

    # -- slot lifecycle -----------------------------------------------------

    def _activate(self, req: Request, slot: int, token: int,
                  ids: List[int], resumed: bool):
        """Post-prefill bookkeeping. A resume rebuilt the cache of
        prompt + generated: its sampled token is discarded and decode
        continues from the last real token, whose row it rewrites."""
        # a device carry no longer describes the batch once the slot joins
        self._carry_gen += 1
        self._op_dirty_sampling = True
        self.slot_req[slot] = req
        self.lengths[slot] = len(ids) - 1 if resumed else len(ids)
        self.temps[slot] = req.temperature
        self.top_ks[slot] = req.top_k
        self.top_ps[slot] = req.top_p
        self.seeds[slot] = req.eff_seed
        if resumed:
            self.last_token[slot] = ids[-1]
        else:
            self._emit(slot, token)

    def _emit(self, slot: int, token: int):
        """Record one generated token; handle stop conditions."""
        req = self.slot_req[slot]
        req.generated.append(token)
        self.last_token[slot] = token
        self.counts["generated_tokens"] += 1
        hit_eos = token in self._eos_set and not req.ignore_eos
        out_of_budget = (len(req.generated) >= req.max_tokens
                         or self.lengths[slot] + 1 >= self.max_len)
        if hit_eos or out_of_budget:
            req.finish_reason = "stop" if hit_eos else "length"
            self._finish(slot)

    def _finish(self, slot: int):
        req = self.slot_req[slot]
        self.slot_req[slot] = None
        self._release_slot(slot)
        self.counts["finished"] += 1
        req.out_queue.put(None)

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
        """Engine thread body: step until stopped, sleeping when idle. A
        failing step fails every in-flight and queued request (their waiters
        get the sentinel) and the loop keeps serving."""
        while not stop.is_set():
            try:
                did_work = self.step()
            # boundary that must keep serving: record, fail the affected
            # requests, continue
            except Exception as e:  # noqa: BLE001
                log.exception("engine step failed; failing in-flight "
                              "requests")
                self.last_error = f"{type(e).__name__}: {e}"
                self._fail_all()
                did_work = False
            if not did_work:
                self._work_event.wait(timeout=0.05)
                self._work_event.clear()

    def _fail_all(self):
        # discard the dispatch in flight un-emitted: its requests fail below
        # (one release each, through _finish), and fetching a dispatch that
        # may be the failure would raise again
        if self._inflight is not None:
            self.counts["pipeline_drains_fail"] += 1
        self._inflight = None
        self._pipe_carry = None
        if self._chunk is not None:
            st, self._chunk = self._chunk, None
            self._release_slot(st["slot"])
            st["req"].finish_reason = "error"
            st["req"].out_queue.put(None)
        for slot, r in enumerate(self.slot_req):
            if r is not None:
                r.finish_reason = "error"
                self._finish(slot)
        with self._lock:
            queued, self._queue = list(self._queue), collections.deque()
        self._resume_ctx.clear()
        for r in queued:
            r.finish_reason = "error"
            r.out_queue.put(None)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
