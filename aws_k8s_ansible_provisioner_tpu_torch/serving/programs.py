"""The engine's step programs: batched prefill, chunked prefill into the
dense cache, the fused decode horizon, the ragged mixed dispatch and the
speculative verify.

Each is a plain function over the model (``models/layers.DecoderLM``), the
cache (updated in place) and device tensors, with the JAX package's
``serving/programs.py`` semantics and operand layouts:

- :func:`prefill_batch_step`: N right-padded prompts in one forward pass,
  causal attention plus the paged scatter (or, with ``slots``, the dense
  cache's); samples each prompt's first token;
- :func:`decode_steps`: ``n_steps`` decode substeps for every slot (the
  fused horizon, here a Python loop), each writing one K/V row per slot at
  its length and attending through the paged kernel (or, without a
  ``table``, the dense cache's);
- :func:`mixed_step`: B decode rows and one C-row prefill chunk of slot
  ``pslot`` packed into one ``[1, B + C]`` sequence and served by one
  forward pass through the ragged kernel. ``pslot``'s own decode row is a
  dead passenger: write row -1 (dropped), limit 0. The chunk's rows (from
  row B on) share ``pslot``'s table row with limits ``pstart + 1 ..
  pstart + C``, the layout that the ragged entry takes as ``chunk_start``
  to stream the slot's pages once per row tile;
- :func:`spec_decode_step`: R tokens per slot (the last emitted token and
  R - 1 drafts) in one forward pass, greedy acceptance of the longest
  matching draft prefix.

:class:`DecodeGraphs` runs :func:`decode_steps` of the serving engine over
operand buffers that stay in place, the carry left in them: on a CUDA card
each horizon is one replay of a CUDA graph captured when the engine is
built (the counterpart of the JAX program's static horizon); on the CPU,
and under an sp mesh, it calls :func:`decode_steps`.

The paged pool serves the target model of the paged engine; the dense slot
cache (``kv_cache.init_cache``) the dense engine (``paged=False``) and the
draft model of speculative decoding, bf16/f32 or (the dense engine's) int8.
Under a mesh with ``sp`` > 1 the dense cache is a list of sequence shards
(``parallel/sharding.init_cache_sharded``): ``prefill_batch_step`` and
``prefill_chunk_step`` take it as it is (their callbacks write each row in
the shard that holds it), ``decode_steps`` takes the mesh.

Each honours the model's ``cfg.sliding_window`` in every attention of the
step (prefill, decode, chunk rows and verify rows alike).

Each takes the rows' ``seeds`` ([B] uint32 values held in int64) and keys
its draws at the JAX programs' counters (``ops/sampling.per_slot_keys``):
a prefill row at its prompt length, a decode row at its length + 1 (the
context the draw extends to), the chunk row at ``pstart + plen`` (a dense
chunk at ``start + chunk_len``), a verify row 0 at its length + 1.

Sampling penalties, logit bias, stop-token bans, guided masks, logprobs and
LoRA of the JAX programs are not ported yet.
"""

from __future__ import annotations

import collections
import time
from typing import Optional

import torch

from aws_k8s_ansible_provisioner_tpu_torch.models.layers import DecoderLM
from aws_k8s_ansible_provisioner_tpu_torch.ops import (dense_attention,
                                                       paged_attention,
                                                       split_kv)
from aws_k8s_ansible_provisioner_tpu_torch.ops.attention import (
    make_chunk_prefill_attend, make_decode_attend_carry,
    make_decode_attend_carry_paged, make_mixed_attend_carry_paged,
    make_prefill_attend_batch, make_prefill_attend_batch_paged_carry,
    make_spec_attend_carry, make_spec_attend_carry_paged)
from aws_k8s_ansible_provisioner_tpu_torch.ops.sampling import sample


def prefill_batch_step(model: DecoderLM, pool: dict, tokens: torch.Tensor,
                       true_lens: torch.Tensor, tables: Optional[torch.Tensor],
                       temperature: torch.Tensor, top_k: torch.Tensor,
                       top_p: torch.Tensor, seeds: torch.Tensor,
                       slots: Optional[torch.Tensor] = None):
    """Prefill N prompts in one forward pass.

    tokens: [N, T] right-padded; true_lens [N]; tables [N, max_pages] int32
    (rows of OOB_PAGE drop) for the paged pool, or ``tables=None`` and
    ``slots`` [N] (slots outside the cache drop) for the dense cache; seeds
    [N]. Returns (pool, first tokens [N] int32).
    """
    N, T = tokens.shape
    positions = torch.arange(T, dtype=torch.int32,
                             device=tokens.device)[None].expand(N, T)
    window = model.cfg.sliding_window
    attend = make_prefill_attend_batch(slots, true_lens, window) \
        if tables is None else \
        make_prefill_attend_batch_paged_carry(tables, true_lens, window)
    logits, pool = model.forward_carry(tokens, positions, pool, attend)
    last = logits[torch.arange(N, device=tokens.device), true_lens.long() - 1]
    return pool, sample(last, temperature, top_k, top_p, seeds, true_lens)


def prefill_chunk_step(model: DecoderLM, cache: dict, tokens: torch.Tensor,
                       start: int, slot: int, chunk_len: int,
                       temperature: torch.Tensor, top_k: torch.Tensor,
                       top_p: torch.Tensor, seed: torch.Tensor):
    """Prefill one chunk of a long prompt into slot ``slot`` of the dense
    cache, at rows [start, start + C) (the JAX program's ``pages=None``
    branch).

    tokens: [1, C] (the final chunk right-padded), ``chunk_len`` of them
    valid; temperature/top_k/top_p/seed: [1]. The chunk's rows are written
    (quantized into an int8 cache), then its queries attend the slot's rows
    up to their own. Returns (cache, token [1]) sampled from the chunk's
    last valid row with the seeded counter ``start + chunk_len``, the
    context length at the final chunk (the only one whose token the engine
    keeps), so a seeded stream does not depend on the chunking.
    """
    C = tokens.shape[1]
    positions = start + torch.arange(C, dtype=torch.int32,
                                     device=tokens.device)[None]
    attend = make_chunk_prefill_attend(slot, start, model.cfg.sliding_window)
    logits, cache = model.forward_carry(tokens, positions, cache, attend)
    last = logits[0, chunk_len - 1][None]
    ctr = torch.tensor([start + chunk_len], dtype=torch.int32,
                       device=tokens.device)
    return cache, sample(last, temperature, top_k, top_p, seed, ctr)


def decode_steps(model: DecoderLM, n_steps: int, pool,
                 tokens: torch.Tensor, lengths: torch.Tensor,
                 table: Optional[torch.Tensor], temperature: torch.Tensor,
                 top_k: torch.Tensor, top_p: torch.Tensor,
                 seeds: torch.Tensor, bblock: int = 1, mesh=None,
                 any_sampled: Optional[bool] = None):
    """``n_steps`` decode substeps for every slot.

    tokens/lengths: [B] int32 (the token to feed and the row it lands at);
    table: [B, max_pages] int32 for the paged pool, None for the dense
    cache; seeds [B]; ``bblock``: slots per CTA of the dense cache's decode
    kernel (K5 when > 1; the paged kernel takes none); ``mesh``: with an
    ``sp`` axis larger than 1, the dense cache is a list of sequence shards
    and each substep attends them through K6 and the log-sum-exp merge;
    ``any_sampled``: whether some row has temperature > 0 (``sample``'s;
    given, no substep reads the device from the host, and the horizon can
    be captured in a CUDA graph, :class:`DecodeGraphs`).
    Returns (pool, out [n_steps, B]). Slots that stop mid-horizon produce
    surplus tokens the host discards; their surplus K/V rows land past the
    slot's length (or drop past the window).
    """
    out = []
    tok, lens = tokens, lengths
    window = model.cfg.sliding_window
    for _ in range(n_steps):
        attend = make_decode_attend_carry(lens, window, bblock, mesh) \
            if table is None \
            else make_decode_attend_carry_paged(lens, table, window)
        logits, pool = model.forward_carry(tok[:, None], lens[:, None], pool,
                                           attend)
        tok = sample(logits[:, 0], temperature, top_k, top_p, seeds,
                     lens + 1, any_sampled)
        lens = lens + 1
        out.append(tok)
    return pool, torch.stack(out)


def mixed_step(model: DecoderLM, pool: dict, tokens: torch.Tensor,
               lengths: torch.Tensor, ptokens: torch.Tensor, pslot: int,
               pstart: int, plen: int, table: torch.Tensor,
               temperature: torch.Tensor, top_k: torch.Tensor,
               top_p: torch.Tensor, seeds: torch.Tensor, ptemp: float,
               ptop_k: int, ptop_p: float, pseed: int,
               any_sampled: Optional[bool] = None):
    """One ragged dispatch: a decode step for every slot AND one prefill
    chunk (``ptokens`` [1, C], ``plen`` valid) of slot ``pslot`` at rows
    [pstart, pstart + C). The chunk row samples with (ptemp, ptop_k,
    ptop_p) and seed ``pseed``; ``any_sampled`` is ``sample``'s for the
    decode rows. The chunk row's operands are filled on the device, not
    uploaded, so the dispatch can be queued behind one in flight.

    Returns (pool, out [1, B], chunk token [1]); ``out[0, pslot]`` is the
    dead passenger's token and is discarded.
    """
    dev = tokens.device
    B, C = tokens.shape[0], ptokens.shape[1]
    i32 = torch.int32
    is_p = torch.arange(B, device=dev) == pslot
    crows = pstart + torch.arange(C, dtype=i32, device=dev)
    write_rows = torch.cat([torch.where(is_p, torch.full_like(lengths, -1),
                                        lengths), crows])
    row_limits = torch.cat([torch.where(is_p, torch.zeros_like(lengths),
                                        lengths + 1), crows + 1])
    row_tables = torch.cat([table, table[pslot][None].expand(C, -1)]) \
        .contiguous()
    packed = torch.cat([tokens[None], ptokens], dim=1)          # [1, B + C]
    positions = torch.cat([torch.where(is_p, torch.zeros_like(lengths),
                                       lengths)[None], crows[None]], dim=1)
    attend = make_mixed_attend_carry_paged(write_rows.to(i32),
                                           row_limits.to(i32), row_tables,
                                           model.cfg.sliding_window,
                                           chunk_start=B)
    logits, pool = model.forward_carry(packed, positions, pool, attend)
    nxt = sample(logits[0, :B], temperature, top_k, top_p, seeds, lengths + 1,
                 any_sampled)
    plast = logits[0, B + plen - 1][None]

    def one(value, dtype):
        return torch.full((1,), value, dtype=dtype, device=dev)

    ptok = sample(plast, one(ptemp, torch.float32), one(ptop_k, i32),
                  one(ptop_p, torch.float32), one(pseed, torch.int64),
                  one(pstart + plen, torch.int64), ptemp > 0)
    return pool, nxt[None], ptok


def spec_decode_step(model: DecoderLM, R: int, pool: dict,
                     tokens: torch.Tensor, lengths: torch.Tensor,
                     table: Optional[torch.Tensor], temperature: torch.Tensor,
                     top_k: torch.Tensor, top_p: torch.Tensor,
                     seeds: torch.Tensor):
    """Speculative verify: R tokens per slot in one forward pass.

    tokens: [B, R] = [last emitted token, R - 1 drafts] at positions
    ``lengths[b] + r``; table [B, max_pages] int32 for the paged pool (its
    pages must cover ``lengths + R``), None for the dense cache. Returns
    (pool, out [B, R], accepted [B]): ``out[b, :accepted[b]]`` are the
    emitted tokens, the longest draft prefix that matches the model's
    argmax at every row, then the argmax after it. A sampled slot
    (temperature > 0) accepts nothing and draws one token from row 0, keyed
    at ``lengths + 1`` as a decode step is. The K/V rows of all R positions
    are written; those past the accepted prefix lie beyond the slot's new
    length and are rewritten before anything attends them.
    """
    B = tokens.shape[0]
    dev = tokens.device
    positions = lengths[:, None] + torch.arange(R, dtype=lengths.dtype,
                                                device=dev)[None, :]
    window = model.cfg.sliding_window
    attend = make_spec_attend_carry(lengths, window) if table is None \
        else make_spec_attend_carry_paged(lengths, table, window)
    logits, pool = model.forward_carry(tokens, positions, pool, attend)
    preds = torch.argmax(logits, dim=-1).to(torch.int32)          # [B, R]
    drafts = tokens[:, 1:].to(torch.int32)                        # [B, R-1]
    match = (drafts == preds[:, :-1]).to(torch.int32)
    m = torch.cumprod(match, dim=-1).sum(dim=-1)                  # [B]
    greedy = temperature <= 0.0
    m = torch.where(greedy, m, torch.zeros_like(m))
    sampled0 = sample(logits[:, 0], temperature, top_k, top_p, seeds,
                      lengths + 1)
    rows = torch.arange(B, device=dev)
    correction = torch.where(greedy, preds[rows, m], sampled0)
    pos = torch.arange(R - 1, device=dev)[None, :]
    out = torch.where(pos < m[:, None], drafts, torch.zeros_like(drafts))
    out = torch.cat([out, torch.zeros((B, 1), dtype=torch.int32,
                                      device=dev)], dim=1)
    out[rows, m] = correction.to(torch.int32)
    return pool, out, (m + 1).to(torch.int32)


def _launch_state() -> collections.Counter:
    """Every kernel wrapper's launch counters as one Counter, keyed by
    (wrapper, "launches" | "window_launches" | a form of
    ``form_launches``): the state that ``launch_counts`` of
    ``ops/paged_attention.py``, ``ops/dense_attention.py`` and
    ``ops/split_kv.py`` report."""
    state = collections.Counter()
    for fn in (paged_attention.counted_wrappers()
               + dense_attention.counted_wrappers()
               + (split_kv.split_merge,)):
        state[fn, "launches"] = fn.launches
        if hasattr(fn, "window_launches"):
            state[fn, "window_launches"] = fn.window_launches
        for form, n in getattr(fn, "form_launches", {}).items():
            state[fn, form] = n
    return state


def _add_launches(delta: collections.Counter, times: int = 1) -> None:
    """Add ``times`` x ``delta`` (a difference of two :func:`_launch_state`)
    to the wrappers' counters."""
    for (fn, key), n in delta.items():
        if key in ("launches", "window_launches"):
            setattr(fn, key, getattr(fn, key) + n * times)
        else:
            fn.form_launches[key] += n * times


class DecodeGraphs:
    """The decode horizon over operand buffers that stay in place: the
    counterpart of the JAX package's jitted ``decode_steps`` with its
    static horizon, compiled ahead by ``EnginePrograms.warmup``.

    ``tokens``, ``lengths`` [B] int32, ``table`` [B, max_pages] int32 (None
    for the dense cache), ``temps``, ``top_ks``, ``top_ps`` and ``seeds``
    [B] are the operands; the caller copies its host values into them.
    :meth:`run` takes ``h`` substeps of :func:`decode_steps` for all B
    slots, returns out [h, B] and leaves the carry in place: ``tokens``
    becomes out[h - 1] and ``lengths`` advances by h, so the next run
    continues on the device without a host round trip.

    With ``capture`` (a CUDA device, no sp mesh), each (horizon in
    ``horizons``, any row samples) is captured once as a CUDA graph, after
    one eager horizon-1 warm-up per sampling flag on the capture stream (it
    builds the kernels, sets their shared-memory limits and allocates the
    split-KV workspace outside the graphs; its K/V rows land at row 0 of
    every slot, the paged ones in the scratch page). The graphs share one
    memory pool, and their out [h, B] is overwritten by the next replay.
    :meth:`run` is then one replay (a missing graph raises; nothing falls
    back to eager launches). The kernels' wrappers count nothing during a
    replay, so each graph records the launches its capture made and every
    replay adds them; ``replays`` counts the replays. Without ``capture``
    :meth:`run` calls :func:`decode_steps` on the same buffers.
    ``capture_s`` and ``pool_bytes`` (device memory the graphs reserved)
    describe the capture.
    """

    def __init__(self, model: DecoderLM, cache, num_slots: int,
                 max_pages: Optional[int], horizons, bblock: int = 1,
                 mesh=None, capture: bool = False):
        dev = mesh.lead if mesh is not None else model.device
        i32 = torch.int32
        self.model, self.cache = model, cache
        self.bblock, self.mesh = bblock, mesh
        self.tokens = torch.zeros(num_slots, dtype=i32, device=dev)
        self.lengths = torch.zeros(num_slots, dtype=i32, device=dev)
        self.table = None if max_pages is None else torch.zeros(
            (num_slots, max_pages), dtype=i32, device=dev)
        self.temps = torch.zeros(num_slots, device=dev)
        self.top_ks = torch.zeros(num_slots, dtype=i32, device=dev)
        self.top_ps = torch.ones(num_slots, device=dev)
        self.seeds = torch.zeros(num_slots, dtype=torch.int64, device=dev)
        self.graphs: dict = {}
        self.replays = 0
        self.capture_s = 0.0
        self.pool_bytes = 0
        self._workspace = None
        if capture:
            self._capture(sorted(set(horizons)))

    def _step(self, h: int, sampled: bool) -> torch.Tensor:
        _, out = decode_steps(self.model, h, self.cache, self.tokens,
                              self.lengths, self.table, self.temps,
                              self.top_ks, self.top_ps, self.seeds,
                              bblock=self.bblock, mesh=self.mesh,
                              any_sampled=sampled)
        self.tokens.copy_(out[-1])
        self.lengths.add_(h)
        return out

    def _capture(self, horizons) -> None:
        dev = self.tokens.device
        t0 = time.monotonic()
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            for sampled in (False, True):
                self._step(1, sampled)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        pool = torch.cuda.graph_pool_handle()
        for h in horizons:
            for sampled in (False, True):
                graph = torch.cuda.CUDAGraph()
                before = _launch_state()
                with torch.cuda.graph(graph, pool=pool, stream=stream):
                    out = self._step(h, sampled)
                captured = _launch_state() - before
                _add_launches(captured, -1)      # a capture launches nothing
                self.graphs[h, sampled] = (graph, out, captured)
        torch.cuda.synchronize(dev)
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self._workspace = split_kv.take_workspace(dev, stream.cuda_stream)
        self.capture_s = time.monotonic() - t0

    def run(self, h: int, sampled: bool) -> torch.Tensor:
        """``h`` substeps on the operand buffers; out [h, B] int32."""
        if not self.graphs:
            return self._step(h, sampled)
        if (h, sampled) not in self.graphs:
            raise RuntimeError(f"no decode graph of horizon {h} "
                               f"(captured: {sorted(self.graphs)})")
        graph, out, captured = self.graphs[h, sampled]
        graph.replay()
        self.replays += 1
        _add_launches(captured)
        return out
