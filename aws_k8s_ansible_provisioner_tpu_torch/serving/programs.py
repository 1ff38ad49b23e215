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
and under any mesh, it calls :func:`decode_steps`.

The paged pool serves the target model of the paged engine; the dense slot
cache (``kv_cache.init_cache``) the dense engine (``paged=False``) and the
draft model of speculative decoding, bf16/f32 or (the dense engine's) int8.
Under a mesh with ``sp`` > 1 the dense cache is a list of sequence shards
(``parallel/sharding.init_cache_sharded``): ``prefill_batch_step`` and
``prefill_chunk_step`` take it as it is (their callbacks write each row in
the shard that holds it), ``decode_steps`` takes the mesh. Under a (dp,
tp, ep) mesh the model is ``models/layers.MeshLM`` and the pool a
``parallel/sharding.ShardedPool``: every program runs unchanged, the
model splitting each forward's rows by dp group (the prefill takes the
rows' slots, ``row_slots``; the mixed dispatch's rows are slots and the
chunk's slot) and gathering the full-vocabulary logits on the lead, where
the sampling and the logit processing read them.

Each honours the model's ``cfg.sliding_window`` in every attention of the
step (prefill, decode, chunk rows and verify rows alike).

Each takes the rows' ``seeds`` ([B] uint32 values held in int64) and keys
its draws at the JAX programs' counters (``ops/sampling.per_slot_keys``):
a prefill row at its prompt length, a decode row at its length + 1 (the
context the draw extends to), the chunk row at ``pstart + plen`` (a dense
chunk at ``start + chunk_len``), a verify row 0 at its length + 1.

Each processes its logits in the JAX programs' order before it samples:
the presence, frequency and repetition penalties (decode rows, over a
[B, V] count carry that each substep updates; a prefill or chunk row's
repetition over its prompt), the OpenAI ``logit_bias``, then the
``min_tokens`` ban of the stop tokens, evaluated against the row's length
at that substep; the logprobs (:func:`_logprob_topk`) are taken from the
processed logits, the prompt logprobs (:func:`_prompt_logprobs`) from the
raw ones. A bias or ban entry that names no token of the vocabulary (the
JAX programs' pad ``NO_TOKEN``) is masked, never indexed. After the ban
comes the guided-decoding allow-mask (``allow`` [rows, ceil(V/32)] int32
words, ``ops/sampling.apply_allow``; all-ones for an unguided row), unpacked
once a dispatch: the decode horizon reuses substep 0's mask, as the JAX
program does, and ``mixed_step`` masks the chunk row with ``pallow``.

Each takes the rows' LoRA adapter indices (``lora_idx``, 0 = base; only
when adapters are attached, ``models/lora.py``): one per row, or in
``mixed_step`` one per packed token, the chunk's rows taking
``lora_idx[pslot]``.
"""

from __future__ import annotations

import collections
import time
from typing import Optional

import numpy as np
import torch

from aws_k8s_ansible_provisioner_tpu_torch.models.layers import DecoderLM
from aws_k8s_ansible_provisioner_tpu_torch.ops import (dense_attention, moe,
                                                       paged_attention,
                                                       split_kv)
from aws_k8s_ansible_provisioner_tpu_torch.ops.attention import (
    make_chunk_prefill_attend, make_decode_attend_carry,
    make_decode_attend_carry_paged, make_mixed_attend_carry_paged,
    make_prefill_attend_batch, make_prefill_attend_batch_paged_carry,
    make_spec_attend_carry, make_spec_attend_carry_paged)
from aws_k8s_ansible_provisioner_tpu_torch.ops.sampling import (
    allow_banned, apply_allow, apply_penalties, sample)

# The JAX programs' static widths (their serving/programs.py): the top-k of
# a logprob record, a slot's min_tokens ban list (its eos set and stop
# token ids) and its logit_bias list
LOGPROB_K = 8
BAN_K = 8
BIAS_K = 64
# the JAX programs' id of an unused ban or bias entry: out of every
# vocabulary (their scatters drop it; the helpers here mask it)
NO_TOKEN = 2**31 - 1


def _vocab_ids(ids: torch.Tensor, V: int):
    """(ids as int64 indices into a vocabulary of V, valid [same shape]):
    a negative id counts from the end, as JAX's indexing does, and an id
    that still lies outside [0, V) (``NO_TOKEN``) becomes 0 with valid
    False, so that no scatter ever indexes outside the vocabulary."""
    ids = ids.long()
    ids = torch.where(ids < 0, ids + V, ids)
    valid = (ids >= 0) & (ids < V)
    return torch.where(valid, ids, torch.zeros_like(ids)), valid


def _bias_rows(bias_ids: torch.Tensor, bias_vals: torch.Tensor, V: int,
               dtype: torch.dtype):
    """Bias rows ready for :func:`_add_bias`: ids in [0, V), values in
    ``dtype`` and 0.0 where the id names no token (token 0 takes it, exact).
    A dispatch prepares them once for all its substeps."""
    ids, valid = _vocab_ids(bias_ids, V)
    vals = bias_vals.to(dtype)
    return ids, torch.where(valid, vals, torch.zeros_like(vals))


def _add_bias(logits: torch.Tensor, rows) -> torch.Tensor:
    ids, vals = rows
    return logits.scatter_add(1, ids, vals)


def _apply_logit_bias(logits: torch.Tensor, bias_ids: Optional[torch.Tensor],
                      bias_vals: Optional[torch.Tensor]) -> torch.Tensor:
    """The OpenAI ``logit_bias``: bias_vals [B, BIAS_K] added to the logits
    [B, V] at bias_ids [B, BIAS_K], in the logits' dtype, before every draw
    (greedy ones too: -100 and +100 ban and force)."""
    if bias_ids is None:
        return logits
    return _add_bias(logits, _bias_rows(bias_ids, bias_vals,
                                        logits.shape[-1], logits.dtype))


def _ban_rows(ban_ids: torch.Tensor, V: int, dtype: torch.dtype):
    """Ban rows ready for :func:`_ban`: (ids in [0, V), valid, -inf and
    +inf of their shape in ``dtype``), prepared once a dispatch."""
    ids, valid = _vocab_ids(ban_ids, V)
    inf = torch.full(ids.shape, float("inf"), dtype=dtype,
                     device=ids.device)
    return ids, valid, -inf, inf


def _ban(logits: torch.Tensor, rows, ban_until: torch.Tensor,
         lens: torch.Tensor) -> torch.Tensor:
    ids, valid, neg, pos = rows
    live = valid & (lens < ban_until)[:, None]
    return logits.scatter_reduce(1, ids, torch.where(live, neg, pos),
                                 reduce="amin")


def _mask_banned(logits: torch.Tensor, ban_ids: Optional[torch.Tensor],
                 ban_until: Optional[torch.Tensor],
                 lens: torch.Tensor) -> torch.Tensor:
    """vLLM's ``min_tokens``: while a row's context length ``lens`` is below
    ``ban_until`` (prompt length + min_tokens), its stop tokens ban_ids
    [B, BAN_K] get -inf before the draw, so a suppressed stop token is
    never produced. A minimum scatter: a live entry takes -inf, any other
    +inf (no change), so the order of duplicate ids does not matter."""
    if ban_ids is None:
        return logits
    return _ban(logits, _ban_rows(ban_ids, logits.shape[-1], logits.dtype),
                ban_until, lens)


def _apply_allow(logits: torch.Tensor, allow: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """The guided allow-mask of a prefill or chunk row (None: no row of the
    dispatch is guided)."""
    return logits if allow is None else apply_allow(logits, allow)


def allow_words(rows: int, V: int, device) -> torch.Tensor:
    """[rows, ceil(V/32)] int32 allow words that allow every token."""
    return torch.full((rows, (V + 31) // 32), -1, dtype=torch.int32,
                      device=device)


def _apply_prefill_repetition(logits: torch.Tensor, tokens: torch.Tensor,
                              true_lens: torch.Tensor,
                              reps: Optional[torch.Tensor]) -> torch.Tensor:
    """``repetition_penalty`` of a prefill row's draw (its first token):
    every token of its prompt (tokens [N, T], true_lens [N] valid) is seen.
    A padded position names its row's first token, already seen."""
    if reps is None:
        return logits
    N, V = logits.shape
    cols = torch.arange(tokens.shape[1], device=tokens.device)[None]
    ids = torch.where(cols < true_lens[:, None], tokens, tokens[:, :1])
    seen = torch.zeros((N, V), dtype=torch.bool, device=logits.device) \
        .scatter_(1, ids.long(), True)
    return _repetition(logits, seen, reps.float()[:, None])


def _repetition(logits: torch.Tensor, seen: torch.Tensor, r) -> torch.Tensor:
    """The multiplicative repetition penalty ``r`` over the ``seen`` tokens:
    a positive logit divided by it, any other multiplied (float32)."""
    out = logits.float()
    return torch.where(seen, torch.where(out > 0, out / r, out * r), out)


def _logprob_topk(logits: torch.Tensor, chosen: torch.Tensor):
    """(chosen logprob [B], top-k logprobs [B, K], their ids [B, K] int32)
    from logits [B, V]: the OpenAI ``logprobs`` record, K = LOGPROB_K."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    sel = logp.gather(1, chosen.long()[:, None])[:, 0]
    vals, ids = torch.topk(logp, min(LOGPROB_K, logp.shape[-1]), dim=-1)
    return sel, vals, ids.to(torch.int32)


def _prompt_logprobs(logits: torch.Tensor, tokens: torch.Tensor,
                     n_pos: int, block_bytes: int = 1 << 26):
    """Per-position prompt logprobs (vLLM ``prompt_logprobs``): entry t
    scores prompt token t + 1 given the tokens up to t, for t < n_pos - 1.
    logits [N, T, V], tokens [N, T]. A block of positions at a time, each
    block's float32 log-softmax at most ``block_bytes``: never the whole
    [N, T, V]. Returns (sel [N, n], vals [N, n, K], ids [N, n, K])."""
    N, _, V = logits.shape
    n = max(0, n_pos - 1)
    K = min(LOGPROB_K, V)
    step = max(1, block_bytes // (4 * N * V))
    sel, vals, ids = [], [], []
    for t0 in range(0, n, step):
        t1 = min(n, t0 + step)
        logp = torch.log_softmax(logits[:, t0:t1].float(), dim=-1)
        sel.append(logp.gather(2, tokens[:, t0 + 1:t1 + 1, None].long())
                   [..., 0])
        v, i = torch.topk(logp, K, dim=-1)
        vals.append(v)
        ids.append(i.to(torch.int32))
    if not sel:
        dev = logits.device
        return (torch.zeros((N, 0), device=dev),
                torch.zeros((N, 0, K), device=dev),
                torch.zeros((N, 0, K), dtype=torch.int32, device=dev))
    return torch.cat(sel, 1), torch.cat(vals, 1), torch.cat(ids, 1)


def _host_lp(lp_t, row: int, k: int):
    """One row of a host (sel, vals, ids) triple as the engine's logprob
    record: (own logprob, [(token id, logprob) x k])."""
    sel, vals, ids = lp_t
    k = min(k, len(ids[row]))
    return (float(sel[row]), [(int(ids[row][j]), float(vals[row][j]))
                              for j in range(k)])


def _process(logits: torch.Tensor, lens: torch.Tensor, counts=None,
             presence=None, frequency=None, repetition=None,
             prompt_mask=None, bias=None, ban=None,
             ban_until=None) -> torch.Tensor:
    """A decode row's logits [B, V] in the JAX order: the penalties over
    ``counts`` when given (in float32), the bias (``bias``:
    :func:`_bias_rows`), then the ban (``ban``: :func:`_ban_rows`) at the
    rows' lengths ``lens``."""
    if counts is not None:
        logits = apply_penalties(logits, counts, presence, frequency,
                                 repetition, prompt_mask)
    if bias is not None:
        logits = _add_bias(logits, bias)
    if ban is not None:
        logits = _ban(logits, ban, ban_until, lens)
    return logits


def _logit_rows(logits: torch.Tensor, penalties: bool, ban_ids, bias_ids,
                bias_vals):
    """(bias rows, ban rows) of a dispatch, for the dtype its processed
    logits take (float32 under the penalties, else the model's)."""
    V = logits.shape[-1]
    dtype = torch.float32 if penalties else logits.dtype
    return (None if bias_ids is None
            else _bias_rows(bias_ids, bias_vals, V, dtype),
            None if ban_ids is None else _ban_rows(ban_ids, V, dtype))


def prefill_batch_step(model: DecoderLM, pool: dict, tokens: torch.Tensor,
                       true_lens: torch.Tensor, tables: Optional[torch.Tensor],
                       temperature: torch.Tensor, top_k: torch.Tensor,
                       top_p: torch.Tensor, seeds: torch.Tensor,
                       slots: Optional[torch.Tensor] = None,
                       ban_ids=None, ban_until=None, bias_ids=None,
                       bias_vals=None, reps=None, allow=None, lora_idx=None,
                       logprobs: bool = False, prompt_logprobs: int = 0,
                       row_slots=None):
    """Prefill N prompts in one forward pass.

    tokens: [N, T] right-padded; true_lens [N]; tables [N, max_pages] int32
    (rows of OOB_PAGE drop) for the paged pool, or ``tables=None`` and
    ``slots`` [N] (slots outside the cache drop) for the dense cache; seeds
    [N]. Each row's last logits go on in float32 (the JAX engine always
    hands its prefills a repetition factor, which casts them) through the
    repetition penalty over its prompt (``reps`` [N]; None when no row
    penalizes), the bias ([N, BIAS_K]), the ban ([N, BAN_K], at the
    prompt's length) and the allow words ([N, ceil(V/32)]; None when no row
    is guided); ``lora_idx`` [N] the rows' adapters. Returns (pool, first
    tokens [N] int32), then with ``logprobs`` their (sel, vals, ids)
    records, then with
    ``prompt_logprobs`` (the longest prompt that asks) the prompts' records
    (:func:`_prompt_logprobs`). ``row_slots`` (host, [N]): the prompts'
    slots, which a dp mesh's model splits the rows by.
    """
    N, T = tokens.shape
    positions = torch.arange(T, dtype=torch.int32,
                             device=tokens.device)[None].expand(N, T)
    window = model.cfg.sliding_window
    attend = make_prefill_attend_batch(slots, true_lens, window) \
        if tables is None else \
        make_prefill_attend_batch_paged_carry(tables, true_lens, window,
                                              row_slots)
    logits, pool = model.forward_carry(tokens, positions, pool, attend,
                                       model.lora_rows(lora_idx))
    last = logits[torch.arange(N, device=tokens.device),
                  true_lens.long() - 1].float()
    last = _apply_prefill_repetition(last, tokens, true_lens, reps)
    last = _apply_logit_bias(last, bias_ids, bias_vals)
    last = _mask_banned(last, ban_ids, ban_until, true_lens)
    last = _apply_allow(last, allow)
    toks = sample(last, temperature, top_k, top_p, seeds, true_lens)
    out = [pool, toks]
    if logprobs:
        out.append(_logprob_topk(last, toks))
    if prompt_logprobs:
        out.append(_prompt_logprobs(logits, tokens, prompt_logprobs))
    return tuple(out)


def prefill_chunk_step(model: DecoderLM, cache: dict, tokens: torch.Tensor,
                       start: int, slot: int, chunk_len: int,
                       temperature: torch.Tensor, top_k: torch.Tensor,
                       top_p: torch.Tensor, seed: torch.Tensor,
                       ban_ids=None, ban_until=None, bias_ids=None,
                       bias_vals=None, rep: float = 1.0, rep_seen=None,
                       allow=None, lora_idx=None, logprobs: bool = False):
    """Prefill one chunk of a long prompt into slot ``slot`` of the dense
    cache, at rows [start, start + C) (the JAX program's ``pages=None``
    branch).

    tokens: [1, C] (the final chunk right-padded), ``chunk_len`` of them
    valid; temperature/top_k/top_p/seed: [1]. The chunk's rows are written
    (quantized into an int8 cache), then its queries attend the slot's rows
    up to their own. Returns (cache, token [1]) sampled from the chunk's
    last valid row with the seeded counter ``start + chunk_len``, the
    context length at the final chunk (the only one whose token the engine
    keeps), so a seeded stream does not depend on the chunking. The row's
    logits go on in float32 through the repetition penalty ``rep`` over
    ``rep_seen`` ([V] bool, the whole context's tokens; skipped at 1.0),
    the bias ([1, BIAS_K]), the ban ([1, BAN_K], at ``start +
    chunk_len``) and the allow words ([1, ceil(V/32)] or None);
    ``lora_idx`` [1] the slot's adapter. With ``logprobs`` the token's
    record follows.
    """
    C = tokens.shape[1]
    positions = start + torch.arange(C, dtype=torch.int32,
                                     device=tokens.device)[None]
    attend = make_chunk_prefill_attend(slot, start, model.cfg.sliding_window)
    logits, cache = model.forward_carry(tokens, positions, cache, attend,
                                        model.lora_rows(lora_idx))
    last = logits[0, chunk_len - 1][None].float()
    if rep != 1.0:
        last = _repetition(last, rep_seen[None], np.float32(rep))
    ctr = torch.tensor([start + chunk_len], dtype=torch.int32,
                       device=tokens.device)
    last = _apply_logit_bias(last, bias_ids, bias_vals)
    last = _mask_banned(last, ban_ids, ban_until, ctr)
    last = _apply_allow(last, allow)
    token = sample(last, temperature, top_k, top_p, seed, ctr)
    if logprobs:
        return cache, token, _logprob_topk(last, token)
    return cache, token


def decode_steps(model: DecoderLM, n_steps: int, pool,
                 tokens: torch.Tensor, lengths: torch.Tensor,
                 table: Optional[torch.Tensor], temperature: torch.Tensor,
                 top_k: torch.Tensor, top_p: torch.Tensor,
                 seeds: torch.Tensor, bblock: int = 1, mesh=None,
                 any_sampled: Optional[bool] = None, counts=None,
                 presence=None, frequency=None, repetition=None,
                 prompt_mask=None, ban_ids=None, ban_until=None,
                 bias_ids=None, bias_vals=None, allow=None, lora_idx=None,
                 logprobs: bool = False):
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

    Each substep's logits go through :func:`_process`: with ``counts``
    ([B, V] int32, the generated tokens' counts, updated in place by every
    substep's draws, so a repeat inside the horizon is penalized) the
    penalties (presence, frequency, repetition [B]; prompt_mask [B, V]),
    then the bias (bias_ids, bias_vals [B, BIAS_K]) and the ban (ban_ids
    [B, BAN_K], ban_until [B]) at the substep's lengths, then the allow
    words (``allow`` [B, ceil(V/32)], unpacked once: every substep reuses
    substep 0's mask). ``lora_idx`` [B]: the slots' adapters (their rows
    built once for the horizon).
    Returns (pool, out [n_steps, B]); with ``logprobs`` out is (tokens
    [n_steps, B], (sel [n_steps, B], vals and ids [n_steps, B, K])). Slots
    that stop mid-horizon produce surplus tokens the host discards (and
    count them: a slot's count row is reset when a request takes it);
    their surplus K/V rows land past the slot's length (or drop past the
    window).
    """
    out, lps = [], []
    tok, lens = tokens, lengths
    window = model.cfg.sliding_window
    rows = torch.arange(tokens.shape[0], device=tokens.device)
    bias = ban = None
    # the allow mask and the adapters' rows once for the whole horizon
    banned = None if allow is None \
        else allow_banned(allow, model.cfg.vocab_size)
    lora = model.lora_rows(lora_idx)
    for i in range(n_steps):
        attend = make_decode_attend_carry(lens, window, bblock, mesh) \
            if table is None \
            else make_decode_attend_carry_paged(lens, table, window)
        logits, pool = model.forward_carry(tok[:, None], lens[:, None], pool,
                                           attend, lora)
        if i == 0:
            # the bias and ban rows once for the whole horizon
            bias, ban = _logit_rows(logits, counts is not None, ban_ids,
                                    bias_ids, bias_vals)
        step_logits = _process(logits[:, 0], lens, counts, presence,
                               frequency, repetition, prompt_mask, bias, ban,
                               ban_until)
        if banned is not None:
            step_logits = apply_allow(step_logits, None, banned)
        tok = sample(step_logits, temperature, top_k, top_p, seeds,
                     lens + 1, any_sampled)
        if counts is not None:
            counts.index_put_((rows, tok.long()),
                              torch.ones_like(tok, dtype=counts.dtype),
                              accumulate=True)
        if logprobs:
            lps.append(_logprob_topk(step_logits, tok))
        lens = lens + 1
        out.append(tok)
    out = torch.stack(out)
    if logprobs:
        out = (out, tuple(torch.stack(a) for a in zip(*lps)))
    return pool, out


def mixed_step(model: DecoderLM, pool: dict, tokens: torch.Tensor,
               lengths: torch.Tensor, ptokens: torch.Tensor, pslot: int,
               pstart: int, plen: int, table: torch.Tensor,
               temperature: torch.Tensor, top_k: torch.Tensor,
               top_p: torch.Tensor, seeds: torch.Tensor, ptemp: float,
               ptop_k: int, ptop_p: float, pseed: int,
               any_sampled: Optional[bool] = None, counts=None,
               presence=None, frequency=None, repetition=None,
               prompt_mask=None, ban_ids=None, ban_until=None,
               bias_ids=None, bias_vals=None, prep: float = 1.0,
               prep_seen=None, allow=None, pallow=None, lora_idx=None,
               logprobs: bool = False, chunk_logprobs: bool = False,
               chunk_prompt_logprobs: int = 0):
    """One ragged dispatch: a decode step for every slot AND one prefill
    chunk (``ptokens`` [1, C], ``plen`` valid) of slot ``pslot`` at rows
    [pstart, pstart + C). The chunk row samples with (ptemp, ptop_k,
    ptop_p) and seed ``pseed``; ``any_sampled`` is ``sample``'s for the
    decode rows. The chunk row's operands are filled on the device, not
    uploaded, so the dispatch can be queued behind one in flight: its bias
    and ban rows are ``pslot``'s rows of the decode operands, its
    repetition ``prep`` over ``prep_seen`` ([V] bool on the device, the
    whole context's tokens; skipped at 1.0).

    The decode rows' logits take :func:`decode_steps`' processing (the
    penalties with ``counts``, whose rows each count their draw, then the
    allow words ``allow`` [B, ceil(V/32)]); the chunk's last valid row takes
    :func:`prefill_chunk_step`'s (float32, repetition, bias, the ban at
    ``pstart + plen``, then ``pallow`` [1, ceil(V/32)] when the chunking
    request is guided). ``lora_idx`` [B]: the slots' adapters; the packed
    rows take them per token, the chunk's rows ``lora_idx[pslot]``.

    Returns (pool, out [1, B], chunk token [1]); ``out[0, pslot]`` is the
    dead passenger's token and is discarded. With ``logprobs`` out is
    (tokens, records of the decode rows with a leading axis of 1), with
    ``chunk_logprobs`` the chunk token is (token, its record); with
    ``chunk_prompt_logprobs`` (the chunk holds the whole prompt, whose
    length it is) the chunk's prompt records (:func:`_prompt_logprobs`)
    follow as a fourth element.
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
    attend = make_mixed_attend_carry_paged(
        write_rows.to(i32), row_limits.to(i32), row_tables,
        model.cfg.sliding_window, chunk_start=B,
        row_slots=np.concatenate([np.arange(B), np.full(C, pslot)]))
    lora = None if lora_idx is None else model.lora_rows(
        torch.cat([lora_idx, lora_idx[pslot].expand(C)])[None])
    logits, pool = model.forward_carry(packed, positions, pool, attend,
                                       lora)
    bias, ban = _logit_rows(logits, counts is not None, ban_ids, bias_ids,
                            bias_vals)
    dec = _process(logits[0, :B], lengths, counts, presence, frequency,
                   repetition, prompt_mask, bias, ban, ban_until)
    dec = _apply_allow(dec, allow)
    nxt = sample(dec, temperature, top_k, top_p, seeds, lengths + 1,
                 any_sampled)
    if counts is not None:
        # pslot's lane counts the dead passenger's draw: the activation's
        # reset (or restore) of its row wipes it
        counts.index_put_((torch.arange(B, device=dev), nxt.long()),
                          torch.ones_like(nxt, dtype=counts.dtype),
                          accumulate=True)
    plast = logits[0, B + plen - 1][None].float()
    if prep != 1.0:
        plast = _repetition(plast, prep_seen[None], np.float32(prep))

    def one(value, dtype):
        return torch.full((1,), value, dtype=dtype, device=dev)

    pctr = one(pstart + plen, torch.int64)
    if bias_ids is not None:
        plast = _apply_logit_bias(plast, bias_ids[pslot][None],
                                  bias_vals[pslot][None])
    if ban_ids is not None:
        plast = _mask_banned(plast, ban_ids[pslot][None],
                             ban_until[pslot][None], pctr)
    plast = _apply_allow(plast, pallow)
    ptok = sample(plast, one(ptemp, torch.float32), one(ptop_k, i32),
                  one(ptop_p, torch.float32), one(pseed, torch.int64),
                  pctr, ptemp > 0)
    out = nxt[None]
    if logprobs:
        out = (out, tuple(a[None] for a in _logprob_topk(dec, nxt)))
    pout = (ptok, _logprob_topk(plast, ptok)) if chunk_logprobs else ptok
    if chunk_prompt_logprobs:
        return pool, out, pout, _prompt_logprobs(
            logits[:, B:], ptokens, chunk_prompt_logprobs)
    return pool, out, pout


def spec_decode_step(model: DecoderLM, R: int, pool: dict,
                     tokens: torch.Tensor, lengths: torch.Tensor,
                     table: Optional[torch.Tensor], temperature: torch.Tensor,
                     top_k: torch.Tensor, top_p: torch.Tensor,
                     seeds: torch.Tensor, lora_idx=None):
    """Speculative verify: R tokens per slot in one forward pass.

    tokens: [B, R] = [last emitted token, R - 1 drafts] at positions
    ``lengths[b] + r``; table [B, max_pages] int32 for the paged pool (its
    pages must cover ``lengths + R``), None for the dense cache. Returns
    (pool, out [B, R], accepted [B]): ``out[b, :accepted[b]]`` are the
    emitted tokens, the longest draft prefix that matches the model's
    argmax at every row, then the argmax after it (each slot through its
    adapter, ``lora_idx`` [B]). A sampled slot
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
    logits, pool = model.forward_carry(tokens, positions, pool, attend,
                                       model.lora_rows(lora_idx))
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
    ``ops/paged_attention.py``, ``ops/dense_attention.py``,
    ``ops/split_kv.py`` and ``ops/moe.py`` report."""
    state = collections.Counter()
    for fn in (paged_attention.counted_wrappers()
               + dense_attention.counted_wrappers()
               + (split_kv.split_merge,) + moe.counted_wrappers()):
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
    [B], the logit operands ``ban_ids`` [B, BAN_K], ``ban_until`` [B],
    ``bias_ids``, ``bias_vals`` [B, BIAS_K], ``presence``, ``frequency``,
    ``repetition`` [B], ``prompt_mask`` [B, V] bool, the guided allow words
    ``allow`` [B, ceil(V/32)] int32 (all ones for an unguided slot) and,
    when ``model`` has adapters attached, the adapter indices ``lora_idx``
    [B] are the operands; the caller copies its host values into them.
    ``counts`` [B, V] int32 is the penalties' carry, updated in place by
    every substep of a penalties
    variant (the caller resets or restores a slot's row when a request
    takes it). :meth:`run` takes ``h`` substeps of :func:`decode_steps` for
    all B slots, returns out [h, B] (with logprobs, (out, records)) and
    leaves the carry in place: ``tokens`` becomes out[h - 1] and
    ``lengths`` advances by h, so the next run continues on the device
    without a host round trip. The bias, the ban and the allow words are
    always on (an unused entry is masked, an all-ones row allows every
    token: operands, not variants, so a guided request doubles no graph);
    the adapter indices are on when adapters are attached; the penalties
    and the logprobs are variants.

    With ``capture`` (a CUDA device, no mesh), each (horizon in
    ``horizons``, any row samples, penalties, logprobs) is captured once as
    a CUDA graph when the engine is built (the first penalized or logprob
    request pays no capture), after one eager horizon-1 warm-up per variant
    on the capture stream (it builds the kernels, sets their shared-memory
    limits and allocates the split-KV workspace outside the graphs; its K/V
    rows land at row 0 of every slot, the paged ones in the scratch page;
    the counts it added are zeroed). The graphs share one memory pool, and
    their outputs are overwritten by the next replay. :meth:`run` is then
    one replay (a missing graph raises; nothing falls back to eager
    launches). The kernels' wrappers count nothing during a replay, so each
    graph records the launches its capture made and every replay adds
    them; ``replays`` counts the replays (``variant_replays`` by
    (penalties, logprobs)). Without ``capture`` :meth:`run`
    calls :func:`decode_steps` on the same buffers. ``capture_s`` and
    ``pool_bytes`` (device memory the graphs reserved) describe the
    capture.
    """

    VARIANTS = tuple((s, p, lp) for s in (False, True) for p in (False, True)
                     for lp in (False, True))

    def __init__(self, model: DecoderLM, cache, num_slots: int,
                 max_pages: Optional[int], horizons, bblock: int = 1,
                 mesh=None, capture: bool = False):
        dev = mesh.lead if mesh is not None else model.device
        i32 = torch.int32
        B, V = num_slots, model.cfg.vocab_size
        self.model, self.cache = model, cache
        self.bblock, self.mesh = bblock, mesh
        self.tokens = torch.zeros(B, dtype=i32, device=dev)
        self.lengths = torch.zeros(B, dtype=i32, device=dev)
        self.table = None if max_pages is None else torch.zeros(
            (B, max_pages), dtype=i32, device=dev)
        self.temps = torch.zeros(B, device=dev)
        self.top_ks = torch.zeros(B, dtype=i32, device=dev)
        self.top_ps = torch.ones(B, device=dev)
        self.seeds = torch.zeros(B, dtype=torch.int64, device=dev)
        self.ban_ids = torch.full((B, BAN_K), NO_TOKEN, dtype=i32, device=dev)
        self.ban_until = torch.zeros(B, dtype=i32, device=dev)
        self.bias_ids = torch.full((B, BIAS_K), NO_TOKEN, dtype=i32,
                                   device=dev)
        self.bias_vals = torch.zeros((B, BIAS_K), device=dev)
        self.presence = torch.zeros(B, device=dev)
        self.frequency = torch.zeros(B, device=dev)
        self.repetition = torch.ones(B, device=dev)
        self.counts = torch.zeros((B, V), dtype=i32, device=dev)
        self.prompt_mask = torch.zeros((B, V), dtype=torch.bool, device=dev)
        self.allow = allow_words(B, V, dev)
        self.lora_idx = torch.zeros(B, dtype=i32, device=dev) \
            if model.has_lora else None
        self.graphs: dict = {}
        self.replays = 0
        # replays by (penalties, logprobs)
        self.variant_replays: collections.Counter = collections.Counter()
        self.capture_s = 0.0
        self.pool_bytes = 0
        self._workspace = None
        if capture:
            self._capture(sorted(set(horizons)))

    def _step(self, h: int, sampled: bool, penalties: bool = False,
              logprobs: bool = False):
        pen = dict(counts=self.counts, presence=self.presence,
                   frequency=self.frequency, repetition=self.repetition,
                   prompt_mask=self.prompt_mask) if penalties else {}
        _, out = decode_steps(self.model, h, self.cache, self.tokens,
                              self.lengths, self.table, self.temps,
                              self.top_ks, self.top_ps, self.seeds,
                              bblock=self.bblock, mesh=self.mesh,
                              any_sampled=sampled, ban_ids=self.ban_ids,
                              ban_until=self.ban_until,
                              bias_ids=self.bias_ids,
                              bias_vals=self.bias_vals, allow=self.allow,
                              lora_idx=self.lora_idx, logprobs=logprobs,
                              **pen)
        toks = out[0] if logprobs else out
        self.tokens.copy_(toks[-1])
        self.lengths.add_(h)
        return out

    def _capture(self, horizons) -> None:
        dev = self.tokens.device
        t0 = time.monotonic()
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            for variant in self.VARIANTS:
                self._step(1, *variant)
            self.counts.zero_()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        pool = torch.cuda.graph_pool_handle()
        for h in horizons:
            for variant in self.VARIANTS:
                graph = torch.cuda.CUDAGraph()
                before = _launch_state()
                with torch.cuda.graph(graph, pool=pool, stream=stream):
                    out = self._step(h, *variant)
                captured = _launch_state() - before
                _add_launches(captured, -1)      # a capture launches nothing
                self.graphs[(h,) + variant] = (graph, out, captured)
        torch.cuda.synchronize(dev)
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self._workspace = split_kv.take_workspace(dev, stream.cuda_stream)
        self.capture_s = time.monotonic() - t0

    def run(self, h: int, sampled: bool, penalties: bool = False,
            logprobs: bool = False):
        """``h`` substeps on the operand buffers: out [h, B] int32, with
        ``logprobs`` (out, (sel [h, B], vals [h, B, K], ids [h, B, K]))."""
        if not self.graphs:
            return self._step(h, sampled, penalties, logprobs)
        key = (h, sampled, penalties, logprobs)
        if key not in self.graphs:
            raise RuntimeError(f"no decode graph of horizon {h} "
                               f"(captured: {sorted(self.graphs)})")
        graph, out, captured = self.graphs[key]
        graph.replay()
        self.replays += 1
        self.variant_replays[penalties, logprobs] += 1
        _add_launches(captured)
        return out
