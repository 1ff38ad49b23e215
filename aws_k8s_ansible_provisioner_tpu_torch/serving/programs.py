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
  dead passenger: write row -1 (dropped), limit 0;
- :func:`spec_decode_step`: R tokens per slot (the last emitted token and
  R - 1 drafts) in one forward pass, greedy acceptance of the longest
  matching draft prefix.

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

from typing import Optional

import torch

from aws_k8s_ansible_provisioner_tpu_torch.models.layers import DecoderLM
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
                 seeds: torch.Tensor, bblock: int = 1, mesh=None):
    """``n_steps`` decode substeps for every slot.

    tokens/lengths: [B] int32 (the token to feed and the row it lands at);
    table: [B, max_pages] int32 for the paged pool, None for the dense
    cache; seeds [B]; ``bblock``: slots per CTA of the dense cache's decode
    kernel (K5 when > 1; the paged kernel takes none); ``mesh``: with an
    ``sp`` axis larger than 1, the dense cache is a list of sequence shards
    and each substep attends them through K6 and the log-sum-exp merge.
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
                     lens + 1)
        lens = lens + 1
        out.append(tok)
    return pool, torch.stack(out)


def mixed_step(model: DecoderLM, pool: dict, tokens: torch.Tensor,
               lengths: torch.Tensor, ptokens: torch.Tensor, pslot: int,
               pstart: int, plen: int, table: torch.Tensor,
               temperature: torch.Tensor, top_k: torch.Tensor,
               top_p: torch.Tensor, seeds: torch.Tensor, ptemp: float,
               ptop_k: int, ptop_p: float, pseed: int):
    """One ragged dispatch: a decode step for every slot AND one prefill
    chunk (``ptokens`` [1, C], ``plen`` valid) of slot ``pslot`` at rows
    [pstart, pstart + C). The chunk row samples with (ptemp, ptop_k,
    ptop_p) and seed ``pseed``.

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
                                           model.cfg.sliding_window)
    logits, pool = model.forward_carry(packed, positions, pool, attend)
    nxt = sample(logits[0, :B], temperature, top_k, top_p, seeds, lengths + 1)
    plast = logits[0, B + plen - 1][None]
    ptok = sample(plast, torch.tensor([ptemp], device=dev),
                  torch.tensor([ptop_k], dtype=i32, device=dev),
                  torch.tensor([ptop_p], device=dev),
                  torch.tensor([pseed], dtype=torch.int64, device=dev),
                  torch.tensor([pstart + plen], device=dev))
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
