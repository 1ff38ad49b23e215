"""The engine's step programs: batched prefill, the fused decode horizon and
the ragged mixed dispatch.

Each is a plain function over the model (``models/layers.DecoderLM``), the
page pool (updated in place) and device tensors, with the JAX package's
``serving/programs.py`` semantics and operand layouts:

- :func:`prefill_batch_step`: N right-padded prompts in one forward pass,
  causal attention plus the paged scatter; samples each prompt's first token;
- :func:`decode_steps`: ``n_steps`` decode substeps for every slot (the
  fused horizon, here a Python loop), each writing one K/V row per slot at
  its length and attending through the paged kernel;
- :func:`mixed_step`: B decode rows and one C-row prefill chunk of slot
  ``pslot`` packed into one ``[1, B + C]`` sequence and served by one
  forward pass through the ragged kernel. ``pslot``'s own decode row is a
  dead passenger: write row -1 (dropped), limit 0.

Each takes the rows' ``seeds`` ([B] uint32 values held in int64) and keys
its draws at the JAX programs' counters (``ops/sampling.per_slot_keys``):
a prefill row at its prompt length, a decode row at its length + 1 (the
context the draw extends to), the chunk row at ``pstart + plen``.

Sampling penalties, logit bias, stop-token bans, guided masks, logprobs and
LoRA of the JAX programs are not ported yet.
"""

from __future__ import annotations

import torch

from aws_k8s_ansible_provisioner_tpu_torch.models.layers import DecoderLM
from aws_k8s_ansible_provisioner_tpu_torch.ops.attention import (
    make_decode_attend_carry_paged, make_mixed_attend_carry_paged,
    make_prefill_attend_batch_paged_carry)
from aws_k8s_ansible_provisioner_tpu_torch.ops.sampling import sample


def prefill_batch_step(model: DecoderLM, pool: dict, tokens: torch.Tensor,
                       true_lens: torch.Tensor, tables: torch.Tensor,
                       temperature: torch.Tensor, top_k: torch.Tensor,
                       top_p: torch.Tensor, seeds: torch.Tensor):
    """Prefill N prompts in one forward pass.

    tokens: [N, T] right-padded; true_lens [N]; tables [N, max_pages] int32
    (rows of OOB_PAGE drop); seeds [N]. Returns (pool, first tokens [N]
    int32).
    """
    N, T = tokens.shape
    positions = torch.arange(T, dtype=torch.int32,
                             device=tokens.device)[None].expand(N, T)
    attend = make_prefill_attend_batch_paged_carry(tables, true_lens)
    logits, pool = model.forward_carry(tokens, positions, pool, attend)
    last = logits[torch.arange(N, device=tokens.device), true_lens.long() - 1]
    return pool, sample(last, temperature, top_k, top_p, seeds, true_lens)


def decode_steps(model: DecoderLM, n_steps: int, pool: dict,
                 tokens: torch.Tensor, lengths: torch.Tensor,
                 table: torch.Tensor, temperature: torch.Tensor,
                 top_k: torch.Tensor, top_p: torch.Tensor,
                 seeds: torch.Tensor):
    """``n_steps`` decode substeps for every slot.

    tokens/lengths: [B] int32 (the token to feed and the row it lands at);
    table: [B, max_pages] int32; seeds [B]. Returns (pool, out [n_steps, B]). Slots
    that stop mid-horizon produce surplus tokens the host discards; their
    surplus K/V rows land past the slot's length (or drop past the
    window).
    """
    out = []
    tok, lens = tokens, lengths
    for _ in range(n_steps):
        attend = make_decode_attend_carry_paged(lens, table)
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
                                           row_limits.to(i32), row_tables)
    logits, pool = model.forward_carry(packed, positions, pool, attend)
    nxt = sample(logits[0, :B], temperature, top_k, top_p, seeds, lengths + 1)
    plast = logits[0, B + plen - 1][None]
    ptok = sample(plast, torch.tensor([ptemp], device=dev),
                  torch.tensor([ptop_k], dtype=i32, device=dev),
                  torch.tensor([ptop_p], device=dev),
                  torch.tensor([pseed], dtype=torch.int64, device=dev),
                  torch.tensor([pstart + plen], device=dev))
    return pool, nxt[None], ptok
