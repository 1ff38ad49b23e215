"""Serving attention callbacks over the paged pool.

The attend callbacks that ``models/layers.model_forward_carry`` calls once
per layer with ``cache_l = (pool, layer)``; each writes the layer's new K/V
rows into the pool in place and attends:

- :func:`make_decode_attend_carry_paged`: one new token per slot
  (``decode_steps``);
- :func:`make_mixed_attend_carry_paged`: B decode rows and C prefill-chunk
  rows packed into one sequence (``mixed_step``);
- :func:`make_prefill_attend_batch_paged_carry`: whole prompts, causal
  attention over the prompt window plus the paged scatter (no kernel, as in
  the JAX package).

The decode and mixed callbacks go through the kernels of
``ops/paged_attention.py``: the row write and the attention over a bf16/f32
pool, or, when the pool carries scale leaves (``"ks" in pool``, int8 KV),
the quantizing row write and the scale-folding attention. As in the JAX
reference, all N row writes land before any row attends, so a chunk row
sees exactly its prefix and a decode row exactly its own slot. The prefill
callback attends over the fresh, unquantized K/V and scatters (quantized)
rows into the pool.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from aws_k8s_ansible_provisioner_tpu_torch.models.layers import causal_attend
from aws_k8s_ansible_provisioner_tpu_torch.ops.paged_attention import (
    cache_write_rows_paged, cache_write_rows_quant_paged, decode_attend_paged,
    ragged_attend_paged)
from aws_k8s_ansible_provisioner_tpu_torch.serving import paged_kv as pkv


def decode_attend(q: torch.Tensor, cache_k: torch.Tensor,
                  cache_v: torch.Tensor, lengths: torch.Tensor
                  ) -> torch.Tensor:
    """Plain dense decode attention, one new token per slot.

    q: [B, 1, Hq, D]; cache_k/v: [B, Hkv, S, D] already holding the new
    token's row; lengths: [B] valid rows per slot. Returns [B, 1, Hq, D].
    """
    B, _, Hq, D = q.shape
    Hkv, S = cache_k.shape[1], cache_k.shape[2]
    qg = q[:, 0].reshape(B, Hkv, Hq // Hkv, D).float()
    logits = torch.einsum("bkgd,bksd->bkgs", qg, cache_k.float()) \
        / math.sqrt(D)
    valid = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    ctx = torch.einsum("bkgs,bksd->bkgd", probs, cache_v.float())
    return ctx.reshape(B, 1, Hq, D).to(q.dtype)


def _write_rows(pool: dict, k_new: torch.Tensor, v_new: torch.Tensor,
                rows: torch.Tensor, layer: int, tables: torch.Tensor) -> dict:
    """The layer's new K/V rows into the pool through the row-write kernel
    (quantizing when the pool is int8); returns the scale pools as the
    attention kernels take them (none for a bf16/f32 pool)."""
    if "ks" in pool:
        cache_write_rows_quant_paged(pool["k"], pool["v"], pool["ks"],
                                     pool["vs"], k_new, v_new, rows, layer,
                                     tables)
        return {"pool_ks": pool["ks"], "pool_vs": pool["vs"]}
    cache_write_rows_paged(pool["k"], pool["v"], k_new, v_new, rows, layer,
                           tables)
    return {}


def make_decode_attend_carry_paged(lengths: torch.Tensor,
                                   table: torch.Tensor):
    """Decode over the paged pool: slot b writes its new K/V row at row
    ``lengths[b]`` and attends over ``lengths[b] + 1`` rows. lengths: [B]
    int32; table: [B, max_pages] int32."""
    limits = lengths + 1

    def attend(q, k, v, cache_l) -> Tuple[torch.Tensor, tuple]:
        pool, layer = cache_l
        scales = _write_rows(pool, k[:, 0].contiguous(), v[:, 0].contiguous(),
                             lengths, layer, table)
        ctx = decode_attend_paged(q, pool["k"], pool["v"], limits, layer,
                                  table, **scales)
        return ctx, (pool, layer)

    return attend


def make_mixed_attend_carry_paged(write_rows: torch.Tensor,
                                  row_limits: torch.Tensor,
                                  row_tables: torch.Tensor):
    """Ragged mixed batch over the paged pool: the packed sequence [1, N]
    holds B decode rows then C prefill-chunk rows. Per packed row i:
    ``write_rows[i]`` is where its K/V lands (-1 drops),
    ``row_limits[i]`` how many columns it attends, ``row_tables[i]`` its
    slot's page run (all int32)."""

    def attend(q, k, v, cache_l) -> Tuple[torch.Tensor, tuple]:
        pool, layer = cache_l
        scales = _write_rows(pool, k[0].contiguous(), v[0].contiguous(),
                             write_rows, layer, row_tables)
        ctx = ragged_attend_paged(q[0], pool["k"], pool["v"], row_limits,
                                  layer, row_tables, **scales)
        return ctx[None], (pool, layer)

    return attend


def make_prefill_attend_batch_paged_carry(tables: torch.Tensor,
                                          seq_lens: torch.Tensor):
    """Batched prefill over the paged pool: causal attention over each
    right-padded prompt's fresh K/V, then its rows scatter through
    ``tables`` (quantized into an int8 pool; padding rows carry OOB_PAGE
    and drop)."""

    def attend(q, k, v, cache_l):
        pool, layer = cache_l
        ctx = causal_attend(q, k, v, seq_lens=seq_lens)
        pool = pkv.write_prompts_paged_layer(pool, layer, tables, k, v,
                                             pool["k"].shape[3])
        return ctx, (pool, layer)

    return attend
