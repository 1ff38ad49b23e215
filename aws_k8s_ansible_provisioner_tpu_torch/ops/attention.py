"""Serving attention callbacks over the paged pool and the dense cache.

The attend callbacks that ``models/layers.model_forward_carry`` calls once
per layer with ``cache_l = (cache, layer)``; each writes the layer's new K/V
rows into the cache in place and attends. Over the paged pool:

- :func:`make_decode_attend_carry_paged`: one new token per slot
  (``decode_steps``);
- :func:`make_spec_attend_carry_paged`: R tokens per slot, the speculative
  verify (``spec_decode_step``);
- :func:`make_mixed_attend_carry_paged`: B decode rows and C prefill-chunk
  rows packed into one sequence (``mixed_step``);
- :func:`make_prefill_attend_batch_paged_carry`: whole prompts, causal
  attention over the prompt window plus the paged scatter (no kernel, as in
  the JAX package).

Over the dense slot cache (``kv_cache.init_cache``; the dense engine's,
``paged=False``, and the draft model's): :func:`make_decode_attend_carry`
(``bblock`` slots per CTA), :func:`make_spec_attend_carry` and
:func:`make_prefill_attend_batch`, the same three programs' callbacks, and
:func:`make_chunk_prefill_attend` (``prefill_chunk_step``: one chunk of a
long prompt, written, then attended by the plain :func:`chunk_attend` over
the slot's rows, dequantized from an int8 cache; no kernel, as in the JAX
package).

Sequence-parallel serving (a mesh with ``sp`` > 1) splits the dense
cache's sequence axis into shards (``parallel/sharding``: a list of cache
dicts, shard i holding the global rows [i * S_local, (i + 1) * S_local) on
its device). The decode callback writes each slot's new row in every shard
at its local row (the non-owners' rows fall outside [0, S_local) and
drop), attends each shard's rows through K6 and merges the shards' flash
triples with a log-sum-exp (:func:`merge_stats`) on the mesh's lead
device. The batched and chunk prefills write each row in the shard that
holds it; a chunk attends its slot's rows gathered from the shards in
order.

Tensor and data parallel serving (``models/layers.MeshLM``) runs the
paged callbacks per (dp group, tp shard): each carries ``rows``
(:class:`RowSplit`), from which the model rebuilds it over one group's
rows (a row's slot decides its group), its tables rebased from global to
the group's local page ids, its operands on the shard's device; a tp
shard's q, k and v hold its heads (Hq / tp, Hkv / tp) and its pool the
same kv heads, so the kernels run unchanged at the per-shard head counts.

The decode, verify and mixed callbacks go through the kernels of
``ops/paged_attention.py``: the row write and the attention over a bf16/f32
pool, or, when the pool carries scale leaves (``"ks" in pool``, int8 KV),
the quantizing row write and the scale-folding attention. They take the
layer's raw q and k rows and its ``QKPrep`` (``fuses_qk_prep``): the row
write is the fused one, which applies the q/k RMSNorm and RoPE in the
launch that writes K and V and hands the attention its q; RoPE over the
first ``prep.rotary_dim`` columns of a head, none at 0 (every family:
full, partial and absent RoPE, with or without the q/k norm). The dense decode,
verify and sequence-parallel decode go through ``ops/dense_attention.py``
the same way (the fused K8 or K9, then K4/K5, K7 or K6, bf16/f32 or int8).
The prefill and chunk-prefill callbacks take q and k after the block's
plain prologue. As in the JAX reference, all row writes land before
any row attends, so a chunk row sees exactly its prefix, a verify row
exactly the rows before it and a decode row exactly its own slot. The
batched prefill callbacks attend over the fresh, unquantized K/V and
scatter (quantized) rows into the cache. Every callback takes ``window``
(the model's ``sliding_window``; 0 for none) and hands it to the kernels
and to ``causal_attend``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from aws_k8s_ansible_provisioner_tpu_torch.models.layers import (
    QKPrep, causal_attend)
from aws_k8s_ansible_provisioner_tpu_torch.ops.dense_attention import (
    decode_attend_dense, decode_attend_dense_stats, prep_write_rows_dense,
    prep_write_rows_quant_dense, spec_attend_dense)
from aws_k8s_ansible_provisioner_tpu_torch.ops.paged_attention import (
    decode_attend_paged, decode_attend_spec_paged, prep_write_rows_paged,
    prep_write_rows_quant_paged, ragged_attend_paged)
from aws_k8s_ansible_provisioner_tpu_torch.parallel.sharding import (
    gather_rows, sp_size)
from aws_k8s_ansible_provisioner_tpu_torch.serving import kv_cache as kvc
from aws_k8s_ansible_provisioner_tpu_torch.serving import paged_kv as pkv


def decode_attend_multi(q: torch.Tensor, cache_k: torch.Tensor,
                        cache_v: torch.Tensor, base_lens: torch.Tensor,
                        window: int = 0) -> torch.Tensor:
    """Plain dense attention, R query rows per slot: the speculative
    verify's, and with R = 1 and ``base_lens = lengths - 1`` the decode
    step's (the JAX package's ``decode_attend``). The dense kernels' plain
    version (``ops/dense_attention.dense_attention_plain``) is built on it.

    q: [B, R, Hq, D]; cache_k/v: [B, Hkv, S, D] with rows base..base+R-1
    already written; query row r sees the columns < base_lens + 1 + r, of
    which the last ``window`` when it is > 0. Returns [B, R, Hq, D].
    """
    B, R, Hq, D = q.shape
    Hkv, S = cache_k.shape[1], cache_k.shape[2]
    qg = q.reshape(B, R, Hkv, Hq // Hkv, D).float()
    logits = torch.einsum("brkgd,bksd->brkgs", qg, cache_k.float()) \
        / math.sqrt(D)
    limit = base_lens[:, None] + 1 + torch.arange(R, device=q.device)
    col = torch.arange(S, device=q.device)[None, None, :]
    valid = col < limit[:, :, None]                             # [B, R, S]
    if window > 0:
        valid &= col >= limit[:, :, None] - window
    logits = torch.where(valid[:, :, None, None, :], logits,
                         torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    ctx = torch.einsum("brkgs,bksd->brkgd", probs, cache_v.float())
    return ctx.reshape(B, R, Hq, D).to(q.dtype)


def _prep_write_rows(pool: dict, q: torch.Tensor, k_new: torch.Tensor,
                     v_new: torch.Tensor, rows: torch.Tensor, layer: int,
                     tables: torch.Tensor, prep: QKPrep):
    """The layer's q/k prologue and its new K/V rows into the pool in one
    launch of the fused row write (quantizing when the pool is int8): q
    [N, Hq, D], k/v [N, Hkv, D] raw, ``prep``'s tables [N, r] (r the
    rotary width, 0 for none). Returns (q
    after the prologue, the scale pools as the attention kernels take them;
    none for a bf16/f32 pool)."""
    if "ks" in pool:
        q = prep_write_rows_quant_paged(pool["k"], pool["v"], pool["ks"],
                                        pool["vs"], q, k_new, v_new, rows,
                                        layer, tables, prep)
        return q, {"pool_ks": pool["ks"], "pool_vs": pool["vs"]}
    return prep_write_rows_paged(pool["k"], pool["v"], q, k_new, v_new, rows,
                                 layer, tables, prep), {}


def _packed(prep: QKPrep, n: int) -> QKPrep:
    """``prep`` with its cos/sin tables [..., r] as one row per packed row
    [n, r] (r the rotary width; 0 with learned positions)."""
    r = prep.rotary_dim
    return dataclasses.replace(prep, cos=prep.cos.reshape(n, r),
                               sin=prep.sin.reshape(n, r))


def _fused(attend):
    """Mark a row-write callback as taking the raw q/k rows and the layer's
    ``QKPrep`` (``models/layers.decoder_block``)."""
    attend.fuses_qk_prep = True
    return attend


@dataclasses.dataclass(frozen=True)
class RowSplit:
    """How a paged callback is rebuilt over a subset of its rows (a dp
    group's) on one device (a tp shard's), for ``models/layers.MeshLM``:
    ``axis`` is the axis of q/k/v (and of the tokens) that indexes the
    rows, ``slots`` each row's slot on the host (None: row i is slot i),
    and ``remake(idx, base, device)`` the callback over rows ``idx`` (a
    host int array, None for all) with its page tables rebased by
    ``-base`` (the group's first global page id; ``OOB_PAGE`` stays out of
    every pool) and its operands on ``device``."""
    axis: int
    slots: Optional[np.ndarray]
    remake: Callable


def _take(t: torch.Tensor, idx: Optional[np.ndarray], device,
          base: int = 0) -> torch.Tensor:
    """Rows ``idx`` of ``t`` (all for None), ``base`` subtracted, on
    ``device``."""
    if idx is not None:
        t = t.index_select(0, torch.as_tensor(idx, dtype=torch.int64,
                                              device=t.device))
    if base:
        t = t - base
    return t.to(device)


def _split(attend, axis: int, slots, remake):
    attend.rows = RowSplit(axis, None if slots is None else np.asarray(slots),
                           remake)
    return attend


def make_decode_attend_carry_paged(lengths: torch.Tensor,
                                   table: torch.Tensor, window: int = 0):
    """Decode over the paged pool: slot b writes its new K/V row at row
    ``lengths[b]`` and attends over ``lengths[b] + 1`` rows (their last
    ``window`` when it is > 0). lengths: [B] int32; table: [B, max_pages]
    int32. The callback takes the raw q/k and the layer's ``QKPrep``: the
    fused row write applies the prologue."""
    limits = lengths + 1

    def attend(q, k, v, cache_l, prep) -> Tuple[torch.Tensor, tuple]:
        pool, layer = cache_l
        B = q.shape[0]
        qp, scales = _prep_write_rows(pool, q[:, 0], k[:, 0], v[:, 0],
                                      lengths, layer, table,
                                      _packed(prep, B))
        ctx = decode_attend_paged(qp[:, None], pool["k"], pool["v"], limits,
                                  layer, table, **scales, window=window)
        return ctx, (pool, layer)

    return _split(_fused(attend), 0, None, lambda idx, base, dev:
                  make_decode_attend_carry_paged(
                      _take(lengths, idx, dev), _take(table, idx, dev, base),
                      window))


def make_spec_attend_carry_paged(lengths: torch.Tensor,
                                 table: torch.Tensor, window: int = 0):
    """Speculative verify over the paged pool: slot b's R new K/V rows land
    at rows ``lengths[b] .. lengths[b] + R - 1`` (one fused row-write launch
    for all B * R rows, the slot's table row repeated; the engine has
    allocated pages covering ``lengths + R``), then one attention launch
    answers the B * R queries, row r of slot b attending ``lengths[b] + 1 +
    r`` columns. lengths: [B] int32; table: [B, max_pages] int32. Takes the
    raw q/k and the layer's ``QKPrep``, as the decode callback does."""

    def attend(q, k, v, cache_l, prep) -> Tuple[torch.Tensor, tuple]:
        pool, layer = cache_l
        B, R = k.shape[:2]
        r = torch.arange(R, dtype=lengths.dtype, device=lengths.device)
        rows = (lengths[:, None] + r).reshape(B * R)
        qp, scales = _prep_write_rows(
            pool, q.reshape(B * R, *q.shape[2:]),
            k.reshape(B * R, *k.shape[2:]), v.reshape(B * R, *v.shape[2:]),
            rows, layer, table.repeat_interleave(R, dim=0),
            _packed(prep, B * R))
        ctx = decode_attend_spec_paged(qp.reshape(q.shape), pool["k"],
                                       pool["v"], lengths, layer, table,
                                       **scales, window=window)
        return ctx, (pool, layer)

    return _split(_fused(attend), 0, None, lambda idx, base, dev:
                  make_spec_attend_carry_paged(
                      _take(lengths, idx, dev), _take(table, idx, dev, base),
                      window))


def make_mixed_attend_carry_paged(write_rows: torch.Tensor,
                                  row_limits: torch.Tensor,
                                  row_tables: torch.Tensor, window: int = 0,
                                  chunk_start: Optional[int] = None,
                                  row_slots: Optional[np.ndarray] = None):
    """Ragged mixed batch over the paged pool: the packed sequence [1, N]
    holds B decode rows then C prefill-chunk rows. Per packed row i:
    ``write_rows[i]`` is where its K/V lands (-1 drops),
    ``row_limits[i]`` how many columns it attends, ``row_tables[i]`` its
    slot's page run (all int32). ``chunk_start`` (B): the chunk's rows
    share row B's table row and their limits rise by one from row B's
    (``ragged_attend_paged``'s layout, which lets them share page loads on
    a card). Takes the raw q/k and the layer's ``QKPrep``: one fused
    row-write launch preps the N rows' q and k and writes their K/V.
    ``row_slots`` (host, [N]): each packed row's slot, which a dp mesh
    splits the rows by (:class:`RowSplit`)."""

    def attend(q, k, v, cache_l, prep) -> Tuple[torch.Tensor, tuple]:
        pool, layer = cache_l
        N = q.shape[1]
        qp, scales = _prep_write_rows(pool, q[0], k[0], v[0], write_rows,
                                      layer, row_tables, _packed(prep, N))
        ctx = ragged_attend_paged(qp, pool["k"], pool["v"], row_limits,
                                  layer, row_tables, **scales, window=window,
                                  chunk_start=chunk_start)
        return ctx[None], (pool, layer)

    def remake(idx, base, dev):
        start = chunk_start
        if idx is not None and start is not None:
            # the subset keeps the decode rows first: its chunk (if it
            # holds the chunk's rows) starts after its decode rows
            n_dec = int((idx < start).sum())
            start = n_dec if n_dec < len(idx) else None
        return make_mixed_attend_carry_paged(
            _take(write_rows, idx, dev), _take(row_limits, idx, dev),
            _take(row_tables, idx, dev, base), window, start,
            None if row_slots is None or idx is None
            else np.asarray(row_slots)[idx])

    return _split(_fused(attend), 1, row_slots, remake)


def make_prefill_attend_batch_paged_carry(tables: torch.Tensor,
                                          seq_lens: torch.Tensor,
                                          window: int = 0,
                                          row_slots: Optional[np.ndarray]
                                          = None):
    """Batched prefill over the paged pool: causal attention over each
    right-padded prompt's fresh K/V, then its rows scatter through
    ``tables`` (quantized into an int8 pool; padding rows carry OOB_PAGE
    and drop). ``row_slots`` (host, [N]): each prompt's slot, which a dp
    mesh splits the rows by (:class:`RowSplit`)."""

    def attend(q, k, v, cache_l):
        pool, layer = cache_l
        ctx = causal_attend(q, k, v, seq_lens=seq_lens, window=window)
        pool = pkv.write_prompts_paged_layer(pool, layer, tables, k, v,
                                             pool["k"].shape[3])
        return ctx, (pool, layer)

    return _split(attend, 0, row_slots, lambda idx, base, dev:
                  make_prefill_attend_batch_paged_carry(
                      _take(tables, idx, dev, base),
                      _take(seq_lens, idx, dev), window,
                      None if row_slots is None or idx is None
                      else np.asarray(row_slots)[idx]))


def _prep_write_dense(cache: dict, q: torch.Tensor, k_new: torch.Tensor,
                      v_new: torch.Tensor, rows: torch.Tensor, layer: int,
                      prep: QKPrep):
    """The layer's q/k prologue and its new K/V rows into the dense cache in
    one launch of the fused row write (quantizing when the cache is int8):
    q [B, R, Hq, D], k/v [B, R, Hkv, D] raw, at ``rows`` [B, R], ``prep``'s
    tables [B, R, r]. Returns (q after the prologue, the scale caches as
    the attention kernels take them; none for a bf16/f32 cache)."""
    if kvc.is_quantized(cache):
        q = prep_write_rows_quant_dense(cache["k"], cache["v"], cache["ks"],
                                        cache["vs"], q, k_new, v_new, rows,
                                        layer, prep)
        return q, {"cache_ks": cache["ks"], "cache_vs": cache["vs"]}
    return prep_write_rows_dense(cache["k"], cache["v"], q, k_new, v_new,
                                 rows, layer, prep), {}


def make_decode_attend_carry(lengths: torch.Tensor, window: int = 0,
                             bblock: int = 1, mesh=None):
    """Decode over the dense cache: slot b writes its new K/V row at row
    ``lengths[b]`` (rows outside the window drop; quantized into an int8
    cache) and attends over ``lengths[b] + 1`` rows, ``bblock`` slots per
    CTA of the attention kernel (K5 when > 1; the result does not depend on
    it). lengths: [B] int32. The callback takes the raw q/k and the layer's
    ``QKPrep``: the fused row write applies the prologue. With a ``mesh``
    whose ``sp`` axis is larger than 1 the cache is split into sequence
    shards and each shard attends its own rows through K6
    (:func:`_make_sp_decode_attend`); a sliding window is refused there, as
    the JAX package refuses it."""
    if sp_size(mesh) > 1:
        if window > 0:
            raise ValueError("sequence-parallel decode (sp > 1) does not "
                             "compose with sliding-window attention")
        return _make_sp_decode_attend(lengths, mesh)
    rows = lengths[:, None].to(torch.int32)

    def attend(q, k, v, cache_l, prep) -> Tuple[torch.Tensor, tuple]:
        cache, layer = cache_l
        qp, scales = _prep_write_dense(cache, q, k, v, rows, layer, prep)
        ctx = decode_attend_dense(qp, cache["k"], cache["v"], lengths + 1,
                                  layer, window, **scales, bblock=bblock)
        return ctx, (cache, layer)

    return _fused(attend)


def merge_stats(accs, ms, ls, device) -> torch.Tensor:
    """The log-sum-exp merge of the sequence shards' flash triples (the JAX
    package's ``ops/attention.py:157-162``, there a pmax and two psums over
    ``sp``): each shard's acc [B, Hq, D], m and l [B, Hq] moved to
    ``device``; a shard with m <= -1e29 (no row of the slot) weighs 0.
    Returns the normalized context [B, Hq, D] float32."""
    acc = torch.stack([a.to(device) for a in accs])            # [sp,B,Hq,D]
    m = torch.stack([x.to(device) for x in ms])                # [sp, B, Hq]
    l_sum = torch.stack([x.to(device) for x in ls])
    m_glob = m.amax(dim=0)
    m_safe = torch.where(m_glob <= -1e29, torch.zeros_like(m_glob), m_glob)
    w = torch.where(m <= -1e29, torch.zeros_like(m), torch.exp(m - m_safe))
    l_glob = (l_sum * w).sum(dim=0)
    acc_glob = (acc * w[..., None]).sum(dim=0)
    return acc_glob / l_glob.clamp_min(1e-9)[..., None]


def _make_sp_decode_attend(lengths: torch.Tensor, mesh):
    """The sequence-parallel decode (the JAX package's ``sp > 1`` branch of
    ``make_decode_attend_carry``, ``ops/attention.py:119-163``): shard i
    owns the global rows [off, off + S_local), off = i * S_local; one
    launch of the fused row write on its device takes the raw q, k and v
    and the layer's ``QKPrep``, writes the new row at ``lengths - off``
    (quantized into an int8 shard; a non-owner's row falls outside
    [0, S_local) and drops) and returns q after the prologue, which the
    shard's K6 reads over ``clip(lengths + 1 - off, 0, S_local)`` rows; the
    triples merge on the lead device (:func:`merge_stats`), cast to q's
    type."""
    devices = mesh.axis_devices("sp")
    lead = mesh.lead
    per_shard = {}

    def shard_rows(s_local):
        # (write rows [B, 1], attended rows [B]) of each shard, on its device
        if s_local not in per_shard:
            lens = lengths.to(torch.int32)
            per_shard[s_local] = [
                (((lens - i * s_local)[:, None]).to(dev),
                 (lens + 1 - i * s_local).clamp(0, s_local).to(dev))
                for i, dev in enumerate(devices)]
        return per_shard[s_local]

    def attend(q, k, v, cache_l, prep) -> Tuple[torch.Tensor, tuple]:
        shards, layer = cache_l
        if len(shards) != len(devices):
            raise ValueError(f"{len(shards)} cache shards for a mesh of "
                             f"sp={len(devices)}")
        parts = []
        for shard, dev, (w_rows, r_lens) in zip(
                shards, devices, shard_rows(shards[0]["k"].shape[3])):
            qp, scales = _prep_write_dense(shard, q.to(dev), k.to(dev),
                                           v.to(dev), w_rows, layer,
                                           _on(prep, dev))
            parts.append(decode_attend_dense_stats(
                qp, shard["k"], shard["v"], r_lens, layer, **scales))
        ctx = merge_stats(*zip(*parts), lead)
        return ctx[:, None].to(q.dtype), (shards, layer)

    return _fused(attend)


def _on(prep: QKPrep, device) -> QKPrep:
    """``prep`` with its tensors on ``device`` (itself when they are)."""
    if prep.cos.device == device:
        return prep
    return QKPrep(*(t if t is None else t.to(device)
                    for t in (prep.q_norm, prep.k_norm)), prep.eps,
                  prep.cos.to(device), prep.sin.to(device))


def make_spec_attend_carry(lengths: torch.Tensor, window: int = 0):
    """Speculative rows over the dense cache: slot b's R new K/V rows land
    at rows ``lengths[b] .. lengths[b] + R - 1`` (one fused row-write
    launch for q's and k's prologue and the B * R rows, quantizing into an
    int8 cache), then one attention launch answers the B * R queries.
    lengths: [B] int32. Takes the raw q/k and the layer's ``QKPrep``, as
    the decode callback does."""

    def attend(q, k, v, cache_l, prep) -> Tuple[torch.Tensor, tuple]:
        cache, layer = cache_l
        R = k.shape[1]
        r = torch.arange(R, dtype=torch.int32, device=lengths.device)
        rows = (lengths.to(torch.int32)[:, None] + r).contiguous()
        qp, scales = _prep_write_dense(cache, q, k, v, rows, layer, prep)
        ctx = spec_attend_dense(qp, cache["k"], cache["v"], lengths, layer,
                                window, **scales)
        return ctx, (cache, layer)

    return _fused(attend)


def make_prefill_attend_batch(slots: torch.Tensor, seq_lens: torch.Tensor,
                              window: int = 0):
    """Batched prefill into the dense cache: causal attention over each
    right-padded prompt's fresh, unquantized K/V, then its rows [0, T)
    scatter into slot ``slots[n]`` (quantized into an int8 cache; slots
    outside the cache drop; into a sequence-sharded cache, each row into
    the shard that holds it)."""

    def attend(q, k, v, cache_l):
        cache, layer = cache_l
        ctx = causal_attend(q, k, v, seq_lens=seq_lens, window=window)
        cache = kvc.write_prompts(cache, layer, slots, k, v)
        return ctx, (cache, layer)

    return attend


def chunk_attend(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                 start: int, window: int = 0) -> torch.Tensor:
    """Attention of one prefill chunk over its slot's rows (the JAX
    package's ``chunk_attend``, float32 softmax): q [1, C, Hq, D] at
    positions start .. start + C - 1; ck/cv [Hkv, S, D] hold the earlier
    chunks' rows and this chunk's (written before it attends). Query row i
    sees the columns <= start + i, of which the last ``window`` when it is
    > 0. Only the columns below start + C are read: the others are masked
    for every row and add exactly 0."""
    _, C, Hq, D = q.shape
    Hkv = ck.shape[0]
    n = min(start + C, ck.shape[1])
    qg = q[0].reshape(C, Hkv, Hq // Hkv, D).float()
    logits = torch.einsum("ckgd,ksd->ckgs", qg, ck[:, :n].float()) \
        / math.sqrt(D)
    cols = torch.arange(n, device=q.device)[None, :]
    rows = start + torch.arange(C, device=q.device)[:, None]
    mask = cols <= rows                                           # [C, n]
    if window > 0:
        mask &= cols > rows - window
    logits = torch.where(mask[:, None, None, :], logits,
                         torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    ctx = torch.einsum("ckgs,ksd->ckgd", probs, cv[:, :n].float())
    return ctx.reshape(C, Hq, D)[None].to(q.dtype)


def make_chunk_prefill_attend(slot: int, start: int, window: int = 0):
    """One prefill chunk of a long prompt into slot ``slot`` of the dense
    cache at rows [start, start + C): the chunk's K/V rows are written
    first (quantized into an int8 cache; rows past the window drop), then
    the chunk attends the slot's rows, those of an int8 cache dequantized
    to q's type, so that the chunk sees its own rows as the decode steps
    will (the JAX package's ``make_chunk_prefill_attend``). A
    sequence-sharded cache takes each row in the shard that holds it, and
    the chunk attends the slot's rows [0, start + C) gathered from the
    shards in order onto q's device (plain torch, as the JAX package
    leaves the gather to XLA)."""

    def attend(q, k, v, cache_l):
        cache, layer = cache_l
        kvc.write_chunk(cache, layer, slot, start, k, v)
        if isinstance(cache, list):
            rows = gather_rows(cache, layer, slot, start + k.shape[1],
                               q.device)
        else:
            rows = {name: leaf[layer, slot] for name, leaf in cache.items()}
        ck, cv = rows["k"], rows["v"]
        if "ks" in rows:
            ck = kvc.dequantize(ck, rows["ks"], q.dtype)
            cv = kvc.dequantize(cv, rows["vs"], q.dtype)
        return chunk_attend(q, ck, cv, start, window), (cache, layer)

    return attend
