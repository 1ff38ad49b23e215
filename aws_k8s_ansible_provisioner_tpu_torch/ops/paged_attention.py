"""The kernels of the serving path, their wrappers and plain versions.

- :func:`paged_attention` (``csrc/paged_attention.cu``) replaces the TPU
  kernel ``_paged_flash_db``/``_paged_db_body`` behind
  ``decode_attend_pallas_paged`` and ``ragged_attend_pallas_paged``
  (bf16, one query row per table row, with or without a sliding window):
  flash attention over the paged pool where every packed query row carries
  its own page-table row and live-column limit; ``window`` > 0 keeps the
  columns ``[limit - window, limit)`` live and never reads a page below
  the window start's. :func:`paged_attention_quant` is the same kernel
  over an int8 pool with per-row float32 scales (the TPU body
  ``_paged_db_kernel_quant``), folding the scales into the loop.
  :func:`decode_attend_paged` and :func:`ragged_attend_paged` are the two
  entry points of both; scale pools select the int8 form.
- :func:`paged_attention_spec` and :func:`paged_attention_spec_quant` (the
  same source's verify entry, ``csrc/split_verify.cuh``) replace the same
  TPU body with ``spec=True`` behind ``decode_attend_pallas_spec_paged``:
  the speculative verify's R query rows per slot, row r with limit
  ``lengths[b] + 1 + r``. One CTA takes a slot's R x G rows of one kv head
  (up to 64: more take row groups) and streams the slot's pages once for
  all of them, with tensor-core scores and P.V.
  :func:`decode_attend_spec_paged` is their entry point.
- :func:`cache_write_rows_paged` (``csrc/cache_write.cu``) replaces
  ``cache_write_row_paged``: one K and one V row per packed row, written in
  place through the table, rows outside ``[0, max_pages * page)`` dropped.
  :func:`cache_write_rows_quant_paged` (same source) replaces
  ``cache_write_row_quant_paged``: the rows quantized
  (``serving/kv_cache.quantize_rows``) into an int8 pool, their scales into
  the scale pools.

The attention kernels are split-KV (``ops/split_kv.py``): each (query row,
kv head), and in the verify each (slot, row group, kv head), gets
``split_kv.split_count`` CTAs from the shapes (rows or slots, Hkv,
``max_pages``, the card's SM count); with more than one, the wrapper
passes the split triples' workspace (``[splits, N, Hq, D]`` and twice
``[splits, N, Hq]`` float32 over the N query rows,
``split_kv.launch_plan``) and the kernel's C entry queues the combine
after the attention kernel on the same stream.
Each wrapper takes its plain PyTorch version for a tensor on the CPU (the
tests), and for a CUDA tensor launches its kernel on the current stream or
raises; nothing falls back. Each keeps a plain integer count of its kernel
launches in ``<wrapper>.launches`` (the combine's in
``split_kv.split_merge.launches``). The plain versions state the contract
the kernels are held to and are what the kernels are compared with.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from aws_k8s_ansible_provisioner_tpu_torch.ops import cuda_build, split_kv
from aws_k8s_ansible_provisioner_tpu_torch.serving.kv_cache import \
    quantize_rows

NEG_INF = -1e30

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_INT8_POOL = 2
_MAX_QUANT_D = 256
_MAX_GROUPS = 8
# the split kernels' P.V gives each thread two output columns: D / 2 <= 128
_MAX_D = 256
_P = ctypes.c_void_p
_I = ctypes.c_int


def _live_pages(limits: torch.Tensor, page_size: int, max_pages: int,
                window: int = 0):
    """(lo, hi): the first and last logical page each row visits.
    hi = min(max(cdiv(limit, page) - 1, 0), max_pages - 1); lo = 0, or with
    a window min(max(limit - window, 0) // page, hi)."""
    lim = limits.long()
    hi = (torch.div(lim + page_size - 1, page_size, rounding_mode="floor")
          - 1).clamp(min=0, max=max_pages - 1)
    if window <= 0:
        return torch.zeros_like(hi), hi
    lo = torch.div((lim - window).clamp_min(0), page_size,
                   rounding_mode="floor")
    return torch.minimum(lo, hi), hi


def paged_attention_plain(q: torch.Tensor, pool_k: torch.Tensor,
                          pool_v: torch.Tensor, limits: torch.Tensor,
                          layer: int, table: torch.Tensor,
                          pool_ks: Optional[torch.Tensor] = None,
                          pool_vs: Optional[torch.Tensor] = None,
                          window: int = 0) -> torch.Tensor:
    """Plain version of :func:`paged_attention` and
    :func:`paged_attention_quant`: gather each row's visited pages, mask,
    float32 softmax.

    q: [N, Hq, D]; pools [L, P, Hkv, page, D]; limits [N]; table
    [N, max_pages]. Row n visits logical pages lo..hi (:func:`_live_pages`)
    and gathers no other; its columns outside ``[limit - window, limit)``
    (window 0: ``[0, limit)``) are masked to NEG_INF (-1e30), so a row with
    limit 0 averages V over page table[n, 0]. With scale pools
    ``pool_ks``/``pool_vs`` [L, P, Hkv, page] the pools are int8 and the
    scales fold in as the kernel folds them: scores times the K scale
    before the mask, the denominator over the unscaled probabilities, the
    probabilities times the V scale in P.V.
    """
    N, Hq, D = q.shape
    _, P, Hkv, ps, _ = pool_k.shape
    if N == 0:
        return torch.empty_like(q)
    G = Hq // Hkv
    lo, hi = _live_pages(limits, ps, table.shape[1], window)
    n_vis = int((hi - lo).max()) + 1
    c = lo[:, None] + torch.arange(n_vis, device=q.device)     # [N, n_vis]
    pages = table.long().gather(1, torch.minimum(c, hi[:, None])) \
        .clamp(0, P - 1)

    def gather(pool):                     # [N, Hkv, S] (+ [D]) in float32
        g = pool[layer][pages].movedim(2, 1)      # [N, Hkv, n_vis, ps, (D)]
        return g.reshape((N, Hkv, n_vis * ps) + g.shape[4:]).float()

    k, v = gather(pool_k), gather(pool_v)
    qg = q.reshape(N, Hkv, G, D).float() * (1.0 / math.sqrt(D))
    s = torch.einsum("nkgd,nksd->nkgs", qg, k)
    if pool_ks is not None:
        s = s * gather(pool_ks)[:, :, None, :]
    col = (c[:, :, None] * ps
           + torch.arange(ps, device=q.device)).reshape(N, n_vis * ps)
    lim = limits.long()[:, None]
    live = col < lim                                            # [N, S]
    if window > 0:
        live &= col >= lim - window
    visited = (c <= hi[:, None]).repeat_interleave(ps, dim=1)
    s = torch.where(live[:, None, None], s, torch.full_like(s, NEG_INF))
    s = torch.where(visited[:, None, None], s,
                    torch.full_like(s, float("-inf")))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l_sum = p.sum(dim=-1, keepdim=True)
    if pool_vs is not None:
        p = p * gather(pool_vs)[:, :, None, :]
    out = torch.einsum("nkgs,nksd->nkgd", p, v) / l_sum.clamp_min(1e-9)
    return out.reshape(N, Hq, D).to(q.dtype)


def _check_cuda(what: str, tensors, aligned) -> None:
    """Same device, contiguous; ``aligned`` ones start on 16 bytes (the
    kernels copy them in 16-byte vectors)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")
    if any(t.data_ptr() % 16 for t in aligned):
        raise ValueError(f"{what}: pool/row buffers must be 16-byte aligned")


def _attention_lib():
    lib = cuda_build.load("paged_attention")
    fn = lib.paged_attention
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                       _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _I, _I,
                       _P]
        fn.restype = _I
    return fn


def _check_operands(what: str, q, pool_k, pool_v, pool_ks, pool_vs,
                    window: int, layer: int) -> tuple:
    """Check q [..., Hq, D] against the pools (bf16/f32 of q's type when
    ``pool_ks`` is None, else int8 with float32 scale pools), the window
    and the layer. Returns (Hkv, G, D, P, page size, scale pools)."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    if window < 0:
        raise ValueError(f"{what}: window {window} < 0")
    Hq, D = q.shape[-2:]
    L, P, Hkv, ps, Dk = pool_k.shape
    G = Hq // Hkv if Hkv else 0
    quant = pool_ks is not None
    if (pool_v.shape != pool_k.shape or Dk != D or Hkv * G != Hq
            or not 1 <= G <= _MAX_GROUPS or D % (16 if quant else 8)
            or D > _MAX_D):
        raise ValueError(f"{what}: bad shapes q {tuple(q.shape)} "
                         f"pool {tuple(pool_k.shape)}")
    pool_type = torch.int8 if quant else q.dtype
    if q.dtype not in _DTYPE_CODES or pool_k.dtype != pool_type \
            or pool_v.dtype != pool_type:
        raise TypeError(f"{what}: q must be bf16 or f32 and the pools "
                        f"{pool_type}, got {q.dtype}/{pool_k.dtype}/"
                        f"{pool_v.dtype}")
    scales = ()
    if quant:
        if pool_vs is None or pool_ks.shape != pool_k.shape[:-1] \
                or pool_vs.shape != pool_ks.shape:
            raise ValueError(f"{what}: scale pools must be [L, P, Hkv, "
                             f"page], got {tuple(pool_ks.shape)}")
        if pool_ks.dtype != torch.float32 or pool_vs.dtype != torch.float32:
            raise TypeError(f"{what}: scale pools must be float32")
        scales = (pool_ks, pool_vs)
    if not 0 <= layer < L:
        raise ValueError(f"{what}: layer {layer} outside [0, {L})")
    return Hkv, G, D, P, ps, scales


def _pool_args(q, pool_k, pool_v, scales) -> tuple:
    """The kernels' pool pointers, q's type code and the pool's."""
    code = _DTYPE_CODES[q.dtype]
    return ((pool_k.data_ptr(), pool_v.data_ptr())
            + (tuple(t.data_ptr() for t in scales) if scales
               else (None, None)),
            code, _INT8_POOL if scales else code)


def _launch_attention(what: str, q, pool_k, pool_v, pool_ks, pool_vs,
                      limits, table, layer: int, window: int
                      ) -> torch.Tensor:
    """Check the operands of the attention kernel and launch it (bf16/f32
    pool when ``pool_ks`` is None, else int8 with scale pools; the window
    instance when ``window`` > 0)."""
    Hkv, G, D, P, ps, scales = _check_operands(
        what, q, pool_k, pool_v, pool_ks, pool_vs, window, layer)
    N, Hq = q.shape[:2]
    if q.dim() != 3 or limits.dtype != torch.int32 \
            or table.dtype != torch.int32 or limits.shape != (N,) \
            or table.dim() != 2 or table.shape[0] != N or table.shape[1] < 1:
        raise ValueError(f"{what}: limits [N] and table [N, pages] must be "
                         f"int32")
    _check_cuda(what, (q, pool_k, pool_v, limits, table) + scales,
                (pool_k, pool_v))
    out = torch.empty_like(q)
    if N == 0:
        return out
    fn = _attention_lib()
    pools, code, pool_code = _pool_args(q, pool_k, pool_v, scales)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        splits, ws = split_kv.launch_plan(N, Hkv, table.shape[1], Hq, D,
                                          q.device, stream)
        rc = fn(out.data_ptr(), *ws, q.data_ptr(), *pools, limits.data_ptr(),
                table.data_ptr(), N, Hkv, G, D, P, ps, table.shape[1], layer,
                window, 1.0 / math.sqrt(D), code, pool_code, splits, stream)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")
    if splits > 1:
        split_kv.split_merge.launches += 1
    return out


def _verify_lib():
    lib = cuda_build.load("paged_attention")
    fn = lib.paged_attention_verify
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                       _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I,
                       _I, _I, _P]
        fn.restype = _I
    return fn


def _launch_verify(what: str, q, pool_k, pool_v, pool_ks, pool_vs, lengths,
                   table, layer: int, window: int) -> torch.Tensor:
    """Check the operands of the verify kernel and launch it: q [B, R, Hq,
    D], lengths [B] and table [B, max_pages] int32 as they are, one CTA per
    (slot, row group, kv head, split) (``csrc/split_verify.cuh``)."""
    Hkv, G, D, P, ps, scales = _check_operands(
        what, q, pool_k, pool_v, pool_ks, pool_vs, window, layer)
    B, R, Hq = q.shape[:3]
    if q.dim() != 4 or lengths.dtype != torch.int32 \
            or table.dtype != torch.int32 or lengths.shape != (B,) \
            or table.dim() != 2 or table.shape[0] != B or table.shape[1] < 1:
        raise ValueError(f"{what}: lengths [B] and table [B, pages] must be "
                         f"int32")
    _check_cuda(what, (q, pool_k, pool_v, lengths, table) + scales,
                (pool_k, pool_v))
    out = torch.empty_like(q)
    if B * R == 0:
        return out
    fn = _verify_lib()
    pools, code, pool_code = _pool_args(q, pool_k, pool_v, scales)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        splits, ws = split_kv.launch_plan(
            B * R, Hkv, table.shape[1], Hq, D, q.device, stream,
            cta_rows=B * split_kv.verify_groups(R, G))
        rc = fn(out.data_ptr(), *ws, q.data_ptr(), *pools,
                lengths.data_ptr(), table.data_ptr(), B, R, Hkv, G, D, P, ps,
                table.shape[1], layer, window, 1.0 / math.sqrt(D), code,
                pool_code, splits, stream)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")
    if splits > 1:
        split_kv.split_merge.launches += 1
    return out


def _count(fn, window: int) -> None:
    """One launch of ``fn``'s kernel; ``window_launches`` counts those of
    the window instance."""
    fn.launches += 1
    fn.window_launches += window > 0


def paged_attention(q: torch.Tensor, pool_k: torch.Tensor,
                    pool_v: torch.Tensor, limits: torch.Tensor, layer: int,
                    table: torch.Tensor, window: int = 0) -> torch.Tensor:
    """Paged flash attention, one (table row, limit) per query row.

    q: [N, Hq, D] bf16 or f32; pools [L, P, Hkv, page, D] of q's type;
    limits [N] int32; layer: int; table [N, max_pages] int32; ``window`` >
    0: sliding window of that many columns. Returns [N, Hq, D]. CPU tensors
    take :func:`paged_attention_plain`; CUDA tensors launch the kernel.
    """
    if q.device.type == "cpu":
        return paged_attention_plain(q, pool_k, pool_v, limits, layer, table,
                                     window=window)
    out = _launch_attention("paged_attention", q, pool_k, pool_v, None, None,
                            limits, table, layer, window)
    _count(paged_attention, window)
    return out


def paged_attention_quant(q: torch.Tensor, pool_k: torch.Tensor,
                          pool_v: torch.Tensor, pool_ks: torch.Tensor,
                          pool_vs: torch.Tensor, limits: torch.Tensor,
                          layer: int, table: torch.Tensor,
                          window: int = 0) -> torch.Tensor:
    """:func:`paged_attention` over an int8 pool: pools [L, P, Hkv, page, D]
    int8, scale pools [L, P, Hkv, page] float32, q bf16 or f32 (D a
    multiple of 16). CPU tensors take :func:`paged_attention_plain`; CUDA
    tensors launch the kernel's int8 instance."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, pool_k, pool_v, limits, layer, table,
                                     pool_ks, pool_vs, window)
    out = _launch_attention("paged_attention_quant", q, pool_k, pool_v,
                            pool_ks, pool_vs, limits, table, layer, window)
    _count(paged_attention_quant, window)
    return out


def _attend(q, pool_k, pool_v, limits, layer, table, pool_ks, pool_vs,
            window):
    if pool_ks is None:
        return paged_attention(q, pool_k, pool_v, limits, layer, table,
                               window)
    return paged_attention_quant(q, pool_k, pool_v, pool_ks, pool_vs, limits,
                                 layer, table, window)


def decode_attend_paged(q: torch.Tensor, pool_k: torch.Tensor,
                        pool_v: torch.Tensor, lengths: torch.Tensor,
                        layer: int, table: torch.Tensor,
                        pool_ks: Optional[torch.Tensor] = None,
                        pool_vs: Optional[torch.Tensor] = None,
                        window: int = 0) -> torch.Tensor:
    """Decode entry: q [B, 1, Hq, D], one row per slot; ``lengths`` counts
    the rows each slot attends over (the just-written row included), of
    which the last ``window`` when it is > 0. Scale pools select the int8
    form. Returns [B, 1, Hq, D]."""
    return _attend(q[:, 0].contiguous(), pool_k, pool_v,
                   lengths.to(torch.int32), layer, table.to(torch.int32),
                   pool_ks, pool_vs, window)[:, None]


def ragged_attend_paged(q: torch.Tensor, pool_k: torch.Tensor,
                        pool_v: torch.Tensor, row_limits: torch.Tensor,
                        layer: int, row_tables: torch.Tensor,
                        pool_ks: Optional[torch.Tensor] = None,
                        pool_vs: Optional[torch.Tensor] = None,
                        window: int = 0) -> torch.Tensor:
    """Ragged entry: N packed rows [N, Hq, D], each with its own table row
    and live-column limit (decode rows and prefill-chunk rows in one
    call), the window off each row's own limit. Scale pools select the int8
    form. Returns [N, Hq, D]."""
    return _attend(q.contiguous(), pool_k, pool_v,
                   row_limits.to(torch.int32), layer,
                   row_tables.to(torch.int32), pool_ks, pool_vs, window)


def _spec_rows(q: torch.Tensor, lengths: torch.Tensor, table: torch.Tensor):
    """The verify's B * R query rows [B, R, Hq, D] as packed rows: row
    (b, r) with limit ``lengths[b] + 1 + r`` and slot b's table row."""
    B, R = q.shape[:2]
    r = torch.arange(R, dtype=torch.int32, device=q.device)
    limits = (lengths.to(torch.int32)[:, None] + 1 + r).reshape(B * R)
    return (q.reshape(B * R, *q.shape[2:]), limits,
            table.to(torch.int32).repeat_interleave(R, dim=0))


def paged_attention_spec_plain(q: torch.Tensor, pool_k: torch.Tensor,
                               pool_v: torch.Tensor, lengths: torch.Tensor,
                               layer: int, table: torch.Tensor,
                               pool_ks: Optional[torch.Tensor] = None,
                               pool_vs: Optional[torch.Tensor] = None,
                               window: int = 0) -> torch.Tensor:
    """Plain version of :func:`paged_attention_spec` and
    :func:`paged_attention_spec_quant`: :func:`paged_attention_plain` over
    the B * R packed rows of :func:`_spec_rows`.

    The TPU kernel walks slot b's pages once for all R rows, from the page
    of row 0's window start (``lengths[b] + 1 - window``) to the page of
    column ``lengths[b] + R - 1``; packed row r walks from its own window
    start's page to its own last page. Every row has a live column (its
    limit is at least 1), so the pages only the TPU kernel visits add
    columns masked to -1e30: before the row's first live column they leave
    its running max at -1e30, and the first live page scales what they
    summed by exp(-1e30 - m) = 0; after it their probabilities are exactly
    0. Both give the same result.
    """
    qp, limits, tables = _spec_rows(q, lengths, table)
    return paged_attention_plain(qp, pool_k, pool_v, limits, layer, tables,
                                 pool_ks, pool_vs, window).reshape(q.shape)


def paged_attention_spec(q: torch.Tensor, pool_k: torch.Tensor,
                         pool_v: torch.Tensor, lengths: torch.Tensor,
                         layer: int, table: torch.Tensor,
                         window: int = 0) -> torch.Tensor:
    """Speculative-verify attention over a bf16/f32 pool: R query rows per
    slot, row r attending the columns < ``lengths[b] + 1 + r`` (the last
    ``window`` of them when it is > 0).

    q: [B, R, Hq, D]; pools [L, P, Hkv, page, D] of q's type; lengths [B]
    int32; table [B, max_pages] int32. Returns [B, R, Hq, D]. CPU tensors
    take :func:`paged_attention_spec_plain`; CUDA tensors launch the
    verify kernel, which streams each slot's pages once for its R rows."""
    if q.device.type == "cpu":
        return paged_attention_spec_plain(q, pool_k, pool_v, lengths, layer,
                                          table, window=window)
    out = _launch_verify("paged_attention_spec", q, pool_k, pool_v, None,
                         None, lengths, table, layer, window)
    _count(paged_attention_spec, window)
    return out


def paged_attention_spec_quant(q: torch.Tensor, pool_k: torch.Tensor,
                               pool_v: torch.Tensor, pool_ks: torch.Tensor,
                               pool_vs: torch.Tensor, lengths: torch.Tensor,
                               layer: int, table: torch.Tensor,
                               window: int = 0) -> torch.Tensor:
    """:func:`paged_attention_spec` over an int8 pool with its float32 scale
    pools (the kernel's int8 instance, scales folded as in
    :func:`paged_attention_quant`)."""
    if q.device.type == "cpu":
        return paged_attention_spec_plain(q, pool_k, pool_v, lengths, layer,
                                          table, pool_ks, pool_vs, window)
    out = _launch_verify("paged_attention_spec_quant", q, pool_k, pool_v,
                         pool_ks, pool_vs, lengths, table, layer, window)
    _count(paged_attention_spec_quant, window)
    return out


def decode_attend_spec_paged(q: torch.Tensor, pool_k: torch.Tensor,
                             pool_v: torch.Tensor, lengths: torch.Tensor,
                             layer: int, table: torch.Tensor,
                             pool_ks: Optional[torch.Tensor] = None,
                             pool_vs: Optional[torch.Tensor] = None,
                             window: int = 0) -> torch.Tensor:
    """Verify entry: q [B, R, Hq, D], the rows at positions
    ``lengths[b] + r`` (all R already written); scale pools select the int8
    form. Returns [B, R, Hq, D]."""
    q = q.contiguous()
    lengths, table = lengths.to(torch.int32), table.to(torch.int32)
    if pool_ks is None:
        return paged_attention_spec(q, pool_k, pool_v, lengths, layer, table,
                                    window)
    return paged_attention_spec_quant(q, pool_k, pool_v, pool_ks, pool_vs,
                                      lengths, layer, table, window)


def _kept_rows(rows: torch.Tensor, table: torch.Tensor, page_size: int,
               num_pages: int):
    """(packed indices, page ids, offsets) of the rows a write keeps: row n
    lands at page table[n, rows[n] // page], offset rows[n] % page; rows
    outside [0, max_pages * page) drop before their table is read, then
    page ids outside the pool drop."""
    N = rows.shape[0]
    max_pages = table.shape[1]
    r = rows.long()
    ok = (r >= 0) & (r < max_pages * page_size)
    pg = table.long()[torch.arange(N, device=r.device),
                      torch.where(ok, r // page_size, torch.zeros_like(r))]
    ok &= (pg >= 0) & (pg < num_pages)
    sel = ok.nonzero().squeeze(1)
    return sel, pg[sel], (r % page_size)[sel]


def cache_write_rows_paged_plain(pool_k: torch.Tensor, pool_v: torch.Tensor,
                                 k_new: torch.Tensor, v_new: torch.Tensor,
                                 rows: torch.Tensor, layer: int,
                                 table: torch.Tensor) -> None:
    """Plain version of :func:`cache_write_rows_paged` (index-put with the
    drop mask of :func:`_kept_rows`)."""
    sel, pg, off = _kept_rows(rows, table, pool_k.shape[3], pool_k.shape[1])
    pool_k[layer, pg, :, off] = k_new[sel].to(pool_k.dtype)
    pool_v[layer, pg, :, off] = v_new[sel].to(pool_v.dtype)


def _check_write_index(what: str, rows, table, layer: int, L: int) -> None:
    """rows [N] and table [N, pages] int32; layer inside the pool."""
    N = rows.shape[0]
    if rows.dtype != torch.int32 or table.dtype != torch.int32 \
            or table.dim() != 2 or table.shape[0] != N or table.shape[1] < 1:
        raise ValueError(f"{what}: rows [N] and table [N, pages] must be "
                         f"int32")
    if not 0 <= layer < L:
        raise ValueError(f"{what}: layer {layer} outside [0, {L})")


def _write_lib():
    lib = cuda_build.load("cache_write")
    fn = lib.cache_write_rows_paged
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
        fn.restype = _I
    return fn


def cache_write_rows_paged(pool_k: torch.Tensor, pool_v: torch.Tensor,
                           k_new: torch.Tensor, v_new: torch.Tensor,
                           rows: torch.Tensor, layer: int,
                           table: torch.Tensor) -> None:
    """Write one new K row and V row per packed row into the pool, in place.

    pools [L, P, Hkv, page, D]; k_new/v_new [N, Hkv, D] of the pool's type;
    rows [N] int32 (logical row per packed row; -1 drops); table
    [N, max_pages] int32. CPU tensors take the plain version; CUDA tensors
    launch the kernel.
    """
    if pool_k.device.type == "cpu":
        cache_write_rows_paged_plain(pool_k, pool_v, k_new, v_new, rows,
                                     layer, table)
        return
    if pool_k.device.type != "cuda":
        raise ValueError(f"cache_write_rows_paged: unsupported device "
                         f"{pool_k.device}")
    L, P, Hkv, ps, D = pool_k.shape
    N = rows.shape[0]
    row_bytes = D * pool_k.element_size()
    if (pool_v.shape != pool_k.shape or k_new.shape != (N, Hkv, D)
            or v_new.shape != (N, Hkv, D) or row_bytes % 16):
        raise ValueError(f"cache_write_rows_paged: bad shapes pool "
                         f"{tuple(pool_k.shape)} new {tuple(k_new.shape)}")
    if not (pool_v.dtype == k_new.dtype == v_new.dtype == pool_k.dtype):
        raise TypeError("cache_write_rows_paged: new rows must have the "
                        "pool's dtype")
    _check_write_index("cache_write_rows_paged", rows, table, layer, L)
    _check_cuda("cache_write_rows_paged",
                (pool_k, pool_v, k_new, v_new, rows, table),
                (pool_k, pool_v, k_new, v_new))
    if N == 0:
        return
    fn = _write_lib()
    with torch.cuda.device(pool_k.device):
        stream = torch.cuda.current_stream(pool_k.device).cuda_stream
        rc = fn(pool_k.data_ptr(), pool_v.data_ptr(), k_new.data_ptr(),
                v_new.data_ptr(), rows.data_ptr(), table.data_ptr(), N, layer,
                P, Hkv, ps, row_bytes, table.shape[1], stream)
    if rc != 0:
        raise RuntimeError(f"cache_write_rows_paged kernel launch failed: "
                           f"CUDA error {rc}")
    cache_write_rows_paged.launches += 1


def cache_write_rows_quant_paged_plain(pool_k: torch.Tensor,
                                       pool_v: torch.Tensor,
                                       pool_ks: torch.Tensor,
                                       pool_vs: torch.Tensor,
                                       k_new: torch.Tensor,
                                       v_new: torch.Tensor,
                                       rows: torch.Tensor, layer: int,
                                       table: torch.Tensor) -> None:
    """Plain version of :func:`cache_write_rows_quant_paged`:
    ``quantize_rows`` of the new rows, then the row write's index-put into
    the int8 pools and the scale pools."""
    sel, pg, off = _kept_rows(rows, table, pool_k.shape[3], pool_k.shape[1])
    for pool, scales, new in ((pool_k, pool_ks, k_new),
                              (pool_v, pool_vs, v_new)):
        q8, scale = quantize_rows(new[sel])
        pool[layer, pg, :, off] = q8
        scales[layer, pg, :, off] = scale


def _quant_write_lib():
    lib = cuda_build.load("cache_write")
    fn = lib.cache_write_rows_quant_paged
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                       _I, _I, _I, _P]
        fn.restype = _I
    return fn


def cache_write_rows_quant_paged(pool_k: torch.Tensor, pool_v: torch.Tensor,
                                 pool_ks: torch.Tensor, pool_vs: torch.Tensor,
                                 k_new: torch.Tensor, v_new: torch.Tensor,
                                 rows: torch.Tensor, layer: int,
                                 table: torch.Tensor) -> None:
    """Quantize one new K row and V row per packed row and write them into
    the int8 pool and their scales into the scale pools, in place.

    pools [L, P, Hkv, page, D] int8; scale pools [L, P, Hkv, page] float32;
    k_new/v_new [N, Hkv, D] bf16 or f32 (D <= 256); rows [N] int32 (-1
    drops); table [N, max_pages] int32. CPU tensors take the plain version;
    CUDA tensors launch the kernel (K and V in one launch).
    """
    if pool_k.device.type == "cpu":
        cache_write_rows_quant_paged_plain(pool_k, pool_v, pool_ks, pool_vs,
                                           k_new, v_new, rows, layer, table)
        return
    what = "cache_write_rows_quant_paged"
    if pool_k.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {pool_k.device}")
    L, P, Hkv, ps, D = pool_k.shape
    N = rows.shape[0]
    if (pool_v.shape != pool_k.shape or pool_ks.shape != pool_k.shape[:-1]
            or pool_vs.shape != pool_ks.shape
            or k_new.shape != (N, Hkv, D) or v_new.shape != (N, Hkv, D)
            or not 1 <= D <= _MAX_QUANT_D):
        raise ValueError(f"{what}: bad shapes pool {tuple(pool_k.shape)} "
                         f"scales {tuple(pool_ks.shape)} new "
                         f"{tuple(k_new.shape)}")
    if pool_k.dtype != torch.int8 or pool_v.dtype != torch.int8 \
            or pool_ks.dtype != torch.float32 \
            or pool_vs.dtype != torch.float32 \
            or k_new.dtype not in _DTYPE_CODES or v_new.dtype != k_new.dtype:
        raise TypeError(f"{what}: int8 pools, float32 scale pools and bf16 "
                        f"or f32 rows expected")
    _check_write_index(what, rows, table, layer, L)
    _check_cuda(what, (pool_k, pool_v, pool_ks, pool_vs, k_new, v_new, rows,
                       table), ())
    if N == 0:
        return
    fn = _quant_write_lib()
    with torch.cuda.device(pool_k.device):
        stream = torch.cuda.current_stream(pool_k.device).cuda_stream
        rc = fn(pool_k.data_ptr(), pool_v.data_ptr(), pool_ks.data_ptr(),
                pool_vs.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
                rows.data_ptr(), table.data_ptr(), N, layer, P, Hkv, ps, D,
                table.shape[1], _DTYPE_CODES[k_new.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")
    cache_write_rows_quant_paged.launches += 1


# the attention wrappers also count their window instance's launches
_WINDOWED = (paged_attention, paged_attention_quant, paged_attention_spec,
             paged_attention_spec_quant)
_COUNTED = _WINDOWED + (cache_write_rows_paged, cache_write_rows_quant_paged)


def reset_launch_counts() -> None:
    for fn in _COUNTED:
        fn.launches = 0
    for fn in _WINDOWED:
        fn.window_launches = 0


reset_launch_counts()


def counted_wrappers() -> tuple:
    """The wrappers whose launches this module counts (their ``launches``,
    ``window_launches`` and ``form_launches`` attributes)."""
    return _COUNTED


def launch_counts() -> dict:
    """{wrapper name: launches} and, for the attention wrappers,
    {name + " window": launches of the window instance}."""
    out = {fn.__name__: fn.launches for fn in _COUNTED}
    out.update({f"{fn.__name__} window": fn.window_launches
                for fn in _WINDOWED})
    return out
