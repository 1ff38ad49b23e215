"""The two kernels of the serving path, their wrappers and plain versions.

- :func:`paged_attention` (``csrc/paged_attention.cu``) replaces the TPU
  kernel ``_paged_flash_db``/``_paged_db_body`` behind
  ``decode_attend_pallas_paged`` and ``ragged_attend_pallas_paged``
  (bf16, one query row per table row, no window): flash attention over the
  paged pool where every packed query row carries its own page-table row
  and live-column limit. :func:`decode_attend_paged` and
  :func:`ragged_attend_paged` are its two entry points.
- :func:`cache_write_rows_paged` (``csrc/cache_write.cu``) replaces
  ``cache_write_row_paged``: one K and one V row per packed row, written in
  place through the table, rows outside ``[0, max_pages * page)`` dropped.

Each wrapper takes its plain PyTorch version for a tensor on the CPU (the
tests), and for a CUDA tensor launches its kernel on the current stream or
raises; nothing falls back. Each keeps a plain integer count of its kernel
launches in ``<wrapper>.launches``. The plain versions state the contract
the kernels are held to and are what the kernels are compared with.
"""

from __future__ import annotations

import ctypes
import math

import torch

from aws_k8s_ansible_provisioner_tpu_torch.ops import cuda_build

NEG_INF = -1e30

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GROUPS = 8
_P = ctypes.c_void_p
_I = ctypes.c_int


def _live_pages(limits: torch.Tensor, page_size: int,
                max_pages: int) -> torch.Tensor:
    """Index of the last logical page each row visits:
    min(max(cdiv(limit, page) - 1, 0), max_pages - 1)."""
    hi = torch.div(limits.long() + page_size - 1, page_size,
                   rounding_mode="floor") - 1
    return hi.clamp(min=0, max=max_pages - 1)


def paged_attention_plain(q: torch.Tensor, pool_k: torch.Tensor,
                          pool_v: torch.Tensor, limits: torch.Tensor,
                          layer: int, table: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`paged_attention`: gather each row's visited
    pages, mask, float32 softmax.

    q: [N, Hq, D]; pools [L, P, Hkv, page, D]; limits [N]; table
    [N, max_pages]. Row n visits logical pages 0..hi (see the kernel); its
    columns >= limit are masked to NEG_INF (-1e30), so a row with limit 0
    averages V over page table[n, 0]. Pages past hi are not visited.
    """
    N, Hq, D = q.shape
    _, P, Hkv, ps, _ = pool_k.shape
    if N == 0:
        return torch.empty_like(q)
    G = Hq // Hkv
    hi = _live_pages(limits, ps, table.shape[1])
    n_vis = int(hi.max()) + 1
    pages = table[:, :n_vis].long().clamp(0, P - 1)            # [N, n_vis]

    def gather(pool):
        g = pool[layer][pages]                       # [N, n_vis, Hkv, ps, D]
        return g.permute(0, 2, 1, 3, 4).reshape(N, Hkv, n_vis * ps, D).float()

    k, v = gather(pool_k), gather(pool_v)
    qg = q.reshape(N, Hkv, G, D).float() * (1.0 / math.sqrt(D))
    s = torch.einsum("nkgd,nksd->nkgs", qg, k)
    col = torch.arange(n_vis * ps, device=q.device)
    live = col[None, :] < limits.long()[:, None]                # [N, S]
    visited = (col[None, :] // ps) <= hi[:, None]
    s = torch.where(live[:, None, None], s, torch.full_like(s, NEG_INF))
    s = torch.where(visited[:, None, None], s,
                    torch.full_like(s, float("-inf")))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("nkgs,nksd->nkgd", p, v)
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
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                       _I, ctypes.c_float, _I, _P]
        fn.restype = _I
    return fn


def paged_attention(q: torch.Tensor, pool_k: torch.Tensor,
                    pool_v: torch.Tensor, limits: torch.Tensor, layer: int,
                    table: torch.Tensor) -> torch.Tensor:
    """Paged flash attention, one (table row, limit) per query row.

    q: [N, Hq, D] bf16 or f32; pools [L, P, Hkv, page, D] of q's type;
    limits [N] int32; layer: int; table [N, max_pages] int32. Returns
    [N, Hq, D]. CPU tensors take :func:`paged_attention_plain`; CUDA tensors
    launch the kernel.
    """
    if q.device.type == "cpu":
        return paged_attention_plain(q, pool_k, pool_v, limits, layer, table)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    N, Hq, D = q.shape
    L, P, Hkv, ps, Dk = pool_k.shape
    G = Hq // Hkv if Hkv else 0
    if (pool_v.shape != pool_k.shape or Dk != D or Hkv * G != Hq
            or not 1 <= G <= _MAX_GROUPS or D % 8):
        raise ValueError(f"paged_attention: bad shapes q {tuple(q.shape)} "
                         f"pool {tuple(pool_k.shape)}")
    if q.dtype not in _DTYPE_CODES or pool_k.dtype != q.dtype \
            or pool_v.dtype != q.dtype:
        raise TypeError(f"paged_attention: q/pools must share bf16 or f32, "
                        f"got {q.dtype}/{pool_k.dtype}/{pool_v.dtype}")
    if limits.dtype != torch.int32 or table.dtype != torch.int32 \
            or limits.shape != (N,) or table.dim() != 2 \
            or table.shape[0] != N or table.shape[1] < 1:
        raise ValueError("paged_attention: limits [N] and table [N, pages] "
                         "must be int32")
    if not 0 <= layer < L:
        raise ValueError(f"paged_attention: layer {layer} outside [0, {L})")
    _check_cuda("paged_attention", (q, pool_k, pool_v, limits, table),
                (pool_k, pool_v))
    out = torch.empty_like(q)
    if N == 0:
        return out
    fn = _attention_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(out.data_ptr(), q.data_ptr(), pool_k.data_ptr(),
                pool_v.data_ptr(), limits.data_ptr(), table.data_ptr(), N,
                Hkv, G, D, P, ps, table.shape[1], layer, 1.0 / math.sqrt(D),
                _DTYPE_CODES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {rc}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0


def decode_attend_paged(q: torch.Tensor, pool_k: torch.Tensor,
                        pool_v: torch.Tensor, lengths: torch.Tensor,
                        layer: int, table: torch.Tensor) -> torch.Tensor:
    """Decode entry: q [B, 1, Hq, D], one row per slot; ``lengths`` counts
    the rows each slot attends over (the just-written row included).
    Returns [B, 1, Hq, D]."""
    return paged_attention(q[:, 0].contiguous(), pool_k, pool_v,
                           lengths.to(torch.int32), layer,
                           table.to(torch.int32))[:, None]


def ragged_attend_paged(q: torch.Tensor, pool_k: torch.Tensor,
                        pool_v: torch.Tensor, row_limits: torch.Tensor,
                        layer: int, row_tables: torch.Tensor) -> torch.Tensor:
    """Ragged entry: N packed rows [N, Hq, D], each with its own table row
    and live-column limit (decode rows and prefill-chunk rows in one
    call). Returns [N, Hq, D]."""
    return paged_attention(q.contiguous(), pool_k, pool_v,
                           row_limits.to(torch.int32), layer,
                           row_tables.to(torch.int32))


def cache_write_rows_paged_plain(pool_k: torch.Tensor, pool_v: torch.Tensor,
                                 k_new: torch.Tensor, v_new: torch.Tensor,
                                 rows: torch.Tensor, layer: int,
                                 table: torch.Tensor) -> None:
    """Plain version of :func:`cache_write_rows_paged` (index-put with the
    drop mask). Row n lands at page table[n, rows[n] // page], offset
    rows[n] % page; rows outside [0, max_pages * page) and page ids outside
    the pool drop."""
    N = rows.shape[0]
    _, P, _, ps, _ = pool_k.shape
    max_pages = table.shape[1]
    r = rows.long()
    ok = (r >= 0) & (r < max_pages * ps)
    pg = table.long()[torch.arange(N, device=r.device),
                      torch.where(ok, r // ps, torch.zeros_like(r))]
    ok &= (pg >= 0) & (pg < P)
    sel = ok.nonzero().squeeze(1)
    off = (r % ps)[sel]
    pool_k[layer, pg[sel], :, off] = k_new[sel].to(pool_k.dtype)
    pool_v[layer, pg[sel], :, off] = v_new[sel].to(pool_v.dtype)


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
    if rows.dtype != torch.int32 or table.dtype != torch.int32 \
            or table.dim() != 2 or table.shape[0] != N or table.shape[1] < 1:
        raise ValueError("cache_write_rows_paged: rows [N] and table "
                         "[N, pages] must be int32")
    if not 0 <= layer < L:
        raise ValueError(f"cache_write_rows_paged: layer {layer} outside "
                         f"[0, {L})")
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


cache_write_rows_paged.launches = 0


def reset_launch_counts() -> None:
    paged_attention.launches = 0
    cache_write_rows_paged.launches = 0


def launch_counts() -> dict:
    return {"paged_attention": paged_attention.launches,
            "cache_write_rows_paged": cache_write_rows_paged.launches}
