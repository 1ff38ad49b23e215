"""Paged KV cache: the physical page pool, its prefill writers and the host
allocator.

- **Pool**: ``{"k", "v"}`` each ``[L, P, Hkv, page, D]``, the JAX package's
  layout (``serving/paged_kv.py``); int8 pools (``quant=True``) add the
  float32 row scales ``{"ks", "vs"}`` ``[L, P, Hkv, page]``. Page 0 is the
  scratch page every idle slot's table points at, so the garbage rows that
  decode writes for idle slots never land in a page another request owns.
- **Tables**: host numpy ``[num_slots, max_pages]`` int32 of physical page
  ids; entries past a slot's pages hold the scratch page, and padding rows
  of a batched prefill hold ``OOB_PAGE`` (their writes drop).
- **Writers**: the prefill scatters (``write_prompts_paged_layer``,
  ``write_chunk_paged_layer``) are plain torch index-puts, as they were XLA
  scatters in the JAX package. They update the pool IN PLACE (the JAX
  versions return a new pool; the port saves the copy) and return it. Into
  an int8 pool they write ``kv_cache.quantize_rows`` of the rows and their
  scales at the same indices.
- **Allocator**: :class:`PagePool`, free list + refcounts. The prefix-hash
  index and the host tier of the JAX allocator are not ported yet.
"""

from __future__ import annotations

import collections
from typing import List, Optional, Sequence

import numpy as np
import torch

from aws_k8s_ansible_provisioner_tpu_torch.config import ModelConfig
from aws_k8s_ansible_provisioner_tpu_torch.serving.kv_cache import \
    quantize_rows

# Page id that drops a write: large and positive, past every pool.
OOB_PAGE = np.int32(2**31 - 1)


def init_pool(cfg: ModelConfig, num_pages: int, page_size: int,
              dtype=torch.bfloat16, device=None, quant: bool = False) -> dict:
    """Allocate the zeroed physical page pool (leaves carry a leading [L]).
    ``quant``: int8 K/V plus float32 scale leaves ``ks``/``vs``. ``device``
    defaults to CUDA (``device.resolve_device``)."""
    from aws_k8s_ansible_provisioner_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    shape = (cfg.num_layers, num_pages, cfg.num_kv_heads, page_size,
             cfg.head_dim)
    if quant:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                "ks": torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
                "vs": torch.zeros(shape[:-1], dtype=torch.float32, device=dev)}
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def pool_bytes(cfg: ModelConfig, num_pages: int, page_size: int,
               dtype=torch.bfloat16, quant: bool = False) -> int:
    """Bytes of the pool's K and V (and scale) leaves."""
    rows = 2 * cfg.num_layers * num_pages * page_size * cfg.num_kv_heads
    if quant:
        return rows * (cfg.head_dim + 4)
    return rows * cfg.head_dim * torch.empty((), dtype=dtype).element_size()


def _scatter_rows(pool: dict, layer: int, pg: torch.Tensor, off: torch.Tensor,
                  k: torch.Tensor, v: torch.Tensor) -> dict:
    """pool[name][layer, pg[i], :, off[i]] = new[i] for every i whose page id
    lies in the pool; the others drop. pg/off: [M]; k/v: [M, Hkv, D]. An
    int8 pool takes the quantized rows, and its scale leaves the scales at
    the same (page, head, offset)."""
    num_pages = pool["k"].shape[1]
    keep = ((pg >= 0) & (pg < num_pages)).nonzero().squeeze(1)
    pg, off = pg[keep], off[keep]
    new = {"k": k[keep], "v": v[keep]}
    if "ks" in pool:
        new["k"], new["ks"] = quantize_rows(new["k"])
        new["v"], new["vs"] = quantize_rows(new["v"])
    for name, val in new.items():
        pool[name][layer, pg, :, off] = val.to(pool[name].dtype)
    return pool


def write_prompts_paged_layer(pool: dict, layer: int, tables: torch.Tensor,
                              k: torch.Tensor, v: torch.Tensor,
                              page_size: int) -> dict:
    """Batched prompt write for one layer: token t of prompt n lands at
    ``(tables[n, t // page_size], t % page_size)``.

    tables: [N, max_pages]; k/v: [N, T, Hkv, D] with T the padded bucket
    width. Padded rows past a prompt's length DO write through the table, so
    its entries past the prompt's own pages must be scratch or own pages
    (the engine's contract); OOB_PAGE rows drop."""
    N, T = k.shape[:2]
    tok = torch.arange(T, device=k.device)
    pg = tables.long()[:, tok // page_size].reshape(-1)
    off = (tok % page_size).repeat(N)
    return _scatter_rows(pool, layer, pg, off, k.reshape(N * T, *k.shape[2:]),
                         v.reshape(N * T, *v.shape[2:]))


def write_chunk_paged_layer(pool: dict, layer: int, pages: torch.Tensor,
                            start: int, k: torch.Tensor, v: torch.Tensor,
                            page_size: int) -> dict:
    """Write one chunk's rows [start, start + C) across a slot's pages for
    one layer. pages: [max_pages]; k/v: [1, C, Hkv, D]. Rows past
    max_pages * page_size drop."""
    C = k.shape[1]
    rows = start + torch.arange(C, device=k.device)
    idx = rows // page_size
    valid = idx < pages.shape[0]
    pg = torch.where(valid, pages.long()[idx.clamp(max=pages.shape[0] - 1)],
                     torch.full_like(idx, int(OOB_PAGE)))
    return _scatter_rows(pool, layer, pg, rows % page_size, k[0], v[0])


def gather_layer_dense(pool: dict, layer: int, table: torch.Tensor) -> dict:
    """One layer's logical dense view: {name: [B, Hkv, S_v, (D)]} with
    S_v = max_pages * page_size (scale leaves have no D). A full gather;
    the kernels never do this."""
    out = {}
    for name, arr in pool.items():
        g = arr[layer][table.long()]               # [B, n, Hkv, page, (D)]
        g = g.movedim(2, 1)                        # [B, Hkv, n, page, (D)]
        out[name] = g.reshape(g.shape[:2] + (-1,) + g.shape[4:])
    return out


class PagePool:
    """Host-side physical page allocator with refcounts.

    The device only ever sees the block tables the engine builds from it.
    Pages [0, first_page) are reserved (the engine keeps page 0 as scratch).
    A page is free (on the free list) or live (refcount > 0).
    """

    def __init__(self, num_pages: int, page_size: int, first_page: int = 0):
        if num_pages <= first_page or page_size <= 0 or first_page < 0:
            raise ValueError("invalid pool geometry")
        self.num_pages = num_pages
        self.first_page = first_page
        self.page_size = page_size
        self._free: collections.deque = collections.deque(
            range(first_page, num_pages))
        self._ref = np.zeros(num_pages, np.int32)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - self.first_page - self.free_pages

    def alloc(self, n: int = 1) -> Optional[List[int]]:
        """Allocate n pages (refcount 1 each), or None if not enough."""
        if n > self.free_pages:
            return None
        out = [self._free.popleft() for _ in range(n)]
        self._ref[out] = 1
        return out

    def retain(self, pid: int):
        """Take an extra reference on a live page."""
        if self._ref[pid] <= 0:
            raise ValueError(f"page {pid} is not live")
        self._ref[pid] += 1

    def release(self, pid: int):
        """Drop one reference; at zero the page returns to the free list."""
        if self._ref[pid] <= 0:
            raise ValueError(f"page {pid} released more often than held")
        self._ref[pid] -= 1
        if self._ref[pid] == 0:
            self._free.append(pid)

    def release_all(self, pids: Sequence[int]):
        for pid in pids:
            self.release(pid)

    def stats(self) -> dict:
        return {
            "pages_total": self.num_pages - self.first_page,
            "pages_free": len(self._free),
            "pages_live": int((self._ref > 0).sum()),
        }
