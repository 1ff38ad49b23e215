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
- **Allocator**: :class:`PagePool`, free list, refcounts and the prefix
  cache's chain-hash index with its evictable LRU (the JAX allocator's).
- **Host tier**: :class:`HostTier`, the pinned host-RAM store of pages the
  LRU reclaimed; :func:`gather_pages` reads whole pages for a spill,
  :func:`upload_pages` and :func:`restore_pages` write spilled pages back
  into the pool IN PLACE (``index_copy_``): the decode graphs
  (``programs.DecodeGraphs``) replay kernels that captured the pool's
  storage, so a restore that built a new pool would leave them decoding
  the old one.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Sequence, Tuple

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


def page_bytes(pool) -> int:
    """One page's payload over every leaf of the pool (a dict, or a mesh's
    ``parallel/sharding.ShardedPool``, all its kv heads)."""
    if not isinstance(pool, dict):
        return pool.page_bytes()
    return sum(a.shape[0] * a[0, 0].numel() * a.element_size()
               for a in pool.values())


def page_shapes(pool) -> dict:
    """Each leaf's page payload shape ``[L, Hkv, page, (D)]`` (the host
    tier's fetch check)."""
    if not isinstance(pool, dict):
        return pool.page_shapes()
    return {name: (a.shape[0],) + tuple(a.shape[2:])
            for name, a in pool.items()}


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




# ---------------------------------------------------------------------------
# Host tier: spill and restore of whole pages across PCIe
# ---------------------------------------------------------------------------


def _page_index(pages: Sequence[int], device) -> torch.Tensor:
    """Physical page ids as an int64 tensor on ``device``, through pinned
    memory and a non_blocking copy on a CUDA device (a pageable copy would
    wait for the work queued on the stream)."""
    idx = torch.tensor([int(p) for p in pages], dtype=torch.long)
    if torch.device(device).type == "cuda":
        idx = idx.pin_memory()
    return idx.to(device, non_blocking=True)


def gather_pages(pool: dict, pages: Sequence[int]) -> dict:
    """Queue a gather of whole physical pages for a spill: one
    ``index_select`` a leaf on the current stream, so it reads the pages as
    every dispatch queued before it leaves them and before any queued after
    it writes them.

    pool: leaves ``[L, P, ...]``; pages: physical ids. Returns ``{name:
    [L, k, Hkv, page, (D)]}`` (the JAX layout), each a view of a contiguous
    ``[k, L, ...]`` buffer, so that one page's slice ``[:, i]`` is
    contiguous for its copy to the host. A mesh's pool
    (``parallel/sharding.ShardedPool``) gathers every shard's heads onto
    its lead device."""
    if not isinstance(pool, dict):
        return pool.gather(pages)
    idx = _page_index(pages, pool["k"].device)
    return {name: arr.movedim(1, 0).index_select(0, idx).movedim(0, 1)
            for name, arr in pool.items()}


def upload_pages(entries: List[dict], device) -> dict:
    """Stack host-tier page payloads (``{name: [L, Hkv, page, (D)]}`` each,
    pinned on a CUDA machine) on ``device`` as ``{name: [L, k, ...]}``: one
    non_blocking copy a page and leaf, queued on the current stream."""
    out = {}
    for name, first in entries[0].items():
        buf = torch.empty((len(entries),) + tuple(first.shape),
                          dtype=first.dtype, device=device)
        for i, e in enumerate(entries):
            buf[i].copy_(e[name], non_blocking=True)
        out[name] = buf.movedim(0, 1)
    return out


def restore_pages(pool: dict, pages: Sequence[int], data: dict) -> dict:
    """Write page payloads ``{name: [L, k, Hkv, page, (D)]}`` into the
    physical pages ``pages`` of the pool, in place (``index_copy_`` along
    the page axis of every leaf; no leaf is reallocated; a mesh's pool
    hands each shard its heads). Returns the pool."""
    if not isinstance(pool, dict):
        pool.restore(pages, data)
        return pool
    idx = _page_index(pages, pool["k"].device)
    for name, arr in pool.items():
        arr.index_copy_(1, idx, data[name].to(arr.dtype))
    return pool


class HostTier:
    """Byte-budgeted host-RAM store of spilled KV pages, keyed by chain hash
    (the JAX package's ``HostTier``).

    When the pool's LRU reclaims an indexed page, the engine gathers it
    (:func:`gather_pages`) and :meth:`spill` parks one payload a page here,
    in a slot of host memory taken when the engine is built
    (:meth:`reserve`: one tensor a pool leaf, budget // page bytes slots,
    pinned for a CUDA pool), so that no spill allocates or page-locks host
    memory on the serving path. On a CUDA device each leaf's slice goes
    into its slot by a non_blocking copy, and one event marks the burst's
    copies. A later prompt whose prefix chain walks past the resident pages
    takes the payloads back (:meth:`fetch`, :func:`upload_pages`). No host
    read waits for a spill: the copy back to the device is queued on the
    same stream after the copy to the host, and a slot that an eviction
    frees is refilled only by a copy queued after every copy out of it
    (the engine queues a restore's upload before the allocation whose
    spills may reuse the slots), so stream order keeps every copy right.
    :meth:`flush_to_host` lets go of the device buffers of the bursts whose
    copies have finished, by their events. Eviction is LRU, a page slot
    at a time. A fetch verifies the entry's tokens, leaf names and shapes,
    and drops an entry that fails: the caller re-prefills that span.
    """

    def __init__(self, budget_bytes: int):
        if budget_bytes <= 0:
            raise ValueError("HostTier needs a positive byte budget")
        self.budget_bytes = int(budget_bytes)
        self.used_bytes = 0
        # chain key -> {"tokens": tuple, "data": {name: tensor}, "nbytes",
        # "slot": the page slot its data lies in}
        self._entries: collections.OrderedDict = collections.OrderedDict()
        # the page slots (:meth:`reserve`): {name: [n, L, Hkv, page, (D)]}
        self._slots: Optional[dict] = None
        self._free_slots: collections.deque = collections.deque()
        # bursts whose device-to-host copies may still run: (event, the
        # gathered device buffers)
        self._copies: List[Tuple] = []
        self.spilled_pages = 0
        self.spilled_bytes = 0
        self.restored_pages = 0
        self.restored_bytes = 0
        self.dropped_lru = 0        # evicted by byte pressure
        self.dropped_invalid = 0    # failed verification on fetch

    def __len__(self) -> int:
        return len(self._entries)

    def reserve(self, pool: dict):
        """Take the page slots for the pages of ``pool`` (its leaves
        ``[L, P, ...]``): as many as the budget holds, one host tensor a
        leaf, pinned when the pool lies on a CUDA device. A budget that
        holds no page is an error: the engine builds no tier then. A mesh's
        pool takes the slots of its whole pages (all kv heads)."""
        if not isinstance(pool, dict):
            pool = pool.page_template()
        page_bytes = sum(a[:, 0].numel() * a.element_size()
                         for a in pool.values())
        n = self.budget_bytes // page_bytes
        if n == 0:
            raise ValueError(f"a host tier of {self.budget_bytes} bytes "
                             f"holds no page of {page_bytes} bytes")
        pin = pool["k"].is_cuda
        self._slots = {name: torch.empty(
            (n, a.shape[0]) + tuple(a.shape[2:]), dtype=a.dtype,
            pin_memory=pin) for name, a in pool.items()}
        self._free_slots = collections.deque(range(n))

    def _drop(self, e: dict):
        self.used_bytes -= e["nbytes"]
        self._free_slots.append(e["slot"])

    def _evict_lru(self):
        _, dropped = self._entries.popitem(last=False)       # LRU front
        self._drop(dropped)
        self.dropped_lru += 1

    def spill(self, log: Sequence[Tuple], data: dict, page_bytes: int):
        """Park one reclaim burst: ``log`` the pool's ``evicted_log``
        entries (pid, chain key, tokens), ``data`` their
        :func:`gather_pages`. Each page takes a free slot (evicting the LRU
        entry when none is free, so the slots bound the bytes) and
        refreshes an entry of the same key; the copies to the host are
        queued, not waited for (the earlier bursts whose copies have
        finished are let go of first). Needs :meth:`reserve`."""
        if self._slots is None:
            raise RuntimeError("HostTier.spill before reserve()")
        self.flush_to_host()
        cuda = data["k"].is_cuda
        for i, (_, key, toks) in enumerate(log):
            old = self._entries.pop(key, None)
            if old is not None:
                self._drop(old)
            while not self._free_slots:
                self._evict_lru()
            slot = self._free_slots.popleft()
            entry = {}
            for name, arr in data.items():
                host = self._slots[name][slot]
                host.copy_(arr[:, i], non_blocking=cuda)
                entry[name] = host
            self._entries[key] = {"tokens": toks, "data": entry,
                                  "nbytes": page_bytes, "slot": slot}
            self.used_bytes += page_bytes
            self.spilled_pages += 1
            self.spilled_bytes += page_bytes
        if cuda:
            event = torch.cuda.Event()
            event.record()
            self._copies.append((event, data))

    def contains(self, key: Tuple, tokens: Tuple) -> bool:
        """Membership with token verification (no LRU bump, no payload
        checks: :meth:`fetch` decides at restore time)."""
        e = self._entries.get(key)
        return e is not None and e["tokens"] == tokens

    def fetch(self, key: Tuple, tokens: Tuple,
              shapes: Dict[str, Tuple]) -> Optional[dict]:
        """A verified entry's payload (LRU-bumped), or None. ``shapes``
        maps leaf name -> per-page shape ``[L, Hkv, page, (D)]``; an entry
        whose tokens, leaf names or shapes differ is dropped. The payload
        may lie in a slot that a later spill refills: copy it out (queue
        :func:`upload_pages`) before anything can spill."""
        e = self._entries.get(key)
        if e is None:
            return None
        data = e["data"]
        ok = (e["tokens"] == tokens
              and set(data.keys()) == set(shapes.keys())
              and all(tuple(data[n].shape) == tuple(shapes[n])
                      for n in shapes))
        if not ok:
            del self._entries[key]
            self._drop(e)
            self.dropped_invalid += 1
            return None
        self._entries.move_to_end(key)
        return data

    def note_restored(self, pages: int, nbytes: int):
        self.restored_pages += pages
        self.restored_bytes += nbytes

    def corrupt(self, key: Tuple):
        """Truncate an entry's payload in place, so that the next
        :meth:`fetch` fails verification and drops it (a bad copy or host
        memory found at restore time)."""
        e = self._entries.get(key)
        if e is not None:
            e["data"] = {n: a[:-1] for n, a in e["data"].items()}

    def flush_to_host(self):
        """Let go of the gathered device buffers of the bursts whose copies
        to the host have finished, by their events: nothing waits (a copy
        back reads a slot after its copy in by stream order)."""
        self._copies = [(event, data) for event, data in self._copies
                        if not event.query()]

    def stats(self) -> dict:
        return {
            "budget_bytes": self.budget_bytes,
            "used_bytes": self.used_bytes,
            "entries": len(self._entries),
            "spilled_pages": self.spilled_pages,
            "spilled_bytes": self.spilled_bytes,
            "restored_pages": self.restored_pages,
            "restored_bytes": self.restored_bytes,
            "dropped_lru": self.dropped_lru,
            "dropped_invalid": self.dropped_invalid,
        }


# ---------------------------------------------------------------------------
# Host allocator
# ---------------------------------------------------------------------------


class PagePool:
    """Host-side physical page allocator with refcounts and the prefix
    cache's chain-hash index (the JAX package's ``PagePool``).

    The device only ever sees the block tables the engine builds from it.
    Pages [0, first_page) are reserved (the engine keeps page 0 as scratch).
    A page is free (on the free list, content meaningless), live (refcount
    > 0) or evictable (refcount 0, content kept and indexed by its chain
    key, in the LRU ``_evictable``: matchable until the free list runs dry
    and an allocation reclaims it from the LRU front).

    A full page holding tokens[p * ps:(p + 1) * ps] of a sequence is keyed
    by ``hash((parent_key, those tokens))``, the parent being the previous
    page's key (None for the first page): equal keys mean equal prefixes,
    up to hash collisions, which the stored tokens rule out on a hit.
    Partial pages are never indexed. With a :class:`HostTier` attached
    (``host_tier``), every indexed page the LRU reclaims is logged in
    ``evicted_log`` as (pid, chain key, tokens) for the engine to spill
    before anything overwrites it.
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
        # page id -> (chain key, tokens) of an indexed page
        self._page_key: Dict[int, Tuple] = {}
        # chain key -> page id (the latest content wins)
        self._hash_to_page: Dict[Tuple, int] = {}
        # LRU of evictable pages: page id -> None
        self._evictable: collections.OrderedDict = collections.OrderedDict()
        self.host_tier: Optional[HostTier] = None
        self.evicted_log: List[Tuple[int, Tuple, Tuple]] = []

    @property
    def free_pages(self) -> int:
        """Pages allocatable now: the free list plus the evictable ones."""
        return len(self._free) + len(self._evictable)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - self.first_page - self.free_pages

    def _pop_physical(self) -> int:
        if self._free:
            return self._free.popleft()
        pid, _ = self._evictable.popitem(last=False)          # LRU front
        if self.host_tier is not None and pid in self._page_key:
            key, toks = self._page_key[pid]
            self.evicted_log.append((pid, key, toks))
        self._drop_index(pid)
        return pid

    def _drop_index(self, pid: int):
        key = self._page_key.pop(pid, None)
        if key is not None and self._hash_to_page.get(key[0]) == pid:
            del self._hash_to_page[key[0]]

    def alloc(self, n: int = 1) -> Optional[List[int]]:
        """Allocate n pages (refcount 1 each), or None if not enough."""
        if n > self.free_pages:
            return None
        out = [self._pop_physical() for _ in range(n)]
        self._ref[out] = 1
        return out

    def retain(self, pid: int):
        """Take an extra reference on a live page, or take an evictable
        one back out of the LRU (its index stays)."""
        if self._ref[pid] <= 0:
            if pid not in self._evictable:
                raise ValueError(f"page {pid} is neither live nor evictable")
            del self._evictable[pid]
        self._ref[pid] += 1

    def release(self, pid: int):
        """Drop one reference; at zero an indexed page becomes evictable
        (most recently used), any other returns to the free list."""
        if self._ref[pid] <= 0:
            raise ValueError(f"page {pid} released more often than held")
        self._ref[pid] -= 1
        if self._ref[pid] == 0:
            if pid in self._page_key:
                self._evictable[pid] = None
                self._evictable.move_to_end(pid)
            else:
                self._free.append(pid)

    def release_all(self, pids: Sequence[int]):
        for pid in pids:
            self.release(pid)

    @staticmethod
    def chain_key(parent_key, tokens: Tuple) -> Tuple:
        """The chain key of a full page holding ``tokens`` after the prefix
        whose last page has ``parent_key`` (None for the first page). A
        tuple of ints hashes the same in every process, so these keys equal
        the JAX package's."""
        return (hash((parent_key, tokens)),)

    def index_page(self, pid: int, parent_key, tokens: Tuple):
        """Register a live full page's content for prefix reuse; returns
        its chain key."""
        key = self.chain_key(parent_key, tokens)
        self._drop_index(pid)       # replace any stale identity
        self._page_key[pid] = (key, tokens)
        self._hash_to_page[key] = pid
        return key

    def lookup_prefix(self, prompt: Sequence[int], salt=None
                      ) -> Tuple[List[int], int, List[Tuple]]:
        """Two-level longest-prefix match over whole pages: the resident
        chain, then its extension in the host tier.

        Returns ``(page_ids, n_tokens, host_keys)``: the resident pages
        matched (not retained: the caller retains what it uses before any
        allocation can reclaim them), the tokens they hold, and the chain
        keys of the host-restorable pages right after them, in prefix
        order (empty without a tier). ``salt`` seeds the chain."""
        ps = self.page_size
        pages: List[int] = []
        parent = salt
        full = len(prompt) // ps
        p = 0
        while p < full:
            toks = tuple(prompt[p * ps:(p + 1) * ps])
            key = self.chain_key(parent, toks)
            pid = self._hash_to_page.get(key)
            if pid is None or self._page_key.get(pid, (None, None))[1] \
                    != toks:
                break
            pages.append(pid)
            parent = key
            p += 1
        host: List[Tuple] = []
        if self.host_tier is not None:
            while p < full:
                toks = tuple(prompt[p * ps:(p + 1) * ps])
                key = self.chain_key(parent, toks)
                if not self.host_tier.contains(key, toks):
                    break
                host.append(key)
                parent = key
                p += 1
        return pages, len(pages) * ps, host

    def stats(self) -> dict:
        out = {
            "pages_total": self.num_pages - self.first_page,
            "pages_free": len(self._free),
            "pages_evictable": len(self._evictable),
            "pages_live": int((self._ref > 0).sum()),
        }
        if self.host_tier is not None:
            out["host_tier"] = self.host_tier.stats()
        return out
