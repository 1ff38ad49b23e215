"""Split-KV decode attention: how many CTAs share a row, and their combine.

The decode attention kernels (``csrc/paged_attention.cu``: K1;
``csrc/dense_attention.cu``: K4, K5, K6, K7) give each (query row, kv head)
``splits`` CTAs. Split s walks the s-th of ``splits`` equal runs of the
row's tiles (pages, or 64-row tiles of the dense cache), counted from the
row's first tile (:func:`split_bounds`); a run past the row's last tile is
empty. The speculative verifies (K1's verify entry, K7) give the
``splits`` CTAs to each (slot, row group, kv head) instead: one CTA takes
up to MAX_VERIFY_ROWS of a slot's R x G query rows over a run of the
slot's tiles (:func:`verify_groups`); the chunk rows of K1's ragged
entry give them to each (row tile of CHUNK_ROWS query rows, kv head)
(:func:`chunk_tiles`, ``csrc/split_chunk.cuh``). With one split the CTA
writes the output itself. With more, each CTA leaves its float32 flash
triples in a workspace (``acc`` [splits, rows, Hq, D], ``m`` and ``l``
[splits, rows, Hq]; one ``torch.empty`` per device, stream and host
thread, kept and grown by :func:`launch_plan`) and the combine
(``csrc/split_merge.cuh``) merges a row's triples in split order. The
attention kernels' C entries queue the combine themselves, right after the
kernel; their wrappers count it in ``split_merge.launches``.

- :func:`split_count` picks ``splits`` from shapes only (rows, Hkv, the
  tiles a row may have, and the card's SM count), never from lengths: the
  launch geometry is fixed for an engine shape, and a result repeats bit
  for bit from run to run.
- :func:`split_triples_plain` is the plain version of what the split CTAs
  leave, given the scores as the kernels form them; :func:`split_merge_plain`
  the plain version of the combine. An empty split is (0, -1e30, 0); the
  combine weighs every split by exp(m - max m), so an empty one adds exactly
  0 and a paged row whose one visited page is wholly masked (limit <= 0,
  ROADMAP C2) keeps its mean of V. ``ops/attention.merge_stats``, which
  weighs a triple with m <= -1e29 as 0, would zero that row instead.

:func:`split_merge`, the combine alone (``csrc/split_merge.cu``), takes its
plain version for CPU tensors and launches the kernel for CUDA tensors,
counting its launches in ``split_merge.launches``.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Optional

import torch

from aws_k8s_ansible_provisioner_tpu_torch.ops import cuda_build

NEG_INF = -1e30
# CTAs per SM that a decode step's grid should offer: a bf16 CTA holds a
# two-stage ring of ~73 KB, so three fit on an SM at once, and a fourth
# keeps an SM busy while the short rows' CTAs drain
CTAS_PER_SM = 4
MAX_SPLITS = 32
# query rows (R x G of one kv head) that one verify CTA takes; a slot with
# more takes several row groups (csrc/split_verify.cuh kMaxRows)
MAX_VERIFY_ROWS = 64
# query rows (C x G of one kv head) of a ragged chunk's row tile
# (csrc/split_chunk.cuh kRows), and the CTAs per SM its grid should offer:
# a bf16 row tile's CTA (8 warps, ~102 KB of shared memory) fits twice on
# an SM
CHUNK_ROWS = 128
CHUNK_CTAS_PER_SM = 2

_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}
_RAW = -1
_P = ctypes.c_void_p
_I = ctypes.c_int


def split_count(rows: int, hkv: int, tiles: int, sms: int) -> int:
    """CTAs per (query row, kv head): enough that ``rows * hkv * splits``
    offers CTAS_PER_SM CTAs to each of ``sms`` SMs, at most ``tiles`` (the
    most tiles a row may visit: ``max_pages``, or ``cdiv(S, 64)``) and
    MAX_SPLITS, at least 1. Depends on shapes only."""
    pairs = rows * hkv
    if pairs <= 0 or tiles <= 1:
        return 1
    want = -(-CTAS_PER_SM * sms // pairs)
    return max(1, min(want, tiles, MAX_SPLITS))


def verify_groups(r_rows: int, groups: int) -> int:
    """Row groups of one (slot, kv head) of a verify: its R x G query rows
    in CTAs of up to MAX_VERIFY_ROWS."""
    return max(1, -(-r_rows * groups // MAX_VERIFY_ROWS))


def chunk_tiles(c_rows: int, groups: int) -> int:
    """Row tiles of one kv head of a ragged chunk: its C x G query rows in
    CTAs of CHUNK_ROWS."""
    return max(1, -(-c_rows * groups // CHUNK_ROWS))


def chunk_splits(c_rows: int, groups: int, hkv: int, tiles: int,
                 sms: int, d: int = 128) -> int:
    """CTAs per (row tile, kv head) of a ragged chunk of ``c_rows`` rows:
    as many as one wave of CHUNK_CTAS_PER_SM CTAs (one above head dim
    128: the D 256 instance's shared memory) on each of ``sms`` SMs holds
    (rounded down: a chunk CTA streams many pages, and a partial second
    wave would leave most SMs idle behind it), at most ``tiles``
    (``max_pages``) and MAX_SPLITS, at least 1. Depends on shapes only."""
    pairs = chunk_tiles(c_rows, groups) * hkv
    if tiles <= 1:
        return 1
    per_sm = CHUNK_CTAS_PER_SM if d <= 128 else 1
    return max(1, min(per_sm * sms // pairs, tiles, MAX_SPLITS))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The SM count of a CUDA device, read once per device."""
    return _sms(device.index if device.index is not None
                else torch.cuda.current_device())


def split_bounds(n_tiles: torch.Tensor, splits: int):
    """(begin, end) [N, splits]: the tiles of split s of each row, counted
    from the row's first tile: [s * per, min((s + 1) * per, n_tiles)) with
    per = cdiv(n_tiles, splits); begin >= end is an empty split."""
    n = n_tiles.long()[:, None]
    per = torch.div(n + splits - 1, splits, rounding_mode="floor")
    s = torch.arange(splits, device=n.device)[None, :]
    return s * per, torch.minimum((s + 1) * per, n)


def split_triples_plain(s: torch.Tensor, v: torch.Tensor, tile: torch.Tensor,
                        n_tiles: torch.Tensor, splits: int,
                        vs: Optional[torch.Tensor] = None) -> tuple:
    """What the split CTAs of each row leave (plain version).

    s: [N, Hkv, G, C] float32 scores of the candidate columns as the
    kernels form them (int8: times the K scale; masked columns -1e30);
    v: [N, Hkv, C, D] float32; tile [N, C]: each column's tile counted from
    the row's first, -1 for a column no split visits; n_tiles [N]; vs:
    [N, Hkv, C] int8 V scales or None. Split k's triple over its columns:
    m = max s, p = exp(s - m), l = sum p, acc = sum p (* vs) v; an empty
    split gives (0, -1e30, 0). Returns (acc [splits, N, Hkv * G, D], m and
    l [splits, N, Hkv * G])."""
    N, Hkv, G, _ = s.shape
    begin, end = split_bounds(n_tiles, splits)
    accs, ms, ls = [], [], []
    for k in range(splits):
        sel = ((tile >= begin[:, k:k + 1]) & (tile < end[:, k:k + 1])
               & (tile >= 0))[:, None, None, :]
        s_k = torch.where(sel, s, torch.full_like(s, float("-inf")))
        m = s_k.amax(dim=-1)
        m = torch.where(sel.any(dim=-1), m, torch.full_like(m, NEG_INF))
        p = torch.where(sel, torch.exp(s_k - m[..., None]),
                        torch.zeros_like(s))
        ls.append(p.sum(dim=-1).reshape(N, Hkv * G))
        if vs is not None:
            p = p * vs[:, :, None, :]
        accs.append(torch.einsum("nkgc,nkcd->nkgd", p, v)
                    .reshape(N, Hkv * G, -1))
        ms.append(m.reshape(N, Hkv * G))
    return torch.stack(accs), torch.stack(ms), torch.stack(ls)


def split_merge_plain(acc: torch.Tensor, m: torch.Tensor, l_sum: torch.Tensor,
                      out_dtype: Optional[torch.dtype] = None):
    """Plain version of :func:`split_merge`: acc [splits, ..., D], m and l
    [splits, ...] float32. M = max m, w = exp(m - M), l' = sum l w, acc' =
    sum acc w over the splits. Returns acc' / max(l', 1e-9) in
    ``out_dtype``, or with ``out_dtype`` None the triple (acc', M, l')."""
    m_max = m.amax(dim=0)
    w = torch.exp(m - m_max)
    l_out = (l_sum * w).sum(dim=0)
    acc_out = (acc * w[..., None]).sum(dim=0)
    if out_dtype is None:
        return acc_out, m_max, l_out
    return (acc_out / l_out.clamp_min(1e-9)[..., None]).to(out_dtype)


# the split triples' workspace of each (device, stream, host thread): one
# float32 buffer, grown to the largest launch; the launches that share it
# are queued by one thread on one stream, so a launch's combine has read it
# before the next attention kernel writes it
_workspaces: dict = {}


def launch_plan(rows: int, hkv: int, tiles: int, hq: int, d: int,
                device: torch.device, stream: int,
                cta_rows: Optional[int] = None,
                splits: Optional[int] = None) -> tuple:
    """(splits, the workspace's pointers) of one attention launch queued
    on ``stream`` (a ``cudaStream_t`` of ``device``) over ``rows`` query rows
    whose rows may visit up to ``tiles`` tiles: with one split three nulls,
    with more the split triples acc [splits, rows, hq, d], m and l [splits,
    rows, hq] in this stream's workspace (uninitialized: the attention
    kernel writes every entry that the combine reads). ``cta_rows``: the
    row sets that take ``splits`` CTAs each where one CTA serves several
    query rows (a verify: slots x :func:`verify_groups`), default
    ``rows``; ``splits``, where given, instead of :func:`split_count`'s (a
    ragged chunk's, :func:`chunk_splits`)."""
    if splits is None:
        splits = split_count(rows if cta_rows is None else cta_rows, hkv,
                             tiles, sm_count(device))
    if splits == 1:
        return 1, (None, None, None)
    n = splits * rows * hq
    key = (device, stream, threading.get_ident())
    buf = _workspaces.get(key)
    if buf is None or buf.numel() < n * (d + 2):
        buf = _workspaces[key] = torch.empty(
            n * (d + 2), dtype=torch.float32, device=device)
    p = buf.data_ptr()
    return splits, (p, p + 4 * n * d, p + 4 * n * (d + 1))


def take_workspace(device: torch.device, stream: int):
    """Remove and return the workspace that :func:`launch_plan` keeps for
    ``stream`` on this host thread (None if it has none). A CUDA graph
    captured on that stream holds the buffer's address: its owner keeps the
    buffer for the graph's lifetime, and no later launch can grow (free) it
    or share it."""
    return _workspaces.pop((device, stream, threading.get_ident()), None)


def _merge_lib():
    lib = cuda_build.load("split_merge")
    fn = lib.split_merge
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, ctypes.c_longlong, _I,
                       _I, _P]
        fn.restype = _I
    return fn


def split_merge(acc: torch.Tensor, m: torch.Tensor, l_sum: torch.Tensor,
                out: Optional[torch.Tensor] = None):
    """Combine the split triples acc [splits, ..., D], m and l [splits, ...]
    (float32, contiguous) in split order: into ``out`` [..., D] (bf16 or
    f32) as acc / max(l, 1e-9) and return it, or, with ``out`` None, return
    the combined float32 triple (acc [..., D], m, l [...]). CPU tensors
    take :func:`split_merge_plain`; CUDA tensors launch the kernel."""
    if acc.device.type == "cpu":
        res = split_merge_plain(acc, m, l_sum,
                                None if out is None else out.dtype)
        if out is None:
            return res
        out.copy_(res)
        return out
    what = "split_merge"
    if acc.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {acc.device}")
    if (m.shape != acc.shape[:-1] or l_sum.shape != m.shape
            or (out is not None and out.shape != acc.shape[1:])):
        raise ValueError(f"{what}: bad shapes acc {tuple(acc.shape)} m "
                         f"{tuple(m.shape)} out "
                         f"{None if out is None else tuple(out.shape)}")
    if any(t.dtype != torch.float32 or not t.is_contiguous()
           or t.device != acc.device for t in (acc, m, l_sum)) or (
            out is not None and (out.dtype not in _OUT_CODES
                                 or not out.is_contiguous()
                                 or out.device != acc.device)):
        raise TypeError(f"{what}: float32 contiguous triples on one device "
                        f"and a bf16/f32 contiguous output expected")
    if out is not None:
        res, dst, code = out, (out.data_ptr(), None, None, None), \
            _OUT_CODES[out.dtype]
    else:
        res = tuple(torch.empty(shape, dtype=torch.float32, device=acc.device)
                    for shape in (acc.shape[1:], m.shape[1:], m.shape[1:]))
        dst, code = (None,) + tuple(t.data_ptr() for t in res), _RAW
    heads = math.prod(m.shape[1:])
    if heads == 0:
        return res
    with torch.cuda.device(acc.device):
        rc = _merge_lib()(*dst, acc.data_ptr(), m.data_ptr(),
                          l_sum.data_ptr(), acc.shape[0], heads,
                          acc.shape[-1], code,
                          torch.cuda.current_stream(acc.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"split_merge kernel launch failed: CUDA error "
                           f"{rc}")
    split_merge.launches += 1
    return res


def reset_launch_counts() -> None:
    split_merge.launches = 0


reset_launch_counts()


def launch_counts() -> dict:
    """{"split_merge": launches of the combine kernel}."""
    return {"split_merge": split_merge.launches}
