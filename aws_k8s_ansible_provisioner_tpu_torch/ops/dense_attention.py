"""The kernels of the dense slot cache, their wrappers and plain versions.

The dense cache (``serving/kv_cache.init_cache``: ``{"k", "v"}`` each
``[L, B, Hkv, S, D]``, slot b's rows contiguous; int8 with ``{"ks", "vs"}``
``[L, B, Hkv, S]`` float32 scales) is the dense engine's
(``ServingConfig.paged=False``) and the draft model's. Its kernels:

- :func:`decode_attend_dense` (``csrc/dense_attention.cu`` with R = 1)
  replaces ``decode_attend_pallas_layer``: K4 at bblock 1 (bodies
  ``_decode_kernel_layer`` and, with ``cache_ks``/``cache_vs``,
  ``_decode_kernel_layer_q``), flash decode over one layer, slot b
  attending its rows [0, lengths[b]); and K5 with ``bblock`` > 1 (bodies
  ``_decode_kernel_layer_bb`` and ``_decode_kernel_layer_q_bb``), the same
  function: on the H100 a block's slots share no bytes, so the kernel runs
  each slot of a block over its own tiles exactly as K4 does, and the block
  size only names the instance in the launch counters. A row with no live
  column returns zeros at every block size, where the TPU's batch-blocked
  body returns a mean of V (ROADMAP C11);
- :func:`decode_attend_dense_stats` (the second entry of the same
  source, K6) replaces ``decode_attend_pallas_layer(return_stats=True)``
  (bodies ``_decode_kernel_layer_stats`` and, int8,
  ``_decode_kernel_layer_q_stats``): K4's loop over one sequence shard of
  the cache, writing the unnormalized float32 ``acc`` and the running ``m``
  and ``l`` for the sequence-parallel decode's log-sum-exp merge; a slot
  with no row in the shard gives (0, -1e30, 0);
- :func:`spec_attend_dense` (the same source's verify entry,
  ``csrc/split_verify.cuh``) replaces ``decode_attend_pallas_spec``
  (``_spec_kernel_plain``, int8 ``_spec_kernel_quant``): R query rows per
  slot, row r attending the rows [0, lengths[b] + 1 + r); one CTA takes a
  slot's R x G rows of one kv head (up to 64: more take row groups) and
  streams the slot's rows once for all of them, with tensor-core scores
  and P.V;
- with ``window`` > 0 (both entries, the kernel's window instances) a row
  attends only the last ``window`` of those rows and reads no 64-row tile
  below its window start's;
- over an int8 cache the kernels fold the scales into the loop as the TPU
  bodies do: the scores times the K scale, the denominator over the
  unscaled probabilities, the probabilities times the V scale in P.V;
- :func:`cache_write_rows_dense` (K8, ``csrc/cache_write.cu``) replaces
  ``cache_write_row``: R new K and V rows per slot written in place, rows
  outside [0, S) dropped; :func:`cache_write_rows_quant_dense` (K9)
  replaces ``cache_write_row_quant``: the rows quantized
  (``kv_cache.quantize_rows``, bit for bit) into the int8 cache and their
  scales into the scale caches. Both are instances, with the prologue off,
  of the one row-write kernel that also serves the paged pool;
- :func:`prep_write_rows_dense` and :func:`prep_write_rows_quant_dense`
  (the same kernel with its q/k prologue on) replace K8 and K9 together
  with the ``rms_norm`` and ``apply_rope`` of q and k before them
  (``models/layers.py``): one launch takes the layer's raw q, k and v rows,
  returns q normed and rotated, and writes k (normed and rotated) and v,
  copied or quantized. The dense decode, verify and sequence-parallel
  decode callbacks (``ops/attention.py``) write through them; the two
  standalone writes stay callable with their contracts.

The attention kernels are split-KV (``ops/split_kv.py``): each (slot, kv
head), and in the verify each (slot, row group, kv head), gets
``split_kv.split_count`` CTAs from the shapes (slots, Hkv, ``cdiv(S,
64)``, the card's SM count); with more than one, the wrapper passes the
split triples' workspace (``[splits, B * R, Hq, D]`` and twice ``[splits,
B * R, Hq]`` float32, ``split_kv.launch_plan``) and the kernel's C entry
queues the combine after the attention kernel on the same stream (K6:
into the shard's triple that the wrapper returns).

Each wrapper takes its plain PyTorch version for a tensor on the CPU (the
tests), and for a CUDA tensor launches its kernel on the current stream or
raises; nothing falls back. Each keeps a plain integer count of its kernel
launches (the combine counts its own, ``split_kv.split_merge.launches``):
``<wrapper>.launches`` for the bf16/f32 one-slot instance (and
``window_launches`` for its window instance), and ``form_launches[form]``
for the int8 (``"quant"``), batch-blocked (``"bblock"``), int8
batch-blocked (``"quant bblock"``) and stats (``"stats"``, ``"quant
stats"``: K6, counted on ``decode_attend_dense``) instances, each with its
own ``form + " window"``; :func:`launch_counts` lists them all by the
names :func:`instance_name` gives.
"""

from __future__ import annotations

import collections
import ctypes
import math
from typing import Optional

import torch

from aws_k8s_ansible_provisioner_tpu_torch.models.layers import (
    QKPrep, prep_qk_plain)
from aws_k8s_ansible_provisioner_tpu_torch.ops import cuda_build, split_kv
from aws_k8s_ansible_provisioner_tpu_torch.ops.paged_attention import (
    _DTYPE_CODES, _INT8_POOL, _MAX_D, _MAX_GROUPS, _MAX_QUANT_D, NEG_INF,
    _check_cuda, _check_prep, _prep_args, _prep_vectors)
from aws_k8s_ansible_provisioner_tpu_torch.serving.kv_cache import \
    write_token_layer

_P = ctypes.c_void_p
_I = ctypes.c_int
_TILE = 64          # rows of a dense tile (csrc/dense_attention.cu kTile)


def fit_bblock(requested: int, num_slots: int) -> int:
    """The block size a request of ``requested`` slots per CTA resolves to
    over ``num_slots`` slots: the largest divisor of ``num_slots`` not
    above it (0 or less: 1), as the TPU kernel and the JAX engine fit it."""
    bb = max(1, min(int(requested), num_slots))
    while num_slots % bb:
        bb -= 1
    return bb


def dense_attention_plain(q: torch.Tensor, cache_k: torch.Tensor,
                          cache_v: torch.Tensor, limits: torch.Tensor,
                          layer: int, window: int = 0,
                          cache_ks: Optional[torch.Tensor] = None,
                          cache_vs: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Plain version of the dense kernel (every entry and instance): q
    [B, R, Hq, D]; cache [L, B, Hkv, S, D]; limits [B]. Row r of slot b
    attends the columns < limits[b] + r, of which the last ``window`` when
    it is > 0, float32 softmax (``ops/attention.decode_attend_multi``).
    With scale caches ``cache_ks``/``cache_vs`` [L, B, Hkv, S] the cache is
    int8 and the scales fold in as the kernel folds them (the Pallas
    contract, not the JAX XLA fallback's dequantized copy in q's type).
    A row with no column to visit (limits[b] + r <= 0: a decode row of
    length 0) returns zeros, as the kernel's 0 / max(0, 1e-9) and the TPU
    kernel's one-slot body."""
    from aws_k8s_ansible_provisioner_tpu_torch.ops.attention import \
        decode_attend_multi

    R = q.shape[1]
    lim = limits.long()
    if cache_ks is None:
        out = decode_attend_multi(q, cache_k[layer], cache_v[layer], lim - 1,
                                  window)
    else:
        out = _quant_attention_plain(q, cache_k[layer], cache_v[layer],
                                     cache_ks[layer], cache_vs[layer], lim,
                                     window)
    empty = lim[:, None] + torch.arange(R, device=q.device) <= 0
    return torch.where(empty[:, :, None, None], torch.zeros_like(out), out)


def _quant_attention_plain(q, k, v, ks, vs, limits, window):
    """Scale-folding attention over one layer of an int8 dense cache: k/v
    [B, Hkv, S, D] int8, ks/vs [B, Hkv, S]; row r of slot b has the limit
    limits[b] + r. s = (q / sqrt(D)) . k * ks, masked to -1e30; l sums the
    unscaled probabilities; P.V takes them times vs."""
    B, R, Hq, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    qg = q.reshape(B, R, Hkv, Hq // Hkv, D).float() * (1.0 / math.sqrt(D))
    s = torch.einsum("brkgd,bksd->brkgs", qg, k.float()) \
        * ks[:, None, :, None, :]
    lim = limits[:, None] + torch.arange(R, device=q.device)     # [B, R]
    col = torch.arange(S, device=q.device)[None, None, :]
    live = col < lim[:, :, None]                                 # [B, R, S]
    if window > 0:
        live &= col >= lim[:, :, None] - window
    s = torch.where(live[:, :, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l_sum = p.sum(dim=-1, keepdim=True)
    p = p * vs[:, None, :, None, :]
    out = torch.einsum("brkgs,bksd->brkgd", p, v.float()) \
        / l_sum.clamp_min(1e-9)
    return out.reshape(B, R, Hq, D).to(q.dtype)


def _attention_lib():
    lib = cuda_build.load("dense_attention")
    fn = lib.dense_attention
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                       _I, _I, _I, _I, ctypes.c_float, _I, _I, _I, _P]
        fn.restype = _I
    return fn


def _verify_lib():
    lib = cuda_build.load("dense_attention")
    fn = lib.dense_attention_verify
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                       _I, _I, _I, _I, _I, ctypes.c_float, _I, _I, _I, _P]
        fn.restype = _I
    return fn


def _check_attention(what: str, q, cache_k, cache_v, cache_ks, cache_vs,
                     limits, layer: int, window: int, bblock: int) -> tuple:
    """Check the operands of the dense attention kernel (int8 when
    ``cache_ks`` is given): q [B, R, Hq, D], cache [L, B, Hkv, S, D],
    limits [B] int32. Returns (B, R, Hkv, G, D, S, scale caches)."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    if window < 0:
        raise ValueError(f"{what}: window {window} < 0")
    B, R, Hq, D = q.shape
    L, Bc, Hkv, S, Dk = cache_k.shape
    G = Hq // Hkv if Hkv else 0
    quant = cache_ks is not None
    if (cache_v.shape != cache_k.shape or Bc != B or Dk != D
            or Hkv * G != Hq or not 1 <= G <= _MAX_GROUPS or R < 1
            or D % (16 if quant else 8) or D > _MAX_D):
        raise ValueError(f"{what}: bad shapes q {tuple(q.shape)} cache "
                         f"{tuple(cache_k.shape)}")
    if bblock < 1 or (bblock > 1 and (R != 1 or B % bblock)):
        raise ValueError(f"{what}: bblock {bblock} must divide the {B} "
                         f"slots (one row each)")
    cache_type = torch.int8 if quant else q.dtype
    if q.dtype not in _DTYPE_CODES or cache_k.dtype != cache_type \
            or cache_v.dtype != cache_type:
        raise TypeError(f"{what}: q must be bf16 or f32 and the cache "
                        f"{cache_type}, got {q.dtype}/{cache_k.dtype}/"
                        f"{cache_v.dtype}")
    scales = ()
    if quant:
        if cache_vs is None or cache_ks.shape != cache_k.shape[:-1] \
                or cache_vs.shape != cache_ks.shape:
            raise ValueError(f"{what}: scale caches must be [L, B, Hkv, S], "
                             f"got {tuple(cache_ks.shape)}")
        if cache_ks.dtype != torch.float32 or cache_vs.dtype != torch.float32:
            raise TypeError(f"{what}: scale caches must be float32")
        scales = (cache_ks, cache_vs)
    if limits.dtype != torch.int32 or limits.shape != (B,):
        raise ValueError(f"{what}: lengths must be [B] int32")
    if not 0 <= layer < L:
        raise ValueError(f"{what}: layer {layer} outside [0, {L})")
    _check_cuda(what, (q, cache_k, cache_v, limits) + scales,
                (cache_k, cache_v))
    return B, R, Hkv, G, D, S, scales


def attention_splits(rows: int, hkv: int, seq: int,
                     device: torch.device) -> int:
    """CTAs per (query row, kv head) of the dense kernel over ``rows``
    query rows of a cache of ``seq`` rows (``split_kv.split_count``)."""
    return split_kv.split_count(rows, hkv, -(-seq // _TILE),
                                split_kv.sm_count(device))


def _launch_attention(what: str, q, cache_k, cache_v, cache_ks, cache_vs,
                      limits, layer: int, window: int, bblock: int,
                      verify: bool = False) -> torch.Tensor:
    """Check the operands of the dense attention kernel and launch it
    (int8 when ``cache_ks`` is given; the window instance when ``window``
    > 0; ``bblock`` is checked, and does not change the launch). q:
    [B, R, Hq, D]; returns [B, R, Hq, D]. The decode (R = 1): slot b
    attends its rows < ``limits[b]``. ``verify``: the verify entry, row r
    of slot b with the limit ``limits[b] + 1 + r`` (``limits`` = lengths),
    one CTA per (slot, row group, kv head, split)."""
    B, R, Hkv, G, D, S, scales = _check_attention(
        what, q, cache_k, cache_v, cache_ks, cache_vs, limits, layer, window,
        bblock)
    if R != 1 and not verify:
        raise ValueError(f"{what}: one query row per slot, got {R}")
    out = torch.empty_like(q)
    if B == 0:
        return out
    fn = _verify_lib() if verify else _attention_lib()
    code = _DTYPE_CODES[q.dtype]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        splits, ws = split_kv.launch_plan(
            B * R, Hkv, -(-S // _TILE), Hkv * G, D, q.device, stream,
            cta_rows=B * split_kv.verify_groups(R, G) if verify else None)
        rc = fn(out.data_ptr(), *ws, q.data_ptr(), cache_k.data_ptr(),
                cache_v.data_ptr(), cache_ks.data_ptr() if scales else None,
                cache_vs.data_ptr() if scales else None, limits.data_ptr(), B,
                *((R,) if verify else ()), Hkv, G, D, S, layer, window,
                1.0 / math.sqrt(D), code, _INT8_POOL if scales else code,
                splits, stream)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")
    if splits > 1:
        split_kv.split_merge.launches += 1
    return out


def _form(quant: bool, bblock: int, stats: bool = False) -> str:
    return " ".join(name for name, on in (("quant", quant),
                                          ("bblock", bblock > 1),
                                          ("stats", stats)) if on)


def instance_name(entry: str, quant: bool, bblock: int = 1,
                  window: int = 0, stats: bool = False) -> str:
    """The :func:`launch_counts` name of an attention kernel instance:
    the wrapper's name, then "quant" (int8 cache), "bblock" (``bblock`` >
    1), "stats" (K6) and "window" (``window`` > 0) as they apply."""
    form = _form(quant, bblock, stats)
    return entry + (" " + form if form else "") + \
        (" window" if window > 0 else "")


def _count(fn, quant: bool, bblock: int, window: int,
           stats: bool = False) -> None:
    """One launch of ``fn``'s kernel instance: the bf16/f32 one-slot
    instance in ``launches`` (its window instance also in
    ``window_launches``), the others in ``form_launches``."""
    form = _form(quant, bblock, stats)
    if not form:
        fn.launches += 1
        fn.window_launches += window > 0
        return
    fn.form_launches[form] += 1
    if window > 0:
        fn.form_launches[form + " window"] += 1


def decode_attend_dense(q: torch.Tensor, cache_k: torch.Tensor,
                        cache_v: torch.Tensor, lengths: torch.Tensor,
                        layer: int, window: int = 0,
                        cache_ks: Optional[torch.Tensor] = None,
                        cache_vs: Optional[torch.Tensor] = None,
                        bblock: int = 1) -> torch.Tensor:
    """Flash decode over one layer of the dense cache (K4; K5 with
    ``bblock`` > 1).

    q: [B, 1, Hq, D] bf16 or f32; cache [L, B, Hkv, S, D] of q's type, or
    int8 with ``cache_ks``/``cache_vs`` [L, B, Hkv, S] float32; lengths
    [B]: the rows slot b attends (the just-written row counted), of which
    the last ``window`` when it is > 0; layer: int; ``bblock``: the TPU
    kernel's slots per grid step, fitted down to a divisor of B
    (:func:`fit_bblock`); here it names the instance in the launch counters
    (K5 when > 1) and leaves the launch as K4's. Returns
    [B, 1, Hq, D]; a slot of length 0 gets zeros. CPU tensors take
    :func:`dense_attention_plain` (the result does not depend on
    ``bblock``); CUDA tensors launch the kernel."""
    q, lengths = q.contiguous(), lengths.to(torch.int32)
    if q.device.type == "cpu":
        return dense_attention_plain(q, cache_k, cache_v, lengths, layer,
                                     window, cache_ks, cache_vs)
    bb = fit_bblock(bblock, q.shape[0]) if q.shape[0] else 1
    out = _launch_attention("decode_attend_dense", q, cache_k, cache_v,
                            cache_ks, cache_vs, lengths, layer, window, bb)
    _count(decode_attend_dense, cache_ks is not None, bb, window)
    return out


def dense_attention_stats_plain(q: torch.Tensor, cache_k: torch.Tensor,
                                cache_v: torch.Tensor, lengths: torch.Tensor,
                                layer: int,
                                cache_ks: Optional[torch.Tensor] = None,
                                cache_vs: Optional[torch.Tensor] = None
                                ) -> tuple:
    """Plain version of :func:`decode_attend_dense_stats`: q [B, 1, Hq, D];
    one layer of the cache [L, B, Hkv, S, D] (int8 with the scale caches
    ``cache_ks``/``cache_vs`` [L, B, Hkv, S]); slot b attends its rows
    [0, lengths[b]). Returns the float32 flash triple as the kernel leaves
    it: acc [B, Hq, D] = sum_j p_j v_j (int8: p_j * vs_j times the int8
    v_j), m [B, Hq] = max_j s_j and l [B, Hq] = sum_j p_j, with s_j =
    (q / sqrt(D)) . k_j (int8: times ks_j) and p_j = exp(s_j - m). A slot
    with no row gives (0, -1e30, 0)."""
    B, _, Hq, D = q.shape
    k, v = cache_k[layer], cache_v[layer]
    Hkv, S = k.shape[1], k.shape[2]
    qg = q[:, 0].reshape(B, Hkv, Hq // Hkv, D).float() * (1.0 / math.sqrt(D))
    s = torch.einsum("bkgd,bksd->bkgs", qg, k.float())
    if cache_ks is not None:
        s = s * cache_ks[layer][:, :, None, :]
    live = (torch.arange(S, device=q.device)[None, :]
            < lengths.long()[:, None])[:, None, None, :]         # [B,1,1,S]
    s = torch.where(live, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    # masked columns add exactly 0, as exp(-1e30 - m) does in the kernel;
    # a slot with no live column keeps m = -1e30, l = 0 and acc = 0
    p = torch.where(live, torch.exp(s - m), torch.zeros_like(s))
    l_sum = p.sum(dim=-1)
    if cache_vs is not None:
        p = p * cache_vs[layer][:, :, None, :]
    acc = torch.einsum("bkgs,bksd->bkgd", p, v.float())
    return (acc.reshape(B, Hq, D), m.reshape(B, Hq), l_sum.reshape(B, Hq))


def _stats_lib():
    lib = cuda_build.load("dense_attention")
    fn = lib.dense_attention_stats
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                       _I, _I, _I, _I, _I, ctypes.c_float, _I, _I, _I, _P]
        fn.restype = _I
    return fn


def decode_attend_dense_stats(q: torch.Tensor, cache_k: torch.Tensor,
                              cache_v: torch.Tensor, lengths: torch.Tensor,
                              layer: int,
                              cache_ks: Optional[torch.Tensor] = None,
                              cache_vs: Optional[torch.Tensor] = None
                              ) -> tuple:
    """K6: flash decode over one layer of one sequence shard of the dense
    cache, returning the unnormalized float32 flash triple for a
    log-sum-exp merge across shards (``ops/attention.merge_stats``).

    q: [B, 1, Hq, D] bf16 or f32; cache [L, B, Hkv, S_local, D] of q's
    type, or int8 with ``cache_ks``/``cache_vs`` [L, B, Hkv, S_local]
    float32; lengths [B]: the rows slot b holds in this shard. Returns
    (acc [B, Hq, D], m [B, Hq], l [B, Hq]), float32; a slot with no row
    here gives (0, -1e30, 0). No window and no block: the sequence-parallel
    decode takes neither. CPU tensors take
    :func:`dense_attention_stats_plain`; CUDA tensors launch the kernel."""
    q, lengths = q.contiguous(), lengths.to(torch.int32)
    if q.device.type == "cpu":
        return dense_attention_stats_plain(q, cache_k, cache_v, lengths,
                                           layer, cache_ks, cache_vs)
    what = "decode_attend_dense_stats"
    B, R, Hkv, G, D, S, scales = _check_attention(
        what, q, cache_k, cache_v, cache_ks, cache_vs, lengths, layer, 0, 1)
    if R != 1:
        raise ValueError(f"{what}: one query row per slot, got {R}")
    dev = q.device
    acc = torch.empty((B, Hkv * G, D), dtype=torch.float32, device=dev)
    m = torch.empty((B, Hkv * G), dtype=torch.float32, device=dev)
    l_sum = torch.empty_like(m)
    if B == 0:
        return acc, m, l_sum
    fn = _stats_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        splits, ws = split_kv.launch_plan(B, Hkv, -(-S // _TILE), Hkv * G,
                                          D, dev, stream)
        rc = fn(acc.data_ptr(), m.data_ptr(), l_sum.data_ptr(), *ws,
                q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
                cache_ks.data_ptr() if scales else None,
                cache_vs.data_ptr() if scales else None, lengths.data_ptr(),
                B, Hkv, G, D, S, layer, 1.0 / math.sqrt(D),
                _DTYPE_CODES[q.dtype],
                _INT8_POOL if scales else _DTYPE_CODES[q.dtype], splits,
                stream)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")
    if splits > 1:
        split_kv.split_merge.launches += 1
    _count(decode_attend_dense, bool(scales), 1, 0, stats=True)
    return acc, m, l_sum


def spec_attend_dense(q: torch.Tensor, cache_k: torch.Tensor,
                      cache_v: torch.Tensor, lengths: torch.Tensor,
                      layer: int, window: int = 0,
                      cache_ks: Optional[torch.Tensor] = None,
                      cache_vs: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Speculative attention over one layer of the dense cache (K7).

    q: [B, R, Hq, D], the rows at positions ``lengths[b] + r`` (all R
    already written); row r attends the rows [0, lengths[b] + 1 + r), of
    which the last ``window`` when it is > 0; scale caches select the int8
    form. Returns [B, R, Hq, D]. CPU tensors take
    :func:`dense_attention_plain`; CUDA tensors launch the verify kernel,
    which streams each slot's rows once for its R rows (lengths as they
    are)."""
    q, lengths = q.contiguous(), lengths.to(torch.int32)
    if q.device.type == "cpu":
        return dense_attention_plain(q, cache_k, cache_v, lengths + 1, layer,
                                     window, cache_ks, cache_vs)
    out = _launch_attention("spec_attend_dense", q, cache_k, cache_v,
                            cache_ks, cache_vs, lengths, layer, window, 1,
                            verify=True)
    _count(spec_attend_dense, cache_ks is not None, 1, window)
    return out


def cache_write_rows_dense_plain(cache_k: torch.Tensor, cache_v: torch.Tensor,
                                 k_new: torch.Tensor, v_new: torch.Tensor,
                                 rows: torch.Tensor, layer: int) -> None:
    """Plain version of :func:`cache_write_rows_dense`:
    ``kv_cache.write_token_layer``'s index-put with rows outside [0, S)
    dropped."""
    write_token_layer({"k": cache_k, "v": cache_v}, layer, rows, k_new,
                      v_new)


def _check_dense_write(what, cache_k, cache_v, k_new, v_new, rows, layer):
    """Shapes [L, B, Hkv, S, D] / [B, R, Hkv, D] / [B, R] int32 and the
    layer of a dense row write; returns (L, B, Hkv, S, D, R)."""
    if cache_k.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {cache_k.device}")
    L, B, Hkv, S, D = cache_k.shape
    R = rows.shape[1] if rows.dim() == 2 else 0
    if (cache_v.shape != cache_k.shape or rows.shape != (B, R)
            or k_new.shape != (B, R, Hkv, D) or v_new.shape != k_new.shape):
        raise ValueError(f"{what}: bad shapes cache {tuple(cache_k.shape)} "
                         f"new {tuple(k_new.shape)} rows {tuple(rows.shape)}")
    if rows.dtype != torch.int32:
        raise ValueError(f"{what}: rows must be int32")
    if not 0 <= layer < L:
        raise ValueError(f"{what}: layer {layer} outside [0, {L})")
    return L, B, Hkv, S, D, R


def _write_lib():
    lib = cuda_build.load("cache_write")
    fn = lib.cache_write_rows_dense
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
        fn.restype = _I
    return fn


def cache_write_rows_dense(cache_k: torch.Tensor, cache_v: torch.Tensor,
                           k_new: torch.Tensor, v_new: torch.Tensor,
                           rows: torch.Tensor, layer: int) -> None:
    """Write R new K and V rows per slot into one layer of the dense cache,
    in place (K8).

    cache [L, B, Hkv, S, D]; k_new/v_new [B, R, Hkv, D] of the cache's
    type; rows [B, R] int32 (slot b's row r lands at row ``rows[b, r]``;
    rows outside [0, S) drop). CPU tensors take the plain version; CUDA
    tensors launch the kernel (K and V in one launch)."""
    if cache_k.device.type == "cpu":
        cache_write_rows_dense_plain(cache_k, cache_v, k_new, v_new, rows,
                                     layer)
        return
    what = "cache_write_rows_dense"
    _, B, Hkv, S, D, R = _check_dense_write(what, cache_k, cache_v, k_new,
                                            v_new, rows, layer)
    row_bytes = D * cache_k.element_size()
    if row_bytes % 16:
        raise ValueError(f"{what}: bad shapes: a row of {row_bytes} bytes")
    if not (cache_v.dtype == k_new.dtype == v_new.dtype == cache_k.dtype):
        raise TypeError(f"{what}: new rows must have the cache's dtype")
    _check_cuda(what, (cache_k, cache_v, k_new, v_new, rows),
                (cache_k, cache_v, k_new, v_new))
    if B * R == 0:
        return
    fn = _write_lib()
    with torch.cuda.device(cache_k.device):
        stream = torch.cuda.current_stream(cache_k.device).cuda_stream
        rc = fn(cache_k.data_ptr(), cache_v.data_ptr(), k_new.data_ptr(),
                v_new.data_ptr(), rows.data_ptr(), B, R, layer, Hkv, S,
                row_bytes, stream)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")
    cache_write_rows_dense.launches += 1


def cache_write_rows_quant_dense_plain(cache_k: torch.Tensor,
                                       cache_v: torch.Tensor,
                                       cache_ks: torch.Tensor,
                                       cache_vs: torch.Tensor,
                                       k_new: torch.Tensor,
                                       v_new: torch.Tensor,
                                       rows: torch.Tensor, layer: int) -> None:
    """Plain version of :func:`cache_write_rows_quant_dense`:
    ``kv_cache.write_token_layer`` into the int8 cache (``quantize_rows``,
    then the index-put of the rows and of their scales; rows outside
    [0, S) drop)."""
    write_token_layer({"k": cache_k, "v": cache_v, "ks": cache_ks,
                       "vs": cache_vs}, layer, rows, k_new, v_new)


def _quant_write_lib():
    lib = cuda_build.load("cache_write")
    fn = lib.cache_write_rows_quant_dense
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       _I, _P]
        fn.restype = _I
    return fn


def cache_write_rows_quant_dense(cache_k: torch.Tensor, cache_v: torch.Tensor,
                                 cache_ks: torch.Tensor,
                                 cache_vs: torch.Tensor, k_new: torch.Tensor,
                                 v_new: torch.Tensor, rows: torch.Tensor,
                                 layer: int) -> None:
    """Quantize R new K and V rows per slot and write them into one layer
    of the int8 dense cache, their scales into the scale caches, in place
    (K9).

    cache [L, B, Hkv, S, D] int8; scale caches [L, B, Hkv, S] float32;
    k_new/v_new [B, R, Hkv, D] bf16 or f32 (D <= 256); rows [B, R] int32
    (rows outside [0, S) drop). CPU tensors take the plain version; CUDA
    tensors launch the kernel (K and V in one launch)."""
    if cache_k.device.type == "cpu":
        cache_write_rows_quant_dense_plain(cache_k, cache_v, cache_ks,
                                           cache_vs, k_new, v_new, rows,
                                           layer)
        return
    what = "cache_write_rows_quant_dense"
    _, B, Hkv, S, D, R = _check_dense_write(what, cache_k, cache_v, k_new,
                                            v_new, rows, layer)
    if cache_ks.shape != cache_k.shape[:-1] or cache_vs.shape != \
            cache_ks.shape or not 1 <= D <= _MAX_QUANT_D:
        raise ValueError(f"{what}: bad shapes cache {tuple(cache_k.shape)} "
                         f"scales {tuple(cache_ks.shape)}")
    if cache_k.dtype != torch.int8 or cache_v.dtype != torch.int8 \
            or cache_ks.dtype != torch.float32 \
            or cache_vs.dtype != torch.float32 \
            or k_new.dtype not in _DTYPE_CODES or v_new.dtype != k_new.dtype:
        raise TypeError(f"{what}: int8 caches, float32 scale caches and "
                        f"bf16 or f32 rows expected")
    _check_cuda(what, (cache_k, cache_v, cache_ks, cache_vs, k_new, v_new,
                       rows), ())
    if B * R == 0:
        return
    fn = _quant_write_lib()
    with torch.cuda.device(cache_k.device):
        stream = torch.cuda.current_stream(cache_k.device).cuda_stream
        rc = fn(cache_k.data_ptr(), cache_v.data_ptr(), cache_ks.data_ptr(),
                cache_vs.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
                rows.data_ptr(), B, R, layer, Hkv, S, D,
                _DTYPE_CODES[k_new.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")
    cache_write_rows_quant_dense.launches += 1


def prep_write_rows_dense_plain(cache_k: torch.Tensor, cache_v: torch.Tensor,
                                q: torch.Tensor, k_new: torch.Tensor,
                                v_new: torch.Tensor, rows: torch.Tensor,
                                layer: int, prep: QKPrep) -> torch.Tensor:
    """Plain version of :func:`prep_write_rows_dense`:
    ``models/layers.prep_qk_plain`` of q and k, then
    :func:`cache_write_rows_dense_plain` of k and v; returns q."""
    q, k_new = prep_qk_plain(q, k_new, prep)
    cache_write_rows_dense_plain(cache_k, cache_v, k_new, v_new, rows, layer)
    return q


def prep_write_rows_quant_dense_plain(cache_k: torch.Tensor,
                                      cache_v: torch.Tensor,
                                      cache_ks: torch.Tensor,
                                      cache_vs: torch.Tensor,
                                      q: torch.Tensor, k_new: torch.Tensor,
                                      v_new: torch.Tensor,
                                      rows: torch.Tensor, layer: int,
                                      prep: QKPrep) -> torch.Tensor:
    """Plain version of :func:`prep_write_rows_quant_dense`:
    ``models/layers.prep_qk_plain`` of q and k, then
    :func:`cache_write_rows_quant_dense_plain` of k and v; returns q."""
    q, k_new = prep_qk_plain(q, k_new, prep)
    cache_write_rows_quant_dense_plain(cache_k, cache_v, cache_ks, cache_vs,
                                       k_new, v_new, rows, layer)
    return q


def _prep_lib():
    lib = cuda_build.load("cache_write")
    fn = lib.prep_write_rows_dense
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, _P, ctypes.c_float, _I, _I, _P, _P,
                       _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                       _P]
        fn.restype = _I
    return fn


def _launch_prep(fn, caches: tuple, q, k_new, v_new, rows, layer: int,
                 prep: QKPrep) -> torch.Tensor:
    """Check the fused dense write's operands, launch it and count the
    launch on ``fn``, the wrapper. ``caches``: (k, v) of q's type, or int8
    (k, v) with their float32 scale caches (ks, vs); q [B, R, Hq, D], k/v
    [B, R, Hkv, D], rows [B, R], prep's tables [B, R, r], which the
    kernel reads as B * R packed rows. Returns q after the prologue."""
    what = fn.__name__
    _, B, Hkv, S, D, R = _check_dense_write(what, caches[0], caches[1], k_new,
                                            v_new, rows, layer)
    _check_prep(what, caches, q, k_new, v_new, prep)
    vectors = _prep_vectors(caches, q, k_new, v_new, prep)
    _check_cuda(what, vectors + caches[2:] + (rows,), vectors)
    out = torch.empty_like(q)
    if B * R == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _prep_lib()(
            *_prep_args(caches, q, k_new, v_new, prep, out), rows.data_ptr(),
            B, R, layer, Hkv, S, D, _DTYPE_CODES[q.dtype],
            int(len(caches) == 4), stream)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")
    fn.launches += 1
    return out


def prep_write_rows_dense(cache_k: torch.Tensor, cache_v: torch.Tensor,
                          q: torch.Tensor, k_new: torch.Tensor,
                          v_new: torch.Tensor, rows: torch.Tensor,
                          layer: int, prep: QKPrep) -> torch.Tensor:
    """K8 with the layer's q/k prologue fused in: q and k through the
    RMSNorm of ``prep`` (when it carries weights) and RoPE, k and v written
    into the dense cache as :func:`cache_write_rows_dense` writes them;
    returns q after the prologue (for every row, dropped or kept).

    q [B, R, Hq, D], k_new/v_new [B, R, Hkv, D], the layer's raw
    projections, of the cache's type (bf16 or f32; D a multiple of 16 up
    to 256); cache [L, B, Hkv, S, D]; rows [B, R] int32 (rows outside [0,
    S) drop); prep: the norm weights [D] of q's type (or None) and cos/sin
    [B, R, r] float32 (RoPE over the first r columns, r even, 0 for none).
    CPU tensors take the plain version; CUDA tensors
    launch the kernel (one launch for q, K and V)."""
    q, k_new, v_new = q.contiguous(), k_new.contiguous(), v_new.contiguous()
    if q.device.type == "cpu":
        return prep_write_rows_dense_plain(cache_k, cache_v, q, k_new, v_new,
                                           rows, layer, prep)
    return _launch_prep(prep_write_rows_dense, (cache_k, cache_v), q, k_new,
                        v_new, rows, layer, prep)


def prep_write_rows_quant_dense(cache_k: torch.Tensor, cache_v: torch.Tensor,
                                cache_ks: torch.Tensor,
                                cache_vs: torch.Tensor, q: torch.Tensor,
                                k_new: torch.Tensor, v_new: torch.Tensor,
                                rows: torch.Tensor, layer: int,
                                prep: QKPrep) -> torch.Tensor:
    """K9 with the layer's q/k prologue fused in: as
    :func:`prep_write_rows_dense`, with k (after its prologue) and v
    quantized into the int8 cache and their scales into the scale caches
    [L, B, Hkv, S] as :func:`cache_write_rows_quant_dense` quantizes them.
    Returns q after the prologue. CPU tensors take the plain version; CUDA
    tensors launch the kernel's int8 instance."""
    q, k_new, v_new = q.contiguous(), k_new.contiguous(), v_new.contiguous()
    if q.device.type == "cpu":
        return prep_write_rows_quant_dense_plain(cache_k, cache_v, cache_ks,
                                                 cache_vs, q, k_new, v_new,
                                                 rows, layer, prep)
    return _launch_prep(prep_write_rows_quant_dense,
                        (cache_k, cache_v, cache_ks, cache_vs), q, k_new,
                        v_new, rows, layer, prep)


# the attention wrappers also count their window instance's launches and
# their other instances' (form_launches)
_FORMS = {"decode_attend_dense": ("quant", "bblock", "quant bblock",
                                   "stats", "quant stats"),
          "spec_attend_dense": ("quant",)}
_WINDOWED = (decode_attend_dense, spec_attend_dense)
_COUNTED = _WINDOWED + (cache_write_rows_dense, cache_write_rows_quant_dense,
                        prep_write_rows_dense, prep_write_rows_quant_dense)


def reset_launch_counts() -> None:
    for fn in _COUNTED:
        fn.launches = 0
    for fn in _WINDOWED:
        fn.window_launches = 0
        fn.form_launches = collections.Counter()


reset_launch_counts()


def counted_wrappers() -> tuple:
    """The wrappers whose launches this module counts (their ``launches``,
    ``window_launches`` and ``form_launches`` attributes)."""
    return _COUNTED


def launch_counts() -> dict:
    """{wrapper name: launches} and, for the attention wrappers,
    {name + " window": launches of the window instance} and
    {name + " " + form (+ " window"): launches of that instance}; the
    stats instances (K6) have no window instance."""
    out = {fn.__name__: fn.launches for fn in _COUNTED}
    for fn in _WINDOWED:
        out[f"{fn.__name__} window"] = fn.window_launches
        for form in _FORMS[fn.__name__]:
            # the stats instances take no window
            windowed = () if "stats" in form else (form + " window",)
            for name in (form,) + windowed:
                out[f"{fn.__name__} {name}"] = fn.form_launches[name]
    return out
