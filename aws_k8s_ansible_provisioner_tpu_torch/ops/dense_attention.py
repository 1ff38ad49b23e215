"""The kernels of the dense slot cache, their wrappers and plain versions.

The dense cache (``serving/kv_cache.init_cache``: ``{"k", "v"}`` each
``[L, B, Hkv, S, D]``, slot b's rows contiguous) is the draft model's in
speculative decoding. Its kernels:

- :func:`decode_attend_dense` (K4, ``csrc/dense_attention.cu`` with R = 1)
  replaces ``decode_attend_pallas_layer`` (bblock 1, body
  ``_decode_kernel_layer``): flash decode over one layer, slot b attending
  its rows [0, lengths[b]);
- :func:`spec_attend_dense` (K7, the same kernel with R > 1) replaces
  ``decode_attend_pallas_spec`` (``_spec_kernel_plain``): R query rows per
  slot, row r attending the rows [0, lengths[b] + 1 + r); the kernel takes
  them as B * R packed rows, row n of slot n // R;
- with ``window`` > 0 (both entries, the kernel's window instance) a row
  attends only the last ``window`` of those rows and reads no 64-row tile
  below its window start's;
- :func:`cache_write_rows_dense` (K8, third entry of ``csrc/cache_write.cu``)
  replaces ``cache_write_row``: R new K and V rows per slot written in
  place, rows outside [0, S) dropped.

Each wrapper takes its plain PyTorch version for a tensor on the CPU (the
tests), and for a CUDA tensor launches its kernel on the current stream or
raises; nothing falls back. Each keeps a plain integer count of its kernel
launches in ``<wrapper>.launches``. The int8 bodies of the TPU kernels
(``_decode_kernel_layer_q``, ``_spec_kernel_quant``, ``cache_write_row_quant``)
are not ported: the draft's cache is never quantized.
"""

from __future__ import annotations

import ctypes
import math

import torch

from aws_k8s_ansible_provisioner_tpu_torch.ops import cuda_build
from aws_k8s_ansible_provisioner_tpu_torch.ops.paged_attention import (
    _DTYPE_CODES, _MAX_GROUPS, _check_cuda, _count)
from aws_k8s_ansible_provisioner_tpu_torch.serving.kv_cache import \
    write_token_layer

_P = ctypes.c_void_p
_I = ctypes.c_int


def dense_attention_plain(q: torch.Tensor, cache_k: torch.Tensor,
                          cache_v: torch.Tensor, limits: torch.Tensor,
                          layer: int, window: int = 0) -> torch.Tensor:
    """Plain version of the dense kernel (both entries): q [B, R, Hq, D];
    cache [L, B, Hkv, S, D]; limits [B]. Row r of slot b attends the
    columns < limits[b] + r, of which the last ``window`` when it is > 0
    (``ops/attention.decode_attend_multi``, float32 softmax). A row with no
    column to visit (limits[b] + r <= 0: a decode row of length 0) returns
    zeros, as the kernel's 0 / max(0, 1e-9) and the TPU kernel's."""
    from aws_k8s_ansible_provisioner_tpu_torch.ops.attention import \
        decode_attend_multi

    R = q.shape[1]
    lim = limits.long()
    out = decode_attend_multi(q, cache_k[layer], cache_v[layer], lim - 1,
                              window)
    empty = lim[:, None] + torch.arange(R, device=q.device) <= 0
    return torch.where(empty[:, :, None, None], torch.zeros_like(out), out)


def _attention_lib():
    lib = cuda_build.load("dense_attention")
    fn = lib.dense_attention
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                       ctypes.c_float, _I, _P]
        fn.restype = _I
    return fn


def _launch_attention(what: str, q, cache_k, cache_v, limits, layer: int,
                      window: int) -> torch.Tensor:
    """Check the operands of the dense attention kernel and launch it (the
    window instance when ``window`` > 0). q: [B, R, Hq, D]; returns
    [B, R, Hq, D]."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    if window < 0:
        raise ValueError(f"{what}: window {window} < 0")
    B, R, Hq, D = q.shape
    L, Bc, Hkv, S, Dk = cache_k.shape
    G = Hq // Hkv if Hkv else 0
    if (cache_v.shape != cache_k.shape or Bc != B or Dk != D
            or Hkv * G != Hq or not 1 <= G <= _MAX_GROUPS or R < 1
            or D % 8):
        raise ValueError(f"{what}: bad shapes q {tuple(q.shape)} cache "
                         f"{tuple(cache_k.shape)}")
    if q.dtype not in _DTYPE_CODES or cache_k.dtype != q.dtype \
            or cache_v.dtype != q.dtype:
        raise TypeError(f"{what}: q and the cache must be bf16 or f32 of one "
                        f"type, got {q.dtype}/{cache_k.dtype}/"
                        f"{cache_v.dtype}")
    if limits.dtype != torch.int32 or limits.shape != (B,):
        raise ValueError(f"{what}: lengths must be [B] int32")
    if not 0 <= layer < L:
        raise ValueError(f"{what}: layer {layer} outside [0, {L})")
    _check_cuda(what, (q, cache_k, cache_v, limits), (cache_k, cache_v))
    out = torch.empty_like(q)
    if B == 0:
        return out
    fn = _attention_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(out.data_ptr(), q.data_ptr(), cache_k.data_ptr(),
                cache_v.data_ptr(), limits.data_ptr(), B, Hkv, G, R, D, S,
                layer, window, 1.0 / math.sqrt(D), _DTYPE_CODES[q.dtype],
                stream)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")
    return out


def decode_attend_dense(q: torch.Tensor, cache_k: torch.Tensor,
                        cache_v: torch.Tensor, lengths: torch.Tensor,
                        layer: int, window: int = 0) -> torch.Tensor:
    """Flash decode over one layer of the dense cache (K4).

    q: [B, 1, Hq, D] bf16 or f32; cache [L, B, Hkv, S, D] of q's type;
    lengths [B]: the rows slot b attends (the just-written row counted), of
    which the last ``window`` when it is > 0; layer: int. Returns
    [B, 1, Hq, D]; a slot of length 0 gets zeros. CPU tensors take
    :func:`dense_attention_plain`; CUDA tensors launch the kernel."""
    q, lengths = q.contiguous(), lengths.to(torch.int32)
    if q.device.type == "cpu":
        return dense_attention_plain(q, cache_k, cache_v, lengths, layer,
                                     window)
    out = _launch_attention("decode_attend_dense", q, cache_k, cache_v,
                            lengths, layer, window)
    _count(decode_attend_dense, window)
    return out


def spec_attend_dense(q: torch.Tensor, cache_k: torch.Tensor,
                      cache_v: torch.Tensor, lengths: torch.Tensor,
                      layer: int, window: int = 0) -> torch.Tensor:
    """Speculative attention over one layer of the dense cache (K7).

    q: [B, R, Hq, D], the rows at positions ``lengths[b] + r`` (all R
    already written); row r attends the rows [0, lengths[b] + 1 + r), of
    which the last ``window`` when it is > 0. Returns [B, R, Hq, D]. CPU
    tensors take :func:`dense_attention_plain`; CUDA tensors launch the
    kernel."""
    q, limits = q.contiguous(), lengths.to(torch.int32) + 1
    if q.device.type == "cpu":
        return dense_attention_plain(q, cache_k, cache_v, limits, layer,
                                     window)
    out = _launch_attention("spec_attend_dense", q, cache_k, cache_v, limits,
                            layer, window)
    _count(spec_attend_dense, window)
    return out


def cache_write_rows_dense_plain(cache_k: torch.Tensor, cache_v: torch.Tensor,
                                 k_new: torch.Tensor, v_new: torch.Tensor,
                                 rows: torch.Tensor, layer: int) -> None:
    """Plain version of :func:`cache_write_rows_dense`:
    ``kv_cache.write_token_layer``'s index-put with rows outside [0, S)
    dropped."""
    write_token_layer({"k": cache_k, "v": cache_v}, layer, rows, k_new,
                      v_new)


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
    if cache_k.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {cache_k.device}")
    L, B, Hkv, S, D = cache_k.shape
    R = rows.shape[1] if rows.dim() == 2 else 0
    row_bytes = D * cache_k.element_size()
    if (cache_v.shape != cache_k.shape or rows.shape != (B, R)
            or k_new.shape != (B, R, Hkv, D) or v_new.shape != k_new.shape
            or row_bytes % 16):
        raise ValueError(f"{what}: bad shapes cache {tuple(cache_k.shape)} "
                         f"new {tuple(k_new.shape)} rows {tuple(rows.shape)}")
    if not (cache_v.dtype == k_new.dtype == v_new.dtype == cache_k.dtype):
        raise TypeError(f"{what}: new rows must have the cache's dtype")
    if rows.dtype != torch.int32:
        raise ValueError(f"{what}: rows must be int32")
    if not 0 <= layer < L:
        raise ValueError(f"{what}: layer {layer} outside [0, {L})")
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


# the attention wrappers also count their window instance's launches
_WINDOWED = (decode_attend_dense, spec_attend_dense)
_COUNTED = _WINDOWED + (cache_write_rows_dense,)


def reset_launch_counts() -> None:
    for fn in _COUNTED:
        fn.launches = 0
    for fn in _WINDOWED:
        fn.window_launches = 0


reset_launch_counts()


def launch_counts() -> dict:
    """{wrapper name: launches} and, for the attention wrappers,
    {name + " window": launches of the window instance}."""
    out = {fn.__name__: fn.launches for fn in _COUNTED}
    out.update({f"{fn.__name__} window": fn.window_launches
                for fn in _WINDOWED})
    return out
