"""Int8 KV quantization: the per-row rule that K3, K9 and the prefill
scatters apply, its inverse, and the cache's size in bytes; and the dense
slot cache (:func:`init_cache`) that the dense engine (``paged=False``) and
the draft model keep, with its prompt and chunk scatters (also into a
cache split into sequence shards, ``parallel/sharding.init_cache_sharded``)
and its plain row write (the plain version of K8 and, int8, of K9), and
the slot-to-slot row copy of the dense prefix cache (:func:`copy_prefix`).

K/V rows are stored int8 with one float32 scale per (layer, page or slot,
kv head, row), the per-token-per-head dynamic scheme of the JAX package's
``serving/kv_cache.py`` (``ServingConfig.kv_dtype="int8"``; vLLM's
``kv_cache_dtype``). The rule must give the same bits as the JAX engine's
jitted programs, where XLA turns the division of the row's absolute maximum
by the constant 127 into a multiplication by its float32 reciprocal (the
eager JAX function divides and differs in the last bit of some scales); the
division of each value by its scale stays a division.
"""

from __future__ import annotations

import torch

from aws_k8s_ansible_provisioner_tpu_torch.config import ModelConfig

# float32(1 / 127), the constant XLA multiplies by
INV_127 = 1.0 / 127.0


def quantize_rows(x: torch.Tensor):
    """Per-row symmetric int8 quantization over the trailing head_dim axis.

    x: [..., D] float -> (int8 [..., D], float32 scale [...]) with
    ``x ~ q * scale``: ``scale = max(amax, 1e-6) * float32(1/127)``, then
    ``q = round_half_even(x / scale)``.
    """
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = amax.clamp_min(1e-6) * torch.tensor(INV_127, dtype=torch.float32,
                                                device=x.device)
    q = torch.round(xf / scale[..., None]).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_rows`: q [..., D] int8, scale [...] ->
    float [..., D]."""
    return (q.float() * scale[..., None]).to(dtype)


def cache_bytes(cfg: ModelConfig, num_slots: int, max_len: int,
                dtype=torch.bfloat16, quant: bool = False) -> int:
    """Bytes of K and V for ``num_slots`` windows of ``max_len`` rows: an
    int8 row plus its float32 scale when quantized."""
    rows = 2 * cfg.num_layers * num_slots * max_len * cfg.num_kv_heads
    if quant:
        return rows * (cfg.head_dim + 4)
    return rows * cfg.head_dim * torch.empty((), dtype=dtype).element_size()


def init_cache(cfg: ModelConfig, num_slots: int, max_len: int,
               dtype=torch.bfloat16, device=None, quant: bool = False) -> dict:
    """The dense slot cache: ``{"k", "v"}`` each
    ``[L, num_slots, Hkv, max_len, D]``, zeroed, slot b's rows contiguous
    (the JAX package's ``kv_cache.init_cache`` layout). With ``quant`` the
    K/V leaves are int8 and ``{"ks", "vs"}`` ``[L, num_slots, Hkv,
    max_len]`` float32 hold a scale per (row, kv head). ``device``
    defaults to CUDA (``device.resolve_device``)."""
    from aws_k8s_ansible_provisioner_tpu_torch.device import resolve_device

    shape = (cfg.num_layers, num_slots, cfg.num_kv_heads, max_len,
             cfg.head_dim)
    dev = resolve_device(device)
    if quant:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                "ks": torch.zeros(shape[:-1], dtype=torch.float32,
                                  device=dev),
                "vs": torch.zeros(shape[:-1], dtype=torch.float32,
                                  device=dev)}
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def is_quantized(cache: dict) -> bool:
    return "ks" in cache


def _put(cache: dict, index: tuple, k: torch.Tensor, v: torch.Tensor):
    """Index-put K and V rows (float, [..., D]) at ``index`` of every
    leaf: as they are, or quantized with their scales into an int8 cache
    (a scale's index is its row's without the trailing D axis)."""
    for name, new in (("k", k), ("v", v)):
        if is_quantized(cache):
            q8, scale = quantize_rows(new)
            cache[name][index] = q8
            cache[name + "s"][index] = scale
        else:
            cache[name][index] = new.to(cache[name].dtype)


def shard_spans(shards: list, lo: int, hi: int):
    """For a cache split into sequence shards (``parallel/sharding``:
    shard i holds the global rows [i * S_local, (i + 1) * S_local)): each
    shard holding some of the global rows [lo, hi), with that part as
    (shard, global first row, global end row, the shard's offset)."""
    s_local = shards[0]["k"].shape[3]
    for i, shard in enumerate(shards):
        off = i * s_local
        a, b = max(lo, off), min(hi, off + s_local)
        if a < b:
            yield shard, a, b, off


def write_prompts(cache, layer: int, slots: torch.Tensor,
                  k: torch.Tensor, v: torch.Tensor):
    """Batched prompt write for one layer of the dense cache, in place:
    prompt n's rows [0, T) land in slot ``slots[n]`` (the padded tail too;
    decode masks by length), quantized into an int8 cache. k/v:
    [N, T, Hkv, D]; slots outside the cache drop, as the JAX scatter's
    ``mode="drop"`` drops them. A cache split into sequence shards (a list
    of such dicts) takes each row in the shard that holds it, on that
    shard's device."""
    if isinstance(cache, list):
        for shard, a, b, off in shard_spans(cache, 0, k.shape[1]):
            dev = shard["k"].device
            write_prompts(shard, layer, slots.to(dev), k[:, a:b].to(dev),
                          v[:, a:b].to(dev))
        return cache
    num_slots, T = cache["k"].shape[1], k.shape[1]
    keep = ((slots >= 0) & (slots < num_slots)).nonzero().squeeze(1)
    _put(cache, (layer, slots.long()[keep], slice(None), slice(0, T)),
         k[keep].transpose(1, 2), v[keep].transpose(1, 2))
    return cache


def write_chunk(cache, layer: int, slot: int, start: int,
                k: torch.Tensor, v: torch.Tensor):
    """One prefill chunk's K/V rows into rows [start, start + C) of one
    slot of one layer, in place (quantized into an int8 cache); rows at or
    past the window drop, as the JAX scatter's ``mode="drop"`` drops them
    (a final chunk is never shifted back). k/v: [1, C, Hkv, D]. A cache
    split into sequence shards takes each row in the shard that holds it,
    at its local row."""
    if isinstance(cache, list):
        for shard, a, b, off in shard_spans(cache, start,
                                             start + k.shape[1]):
            dev = shard["k"].device
            write_chunk(shard, layer, slot, a - off,
                        k[:, a - start:b - start].to(dev),
                        v[:, a - start:b - start].to(dev))
        return cache
    S, C = cache["k"].shape[3], k.shape[1]
    n = max(0, min(C, S - start))
    _put(cache, (layer, slot, slice(None), slice(start, start + n)),
         k[0, :n].transpose(0, 1), v[0, :n].transpose(0, 1))
    return cache


def write_token_layer(cache: dict, layer: int, rows: torch.Tensor,
                      k: torch.Tensor, v: torch.Tensor) -> dict:
    """Row write into one layer of the dense cache, in place: slot b's new
    K/V row r lands at row ``rows[b, r]``, quantized into an int8 cache;
    rows outside [0, S) drop. rows: [B, R]; k/v: [B, R, Hkv, D]. The JAX
    package's ``write_token_layer`` is the R = 1 case."""
    S = cache["k"].shape[3]
    r = rows.long()
    ok = ((r >= 0) & (r < S)).nonzero()                   # [M, 2] (b, r)
    b, j = ok[:, 0], ok[:, 1]
    _put(cache, (layer, b, slice(None), r[b, j]), k[b, j], v[b, j])
    return cache


def copy_prefix(cache, src_slot: int, dst_slot: int, n_rows: int):
    """Copy rows [0, n_rows) of ``src_slot`` into ``dst_slot`` in every
    layer and leaf (scales too), in place: the dense engine's prefix cache
    (the JAX package's ``copy_prefix``), one slice copy a leaf. A cache
    split into sequence shards copies each shard's part of the rows on its
    own device (both slots' rows of a span lie in the same shard)."""
    if isinstance(cache, list):
        for shard, a, b, off in shard_spans(cache, 0, n_rows):
            for arr in shard.values():
                arr[:, dst_slot, :, a - off:b - off] = \
                    arr[:, src_slot, :, a - off:b - off]
        return cache
    for arr in cache.values():
        arr[:, dst_slot, :, :n_rows] = arr[:, src_slot, :, :n_rows]
    return cache
