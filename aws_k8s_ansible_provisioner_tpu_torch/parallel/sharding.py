"""How the serving cache is laid out over a mesh.

The JAX package states its layouts as ``PartitionSpec``s (its
``parallel/sharding.py``; the dense cache's ``cache_pspecs`` `:145-156`:
``[L, slots, Hkv, S, D]`` with slots over ``dp``, kv heads over ``tp``,
the sequence axis over ``sp``, and the int8 scale caches ``[L, slots, Hkv,
S]`` alike). The port serves the ``sp`` axis so far, and builds the layout
directly: :func:`init_cache_sharded` gives one ``kv_cache.init_cache``
dict per sequence shard, ``[L, slots, Hkv, S / sp, D]`` on its device.
Shard i holds the global rows ``[i * S_local, (i + 1) * S_local)``; each
row keeps its own int8 scale, so the quantized bits do not depend on the
sharding. The parameters stay whole on the mesh's lead device.
"""

from __future__ import annotations

from typing import List

import torch

from aws_k8s_ansible_provisioner_tpu_torch.config import ModelConfig
from aws_k8s_ansible_provisioner_tpu_torch.serving import kv_cache as kvc


def check_tp_divisibility(cfg: ModelConfig, tp: int, ep: int = 1) -> None:
    """TP must evenly split query heads, kv heads, the vocabulary and the
    MLP intermediate (the MoE expert intermediate when sparse); ep must
    split the experts (the JAX package's rule)."""
    dims = [("num_heads", cfg.num_heads),
            ("num_kv_heads", cfg.num_kv_heads),
            ("vocab_size", cfg.vocab_size)]
    if cfg.num_experts > 0:
        dims.append(("moe_intermediate_size", cfg.moe_intermediate_size))
    else:
        dims.append(("intermediate_size", cfg.intermediate_size))
    for name, dim in dims:
        if dim % tp != 0:
            raise ValueError(f"tp={tp} does not divide {name}={dim} "
                             f"for model {cfg.name}")
    if ep > 1 and cfg.num_experts % ep != 0:
        raise ValueError(f"ep={ep} does not divide num_experts="
                         f"{cfg.num_experts} for model {cfg.name}")


def sp_size(mesh) -> int:
    """The mesh's sequence-parallel size (1 without a mesh)."""
    return mesh.shape.get("sp", 1) if mesh is not None else 1


def init_cache_sharded(cfg: ModelConfig, num_slots: int, max_len: int,
                       dtype, mesh, quant: bool = False) -> List[dict]:
    """The dense cache of ``num_slots`` windows of ``max_len`` rows with its
    sequence axis split over the mesh's ``sp`` axis: shard i is a zeroed
    ``kv_cache.init_cache`` dict of ``max_len / sp`` rows on the i-th
    device of that axis, allocated there directly (never split from a
    whole cache)."""
    sp = sp_size(mesh)
    if max_len % sp:
        raise ValueError(f"cache window {max_len} does not split into "
                         f"sp={sp} sequence shards")
    return [kvc.init_cache(cfg, num_slots, max_len // sp, dtype, dev,
                           quant=quant) for dev in mesh.axis_devices("sp")]


def gather_rows(shards: List[dict], layer: int, slot: int, n: int,
                device) -> dict:
    """One slot's rows [0, n) of one layer, gathered from the shards in
    order onto ``device``: ``{"k", "v"}`` [Hkv, n, D] (and the scales
    ``{"ks", "vs"}`` [Hkv, n] of an int8 cache)."""
    parts = {name: [] for name in shards[0]}
    for shard, a, b, off in kvc.shard_spans(shards, 0, n):
        for name, leaf in shard.items():
            parts[name].append(leaf[layer, slot, :, a - off:b - off]
                               .to(device))
    return {name: torch.cat(p, dim=1) for name, p in parts.items()}
