"""Int8 KV quantization: the per-row rule both K3 and the prefill scatters
apply, its inverse, and the cache's size in bytes.

K/V rows are stored int8 with one float32 scale per (layer, page, kv head,
row), the per-token-per-head dynamic scheme of the JAX package's
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
