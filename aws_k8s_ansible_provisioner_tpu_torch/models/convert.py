"""Conversion of a JAX parameter tree or KV page pool (as numpy arrays) into
the port's.

The layouts are the same on both sides (``models/layers.py``), so the
conversion is a leaf-by-leaf copy that keeps every bit: float32, int8 and
bfloat16 leaves all arrive unchanged. A bfloat16 numpy array (the
``ml_dtypes`` type JAX hands out) has no torch counterpart in
``torch.from_numpy``, so its bits travel as int16 and are viewed back.
"""

from __future__ import annotations

import numpy as np
import torch

from aws_k8s_ansible_provisioner_tpu_torch.config import ModelConfig

_NUMPY_TO_TORCH = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int32): torch.int32,
}


def _leaf(a, device) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a))
    if not a.flags.writeable:           # a JAX array's host view is read-only
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    if a.dtype not in _NUMPY_TO_TORCH:
        raise TypeError(f"unsupported parameter dtype {a.dtype}")
    return torch.from_numpy(a).to(device)


def _expected_shapes(cfg: ModelConfig) -> dict:
    """Every leaf the config's tree holds, with its shape: the norms' biases
    with LayerNorm, the projections' biases, ``w_gate`` of a gated MLP,
    a MoE config's router [L, H, E] and stacked experts [L, E, in, out],
    ``post_norm`` outside a parallel block, OPT's ``pos_embed`` and Phi's
    ``lm_head`` bias."""
    L, H, I = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    dense = {"wq": (H, cfg.q_size), "wk": (H, cfg.kv_size),
             "wv": (H, cfg.kv_size), "wo": (cfg.q_size, H)}
    if cfg.num_experts == 0:
        dense.update({"w_up": (H, I), "w_down": (I, H)})
        if cfg.gated_mlp:
            dense["w_gate"] = (H, I)
    norms = [("layers", "input_norm", (L, H)), ("final_norm", None, (H,))]
    if not cfg.parallel_block:
        norms.append(("layers", "post_norm", (L, H)))
    shapes = {("embed", "weight"): (cfg.vocab_size, H)}
    for name, (din, dout) in dense.items():
        shapes[("layers", name, "kernel")] = (L, din, dout)
        bias = cfg.mlp_bias if name.startswith("w_") else cfg.attention_bias
        if bias:
            shapes[("layers", name, "bias")] = (L, dout)
    if cfg.num_experts > 0:
        E, M = cfg.num_experts, cfg.moe_intermediate_size
        shapes[("layers", "router", "kernel")] = (L, H, E)
        for name, din, dout in (("w_gate", H, M), ("w_up", H, M),
                                ("w_down", M, H)):
            shapes[("layers", name, "kernel")] = (L, E, din, dout)
    for top, name, shape in norms:
        path = (top, name) if name else (top,)
        shapes[path + ("weight",)] = shape
        if cfg.norm == "layernorm":
            shapes[path + ("bias",)] = shape
    if cfg.qk_norm:
        shapes[("layers", "q_norm", "weight")] = (L, cfg.head_dim)
        shapes[("layers", "k_norm", "weight")] = (L, cfg.head_dim)
    if cfg.pos_embed == "learned":
        shapes[("pos_embed", "weight")] = (cfg.max_seq_len + 2, H)
    if not cfg.tie_embeddings:
        shapes[("lm_head", "kernel")] = (H, cfg.vocab_size)
        if cfg.parallel_block:
            shapes[("lm_head", "bias")] = (cfg.vocab_size,)
    return shapes


def from_jax_params(tree, cfg: ModelConfig, device="cpu") -> dict:
    """JAX parameter pytree (nested dicts of numpy or JAX arrays; bf16, f32
    or int8-quantized) -> the port's nested dict of torch tensors.

    Shapes are checked against ``cfg``; quantized leaves (int8 kernel plus
    float32 ``scale``) convert like any other.
    """
    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        return _leaf(node, device)

    out = convert(tree)
    for path, expect in _expected_shapes(cfg).items():
        node = out
        for key in path:
            if not isinstance(node, dict) or key not in node:
                raise KeyError(f"parameter {'/'.join(path)} missing")
            node = node[key]
        if tuple(node.shape) != expect:
            raise ValueError(f"parameter {'/'.join(path)}: shape "
                             f"{tuple(node.shape)} != {expect}")
    return out


def from_jax_pool(pool: dict, device="cpu") -> dict:
    """JAX paged KV pool (``{"k", "v"}`` and, int8, ``{"ks", "vs"}``; numpy
    or JAX arrays) -> the port's pool, leaf for leaf and bit for bit, so a
    test can hand one pool to both sides. The leaves are copies: the port
    writes its pool in place, and that must not reach the caller's
    arrays."""
    return {name: _leaf(np.array(arr), device) for name, arr in pool.items()}
