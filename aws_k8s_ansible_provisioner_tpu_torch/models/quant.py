"""Weights-only int8 quantization (the serving default).

Symmetric per-out-channel scales ``s = max|W[:, o]| / 127`` (float32, floored
at 1e-12) and ``q = clip(round(W / s), -127, 127)`` as int8, with round half
to even: the same rule, in the same float32 arithmetic, as the JAX package's
jit-compiled ``models/quant.py`` path (the one its single-device engine
takes), so the int8 values and scales come out bit-identical.

Quantized: the per-layer projections (scales ``[L, out]``; six where a
plain MLP has no ``w_gate``), a MoE config's stacked experts
``[L, E, in, out]`` over their in axis (scales ``[L, E, out]``), the
embedding table (per-vocab-row scales ``[V]``) and an untied ``lm_head``.
Norms, biases (Phi's ``lm_head`` bias among them), the MoE router and
OPT's learned position table stay in the model dtype. A quantized leaf is
the same dict with ``kernel``/``weight`` turned int8 plus a sibling
``scale``. Every matrix is quantized in slices along an axis it is not
reduced over (:func:`quant_kernel_chunked`: the same values), so the
float32 temporaries stay small beside a large tree.
"""

from __future__ import annotations

from typing import Tuple

import torch

from aws_k8s_ansible_provisioner_tpu_torch.config import ModelConfig

# projection -> contraction (in) axis of its stacked [L, in, out] kernel;
# MoE expert kernels are [L, E, in, out] (axis 2)
_DENSE_AXES = {"wq": 1, "wk": 1, "wv": 1, "wo": 1,
               "w_gate": 1, "w_up": 1, "w_down": 1}
_MOE_AXES = {"wq": 1, "wk": 1, "wv": 1, "wo": 1,
             "w_gate": 2, "w_up": 2, "w_down": 2}
# float32 elements of one slice of quant_kernel_chunked
_CHUNK_ELEMS = 1 << 24


def quant_kernel(w: torch.Tensor, in_axis: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-out-channel int8: (q int8, float32 scale with
    ``in_axis`` reduced away)."""
    w32 = w.float()
    # XLA compiles the JAX package's ``max / 127.0`` into a multiply by the
    # float32 reciprocal; the same product here keeps the scales bit-equal
    s = w32.abs().amax(dim=in_axis) * (1.0 / 127.0)
    s = torch.clamp_min(s, 1e-12)
    q = torch.clamp(torch.round(w32 / s.unsqueeze(in_axis)), -127, 127)
    return q.to(torch.int8), s


def quant_kernel_chunked(w: torch.Tensor, in_axis: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`quant_kernel` in slices along the first axis that is not
    ``in_axis`` (the first, or else the last), of up to ``_CHUNK_ELEMS``
    elements each: the same values (every step is per element or reduces
    over ``in_axis`` alone), with float32 temporaries of one slice."""
    axis = 0 if in_axis != 0 else w.dim() - 1
    n = w.shape[axis]
    step = max(1, _CHUNK_ELEMS // max(1, w.numel() // max(n, 1)))
    if step >= n:
        return quant_kernel(w, in_axis)
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    s = torch.empty(w.shape[:in_axis] + w.shape[in_axis + 1:],
                    dtype=torch.float32, device=w.device)
    s_axis = axis if axis < in_axis else axis - 1
    for i in range(0, n, step):
        qi, si = quant_kernel(w.narrow(axis, i, min(step, n - i)), in_axis)
        q.narrow(axis, i, qi.shape[axis]).copy_(qi)
        s.narrow(s_axis, i, si.shape[s_axis]).copy_(si)
    return q, s


def _quant_stacked(w: torch.Tensor, in_axis: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`quant_kernel` of a stacked ``[L, ...]`` kernel, one layer at a
    time (the same values: every step is per element or reduces within a
    layer), so the float32 temporaries never exceed one layer's matrix."""
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    s = torch.empty(w.shape[:in_axis] + w.shape[in_axis + 1:],
                    dtype=torch.float32, device=w.device)
    for layer in range(w.shape[0]):
        q[layer], s[layer] = quant_kernel_chunked(w[layer], in_axis - 1)
    return q, s


def weights_quantized(params: dict) -> bool:
    """Whether ``params`` carries int8 weight leaves (scale siblings)."""
    try:
        return "scale" in params["layers"]["wq"]
    except (KeyError, TypeError):
        return False


def quantize_params(params: dict, cfg: ModelConfig) -> dict:
    """Quantize a bf16/f32 parameter tree to weights-only int8; returns a new
    tree (leaves that are not quantized are shared, not copied)."""
    out = dict(params)
    layers = dict(params["layers"])
    axes = _MOE_AXES if cfg.num_experts > 0 else _DENSE_AXES
    for key, in_axis in axes.items():
        if key not in layers:
            continue
        p = dict(layers[key])
        p["kernel"], p["scale"] = _quant_stacked(p["kernel"], in_axis)
        layers[key] = p
    out["layers"] = layers
    emb = dict(params["embed"])
    emb["weight"], emb["scale"] = quant_kernel_chunked(emb["weight"],
                                                       1)          # [V, H]
    out["embed"] = emb
    if "lm_head" in params:
        p = dict(params["lm_head"])
        p["kernel"], p["scale"] = quant_kernel_chunked(p["kernel"],
                                                       0)          # [H, V]
        out["lm_head"] = p
    return out
