"""Multi-LoRA serving: per-request adapters batched into one dispatch.

The port's counterpart of the JAX package's ``models/lora.py``: the same
peft adapter directories, the same refusals, the same rslora scale and the
same stacking (:func:`stack_adapters`: the zero base adapter at index 0,
ranks padded with zeros), so that both packages load one directory alike.

:func:`attach` lays the stacked factors out for the port's forward pass
(``models/layers._linear``). Where the JAX forward gathers each row's
``[din, r]`` factors by its adapter index, here the N adapters' A factors
are concatenated along the rank into ``[din, N * r]`` and their B factors
into ``[N * r, dout]``, and a row computes ``((x @ A) * mask) @ B`` with a
mask that keeps only its own adapter's columns (all zero for a base row):
two small matmuls a projection whatever the mix of adapters, no shape that
depends on the data, so the decode graphs capture it. The projections that
share an input are grouped: q, k and v (on the attention input) and gate
and up (on the MLP input) share one A matmul and one block B matmul whose
output columns are the concatenated projections, so that an adapter adds
four pairs of matmuls a layer, not seven.

Targets are the attention and dense MLP projections; embeddings are not
targetable (the loader raises). The factors stay in the activation dtype
beside int8 base kernels (the JAX engine attaches after quantization too).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from aws_k8s_ansible_provisioner_tpu_torch.models.hf_loader import \
    read_safetensors

# peft module name -> the parameter tree's stacked-layer name
TARGET_MAP = {
    "q_proj": "wq",
    "k_proj": "wk",
    "v_proj": "wv",
    "o_proj": "wo",
    "gate_proj": "w_gate",
    "up_proj": "w_up",
    "down_proj": "w_down",
}

# the projections that share an input, and the group's leaf name in the
# layer tree; a group's output columns are its members' outputs in order,
# of those the model has (a plain MLP's lora_gu is w_up alone)
GROUPS = (("lora_qkv", ("wq", "wk", "wv")),
          ("lora_gu", ("w_gate", "w_up")),
          ("lora_o", ("wo",)),
          ("lora_down", ("w_down",)))


def load_adapter(adapter_dir: str) -> dict:
    """Read one peft adapter dir -> {"r": r, "targets": {target: (A [L, din,
    r], B [L, r, dout])}} in float32, with ``lora_alpha / r`` (rslora:
    ``lora_alpha / sqrt(r)``) folded into B. peft stores per-layer
    ``...layers.<i>.<module>.<proj>.lora_A.weight`` [r, din] and
    ``lora_B.weight`` [dout, r]; they are stacked over layers in the
    right-multiplication orientation. DoRA, LoRA biases, per-module alpha
    or rank overrides, an unknown module or tensor and a missing layer
    raise ValueError (the JAX loader's messages)."""
    cfg_path = os.path.join(adapter_dir, "adapter_config.json")
    with open(cfg_path) as fh:
        acfg = json.load(fh)
    r = int(acfg["r"])
    for unsupported in ("use_dora", "lora_bias"):
        if acfg.get(unsupported):
            # DoRA magnitudes / bias tensors change the adapter math; plain
            # LoRA application would serve degraded outputs silently
            raise ValueError(f"adapter {adapter_dir}: {unsupported} is not "
                             f"supported")
    for patterned in ("alpha_pattern", "rank_pattern"):
        if acfg.get(patterned):
            # a uniform scale over per-module overrides would serve degraded
            # adapters with no diagnostic
            raise ValueError(f"adapter {adapter_dir}: {patterned} per-module "
                             f"overrides are not supported")
    alpha = float(acfg.get("lora_alpha", r))
    # rslora (Kalajdzievski 2023): scaling is alpha / sqrt(r), not alpha / r
    scale = alpha / (r ** 0.5) if acfg.get("use_rslora") else alpha / r
    raw = read_safetensors(os.path.join(adapter_dir,
                                        "adapter_model.safetensors"))

    per_target: Dict[str, Dict[int, list]] = {}
    for key, val in raw.items():
        parts = key.split(".")
        try:
            layer = int(parts[parts.index("layers") + 1])
        except ValueError:
            raise ValueError(f"unsupported adapter key (no layer index): "
                             f"{key}")
        proj = next((p for p in parts if p in TARGET_MAP), None)
        if proj is None:
            raise ValueError(f"adapter targets an unsupported module: {key} "
                             f"(supported: {sorted(TARGET_MAP)})")
        if key.endswith("lora_A.weight"):
            which = 0
        elif key.endswith("lora_B.weight"):
            which = 1
        else:
            raise ValueError(f"unsupported adapter tensor {key!r} (only "
                             f"lora_A.weight / lora_B.weight)")
        slot = per_target.setdefault(TARGET_MAP[proj], {}) \
            .setdefault(layer, [None, None])
        slot[which] = val.float().numpy()

    out = {}
    for target, layers in per_target.items():
        L = max(layers) + 1
        a_l, b_l = [], []
        for i in range(L):
            pair = layers.get(i)
            if pair is None or pair[0] is None or pair[1] is None:
                raise ValueError(f"adapter {adapter_dir}: target {target} "
                                 f"missing layer {i} A/B pair")
            a, b = pair
            a_l.append(a.T)                    # [din, r]
            b_l.append(b.T * scale)            # [r, dout] (alpha/r folded)
        out[target] = (np.stack(a_l), np.stack(b_l))
    if not out:
        raise ValueError(f"adapter {adapter_dir} has no LoRA tensors")
    return {"r": r, "targets": out}


def stack_adapters(adapters: List[dict], num_layers: int) -> dict:
    """Stack N loaded adapters (+ the zero base adapter at index 0):
    {target: {"lora_A": [L, N+1, din, r_max], "lora_B": [L, N+1, r_max,
    dout]}} float32 numpy. Ranks pad with zeros (a zero-padded rank
    contributes nothing)."""
    targets = sorted({t for ad in adapters for t in ad["targets"]})
    r_max = max(ad["r"] for ad in adapters)
    out = {}
    for t in targets:
        dims = next(ad["targets"][t] for ad in adapters if t in ad["targets"])
        din, dout = dims[0].shape[1], dims[1].shape[2]
        A = np.zeros((num_layers, len(adapters) + 1, din, r_max), np.float32)
        B = np.zeros((num_layers, len(adapters) + 1, r_max, dout), np.float32)
        for n, ad in enumerate(adapters):
            if t not in ad["targets"]:
                continue
            a, b = ad["targets"][t]
            if a.shape[0] != num_layers:
                raise ValueError(
                    f"adapter layer count {a.shape[0]} != model "
                    f"{num_layers} for target {t}")
            A[:, n + 1, :, :ad["r"]] = a
            B[:, n + 1, :ad["r"], :] = b
        out[t] = {"lora_A": A, "lora_B": B}
    return out


def attach(params: dict, stacked: dict, dtype: torch.dtype) -> dict:
    """Return params with the adapters laid out for the forward pass (a new
    tree; the base leaves are shared): ``params["lora"]["cols"]`` [N * r]
    int32, the adapter index (1..N) of each rank column, and per group of
    :data:`GROUPS` that some adapter targets a layer leaf ``{"A": [L, din,
    k * N * r], "B": [L, k * N * r, dout_group]}`` in ``dtype`` on the
    params' device, k the group's targeted members. A group's B places
    member j's rows in its own output columns; a member no adapter
    targets has no rows and zero columns."""
    layers = dict(params["layers"])
    for target in stacked:
        if target not in layers:
            raise ValueError(f"model has no target {target!r} "
                             f"(MoE experts are not LoRA-targetable)")
        if layers[target]["kernel"].ndim != 3:
            raise ValueError(f"target {target!r} is not a dense [L, din, "
                             f"dout] projection (MoE expert stacks are not "
                             f"LoRA-targetable)")
    dev = params["layers"]["wq"]["kernel"].device
    first = next(iter(stacked.values()))
    L, n1, _, r = first["lora_A"].shape
    n = n1 - 1

    def cat(a: np.ndarray, axis_r: int) -> np.ndarray:
        # [L, N+1, din, r] -> [L, din, N*r]  or  [L, N+1, r, dout] -> [L,
        # N*r, dout]: adapter-major columns, the base (index 0) dropped
        a = a[:, 1:]
        if axis_r == 3:
            return a.transpose(0, 2, 1, 3).reshape(L, a.shape[2], n * r)
        return a.reshape(L, n * r, a.shape[3])

    for group, members in GROUPS:
        members = tuple(t for t in members if t in layers)
        present = [t for t in members if t in stacked]
        if not present:
            continue
        douts = [layers[t]["kernel"].shape[2] for t in members]
        A = np.concatenate([cat(stacked[t]["lora_A"], 3) for t in present],
                           axis=2)
        B = np.zeros((L, len(present) * n * r, sum(douts)), np.float32)
        for j, t in enumerate(present):
            c0 = sum(douts[:members.index(t)])
            B[:, j * n * r:(j + 1) * n * r, c0:c0 + douts[members.index(t)]] \
                = cat(stacked[t]["lora_B"], 2)
        layers[group] = {"A": torch.from_numpy(A).to(dev, dtype),
                         "B": torch.from_numpy(B).to(dev, dtype)}
    out = dict(params)
    out["layers"] = layers
    out["lora"] = {"cols": torch.from_numpy(
        (np.arange(n * r) // r + 1).astype(np.int32)).to(dev)}
    return out


def load_attached(params: dict, adapters: List[Tuple[str, str]],
                  num_layers: int, dtype: torch.dtype) -> dict:
    """``params`` with the adapters of ``[(name, dir), ...]`` attached in
    that order (index i + 1 serves adapter i)."""
    loaded = [load_adapter(path) for _, path in adapters]
    return attach(params, stack_adapters(loaded, num_layers), dtype)
