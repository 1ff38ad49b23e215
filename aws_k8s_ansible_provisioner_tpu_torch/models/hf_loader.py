"""HuggingFace checkpoint directory -> the port's parameter tree.

The port's counterpart of the JAX package's ``models/hf_loader.py``: a
local directory of ``config.json`` and ``*.safetensors`` shards (the deploy
layer's model PVC, ``/models/<model>``) becomes the parameter tree of
``models/layers.py``: ``[in, out]`` projection kernels, per-layer weights
stacked on a leading ``[num_layers]`` axis, every leaf in one dtype. That is
the layout ``models/convert.from_jax_params`` shares with JAX, so a tree
loaded here equals, leaf for leaf, the JAX loader's tree of the same
directory.

The safetensors format is read here (:func:`read_safetensors`): an 8-byte
little-endian header length, a JSON header (``dtype``, ``shape`` and
``data_offsets`` of each tensor, plus ``__metadata__``), then the raw bytes.
Each file is mapped copy-on-write and every tensor is a view into the
mapping, so reading a shard costs no host memory beyond the page cache;
nothing here needs the ``safetensors`` package.

:func:`convert_state_dict` is the JAX key map, every family included
(gated Qwen3/Llama/Mistral/Gemma, phi's parallel block, OPT with either key
prefix, qwen3_moe's stacked experts). Each stacked leaf is allocated once in the target dtype on the
target device and filled one layer at a time (the layer's matrix copied to
the device in its stored dtype, transposed there, cast into its row of the
leaf), so the peak is the finished tree plus one layer's matrix; with
``quantize`` (an int8 target) each kernel, the embedding and an untied
head is quantized (``models/quant.py``) as its layer's matrix arrives, so
the peak is the int8 tree plus one layer's matrix (Qwen3-30B-A3B: its bf16
tree, 61 GB, is never held); the JAX
loader's float32 intermediates would hold Mistral-7B's ~29 GB on the host.

Not ported: ``download_snapshot`` (it needs the network and
``huggingface_hub``; the deploy layer's download Job runs the JAX one).
"""

from __future__ import annotations

import json
import math
import os
import struct
from typing import Dict, Optional

import torch

from aws_k8s_ansible_provisioner_tpu_torch.config import ModelConfig
from aws_k8s_ansible_provisioner_tpu_torch.device import resolve_device

# safetensors dtype tag -> torch dtype
SAFETENSORS_DTYPES = {
    "BF16": torch.bfloat16,
    "F16": torch.float16,
    "F32": torch.float32,
    "I8": torch.int8,
    "I32": torch.int32,
    "I64": torch.int64,
    "BOOL": torch.bool,
}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one safetensors file, as CPU tensors of its stored
    dtype viewing a copy-on-write mapping of the file (a tensor whose byte
    offset is not a multiple of its element size is copied instead). An
    unknown dtype, a header or tensor that runs past the end of the file,
    a size that disagrees with the shape, or two tensors whose bytes
    overlap raise ValueError naming the file and the tensor."""
    size = os.path.getsize(path)
    with open(path, "rb") as fh:
        head = fh.read(8)
        if len(head) < 8:
            raise ValueError(f"{path}: truncated safetensors file (no "
                             f"header length)")
        n = struct.unpack("<Q", head)[0]
        if 8 + n > size:
            raise ValueError(f"{path}: truncated safetensors file (header "
                             f"of {n} bytes, file of {size})")
        try:
            header = json.loads(fh.read(n))
        except ValueError as e:
            raise ValueError(f"{path}: unreadable safetensors header "
                             f"({e})") from None
    base = 8 + n
    entries = []
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dtype = SAFETENSORS_DTYPES.get(meta.get("dtype"))
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype "
                             f"{meta.get('dtype')!r}, not one of "
                             f"{sorted(SAFETENSORS_DTYPES)}")
        shape = tuple(int(d) for d in meta["shape"])
        begin, end = (int(x) for x in meta["data_offsets"])
        nbytes = math.prod(shape) * dtype.itemsize
        if not 0 <= begin <= end or end - begin != nbytes:
            raise ValueError(f"{path}: tensor {name!r} spans bytes "
                             f"[{begin}, {end}), its shape {shape} and "
                             f"dtype need {nbytes}")
        if base + end > size:
            raise ValueError(f"{path}: truncated safetensors file (tensor "
                             f"{name!r} ends at byte {base + end}, the file "
                             f"at {size})")
        entries.append((begin, end, name, dtype, shape))
    entries.sort(key=lambda e: (e[0], e[1]))
    for prev, cur in zip(entries, entries[1:]):
        if cur[0] < prev[1]:
            raise ValueError(f"{path}: tensors {prev[2]!r} and {cur[2]!r} "
                             f"overlap (bytes [{prev[0]}, {prev[1]}) and "
                             f"[{cur[0]}, {cur[1]}))")
    # (filename, shared, size): private, copy-on-write
    storage = torch.UntypedStorage.from_file(path, False, size)
    out: Dict[str, torch.Tensor] = {}
    for begin, end, name, dtype, shape in entries:
        offset = base + begin
        if offset % dtype.itemsize == 0:
            t = torch.empty(0, dtype=dtype).set_(
                storage, offset // dtype.itemsize, shape)
        else:
            raw = torch.empty(0, dtype=torch.uint8).set_(
                storage, offset, (end - begin,))
            t = raw.clone().view(dtype).reshape(shape)
        out[name] = t
    return out


def _get(tensors: dict, key: str, shape: Optional[tuple] = None
         ) -> torch.Tensor:
    if key not in tensors:
        raise KeyError(f"missing weight {key!r}; have e.g. "
                       f"{sorted(tensors)[:8]} ...")
    t = tensors[key].detach()
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"weight {key!r}: shape {tuple(t.shape)} != "
                         f"{tuple(shape)}")
    return t


def convert_state_dict(cfg: ModelConfig, tensors: dict,
                       dtype: torch.dtype = torch.bfloat16,
                       device=None, quantize: bool = False,
                       place=None) -> dict:
    """A flat HF state dict (torch tensors) -> the port's parameter tree in
    ``dtype`` on ``device``, the card unless the caller names another (the
    JAX ``convert_state_dict``'s tree, leaf for leaf). A missing key raises
    KeyError, a weight of the wrong shape ValueError. ``quantize``: the
    tree of ``quantize_params`` (bit for bit), each matrix quantized as it
    is converted. ``place(path, leaf)`` (the JAX loader's ``device_put``,
    e.g. ``parallel/sharding.make_sharded_put``): each leaf, once
    converted (and quantized), is handed to it with its keys in the tree
    and replaced by what it returns, before the next leaf is converted;
    ``device`` is then the staging device, the host unless named."""
    from aws_k8s_ansible_provisioner_tpu_torch.models.quant import \
        quant_kernel_chunked

    device = resolve_device(device if place is None else device or "cpu")

    def placed(path: tuple, node: dict) -> dict:
        """``node``'s leaves through ``place`` (itself without one)."""
        if place is None:
            return node
        return {k: placed(path + (k,), v) if isinstance(v, dict)
                else place(path + (k,), v) for k, v in node.items()}
    L, H = cfg.num_layers, cfg.hidden_size
    Q, KV, I = cfg.q_size, cfg.kv_size, cfg.intermediate_size

    opt = cfg.pos_embed == "learned"
    if opt:
        # Hub facebook/opt-* safetensors carry bare "decoder.*" keys
        # (exported from the base OPTModel), OPTForCausalLM.state_dict()
        # "model.decoder.*": both load
        if ("model.decoder.embed_tokens.weight" not in tensors
                and "decoder.embed_tokens.weight" in tensors):
            tensors = {("model." + k if k.startswith("decoder.") else k): v
                       for k, v in tensors.items()}
        layer_pre = "model.decoder.layers.{i}."
        pre = layer_pre + "self_attn."
        o_name, up_name, down_name = "out_proj", "fc1", "fc2"
        input_norm = layer_pre + "self_attn_layer_norm"
        post_norm = layer_pre + "final_layer_norm"
        final_norm = "model.decoder.final_layer_norm"
        embed_key = "model.decoder.embed_tokens.weight"
    elif cfg.parallel_block:
        layer_pre = "model.layers.{i}."
        pre = layer_pre + "self_attn."
        o_name, up_name, down_name = "dense", "mlp.fc1", "mlp.fc2"
        input_norm = layer_pre + "input_layernorm"
        post_norm = layer_pre + "post_attention_layernorm"
        final_norm = "model.final_layernorm"
        embed_key = "model.embed_tokens.weight"
    else:
        layer_pre = "model.layers.{i}."
        pre = layer_pre + "self_attn."
        o_name, up_name, down_name = "o_proj", "mlp.up_proj", "mlp.down_proj"
        input_norm = layer_pre + "input_layernorm"
        post_norm = layer_pre + "post_attention_layernorm"
        final_norm = "model.norm"
        embed_key = "model.embed_tokens.weight"

    def leaf(key: str, shape: tuple, transpose: bool = False
             ) -> torch.Tensor:
        """One unstacked weight, in ``dtype`` on ``device``."""
        w = _get(tensors, key, shape[::-1] if transpose else shape)
        w = w.to(device)
        # a fresh tensor: never a view of the mapped file
        return torch.empty(shape, dtype=dtype, device=device).copy_(
            w.t() if transpose else w)

    def stacked(layer_fn, shape: tuple) -> torch.Tensor:
        """``layer_fn(i)`` into row i of one preallocated [L, *shape] leaf
        in ``dtype``."""
        out = torch.empty((L,) + shape, dtype=dtype, device=device)
        for i in range(L):
            out[i].copy_(layer_fn(i))
        return out

    def layer_matrix(fmt, i, shape, transpose):
        """Layer i's weight ``fmt.format(i=i)`` (``shape`` after the
        transpose), on ``device`` in its stored dtype."""
        w = _get(tensors, fmt.format(i=i),
                 shape[::-1] if transpose else shape).to(device)
        return w.t() if transpose else w

    def stack(fmt: str, shape: tuple, transpose: bool) -> torch.Tensor:
        return stacked(lambda i: layer_matrix(fmt, i, shape, transpose),
                       shape)

    def kernel(layer_fn, shape: tuple, in_axis: int) -> dict:
        """{"kernel"} [L, *shape] from ``layer_fn(i)`` (layer i's matrix);
        with ``quantize`` int8 beside its scales, each layer cast to
        ``dtype`` and quantized over ``in_axis`` of ``shape`` as it
        arrives."""
        if not quantize:
            return {"kernel": stacked(layer_fn, shape)}
        q = torch.empty((L,) + shape, dtype=torch.int8, device=device)
        s = torch.empty((L,) + shape[:in_axis] + shape[in_axis + 1:],
                        dtype=torch.float32, device=device)
        for i in range(L):
            w = torch.empty(shape, dtype=dtype, device=device)
            w.copy_(layer_fn(i))
            q[i], s[i] = quant_kernel_chunked(w, in_axis)
        return {"kernel": q, "scale": s}

    def quantized(p: dict, key: str, in_axis: int) -> dict:
        if quantize:
            p[key], p["scale"] = quant_kernel_chunked(p[key], in_axis)
        return p

    def dense(hf_fmt: str, d_in: int, d_out: int, bias: bool) -> dict:
        fmt = hf_fmt + ".weight"
        p = kernel(lambda i: layer_matrix(fmt, i, (d_in, d_out), True),
                   (d_in, d_out), 0)
        if bias:
            p["bias"] = stack(hf_fmt + ".bias", (d_out,), False)
        return p

    def norm(hf_fmt: str) -> dict:
        p = {"weight": stack(hf_fmt + ".weight", (H,), False)}
        if cfg.norm == "layernorm":
            p["bias"] = stack(hf_fmt + ".bias", (H,), False)
        return p

    def stack_experts(proj: str, d_in: int, d_out: int) -> dict:
        """HF per-expert Linears into one [L, E, in, out] kernel leaf,
        expert by expert (the JAX loader's order and rounding)."""
        E = cfg.num_experts

        def layer(i):
            out = torch.empty((E, d_in, d_out), dtype=dtype, device=device)
            for e in range(E):
                w = _get(tensors, layer_pre.format(i=i)
                         + f"mlp.experts.{e}.{proj}.weight",
                         (d_out, d_in)).to(device)
                out[e].copy_(w.t())
            return out

        return kernel(layer, (E, d_in, d_out), 1)

    ab, mb = cfg.attention_bias, cfg.mlp_bias
    layers: dict = {}

    def add(name: str, make) -> None:
        layers[name] = placed(("layers", name), make())

    add("input_norm", lambda: norm(input_norm))
    add("wq", lambda: dense(pre + "q_proj", H, Q, ab))
    add("wk", lambda: dense(pre + "k_proj", H, KV, ab))
    add("wv", lambda: dense(pre + "v_proj", H, KV, ab))
    add("wo", lambda: dense(pre + o_name, Q, H, ab))
    if cfg.num_experts > 0:
        # Qwen3-MoE: router = mlp.gate [E, H] -> [H, E]; experts stacked
        M = cfg.moe_intermediate_size
        add("router", lambda: {"kernel": stack(
            layer_pre + "mlp.gate.weight", (H, cfg.num_experts), True)})
        add("w_gate", lambda: stack_experts("gate_proj", H, M))
        add("w_up", lambda: stack_experts("up_proj", H, M))
        add("w_down", lambda: stack_experts("down_proj", M, H))
    elif cfg.act in ("silu", "gelu_tanh"):
        # SwiGLU (Qwen/Llama/Mistral) and GeGLU (Gemma): the same HF names
        add("w_gate", lambda: dense(layer_pre + "mlp.gate_proj", H, I, mb))
        add("w_up", lambda: dense(layer_pre + "mlp.up_proj", H, I, mb))
        add("w_down", lambda: dense(layer_pre + down_name, I, H, mb))
    else:
        add("w_up", lambda: dense(layer_pre + up_name, H, I, mb))
        add("w_down", lambda: dense(layer_pre + down_name, I, H, mb))
    if cfg.qk_norm:
        add("q_norm", lambda: {"weight": stack(pre + "q_norm.weight",
                                               (cfg.head_dim,), False)})
        add("k_norm", lambda: {"weight": stack(pre + "k_norm.weight",
                                               (cfg.head_dim,), False)})
    if not cfg.parallel_block:
        add("post_norm", lambda: norm(post_norm))

    params: dict = {
        "embed": placed(("embed",), quantized(
            {"weight": leaf(embed_key, (cfg.vocab_size, H))}, "weight", 1)),
        "layers": layers,
    }
    final = {"weight": leaf(final_norm + ".weight", (H,))}
    if cfg.norm == "layernorm":
        final["bias"] = leaf(final_norm + ".bias", (H,))
    params["final_norm"] = placed(("final_norm",), final)
    if opt:
        key = "model.decoder.embed_positions.weight"
        params["pos_embed"] = placed(("pos_embed",), {"weight": leaf(
            key, tuple(_get(tensors, key).shape))})
    if not cfg.tie_embeddings:
        head = quantized(
            {"kernel": leaf("lm_head.weight", (H, cfg.vocab_size), True)},
            "kernel", 0)
        if "lm_head.bias" in tensors:
            head["bias"] = leaf("lm_head.bias", (cfg.vocab_size,))
        params["lm_head"] = placed(("lm_head",), head)
    return params


def load_checkpoint(checkpoint_dir: str, cfg: ModelConfig,
                    dtype: torch.dtype = torch.bfloat16,
                    device=None, quantize: bool = False,
                    place=None) -> dict:
    """Every ``*.safetensors`` shard of a HF checkpoint directory, read in
    sorted order (a later shard's key wins, as in the JAX loader) and
    converted onto ``device`` (the card unless the caller names another),
    quantized as it converts with ``quantize``, each leaf handed to
    ``place`` as it is produced (:func:`convert_state_dict`; the JAX
    ``load_checkpoint(device_put=...)``). Raises FileNotFoundError for a
    directory without a ``.safetensors`` file."""
    files = sorted(f for f in os.listdir(checkpoint_dir)
                   if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files in {checkpoint_dir}")
    tensors: Dict[str, torch.Tensor] = {}
    for f in files:
        tensors.update(read_safetensors(os.path.join(checkpoint_dir, f)))
    return convert_state_dict(cfg, tensors, dtype, device, quantize, place)


def config_from_hf_dir(checkpoint_dir: str) -> ModelConfig:
    """A ModelConfig from a checkpoint's ``config.json``: the registry's
    entry when ``_name_or_path`` (else the directory's name) names one
    exactly, else built from the file by ``model_type`` (the JAX
    ``config_from_hf_dir``, branch for branch)."""
    from aws_k8s_ansible_provisioner_tpu_torch.config import MODEL_REGISTRY

    with open(os.path.join(checkpoint_dir, "config.json")) as fh:
        hf = json.load(fh)
    name = hf.get("_name_or_path") or os.path.basename(
        checkpoint_dir.rstrip("/"))
    # exact registry match only: fuzzy matching could bind e.g. a 'qwen3'
    # directory of 8B weights to the 0.6B entry
    if name in MODEL_REGISTRY:
        return MODEL_REGISTRY[name]
    model_type = hf.get("model_type", "")
    if model_type == "qwen3_moe":
        if hf.get("mlp_only_layers") or hf.get("decoder_sparse_step", 1) != 1:
            raise ValueError("qwen3_moe variants with dense layers mixed in "
                             "(mlp_only_layers/decoder_sparse_step) are not "
                             "supported")
        return ModelConfig(
            name=name,
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"],
            num_layers=hf["num_hidden_layers"],
            num_heads=hf["num_attention_heads"],
            num_kv_heads=hf["num_key_value_heads"],
            head_dim=hf.get("head_dim",
                            hf["hidden_size"] // hf["num_attention_heads"]),
            max_seq_len=hf.get("max_position_embeddings", 4096),
            rope_theta=hf.get("rope_theta", 1e6),
            qk_norm=True,
            norm_eps=hf.get("rms_norm_eps", 1e-6),
            tie_embeddings=hf.get("tie_word_embeddings", False),
            eos_token_id=(hf.get("eos_token_id") or 0),
            num_experts=hf["num_experts"],
            num_experts_per_tok=hf["num_experts_per_tok"],
            moe_intermediate_size=hf["moe_intermediate_size"],
            norm_topk_prob=hf.get("norm_topk_prob", True),
            hf_repo=name,
        )
    if model_type == "qwen3":
        return ModelConfig(
            name=name,
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"],
            num_layers=hf["num_hidden_layers"],
            num_heads=hf["num_attention_heads"],
            num_kv_heads=hf["num_key_value_heads"],
            head_dim=hf.get("head_dim",
                            hf["hidden_size"] // hf["num_attention_heads"]),
            max_seq_len=hf.get("max_position_embeddings", 4096),
            rope_theta=hf.get("rope_theta", 1e6),
            qk_norm=True,
            norm_eps=hf.get("rms_norm_eps", 1e-6),
            tie_embeddings=hf.get("tie_word_embeddings", False),
            eos_token_id=(hf.get("eos_token_id") or 0),
            hf_repo=name,
        )
    if model_type == "llama":
        rs = hf.get("rope_scaling") or {}
        rs_type = rs.get("rope_type") or rs.get("type") or "none"
        if rs_type not in ("none", "llama3", "default"):
            raise ValueError(f"unsupported llama rope_scaling type "
                             f"{rs_type!r}")
        eos = hf.get("eos_token_id") or 0
        eos_list = eos if isinstance(eos, list) else [eos]
        return ModelConfig(
            name=name,
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"],
            num_layers=hf["num_hidden_layers"],
            num_heads=hf["num_attention_heads"],
            num_kv_heads=hf.get("num_key_value_heads")
            or hf["num_attention_heads"],
            head_dim=hf.get("head_dim") or
            hf["hidden_size"] // hf["num_attention_heads"],
            max_seq_len=hf.get("max_position_embeddings", 4096),
            rope_theta=hf.get("rope_theta", 10000.0),
            rope_scaling="llama3" if rs_type == "llama3" else "none",
            rope_factor=float(rs.get("factor", 1.0)),
            rope_low_freq_factor=float(rs.get("low_freq_factor", 1.0)),
            rope_high_freq_factor=float(rs.get("high_freq_factor", 4.0)),
            rope_original_max_pos=int(
                rs.get("original_max_position_embeddings", 8192)),
            norm_eps=hf.get("rms_norm_eps", 1e-5),
            attention_bias=hf.get("attention_bias", False),
            mlp_bias=hf.get("mlp_bias", False),
            tie_embeddings=hf.get("tie_word_embeddings", False),
            bos_token_id=hf.get("bos_token_id"),
            # Llama-3 Instruct declares a list of eos ids; generation stops
            # on any of them (chat turns end with <|eot_id|>, not the first)
            eos_token_id=eos_list[0],
            extra_eos_token_ids=tuple(eos_list[1:]),
            hf_repo=name,
        )
    if model_type == "mistral":
        eos = hf.get("eos_token_id") or 2
        eos_list = eos if isinstance(eos, list) else [eos]
        return ModelConfig(
            name=name,
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"],
            num_layers=hf["num_hidden_layers"],
            num_heads=hf["num_attention_heads"],
            num_kv_heads=hf.get("num_key_value_heads", 8),
            head_dim=hf.get("head_dim") or
            hf["hidden_size"] // hf["num_attention_heads"],
            max_seq_len=hf.get("max_position_embeddings", 32768),
            # v0.1 checkpoints declare 4096; v0.3+ null (full attention)
            sliding_window=int(hf.get("sliding_window") or 0),
            rope_theta=hf.get("rope_theta", 10000.0),
            norm_eps=hf.get("rms_norm_eps", 1e-5),
            tie_embeddings=hf.get("tie_word_embeddings", False),
            bos_token_id=hf.get("bos_token_id", 1),
            eos_token_id=eos_list[0],
            extra_eos_token_ids=tuple(eos_list[1:]),
            hf_repo=name,
        )
    if model_type == "gemma":
        return ModelConfig(
            name=name,
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"],
            num_layers=hf["num_hidden_layers"],
            num_heads=hf["num_attention_heads"],
            num_kv_heads=hf.get("num_key_value_heads", 1),
            head_dim=hf.get("head_dim",
                            hf["hidden_size"] // hf["num_attention_heads"]),
            max_seq_len=hf.get("max_position_embeddings", 8192),
            rope_theta=hf.get("rope_theta", 10000.0),
            norm_eps=hf.get("rms_norm_eps", 1e-6),
            norm_zero_centered=True,
            embed_scale=True,
            act="gelu_tanh",
            tie_embeddings=hf.get("tie_word_embeddings", True),
            bos_token_id=hf.get("bos_token_id", 2),
            eos_token_id=(hf.get("eos_token_id") or 1),
            hf_repo=name,
        )
    if model_type == "phi":
        head_dim = hf["hidden_size"] // hf["num_attention_heads"]
        return ModelConfig(
            name=name,
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"],
            num_layers=hf["num_hidden_layers"],
            num_heads=hf["num_attention_heads"],
            num_kv_heads=hf.get("num_key_value_heads")
            or hf["num_attention_heads"],
            head_dim=head_dim,
            max_seq_len=hf.get("max_position_embeddings", 2048),
            rope_theta=hf.get("rope_theta", 10000.0),
            rotary_pct=hf.get("partial_rotary_factor", 0.4),
            norm="layernorm",
            norm_eps=hf.get("layer_norm_eps", 1e-5),
            act="gelu_new",
            attention_bias=True,
            mlp_bias=True,
            parallel_block=True,
            eos_token_id=(hf.get("eos_token_id") or 0),
            hf_repo=name,
        )
    if model_type == "opt":
        if hf.get("word_embed_proj_dim", hf["hidden_size"]) != \
                hf["hidden_size"]:
            raise ValueError("OPT variants with embed projection (350m) are "
                             "not supported")
        if not hf.get("do_layer_norm_before", True):
            raise ValueError("post-norm OPT variants are not supported")
        head_dim = hf["hidden_size"] // hf["num_attention_heads"]
        return ModelConfig(
            name=name,
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            intermediate_size=hf["ffn_dim"],
            num_layers=hf["num_hidden_layers"],
            num_heads=hf["num_attention_heads"],
            num_kv_heads=hf["num_attention_heads"],
            head_dim=head_dim,
            max_seq_len=hf.get("max_position_embeddings", 2048),
            norm="layernorm",
            norm_eps=1e-5,
            act="relu",
            pos_embed="learned",
            attention_bias=True,
            mlp_bias=True,
            tie_embeddings=hf.get("tie_word_embeddings", True),
            bos_token_id=hf.get("bos_token_id", 2),
            eos_token_id=(hf.get("eos_token_id") or 2),
            hf_repo=name,
        )
    raise ValueError(f"unsupported model_type {model_type!r} in "
                     f"{checkpoint_dir}")
