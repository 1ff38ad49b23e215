"""Decoder-only transformer (Qwen3, Qwen3-MoE, Mistral, Llama, Gemma, Phi
and OPT families) in PyTorch.

The same functions as the JAX package's ``models/layers.py``, written over
torch tensors, with its parameter layout kept unchanged so that a converted
JAX parameter tree runs here as it is (``models/convert.py``):

- per-layer weights are stacked with a leading ``[num_layers]`` axis;
- projection kernels are ``[in, out]`` (``x @ W``), i.e. transposed from
  ``nn.Linear``;
- a weights-only int8 projection is ``{"kernel": int8, "scale": f32}``
  (``models/quant.py``), dequantized to the activation dtype before the
  matmul with the per-out-channel scale folded in after it.

A MoE config's MLP is ``ops/moe.moe_mlp`` over the block's tokens
flattened to ``[B * T, H]`` (the router ``[L, H, E]`` and the stacked
experts ``[L, E, H, I]`` / ``[L, E, I, H]``).

Norms (RMSNorm, optionally zero-centred; LayerNorm with its bias) and
softmax accumulate in float32. RoPE rotates the first ``cfg.rotary_dim``
columns of a head (all of them, Phi-2's 32 of 80, or none with OPT's
learned positions), with the llama3 frequency scaling where the config
asks for it. ``model_forward`` takes an
``attend`` callback so that the same block stack serves causal prefill,
decode against the paged pool and the ragged mixed dispatch; with the carry
form (``model_forward_carry``) the callback receives ``(pool, layer)`` and
updates the pool in place. A callback whose ``fuses_qk_prep`` attribute is
true takes the raw q and k rows and a :class:`QKPrep` as a fifth argument
and applies the q/k RMSNorm and RoPE itself (the row-write callbacks,
whose row-write kernel does it in the same launch); every other callback
receives q and k after :func:`prep_qk_plain`.

With LoRA adapters attached (``models/lora.attach``: a ``lora`` leaf and
per-layer groups of concatenated factors), the forward takes the rows'
adapters (:class:`LoraRows`, built by ``DecoderLM.lora_rows`` from their
indices) and adds each projection's delta before its bias; without them
no LoRA operation runs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from aws_k8s_ansible_provisioner_tpu_torch.config import ModelConfig
from aws_k8s_ansible_provisioner_tpu_torch.models.quant import \
    quant_kernel_chunked
from aws_k8s_ansible_provisioner_tpu_torch.ops.moe import moe_mlp

# attend(q [B,T,Hq,D], k [B,T,Hkv,D], v [B,T,Hkv,D], cache_l)
#   -> (context [B,T,Hq,D], cache_l); q/k are already qk-normed and RoPE'd,
# unless the callback's ``fuses_qk_prep`` is true: it then takes the raw
# q/k and a QKPrep as a fifth argument.
AttendFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, Any],
                    Tuple[torch.Tensor, Any]]


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
             zero_centered: bool = False) -> torch.Tensor:
    """RMSNorm with float32 accumulation (HF Qwen3 semantics);
    ``zero_centered`` applies the weight as ``1 + w`` (Gemma)."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    w = weight.float()
    if zero_centered:
        w = 1.0 + w
    return (x * w).to(dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm with its bias, float32 accumulation (Phi, OPT)."""
    dtype = x.dtype
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    x = (x - mean) * torch.rsqrt(var + eps)
    return (x * weight.float() + bias.float()).to(dtype)


def apply_norm(cfg: ModelConfig, x: torch.Tensor, p: dict) -> torch.Tensor:
    """The config's norm with the leaf ``p`` (``weight``, and ``bias`` for
    LayerNorm)."""
    if cfg.norm == "rmsnorm":
        return rms_norm(x, p["weight"], cfg.norm_eps,
                        zero_centered=cfg.norm_zero_centered)
    return layer_norm(x, p["weight"], p["bias"], cfg.norm_eps)


def _llama3_scale_inv_freq(inv_freq: torch.Tensor, cfg: ModelConfig
                           ) -> torch.Tensor:
    """The llama3 frequency scaling (HF ``rope_type: llama3``): short
    wavelengths pass, long ones are divided by ``rope_factor``, a band
    between the two corner wavelengths interpolates; float32 as the JAX
    package computes it."""
    low_wavelen = cfg.rope_original_max_pos / cfg.rope_low_freq_factor
    high_wavelen = cfg.rope_original_max_pos / cfg.rope_high_freq_factor
    wavelen = 2.0 * math.pi / inv_freq
    scaled = inv_freq / cfg.rope_factor
    smooth = (cfg.rope_original_max_pos / wavelen - cfg.rope_low_freq_factor) \
        / (cfg.rope_high_freq_factor - cfg.rope_low_freq_factor)
    smoothed = (1.0 - smooth) * scaled + smooth * inv_freq
    out = torch.where(wavelen > low_wavelen, scaled, inv_freq)
    mid = (wavelen <= low_wavelen) & (wavelen >= high_wavelen)
    return torch.where(mid, smoothed, out)


def rope_cos_sin(positions: torch.Tensor, rotary_dim: int, theta: float,
                 cfg: Optional[ModelConfig] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 cos/sin tables for integer positions [..., T] (HF rotate_half
    convention): returns [..., T, rotary_dim] each; ``cfg`` with
    ``rope_scaling == "llama3"`` scales the frequencies."""
    exponent = torch.arange(0, rotary_dim, 2, dtype=torch.float32,
                            device=positions.device) / rotary_dim
    inv_freq = 1.0 / (theta ** exponent)
    if cfg is not None and cfg.rope_scaling == "llama3":
        inv_freq = _llama3_scale_inv_freq(inv_freq, cfg)
    freqs = positions[..., None].float() * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """RoPE over the first r columns of each head, r the tables' width (all
    of D, part of it, or 0: x as it is); the other columns pass through.
    x: [B, T, H, D]; cos/sin: [B, T, r] (or any leading shape, one table
    row per row of heads)."""
    r = cos.shape[-1]
    if r == 0:
        return x
    dtype = x.dtype
    rot = x[..., :r].float()
    cos, sin = cos[..., None, :], sin[..., None, :]
    rot = (rot * cos + _rotate_half(rot) * sin).to(dtype)
    if r == x.shape[-1]:
        return rot
    return torch.cat([rot, x[..., r:]], dim=-1)


@dataclasses.dataclass(frozen=True)
class QKPrep:
    """What turns a layer's raw q/k rows into the rows that attend: the
    per-head RMSNorm weights [D] (None without ``cfg.qk_norm``), its eps,
    and the float32 RoPE tables ``cos``/``sin`` of the rows' positions
    ([B, T, r] as ``_embed_inputs`` builds them, r the rotary width; a
    fused callback hands its kernel the same tables flattened to one row
    per packed row). RoPE rotates the first :attr:`rotary_dim` columns of
    a head; 0 (OPT's zero-width tables) means no RoPE."""
    q_norm: Optional[torch.Tensor]
    k_norm: Optional[torch.Tensor]
    eps: float
    cos: torch.Tensor
    sin: torch.Tensor

    @property
    def rotary_dim(self) -> int:
        return self.cos.shape[-1]


def prep_qk_plain(q: torch.Tensor, k: torch.Tensor, prep: QKPrep
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The q/k prologue of every block: RMSNorm of each head (when the
    prep carries weights), then RoPE over the first ``prep.rotary_dim``
    columns (none at 0); each rounds to the rows' dtype. q [..., Hq, D]
    and k [..., Hkv, D] over tables [..., r]."""
    if prep.q_norm is not None:
        q = rms_norm(q, prep.q_norm, prep.eps)
        k = rms_norm(k, prep.k_norm, prep.eps)
    return (apply_rope(q, prep.cos, prep.sin),
            apply_rope(k, prep.cos, prep.sin))


def repeat_kv(k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, T, Hkv, D] -> [B, T, Hq, D] by repeating each kv head."""
    num_kv = k.shape[-2]
    if num_kv == num_heads:
        return k
    return torch.repeat_interleave(k, num_heads // num_kv, dim=-2)


def causal_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  seq_lens: Optional[torch.Tensor] = None,
                  window: int = 0) -> torch.Tensor:
    """Full causal self-attention over the current window, float32 softmax.

    q: [B, T, Hq, D]; k/v: [B, T, Hkv, D]; ``seq_lens`` [B] masks right
    padding; ``window`` > 0 restricts each query to its last ``window`` keys
    (sliding-window attention). Masked logits are -1e30, as in the JAX
    reference.
    """
    B, T, Hq, D = q.shape
    k = repeat_kv(k, Hq).float()
    v = repeat_kv(v, Hq).float()
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) / math.sqrt(D)
    pos = torch.arange(T, device=q.device)
    mask = pos[None, :] <= pos[:, None]                      # [Tq, Tk]
    if window > 0:
        mask = mask & (pos[None, :] > pos[:, None] - window)
    if seq_lens is not None:
        valid = pos[None, :] < seq_lens[:, None]             # [B, Tk]
        mask = (mask[None] & valid[:, None, :])[:, None]     # [B,1,Tq,Tk]
    else:
        mask = mask[None, None]
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v).to(q.dtype)


def _product(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """x @ kernel in x's dtype (an int8 kernel dequantized to it, its scale
    not yet applied): the whole product, or a row-parallel shard's partial
    sum."""
    if "scale" in p:
        return x @ p["kernel"].to(x.dtype)
    return x @ p["kernel"]


def _epilogue(y: torch.Tensor, p: Dict[str, torch.Tensor],
              delta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """After the product (for a row-parallel kernel, after the sum of its
    shards' partials): the per-out-channel float32 int8 scale (exact to
    fold in here: the scale is constant along the contraction axis), a
    LoRA ``delta`` of the output's shape (in the JAX order: before the
    bias), the bias."""
    if "scale" in p:
        y = (y * p["scale"]).to(y.dtype)
    if delta is not None:
        y = y + delta.to(y.dtype)
    if "bias" in p:
        y = y + p["bias"]
    return y


def _linear(x: torch.Tensor, p: Dict[str, torch.Tensor],
            delta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ kernel, plus a LoRA ``delta`` of the output's shape (in the JAX
    order: before the bias), plus the bias; weights-only int8 is
    dequantized to the activation dtype before the matmul, its scale folded
    in after."""
    return _epilogue(_product(x, p), p, delta)


class LoraRows:
    """The rows' adapters of one forward pass (``models/lora.py``): from
    the adapter indices ``idx`` (0 = base; [B] one per row of x [B, T, H],
    or [B, T] one per token, the packed layout of the mixed dispatch) and
    ``cols`` (the adapter of each of the N * r rank columns), the mask
    [B, 1 or T, N * r] that keeps a row's own adapter's columns, in the
    activation dtype; built once a forward pass (or a decode dispatch),
    repeated once per group width."""

    def __init__(self, idx: torch.Tensor, cols: torch.Tensor,
                 dtype: torch.dtype):
        m = (idx[..., None] == cols).to(dtype)
        self.mask = m[:, None, :] if idx.ndim == 1 else m
        self._tiled = {1: self.mask}

    def delta(self, x: torch.Tensor, g: Dict[str, torch.Tensor]
              ) -> torch.Tensor:
        """((x @ A) * mask) @ B of a group ``g`` (its members' outputs
        concatenated)."""
        k = g["A"].shape[-1] // self.mask.shape[-1]
        m = self._tiled.get(k)
        if m is None:
            m = self._tiled[k] = self.mask.repeat(1, 1, k)
        return ((x @ g["A"]) * m) @ g["B"]


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


_ACTS = {"silu": F.silu, "gelu_tanh": _gelu_tanh, "gelu_new": _gelu_tanh,
         "relu": F.relu}


def _mlp(cfg: ModelConfig, h: torch.Tensor, p: dict,
         lora: Optional[LoraRows] = None) -> torch.Tensor:
    """The gated MLP, down(act(gate(h)) * up(h)) (SwiGLU, GeGLU), or the
    plain one, down(act(up(h))) (Phi's gelu_new, OPT's ReLU), with the
    rows' LoRA deltas (a family without ``w_gate`` has ``w_up`` alone in
    its ``lora_gu`` group). With experts, the MoE MLP over the rows
    flattened to [B * T, H] (adapters never target experts)."""
    if cfg.num_experts > 0:
        return moe_mlp(cfg, h.reshape(-1, h.shape[-1]), p).view(h.shape)
    dg = du = dd = None
    if lora is not None and "lora_gu" in p:
        d = lora.delta(h, p["lora_gu"])
        if "w_gate" in p:
            n = p["w_gate"]["kernel"].shape[-1]
            dg, du = d[..., :n], d[..., n:]
        else:
            du = d
    a = _mlp_columns(cfg, h, p, dg, du)
    if lora is not None and "lora_down" in p:
        dd = lora.delta(a, p["lora_down"])
    return _linear(a, p["w_down"], dd)


def decoder_block(cfg: ModelConfig, p: dict, x: torch.Tensor,
                  cos: torch.Tensor, sin: torch.Tensor, attend: AttendFn,
                  cache_l: Any, lora: Optional[LoraRows] = None
                  ) -> Tuple[torch.Tensor, Any]:
    """One transformer block; ``p`` is a per-layer slice (no leading L);
    ``lora`` adds the rows' adapter deltas where ``p`` carries adapters."""
    B, T, _ = x.shape
    h = apply_norm(cfg, x, p["input_norm"])
    dq = dk = dv = None
    if lora is not None and "lora_qkv" in p:
        d = lora.delta(h, p["lora_qkv"])
        qs, ks = cfg.q_size, cfg.kv_size
        dq, dk, dv = d[..., :qs], d[..., qs:qs + ks], d[..., qs + ks:]
    q = _linear(h, p["wq"], dq).reshape(B, T, cfg.num_heads, cfg.head_dim)
    k = _linear(h, p["wk"], dk).reshape(B, T, cfg.num_kv_heads,
                                        cfg.head_dim)
    v = _linear(h, p["wv"], dv).reshape(B, T, cfg.num_kv_heads,
                                        cfg.head_dim)
    prep = QKPrep(p["q_norm"]["weight"] if cfg.qk_norm else None,
                  p["k_norm"]["weight"] if cfg.qk_norm else None,
                  cfg.norm_eps, cos, sin)
    if getattr(attend, "fuses_qk_prep", False):
        ctx, cache_l = attend(q, k, v, cache_l, prep)
    else:
        q, k = prep_qk_plain(q, k, prep)
        ctx, cache_l = attend(q, k, v, cache_l)
    ctx = ctx.reshape(B, T, cfg.q_size)
    do = lora.delta(ctx, p["lora_o"]) \
        if lora is not None and "lora_o" in p else None
    attn_out = _linear(ctx, p["wo"], do)
    if cfg.parallel_block:
        # Phi: attention and MLP both read the same normed input
        return x + attn_out + _mlp(cfg, h, p, lora), cache_l
    x = x + attn_out
    h2 = apply_norm(cfg, x, p["post_norm"])
    return x + _mlp(cfg, h2, p, lora), cache_l


def _embed_inputs(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                  positions: torch.Tensor):
    """Token embedding (int8 table dequantized per gathered row; Gemma's
    times sqrt(H), the factor cast to the embedding's dtype first) + RoPE
    tables [..., T, rotary_dim], or OPT's learned positions (the table's
    row ``positions + 2``, an index outside it clamped as the JAX gather
    clamps it) and zero-width tables."""
    emb = params["embed"]
    if "scale" in emb:
        dt = params["final_norm"]["weight"].dtype
        x = (emb["weight"][tokens].float()
             * emb["scale"][tokens][..., None]).to(dt)
    else:
        x = emb["weight"][tokens]
    return _position_inputs(params, cfg, x, positions)


def _position_inputs(params: dict, cfg: ModelConfig, x: torch.Tensor,
                     positions: torch.Tensor):
    """The rest of :func:`_embed_inputs` after the token lookup ``x``:
    Gemma's scale, the learned positions or the RoPE tables."""
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=x.dtype)
    if cfg.pos_embed == "learned":
        table = params["pos_embed"]["weight"]
        n = table.shape[0]
        # a finished slot's substeps in a decode horizon run past the
        # table's end: clamped, as the JAX gather clamps
        x = x + table[(positions.long() + 2).clamp(max=n - 1)]
        cos = sin = torch.zeros(positions.shape + (0,), dtype=torch.float32,
                                device=positions.device)
        return x, cos, sin
    cos, sin = rope_cos_sin(positions, cfg.rotary_dim, cfg.rope_theta, cfg)
    return x, cos, sin


def _final_logits(params: dict, cfg: ModelConfig, x: torch.Tensor
                  ) -> torch.Tensor:
    return _head(params, cfg, apply_norm(cfg, x, params["final_norm"]))


def _head(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The logits of the normed rows: the (tied) embedding's or the
    head's columns that ``params`` holds (all of them, or a tp shard's)."""
    if cfg.tie_embeddings:
        emb = params["embed"]
        if "scale" in emb:
            # per-vocab-row scales become per-logit-column scales
            return ((x @ emb["weight"].T.to(x.dtype))
                    * emb["scale"]).to(x.dtype)
        return x @ emb["weight"].T
    return _linear(x, params["lm_head"])


def layer_slices(params: dict, num_layers: int) -> List[dict]:
    """Per-layer views of the stacked ``params["layers"]`` tree."""
    layers = params["layers"]
    return [{name: {leaf: t[l] for leaf, t in p.items()}
             for name, p in layers.items()} for l in range(num_layers)]


def make_default_attend(cfg: ModelConfig) -> AttendFn:
    """Causal attention over the whole sequence, honouring
    ``cfg.sliding_window``."""
    def attend(q, k, v, cache_l):
        return causal_attend(q, k, v, window=cfg.sliding_window), cache_l

    return attend


def model_forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                  positions: torch.Tensor, attend: Optional[AttendFn] = None,
                  layers: Optional[List[dict]] = None,
                  lora: Optional[LoraRows] = None) -> torch.Tensor:
    """Run the decoder with causal attention (sliding-window where the
    config has one), or ``attend`` with a per-layer cache of None; returns
    logits [B, T, V]. ``lora``: the rows' adapters
    (``DecoderLM.lora_rows``)."""
    attend = attend or make_default_attend(cfg)
    layers = layers or layer_slices(params, cfg.num_layers)
    x, cos, sin = _embed_inputs(params, cfg, tokens, positions)
    for p_l in layers:
        x, _ = decoder_block(cfg, p_l, x, cos, sin, attend, None, lora)
    return _final_logits(params, cfg, x)


def model_forward_carry(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                        positions: torch.Tensor, cache: Any, attend: AttendFn,
                        layers: Optional[List[dict]] = None,
                        lora: Optional[LoraRows] = None
                        ) -> Tuple[torch.Tensor, Any]:
    """Decoder forward with the whole cache handed to every layer:
    ``attend`` receives ``(cache, layer_idx)`` and writes the layer's rows in
    place (the serving decode, prefill and mixed paths); ``lora`` as in
    :func:`model_forward`."""
    layers = layers or layer_slices(params, cfg.num_layers)
    x, cos, sin = _embed_inputs(params, cfg, tokens, positions)
    for l, p_l in enumerate(layers):
        x, (cache, _) = decoder_block(cfg, p_l, x, cos, sin, attend,
                                      (cache, l), lora)
    return _final_logits(params, cfg, x), cache


def _draw(shape, generator: torch.Generator, dtype: torch.dtype
          ) -> torch.Tensor:
    """One normal draw of std 0.02 into ``dtype`` (float32 first)."""
    t = torch.randn(shape, generator=generator, device=generator.device,
                    dtype=torch.float32)
    return t.mul_(0.02).to(dtype)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.bfloat16,
                quantize: bool = False) -> dict:
    """Random parameters (normal, std 0.02; norm weights at one, biases at
    zero) on the generator's device, in the JAX package's layout: every
    family's tree (norm biases with LayerNorm, projection biases, no
    ``w_gate`` in a plain MLP, no ``post_norm`` in a parallel block,
    OPT's ``pos_embed`` of ``max_seq_len + 2`` rows, Phi's ``lm_head``
    bias; with experts the router [L, H, E] and the stacked experts). Same
    distribution as the JAX ``init_params``; not the same numbers (the
    generators differ). A stacked kernel is drawn one layer at a time into
    its ``dtype`` tensor, so the float32 draws never exceed one layer's
    matrix (Mistral-7B's bf16 tree is 14.5 GB; its float32 tree would be
    twice that). ``quantize``: each kernel, the embedding and an untied
    head is quantized (``models/quant.py``) as soon as it is drawn, a
    stacked kernel layer by layer, so the ``dtype`` tensors held at once
    never exceed one layer's matrix or the embedding (Qwen3-30B-A3B: a
    30.6 GB int8 tree, where the bf16 tree is 61 GB); the result equals
    ``quantize_params(init_params(...))`` bit for bit."""
    dev = generator.device
    L, H = cfg.num_layers, cfg.hidden_size

    def draw(shape):
        return _draw(shape, generator, dtype)

    def stacked(*shape):
        out = torch.empty((L,) + shape, dtype=dtype, device=dev)
        for layer in range(L):
            out[layer] = draw(shape)
        return out

    def kernel(*shape, in_axis=0):
        """{"kernel"} of a stacked [L, *shape] matrix contracting over
        ``in_axis`` of ``shape``; int8 beside its scales with
        ``quantize``."""
        if not quantize:
            return {"kernel": stacked(*shape)}
        q = torch.empty((L,) + shape, dtype=torch.int8, device=dev)
        s = torch.empty((L,) + shape[:in_axis] + shape[in_axis + 1:],
                        dtype=torch.float32, device=dev)
        for layer in range(L):
            q[layer], s[layer] = quant_kernel_chunked(draw(shape), in_axis)
        return {"kernel": q, "scale": s}

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def dense(din, dout, bias):
        p = kernel(din, dout)
        if bias:
            p["bias"] = zeros(L, dout)
        return p

    def norm(*lead):
        p = {"weight": ones(*lead, H)}
        if cfg.norm == "layernorm":
            p["bias"] = zeros(*lead, H)
        return p

    def quantized(p, in_axis):
        """A whole (unstacked) weight leaf, quantized with ``quantize``."""
        if not quantize:
            return p
        key = "weight" if "weight" in p else "kernel"
        q, s = quant_kernel_chunked(p.pop(key), in_axis)
        return {**p, key: q, "scale": s}

    I, ab, mb = cfg.intermediate_size, cfg.attention_bias, cfg.mlp_bias
    layers = {
        "input_norm": norm(L),
        "wq": dense(H, cfg.q_size, ab),
        "wk": dense(H, cfg.kv_size, ab),
        "wv": dense(H, cfg.kv_size, ab),
        "wo": dense(cfg.q_size, H, ab),
    }
    if cfg.qk_norm:
        layers["q_norm"] = {"weight": ones(L, cfg.head_dim)}
        layers["k_norm"] = {"weight": ones(L, cfg.head_dim)}
    if cfg.num_experts > 0:
        # the router stays in the model dtype; the experts contract over
        # their in axis (1 of [E, in, out])
        E, Im = cfg.num_experts, cfg.moe_intermediate_size
        layers["router"] = {"kernel": stacked(H, E)}
        layers["w_gate"] = kernel(E, H, Im, in_axis=1)
        layers["w_up"] = kernel(E, H, Im, in_axis=1)
        layers["w_down"] = kernel(E, Im, H, in_axis=1)
    else:
        if cfg.gated_mlp:
            layers["w_gate"] = dense(H, I, mb)
        layers["w_up"] = dense(H, I, mb)
        layers["w_down"] = dense(I, H, mb)
    if not cfg.parallel_block:
        layers["post_norm"] = norm(L)
    params = {
        "embed": quantized({"weight": draw((cfg.vocab_size, H))}, 1),
        "layers": layers,
        "final_norm": norm(),
    }
    if cfg.pos_embed == "learned":
        params["pos_embed"] = {"weight": draw((cfg.max_seq_len + 2, H))}
    if not cfg.tie_embeddings:
        head = {"kernel": draw((H, cfg.vocab_size))}
        if cfg.parallel_block:
            head["bias"] = zeros(cfg.vocab_size)
        params["lm_head"] = quantized(head, 0)
    return params


def _flatten(tree: dict, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    out = []
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            out.extend(_flatten(val, name + "__"))
        else:
            out.append((name, val))
    return out


class DecoderLM(nn.Module):
    """The decoder as an ``nn.Module``: parameters are buffers (serving only,
    no gradients), named after their place in the JAX tree with ``__``
    separators; ``params`` rebuilds that nested dict."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self._names = []
        for name, t in _flatten(params):
            self.register_buffer(name, t, persistent=False)
            self._names.append(name)
        self._views = None

    def _apply(self, fn, *args, **kwargs):
        self._views = None          # device/dtype moves replace the buffers
        return super()._apply(fn, *args, **kwargs)

    @property
    def params(self) -> dict:
        tree: dict = {}
        for name in self._names:
            node = tree
            *path, leaf = name.split("__")
            for key in path:
                node = node.setdefault(key, {})
            node[leaf] = getattr(self, name)
        return tree

    def _cached(self):
        if self._views is None:
            params = self.params
            self._views = (params, layer_slices(params, self.cfg.num_layers))
        return self._views

    @property
    def device(self) -> torch.device:
        return self.embed__weight.device

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.final_norm__weight.dtype

    @property
    def has_lora(self) -> bool:
        """Whether adapters are attached (``models/lora.attach``)."""
        return "lora__cols" in self._names

    def lora_rows(self, idx: Optional[torch.Tensor]) -> Optional[LoraRows]:
        """:class:`LoraRows` of the adapter indices ``idx`` ([B] per row,
        [B, T] per token; 0 = base), None without adapters or indices: the
        ``lora`` of :meth:`forward` and :meth:`forward_carry`, built once a
        forward pass (a decode dispatch: once for all its substeps). A
        model without adapters gives None whatever ``idx`` is, so that it
        runs no LoRA operation."""
        if idx is None or not self.has_lora:
            return None
        return LoraRows(idx, self.lora__cols, self.compute_dtype)

    def forward(self, tokens: torch.Tensor, positions: torch.Tensor,
                attend: Optional[AttendFn] = None,
                lora: Optional[LoraRows] = None) -> torch.Tensor:
        params, layers = self._cached()
        return model_forward(params, self.cfg, tokens, positions, attend,
                             layers, lora)

    def forward_carry(self, tokens: torch.Tensor, positions: torch.Tensor,
                      cache: Any, attend: AttendFn,
                      lora: Optional[LoraRows] = None):
        """``lora``: the rows' adapters (:meth:`lora_rows`)."""
        params, layers = self._cached()
        return model_forward_carry(params, self.cfg, tokens, positions, cache,
                                   attend, layers, lora)


class MeshLM:
    """The decoder served over a (dp, tp, ep) mesh by one process (the
    JAX engine's sharded ``model_forward_carry`` under GSPMD), with
    :class:`DecoderLM`'s serving interface (``forward_carry``, ``cfg``,
    ``device``, ``compute_dtype``, ``lora_rows``).

    The parameters are sliced by ``parallel/sharding.param_pspecs``
    (Megatron tp, experts over ep, replicas over dp), each position's tree
    on its device; a tp shard runs at :attr:`local_cfg`'s head counts
    (Hq / tp, Hkv / tp). One forward pass splits the rows by dp group
    (each paged callback's ``rows``, ``ops/attention.RowSplit``: a row's
    slot, slots over groups contiguously, ``slots_per_group`` a group),
    and runs each group's rows on its devices against its partition of
    the pool (``parallel/sharding.ShardedPool``): the vocab-sharded
    embedding lookup and one ``all_reduce``; in every layer the attention
    and ``wo`` on each tp shard's heads, one ``all_reduce``, then the MLP
    per shard (column-parallel gate and up, row-parallel down) and one
    ``all_reduce`` (the parallel block, phi: both partials in one
    reduction); a row-parallel kernel's int8 scale and bias after the sum;
    the MoE MLP as the gshard dispatch over (ep, tp)
    (``ops/moe.moe_mlp_gshard_sharded``); the head per shard and the
    logits gathered in vocabulary order onto the mesh's lead device, where
    the rows of every group are put back in order. Sampling and every
    logit process after the forward read those full-vocabulary logits on
    the lead, so they do not depend on the mesh. The collectives are
    ``parallel/collectives.py``'s. No adapters (LoRA under a mesh is
    refused)."""

    has_lora = False

    def __init__(self, cfg: ModelConfig, params: dict, mesh,
                 slots_per_group: int):
        from aws_k8s_ansible_provisioner_tpu_torch.parallel import \
            sharding as shd

        self.cfg, self.mesh = cfg, mesh
        self.dp = shd.axis_size(mesh, "dp")
        self.tp = shd.axis_size(mesh, "tp")
        self.ep = shd.axis_size(mesh, "ep")
        self.local_cfg = shd.tp_local_config(cfg, self.tp)
        self.slots_per_group = slots_per_group
        self.params = shd.shard_params(params, mesh, cfg)
        # trees[g][e][t], the layer views alike; devices[g][e][t]
        self.devices = [[[mesh.devices[g, 0, 0, e, t] for t in range(self.tp)]
                         for e in range(self.ep)] for g in range(self.dp)]
        self.trees = [[[shd.position_tree(self.params, (g, 0, 0, e, t))
                        for t in range(self.tp)] for e in range(self.ep)]
                      for g in range(self.dp)]
        self.layers = [[[layer_slices(tree, cfg.num_layers) for tree in row]
                        for row in grp] for grp in self.trees]

    @property
    def device(self) -> torch.device:
        return self.mesh.lead

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.trees[0][0][0]["final_norm"]["weight"].dtype

    def lora_rows(self, idx) -> None:
        return None

    def forward(self, tokens: torch.Tensor, positions: torch.Tensor,
                lora: Optional[LoraRows] = None) -> torch.Tensor:
        """Causal attention over the whole sequence (no cache), every row
        on dp group 0's tp shards: logits [B, T, V] on the lead."""
        if lora is not None:
            raise ValueError("LoRA under a mesh is not served")
        attend = make_default_attend(self.local_cfg)
        return self._group_forward(0, tokens, positions, [None] * self.tp,
                                   [attend] * self.tp)

    def forward_carry(self, tokens: torch.Tensor, positions: torch.Tensor,
                      cache: Any, attend: AttendFn,
                      lora: Optional[LoraRows] = None):
        """Logits [..., V] on the lead and the pool (written in place).
        ``attend`` is a paged callback (``ops/attention``) over the whole
        batch with global page ids; each group gets it rebuilt over its
        rows, its tables rebased to its partition, on each tp shard's
        device."""
        if lora is not None:
            raise ValueError("LoRA under a mesh is not served")
        split = getattr(attend, "rows", None)
        if split is None:
            raise ValueError("a mesh with dp, tp or ep > 1 serves the paged "
                             "callbacks only")
        ax = split.axis
        n = tokens.shape[ax]
        if self.dp == 1:
            groups = [(0, None)]
        else:
            slots = split.slots if split.slots is not None else np.arange(n)
            grp = np.asarray(slots) // self.slots_per_group
            groups = [(g, np.nonzero(grp == g)[0]) for g in range(self.dp)]
            groups = [(g, idx) for g, idx in groups if len(idx)]
        outs = []
        for g, idx in groups:
            if idx is None:
                tok, pos = tokens, positions
            else:
                sel = torch.as_tensor(idx, dtype=torch.int64,
                                      device=tokens.device)
                tok = tokens.index_select(ax, sel)
                pos = positions.index_select(ax, sel)
            base = g * cache.group_pages
            attends = [attend if (idx is None and base == 0
                                  and str(dev) == str(tokens.device))
                       else split.remake(idx, base, dev)
                       for dev in self.devices[g][0]]
            outs.append((idx, self._group_forward(g, tok, pos, cache.parts[g],
                                                  attends)))
        if len(outs) == 1 and outs[0][0] is None:
            return outs[0][1], cache
        first = outs[0][1]
        shape = list(first.shape)
        shape[ax] = n
        logits = torch.empty(shape, dtype=first.dtype, device=first.device)
        for idx, part in outs:
            logits.index_copy_(ax, torch.as_tensor(
                idx, dtype=torch.int64, device=first.device), part)
        return logits, cache

    def _group_forward(self, g: int, tokens, positions, pools, attends):
        from aws_k8s_ansible_provisioner_tpu_torch.parallel.collectives \
            import all_gather, all_reduce, broadcast, vocab_embed

        cfg = self.cfg
        devs = self.devices[g][0]
        trees = self.trees[g][0]
        # replicated work (norms, residual adds, RoPE tables) runs once on
        # the group's lead and is broadcast to the shards that read it
        lead = devs[:1]
        x = all_reduce(vocab_embed([tr["embed"] for tr in trees],
                                   broadcast(tokens, devs),
                                   self.compute_dtype), lead)[0]
        x, cos, sin = _position_inputs(trees[0], cfg, x,
                                       positions.to(x.device))
        cos_t, sin_t = broadcast(cos, devs), broadcast(sin, devs)
        for layer in range(cfg.num_layers):
            x = self._block(g, layer, x, cos_t, sin_t, pools, attends)
        xn = apply_norm(cfg, x, trees[0]["final_norm"])
        parts = [_head(tr, cfg, h) for tr, h in
                 zip(trees, broadcast(xn, devs))]
        return all_gather(parts, self.mesh.lead)

    def _block(self, g: int, layer: int, x, cos_t, sin_t, pools, attends):
        """One block of group g's rows (x on the group's lead device)."""
        from aws_k8s_ansible_provisioner_tpu_torch.parallel.collectives \
            import all_reduce, broadcast

        cfg, lc = self.cfg, self.local_cfg
        devs = self.devices[g][0]
        ps = [ls[layer] for ls in self.layers[g][0]]
        B, T, _ = x.shape
        h = apply_norm(cfg, x, ps[0]["input_norm"])
        hs = broadcast(h, devs)
        attn_parts, mlp_parts = [], []
        for t, p in enumerate(ps):
            q = _linear(hs[t], p["wq"]).reshape(B, T, lc.num_heads,
                                                lc.head_dim)
            k = _linear(hs[t], p["wk"]).reshape(B, T, lc.num_kv_heads,
                                                lc.head_dim)
            v = _linear(hs[t], p["wv"]).reshape(B, T, lc.num_kv_heads,
                                                lc.head_dim)
            prep = QKPrep(p["q_norm"]["weight"] if cfg.qk_norm else None,
                          p["k_norm"]["weight"] if cfg.qk_norm else None,
                          cfg.norm_eps, cos_t[t], sin_t[t])
            if getattr(attends[t], "fuses_qk_prep", False):
                ctx, _ = attends[t](q, k, v, (pools[t], layer), prep)
            else:
                q, k = prep_qk_plain(q, k, prep)
                ctx, _ = attends[t](q, k, v, (pools[t], layer))
            attn_parts.append(_product(ctx.reshape(B, T, lc.q_size), p["wo"]))
            if cfg.parallel_block:
                mlp_parts.append(_product(_mlp_columns(cfg, hs[t], p),
                                          p["w_down"]))
        if cfg.parallel_block:
            # attention's and the MLP's partials in one reduction
            both = all_reduce([torch.stack(ab) for ab in
                               zip(attn_parts, mlp_parts)], devs[:1])[0]
            return (x + _epilogue(both[0], ps[0]["wo"])
                    + _epilogue(both[1], ps[0]["w_down"]))
        x = x + _epilogue(all_reduce(attn_parts, devs[:1])[0], ps[0]["wo"])
        h2 = apply_norm(cfg, x, ps[0]["post_norm"])
        if cfg.num_experts > 0:
            from aws_k8s_ansible_provisioner_tpu_torch.ops.moe import \
                moe_mlp_gshard_sharded

            experts = [[ls[layer] for ls in row] for row in self.layers[g]]
            out = moe_mlp_gshard_sharded(
                cfg, h2.reshape(-1, h2.shape[-1]), ps[0]["router"]["kernel"],
                experts, self.devices[g])
            return x + out.view(h2.shape)
        parts = [_product(_mlp_columns(cfg, h2t, p), p["w_down"])
                 for p, h2t in zip(ps, broadcast(h2, devs))]
        return x + _epilogue(all_reduce(parts, devs[:1])[0],
                             ps[0]["w_down"])


def _mlp_columns(cfg: ModelConfig, h: torch.Tensor, p: dict,
                 dg: Optional[torch.Tensor] = None,
                 du: Optional[torch.Tensor] = None) -> torch.Tensor:
    """act(gate(h)) * up(h), or act(up(h)), over the intermediate columns
    that ``p`` holds (all, or a tp shard's: column-parallel, its bias
    sliced), with the gate's and up's LoRA deltas."""
    act = _ACTS[cfg.act]
    if "w_gate" in p:
        return act(_linear(h, p["w_gate"], dg)) * _linear(h, p["w_up"], du)
    return act(_linear(h, p["w_up"], du))
