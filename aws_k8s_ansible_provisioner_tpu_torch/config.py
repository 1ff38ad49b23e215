"""Configuration of the PyTorch/CUDA serving port.

The port keeps its own copy of the architecture and serving knobs it reads,
field for field with the JAX package's ``config.py`` so that a test can hand
one config to both sides (``dataclasses.asdict`` round-trips between them).
Only the serving fields the port reads are here; the rest of the JAX
``ServingConfig`` (checkpoint loading, prefix cache, host tier, pipeline,
LoRA, deadlines, telemetry) comes over with the slices that port those
features.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters for a decoder-only LM (same schema as the
    JAX package's ``ModelConfig``). The port's forward pass serves the Qwen3
    and Mistral families: ``norm="rmsnorm"``, ``pos_embed="rope"``, gated
    SiLU MLP, optional qk-norm, optional sliding-window attention
    (``sliding_window`` > 0: a query sees its last ``sliding_window`` keys),
    no MoE."""

    name: str
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    max_seq_len: int = 4096
    sliding_window: int = 0
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0
    rope_scaling: str = "none"
    rope_factor: float = 1.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_pos: int = 8192
    norm: str = "rmsnorm"
    norm_eps: float = 1e-6
    norm_zero_centered: bool = False
    embed_scale: bool = False
    qk_norm: bool = False
    act: str = "silu"
    pos_embed: str = "rope"
    attention_bias: bool = False
    mlp_bias: bool = False
    parallel_block: bool = False
    tie_embeddings: bool = False
    bos_token_id: Optional[int] = None
    eos_token_id: int = 0
    extra_eos_token_ids: tuple = ()
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_intermediate_size: int = 0
    norm_topk_prob: bool = True
    moe_impl: str = "ragged"
    moe_capacity_factor: float = 2.0
    hf_repo: str = ""

    @property
    def q_size(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_size(self) -> int:
        return self.num_kv_heads * self.head_dim

    def scaled(self, **overrides) -> "ModelConfig":
        """Return a copy with fields overridden (used for tiny test configs)."""
        return dataclasses.replace(self, **overrides)


# Public HF config.json values of the served default model.
QWEN3_0_6B = ModelConfig(
    name="Qwen/Qwen3-0.6B",
    vocab_size=151936,
    hidden_size=1024,
    intermediate_size=3072,
    num_layers=28,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    max_seq_len=40960,
    rope_theta=1e6,
    qk_norm=True,
    tie_embeddings=True,
    bos_token_id=151643,
    eos_token_id=151645,
    hf_repo="Qwen/Qwen3-0.6B",
)

# Public HF config.json of mistralai/Mistral-7B-v0.1. Its rms_norm_eps is
# 1e-5; the JAX package's registry entry leaves the 1e-6 default (its HF
# loader reads 1e-5 for this family; ROADMAP C10), the port takes 1e-5.
MISTRAL_7B_V01 = ModelConfig(
    name="mistralai/Mistral-7B-v0.1",
    vocab_size=32000,
    hidden_size=4096,
    intermediate_size=14336,
    num_layers=32,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    max_seq_len=32768,
    sliding_window=4096,
    rope_theta=10000.0,
    norm_eps=1e-5,
    tie_embeddings=False,
    bos_token_id=1,
    eos_token_id=2,
    hf_repo="mistralai/Mistral-7B-v0.1",
)

MODEL_REGISTRY = {
    "Qwen/Qwen3-0.6B": QWEN3_0_6B,
    "mistralai/Mistral-7B-v0.1": MISTRAL_7B_V01,
}


def tiny_qwen3(**overrides) -> ModelConfig:
    """A miniature Qwen3-shaped config for unit tests (CPU-fast, GQA exercised)."""
    base = dict(
        name="tiny-qwen3",
        vocab_size=128,
        hidden_size=64,
        intermediate_size=128,
        num_layers=2,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        max_seq_len=128,
        rope_theta=1e6,
        qk_norm=True,
        tie_embeddings=True,
        eos_token_id=1,
    )
    base.update(overrides)
    return ModelConfig(**base)


def tiny_mistral(**overrides) -> ModelConfig:
    """A miniature Mistral-shaped config (sliding-window attention, GQA)."""
    base = dict(
        name="tiny-mistral",
        vocab_size=128,
        hidden_size=64,
        intermediate_size=128,
        num_layers=2,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        max_seq_len=128,
        sliding_window=8,
        rope_theta=10000.0,
        tie_embeddings=False,
        eos_token_id=1,
    )
    base.update(overrides)
    return ModelConfig(**base)


@dataclass(frozen=True)
class MeshConfig:
    """Logical device mesh (the JAX package's ``config.MeshConfig``, field
    for field): ``dp`` data-parallel replicas, ``tp`` tensor parallel,
    ``sp`` sequence parallel (the serving cache's sequence axis), ``ep``
    expert parallel, ``pp`` pipeline stages. The product is the device
    count. The port serves ``sp`` only so far (``serving/engine.py``)."""

    dp: int = 1
    tp: int = 1
    sp: int = 1
    ep: int = 1
    pp: int = 1

    @property
    def num_devices(self) -> int:
        return self.dp * self.tp * self.sp * self.ep * self.pp

    @property
    def axis_names(self):
        return ("dp", "pp", "sp", "ep", "tp")


@dataclass(frozen=True)
class ServingConfig:
    """Engine knobs this slice reads; defaults equal the JAX package's."""

    model: str = "Qwen/Qwen3-0.6B"
    port: int = 8000
    host: str = "0.0.0.0"
    # Decode slots = max concurrent sequences in flight.
    max_decode_slots: int = 32
    # Prefill length buckets: prompts are right-padded to the smallest bucket
    # that holds them.
    prefill_buckets: tuple = (32, 64, 128, 256, 512, 1024, 2048)
    # Max tokens of KV cache per slot.
    max_cache_len: int = 2048
    # Decode substeps per dispatch when no admission is possible.
    decode_horizon: int = 8
    # One-deep decode pipeline: decode dispatch N+1 is queued, with the
    # sampled token and length carry still on the device, before N's tokens
    # are fetched, so the host's emits overlap the device's work. Seeded
    # streams are the same either way (draws are keyed by position). 0 is
    # the synchronous dispatch-then-fetch path.
    decode_pipeline: int = 1
    # Paged KV pool geometry: rows per page, and physical pages (0 =
    # max_decode_slots * ceil(max_cache_len / page_size)).
    page_size: int = 64
    # True: a shared page pool with per-slot block tables, admission gated
    # on free pages. False: the dense slot-contiguous cache
    # [L, slots, Hkv, window, D], every slot reserving its whole window,
    # admission gated on free slots (the JAX engine's layout under sp).
    paged: bool = True
    kv_pool_pages: int = 0
    # Up to this many fresh prompts share one prefill dispatch.
    max_prefill_batch: int = 4
    # Prompts longer than this are prefilled in chunks of this many tokens,
    # each chunk packed beside the decode batch in one ragged dispatch.
    # 0 disables chunking.
    prefill_chunk: int = 0
    max_tokens_default: int = 256
    # Admissions past this queue depth are refused (0 = unbounded).
    max_queue_depth: int = 256
    # Seed of the engine's draws of per-request sampling seeds for requests
    # that set none; None draws it from os.urandom.
    derived_seed: object = None
    # Activation dtype; the KV pool is stored in it unless kv_dtype is int8.
    dtype: str = "bfloat16"
    # "auto" = KV pool in ``dtype``; "int8" = per-row int8 K/V with a float32
    # scale per (row, kv head) (vLLM's kv_cache_dtype): half the bytes.
    kv_dtype: str = "auto"
    # "int8" = weights-only per-out-channel int8 (the default); "bf16"/"auto"
    # keep the weights as loaded.
    weights_dtype: str = "int8"
    # Slots per CTA of the dense cache's decode kernel (K5 when > 1): a
    # positive value is fitted down to the largest divisor of
    # max_decode_slots; 0 means 1. The paged engine's kernel (K1) takes no
    # block: its result does not depend on one, and the JAX package
    # autotunes it only on a TPU.
    decode_bblock: int = 0
    # Speculative decoding: propose spec_k tokens per greedy slot and verify
    # them with the target model in one dispatch of spec_k + 1 rows. Greedy
    # streams stay those of plain decode; a sampled slot accepts nothing.
    spec_decode: bool = False
    # Proposal source: "prompt_lookup" (the context's trailing spec_ngram
    # tokens matched against its own history) or "draft" (a small draft LM,
    # ``Engine(..., draft=(cfg, params))``).
    spec_method: str = "prompt_lookup"
    spec_k: int = 4
    spec_ngram: int = 3
    # The serving mesh: more than one device shards the dense cache's
    # sequence axis over ``sp`` (``Engine._build_mesh``).
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
