"""Configuration of the PyTorch/CUDA serving port.

The port keeps its own copy of the architecture and serving knobs it reads,
field for field with the JAX package's ``config.py`` so that a test can hand
one config to both sides (``dataclasses.asdict`` round-trips between them).
The registry holds every entry of the JAX registry (Qwen3, Qwen3-MoE,
Mistral, Llama, Gemma, Phi and OPT) and the tiny builders of each family.
Only the serving fields the port reads are here (``lora_adapters``
among them; guided decoding needs none); the rest of the JAX
``ServingConfig`` (tracing, telemetry, the TPU attention and ragged
switches) comes over with the slices that port those features.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters for a decoder-only LM (same schema as the
    JAX package's ``ModelConfig``). The port's forward pass serves every
    dense family of it: ``norm`` "rmsnorm" (optionally zero-centred, Gemma)
    or "layernorm" (with bias: Phi, OPT); ``pos_embed`` "rope" (over the
    first ``head_dim * rotary_pct`` columns, optionally with the llama3
    frequency scaling) or "learned" (OPT); ``act`` "silu" and "gelu_tanh"
    (gated MLPs) or "gelu_new" and "relu" (plain two-matrix MLPs); the
    parallel block (Phi); optional qk-norm, biases and sliding-window
    attention (``sliding_window`` > 0: a query sees its last
    ``sliding_window`` keys); and the Qwen3-MoE MLP (``num_experts`` > 0:
    a router and ``num_experts`` SwiGLU experts of width
    ``moe_intermediate_size``, top ``num_experts_per_tok`` a token,
    renormalized with ``norm_topk_prob``; ``moe_impl`` "ragged", exact
    and no-drop, or "gshard", fixed capacity ``moe_capacity_factor``;
    ``ops/moe.py``)."""

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
    def gated_mlp(self) -> bool:
        return self.act in ("silu", "gelu_tanh")

    @property
    def rotary_dim(self) -> int:
        """Columns of a head that RoPE rotates: 0 with learned positions."""
        if self.pos_embed != "rope":
            return 0
        return int(self.head_dim * self.rotary_pct)

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


# Public HF config.json values of the other dense families (the JAX
# registry's entries, field for field).
QWEN3_8B = ModelConfig(
    name="Qwen/Qwen3-8B",
    vocab_size=151936,
    hidden_size=4096,
    intermediate_size=12288,
    num_layers=36,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    max_seq_len=40960,
    rope_theta=1e6,
    qk_norm=True,
    tie_embeddings=False,
    bos_token_id=151643,
    eos_token_id=151645,
    hf_repo="Qwen/Qwen3-8B",
)

PHI_2 = ModelConfig(
    name="microsoft/phi-2",
    vocab_size=51200,
    hidden_size=2560,
    intermediate_size=10240,
    num_layers=32,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    max_seq_len=2048,
    rope_theta=10000.0,
    rotary_pct=0.4,
    norm="layernorm",
    norm_eps=1e-5,
    act="gelu_new",
    attention_bias=True,
    mlp_bias=True,
    parallel_block=True,
    tie_embeddings=False,
    bos_token_id=50256,
    eos_token_id=50256,
    hf_repo="microsoft/phi-2",
)

OPT_125M = ModelConfig(
    name="facebook/opt-125m",
    vocab_size=50272,
    hidden_size=768,
    intermediate_size=3072,
    num_layers=12,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    max_seq_len=2048,
    norm="layernorm",
    norm_eps=1e-5,
    act="relu",
    pos_embed="learned",
    attention_bias=True,
    mlp_bias=True,
    tie_embeddings=True,
    bos_token_id=2,
    eos_token_id=2,
    hf_repo="facebook/opt-125m",
)

OPT_1_3B = ModelConfig(
    name="facebook/opt-1.3b",
    vocab_size=50272,
    hidden_size=2048,
    intermediate_size=8192,
    num_layers=24,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    max_seq_len=2048,
    norm="layernorm",
    norm_eps=1e-5,
    act="relu",
    pos_embed="learned",
    attention_bias=True,
    mlp_bias=True,
    tie_embeddings=True,
    bos_token_id=2,
    eos_token_id=2,
    hf_repo="facebook/opt-1.3b",
)

LLAMA_3_2_1B = ModelConfig(
    name="meta-llama/Llama-3.2-1B",
    vocab_size=128256,
    hidden_size=2048,
    intermediate_size=8192,
    num_layers=16,
    num_heads=32,
    num_kv_heads=8,
    head_dim=64,
    max_seq_len=131072,
    rope_theta=500000.0,
    rope_scaling="llama3",
    rope_factor=32.0,
    rope_low_freq_factor=1.0,
    rope_high_freq_factor=4.0,
    rope_original_max_pos=8192,
    tie_embeddings=True,
    bos_token_id=128000,
    eos_token_id=128001,
    hf_repo="meta-llama/Llama-3.2-1B",
)

LLAMA_3_1_8B = ModelConfig(
    name="meta-llama/Llama-3.1-8B",
    vocab_size=128256,
    hidden_size=4096,
    intermediate_size=14336,
    num_layers=32,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    max_seq_len=131072,
    rope_theta=500000.0,
    rope_scaling="llama3",
    rope_factor=8.0,
    rope_low_freq_factor=1.0,
    rope_high_freq_factor=4.0,
    rope_original_max_pos=8192,
    tie_embeddings=False,
    bos_token_id=128000,
    eos_token_id=128001,
    hf_repo="meta-llama/Llama-3.1-8B",
)

TINYLLAMA_1_1B = ModelConfig(
    name="TinyLlama/TinyLlama-1.1B-Chat-v1.0",
    vocab_size=32000,
    hidden_size=2048,
    intermediate_size=5632,
    num_layers=22,
    num_heads=32,
    num_kv_heads=4,
    head_dim=64,
    max_seq_len=2048,
    rope_theta=10000.0,
    tie_embeddings=False,
    bos_token_id=1,
    eos_token_id=2,
    hf_repo="TinyLlama/TinyLlama-1.1B-Chat-v1.0",
)

GEMMA_2B = ModelConfig(
    name="google/gemma-2b",
    vocab_size=256000,
    hidden_size=2048,
    intermediate_size=16384,
    num_layers=18,
    num_heads=8,
    num_kv_heads=1,            # MQA
    head_dim=256,
    max_seq_len=8192,
    rope_theta=10000.0,
    norm_zero_centered=True,
    embed_scale=True,
    act="gelu_tanh",
    tie_embeddings=True,
    bos_token_id=2,
    eos_token_id=1,
    hf_repo="google/gemma-2b",
)

QWEN3_30B_A3B = ModelConfig(
    name="Qwen/Qwen3-30B-A3B",
    vocab_size=151936,
    hidden_size=2048,
    intermediate_size=6144,        # dense-MLP width (unused: all layers MoE)
    num_layers=48,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    max_seq_len=40960,
    rope_theta=1e6,
    qk_norm=True,
    tie_embeddings=False,
    bos_token_id=151643,
    eos_token_id=151645,
    num_experts=128,
    num_experts_per_tok=8,
    moe_intermediate_size=768,
    norm_topk_prob=True,
    hf_repo="Qwen/Qwen3-30B-A3B",
)

MODEL_REGISTRY = {
    "Qwen/Qwen3-0.6B": QWEN3_0_6B,
    "Qwen/Qwen3-30B-A3B": QWEN3_30B_A3B,
    "Qwen/Qwen3-8B": QWEN3_8B,
    "microsoft/phi-2": PHI_2,
    "facebook/opt-125m": OPT_125M,
    "facebook/opt-1.3b": OPT_1_3B,
    "google/gemma-2b": GEMMA_2B,
    "mistralai/Mistral-7B-v0.1": MISTRAL_7B_V01,
    "meta-llama/Llama-3.2-1B": LLAMA_3_2_1B,
    "meta-llama/Llama-3.1-8B": LLAMA_3_1_8B,
    "TinyLlama/TinyLlama-1.1B-Chat-v1.0": TINYLLAMA_1_1B,
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


def tiny_qwen3_moe(**overrides) -> ModelConfig:
    """A miniature Qwen3-MoE-shaped config (router + SwiGLU experts, GQA)."""
    base = dict(
        name="tiny-qwen3-moe",
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
        num_experts=8,
        num_experts_per_tok=2,
        moe_intermediate_size=32,
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


def tiny_gemma(**overrides) -> ModelConfig:
    """A miniature Gemma-shaped config (zero-centered norms, scaled embed,
    GeGLU, MQA)."""
    base = dict(
        name="tiny-gemma",
        vocab_size=128,
        hidden_size=64,
        intermediate_size=128,
        num_layers=2,
        num_heads=4,
        num_kv_heads=1,
        head_dim=16,
        max_seq_len=128,
        rope_theta=10000.0,
        norm_zero_centered=True,
        embed_scale=True,
        act="gelu_tanh",
        tie_embeddings=True,
        eos_token_id=1,
    )
    base.update(overrides)
    return ModelConfig(**base)


def tiny_llama(**overrides) -> ModelConfig:
    """A miniature Llama-3-shaped config (GQA, llama3 rope scaling, no
    qk-norm)."""
    base = dict(
        name="tiny-llama",
        vocab_size=128,
        hidden_size=64,
        intermediate_size=128,
        num_layers=2,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        max_seq_len=256,
        rope_theta=500000.0,
        rope_scaling="llama3",
        rope_factor=8.0,
        rope_low_freq_factor=1.0,
        rope_high_freq_factor=4.0,
        rope_original_max_pos=64,
        tie_embeddings=True,
        eos_token_id=1,
    )
    base.update(overrides)
    return ModelConfig(**base)


def tiny_opt(**overrides) -> ModelConfig:
    """A miniature OPT-shaped config (learned positions, ReLU MLP,
    pre-norm)."""
    base = dict(
        name="tiny-opt",
        vocab_size=128,
        hidden_size=64,
        intermediate_size=128,
        num_layers=2,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        max_seq_len=128,
        norm="layernorm",
        norm_eps=1e-5,
        act="relu",
        pos_embed="learned",
        attention_bias=True,
        mlp_bias=True,
        tie_embeddings=True,
        eos_token_id=1,
    )
    base.update(overrides)
    return ModelConfig(**base)


def tiny_phi(**overrides) -> ModelConfig:
    """A miniature Phi-2-shaped config (parallel block, partial rotary,
    biases)."""
    base = dict(
        name="tiny-phi",
        vocab_size=128,
        hidden_size=64,
        intermediate_size=128,
        num_layers=2,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        max_seq_len=128,
        rope_theta=10000.0,
        rotary_pct=0.5,
        norm="layernorm",
        norm_eps=1e-5,
        act="gelu_new",
        attention_bias=True,
        mlp_bias=True,
        parallel_block=True,
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
    count. The port's engine serves ``sp`` alone, or ``dp``, ``tp`` and
    ``ep`` together (``serving/engine.py``); not ``pp``."""

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
    # Host-RAM tier of the prefix cache: byte budget of the pinned host
    # store of spilled pages. When the pool's LRU reclaims an indexed
    # (evictable) page, its K/V is copied to the host under its chain key; a
    # later prompt whose prefix chain runs past the pages still in the pool
    # restores the rest across PCIe and prefills only the suffix. 0 turns
    # the tier off (no spill log, no host walk in the lookup), as do a
    # budget below one page and the prefix cache off.
    kv_host_tier_bytes: int = 256 * 2**20
    # Up to this many fresh prompts share one prefill dispatch.
    max_prefill_batch: int = 4
    # Prompts longer than this are prefilled in chunks of this many tokens,
    # each chunk packed beside the decode batch in one ragged dispatch.
    # 0 disables chunking.
    prefill_chunk: int = 0
    # Automatic prefix caching (vLLM's feature of the same name). Paged: the
    # full pages of every prompt (and, at a finish or a preemption, of its
    # generated tokens) are indexed by a chain hash and shared by refcount
    # with a later prompt that starts with the same tokens; a released page
    # stays matchable in an evictable LRU until the pool reclaims it. Dense:
    # a prompt sharing >= prefix_cache_min_len leading tokens with the
    # prompt rows still held by a slot copies them from that slot. Either
    # way only the suffix is prefilled (through the chunk walk).
    prefix_cache: bool = True
    prefix_cache_min_len: int = 32
    # Dense: a hit that adds dispatches against the whole-prompt path (the
    # copy plus the suffix's chunks against one bucket) must reuse at least
    # this many rows; hits that add none are always taken.
    prefix_cache_payback_rows: int = 256
    # Paged: a prefix hit forces the chunk walk, so under a burst (another
    # prompt in the same admission round or still queued) a match is used
    # only when the prompt would chunk anyway or the match spans at least
    # this many whole pages (resident plus host-restorable).
    prefix_reuse_min_pages: int = 2
    max_tokens_default: int = 256
    # Prefill/decode fairness: after this many consecutive batch-prefill
    # dispatches while slots decode and prompts wait, the engine forces one
    # decode dispatch at the full decode_horizon before it admits more.
    # Without it a steady stream of arrivals holds the running streams back
    # (decode runs only when nothing can be admitted, at horizon 1 near an
    # admission). 0 turns the floor off.
    prefill_fairness: int = 4
    # Default end-to-end deadline of a request, and the cap of a client's
    # own (X-Request-Deadline-Ms / deadline_ms), in seconds from submission:
    # queue wait counts against it, and an expired request is cancelled
    # between dispatches (finish "timeout", HTTP 408). 0 disables (no
    # default deadline, uncapped client deadlines).
    request_timeout_s: float = 600.0
    # Admissions past this queue depth are shed with reason "queue_full"
    # (HTTP 429 + Retry-After; 0 = unbounded).
    max_queue_depth: int = 256
    # When > 0, an admission whose estimated queue wait (queue depth x
    # recent tokens per finished request / recent tokens per second) exceeds
    # this many seconds is shed with reason "est_wait" (429). 0 disables.
    admission_max_wait_s: float = 0.0
    # Graceful drain budget: on SIGTERM or /admin/drain the engine stops
    # admitting (new requests shed with reason "draining", HTTP 503,
    # /readyz 503) and in-flight requests get this many seconds to finish;
    # stragglers are then cancelled through the deadline path.
    drain_timeout_s: float = 30.0
    # Stall watchdog: a step executing past this many seconds is declared
    # stalled (/healthz and /readyz answer 503 "stalled"; counted in
    # tpu_serve_watchdog_stalls_total).
    watchdog_stall_s: float = 120.0
    # Paged admission pressure relief: when the queue head cannot be placed
    # for want of pages although a slot is free, for this many seconds, the
    # lowest-progress running request is preempted (recompute, requeued at
    # the back). 0 disables (the head waits for pages to come free).
    admission_preempt_after_s: float = 1.0
    # /v1/chat/completions: a Jinja template file that renders the
    # messages; empty = the tokenizer's own template, else the model
    # family's default style (serving/chat_template.py)
    chat_template: str = ""
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
    # A local HF checkpoint directory (config.json, *.safetensors, the
    # tokenizer's files): the served model, its weights and its tokenizer;
    # empty serves ``model``'s random weights and the byte tokenizer
    checkpoint_dir: str = ""
    # The draft model's checkpoint directory (spec_method="draft")
    draft_checkpoint_dir: str = ""
    # Multi-LoRA (models/lora.py): ("name=path", ...) peft adapter dirs,
    # served as model ids beside the base (the vLLM --enable-lora contract)
    lora_adapters: tuple = ()
    # The JAX engine's switches of the ragged mixed dispatch and of the
    # feature paths riding it. The port always runs both (1); 0 is refused
    # by the server (the serialized chunk walk and the per-feature
    # fallbacks are not ported).
    ragged_attention: int = 1
    ragged_features: int = 1
    # ---- request tracing (serving/tracing.py) ----
    # OTLP/HTTP trace collector base URL (spans POST to <endpoint>/v1/traces);
    # empty falls back to $OTEL_EXPORTER_OTLP_ENDPOINT, and with neither the
    # spans are created (their ids echo in the answers) but never exported
    otlp_endpoint: str = ""
    # root-span sampling probability in [0, 1]; a propagated context keeps
    # the caller's decision
    trace_sample: float = 1.0
    # ---- SLO burn rates and the flight recorder (serving/slo.py,
    # serving/flightrec.py) ----
    # TTFT p95 objective in ms (0: no objective); the allowed fraction of
    # requests finishing error or timeout (0: none)
    slo_ttft_p95_ms: float = 0.0
    slo_error_rate: float = 0.01
    # directory of the anomaly dumps' capped JSONL spool (empty: in memory
    # only, /debug/flight/<id>)
    flight_spool_dir: str = ""
    # ---- device telemetry (serving/devmon.py) ----
    # the peaks the MFU and bandwidth gauges divide by: the H100 SXM's dense
    # bf16 TFLOP/s and HBM3 GB/s (the JAX defaults are a v5e's); the
    # live-over-ledger tolerance (MB) before /healthz's hbm_drift warns
    devmon_enabled: bool = True
    devmon_peak_tflops: float = 989.0
    devmon_peak_hbm_gbps: float = 3350.0
    devmon_hbm_tolerance_mb: float = 64.0
    # ---- capacity and saturation (serving/capacity.py) ----
    # the forecast's headroom (a replica's ready time: the default
    # replica's on an H100 80GB HBM3 at 700 W, serving/capacity.py's
    # DEFAULT_HEADROOM_S), the rate window and the trend window
    capacity_enabled: bool = True
    capacity_headroom_s: float = 15.0
    capacity_window_s: float = 60.0
    capacity_trend_window_s: float = 300.0
