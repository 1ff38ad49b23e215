#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--phases NAME[,NAME...]]

Runs from the root of a checkout and needs one CUDA card, nvcc and the
port's package beside this file; it exits non-zero without printing a
result when either is missing. ``--phases`` runs only the named phases
(``PHASES``: kernels, kernels-window, kernels-sp, kernels-families,
kernels-moe, sampling, engine, server-process, checkpoint, guided-lora,
prefix, spec, draft, dense, mistral, families, moe, sp, mesh; the build always
runs); the kernels line then lists the rows whose kernels phase and named
run both ran, each still required to have launched there. With no
argument every phase runs. Phases, in order (any failure raises):

1. build: nvcc compiles every kernel of the serving path from ``csrc/``
   (one process per source, all started together);
2. kernels: at the shapes of the main path (Qwen3-0.6B: Hq 16, Hkv 8, D 128,
   page 64, a 28-layer pool) each kernel is held against its plain PyTorch
   version on the same inputs on the card, and timed beside its plain
   version, a PyTorch library call of the same function and its bound: the
   attention and the row write over a bf16 pool, and their int8 forms (the
   scale-folding attention, the quantizing row write) over an int8 pool
   (the ragged call with its chunk layout, its 256 chunk rows through the
   chunk body, within one bf16 ulp a row); the speculative verify's
   attention (5 rows per slot) over both pools;
   and over the dense cache ([28, 32, 8, 2048, 128], bf16, then int8 with
   its scales) the decode attention (K4; K5 at 4 and 8 slots per CTA), the
   verify attention (K7) and the row write (K8; int8: K9, bit-exact); and
   the paged row write with Qwen3's q/k RMSNorm and RoPE fused in, bf16
   and int8, at the decode's 32 rows, the verify's 32 x 5 and the ragged
   call's 32 + 256, and the dense one at the dense decode's 32 rows and
   verify's 32 x 5 (q and k within one bf16 ulp of their head row's largest
   value, v bit-exact, int8 codes within 1 and scales within 2^-8,
   bit-identical where the bf16 k row is), timed eagerly, as one CUDA graph
   replay, and beside the chain it replaces (the plain prologue and the
   standalone write) replayed as one CUDA graph;
3. engine, once per KV pool: the main path, Qwen3-0.6B at full width with
   seeded random weights through ``serving.engine.Engine`` (the default
   ServingConfig: paged, page 64, 32 slots, int8 weights; prefill_chunk 256
   so long prompts ride ``mixed_step``), first with bf16 KV, then with
   ``kv_dtype="int8"``, with the default one-deep decode pipeline and the
   decode horizon replayed as CUDA graphs captured when the engine is
   built: every decode dispatch must be one replay. The kernels' launch
   counts (a replay adds what its graph captured) are zeroed just before
   each run and read just after; each kernel of that pool must be > 0 (the
   chunk body's launches included) and the other pool's kernels 0; the
   fused q/k prologue and row write must have launched once per layer of
   every paged forward (decode substep, mixed dispatch, verify) and the
   standalone row writes never (also in the profiled dispatch, the
   prefix and the spec runs; the dense runs of 9, 12 and 13 hold the fused
   dense write to every layer of every dense forward the same way). The
   int8 run adds seeded sampled requests: one submitted alone and again
   beside other running requests must give the same stream. Then one
   decode dispatch of 8 slots is timed and profiled (device time by
   kernel, the row write's time a launch), and
   one decode step's logits through the kernels are held against the same
   step through the plain versions. After the int8 run, the pipeline
   phase: the graphs' capture time and device memory, one replay against
   eager ``decode_steps`` on a clone of the cache (tokens equal, every
   K/V row and scale bit-identical or the largest difference printed,
   launch counts equal), seeded streams equal with ``decode_pipeline`` 1
   and 0, and a dispatch profiled with the pipeline off;
4. server, for each engine: the port's HTTP server in-process on a free
   port answers ``GET /v1/models`` and ``POST /v1/completions`` (with the
   int8 engine, a seeded sampled completion twice, the same text). Over
   the paged int8 engine (32 slots) it also runs the replica lifecycle,
   launch counts zeroed before it and read after it (K1-int8 and the
   fused K3 write must have launched): ``/readyz``, ``/healthz`` (paged,
   pages counted), ``/load`` (32 slots), ``/metrics`` (the generated-token
   counter's increase equal to the engine count's); a completion of 1500
   tokens with ``X-Request-Deadline-Ms: 300`` answers 408 and gives its
   slot and pages back (the overshoot past the deadline printed); a drain
   (``exit: false``) during a 512-token completion turns ``/readyz`` 503
   with ``X-TPU-Draining``, sheds a new completion 503 ``draining`` and
   lets the running one finish with 512 tokens, and the undrain makes
   ``/readyz`` 200 again; a drain of ``timeout_s`` 0.5 answers its
   straggler 408 and frees its slot. Then the server as a process
   (``python -m ...serving.server --device cuda``): the seconds until
   ``/readyz`` answers 200, the client's time to the first chunk of a
   stream and the gaps between its chunks, SIGTERM during a long
   completion and a long stream, which must answer 200 with every token
   and end with the finish chunk and ``[DONE]`` after every token, and the
   seconds from SIGTERM to the process's exit (0, within
   ``--drain-timeout``). Over the paged bf16 engine the server also
   answers the request fields (``n`` 3 with a seed, choice 0 the n=1
   answer; ``best_of`` 4 with ``n`` 2; ``echo`` with ``logprobs`` 2; a
   ``stop`` string's cut), each 200 in the JAX server's shape, and the
   streaming API (a greedy stream and a streamed chat equal to their
   whole answers; a seeded ``n`` 2 stream with ``include_usage``; a stream
   cut by a stop string; a ``logprobs`` 2 stream whose records are the
   whole answer's); the failover continuation runs over that engine and a
   second one with the same weights and ``derived_seed`` (a stream cut
   after 5 chunks on one server and continued on the other, greedy and
   seeded, must splice into the undisturbed stream, or part from it only
   where its top-2 logit margin is below LOGIT_TOL); the C22 probe
   compares one prompt's prefill in a batch of one and of three, stage by
   stage; and then the request fields phase runs on that engine: a batch
   of 8 requests of 64 tokens (plain, presence + frequency, repetition,
   a +100 and a -100 bias, min_tokens 16 with a stop id, logprobs 8, a
   seeded sampled one with a penalty) with launch counts zeroed before and
   read after (K1 and the fused K2 layers x forwards, every decode
   dispatch a replay), forced and banned tokens, no stop id before
   min_tokens, sorted logprob records, prompt logprobs, a neutral request
   bit-identical to the bare one, each new decode graph variant's replay
   bit-identical to eager ``decode_steps`` from the same state (the pool
   rewritten unchanged outside the scratch page), a verify beside a
   logprobs slot that it skips, and one horizon-8 dispatch of 8 slots
   profiled per variant (default, penalties, logprobs, both);
5. checkpoint: loading and warmup at the published width of Qwen3-0.6B
   (28 layers, hidden 1024, vocab 151,936, tied, bf16). An HF directory of
   seeded random weights is written here (config.json without
   ``_name_or_path``, two safetensors shards whose bytes this script
   writes itself, no tokenizer files); ``config_from_hf_dir`` must give
   the registry's QWEN3_0_6B (but the name, hf_repo and the bos id, which
   the qwen3 branch does not read); ``load_checkpoint_cached`` loads it
   onto the card twice, a miss (conversion and cache write, timed apart)
   and a hit, each leaf bit for bit the written weights, with the load's
   peak device memory; an engine of the loaded tree and one of a tree
   built here from the same weights give the same greedy streams (3
   prompts x 32 tokens, one chunked; K1 decode and ragged and the fused K2
   must launch); ``python -m ...serving.aot`` writes the memory-fit
   manifest of the server's configuration; the server process over the
   directory adopts it and warms up, and runs again with ``--no-warmup``:
   each time the seconds to ``/readyz`` 200, the first streamed chunk of
   the first and later requests, ``tpu_serve_compile_seconds_total``, and
   greedy answers equal to the engine's; a manifest whose ``max_len`` was
   edited stops the server with a non-zero exit before warmup. The
   manifest and the warmed run carry ``--lora a=DIR`` (a peft adapter
   written here): ``/v1/models`` lists ``a``, ``model: "a"`` answers and
   ``response_format: json_object`` parses, whole and streamed. The
   directory is removed at the end;
6. guided and LoRA (``phase_guided_lora``), Qwen3-0.6B at full width over
   the byte tokenizer's grammars: 4 unguided greedy requests, then beside
   them 4 guided ones (json_object, a json_schema with required keys and an
   enum, a regex, a choice) through ``mixed_step``, the decode graphs'
   always-on allow operand and the pipeline: every guided answer finishes
   and parses or matches, every neighbour's stream equals its stream
   beside unguided requests of the same lengths; the host's mask time a
   guided token, the allow words' cache hits, one default dispatch
   profiled. Then two peft adapters (r 16 and r 8, all seven targets)
   written here: a mixed batch (base, a, b, twice each) gives every slot
   its one-adapter run's greedy stream; one decode step of the adapter rows
   within LOGIT_TOL of a plain forward over the merged weights (the
   engine's int8 kernels dequantized + A.B in float32, rounded to bf16)
   and more than LORA_BASE_MIN x LOGIT_TOL from the base model's; no
   prefix hit across adapters; prompt lookup over adapter slots
   (K1-spec); one dispatch profiled, the graphs' capture time and memory.
   The launch counts are zeroed just before the guided run, the mixed
   adapter batch and the prompt-lookup run, and read just after each: K1
   once a layer of every paged forward, its chunk body, the fused K2 once
   a layer of every forward, K1-spec in the verifies, the int8 pool's
   kernels never;
7. prefix, once per KV pool: the prefix cache and the host KV tier at the
   defaults (prefix cache on, a 256 MiB host tier, the pipeline and the
   decode graphs on), Qwen3-0.6B at full width with the pool cut to 68
   pages: A (a 1,536-token history and a 64-token tail) cold, A again (a
   resident hit), 8 requests sharing the history, fillers until A's pages
   have left the pool for the host tier, A once more (restored): the warm
   and restored streams equal the cold one, the restored pages equal a
   snapshot of A's pages bit for bit, the 8 hits' first-token logits are
   held against a ``prefix_cache=False`` engine, the counts follow the
   schedule, one replay per decode dispatch, every ragged launch's chunk
   rows through the chunk body, K1's ragged entry (8 decode rows and a
   64-row chunk) held against its plain version within one bf16 ulp a row
   over tables whose leading pages are shared;
   time to first token of A cold, resident and restored, and the
   restore's bytes and device time. The phases that run one prompt twice
   on an engine and compare the runs (the seeded check of 3, the pipeline
   phase, spec, sp) turn the prefix cache off, so that both runs prefill
   alike;
8. spec, once per KV pool: prompt-lookup speculative decoding
   (``spec_decode=True``) at full width on repeated-pattern prompts, with
   its launch counts zeroed just before and read just after (verify
   dispatches, drafts and the verify kernel of that pool required); a
   seeded sampled request gives the same stream with spec on and off (the
   engine serves sampled slots from the plain step only). One
   verify dispatch of 8 slots is held against plain decode steps of the
   same prefixes (logits within LOGIT_TOL, the emitted tokens the accept
   rule on the verify's argmax), then timed and profiled;
9. draft: ``spec_method="draft"`` with a self-draft and a divergent draft of
   the same width over the dense cache; a second wave of chunked prompts
   puts the drafts behind so that they catch up. The dense kernels must
   have launched, the fused writes once a layer of every target and draft
   forward (the draft's rollout substeps and catch-ups), and the
   self-draft must have accepted drafts;
10. the window instances (after the kernels phase): K1 (decode, ragged,
   verify; bf16 and int8 pools), K4, K7 and K5 (4 slots per CTA; bf16 and
   int8 dense caches) at Mistral-7B-v0.1's shapes with its window of 4096,
   each held against its plain version and timed (the ragged call's 512
   chunk rows through the chunk body, within one bf16 ulp a row), the fused
   row write without the norm (RoPE only) at the decode's 16 rows (paged
   and dense), the
   ragged call and the dense ones also with NaN pages or rows (int8:
   scales) outside their rows' ranges, which must change nothing; and K1
   at window 0 against window 4096 on rows of ~8000 columns;
11. Mistral-7B-v0.1 at full width (32 layers, window 4096, int8 weights, 16
   slots of 8192 rows, prefill_chunk 512), once per KV pool: the engine
   with launch counts (window instances only, the chunk body's among
   them), one decode step's logits
   at lengths past the window held against the plain versions and against
   window 0, one decode dispatch profiled, the server; then prompt lookup
   (the verify's window instance) and a self-draft (K4 and K7's);
12. the dense engine (``ServingConfig(paged=False)``, every slot's window
   of rows reserved, prefill_chunk 256 so that long prompts take the dense
   chunk walk): Qwen3-0.6B at full width with bf16 KV and decode_bblock 4
   (K8, K5), then with int8 KV (K9, K4-int8; seeded sampled streams alone
   and beside others; the server; the pipeline phase as in 3), each with
   one decode dispatch profiled and a decode step's logits held against
   the plain versions; prompt lookup
   over int8 KV with decode_bblock 4 (K7-int8, K9, K5-int8); and
   Mistral-7B-v0.1 at full width on a dense int8 cache of 16 x 8192 rows
   with decode_bblock 4 (K5-int8's window instance, K9; logits held as in
   10). Every dense forward (decode substep, verify) writes its rows
   through K8 or K9 with the q/k prologue fused in, once a layer, and the
   standalone K8/K9 never launch; the paged kernels' counts must be 0;
13. sequence-parallel serving (after the window kernels, the kernels phase
   "kernels, sp"): K6, the stats form of the dense decode, bf16 and int8,
   over every shard of a dense cache [28, 4, 8, 32768, 128] split into 4
   and into 2 sequence shards, against its plain version (the empty
   shards exactly (0, -1e30, 0)), the shards merged as the engine merges
   them against K4 (int8: K4-int8) over the whole cache by the ulp rule,
   timed beside its plain version and a memory-efficient attention call
   that returns the log-sum-exp, and the fused dense write into one shard
   (one slot's row kept, three dropped); then Qwen3-0.6B at full width
   (its depth cut to SP_LAYERS, 8 of 28) with 4 slots of 32768 rows,
   prefill_chunk 512 and prompts of about 40, 6,000, 14,000 and 27,000
   tokens (32 new tokens each): the dense engine
   without a mesh (the yardstick), then ``Engine(..., mesh=)`` over
   ``[cuda:0] * sp`` with bf16 KV at sp 4 and sp 2 and int8 KV at sp 4
   (with a seeded sampled request, drawn twice), each with launch counts
   zeroed just before and read just after (K6 and the fused row write
   ``L x sp`` times per decode substep, no other kernel), one decode step of
   all 4 slots held against the plain versions, the bf16 greedy streams
   compared with the yardstick's, and the HTTP server over the int8 one;
14. the other dense families (``phase_kernels_families`` after "kernels,
   sp", ``phase_families`` after the Mistral phases): Llama-3.2-1B (D 64,
   G 4, llama3 RoPE), gemma-2b (D 256, MQA G 8), phi-2 (D 80, RoPE over
   32 columns, MHA) and opt-1.3b (D 64, no RoPE). First each kernel of
   their paths at their shapes against its plain version (the fused write
   at RoPE over all of D, 32 of 80 columns and none, paged and dense, bf16
   and int8; K1, its ragged entry with a 256-row chunk (the chunk body's
   D 256 instance for gemma, timed beside the per-row route), K1-spec, K4,
   K5 and K7). Then each family at its registered full width, its depth
   cut to FAMILY_LAYERS (8), on seeded random int8 weights: the default
   ServingConfig (8 slots, prefill_chunk 256), 8 greedy requests of
   prompts from 9 up to 700
   tokens (up to 1,900 for phi and opt), logits held against the plain
   path and one horizon-8 dispatch profiled; phi and gemma again with
   int8 KV, with prompt lookup and with a self-draft over the dense bf16
   cache at 4 slots per CTA; Llama on the dense engine with int8 KV at 4
   slots per CTA and with a self-draft beside the paged pool. Each run's
   launch counts are zeroed just before it and read just after, and every
   family instance of the kernels line must have launched in its run.
15. Qwen3-30B-A3B (MoE; ``phase_kernels_moe`` after "kernels, families",
   ``phase_moe`` after the families): first both MoE kernels at its widths
   (H 2048, expert width 768, 128 experts, top 8) over one layer's bf16 and
   int8 experts, against their plain versions, at 8 and 32 decode tokens,
   a verify of 32 x 5, a mixed dispatch of 32 + 512 rows, every token on
   the same 8 experts, only even experts live, router ties and a batch
   prefill of 2048 tokens: the
   route-and-sort's experts, offsets, sorted rows and positions exact and
   its weights within one bf16 ulp; the grouped gate + up (silu(g) * u)
   and down products within one bf16 ulp a row (the count of outputs that
   differ from plain at all printed); each timed beside its
   plain version, its bound and ``torch._grouped_mm`` on bf16 weights (a
   per-expert matmul loop where the card's torch lacks it). Then the model
   at full width and depth (48 layers) on seeded weights drawn and
   quantized to int8 layer by layer (the peak device memory before the
   engine printed, under 35 GB), the default ServingConfig with 8 slots:
   8 greedy requests of 9 to 700 tokens, one decode step's logits against
   the plain path (the MoE MLP's plain versions included), one horizon-8
   dispatch profiled (the grouped kernel's share of device time), one
   eager forward profiled with shapes (no copy or cast of an expert
   stack); then prompt lookup over the same weights (verify rows through
   the MoE kernels), and the bf16 instances at full width with the depth
   cut to 4 layers (bf16 weights). The MoE kernels must have launched once
   a layer of every forward of each run, in the weights' instance.
16. mesh, last (``phase_mesh``): tensor, data and expert parallel serving
   on the paged engine, every mesh position on this card (two cards take
   (a)'s tp shards on cards 0 and 1 as well): (a) Qwen3-8B over tp 2 at
   full width and depth, plain and with prompt lookup, (b) Qwen3-0.6B over
   dp 2 x tp 2 with prompt lookup, each against the same weights on the
   engine without a mesh (first-token logits within MESH_LOGIT_TOL, greedy
   streams equal up to the first draw whose unmeshed top-2 margin is
   below it; K1, K1-spec and the fused K2 once a layer on every shard's
   pool for every forward; (b): every slot's pages in its own group's
   partition after every step), (c) Qwen3-30B-A3B at 4 layers over ep 2
   x tp 2, the gshard forward against gshard whole on the card, and (d)
   the checkpoint phase's Qwen3-0.6B directory loaded under tp 2, every
   shard leaf its whole load's slice bit for bit. The kernels line adds
   ``mesh_launches`` to the rows whose instance the mesh runs launched.

Every phase logs its wall time. The line before the last is
``{"kernels": [...]}``; the last is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gc
import http.client
import json
import math
import os
import re
import socket
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor cores
PEAK_F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
ATTN_SRC = "aws_k8s_ansible_provisioner_tpu_torch/csrc/paged_attention.cu"
WRITE_SRC = "aws_k8s_ansible_provisioner_tpu_torch/csrc/cache_write.cu"
DENSE_SRC = "aws_k8s_ansible_provisioner_tpu_torch/csrc/dense_attention.cu"
MERGE_SRC = "aws_k8s_ansible_provisioner_tpu_torch/csrc/split_merge.cu"
CHUNK_SRC = "aws_k8s_ansible_provisioner_tpu_torch/csrc/split_chunk.cuh"
TPU_KERNELS = "aws_k8s_ansible_provisioner_tpu/ops/pallas_attention.py"
# bf16 kernel vs plain, per query row (its Hq x D outputs): both compute in
# float32 and round once to bf16, so an element differs by at most one ulp
# of itself. With u the bf16 ulp of the row's max |plain output|, each row
# must hold max |diff| <= ATTN_MAX_ULPS * u and mean |diff| <=
# ATTN_MEAN_ULPS * u. A row that loses or gains one live column moves its
# mean by about |v| / limit, tens of ulps for the rows of these cases.
ATTN_MAX_ULPS, ATTN_MEAN_ULPS = 4.0, 0.5
# the ragged entry's calls with the chunk layout: every row (the decode
# rows through the per-row body, the chunk's through the chunk body, whose
# P.V keeps 16 bits of p) within one bf16 ulp of plain, mean 0.5
CHUNK_MAX_ULPS = 1.0
# one decode step of the 28-layer bf16 model, kernels vs plain versions:
# the attention outputs differ by one bf16 rounding, which the residual
# stream carries through 28 layers into logits of magnitude ~3 (max abs
# 0.039 measured with the bf16 pool on an H100 80GB HBM3, 700 W). The int8
# pool changes nothing in that: both steps start from the same pool, the
# quantizing write is bit-exact on equal rows, and the attention output
# again differs by one bf16 rounding (0.039 again with the int8 pool, same
# card).
LOGIT_TOL = 0.1
# one decode step of Mistral-7B-v0.1 (32 layers), kernels vs plain versions:
# the same one-bf16-rounding differences in the attention outputs as above
# (each layer's held to the ulp rule in the step itself), but random
# Mistral-7B weights amplify them much more through 32 layers: max abs
# 0.625 against a max |logit| of 5.875, where the window's own effect
# (window 0 against 4096) moved the logits by 7.19 (H100 80GB HBM3, 700 W)
MISTRAL_LOGIT_TOL = 2.0
# random Mistral-7B weights, also with the head holding the embedding's rows,
# give a greedy stream in which prompt lookup finds no n-gram (measured on an
# H100); with the embedding 1000 times larger the current token's embedding
# (|E[t]|^2 = 1.6 at std 0.02) outweighs what 32 layers add to the head's
# reading, and the stream repeats its token
REPEAT_EMBED_SCALE = 1000.0
# sampled requests of the int8 engine run
SAMPLED = dict(temperature=0.8, top_p=0.9, top_k=20, ignore_eos=True)
# query rows per slot of a verify: the default spec_k 4, plus the last token
SPEC_R = 5


def log(msg: str) -> None:
    print(msg, flush=True)


def hold_stream(torch, seconds: float) -> None:
    """Keep the current stream busy for about ``seconds`` (a spinning
    kernel, at most 50 ms), so that the host can queue a timed run's calls
    before the device starts them."""
    torch.cuda._sleep(int(min(seconds, 0.05) * 2e9))   # ~2e9 cycles a s


def timed_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of one call, by CUDA events around ``iters`` back-to-back
    calls: the device's time, or the host's where a call's wrapper takes
    longer on the host than its work on the device."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call: CUDA events over ``iters`` calls
    queued behind :func:`hold_stream`, so that they time the device's
    back-to-back work and not the host's wrappers."""
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    host = (time.perf_counter() - t0) / warmup
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    hold_stream(torch, 2 * iters * host + 1e-3)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _bf16_ulp(torch, x):
    """bf16 ulp of each value of ``x`` (8 significant bits)."""
    e = torch.floor(torch.log2(x.clamp_min(1e-30)))
    return torch.exp2(e - 7)


def phase_build():
    from aws_k8s_ansible_provisioner_tpu_torch.ops import cuda_build

    t0 = time.monotonic()
    secs = cuda_build.build_kernels()
    log(f"[build] nvcc {cuda_build.nvcc_path()}: "
        + ", ".join(f"{k} {v:.1f}s" for k, v in secs.items())
        + f"; wall {time.monotonic() - t0:.1f}s")
    for name, text in cuda_build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"[build] {name}: {line.strip()}")


def _paged_kv(torch, np, pools, table, lo, hi, layer):
    """For an SDPA yardstick: each row's visited pages lo..hi gathered dense
    (int8 dequantized to bf16) as K/V [N, Hkv, S, D], beside the columns'
    positions [N, S] and whether each was visited [N, S]."""
    from aws_k8s_ansible_provisioner_tpu_torch.serving.kv_cache import \
        dequantize

    dev = table.device
    _, P, Hkv, ps, D = pools["k"].shape
    N = len(lo)
    n_vis = int((hi - lo).max()) + 1
    c = torch.from_numpy(lo[:, None] + np.arange(n_vis)).to(dev)
    hi_t = torch.from_numpy(hi).to(dev)[:, None]
    pages = table.long().gather(1, torch.minimum(c, hi_t)).clamp(0, P - 1)

    def dense(name):
        g = pools[name][layer][pages]              # [N, n_vis, Hkv, ps, D]
        if "ks" in pools:
            g = dequantize(g, pools[name + "s"][layer][pages], torch.bfloat16)
        return g.permute(0, 2, 1, 3, 4).reshape(N, Hkv, n_vis * ps, D)

    col = (c[:, :, None] * ps + torch.arange(ps, device=dev)).reshape(N, -1)
    visited = (c <= hi_t).repeat_interleave(ps, dim=1)
    return dense("k"), dense("v"), col, visited


def _sdpa_ms(torch, q4, kd, vd, col, lim, window, visited=None):
    """Yardstick: one SDPA call over K/V gathered dense beforehand, the
    G (or R * G) query rows of a kv head as SDPA's query axis (GQA without
    copies). q4 [N, Hkv, M, D]; kd/vd [N, Hkv, S, D]; col [N, S] the
    columns' positions; lim [N, M] each query row's limit; the mask (built
    outside the timed call) keeps [lim - window, lim), or [0, lim) at
    window 0, of the visited columns."""
    live = col[:, None, :] < lim[:, :, None]
    if window > 0:
        live &= col[:, None, :] >= lim[:, :, None] - window
    if visited is not None:
        live &= visited[:, None, :]
    mask = torch.where(live, 0.0, -1e30).to(q4.dtype)[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return timed_ms(torch, lambda: sdpa(q4, kd, vd, attn_mask=mask))


def _live_cols(np, limits, window):
    """Live columns of rows with these limits: [limit - window, limit)."""
    live = np.maximum(limits, 0)
    return np.minimum(live, window) if window > 0 else live


def _attention_case(torch, np, pools, limits_np, table_np, layer, label,
                    hq=16, window=0, chunk_start=None):
    """Hold the attention kernel against its plain version; time both, an
    SDPA over the gathered K/V, and the bound. ``pools`` holds bf16 "k"/"v",
    or int8 "k"/"v" with float32 scales "ks"/"vs" (the int8 instance);
    ``window`` > 0 takes the window instance; ``chunk_start`` (the ragged
    entry's chunk layout: the rows from there on are one chunk of one slot)
    sends those rows through the chunk body, held to CHUNK_MAX_ULPS, and the
    rows before it through the per-row body. Returns a result dict."""
    from aws_k8s_ansible_provisioner_tpu_torch.ops import paged_attention as pa
    from aws_k8s_ansible_provisioner_tpu_torch.ops import split_kv

    pool_k, pool_v = pools["k"], pools["v"]
    quant = "ks" in pools
    scales = (pools["ks"], pools["vs"]) if quant else ()
    name = "paged_attention_quant" if quant else "paged_attention"
    dev = pool_k.device
    _, P, Hkv, ps, D = pool_k.shape
    N = len(limits_np)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    q = torch.randn((N, hq, D), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    limits = torch.from_numpy(limits_np.astype(np.int32)).to(dev)
    table = torch.from_numpy(table_np.astype(np.int32)).to(dev)

    def kernel():
        if quant:
            return pa.paged_attention_quant(q, pool_k, pool_v, *scales,
                                            limits, layer, table, window,
                                            chunk_start)
        return pa.paged_attention(q, pool_k, pool_v, limits, layer, table,
                                  window, chunk_start)

    fn = pa.paged_attention_quant if quant else pa.paged_attention
    chunks0 = fn.form_launches["chunk"]
    out = kernel()
    if chunk_start is not None and fn.form_launches["chunk"] != chunks0 + 1:
        raise AssertionError(f"{name} {label}: the chunk body did not launch")
    ref = pa.paged_attention_plain(q, pool_k, pool_v, limits, layer, table,
                                   *scales, window=window)
    torch.cuda.synchronize()
    what = f"{name} {label}" + ("" if chunk_start is None else
                                f", chunk body from row {chunk_start}")
    check = _ulp_rows(torch, what, out, ref, N,
                      lambda bad: f"limits {limits_np[bad].tolist()}",
                      ATTN_MAX_ULPS if chunk_start is None
                      else CHUNK_MAX_ULPS)
    ms = timed_ms(torch, kernel)
    dev_ms = device_ms(torch, kernel)
    plain_ms = timed_ms(torch, lambda: pa.paged_attention_plain(
        q, pool_k, pool_v, limits, layer, table, *scales, window=window),
        iters=5, warmup=1)
    lo, hi = (t.cpu().numpy() for t in pa._live_pages(
        limits, ps, table_np.shape[1], window))
    kd, vd, col, visited = _paged_kv(torch, np, pools, table, lo, hi, layer)
    library_ms = _sdpa_ms(torch, q.reshape(N, Hkv, hq // Hkv, D), kd, vd,
                          col, limits.long()[:, None], window, visited)
    del kd, vd
    # bound: each input byte read once (K/V pages the rows visit, and their
    # scales, counted once per distinct (page, kv head) tile; the table
    # entries of the visited pages), each output byte written once;
    # operations: QK^T and PV over the live columns
    tiles = {int(table_np[n, c]) for n in range(N)
             for c in range(lo[n], hi[n] + 1)}
    tile = Hkv * ps * (D * pool_k.element_size() + (4 if quant else 0))
    nbytes = (2 * len(tiles) * tile + 2 * N * hq * D * 2
              + N * 4 + int((hi - lo + 1).sum()) * 4)
    ops = 4 * hq * D * int(_live_cols(np, limits_np, window).sum())
    sms = split_kv.sm_count(dev)
    if chunk_start is None:
        splits, extra = split_kv.split_count(N, Hkv, table_np.shape[1],
                                             sms), ""
    else:
        # the decode rows' split count, and the chunk body's per row tile
        C = N - chunk_start
        splits = split_kv.split_count(chunk_start, Hkv, table_np.shape[1],
                                      sms)
        chunk_splits = split_kv.chunk_splits(C, hq // Hkv, Hkv,
                                             table_np.shape[1], sms, D)
        extra = (f"; chunk body: {C} rows in "
                 f"{split_kv.chunk_tiles(C, hq // Hkv)} row tiles x {Hkv} kv "
                 f"heads, {chunk_splits} splits")
    res = _report(what, check, ms, dev_ms, plain_ms, library_ms, nbytes,
                  ops, N, splits, extra)
    if chunk_start is not None:
        res["chunk_splits"] = chunk_splits
    return res


def _ulp_rows(torch, what, out, ref, n_rows, describe,
              max_ulps=ATTN_MAX_ULPS):
    """The attention kernels' tolerance, query row by query row (each row's
    Hq x D outputs): max |diff| <= ``max_ulps`` and mean |diff| <=
    ATTN_MEAN_ULPS bf16 ulps of the row's largest |plain output|.
    ``describe(bad row indices)`` names the failing rows' inputs."""
    diff = (out.float() - ref.float()).abs().reshape(n_rows, -1)
    max_err, mean_err = float(diff.max()), float(diff.mean())
    ulp = _bf16_ulp(torch, ref.float().abs().reshape(n_rows, -1).amax(1))
    row_max = diff.amax(1) / ulp
    row_mean = diff.mean(1) / ulp
    worst_max, worst_mean = float(row_max.max()), float(row_mean.max())
    if not (math.isfinite(max_err) and worst_max <= max_ulps
            and worst_mean <= ATTN_MEAN_ULPS):
        bad = torch.nonzero((row_max > max_ulps)
                            | (row_mean > ATTN_MEAN_ULPS)).flatten()[:8]
        raise AssertionError(
            f"{what}: rows {bad.tolist()} ({describe(bad.cpu().numpy())}) "
            f"past tolerance: worst row max {worst_max:.2f} ulp (tol "
            f"{max_ulps}), worst row mean {worst_mean:.3f} ulp (tol "
            f"{ATTN_MEAN_ULPS})")
    return {"max_abs_err": max_err, "mean_abs_err": mean_err,
            "worst_row_max_ulps": worst_max, "worst_row_mean_ulps": worst_mean,
            "tol_max_ulps": max_ulps}


def _report(what, check, ms, dev_ms, plain_ms, library_ms, nbytes, ops,
            rows, splits, extra=""):
    """One attention case's result: the check, the times, the bound (the
    larger of bytes over the memory rate and operations over the bf16
    tensor-core rate) and the kernel's split count."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_BF16_OPS_PER_S
    res = {**check, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": 1e3 * max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes, "rows": rows, "splits": splits}
    log(f"[kernels] {what}: rows {rows}, splits {splits}, max abs "
        f"{check['max_abs_err']:.3e}, "
        f"mean abs {check['mean_abs_err']:.3e}; worst row: max "
        f"{check['worst_row_max_ulps']:.2f} ulp, mean "
        f"{check['worst_row_mean_ulps']:.3f} ulp (tol "
        f"{check.get('tol_max_ulps', ATTN_MAX_ULPS)}/"
        f"{ATTN_MEAN_ULPS}); kernel_ms {ms:.4f} device_ms {dev_ms:.4f} "
        f"plain_ms {plain_ms:.4f} "
        f"library_ms {library_ms:.4f} bound_ms {res['bound_ms']:.4f} "
        f"({nbytes / 1e6:.1f} MB, {100 * res['bound_ms'] / ms:.1f}% of "
        f"bound){extra}")
    return res


def _write_case(torch, np, pools, rows_np, table_np, layer, label):
    """Hold the row-write kernel against its plain version, bit for bit on
    the whole pool (and, int8, the whole scale pools); time both, a PyTorch
    yardstick and the bound. ``pools`` as in :func:`_attention_case`."""
    from aws_k8s_ansible_provisioner_tpu_torch.ops import paged_attention as pa
    from aws_k8s_ansible_provisioner_tpu_torch.serving.kv_cache import \
        quantize_rows

    quant = "ks" in pools
    names = ("k", "v", "ks", "vs") if quant else ("k", "v")
    leaves = [pools[n] for n in names]
    name = "cache_write_rows_quant_paged" if quant else \
        "cache_write_rows_paged"
    kernel_fn = getattr(pa, name)
    plain_fn = getattr(pa, name + "_plain")
    dev = leaves[0].device
    _, P, Hkv, ps, D = leaves[0].shape
    N = len(rows_np)
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    k_new = torch.randn((N, Hkv, D), generator=gen, device=dev,
                        dtype=torch.bfloat16)
    v_new = torch.randn((N, Hkv, D), generator=gen, device=dev,
                        dtype=torch.bfloat16)
    rows = torch.from_numpy(rows_np.astype(np.int32)).to(dev)
    table = torch.from_numpy(table_np.astype(np.int32)).to(dev)
    refs = [t.clone() for t in leaves]
    kernel_fn(*leaves, k_new, v_new, rows, layer, table)
    plain_fn(*refs, k_new, v_new, rows, layer, table)
    torch.cuda.synchronize()
    for n, got, want in zip(names, leaves, refs):
        if not torch.equal(got, want):
            raise AssertionError(f"{name} {label}: pool leaf {n!r} differs "
                                 f"from the plain version")
    del refs
    ms = timed_ms(torch, lambda: kernel_fn(*leaves, k_new, v_new, rows,
                                           layer, table))
    dev_ms = device_ms(torch, lambda: kernel_fn(*leaves, k_new, v_new, rows,
                                                layer, table))
    plain_ms = timed_ms(torch, lambda: plain_fn(*leaves, k_new, v_new, rows,
                                                layer, table),
                        iters=5, warmup=1)
    ok = (rows_np >= 0) & (rows_np < table_np.shape[1] * ps)
    sel = np.nonzero(ok)[0]
    pg = torch.from_numpy(table_np[sel, rows_np[sel] // ps].astype(
        np.int64)).to(dev)
    off = torch.from_numpy((rows_np[sel] % ps).astype(np.int64)).to(dev)
    heads = torch.arange(Hkv, device=dev)
    lay = torch.full_like(pg, layer)
    idx = (lay[:, None], pg[:, None], heads[None, :], off[:, None])
    sel_t = torch.from_numpy(sel).to(dev)
    ks, vs = k_new[sel_t], v_new[sel_t]

    def library():
        # bf16: the index_put_ pair; int8: quantize, then the index_put_
        # pair of the rows and the pair of their scales
        if quant:
            (kq, kss), (vq, vss) = quantize_rows(ks), quantize_rows(vs)
            pools["ks"].index_put_(idx, kss)
            pools["vs"].index_put_(idx, vss)
        else:
            kq, vq = ks, vs
        pools["k"].index_put_(idx, kq)
        pools["v"].index_put_(idx, vq)

    library_ms = timed_ms(torch, library)
    # bound: the kept rows' new K/V read once and their pool rows (and
    # scales) written once, the rows array read once, one table entry read
    # per kept row (a dropped row needs no more than its index)
    out_row = D * leaves[0].element_size() + (4 if quant else 0)
    nbytes = (2 * len(sel) * Hkv * D * 2 + 2 * len(sel) * Hkv * out_row
              + N * 4 + len(sel) * 4)
    res = {"max_abs_err": 0.0, "mean_abs_err": 0.0, "ms": ms,
           "device_ms": dev_ms, "plain_ms": plain_ms,
           "library_ms": library_ms,
           "bound_ms": 1e3 * nbytes / PEAK_BYTES_PER_S, "bound_by": "bytes",
           "bytes": nbytes, "rows": N}
    log(f"[kernels] {name} {label}: rows {N} ({len(sel)} kept), bit-exact"
        f"{' (int8 rows and scales)' if quant else ''}; kernel_ms {ms:.4f} "
        f"device_ms {dev_ms:.4f} "
        f"plain_ms {plain_ms:.4f} library_ms {library_ms:.4f} "
        f"({'quantize + ' if quant else ''}index_put_ K and V) bound_ms "
        f"{res['bound_ms']:.5f} ({nbytes / 1e6:.2f} MB)")
    return res


def _graph(torch, fn):
    """``fn`` captured as a CUDA graph (after warm-up calls on a side
    stream); returns the graph's replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    torch.cuda.synchronize()
    return graph.replay


def _prep_case(torch, np, pools, rows_np, table_np, positions_np, layer,
               label, hq, theta, norm, standalone=None, rot=None, cfg=None):
    """The fused q/k prologue and row write against its plain version
    (``models/layers.prep_qk_plain`` then the standalone write) on raw
    q/k/v rows at ``positions_np``: over a page pool (``table_np`` given:
    K2, or K3 over an int8 pool; packed rows [N]) or a dense cache
    (``table_np`` None: K8, or K9 over an int8 cache; rows [B, R]). q and
    the written k rows within one bf16 ulp of their head row's largest
    |plain value| per element (the share bit-identical reported), v
    bit-exact; int8: v's codes and scales bit-exact, k's codes within 1 and
    scales within 2^-8 relative, and bit-identical wherever the kernel's
    bf16 k row (its bf16 instance, into a scratch cache of one row per
    packed row) is. Timed eagerly (ms, device_ms), as one CUDA graph replay
    (graph_ms), beside the plain chain eagerly (plain_ms) and as one CUDA
    graph replay (chain_graph_ms, the yardstick), and its bound: the larger
    of the bytes over the memory rate and the prologue's float32 operations
    over the card's float32 rate. ``standalone``: the standalone write's
    case (:func:`_dense_write_case`) whose times the row keeps beside its
    own (``standalone_ms``, ``standalone_device_ms``). ``rot``: the
    rotary width (default the head dim; 0 for no RoPE), ``cfg`` a config
    whose llama3 frequency scaling the tables take."""
    from aws_k8s_ansible_provisioner_tpu_torch.models.layers import (
        QKPrep, prep_qk_plain, rope_cos_sin)
    from aws_k8s_ansible_provisioner_tpu_torch.ops import dense_attention as da
    from aws_k8s_ansible_provisioner_tpu_torch.ops import paged_attention as pa

    quant = "ks" in pools
    dense = table_np is None
    mod = da if dense else pa
    names = ("k", "v", "ks", "vs") if quant else ("k", "v")
    leaves = [pools[n] for n in names]
    name = "prep_write_rows" + ("_quant" if quant else "") + \
        ("_dense" if dense else "_paged")
    kernel_fn, plain_fn = getattr(mod, name), getattr(mod, name + "_plain")
    chain_write = getattr(mod, name.replace("prep_write", "cache_write"))
    dev = leaves[0].device
    _, P, Hkv, ps, D = leaves[0].shape
    lead = rows_np.shape                       # [N] paged, [B, R] dense
    N = rows_np.size
    gen = torch.Generator(device=dev)
    gen.manual_seed(19)

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)
                ).to(torch.bfloat16)

    q, k, v = randn(*lead, hq, D, scale=3.0), randn(*lead, Hkv, D,
                                                    scale=3.0), \
        randn(*lead, Hkv, D)
    weights = (None, None)
    if norm:
        weights = tuple((1.0 + 0.1 * randn(D).float()).to(torch.bfloat16)
                        for _ in range(2))
    rot = D if rot is None else rot
    cos, sin = rope_cos_sin(torch.from_numpy(positions_np).to(dev), rot,
                            theta, cfg)
    prep = QKPrep(*weights, 1e-6, cos.contiguous(), sin.contiguous())
    rows = torch.from_numpy(rows_np.astype(np.int32)).to(dev)
    index = () if dense else (torch.from_numpy(table_np.astype(np.int32))
                              .to(dev),)
    args = (rows, layer) + index
    refs = [t.clone() for t in leaves]
    before = kernel_fn.launches
    got_q = kernel_fn(*leaves, q, k, v, *args, prep)
    if kernel_fn.launches != before + 1:
        raise AssertionError(f"{name} {label}: no launch counted")
    ref_q = plain_fn(*refs, q, k, v, *args, prep)
    _, ref_k = prep_qk_plain(q, k, prep)
    # the kernel's k rows after the prologue: its bf16 instance into a
    # scratch cache of one row per packed row
    if dense:
        B, R = lead
        scratch = [torch.zeros((1, B, Hkv, R, D), dtype=torch.bfloat16,
                               device=dev) for _ in range(2)]
        da.prep_write_rows_dense(
            *scratch, q, k, v,
            torch.arange(R, dtype=torch.int32, device=dev).expand(B, R)
            .contiguous(), 0, prep)
        torch.cuda.synchronize()
        got_k = scratch[0][0].transpose(1, 2)          # [B, R, Hkv, D]
        b_np, r_np = np.nonzero((rows_np >= 0) & (rows_np < ps))
        sel = torch.from_numpy(b_np * R + r_np).to(dev)
        kept = (layer, torch.from_numpy(b_np).to(dev)[:, None],
                torch.arange(Hkv, device=dev)[None],
                torch.from_numpy(rows_np[b_np, r_np].astype(np.int64))
                .to(dev)[:, None])
    else:
        scratch = [torch.zeros((1, N, Hkv, 1, D), dtype=torch.bfloat16,
                               device=dev) for _ in range(2)]
        pa.prep_write_rows_paged(
            *scratch, q, k, v, torch.zeros_like(rows), 0,
            torch.arange(N, dtype=torch.int32, device=dev)[:, None], prep)
        torch.cuda.synchronize()
        got_k = scratch[0][0, :, :, 0]
        sel, pg, off = (t.to(dev) for t in pa._kept_rows(rows, index[0], ps,
                                                          P))
        kept = (layer, pg[:, None], torch.arange(Hkv, device=dev)[None],
                off[:, None])

    def within_ulp(got, want):
        """(every element within one bf16 ulp of its head row's largest
        |want|, share of elements bit-identical, max abs diff)"""
        diff = (got.float() - want.float()).abs()
        top = want.float().abs().amax(-1, keepdim=True).clamp_min(1e-30)
        ulp = torch.exp2(torch.floor(torch.log2(top)) - 7)
        return (bool((diff <= ulp).all()),
                float((got == want).float().mean()), float(diff.max()))

    q_ok, q_same, q_err = within_ulp(got_q, ref_q)
    k_ok, k_same, k_err = within_ulp(got_k, ref_k)
    if not (q_ok and k_ok):
        raise AssertionError(f"{name} {label}: q (ok {q_ok}, max abs "
                             f"{q_err:.3e}) or k (ok {k_ok}, max abs "
                             f"{k_err:.3e}) past one bf16 ulp of its row")
    same_k = (got_k == ref_k).all(-1).reshape(N, Hkv)[sel]   # [kept, Hkv]

    def same_bits(a, b):
        """bit for bit (the window phase's pools hold NaN pages)"""
        ints = {1: torch.int8, 2: torch.int16, 4: torch.int32}
        dt = ints[a.element_size()]
        return torch.equal(a.view(dt), b.view(dt))

    def untouched_same(leaf, ref):
        """every row but the kept rows' k bit-identical to the plain
        version's"""
        other = leaf.clone()
        other[kept] = ref[kept]
        return same_bits(other, ref)

    if not all(same_bits(leaves[i], refs[i]) for i in ((1, 3) if quant
                                                       else (1,))):
        raise AssertionError(f"{name} {label}: v (or its scales) differs "
                             f"from the plain version")
    if quant:
        codes = int((leaves[0][kept].int() - refs[0][kept].int()).abs().max())
        rel = float(((leaves[2][kept] - refs[2][kept]).abs()
                     / refs[2][kept]).max())
        if codes > 1 or not rel <= 2.0 ** -8:
            raise AssertionError(f"{name} {label}: k codes off by {codes}, "
                                 f"scales by {rel:.3e} relative")
        k_rows = leaves[0][kept] == refs[0][kept]      # [kept, Hkv, D]
        k_scales = leaves[2][kept] == refs[2][kept]    # [kept, Hkv]
        if not (k_rows.all(-1) & k_scales)[same_k].all():
            raise AssertionError(f"{name} {label}: a bit-identical bf16 k "
                                 f"row quantized to other codes or scale")
        extra = {"code_max_diff": codes, "scale_max_rel": rel}
        untouched = untouched_same(leaves[0], refs[0]) and \
            untouched_same(leaves[2], refs[2])
    else:
        pool_ok, _, pool_err = within_ulp(leaves[0][kept], refs[0][kept])
        if not pool_ok:
            raise AssertionError(f"{name} {label}: the cache's k rows past "
                                 f"one bf16 ulp of the plain version's")
        extra = {"pool_k_max_abs_err": pool_err}
        untouched = untouched_same(leaves[0], refs[0])
    if not untouched:
        raise AssertionError(f"{name} {label}: a k row or scale that no "
                             f"kept row owns was written")
    err = max(q_err, k_err)
    mean_err = float((got_q.float() - ref_q.float()).abs().mean())
    del refs, scratch

    def kernel():
        return kernel_fn(*leaves, q, k, v, *args, prep)

    def chain():
        qc, kc = prep_qk_plain(q, k, prep)
        chain_write(*leaves, kc, v, *args)
        return qc

    ms = timed_ms(torch, kernel)
    dev_ms = device_ms(torch, kernel)
    plain_ms = timed_ms(torch, lambda: plain_fn(*leaves, q, k, v, *args,
                                                prep),
                        iters=5, warmup=1)
    graph_ms = timed_ms(torch, _graph(torch, kernel))
    chain_graph_ms = timed_ms(torch, _graph(torch, chain))
    n_kept = len(sel)
    out_row = D * leaves[0].element_size() + (4 if quant else 0)
    nbytes = (2 * N * hq * D * 2 + 2 * N * Hkv * D * 2 + 2 * N * rot * 4
              + (2 * D * 2 if norm else 0) + 2 * n_kept * Hkv * out_row
              + N * 4 + (0 if dense else n_kept * 4))
    # float32 operations of the prologue: RMSNorm (square, sum, scale,
    # weight) per q and k element, RoPE (two products, one sum) per rotated
    # one
    ops = N * (hq + Hkv) * ((4 * D if norm else 0) + 3 * rot)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_OPS_PER_S
    res = {"max_abs_err": err, "mean_abs_err": mean_err, "ms": ms,
           "device_ms": dev_ms, "plain_ms": plain_ms, "library_ms": None,
           "graph_ms": graph_ms, "chain_graph_ms": chain_graph_ms,
           "bound_ms": 1e3 * max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes, "rows": N, "q_identical_share": q_same,
           "k_identical_share": k_same,
           "k_rows_identical_share": float(same_k.float().mean()),
           **extra}
    if standalone is not None:
        res["standalone_ms"] = standalone["ms"]
        res["standalone_device_ms"] = standalone["device_ms"]
    log(f"[kernels] {name} {label}: rows {N} ({n_kept} kept), Hq {hq}, "
        f"D {D}, {'q/k norm + ' if norm else ''}RoPE over {rot} columns; "
        f"q, k within 1 bf16 ulp of "
        f"their row (bit-identical: q {q_same:.4f}, k {k_same:.4f} of "
        f"elements), v bit-exact"
        f"{', int8 codes within 1, scales within 2^-8, bit-identical on the '
           f'identical k rows' if quant else ''}; max abs err {err:.3e} "
        f"{extra}; "
        f"kernel_ms {ms:.4f} device_ms {dev_ms:.4f} graph_ms {graph_ms:.4f} "
        f"plain_ms {plain_ms:.4f} chain_graph_ms {chain_graph_ms:.4f} "
        f"bound_ms {res['bound_ms']:.5f} ({nbytes / 1e6:.3f} MB, "
        f"{ops / 1e6:.2f} MFLOP; {res['bound_by']})"
        + (f"; the standalone write alone: kernel_ms "
           f"{standalone['ms']:.4f} device_ms {standalone['device_ms']:.4f}"
           if standalone is not None else ""))
    return res


def _spec_case(torch, np, pools, lengths_np, table_np, layer, label, hq=16,
               window=0):
    """K1-spec: SPEC_R rows per slot against its plain version (the ulp
    rule row by row), timed beside the plain version, an SDPA over the
    gathered K/V and the bound; ``window`` > 0 takes the window instance."""
    from aws_k8s_ansible_provisioner_tpu_torch.ops import paged_attention as pa
    from aws_k8s_ansible_provisioner_tpu_torch.ops import split_kv

    quant = "ks" in pools
    name = "paged_attention_spec_quant" if quant else "paged_attention_spec"
    kw = {"pool_ks": pools["ks"], "pool_vs": pools["vs"]} if quant else {}
    pool_k, pool_v = pools["k"], pools["v"]
    dev = pool_k.device
    _, P, Hkv, ps, D = pool_k.shape
    R, B = SPEC_R, len(lengths_np)
    G = hq // Hkv
    max_pages = table_np.shape[1]
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    q = torch.randn((B, R, hq, D), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    lengths = torch.from_numpy(lengths_np.astype(np.int32)).to(dev)
    table = torch.from_numpy(table_np.astype(np.int32)).to(dev)

    def kernel():
        return pa.decode_attend_spec_paged(q, pool_k, pool_v, lengths, layer,
                                           table, **kw, window=window)

    def plain():
        return pa.paged_attention_spec_plain(q, pool_k, pool_v, lengths,
                                             layer, table, *kw.values(),
                                             window=window)

    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    what = f"{name} {label}"
    check = _ulp_rows(torch, what, out, ref, B * R,
                      lambda bad: f"lengths {lengths_np[bad // R].tolist()}")
    ms = timed_ms(torch, kernel)
    dev_ms = device_ms(torch, kernel)
    plain_ms = timed_ms(torch, plain, iters=5, warmup=1)
    # slot b's pages: from row 0's window start to row R - 1's last column
    lo = pa._live_pages(lengths + 1, ps, max_pages, window)[0].cpu().numpy()
    hi = pa._live_pages(lengths + R, ps, max_pages)[1].cpu().numpy()
    kd, vd, col, visited = _paged_kv(torch, np, pools, table, lo, hi, layer)
    q4 = q.reshape(B, R, Hkv, G, D).transpose(1, 2).reshape(B, Hkv, R * G, D)
    lim = (lengths.long()[:, None] + 1
           + torch.arange(R, device=dev)).repeat_interleave(G, dim=1)
    library_ms = _sdpa_ms(torch, q4, kd, vd, col, lim, window, visited)
    del kd, vd
    # bound: each visited (page, kv head) tile read once for all R rows,
    # and each slot's table entries of its visited pages
    tiles = {int(table_np[b, c]) for b in range(B)
             for c in range(lo[b], hi[b] + 1)}
    tile = Hkv * ps * (D * pool_k.element_size() + (4 if quant else 0))
    nbytes = (2 * len(tiles) * tile + 2 * B * R * hq * D * 2 + B * 4
              + int((hi - lo + 1).sum()) * 4)
    limits = lengths_np[:, None] + 1 + np.arange(R)[None, :]
    ops = 4 * hq * D * int(_live_cols(np, limits, window).sum())
    # one CTA takes a slot's R x G rows of a kv head: the split counts slots
    splits = split_kv.split_count(B * split_kv.verify_groups(R, G), Hkv,
                                  max_pages, split_kv.sm_count(dev))
    return _report(what, check, ms, dev_ms, plain_ms, library_ms, nbytes,
                   ops, B * R, splits)


def _dense_name(entry, quant, bb=1, window=0, stats=False):
    """Launch-count name of a dense attention kernel instance."""
    from aws_k8s_ansible_provisioner_tpu_torch.ops import dense_attention as da

    return da.instance_name(entry, quant, bb, window, stats)


def _dense_attention_case(torch, np, cache, lengths_np, layer, R, label,
                          hq=16, window=0, bb=1):
    """K4 (R = 1), K5 (R = 1, ``bb`` > 1 slots per CTA) or K7 (R = SPEC_R)
    over the dense cache, bf16 or int8 (``"ks" in cache``), against the
    plain version (the ulp rule row by row; a slot of length 0 must give
    exact zeros), timed beside the plain version, an SDPA over the slots'
    rows (int8 dequantized to bf16 beforehand) and the bound; ``window`` >
    0 takes the window instance. The bound counts the rows each slot needs
    (K5 reads its block's union of them)."""
    from aws_k8s_ansible_provisioner_tpu_torch.ops import dense_attention as da
    from aws_k8s_ansible_provisioner_tpu_torch.ops import split_kv
    from aws_k8s_ansible_provisioner_tpu_torch.serving.kv_cache import \
        dequantize

    ck, cv = cache["k"], cache["v"]
    quant = "ks" in cache
    scales = (cache["ks"], cache["vs"]) if quant else ()
    dev = ck.device
    _, B, Hkv, S, D = ck.shape
    G = hq // Hkv
    entry = da.decode_attend_dense if R == 1 else da.spec_attend_dense
    limits_np = lengths_np if R == 1 else lengths_np + 1
    gen = torch.Generator(device=dev)
    gen.manual_seed(19 + R)
    q = torch.randn((B, R, hq, D), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    lengths = torch.from_numpy(lengths_np.astype(np.int32)).to(dev)
    limits = torch.from_numpy(limits_np.astype(np.int32)).to(dev)
    kw = {"cache_ks": cache["ks"], "cache_vs": cache["vs"]} if quant else {}
    if bb > 1:
        kw["bblock"] = bb

    def kernel():
        return entry(q, ck, cv, lengths, layer, window, **kw)

    def plain():
        return da.dense_attention_plain(q, ck, cv, limits, layer, window,
                                        *scales)

    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    what = f"{_dense_name(entry.__name__, quant, bb)} {label}"
    check = _ulp_rows(torch, what, out, ref, B * R,
                      lambda bad: f"lengths {lengths_np[bad // R].tolist()}")
    zero = limits_np + R - 1 <= 0
    if zero.any() and out[torch.from_numpy(zero).to(dev)].any():
        raise AssertionError(f"{what}: a slot of length 0 is not zeros")
    ms = timed_ms(torch, kernel)
    dev_ms = device_ms(torch, kernel)
    plain_ms = timed_ms(torch, plain, iters=5, warmup=1)
    # slot b's rows: from row 0's window start to row R - 1's extent
    ext = np.clip(limits_np + R - 1, 0, S)
    start = np.maximum(limits_np - window, 0) if window > 0 \
        else np.zeros_like(ext)
    start = np.minimum(start, ext)
    n = max(int((ext - start).max()), 1)
    idx = torch.from_numpy(np.minimum(start[:, None] + np.arange(n),
                                      S - 1)).to(dev)
    slots = torch.arange(B, device=dev)[:, None]

    def gathered(name):
        g = cache[name][layer][slots, :, idx]            # [B, n, Hkv, (D)]
        if quant:
            g = dequantize(g, cache[name + "s"][layer][slots, :, idx],
                           torch.bfloat16)
        return g.permute(0, 2, 1, 3)

    kd, vd = gathered("k"), gathered("v")
    q4 = q.reshape(B, R, Hkv, G, D).transpose(1, 2).reshape(B, Hkv, R * G, D)
    lim = (limits.long()[:, None]
           + torch.arange(R, device=dev)).repeat_interleave(G, dim=1)
    col = torch.from_numpy(start[:, None] + np.arange(n)).to(dev)
    library_ms = _sdpa_ms(torch, q4, kd, vd, col, lim, window,
                          col < torch.from_numpy(ext).to(dev)[:, None])
    del kd, vd
    row = D * ck.element_size() + (4 if quant else 0)
    nbytes = (2 * int((ext - start).sum()) * Hkv * row
              + 2 * B * R * hq * D * 2 + B * 4)
    live = np.minimum(limits_np[:, None] + np.arange(R)[None, :], S)
    ops = 4 * hq * D * int(_live_cols(np, live, window).sum())
    # a verify splits each (slot, row group, kv head)
    cta_rows = B * split_kv.verify_groups(R, G) if R > 1 else B
    return _report(what, check, ms, dev_ms, plain_ms, library_ms, nbytes,
                   ops, B * R, da.attention_splits(cta_rows, Hkv, S, dev))


def _dense_write_case(torch, np, cache, rows_np, layer, label):
    """K8 (bf16 cache) or K9 (int8 cache and its scales) against its plain
    version, bit for bit on every leaf of the cache; timed beside the plain
    version, a PyTorch yardstick (int8: quantize_rows, then the
    ``index_put_`` pairs of the rows and of their scales) and the bound."""
    from aws_k8s_ansible_provisioner_tpu_torch.ops import dense_attention as da
    from aws_k8s_ansible_provisioner_tpu_torch.serving.kv_cache import \
        quantize_rows

    quant = "ks" in cache
    names = ("k", "v", "ks", "vs") if quant else ("k", "v")
    leaves = [cache[n] for n in names]
    name = "cache_write_rows_quant_dense" if quant else \
        "cache_write_rows_dense"
    kernel_fn = getattr(da, name)
    plain_fn = getattr(da, name + "_plain")
    ck = cache["k"]
    dev = ck.device
    _, B, Hkv, S, D = ck.shape
    R = rows_np.shape[1]
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    k_new, v_new = (torch.randn((B, R, Hkv, D), generator=gen, device=dev,
                                dtype=torch.bfloat16) for _ in range(2))
    rows = torch.from_numpy(rows_np.astype(np.int32)).to(dev)
    refs = [t.clone() for t in leaves]
    kernel_fn(*leaves, k_new, v_new, rows, layer)
    plain_fn(*refs, k_new, v_new, rows, layer)
    torch.cuda.synchronize()
    for n, got, want in zip(names, leaves, refs):
        if not torch.equal(got, want):
            raise AssertionError(f"{name} {label}: cache leaf {n!r} differs "
                                 f"from the plain version")
    del refs
    ms = timed_ms(torch, lambda: kernel_fn(*leaves, k_new, v_new, rows,
                                           layer))
    dev_ms = device_ms(torch, lambda: kernel_fn(*leaves, k_new, v_new, rows,
                                                layer))
    plain_ms = timed_ms(torch, lambda: plain_fn(*leaves, k_new, v_new, rows,
                                                layer), iters=5, warmup=1)
    kept = np.nonzero((rows_np >= 0) & (rows_np < S))
    b = torch.from_numpy(kept[0]).to(dev)
    r = torch.from_numpy(rows_np[kept].astype(np.int64)).to(dev)
    j = torch.from_numpy(kept[1]).to(dev)
    kk, vk = k_new[b, j], v_new[b, j]
    idx = (b[:, None], torch.arange(Hkv, device=dev)[None], r[:, None])

    def library():
        if quant:
            (kq, kss), (vq, vss) = quantize_rows(kk), quantize_rows(vk)
            cache["ks"][layer].index_put_(idx, kss)
            cache["vs"][layer].index_put_(idx, vss)
        else:
            kq, vq = kk, vk
        cache["k"][layer].index_put_(idx, kq)
        cache["v"][layer].index_put_(idx, vq)

    library_ms = timed_ms(torch, library)
    # bound: the kept rows' new K/V read once and their cache rows (and
    # scales) written once, the rows array read once (a dropped row needs
    # no more than its index)
    out_row = D * ck.element_size() + (4 if quant else 0)
    nbytes = (2 * len(kept[0]) * Hkv * (D * 2 + out_row) + B * R * 4)
    res = {"max_abs_err": 0.0, "mean_abs_err": 0.0, "ms": ms,
           "device_ms": dev_ms, "plain_ms": plain_ms,
           "library_ms": library_ms,
           "bound_ms": 1e3 * nbytes / PEAK_BYTES_PER_S, "bound_by": "bytes",
           "bytes": nbytes, "rows": B * R}
    log(f"[kernels] {name} {label}: rows {B * R} ({len(kept[0])} kept), "
        f"bit-exact on the whole cache"
        f"{' (int8 rows and scales)' if quant else ''}; kernel_ms {ms:.4f} "
        f"device_ms {dev_ms:.4f} "
        f"plain_ms {plain_ms:.4f} library_ms {library_ms:.4f} "
        f"({'quantize + ' if quant else ''}index_put_ K and V) bound_ms "
        f"{res['bound_ms']:.5f} ({nbytes / 1e6:.3f} MB)")
    return res


def _dense_cache(torch, gen, shape, quant):
    """A random dense cache of ``shape`` [L, B, Hkv, S, D] on ``gen``'s
    device: bf16, or int8 with float32 scales around amax / 127 of unit
    rows (as :func:`_make_pools` draws a pool)."""
    dev = gen.device
    if quant:
        cache = {n: torch.randint(-127, 128, shape, generator=gen,
                                  device=dev, dtype=torch.int8)
                 for n in ("k", "v")}
        for n in ("ks", "vs"):
            cache[n] = torch.rand(shape[:-1], generator=gen, device=dev) \
                * 0.02 + 1e-3
    else:
        cache = {n: torch.randn(shape, generator=gen, device=dev,
                                dtype=torch.bfloat16) for n in ("k", "v")}
    L, B, Hkv, S, D = shape
    log(f"[kernels] dense cache [L {L}, B {B}, Hkv {Hkv}, S {S}, D {D}] "
        f"{'int8 + float32 scales' if quant else 'bf16'}, "
        f"{_tree_bytes(cache) / 2**30:.2f} GiB")
    return cache


def _dense_cases(torch, np):
    """The dense cache at the main path's shapes ([28, 32, 8, 2048, 128]
    for K and for V), bf16 then int8 with its scales: K4 over 32 decode
    rows (lengths 0 to 2048), K5 over the same rows at 4 and 8 slots per
    CTA, K7 over 32 x SPEC_R verify rows, the row write (K8; int8: K9)
    with one row and with SPEC_R rows per slot (some dropped), and the same
    rows through the write with Qwen3's q/k prologue fused in."""
    from aws_k8s_ansible_provisioner_tpu_torch.config import QWEN3_0_6B as cfg
    from aws_k8s_ansible_provisioner_tpu_torch.ops import dense_attention as da

    L, Hkv, D, B, S = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, 32, \
        2048
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    rng = np.random.default_rng(8)
    lengths = rng.integers(1, S + 1, B)
    lengths[:6] = [0, 1, 64, 65, S, S - 1]
    layer = L - 1
    spec_len = np.minimum(lengths, S - SPEC_R)
    spec_len[:4] = [0, 59, 60, S - SPEC_R]
    rows = spec_len[:, None] + np.arange(SPEC_R)[None, :]
    rows[1, 2] = -1
    rows[2, :] = S + np.arange(SPEC_R)
    out = {}
    for name in ("bf16", "int8"):
        cache = _dense_cache(torch, gen, (L, B, Hkv, S, D), name == "int8")
        res = out[name] = {}
        res["attention"] = _dense_attention_case(
            torch, np, cache, lengths, layer, 1, "decode, 32 slots")
        _dense_attention_case(
            torch, np, cache,
            _split_edges(np, B, 64, S // 64,
                         da.attention_splits(B, Hkv, S, cache["k"].device)),
            layer, 1, "decode, 32 slots, split edges")
        for bb in (4, 8):
            res[f"bblock {bb}"] = _dense_attention_case(
                torch, np, cache, lengths, layer, 1,
                f"decode, 32 slots, {bb} per CTA", bb=bb)
        res["spec"] = _dense_attention_case(
            torch, np, cache, spec_len, layer, SPEC_R,
            f"verify, 32 slots x {SPEC_R} rows")
        res["write"] = _dense_write_case(torch, np, cache,
                                         lengths[:, None] - 1, layer,
                                         "decode, 32 rows")
        res["write_spec"] = _dense_write_case(
            torch, np, cache, rows, layer, f"verify, 32 x {SPEC_R} rows")
        # the same rows with Qwen3's q/k RMSNorm and RoPE fused in
        res["prep decode"] = _prep_case(
            torch, np, cache, lengths[:, None] - 1, None,
            np.maximum(lengths[:, None] - 1, 0), layer, "decode, 32 rows",
            cfg.num_heads, cfg.rope_theta, cfg.qk_norm, res["write"])
        res["prep verify"] = _prep_case(
            torch, np, cache, rows, None, np.maximum(rows, 0), layer,
            f"verify, 32 x {SPEC_R} rows", cfg.num_heads, cfg.rope_theta,
            cfg.qk_norm, res["write_spec"])
        del cache
        torch.cuda.empty_cache()
    return out


def _split_edges(np, n_rows, tile, tiles, splits):
    """Decode lengths at the split kernels' edges: 0 (every split empty; a
    paged row's C2 mean), one column, one tile and one past it, rows whose
    tiles end exactly on a split boundary (``splits`` x k tiles) and one
    column past it, the full window; ``n_rows`` of them."""
    base = [0, 1, tile - 1, tile, tile + 1, tiles * tile]
    runs = [splits * k * tile for k in range(1, tiles // splits + 1)]
    edges = base + runs + [r + 1 for r in runs]
    return np.resize(np.array(edges, np.int64), n_rows)


def _merge_case(torch, np, splits, rows, hq, d, label):
    """The split-KV combine at one launch's workspace shape: random split
    triples, a third of them empty (0, -1e30, 0) and one head whose only
    visited split is wholly masked (m -1e30, l > 0: a paged row at limit
    0), combined into a bf16 output against its plain version (the ulp
    rule row by row) and into the raw triple (within 1e-5 of max(|x|, 1):
    float32 sums of up to ``splits`` terms in another order); timed
    beside the plain version and its bound. No single PyTorch call
    computes it: library_ms is null."""
    from aws_k8s_ansible_provisioner_tpu_torch.ops import split_kv

    gen = torch.Generator(device="cuda")
    gen.manual_seed(41)
    dev = gen.device
    acc = torch.randn((splits, rows, hq, d), generator=gen, device=dev)
    m = torch.randn((splits, rows, hq), generator=gen, device=dev) * 3
    l_sum = torch.rand((splits, rows, hq), generator=gen, device=dev) * 60 + 1
    empty = torch.rand((splits, rows, hq), generator=gen, device=dev) < 0.33
    empty[:, 0, 0] = True
    acc[empty], m[empty], l_sum[empty] = 0.0, -1e30, 0.0
    m[0, 0, 0], l_sum[0, 0, 0] = -1e30, 64.0
    out = torch.empty((rows, hq, d), dtype=torch.bfloat16, device=dev)
    split_kv.split_merge(acc, m, l_sum, out=out)
    ref = split_kv.split_merge_plain(acc, m, l_sum, torch.bfloat16)
    raw = split_kv.split_merge(acc, m, l_sum)
    raw_ref = split_kv.split_merge_plain(acc, m, l_sum)
    torch.cuda.synchronize()
    what = f"split_merge {label}"
    check = _ulp_rows(torch, what, out, ref, rows,
                      lambda bad: f"rows {bad.tolist()}")
    for got, want in zip(raw, raw_ref):
        rel = float(((got - want).abs() / want.abs().clamp_min(1.0)).max())
        if not rel <= 1e-5:
            raise AssertionError(f"{what}: raw triple off by {rel:.2e}")
    ms = timed_ms(torch, lambda: split_kv.split_merge(acc, m, l_sum,
                                                      out=out))
    dev_ms = device_ms(torch, lambda: split_kv.split_merge(acc, m, l_sum,
                                                           out=out))
    plain_ms = timed_ms(torch, lambda: split_kv.split_merge_plain(
        acc, m, l_sum, torch.bfloat16), iters=5, warmup=1)
    nbytes = splits * rows * hq * (d + 2) * 4 + rows * hq * d * 2
    res = {**check, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
           "library_ms": None,
           "bound_ms": 1e3 * nbytes / PEAK_BYTES_PER_S, "bound_by": "bytes",
           "bytes": nbytes, "rows": rows}
    log(f"[kernels] {what}: {splits} splits x {rows} rows x {hq} heads x "
        f"{d}, max abs {check['max_abs_err']:.3e}, worst row max "
        f"{check['worst_row_max_ulps']:.2f} ulp; raw triple within 1e-5; "
        f"kernel_ms {ms:.4f} device_ms {dev_ms:.4f} plain_ms "
        f"{plain_ms:.4f} library_ms null "
        f"bound_ms {res['bound_ms']:.5f} ({nbytes / 1e6:.3f} MB)")
    return res


def _pool_cases(torch, np, pools, lengths, table, layer, label):
    """The decode and ragged attention cases and the decode, ragged and
    dropped-row write cases of one pool (bf16 or int8); the decode also at
    the split kernels' edges; the fused q/k prologue and row write at the
    decode's, the verify's and the ragged call's rows."""
    from aws_k8s_ansible_provisioner_tpu_torch.config import QWEN3_0_6B
    from aws_k8s_ansible_provisioner_tpu_torch.ops import split_kv

    max_pages = table.shape[1]
    ps = pools["k"].shape[3]
    dec = _attention_case(torch, np, pools, lengths, table, layer, "decode")
    splits = split_kv.split_count(len(lengths), pools["k"].shape[2],
                                  max_pages,
                                  split_kv.sm_count(pools["k"].device))
    _attention_case(torch, np, pools,
                    _split_edges(np, len(lengths), ps, max_pages, splits),
                    table, layer, "decode, split edges")
    # ragged mixed: slot 3 chunks rows [512, 768); its own decode row is the
    # dead passenger (limit 0); the 256 chunk rows share 4 pages
    pslot, pstart, C = 3, 512, 256
    limits = np.concatenate([lengths, pstart + np.arange(C) + 1])
    limits[pslot] = 0
    tables = np.concatenate([table, np.repeat(table[pslot][None], C, 0)])
    rag = _attention_case(torch, np, pools, limits, tables, layer,
                          "ragged 32+256", chunk_start=len(lengths))
    rows = np.concatenate([lengths - 1, pstart + np.arange(C)])
    rows[pslot] = -1
    wr_rag = _write_case(torch, np, pools, rows, tables, layer,
                         "ragged 32+256")
    wr_dec = _write_case(torch, np, pools, lengths - 1, table, layer,
                         "decode")
    # a dropped row must not read its table: OOB_PAGE rows beyond the window
    oob = np.full((4, max_pages), 2**31 - 1)
    wr_oob = _write_case(torch, np, pools,
                         np.array([-1, max_pages * ps, -5, 10**6]), oob,
                         layer, "dropped rows, OOB_PAGE tables")
    # the verify: SPEC_R rows per slot, rows crossing and filling pages
    spec_len = np.minimum(lengths, max_pages * ps - SPEC_R)
    spec_len[:4] = [0, 59, 60, max_pages * ps - SPEC_R]
    spec = _spec_case(torch, np, pools, spec_len, table, layer,
                      f"verify, 32 slots x {SPEC_R} rows")
    # the fused q/k prologue and row write at the decode's, the verify's
    # and the ragged call's rows (Qwen3: q/k norm and RoPE, Hq 16)
    prep_rows = {
        "decode": (lengths - 1, table, lengths - 1),
        "verify": ((spec_len[:, None] + np.arange(SPEC_R)).reshape(-1),
                   np.repeat(table, SPEC_R, axis=0),
                   (spec_len[:, None] + np.arange(SPEC_R)).reshape(-1)),
        "ragged": (rows, tables, np.maximum(rows, 0))}
    labels = {"decode": "decode 32 rows",
              "verify": f"verify 32 x {SPEC_R} rows",
              "ragged": "ragged 32+256"}
    prep = {f"prep {kind}": _prep_case(
        torch, np, pools, *prep_rows[kind], layer, labels[kind],
        QWEN3_0_6B.num_heads, QWEN3_0_6B.rope_theta, QWEN3_0_6B.qk_norm)
        for kind in prep_rows}
    log(f"[kernels] {label} pool done")
    return {"attention": dec, "attention_ragged": rag, "write": wr_dec,
            "write_ragged": wr_rag, "write_dropped": wr_oob, "spec": spec,
            **prep}


def _make_pools(torch, gen, shape, quant):
    """A random pool of ``shape`` [L, P, Hkv, page, D]: bf16, or int8 with
    float32 scales around amax / 127 of unit rows, on ``gen``'s device."""
    dev = gen.device
    if not quant:
        pools = {n: torch.randn(shape, generator=gen, device=dev,
                                dtype=torch.bfloat16) for n in ("k", "v")}
    else:
        pools = {n: torch.randint(-127, 128, shape, generator=gen, device=dev,
                                  dtype=torch.int8) for n in ("k", "v")}
        for n in ("ks", "vs"):
            pools[n] = torch.rand(shape[:-1], generator=gen, device=dev) \
                * 0.02 + 1e-3
    L, P, Hkv, ps, D = shape
    gib = 2 * pools["k"].numel() * (1 + 4 / D if quant else 2) / 2**30
    log(f"[kernels] pool [L {L}, P {P}, Hkv {Hkv}, page {ps}, D {D}] "
        f"{'int8 + float32 scales' if quant else 'bf16'}, {gib:.2f} GiB")
    return pools


def phase_kernels(torch, np):
    """Main-path shapes: 32 decode rows with ragged lengths up to 2048, and
    the ragged mixed case of those rows plus a 256-row chunk of one slot;
    over a bf16 pool, then over an int8 pool with its scales."""
    from aws_k8s_ansible_provisioner_tpu_torch.config import QWEN3_0_6B as cfg

    L, Hkv, D, ps, B, max_pages = cfg.num_layers, cfg.num_kv_heads, \
        cfg.head_dim, 64, 32, 2048 // 64
    P = B * max_pages + 1
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    rng = np.random.default_rng(5)
    table = (rng.permutation(B * max_pages) + 1).reshape(B, max_pages)
    lengths = rng.integers(1, 2049, B)
    lengths[:6] = [1, 64, 65, 2048, 2047, 128]
    out = {}
    for name in ("bf16", "int8"):
        pools = _make_pools(torch, gen, (L, P, Hkv, ps, D), name == "int8")
        out[name] = _pool_cases(torch, np, pools, lengths, table, L - 1, name)
        del pools
        torch.cuda.empty_cache()
    dense = _dense_cases(torch, np)
    out["dense"], out["dense int8"] = dense["bf16"], dense["int8"]
    # the combine at the decode's workspace: 32 rows x 16 heads, 3 splits
    out["merge"] = _merge_case(torch, np, out["bf16"]["attention"]["splits"],
                               B, cfg.num_heads, D, "decode, 32 rows")
    return out


def phase_kernels_window(torch, np):
    """The window instances at Mistral-7B-v0.1's shapes (Hq 32, Hkv 8,
    D 128, page 64, window 4096) over pools and a dense cache of 2 layers
    (the cut: a kernel reads one layer): K1 over 16 decode rows with lengths
    up to 8192, over those rows beside a 512-row chunk of one slot at rows
    [7680, 8192) (the ragged entry), and the verify's 16 x SPEC_R rows, for
    a bf16 and an int8 pool; K1 over 16 rows of length ~8000 at window 0
    against window 4096 (time ratio); K4, K7 and K5 (4 slots per CTA) over
    a dense cache [2, 16, 8, 8192, 128], bf16 then int8, each window
    instance then held to read no row below its first tile (NaN rows or
    scales there change nothing)."""
    from aws_k8s_ansible_provisioner_tpu_torch.config import \
        MISTRAL_7B_V01 as cfg
    from aws_k8s_ansible_provisioner_tpu_torch.ops import paged_attention as pa

    L, Hq, Hkv, D, W = 2, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, \
        cfg.sliding_window
    ps, B, S = 64, 16, 8192
    max_pages = S // ps
    P = B * max_pages + 1
    layer = L - 1
    gen = torch.Generator(device="cuda")
    gen.manual_seed(33)
    rng = np.random.default_rng(34)
    table = (rng.permutation(B * max_pages) + 1).reshape(B, max_pages)
    lengths = rng.integers(W + 1, S + 1, B)
    lengths[:8] = [1, 64, W, W + 1, W + 64, W + 65, S, S - 1]
    long_rows = rng.integers(7900, 8101, B)
    pslot, pstart, C = 3, S - 512, 512
    limits = np.concatenate([lengths, pstart + np.arange(C) + 1])
    limits[pslot] = 0
    tables = np.concatenate([table, np.repeat(table[pslot][None], C, 0)])
    spec_len = np.minimum(lengths, S - SPEC_R)
    spec_len[:4] = [0, W - 2, W + 61, S - SPEC_R]
    out = {}
    for name in ("bf16", "int8"):
        pools = _make_pools(torch, gen, (L, P, Hkv, ps, D), name == "int8")
        res = {"attention": _attention_case(
            torch, np, pools, lengths, table, layer,
            f"window {W}, decode {B} rows", Hq, W)}
        res["attention_ragged"] = _attention_case(
            torch, np, pools, limits, tables, layer,
            f"window {W}, ragged {B}+{C}", Hq, W, chunk_start=B)
        _chunk_poison_check(torch, np, pools, limits, tables, layer, Hq, W,
                            B)
        res["spec"] = _spec_case(torch, np, pools, spec_len, table, layer,
                                 f"window {W}, verify {B} x {SPEC_R} rows",
                                 Hq, W)
        _paged_poison_check(torch, np, pools, spec_len, table, layer, Hq, W)
        # the fused write without the norm (Mistral has no q/k norm)
        res["prep"] = _prep_case(torch, np, pools, lengths - 1, table,
                                 lengths - 1, layer, f"decode {B} rows", Hq,
                                 cfg.rope_theta, cfg.qk_norm)
        # the same 16 rows of ~8000 columns at window 0 and at window W
        scales = (pools["ks"], pools["vs"]) if "ks" in pools else ()
        fn = pa.paged_attention_quant if scales else pa.paged_attention
        q = torch.randn((B, Hq, D), generator=gen, device=gen.device,
                        dtype=torch.bfloat16)
        lim = torch.from_numpy(long_rows.astype(np.int32)).to(gen.device)
        tab = torch.from_numpy(table.astype(np.int32)).to(gen.device)
        ms = {w: timed_ms(torch, lambda w=w: fn(
            q, pools["k"], pools["v"], *scales, lim, layer, tab, w))
            for w in (0, W)}
        lo, hi = pa._live_pages(lim, ps, max_pages, W)
        log(f"[kernels] {fn.__name__} {B} rows of {int(long_rows.min())}-"
            f"{int(long_rows.max())} columns: window 0 {ms[0]:.4f} ms "
            f"({int((hi + 1).sum())} pages), window {W} {ms[W]:.4f} ms "
            f"({int((hi - lo + 1).sum())} pages); ratio {ms[W] / ms[0]:.3f}")
        out[name] = res
        del pools
        torch.cuda.empty_cache()
    dense_len = lengths.copy()
    dense_len[0] = 0
    for name in ("bf16", "int8"):
        cache = _dense_cache(torch, gen, (L, B, Hkv, S, D), name == "int8")
        res = out["dense" if name == "bf16" else "dense int8"] = {
            # the fused dense write without the norm (Mistral's decode)
            "prep": _prep_case(torch, np, cache, dense_len[:, None] - 1,
                               None, np.maximum(dense_len[:, None] - 1, 0),
                               layer, f"decode {B} slots", Hq,
                               cfg.rope_theta, cfg.qk_norm),
            "attention": _dense_attention_case(
                torch, np, cache, dense_len, layer, 1,
                f"window {W}, decode {B} slots", Hq, W),
            "spec": _dense_attention_case(
                torch, np, cache, spec_len, layer, SPEC_R,
                f"window {W}, verify {B} x {SPEC_R} rows", Hq, W),
            "bblock": _dense_attention_case(
                torch, np, cache, dense_len, layer, 1,
                f"window {W}, decode {B} slots, 4 per CTA", Hq, W, bb=4)}
        for bb in (1, 4):
            _dense_poison_check(torch, np, cache, dense_len, layer, Hq, W,
                                bb)
        _dense_poison_check(torch, np, cache, spec_len, layer, Hq, W, 1,
                            SPEC_R)
        del cache
        torch.cuda.empty_cache()
    return out


def _paged_poison_check(torch, np, pools, lengths_np, table_np, layer, hq,
                        window):
    """The verify's window instance (K1-spec) reads no page outside its
    slots' ranges: table entries below the page of each slot's row 0 window
    start and past the page of its last column (lengths + SPEC_R - 1) point
    at page 0, which no slot owns, filled with NaN (int8: its scales); the
    output must be finite and bit-identical to the clean table's."""
    from aws_k8s_ansible_provisioner_tpu_torch.ops import paged_attention as pa

    quant = "ks" in pools
    dev = pools["k"].device
    _, _, Hkv, ps, D = pools["k"].shape
    B, max_pages = table_np.shape
    assert table_np.min() > 0
    for n in ("ks", "vs") if quant else ("k", "v"):
        pools[n][layer, 0] = float("nan")
    lo = np.maximum(lengths_np + 1 - window, 0) // ps
    end = -(-(lengths_np + SPEC_R) // ps)
    dirty = table_np.copy()
    for b in range(B):
        dirty[b, :lo[b]] = 0
        dirty[b, end[b]:] = 0
    gen = torch.Generator(device=dev)
    gen.manual_seed(37)
    q = torch.randn((B, SPEC_R, hq, D), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    lengths = torch.from_numpy(lengths_np.astype(np.int32)).to(dev)
    scales = (pools["ks"], pools["vs"]) if quant else ()

    def run(tab):
        return pa.decode_attend_spec_paged(
            q, pools["k"], pools["v"], lengths, layer,
            torch.from_numpy(tab.astype(np.int32)).to(dev), *scales,
            window=window)

    clean, bad = run(table_np), run(dirty)
    torch.cuda.synchronize()
    what = ("paged_attention_spec_quant" if quant
            else "paged_attention_spec") + " window"
    if not (bool(torch.isfinite(bad.float()).all())
            and torch.equal(clean, bad)):
        raise AssertionError(f"{what}: a page outside a slot's range was "
                             f"read")
    log(f"[kernels] {what}: {int((dirty == 0).sum())} table entries outside "
        f"the slots' ranges at a NaN page: output finite and bit-identical")


def _chunk_poison_check(torch, np, pools, limits_np, tables_np, layer, hq,
                        window, chunk_start):
    """The ragged entry's window instance with the chunk layout reads no
    page outside its rows' ranges: the chunk rows' table entries below the
    page of the chunk's first row's window start and past its last row's
    last page, and each decode row's outside its own pages, point at page
    0, which no row owns, filled with NaN (int8: its scales); the output
    must be finite and bit-identical to the clean tables'."""
    from aws_k8s_ansible_provisioner_tpu_torch.ops import paged_attention as pa

    quant = "ks" in pools
    dev = pools["k"].device
    _, _, Hkv, ps, D = pools["k"].shape
    N, max_pages = tables_np.shape
    assert tables_np.min() > 0
    for n in ("ks", "vs") if quant else ("k", "v"):
        pools[n][layer, 0] = float("nan")
    limits = torch.from_numpy(limits_np.astype(np.int32)).to(dev)
    lo, hi = (t.cpu().numpy() for t in pa._live_pages(limits, ps, max_pages,
                                                      window))
    dirty = tables_np.copy()
    for n in range(N):
        first, last = (lo[chunk_start], hi[-1]) if n >= chunk_start \
            else (lo[n], hi[n])
        dirty[n, :first] = 0
        dirty[n, last + 1:] = 0
    gen = torch.Generator(device=dev)
    gen.manual_seed(38)
    q = torch.randn((N, hq, D), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    scales = (pools["ks"], pools["vs"]) if quant else ()

    def run(tab):
        return pa.ragged_attend_paged(
            q, pools["k"], pools["v"], limits, layer,
            torch.from_numpy(tab.astype(np.int32)).to(dev), *scales,
            window=window, chunk_start=chunk_start)

    clean, bad = run(tables_np), run(dirty)
    torch.cuda.synchronize()
    what = ("paged_attention_quant" if quant else "paged_attention") \
        + " chunk window"
    if not (bool(torch.isfinite(bad.float()).all())
            and torch.equal(clean, bad)):
        raise AssertionError(f"{what}: a page outside its rows' ranges was "
                             f"read")
    log(f"[kernels] {what}: {int((dirty == 0).sum())} table entries outside "
        f"the rows' ranges at a NaN page: output finite and bit-identical")


def _dense_poison_check(torch, np, cache, lengths_np, layer, hq, window, bb,
                        R=1):
    """The window instance of K4 (``bb`` 1), K5 (``bb`` > 1) or K7 (``R`` >
    1) reads no row below its first tile, nor (K7) past its last row: the
    rows below each slot's window start's tile (K5 too: each slot walks its
    own tiles; K7: row 0's), and for K7 the rows from lengths + R on, set
    to NaN (int8: their scales), the output must be finite and
    bit-identical to the clean cache's."""
    from aws_k8s_ansible_provisioner_tpu_torch.ops import dense_attention as da

    quant = "ks" in cache
    B, D = cache["k"].shape[1], cache["k"].shape[4]
    gen = torch.Generator(device=cache["k"].device)
    gen.manual_seed(29)
    q = torch.randn((B, R, hq, D), generator=gen, device=gen.device,
                    dtype=torch.bfloat16)
    lengths = torch.from_numpy(lengths_np.astype(np.int32)).to(gen.device)
    start = np.maximum(lengths_np + (R > 1) - window, 0) // 64 * 64
    if not start.any():
        raise AssertionError("poison check: no row below any first tile")

    def run(c):
        kw = {"cache_ks": c["ks"], "cache_vs": c["vs"]} if quant else {}
        if R > 1:
            return da.spec_attend_dense(q, c["k"], c["v"], lengths, layer,
                                        window, **kw)
        return da.decode_attend_dense(q, c["k"], c["v"], lengths, layer,
                                      window, **kw, bblock=bb)

    clean = run(cache)
    names = ("ks", "vs") if quant else ("k", "v")
    dirty = dict(cache)
    for n in names:
        dirty[n] = cache[n].clone()
        for b, st in enumerate(start):
            dirty[n][layer, b, :, :st] = float("nan")
            if R > 1:
                dirty[n][layer, b, :, int(lengths_np[b]) + R:] = float("nan")
    bad = run(dirty)
    torch.cuda.synchronize()
    what = _dense_name("spec_attend_dense" if R > 1 else
                       "decode_attend_dense", quant, bb, window)
    if not (bool(torch.isfinite(bad.float()).all())
            and torch.equal(clean, bad)):
        raise AssertionError(f"{what}: rows below the first tile were read")
    log(f"[kernels] {what}: {int((start > 0).sum())} of {B} slots with "
        f"NaN {'scales' if quant else 'rows'} below their first tile "
        f"(up to row {int(start.max())}): output finite and bit-identical")


def _kernel_names(quant: bool):
    """(attention, row write) launch-count names of one pool's kernels (the
    row write with the q/k prologue fused in)."""
    return (("paged_attention_quant", "prep_write_rows_quant_paged") if quant
            else ("paged_attention", "prep_write_rows_paged"))


# the standalone paged row writes (K2, K3 without the prologue): no engine
# path launches them
STANDALONE_WRITES = ("cache_write_rows_paged", "cache_write_rows_quant_paged")
# the paged engine's kernels (every instance), each 0 in a dense engine run
PAGED_KERNELS = ("paged_attention", "paged_attention_quant",
                 "paged_attention_spec", "paged_attention_spec_quant",
                 "prep_write_rows_paged", "prep_write_rows_quant_paged"
                 ) + STANDALONE_WRITES


def _check_fused_writes(tag, engine, launches, counts):
    """Every layer of every paged forward of a run (decode substeps, mixed
    dispatches, verifies; ``counts`` the engine's counts of that run) went
    through the fused q/k prologue and row write: its launches equal layers
    x forwards, and the standalone K2/K3 launched no time."""
    forwards = sum(counts.get(k, 0) for k in (
        "decode_substeps", "mixed_dispatches", "spec_dispatches"))
    fused = sum(launches[k] for k in _kernel_names(False)[1:]
                + _kernel_names(True)[1:])
    want = engine.cfg.num_layers * forwards
    if forwards <= 0 or fused != want or \
            any(launches[k] for k in STANDALONE_WRITES):
        alone = {k: launches[k] for k in STANDALONE_WRITES}
        raise AssertionError(f"{tag} fused row writes {fused}, expected "
                             f"{engine.cfg.num_layers} layers x {forwards} "
                             f"forwards = {want}; standalone {alone}")
    log(f"{tag} fused q/k prologue + row write: {fused} launches = "
        f"{engine.cfg.num_layers} layers x {forwards} paged forwards "
        f"(decode substeps, mixed dispatches, verifies); standalone K2/K3 0")


def _dense_kernel_names(engine):
    """(decode attention instance, row write) launch-count names of a
    dense engine's kernels (its KV dtype, decode_bblock and window; the row
    write with the q/k prologue fused in)."""
    quant = "ks" in engine.cache
    return (_dense_name("decode_attend_dense", quant, engine.decode_bblock,
                        engine.cfg.sliding_window),
            FUSED_DENSE_WRITES[quant])


# the dense row writes with the q/k prologue fused in (bf16/f32, int8),
# and standalone (K8, K9 without the prologue): no engine path launches
# the standalone ones
FUSED_DENSE_WRITES = ("prep_write_rows_dense", "prep_write_rows_quant_dense")
STANDALONE_DENSE_WRITES = ("cache_write_rows_dense",
                           "cache_write_rows_quant_dense")


def _dense_forwards(counts):
    """A dense engine's forwards that write a row at every layer through
    the dense callbacks: its decode substeps and verifies."""
    return sum(counts.get(k, 0) for k in ("decode_substeps",
                                          "spec_dispatches"))


def _check_fused_dense(tag, layers, launches, forwards, what, per=1):
    """Every layer of every dense forward (``forwards`` of them, ``what``
    for the log; ``per`` launches a layer: one per sequence shard) went
    through the fused q/k prologue and dense row write: its launches equal
    layers x forwards x per, and the standalone K8/K9 launched no time."""
    fused = sum(launches[k] for k in FUSED_DENSE_WRITES)
    want = layers * forwards * per
    alone = {k: launches[k] for k in STANDALONE_DENSE_WRITES}
    if forwards <= 0 or fused != want or any(alone.values()):
        raise AssertionError(f"{tag} fused dense row writes {fused}, "
                             f"expected {layers} layers x {forwards} "
                             f"{what} x {per} = {want}; standalone {alone}")
    log(f"{tag} fused q/k prologue + dense row write: {fused} launches = "
        f"{layers} layers x {forwards} {what}"
        f"{f' x {per} shards' if per > 1 else ''}; standalone K8/K9 0")


def _check_dense_launches(tag, engine, launches, extra=(), counts=None):
    """A dense engine run: its decode attention instance, its fused row
    write and ``extra`` launched, the fused write once a layer of every
    decode substep and verify (``counts``: the run's engine counts, the
    engine's own by default) and the standalone K8/K9 never, no paged
    kernel, and (without a window) no window instance."""
    _check_fused_dense(tag, engine.cfg.num_layers, launches,
                       _dense_forwards(engine.counts if counts is None
                                       else counts),
                       "dense forwards (decode substeps, verifies)")
    mine = _dense_kernel_names(engine) + tuple(extra)
    if min(launches[k] for k in mine) <= 0:
        raise AssertionError(f"{tag} a kernel of the path never launched "
                             f"({mine}): {launches}")
    if max(launches[k] for k in PAGED_KERNELS) != 0:
        raise AssertionError(f"{tag} the dense engine launched a paged "
                             f"kernel: {launches}")
    window = [k for k in launches if k.endswith(" window") and launches[k]]
    if engine.cfg.sliding_window == 0 and window:
        raise AssertionError(f"{tag} a window instance launched: {launches}")
    if engine.counts["chunk_dispatches"] <= 0:
        raise AssertionError(f"{tag} no prompt took the dense chunk walk")


def _dispatch_mode(engine):
    """How the engine dispatches decode, for the logs: the pipeline's depth
    and the CUDA graphs of the horizon (their capture time and the device
    memory they reserved)."""
    dec = engine.decoder
    mode = ("pipelined" if engine.serving.decode_pipeline > 0
            and engine.sp == 1 else "synchronous") + " dispatch"
    if not dec.graphs:
        return mode + ", eager decode"
    return (f"{mode}, decode graphs {sorted(dec.graphs)} captured in "
            f"{dec.capture_s:.2f}s, {dec.pool_bytes / 2**20:.1f} MiB")


def _check_replays(tag, engine, replays0):
    """Every plain decode dispatch since ``replays0`` replays was one replay
    of a captured decode graph (none falls back to eager launches)."""
    n = engine.counts["decode_dispatches"]
    replays = engine.decoder.replays - replays0
    if not engine.decoder.graphs or n <= 0 or replays != n:
        raise AssertionError(f"{tag} {n} decode dispatches but {replays} "
                             f"graph replays")
    log(f"{tag} {n} decode dispatches, each one replay of a CUDA graph; "
        f"{engine.counts['pipeline_dispatches']} dispatches through the "
        f"pipeline, drains "
        f"{ {k: v for k, v in engine.counts.items() if 'drains' in k} }")


def _finish_ok(cfg, req, n):
    if len(req.generated) != n or req.finish_reason != "length" or \
            not all(0 <= t < cfg.vocab_size for t in req.generated):
        raise AssertionError(f"request {req.id}: {len(req.generated)} tokens "
                             f"({req.finish_reason}), expected {n}")


def _cache_layout(engine):
    """How an engine keeps its KV, for the logs."""
    serving = engine.serving
    if isinstance(engine.cache, list):
        gib = sum(_tree_bytes(sh) for sh in engine.cache) / 2**30
        return (f"dense cache {engine.num_slots} slots x {engine.max_len} "
                f"rows in {len(engine.cache)} sequence shards of "
                f"{engine.max_len // len(engine.cache)} rows ({gib:.2f} "
                f"GiB)")
    gib = _tree_bytes(engine.cache) / 2**30
    if engine.paged:
        return (f"page {serving.page_size}, {serving.max_decode_slots} "
                f"slots, pool {engine.allocator.num_pages} pages "
                f"({gib:.2f} GiB)")
    return (f"dense cache {engine.num_slots} slots x {engine.max_len} rows "
            f"({gib:.2f} GiB), {engine.decode_bblock} slots per decode CTA")


def phase_engine(torch, np, kv_dtype, paged=True, bblock=0):
    """The main path with the ``kv_dtype`` pool (``paged``; else the dense
    engine with ``bblock`` slots per decode CTA); launch counts zeroed just
    before the measured run and read just after. With int8 KV the run also
    holds the seeded contract: a sampled request with its own seed, alone
    and again beside three running requests, gives one stream."""
    from aws_k8s_ansible_provisioner_tpu_torch.config import (QWEN3_0_6B,
                                                              ServingConfig)
    from aws_k8s_ansible_provisioner_tpu_torch.models.layers import init_params
    from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import (Engine,
                                                                      Request)

    cfg = QWEN3_0_6B
    quant = kv_dtype == "int8"
    serving = ServingConfig(prefill_chunk=256, derived_seed=0,
                            kv_dtype=kv_dtype, paged=paged,
                            decode_bblock=bblock)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.monotonic()
    params = init_params(cfg, gen, torch.bfloat16)
    engine = Engine(cfg, params, serving, device="cuda")
    del params
    torch.cuda.synchronize()
    tag = f"[engine {kv_dtype}]" if paged else f"[dense {kv_dtype}]"
    log(f"{tag} {cfg.name}: {cfg.num_layers} layers, hidden "
        f"{cfg.hidden_size}, vocab {cfg.vocab_size}; weights "
        f"{serving.weights_dtype}, KV {'int8' if quant else serving.dtype}, "
        f"{_cache_layout(engine)}; set-up {time.monotonic() - t0:.1f}s")
    rng = np.random.default_rng(1)
    lens = [17, 45, 130, 300, 64, 700, 9, 200]
    new = [32, 48, 64, 40, 56, 32, 64, 48]
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    # warm the allocator and the cuBLAS handles outside the measured run
    engine.submit(Request(prompt_ids=prompts[0][:8], max_tokens=2,
                          ignore_eos=True))
    engine.run_until_idle()
    engine.counts.clear()
    replays0 = engine.decoder.replays
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.monotonic()
    reqs = [engine.submit(Request(prompt_ids=p, max_tokens=m,
                                  ignore_eos=True))
            for p, m in zip(prompts, new)]
    if quant:
        reqs.append(engine.submit(Request(prompt_ids=prompts[2], max_tokens=48,
                                          seed=2, **SAMPLED)))
        new = new + [48]
    engine.run_until_idle()
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    n_gen = sum(len(r.generated) for r in reqs)
    if quant:
        _seeded_twice(engine, rng, Request)
    launches = _launches()
    log(f"{tag} {len(reqs)} requests, prompts {lens}: {n_gen} tokens in "
        f"{dt:.2f}s ({n_gen / dt:.1f} tok/s end to end, "
        f"{_dispatch_mode(engine)}); dispatches {dict(engine.counts)}; "
        f"kernel launches "
        f"{launches}")
    for r, m in zip(reqs, new):
        _finish_ok(cfg, r, m)
    _check_replays(tag, engine, replays0)
    if not paged:
        _check_dense_launches(tag, engine, launches)
        return engine, launches
    mine = _kernel_names(quant)
    others = _kernel_names(not quant)
    if min(launches[k] for k in mine) <= 0:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    if max(launches[k] for k in others) != 0:
        raise AssertionError(f"the {kv_dtype} path launched the other "
                             f"pool's kernels: {launches}")
    if launches[mine[0] + " window"] != 0:
        raise AssertionError(f"Qwen3 (no window) launched a window "
                             f"instance: {launches}")
    if launches["split_merge"] <= 0:
        raise AssertionError(f"no decode dispatch went through the split-KV "
                             f"combine: {launches}")
    if engine.counts["mixed_dispatches"] <= 0:
        raise AssertionError("no chunked prefill went through mixed_step")
    if launches[mine[0] + " chunk"] <= 0:
        raise AssertionError(f"no mixed dispatch's chunk rows went through "
                             f"the chunk body: {launches}")
    _check_fused_writes(tag, engine, launches, engine.counts)
    return engine, launches


def _seeded_twice(engine, rng, Request):
    """One sampled request with its own seed, alone, then admitted again
    while three greedy requests decode in other slots (its prefill is a
    batch of its own both times, and no chunk is in flight beside it):
    both streams must be identical."""
    import dataclasses

    cfg = engine.cfg
    # the prefix cache off for this check: the second copy would hit the
    # first's rows and walk its last token through the chunk program
    # (another bf16 rounding of its rows); phase_prefix holds the cache
    serving = engine.serving
    engine.serving = dataclasses.replace(serving, prefix_cache=False)
    prompt = rng.integers(0, cfg.vocab_size, 90).tolist()
    alone = engine.submit(Request(prompt_ids=prompt, max_tokens=40, seed=1,
                                  **SAMPLED))
    engine.run_until_idle()
    others = [engine.submit(Request(prompt_ids=rng.integers(
        0, cfg.vocab_size, n).tolist(), max_tokens=60, ignore_eos=True))
        for n in (40, 120, 70)]
    while engine.pending or engine._chunk is not None:
        engine.step()
    # with a dispatch in flight the paged engine would admit the prompt
    # through the chunk walk (a mixed dispatch, another bf16 rounding of its
    # rows): settle it so that the prompt is a batch of its own again
    engine._settle_inflight()
    crowded = engine.submit(Request(prompt_ids=prompt, max_tokens=40, seed=1,
                                    **SAMPLED))
    engine.run_until_idle()
    engine.serving = serving
    for r, n in [(alone, 40), (crowded, 40)] + [(r, 60) for r in others]:
        _finish_ok(cfg, r, n)
    if crowded.generated != alone.generated:
        first = next(i for i, (a, b) in enumerate(zip(alone.generated,
                                                      crowded.generated))
                     if a != b)
        raise AssertionError(f"seeded stream depends on the batch: first "
                             f"difference at token {first}")
    log(f"[{cfg.name} int8] seeded request (seed 1, temperature 0.8, top-p "
        f"0.9, top-k 20) alone and beside 3 running requests: identical "
        f"{len(alone.generated)}-token streams, {len(set(alone.generated))} "
        f"distinct tokens")


def phase_profile(torch, np, engine):
    """Where a decode dispatch's time goes: 8 active slots, one horizon-8
    decode dispatch timed by the host clock, and the same dispatch under
    torch.profiler for device time by kernel and the device's idle share."""
    from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import Request

    rng = np.random.default_rng(4)
    for _ in range(8):
        engine.submit(Request(prompt_ids=rng.integers(
            0, engine.cfg.vocab_size, 100).tolist(), max_tokens=200,
            ignore_eos=True))
    while engine.pending or engine._chunk is not None:
        engine.step()
    engine.step()                                  # warm the horizon path
    tag = (f"[profile {'' if engine.paged else 'dense '}"
           f"{'int8' if 'ks' in engine.cache else 'bf16'}"
           f"{'' if engine.serving.decode_pipeline else ', pipeline off'}]")
    before, counts0 = _launches(), dict(engine.counts)
    wall_ms = _profile_dispatch(torch, engine, tag)
    launches = _delta(_launches(), before)
    counts = {k: v - counts0.get(k, 0) for k, v in engine.counts.items()}
    if engine.paged:
        _check_fused_writes(tag, engine, launches, counts)
    else:
        _check_fused_dense(tag, engine.cfg.num_layers, launches,
                           _dense_forwards(counts), "decode substeps")
    for s in engine._active_slots():
        engine.cancel(engine.slot_req[s])
    engine.step()
    return wall_ms


def _profile_dispatch(torch, engine, tag, step=None, n_slots=None,
                      stats=None):
    """One engine step (a decode dispatch; or ``step()``, a dispatch of
    ``n_slots`` slots) timed by the host clock, then the next under
    torch.profiler: device time by kernel and the device's idle share
    (also into the dict ``stats``, when given)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step = step or engine.step
    if n_slots is None:
        n_slots = len(engine._active_slots())
    torch.cuda.synchronize()
    t0 = time.monotonic()
    step()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.monotonic() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        step()
        torch.cuda.synchronize()
        prof_wall_ms = 1e3 * (time.monotonic() - t0)
    # device-side events only (kernels, memcpy/memset): their self time on
    # the one stream the engine uses is the device's busy time
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    horizon = engine.serving.decode_horizon
    log(f"{tag} decode dispatch, {n_slots} active "
        f"slots, horizon {horizon}: wall {wall_ms:.2f} ms "
        f"({wall_ms / horizon:.2f} ms per substep)")
    if not events:
        log(f"{tag} torch.profiler recorded no device time: device "
            "busy share not measured")
    else:
        n_ops = sum(e.count for e in events)
        if stats is not None:
            stats.update(wall_ms=wall_ms, prof_wall_ms=prof_wall_ms,
                         busy_ms=busy_ms, ops_per_substep=n_ops / horizon,
                         by_kernel={e.key: (e.self_device_time_total,
                                            e.count) for e in events})
        log(f"{tag} profiled dispatch: wall {prof_wall_ms:.2f} ms, "
            f"device busy {busy_ms:.2f} ms (idle share "
            f"{1 - busy_ms / prof_wall_ms:.3f}), "
            f"{n_ops} device operations ({n_ops / horizon:.1f} a substep)")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
            log(f"{tag}   {e.self_device_time_total / 1e3:8.3f} ms "
                f"{100 * e.self_device_time_total / 1e3 / busy_ms:5.1f}% "
                f"x{e.count:<5d} {e.key[:90]}")
        # the row writes (K2, K3, K8, K9, each with the q/k prologue fused
        # in): device time a launch (a graph node when the engine replays
        # its decode graphs)
        for e in events:
            kernel = re.search(r"cache_write\w*", e.key)
            if kernel:
                log(f"{tag}   row write {kernel.group(0)}: "
                    f"{e.self_device_time_total / e.count:.2f} us a launch "
                    f"x{e.count}")
    return wall_ms


def phase_pipeline(torch, np, engine):
    """The decode graphs and the one-deep pipeline of an int8 Qwen3 engine
    (paged, or dense): its graphs' capture time and device memory; one
    replay of the full horizon held against eager ``decode_steps`` on a
    clone of the cache from the same operands (the same tokens; every K/V
    row and scale bit-identical, else the largest difference printed and
    the tokens still equal; the launch counts of the replay equal to the
    eager run's); seeded streams, greedy and sampled, equal with
    ``decode_pipeline`` 1 and 0 on the same engine; one decode dispatch
    timed and profiled with the pipeline off, beside the profile phase's
    pipelined one."""
    import dataclasses

    from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import Request
    from aws_k8s_ansible_provisioner_tpu_torch.serving.programs import \
        decode_steps

    dec = engine.decoder
    # the same prompts run three times on the engine: the prefix cache off,
    # so that each run prefills them alike (phase_prefix holds the cache)
    orig = engine.serving
    serving = dataclasses.replace(orig, prefix_cache=False)
    engine.serving = serving
    cfg = engine.cfg
    tag = f"[pipeline {'paged' if engine.paged else 'dense'} int8]"
    log(f"{tag} {_dispatch_mode(engine)} ({dec.pool_bytes} bytes)")
    rng = np.random.default_rng(61)
    lens = (40, 90, 150, 220, 60, 300, 33, 120)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]

    def submit():
        return [engine.submit(Request(prompt_ids=p, max_tokens=40, **(
            dict(SAMPLED, seed=10 + i) if i % 2 else
            dict(ignore_eos=True)))) for i, p in enumerate(prompts)]

    # one replay against eager decode_steps, from the same operands
    reqs = submit()
    while engine.pending or engine._chunk is not None:
        engine.step()
    engine.step()
    engine._settle_inflight()
    engine._decode_operands()
    ops = [t.clone() for t in (dec.tokens, dec.lengths, dec.temps,
                               dec.top_ks, dec.top_ps, dec.seeds)]
    table = dec.table.clone() if engine.paged else None
    sampled = bool((engine.temps > 0).any())
    H = serving.decode_horizon
    clone = {k: v.clone() for k, v in engine.cache.items()}
    torch.cuda.synchronize()
    _reset_launches()
    out_g = dec.run(H, sampled).clone()
    torch.cuda.synchronize()
    graph_launches = _launches()
    _reset_launches()
    _, out_e = decode_steps(engine.model, H, clone, ops[0], ops[1], table,
                            *ops[2:], bblock=engine.decode_bblock,
                            any_sampled=sampled)
    torch.cuda.synchronize()
    eager_launches = _launches()
    # the replay moved the carry in the operand buffers: the next dispatch
    # copies the host mirrors in again
    engine._pipe_carry = None
    diffs = {k: float((engine.cache[k].float() - clone[k].float()).abs()
                      .max()) for k in clone}
    del clone
    same = bool(torch.equal(out_g, out_e))
    bits = "bit-identical" if not any(diffs.values()) else "not bit-identical"
    counted = "equal" if graph_launches == eager_launches else "DIFFER"
    log(f"{tag} one replay of horizon {H} (any row samples: {sampled}) vs "
        f"eager decode_steps on a clone of the cache: tokens "
        f"{'equal' if same else 'DIFFER'}; cache leaves max abs difference "
        f"{diffs} ({bits}); launches of the replay {counted} to eager")
    if not same:
        raise AssertionError(f"{tag} the graph's tokens differ from eager "
                             f"decode_steps'")
    if graph_launches != eager_launches:
        raise AssertionError(f"{tag} replay launches {graph_launches} vs "
                             f"eager {eager_launches}")
    for r in reqs:
        engine.cancel(r)
    engine.run_until_idle()
    # seeded streams with the pipeline on and off (every prompt is in
    # before the first decode dispatch, so both admit alike)
    streams = {}
    for depth in (1, 0):
        engine.serving = dataclasses.replace(serving, decode_pipeline=depth)
        engine.counts.clear()
        t0 = time.monotonic()
        reqs = submit()
        engine.run_until_idle()
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        for r in reqs:
            _finish_ok(cfg, r, 40)
        streams[depth] = [r.generated for r in reqs]
        log(f"{tag} decode_pipeline={depth}: {len(reqs)} requests (4 "
            f"seeded sampled) in {dt:.2f}s; counts {dict(engine.counts)}")
    same = sum(a == b for a, b in zip(streams[1], streams[0]))
    log(f"{tag} streams equal with the pipeline on and off: {same}/"
        f"{len(prompts)}")
    if same != len(prompts):
        raise AssertionError(f"{tag} a seeded stream depends on the "
                             f"pipeline")
    # one decode dispatch with the pipeline off (graphs still on)
    engine.serving = dataclasses.replace(serving, decode_pipeline=0)
    phase_profile(torch, np, engine)
    engine.serving = orig
    return {"capture_s": dec.capture_s, "pool_bytes": dec.pool_bytes}


FIELDS_NEW = 64
# the +100 logit_bias of the forced stream: any token id
FORCED_TOKEN = 4242


def _lp_rows_ok(tag, req, greedy):
    """Each logprob record of ``req``: its top list sorted, its own value
    equal to its token's entry when the token is listed, and (greedy) its
    token on top, or tied with the top."""
    for i, (tok, rec) in enumerate(zip(req.generated, req.logprob_data)):
        own, top = rec
        vals = [v for _, v in top]
        listed = [v for t, v in top if t == tok]
        if vals != sorted(vals, reverse=True) or \
                (listed and listed[0] != own) or \
                (greedy and own != vals[0]):
            raise AssertionError(f"{tag} logprob record {i} of request "
                                 f"{req.id}: token {tok}, {rec}")


def _variant_vs_eager(torch, engine, tag, H, penalties, logprobs):
    """One replay of the (horizon H, penalties, logprobs) graph against
    eager ``decode_steps`` of the same variant from the same state: the
    operands' tokens, lengths and counts are put back after the replay and
    the eager call rewrites the same K/V rows of the same pool. The active
    slots' tokens, logprob records and count rows must be bit-identical,
    and the pool after the rewrite equal to the pool after the replay
    outside the scratch page (page 0, where the idle slots write: their
    garbage rows read what the replay's idle rows left there)."""
    from aws_k8s_ansible_provisioner_tpu_torch.serving.programs import \
        decode_steps

    dec = engine.decoder
    sampled = bool((engine.temps > 0).any())
    act = torch.tensor(engine._active_slots(), device=dec.tokens.device)
    state = [t.clone() for t in (dec.tokens, dec.lengths, dec.counts)]
    out_g = dec.run(H, sampled, penalties, logprobs)
    out_g = (out_g[0].clone(), tuple(a.clone() for a in out_g[1])) \
        if logprobs else out_g.clone()
    counts_g = dec.counts.clone()
    torch.cuda.synchronize()
    after = {k: v[:, 1:].clone() for k, v in engine.cache.items()}
    for dst, src in zip((dec.tokens, dec.lengths, dec.counts), state):
        dst.copy_(src)
    pen = dict(counts=dec.counts, presence=dec.presence,
               frequency=dec.frequency, repetition=dec.repetition,
               prompt_mask=dec.prompt_mask) if penalties else {}
    _, out_e = decode_steps(
        engine.model, H, engine.cache, dec.tokens, dec.lengths, dec.table,
        dec.temps, dec.top_ks, dec.top_ps, dec.seeds, any_sampled=sampled,
        ban_ids=dec.ban_ids, ban_until=dec.ban_until, bias_ids=dec.bias_ids,
        bias_vals=dec.bias_vals, logprobs=logprobs, **pen)
    torch.cuda.synchronize()
    same = {"tokens": torch.equal((out_g[0] if logprobs else out_g)[:, act],
                                  (out_e[0] if logprobs else out_e)[:, act]),
            "counts": torch.equal(counts_g[act], dec.counts[act]),
            "pool": all(torch.equal(after[k], engine.cache[k][:, 1:])
                        for k in after)}
    if logprobs:
        same["logprobs"] = all(torch.equal(a[:, act], b[:, act])
                               for a, b in zip(out_g[1], out_e[1]))
    del after
    # the eager call left the carry of its own outputs: the next dispatch
    # copies the host mirrors in
    engine._pipe_carry = None
    log(f"{tag} variant (penalties {penalties}, logprobs {logprobs}), "
        f"horizon {H}: replay vs eager decode_steps from the same state, "
        f"bit-identical: {same}")
    if not all(same.values()):
        raise AssertionError(f"{tag} the graph variant differs from eager "
                             f"decode_steps: {same}")


def phase_fields(torch, np, engine):
    """The request fields on the paged bf16 Qwen3-0.6B engine at full width
    (pipeline and graphs on): one batch of 8 requests of FIELDS_NEW tokens
    (plain; presence + frequency; repetition; a +100 bias; a -100 bias on
    the plain stream's most frequent token; min_tokens 16 with a stop id the
    plain stream emits early; logprobs 8; a seeded sampled request with a
    presence penalty), launch counts zeroed just before and read just after
    (K1 and the fused K2 once a layer of every paged forward, every decode
    dispatch a replay); a prompt_logprobs request; a request with every
    field neutral against the bare one; each new graph variant replayed
    against eager ``decode_steps``; a verify beside a logprobs slot that it
    skips; then one horizon-8 dispatch of 8 slots profiled per variant
    (default, penalties, logprobs, both)."""
    import dataclasses

    from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import Request

    cfg, dec = engine.cfg, engine.decoder
    tag = "[fields]"
    orig = engine.serving
    # the phase compares runs of one prompt: each must prefill alike
    engine.serving = dataclasses.replace(orig, prefix_cache=False)
    log(f"{tag} {_dispatch_mode(engine)}: {len(dec.graphs)} graphs "
        f"(horizons x any row samples x penalties x logprobs), capture_s "
        f"{dec.capture_s:.3f}, pool_bytes {dec.pool_bytes}")
    variants0 = dict(dec.variant_replays)
    rng = np.random.default_rng(71)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (40, 90, 150, 220, 60, 300, 33, 120)]

    def run(reqs):
        reqs = [engine.submit(r) for r in reqs]
        engine.run_until_idle()
        torch.cuda.synchronize()
        return reqs

    def req(i, **kw):
        return Request(prompt_ids=prompts[i], max_tokens=FIELDS_NEW,
                       **{"ignore_eos": True, **kw})

    bare = run([req(0)])[0].generated
    frequent = max(set(bare), key=bare.count)
    stop = bare[3]
    engine.counts.clear()
    replays0 = dec.replays
    _reset_launches()
    t0 = time.monotonic()
    reqs = run([req(0), req(1, presence_penalty=0.5, frequency_penalty=0.5),
                req(2, repetition_penalty=1.3),
                req(3, logit_bias=((FORCED_TOKEN, 100.0),)),
                req(0, logit_bias=((frequent, -100.0),)),
                req(0, min_tokens=16, stop_token_ids=(stop,)),
                req(6, logprobs=8),
                req(7, **dict(SAMPLED, seed=5, presence_penalty=0.5))])
    dt = time.monotonic() - t0
    launches = _launches()
    counts = dict(engine.counts)
    forwards = counts.get("decode_substeps", 0) + \
        counts.get("mixed_dispatches", 0)
    log(f"{tag} 8 requests: {sum(len(r.generated) for r in reqs)} tokens in "
        f"{dt:.2f}s; dispatches {counts}; variant replays "
        f"{dict(dec.variant_replays)}; K1 {launches['paged_attention']}, "
        f"fused K2 {launches['prep_write_rows_paged']}")
    _check_replays(tag, engine, replays0)
    _check_fused_writes(tag, engine, launches, counts)
    if launches["paged_attention"] != cfg.num_layers * forwards:
        raise AssertionError(f"{tag} K1 launched "
                             f"{launches['paged_attention']} times, "
                             f"expected {cfg.num_layers} x {forwards}")
    plain, forced, banned, held, lp = (reqs[0], reqs[3], reqs[4], reqs[5],
                                       reqs[6])
    checks = {
        "forced token at every position":
            forced.generated == [FORCED_TOKEN] * FIELDS_NEW,
        f"banned token {frequent} absent": frequent not in banned.generated,
        f"stop id {stop} absent before min_tokens":
            stop not in held.generated[:16] and len(held.generated) >= 16,
        "logprob records": len(lp.logprob_data) == FIELDS_NEW,
    }
    _lp_rows_ok(tag, lp, greedy=True)
    # a request with every field at its neutral value: the bare stream
    neutral = run([req(0, presence_penalty=0.0, frequency_penalty=0.0,
                       repetition_penalty=1.0, logit_bias=(), min_tokens=0,
                       stop_token_ids=())])[0]
    checks["neutral = bare, bit for bit"] = neutral.generated == bare
    plp = run([Request(prompt_ids=prompts[3], max_tokens=4,
                       ignore_eos=True, prompt_logprobs=3)])[0]
    data = plp.prompt_logprob_data
    checks["prompt logprobs, one a position"] = \
        len(data) == len(prompts[3]) and data[0] is None
    for t, (own, top) in enumerate(data[1:], start=1):
        vals = [v for _, v in top]
        listed = [v for i, v in top if i == prompts[3][t]]
        if len(top) != 3 or vals != sorted(vals, reverse=True) or \
                (listed and listed[0] != own) or own > vals[0]:
            checks["prompt logprobs, one a position"] = False
    log(f"{tag} checks {checks}; the stop id's request finished "
        f"{held.finish_reason} after {len(held.generated)} tokens")
    if not all(checks.values()):
        raise AssertionError(f"{tag} {checks}")
    # each new variant's replay against eager decode_steps, 8 slots
    # running with their fields
    state_reqs = [engine.submit(r) for r in (
        req(0, logprobs=2), req(1, presence_penalty=0.5),
        req(2, repetition_penalty=1.3), req(3, logit_bias=((5, 3.0),)),
        req(4, min_tokens=40, stop_token_ids=(stop,)),
        req(5, **dict(SAMPLED, seed=9, frequency_penalty=0.4)), req(6),
        req(7, **dict(SAMPLED, seed=10, logprobs=1)))]
    while engine.pending or engine._chunk is not None:
        engine.step()
    engine.step()
    engine._settle_inflight()
    engine._decode_operands()
    H = engine.serving.decode_horizon
    for penalties, logprobs in ((True, False), (False, True), (True, True)):
        _variant_vs_eager(torch, engine, tag, H, penalties, logprobs)
    for r in state_reqs:
        engine.cancel(r)
    engine.run_until_idle()
    # a verify beside a slot it must skip (logprobs): the slot's every
    # token comes from the plain step, with its record
    engine.serving = dataclasses.replace(engine.serving, spec_decode=True)
    engine.counts.clear()
    pat = _pattern_prompts(rng, cfg.vocab_size, 4)
    spec = run([Request(prompt_ids=p, max_tokens=48, ignore_eos=True,
                        **({"logprobs": 1} if i == 0 else {}))
                for i, p in enumerate(pat)])
    engine.serving = dataclasses.replace(engine.serving, spec_decode=False)
    skipped = spec[0]
    if engine.counts["spec_dispatches"] <= 0 or \
            len(skipped.logprob_data) != 48 or \
            any(d is None for d in skipped.logprob_data):
        raise AssertionError(f"{tag} verify with an ineligible slot: "
                             f"{dict(engine.counts)}, records "
                             f"{len(skipped.logprob_data)}")
    log(f"{tag} {engine.counts['spec_dispatches']} verify dispatches beside "
        f"a logprobs slot: it took all 48 tokens (each with its record) "
        f"from the plain step; accepted "
        f"{engine.counts['spec_accepted_tokens']} of "
        f"{engine.counts['spec_drafted_tokens']} drafts of the others")
    # one horizon-8 dispatch of 8 slots per variant
    profiles = {}
    for name, extra in (("default", {}),
                        ("penalties", {"presence_penalty": 0.5}),
                        ("logprobs", {"logprobs": 8}),
                        ("both", {"presence_penalty": 0.5,
                                  "logprobs": 8})):
        rs = [engine.submit(Request(prompt_ids=rng.integers(
            0, cfg.vocab_size, 100).tolist(), max_tokens=400,
            ignore_eos=True, **(extra if i == 0 else {})))
            for i in range(8)]
        while engine.pending or engine._chunk is not None:
            engine.step()
        engine.step()
        stats = {}
        _profile_dispatch(torch, engine, f"{tag} profile {name}",
                          stats=stats)
        profiles[name] = stats
        for r in rs:
            engine.cancel(r)
        engine.run_until_idle()
    used = {k: v - variants0.get(k, 0)
            for k, v in dec.variant_replays.items()}
    log(f"{tag} replays by (penalties, logprobs) over the phase: {used}")
    if len(used) != 4 or min(used.values()) <= 0:
        raise AssertionError(f"{tag} a decode variant never replayed: "
                             f"{used}")
    engine.serving = orig
    return profiles


# the prefix phase: the chat-turn pattern on Qwen3-0.6B at the defaults
# (prefix cache on, a 256 MiB host tier), the pool cut to PREFIX_POOL_PAGES
# pages of 64 rows so that fillers push A's pages out to the host tier.
# A 1,536-token history (a chunk boundary of prefill_chunk 256) and 64-token
# tails: a hit's single suffix chunk has the cold walk's last chunk's shape
# and rows.
PREFIX_HISTORY = 1536
PREFIX_TAIL = 64
PREFIX_NEW = 32
PREFIX_BURST = 8
# the burst (24 shared pages + 2 of its own a request) fits at once; the
# fillers then reclaim what the LRU holds before A's history pages
PREFIX_POOL_PAGES = 68
# each time to first token is taken PREFIX_REPS times (median and range):
# the cold and resident turns over prompts of A's shape, A last; the
# restore of A after each round of at most PREFIX_MAX_FILLERS fillers
PREFIX_REPS = 5
PREFIX_MAX_FILLERS = 5


def _prefix_wrappers(torch, engine, attn, ragged, restores, spills):
    """Wrap one engine's mixed dispatch (the K1 launches of its ragged
    entry, counted into ``ragged``), its restore and its spill: CUDA events
    around what they queue, the restore's two parts apart (its payloads'
    copies to the device, ``paged_kv.upload_pages``, patched in the module
    until the returned undo is called; and the ``index_copy_`` into the
    pool): (upload start, upload end, copy start, copy end, pages, page
    ids) into ``restores``, (start, end, pages) into ``spills``."""
    from aws_k8s_ansible_provisioner_tpu_torch.serving import paged_kv as pkv

    mixed, restore, spill, upload = (engine._mixed_dispatch,
                                     engine._schedule_restore,
                                     engine._spill_reclaimed,
                                     pkv.upload_pages)
    uploads = []

    def events():
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def counted_mixed(*args):
        before = attn.launches
        out = mixed(*args)
        ragged[0] += attn.launches - before
        return out

    def timed_upload(entries, device):
        e0, e1 = events()
        e0.record()
        out = upload(entries, device)
        e1.record()
        uploads.append((e0, e1))
        return out

    def timed_restore(slot, pids, staged):
        e0, e1 = events()
        e0.record()
        restore(slot, pids, staged)
        e1.record()
        restores.append(uploads[-1] + (e0, e1, len(pids), list(pids)))

    def timed_spill():
        n = len(engine.allocator.evicted_log)
        if not n:
            return spill()
        e0, e1 = events()
        e0.record()
        spill()
        e1.record()
        spills.append((e0, e1, n))

    engine._mixed_dispatch = counted_mixed
    engine._schedule_restore = timed_restore
    engine._spill_reclaimed = timed_spill
    pkv.upload_pages = timed_upload

    def undo():
        pkv.upload_pages = upload

    return undo


def _first_token_logits(programs, engine, out):
    """Patch ``programs.sample`` to record, for ``engine``'s walk, the
    logits its final chunk samples the request's first token from
    (request id -> float32 [V]); returns the original."""
    sample = programs.sample

    def recording(logits, *args, **kw):
        st = engine._chunk
        if st is not None and logits.shape[0] == 1 and \
                st["off"] + engine._chunk_size >= len(st["ids"]):
            out[st["req"].id] = logits[0].float().clone()
        return sample(logits, *args, **kw)

    programs.sample = recording
    return sample


def phase_prefix(torch, np, kv_dtype):
    """The prefix cache and the host tier at the port's defaults (prefix
    cache on, host tier 256 MiB, the pipeline and the decode graphs on),
    Qwen3-0.6B at full width, the pool cut to PREFIX_POOL_PAGES pages; the
    chat-turn pattern: A (a 1,536-token history and a 64-token tail) cold
    with the engine idle, A again (a resident hit), 8 requests sharing the
    history with their own tails submitted together, fillers of A's length
    until A's history pages have all left the pool for the host tier, A
    once more (restored from the host); each time to first token taken
    PREFIX_REPS times. Launch counts zeroed just before and read just
    after (:func:`_prefix_run`). Then the 8 requests'
    first-token logits are held within LOGIT_TOL of the same requests on a
    ``prefix_cache=False`` engine of the same weights."""
    import dataclasses

    from aws_k8s_ansible_provisioner_tpu_torch.config import (QWEN3_0_6B,
                                                              ServingConfig)
    from aws_k8s_ansible_provisioner_tpu_torch.models.layers import init_params
    from aws_k8s_ansible_provisioner_tpu_torch.ops import paged_attention as pa
    from aws_k8s_ansible_provisioner_tpu_torch.serving import programs
    from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import (Engine,
                                                                      Request)

    cfg = QWEN3_0_6B
    quant = kv_dtype == "int8"
    tag = f"[prefix {'int8' if quant else 'bf16'}]"
    serving = ServingConfig(prefill_chunk=256, derived_seed=0,
                            kv_dtype=kv_dtype,
                            kv_pool_pages=PREFIX_POOL_PAGES)
    if not (serving.prefix_cache and serving.kv_host_tier_bytes > 0):
        raise AssertionError(f"{tag} the defaults serve no prefix cache or "
                             f"host tier: {serving}")

    def build(**over):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        params = init_params(cfg, gen, torch.bfloat16)
        return Engine(cfg, params, dataclasses.replace(serving, **over),
                      device="cuda")

    t0 = time.monotonic()
    engine = build()
    torch.cuda.synchronize()
    log(f"{tag} {cfg.name}, KV {'int8' if quant else serving.dtype}, "
        f"{_cache_layout(engine)}, {engine._page_bytes / 2**20:.2f} MiB a "
        f"page; host tier {serving.kv_host_tier_bytes / 2**20:.0f} MiB "
        f"({len(engine.host_tier._free_slots)} page slots); "
        f"{_dispatch_mode(engine)}; set-up {time.monotonic() - t0:.1f}s")
    rng = np.random.default_rng(71)
    V = cfg.vocab_size
    history = rng.integers(0, V, PREFIX_HISTORY).tolist()
    a = history + rng.integers(0, V, PREFIX_TAIL).tolist()
    # the other cold and resident turns: A's shape, histories of their own
    others = [rng.integers(0, V, len(a)).tolist()
              for _ in range(PREFIX_REPS - 1)]
    burst = [history + rng.integers(0, V, PREFIX_TAIL).tolist()
             for _ in range(PREFIX_BURST)]
    fillers = [rng.integers(0, V, len(a)).tolist()
               for _ in range(PREFIX_REPS * PREFIX_MAX_FILLERS)]
    engine.submit(Request(prompt_ids=fillers[0][:8], max_tokens=2,
                          ignore_eos=True))
    engine.run_until_idle()
    attn = pa.paged_attention_quant if quant else pa.paged_attention
    ragged, restores, spills = [0], [], []
    undo = _prefix_wrappers(torch, engine, attn, ragged, restores, spills)
    try:
        res = _prefix_run(torch, np, engine, tag, a, others, burst, fillers,
                          (attn, ragged, restores, spills))
    finally:
        undo()
    del engine
    _free(torch)
    # the same burst on an engine without the prefix cache (the same
    # weights): first-token logits
    ref = build(prefix_cache=False)
    logits_ref = {}
    sample = _first_token_logits(programs, ref, logits_ref)
    try:
        ref_reqs = [ref.submit(Request(prompt_ids=p, max_tokens=1,
                                       ignore_eos=True)) for p in burst]
        ref.run_until_idle()
    finally:
        programs.sample = sample
    errs = [float((res["logits_hit"][r.id] - logits_ref[q.id]).abs().max())
            for r, q in zip(res["burst_reqs"], ref_reqs)]
    if ref.counts["prefix_cache_hits"] or not max(errs) <= LOGIT_TOL:
        raise AssertionError(f"{tag} first-token logits of the hits vs "
                             f"prefix_cache=False: max abs {errs} (tol "
                             f"{LOGIT_TOL}); reference counts "
                             f"{dict(ref.counts)}")
    log(f"{tag} {PREFIX_BURST} hits' first-token logits vs the same "
        f"requests on a prefix_cache=False engine: max abs per request "
        f"{[round(e, 5) for e in errs]} (tol {LOGIT_TOL})")
    del ref
    _free(torch)
    res.update(logit_errs=errs)
    del res["logits_hit"], res["burst_reqs"]
    return res


def _spread(xs):
    """Median and range of a list of ms: 'median x ms (min y, max z)'."""
    return (f"median {statistics.median(xs):.2f} ms (min {min(xs):.2f}, "
            f"max {max(xs):.2f})")


def _prefix_run(torch, np, engine, tag, a, others, burst, fillers, probes):
    """The chat-turn run of :func:`phase_prefix` on ``engine`` (its wrappers
    in ``probes``: the attention wrapper, the ragged count, the restores'
    and the spills' events). Checks: the warm and restored streams equal
    the cold ones; the pages of every restore equal a snapshot of A's pages
    taken before the fillers, bit for bit; the counts the schedule implies;
    one replay per decode dispatch; K1's ragged entry, its decode entry,
    the combine and the row write launched in the run (K1's ragged entry
    over tables whose leading pages are shared is also held against its
    plain version on the pool, outside the counted run). Reported: time to
    first token, PREFIX_REPS samples each, of turns of A's shape cold and
    resident and of A restored; the restores' and the spills' bytes and
    device time."""
    from aws_k8s_ansible_provisioner_tpu_torch.serving import programs
    from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import Request

    attn, ragged, restores, spills = probes
    cfg = engine.cfg
    ps = engine.page_size
    page_bytes = engine._page_bytes
    n_hist = PREFIX_HISTORY // ps

    def ttft(prompt):
        """Submit ``prompt`` to the idle engine: ms to its first token (the
        fetch that emits it waits for its dispatch), then run it out."""
        torch.cuda.synchronize()
        t = time.monotonic()
        req = engine.submit(Request(prompt_ids=prompt, max_tokens=PREFIX_NEW,
                                    ignore_eos=True))
        while not req.generated:
            engine.step()
        ms = 1e3 * (time.monotonic() - t)
        engine.run_until_idle()
        torch.cuda.synchronize()
        _finish_ok(cfg, req, PREFIX_NEW)
        return req, ms

    engine.counts.clear()
    replays0 = engine.decoder.replays
    torch.cuda.synchronize()
    _reset_launches()
    t_run = time.monotonic()
    # cold, then a resident hit, for each turn of A's shape; A last, so that
    # its history is resident for the burst
    ttft_cold, ttft_hit = [], []
    for prompt in others + [a]:
        cold, ms = ttft(prompt)
        ttft_cold.append(ms)
        warm, ms = ttft(prompt)
        ttft_hit.append(ms)
        if warm.generated != cold.generated:
            raise AssertionError(f"{tag} a resident hit gave another stream "
                                 f"than its cold run")
    # the burst: first-token logits recorded for the reference comparison
    logits_hit = {}
    sample = _first_token_logits(programs, engine, logits_hit)
    try:
        reqs = [engine.submit(Request(prompt_ids=p, max_tokens=PREFIX_NEW,
                                      ignore_eos=True)) for p in burst]
        engine.run_until_idle()
    finally:
        programs.sample = sample
    for r in reqs:
        _finish_ok(cfg, r, PREFIX_NEW)
    # A's history pages, snapshot before the fillers push them out
    pages, n, _ = engine.allocator.lookup_prefix(a)
    if n < PREFIX_HISTORY:
        raise AssertionError(f"{tag} A's history is not resident after the "
                             f"burst ({n} tokens)")
    snap = {k: v[:, pages[:n_hist]].clone() for k, v in engine.cache.items()}
    # K1's ragged entry over the burst's tables (the history's pages shared
    # by every row): the 8 decode rows past the prompts and one tail's 64
    # chunk rows, held against the plain version on the engine's pool. Its
    # launches are kept out of the run's counts: read before, zeroed after
    torch.cuda.synchronize()
    counted = _launches()
    width = engine.pages_per_slot
    tables, limits = [], []
    for p in burst:
        own = engine.allocator.lookup_prefix(p)[0]
        tables.append(own + [0] * (width - len(own)))
        limits.append(len(p))
    tables += [tables[0]] * PREFIX_TAIL
    limits += list(PREFIX_HISTORY + 1 + np.arange(PREFIX_TAIL))
    shared_case = _attention_case(
        torch, np, engine.cache, np.array(limits), np.array(tables),
        cfg.num_layers - 1, f"ragged {PREFIX_BURST} + {PREFIX_TAIL} rows, "
        f"{n_hist} leading pages shared", chunk_start=len(burst))
    torch.cuda.synchronize()
    _reset_launches()
    # rounds of fillers until A's history has left the pool for the host
    # tier, then A restored from there
    ttft_restore, n_fill = [], 0
    for rep in range(PREFIX_REPS):
        for k in range(PREFIX_MAX_FILLERS + 1):
            found = engine.allocator.lookup_prefix(a)
            if found[1] == 0 and len(found[2]) >= n_hist:
                break
            if k == PREFIX_MAX_FILLERS:
                raise AssertionError(
                    f"{tag} round {rep}: A's history not all on the host "
                    f"after {k} fillers: {found[1]} tokens resident, "
                    f"{len(found[2])} host pages")
            ttft(fillers[n_fill])
            n_fill += 1
        queued = len(restores)
        restored, ms = ttft(a)
        ttft_restore.append(ms)
        if restored.generated != cold.generated:
            raise AssertionError(f"{tag} round {rep}: A restored from the "
                                 f"host gave another stream than its cold "
                                 f"run")
        if len(restores) != queued + 1:
            raise AssertionError(f"{tag} round {rep}: "
                                 f"{len(restores) - queued} restores queued")
        n_restored, pids = restores[-1][4:]
        same_bits = {k: bool(torch.equal(engine.cache[k][:, pids], snap[k]))
                     for k in snap}
        if n_restored != n_hist or not all(same_bits.values()):
            raise AssertionError(f"{tag} round {rep}: restored pages "
                                 f"{n_restored} (want {n_hist}), "
                                 f"bit-identical by leaf {same_bits}")
    torch.cuda.synchronize()
    run_s = time.monotonic() - t_run
    launches = {k: counted[k] + v for k, v in _launches().items()}
    upload_ms = [u0.elapsed_time(u1) for u0, u1, *_ in restores]
    copy_ms = [c0.elapsed_time(c1) for _, _, c0, c1, *_ in restores]
    restore_bytes = n_hist * page_bytes
    gbs = [restore_bytes / ms / 1e6 for ms in upload_ms]
    spill_ms = sum(s0.elapsed_time(s1) for s0, s1, _ in spills)
    spill_pages = sum(k for _, _, k in spills)
    counts = dict(engine.counts)
    n_hits = 2 * PREFIX_REPS + PREFIX_BURST
    want = {"prefix_cache_hits": n_hits,
            "prefix_tokens_reused": n_hits * PREFIX_HISTORY,
            "prefix_tier_hits_hbm": PREFIX_REPS + PREFIX_BURST,
            "prefix_tier_hits_host": PREFIX_REPS,
            "prefix_tier_hits_miss": PREFIX_REPS + n_fill,
            "kv_restore_bytes": PREFIX_REPS * restore_bytes,
            "kv_restore_dropped": 0}
    got = {k: counts.get(k, 0) for k in want}
    if got != want or counts.get("kv_spill_bytes", 0) < restore_bytes:
        raise AssertionError(f"{tag} counts {counts}, expected {want} and "
                             f"kv_spill_bytes >= {restore_bytes}")
    _check_replays(tag, engine, replays0)
    k1, write = attn.__name__, _kernel_names("ks" in engine.cache)[1]
    _check_fused_writes(tag, engine, launches, counts)
    decode = launches[k1] - ragged[0]
    if min(ragged[0], decode, launches["split_merge"], launches[write]) <= 0:
        raise AssertionError(f"{tag} K1 ragged {ragged[0]}, decode {decode}; "
                             f"launches {launches}")
    if launches[k1 + " chunk"] != ragged[0]:
        raise AssertionError(f"{tag} {ragged[0]} ragged launches, of which "
                             f"{launches[k1 + ' chunk']} took the chunk "
                             f"body")
    log(f"{tag} {PREFIX_REPS} turns of {len(a)} tokens cold then resident, "
        f"A restored {PREFIX_REPS} times: streams identical to the cold ones "
        f"({PREFIX_NEW} tokens); {PREFIX_BURST} requests sharing A's "
        f"{PREFIX_HISTORY}-token history, {n_fill} fillers; run {run_s:.2f}s;"
        f" counts {counts}; host tier {engine.host_tier.stats()}")
    log(f"{tag} time to first token ({PREFIX_REPS} samples each, engine "
        f"idle, prefill_chunk 256): cold {_spread(ttft_cold)}; resident hit "
        f"{_spread(ttft_hit)}; host restore {_spread(ttft_restore)}; samples"
        f" cold {[round(x, 2) for x in ttft_cold]}, hit "
        f"{[round(x, 2) for x in ttft_hit]}, restore "
        f"{[round(x, 2) for x in ttft_restore]}")
    log(f"{tag} restores: {n_hist} pages, {restore_bytes} bytes "
        f"({restore_bytes / 2**20:.1f} MiB) each: host -> device "
        f"{_spread(upload_ms)} of device time, GB/s median "
        f"{statistics.median(gbs):.2f} (min {min(gbs):.2f}, max "
        f"{max(gbs):.2f}); into the pool {_spread(copy_ms)}; restored pages "
        f"bit-identical to the snapshot every time; spills: {spill_pages} "
        f"pages, {counts.get('kv_spill_bytes', 0)} bytes, {spill_ms:.3f} ms "
        f"of device time between the events around them (gather and copies "
        f"to the host slots)")
    log(f"{tag} launches in the run (the shared-table check's kept out): K1 "
        f"({k1}) {launches[k1]}: ragged (mixed dispatches) {ragged[0]}, "
        f"their chunk rows through the chunk body {launches[k1 + ' chunk']}, "
        f"decode {decode}; {write} {launches[write]}; split_merge "
        f"{launches['split_merge']}")
    return {"ttft_cold_ms": ttft_cold, "ttft_hit_ms": ttft_hit,
            "ttft_restore_ms": ttft_restore, "upload_ms": upload_ms,
            "copy_ms": copy_ms, "restore_bytes": restore_bytes,
            "spill_ms": spill_ms, "spill_pages": spill_pages,
            "ragged_launches": ragged[0], "launches": launches,
            "shared_case": shared_case, "logits_hit": logits_hit,
            "burst_reqs": reqs}


def phase_sampling(torch, np):
    """Cost of the seeded noise: one ``sample`` call over 32 rows of the
    full vocabulary, all greedy vs all sampled (threefry keys and uniforms
    for 64 candidates a row): device time by CUDA events and device
    operations counted by torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from aws_k8s_ansible_provisioner_tpu_torch.config import QWEN3_0_6B
    from aws_k8s_ansible_provisioner_tpu_torch.ops.sampling import sample

    dev = torch.device("cuda")
    B, V = 32, QWEN3_0_6B.vocab_size
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    logits = torch.randn((B, V), generator=gen, device=dev) * 3
    args = {"greedy": torch.zeros(B, device=dev),
            "sampled": torch.full((B,), 0.8, device=dev)}
    top_k = torch.full((B,), 20, dtype=torch.int32, device=dev)
    top_p = torch.full((B,), 0.9, device=dev)
    seeds = torch.arange(B, device=dev) * 7919
    ctrs = torch.full((B,), 100, dtype=torch.int32, device=dev)
    out = {}
    for name, temp in args.items():
        def call():
            return sample(logits, temp, top_k, top_p, seeds, ctrs)
        ms = timed_ms(torch, call)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        ops = sum(e.count for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
        out[name] = (ms, ops)
    log(f"[sampling] sample() over {B} rows x {V} logits: greedy "
        f"{out['greedy'][0]:.4f} ms ({out['greedy'][1]} device operations), "
        f"seeded sampled {out['sampled'][0]:.4f} ms ({out['sampled'][1]} "
        f"device operations)")
    return out


def phase_logits(torch, np, engine):
    """One decode step's logits through the kernels vs through the plain
    versions (:func:`_logits_check`) after a few decode dispatches of 4
    requests."""
    from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import Request

    rng = np.random.default_rng(2)
    for n in (33, 70, 150, 90):
        engine.submit(Request(prompt_ids=rng.integers(
            0, engine.cfg.vocab_size, n).tolist(), max_tokens=64,
            ignore_eos=True))
    while engine.pending or engine._chunk is not None:
        engine.step()
    for _ in range(3):
        engine.step()                    # a few decode dispatches
    err = _logits_check(torch, engine, LOGIT_TOL)
    for s in engine._active_slots():
        engine.cancel(engine.slot_req[s])
    engine.step()
    return err


def _logits_check(torch, engine, tol, slots=None):
    """The next decode step of the engine's active slots (or of ``slots``:
    a dense slot keeps its rows and its length after it finishes) through
    the kernels and through the plain versions: logits within ``tol``; and
    in the kernels' step, every layer's attention output held against the
    plain version on the same inputs by the kernels' ulp rule (before the
    layers amplify the rounding). With a sliding window, the same step
    through the kernels at window 0 must differ by more than ``tol`` (the
    window is applied). Every forward runs on the engine's own pool or
    dense cache: each writes the step's K/V row at every layer before any
    row attends it, so none reads another's rows, and the engine's next
    step rewrites them (a paged slot first takes the page of its next row,
    as the engine's next dispatch would). The dense engine's step takes its
    decode_bblock.
    A sequence-parallel engine's kernels step writes each shard and merges
    K6's triples (its decode callback); its plain step writes each shard
    through the plain writers at the local rows and attends the rows
    gathered from the shards in order. A MoE engine's plain step also runs
    its MoE MLP through the plain versions (``_moe_plain_ragged``)."""
    from aws_k8s_ansible_provisioner_tpu_torch.models.layers import \
        prep_qk_plain
    from aws_k8s_ansible_provisioner_tpu_torch.ops import dense_attention as da
    from aws_k8s_ansible_provisioner_tpu_torch.ops import paged_attention as pa
    from aws_k8s_ansible_provisioner_tpu_torch.ops.attention import (
        make_decode_attend_carry, make_decode_attend_carry_paged)

    engine._settle_inflight()            # the host mirrors up to date
    if engine.paged:
        # the page of each slot's next row, as the engine's next dispatch
        # would take it: a slot whose length sits on a page edge has none
        # yet, and its table entry still names the scratch page 0 that the
        # idle slots write into in the same launch
        engine._ensure_pages(1)
    active = engine._active_slots() if slots is None else list(slots)
    dev = engine.device
    window = engine.cfg.sliding_window
    tok = torch.from_numpy(engine.last_token.copy()).to(dev)
    lens = torch.from_numpy(engine.lengths.copy()).to(dev)
    pool = engine.cache
    shards = pool if isinstance(pool, list) else [pool]
    quant = "ks" in shards[0]
    scales = (shards[0]["ks"], shards[0]["vs"]) if quant else ()
    rows = torch.tensor(active, device=dev)
    lengths = [int(engine.lengths[s]) for s in active]
    if engine.paged:
        table = torch.from_numpy(engine.table.copy()).to(dev)

        def plain_ctx(q, layer):
            return pa.paged_attention_plain(q[:, 0].contiguous(), pool["k"],
                                            pool["v"], lens + 1, layer, table,
                                            *scales, window=window)[:, None]

        def plain_write(k, v, layer):
            fn = pa.cache_write_rows_quant_paged_plain if quant \
                else pa.cache_write_rows_paged_plain
            fn(pool["k"], pool["v"], *scales, k[:, 0], v[:, 0], lens, layer,
               table)

        def kernel_attend(w):
            return make_decode_attend_carry_paged(lens, table, w)
    elif len(shards) > 1:
        s_local = shards[0]["k"].shape[3]

        def plain_ctx(q, layer):
            rows = {n: torch.cat([sh[n][layer] for sh in shards],
                                 dim=2)[None] for n in shards[0]}
            return da.dense_attention_plain(q.contiguous(), rows["k"],
                                            rows["v"], lens + 1, 0, window,
                                            rows.get("ks"), rows.get("vs"))

        def plain_write(k, v, layer):
            fn = da.cache_write_rows_quant_dense_plain if quant \
                else da.cache_write_rows_dense_plain
            for i, sh in enumerate(shards):
                fn(*sh.values(), k, v, (lens - i * s_local)[:, None], layer)

        def kernel_attend(w):
            return make_decode_attend_carry(lens, w, 1, engine.mesh)
    else:
        def plain_ctx(q, layer):
            return da.dense_attention_plain(q.contiguous(), pool["k"],
                                            pool["v"], lens + 1, layer,
                                            window, *scales)

        def plain_write(k, v, layer):
            fn = da.cache_write_rows_quant_dense_plain if quant \
                else da.cache_write_rows_dense_plain
            fn(pool["k"], pool["v"], *scales, k, v, lens[:, None], layer)

        def kernel_attend(w):
            return make_decode_attend_carry(lens, w, engine.decode_bblock)

    def plain_attend(q, k, v, cache_l):
        plain_write(k, v, cache_l[1])
        return plain_ctx(q, cache_l[1]), cache_l

    kernels = kernel_attend(window)
    worst = {"worst_row_max_ulps": 0.0, "worst_row_mean_ulps": 0.0}

    def checked_attend(q, k, v, cache_l, *prep):
        # a paged callback takes the raw q/k and the layer's QKPrep (its
        # row write applies the prologue): the plain attention gets q after
        # the plain prologue
        ctx, cache_l = kernels(q, k, v, cache_l, *prep)
        if prep:
            q, _ = prep_qk_plain(q, k, prep[0])
        layer = cache_l[1]
        check = _ulp_rows(torch, f"{engine.cfg.name} layer {layer} attention",
                          ctx[rows, 0], plain_ctx(q, layer)[rows, 0],
                          len(active), lambda bad: f"lengths {lengths}")
        for key in worst:
            worst[key] = max(worst[key], check[key])
        return ctx, cache_l

    checked_attend.fuses_qk_prep = getattr(kernels, "fuses_qk_prep", False)

    def step(attend):
        logits, _ = engine.model.forward_carry(tok[:, None], lens[:, None],
                                               pool, attend)
        return logits[rows, 0].float()

    lk = step(checked_attend)
    if engine.cfg.num_experts > 0:
        # the plain step's MoE MLP through the plain versions too
        from unittest import mock

        from aws_k8s_ansible_provisioner_tpu_torch.ops import moe

        with mock.patch.object(moe, "moe_mlp_ragged", _moe_plain_ragged(moe)):
            lp = step(plain_attend)
    else:
        lp = step(plain_attend)
    torch.cuda.synchronize()
    per_slot = (lk - lp).abs().amax(-1)
    err = float(per_slot.max())
    scale = float(lp.abs().max())
    agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    msg = ""
    if window > 0:
        d0 = float((step(kernel_attend(0)) - lp).abs().max())
        msg = (f"; the same step at window 0 differs by {d0:.3e} (must "
               f"exceed the tol)")
    layout = "paged" if engine.paged else \
        f"dense, {engine.decode_bblock} slots per CTA" if len(shards) == 1 \
        else f"dense, sp {len(shards)}"
    log(f"[logits {engine.cfg.name}] {'int8' if quant else 'bf16'} KV "
        f"({layout}), decode step over {len(active)} active slots (lengths "
        f"{lengths}): every layer's attention vs plain: worst row max "
        f"{worst['worst_row_max_ulps']:.2f} ulp, mean "
        f"{worst['worst_row_mean_ulps']:.3f} ulp (tol {ATTN_MAX_ULPS}/"
        f"{ATTN_MEAN_ULPS}); logits: max |logit| {scale:.3f}, kernels vs "
        f"plain max abs {err:.3e} (per slot "
        f"{[round(float(x), 4) for x in per_slot]}; tol {tol}), argmax "
        f"agreement {agree:.2f}{msg}")
    if not (math.isfinite(err) and err <= tol):
        raise AssertionError(f"decode logits differ: {err}")
    if window > 0 and not d0 > tol:
        raise AssertionError(f"the window changes the logits by only {d0}")
    return err


def _launches():
    """Every kernel's launch count, the split-KV combine's and the MoE
    kernels' included."""
    from aws_k8s_ansible_provisioner_tpu_torch.ops import dense_attention as da
    from aws_k8s_ansible_provisioner_tpu_torch.ops import moe
    from aws_k8s_ansible_provisioner_tpu_torch.ops import paged_attention as pa
    from aws_k8s_ansible_provisioner_tpu_torch.ops import split_kv

    return {**pa.launch_counts(), **da.launch_counts(),
            **split_kv.launch_counts(), **moe.launch_counts()}


def _reset_launches():
    from aws_k8s_ansible_provisioner_tpu_torch.ops import dense_attention as da
    from aws_k8s_ansible_provisioner_tpu_torch.ops import moe
    from aws_k8s_ansible_provisioner_tpu_torch.ops import paged_attention as pa
    from aws_k8s_ansible_provisioner_tpu_torch.ops import split_kv

    pa.reset_launch_counts()
    da.reset_launch_counts()
    split_kv.reset_launch_counts()
    moe.reset_launch_counts()


def _pattern_prompts(rng, vocab, n, reps=8, width=16):
    """Prompts of a random ``width``-token pattern repeated ``reps`` times:
    the prompt-lookup proposer finds the trailing n-gram in them."""
    return [rng.integers(0, vocab, width).tolist() * reps for _ in range(n)]


def phase_spec(torch, np, kv_dtype, paged=True, bblock=0):
    """Prompt-lookup speculative decoding on the main path: Qwen3-0.6B at
    full width, the default ServingConfig with spec_decode=True and the
    ``kv_dtype`` pool (``paged``; else the dense engine with ``bblock``
    slots per decode CTA and prefill_chunk 256); 8 greedy requests with
    repeated-pattern prompts and one seeded sampled request. Launch counts
    zeroed just before the run and read just after: verify dispatches,
    drafts and the verify kernel of this pool required, the other pool's
    kernels 0 (dense: the dense verify, row write and decode instance, no
    paged kernel). The same requests then
    run on the same engine with spec off: the sampled stream must be the
    same (the engine serves a sampled slot from the plain step only, never
    from a verify); equal greedy streams, tok/s and the acceptance rate are
    reported (in bf16 the 5-row verify rounds apart from the 1-row decode,
    which can flip a greedy near-tie)."""
    import dataclasses

    from aws_k8s_ansible_provisioner_tpu_torch.config import (QWEN3_0_6B,
                                                              ServingConfig)
    from aws_k8s_ansible_provisioner_tpu_torch.models.layers import init_params
    from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import (Engine,
                                                                      Request)

    cfg = QWEN3_0_6B
    quant = kv_dtype == "int8"
    # the prefix cache off: the same prompts run twice on the engine, spec
    # on and off, and must prefill alike (phase_prefix holds the cache)
    serving = ServingConfig(spec_decode=True, derived_seed=0,
                            kv_dtype=kv_dtype, paged=paged,
                            decode_bblock=bblock,
                            prefill_chunk=0 if paged else 256,
                            prefix_cache=False)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    engine = Engine(cfg, init_params(cfg, gen, torch.bfloat16), serving,
                    device="cuda")
    tag = f"[spec {kv_dtype}]" if paged else f"[dense spec {kv_dtype}]"
    rng = np.random.default_rng(21)
    prompts = _pattern_prompts(rng, cfg.vocab_size, 8)
    engine.submit(Request(prompt_ids=prompts[0][:8], max_tokens=2,
                          ignore_eos=True))
    engine.run_until_idle()

    def run():
        reqs = [engine.submit(Request(prompt_ids=p, max_tokens=64,
                                      ignore_eos=True)) for p in prompts]
        reqs.append(engine.submit(Request(prompt_ids=prompts[1],
                                          max_tokens=48, seed=3, **SAMPLED)))
        torch.cuda.synchronize()
        t0 = time.monotonic()
        engine.run_until_idle()
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        for r, m in zip(reqs, [64] * 8 + [48]):
            _finish_ok(cfg, r, m)
        return reqs, sum(len(r.generated) for r in reqs) / dt

    engine.counts.clear()
    torch.cuda.synchronize()
    _reset_launches()
    reqs, tps = run()
    launches = _launches()
    counts = dict(engine.counts)
    spec = ("paged_attention_spec", "paged_attention_spec_quant")
    mine = (spec[quant], _kernel_names(quant)[1])
    others = (spec[not quant], _kernel_names(not quant)[1])
    drafted = counts.get("spec_drafted_tokens", 0)
    accepted = counts.get("spec_accepted_tokens", 0)
    log(f"{tag} 8 greedy requests (16-token pattern x 8) + 1 seeded sampled: "
        f"{tps:.1f} tok/s end to end; dispatches {counts}; acceptance "
        f"{accepted}/{drafted} = {accepted / max(drafted, 1):.3f}; kernel "
        f"launches {launches}")
    if counts.get("spec_dispatches", 0) <= 0 or drafted <= 0:
        raise AssertionError(f"{tag} no verify dispatch or no draft: {counts}")
    if not paged:
        mine = (_dense_name("spec_attend_dense", quant),) \
            + _dense_kernel_names(engine)
        others = PAGED_KERNELS
    if min(launches[k] for k in mine) <= 0:
        raise AssertionError(f"{tag} a kernel of the path never launched: "
                             f"{launches}")
    if max(launches[k] for k in others) != 0:
        raise AssertionError(f"{tag} the other pool's kernels launched: "
                             f"{launches}")
    if paged:
        _check_fused_writes(tag, engine, launches, counts)
    else:
        _check_fused_dense(tag, cfg.num_layers, launches,
                           _dense_forwards(counts),
                           "dense forwards (decode substeps, verifies)")
    engine.serving = dataclasses.replace(serving, spec_decode=False)
    plain, plain_tps = run()
    engine.serving = serving
    same = sum(a.generated == b.generated for a, b in zip(reqs[:8], plain[:8]))
    on, off = reqs[8].generated, plain[8].generated
    first = next((i for i, (a, b) in enumerate(zip(on, off)) if a != b),
                 None)
    log(f"{tag} same engine with spec off: {plain_tps:.1f} tok/s; greedy "
        f"streams equal to the spec run: {same}/8; the seeded sampled "
        f"stream " + ("is identical" if first is None else
                      f"differs from token {first} of {len(on)} on"))
    if first is not None:
        raise AssertionError(f"{tag} the seeded sampled stream differs with "
                             f"spec on and off from token {first}")
    return engine, launches, {"tok_s": tps, "plain_tok_s": plain_tps,
                              "acceptance": accepted / max(drafted, 1),
                              "same_greedy": same, "sampled_first_diff":
                              first, "counts": counts}


def phase_verify(torch, np, engine):
    """One verify dispatch of 8 slots (7 greedy, 1 seeded sampled) held
    against plain decode steps of the same prefixes (the same tokens
    teacher-forced one row at a time, both through the kernels, on clones
    of the pool): the logits of row 0 and of every accepted row within
    LOGIT_TOL, and ``spec_decode_step``'s emitted tokens equal to the
    accept rule applied to the verify's argmax; the program's sampled row
    accepts nothing and draws ``sample`` of its row 0 keyed at lengths + 1
    (the engine skips it). Then the engine's verify dispatch timed and
    profiled (device time, idle share)."""
    from aws_k8s_ansible_provisioner_tpu_torch.ops.attention import (
        make_decode_attend_carry_paged, make_spec_attend_carry_paged)
    from aws_k8s_ansible_provisioner_tpu_torch.ops.sampling import sample
    from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import Request
    from aws_k8s_ansible_provisioner_tpu_torch.serving.programs import \
        spec_decode_step

    quant = "ks" in engine.cache
    tag = f"[verify {'int8' if quant else 'bf16'}]"
    rng = np.random.default_rng(31)
    for i, p in enumerate(_pattern_prompts(rng, engine.cfg.vocab_size, 8,
                                           reps=6)):
        engine.submit(Request(prompt_ids=p, max_tokens=400, **(
            dict(SAMPLED, seed=5) if i == 7 else dict(ignore_eos=True))))
    while engine.pending or engine._chunk is not None:
        engine.step()
    for _ in range(2):
        engine.step()
    engine._settle_inflight()            # the host mirrors up to date
    active = engine._active_slots()
    K = engine.serving.spec_k
    R = K + 1
    engine._ensure_pages(R)
    skip = engine._spec_skip(active)
    proposal = engine._propose_drafts([s for s in active if s not in skip])
    drafts, proposed = proposal if proposal is not None else (
        np.zeros((engine.num_slots, K), np.int32), {})
    dev = engine.device
    tokens = torch.from_numpy(np.concatenate(
        [engine.last_token[:, None], drafts], axis=1)).to(dev)
    lens = torch.from_numpy(engine.lengths.copy()).to(dev)
    table = torch.from_numpy(engine.table.copy()).to(dev)
    positions = lens[:, None] + torch.arange(R, dtype=lens.dtype,
                                             device=dev)[None]
    pool_a = {k: v.clone() for k, v in engine.cache.items()}
    pool_b = {k: v.clone() for k, v in engine.cache.items()}
    model = engine.model
    lv, _ = model.forward_carry(tokens, positions, pool_a,
                                make_spec_attend_carry_paged(lens, table))
    lp = torch.stack([model.forward_carry(
        tokens[:, r:r + 1], (lens + r)[:, None], pool_b,
        make_decode_attend_carry_paged(lens + r, table))[0][:, 0]
        for r in range(R)], dim=1)
    del pool_b
    sampling = [torch.from_numpy(a.copy()).to(dev) for a in (
        engine.temps, engine.top_ks, engine.top_ps, engine.seeds)]
    _, out, acc = spec_decode_step(model, R, pool_a, tokens, lens, table,
                                   *sampling)
    drawn = sample(lv[:, 0], *sampling, lens + 1).cpu().numpy()
    torch.cuda.synchronize()
    del pool_a
    preds = lv.argmax(-1).cpu().numpy()
    out, acc = out.cpu().numpy(), acc.cpu().numpy()
    lv, lp = lv.float(), lp.float()
    err = 0.0
    for b in active:
        m = 0
        while engine.temps[b] <= 0 and m < K and drafts[b, m] == preds[b, m]:
            m += 1
        want = list(drafts[b, :m]) + [preds[b, m] if engine.temps[b] <= 0
                                      else drawn[b]]
        if acc[b] != m + 1 or list(out[b, :m + 1]) != want:
            raise AssertionError(f"{tag} slot {b}: emitted {out[b, :acc[b]]}"
                                 f", the accept rule gives {want}")
        err = max(err, float((lv[b, :m + 1] - lp[b, :m + 1]).abs().max()))
    agree = float((lv.argmax(-1) == lp.argmax(-1))[active].float().mean())
    log(f"{tag} verify of {len(active)} slots x {R} rows ({len(proposed)} "
        f"drafted, accepted {[int(acc[b]) - 1 for b in active]}): logits of "
        f"row 0 and the accepted rows vs plain decode steps max abs "
        f"{err:.3e} (tol {LOGIT_TOL}); argmax agreement over all rows "
        f"{agree:.3f}; emitted tokens = the accept rule on the verify's "
        f"argmax, the sampled slot's draw keyed at lengths + 1")
    if not (math.isfinite(err) and err <= LOGIT_TOL):
        raise AssertionError(f"{tag} verify logits differ: {err}")
    _profile_verify(torch, np, engine, tag)
    for s in engine._active_slots():
        engine.cancel(engine.slot_req[s])
    engine.step()
    return err


def _profile_verify(torch, np, engine, tag):
    """One verify dispatch of the engine's active slots timed by the host
    clock, then the next under torch.profiler: device busy time, idle share
    and the kernels that take it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    R = engine.serving.spec_k + 1
    for label in ("timed", "profiled"):
        active = engine._active_slots()
        engine._ensure_pages(R)
        skip = engine._spec_skip(active)
        proposal = engine._propose_drafts([s for s in active
                                           if s not in skip])
        drafts, proposed = proposal if proposal is not None else (
            np.zeros((engine.num_slots, R - 1), np.int32), {})
        torch.cuda.synchronize()
        if label == "timed":
            t0 = time.monotonic()
            engine._do_spec_decode(active, drafts, proposed, skip)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.monotonic() - t0)
            continue
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            engine._do_spec_decode(active, drafts, proposed, skip)
            torch.cuda.synchronize()
            prof_wall_ms = 1e3 * (time.monotonic() - t0)
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    log(f"{tag} verify dispatch, {len(active)} slots x {R} rows: wall "
        f"{wall_ms:.2f} ms")
    if not events:
        log(f"{tag} torch.profiler recorded no device time: device busy "
            f"share not measured")
        return
    log(f"{tag} profiled verify: wall {prof_wall_ms:.2f} ms, device busy "
        f"{busy_ms:.2f} ms (idle share {1 - busy_ms / prof_wall_ms:.3f}), "
        f"{sum(e.count for e in events)} device operations")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"{tag}   {e.self_device_time_total / 1e3:8.3f} ms "
            f"{100 * e.self_device_time_total / 1e3 / busy_ms:5.1f}% "
            f"x{e.count:<5d} {e.key[:90]}")


def phase_draft(torch, np):
    """Draft-model speculation on the main path: Qwen3-0.6B at full width
    (int8 weights, bf16 paged KV, prefill_chunk 256) with two drafts of the
    same width over their dense cache: the target's own weights (a
    self-draft: acceptance near 1) and Qwen3-0.6B weights from another seed
    with an untied head rolled one vocab row (a divergent draft:
    rejections). A first wave of 6 requests decodes; a
    second wave of 2 prompts of 600 tokens walks in chunks beside it, so
    mixed dispatches advance the running slots past their draft rows and
    the draft catches up through the verify program (K7). Launch counts
    zeroed just before each run and read just after: K4, K7 and K8 > 0,
    the fused q/k prologue and row writes once a layer of every forward
    (the target's paged ones, the draft's dense rollout substeps and
    catch-ups), the standalone writes never; and accepted drafts > 0 with
    the self-draft."""
    from aws_k8s_ansible_provisioner_tpu_torch.config import (QWEN3_0_6B,
                                                              ServingConfig)
    from aws_k8s_ansible_provisioner_tpu_torch.models.layers import init_params
    from aws_k8s_ansible_provisioner_tpu_torch.models.quant import \
        quantize_params
    from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import (Engine,
                                                                      Request)

    cfg = QWEN3_0_6B
    serving = ServingConfig(spec_decode=True, spec_method="draft",
                            prefill_chunk=256, derived_seed=0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = quantize_params(init_params(cfg, gen, torch.bfloat16), cfg)
    # random Qwen3 weights with tied embeddings mostly repeat the current
    # token, so a draft from another seed would agree; an untied head
    # rolled one vocab row proposes another token (as
    # tests/test_draft_spec.py builds its divergent draft)
    dcfg = cfg.scaled(tie_embeddings=False)
    gen.manual_seed(1)
    other = init_params(dcfg, gen, torch.bfloat16)
    other["lm_head"] = {"kernel": torch.roll(other["embed"]["weight"], 1,
                                             0).T.contiguous()}
    rng = np.random.default_rng(41)
    wave1 = [rng.integers(0, cfg.vocab_size, n).tolist()
             for n in (40, 90, 130, 64, 200, 17)]
    wave2 = [rng.integers(0, cfg.vocab_size, 600).tolist() for _ in range(2)]
    out = {}
    for name, draft in (("self", (cfg, params)),
                        ("divergent", (dcfg, other))):
        engine = Engine(cfg, params, serving, device="cuda", draft=draft)
        engine.submit(Request(prompt_ids=wave1[0][:8], max_tokens=2,
                              ignore_eos=True))
        engine.run_until_idle()
        engine.counts.clear()
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.monotonic()
        first = [engine.submit(Request(prompt_ids=p, max_tokens=48,
                                       ignore_eos=True)) for p in wave1]
        while engine.pending:
            engine.step()
        engine.step()
        second = [engine.submit(Request(prompt_ids=p, max_tokens=24,
                                        ignore_eos=True)) for p in wave2]
        engine.run_until_idle()
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        launches = _launches()
        counts = dict(engine.counts)
        for r in first:
            _finish_ok(cfg, r, 48)
        for r in second:
            _finish_ok(cfg, r, 24)
        n_gen = 48 * len(first) + 24 * len(second)
        drafted = counts.get("spec_drafted_tokens", 0)
        accepted = counts.get("spec_accepted_tokens", 0)
        rate = accepted / max(drafted, 1)
        log(f"[draft {name}] {len(first)} + {len(second)} requests: {n_gen} "
            f"tokens in {dt:.2f}s ({n_gen / dt:.1f} tok/s); dispatches "
            f"{counts}; acceptance {accepted}/{drafted} = {rate:.3f}; "
            f"kernel launches {launches}")
        dense = ("decode_attend_dense", "spec_attend_dense",
                 "prep_write_rows_dense")
        if min(launches[k] for k in dense) <= 0:
            raise AssertionError(f"[draft {name}] a dense kernel never "
                                 f"launched (K4/K7/K8): {launches}")
        _check_draft_writes(f"[draft {name}]", engine, launches, counts)
        if counts.get("spec_dispatches", 0) <= 0 or drafted <= 0:
            raise AssertionError(f"[draft {name}] no verify or no draft: "
                                 f"{counts}")
        if name == "self" and accepted <= 0:
            raise AssertionError("[draft self] no draft token accepted")
        out[name] = {"launches": launches, "acceptance": rate,
                     "tok_s": n_gen / dt, "counts": counts}
        del engine
        torch.cuda.empty_cache()
    return out


def _check_draft_writes(tag, engine, launches, counts):
    """A run with a draft model: every layer of the target's paged forwards
    and of the draft's dense ones (its rollout substeps and catch-ups) went
    through the fused q/k prologue and row write of its cache."""
    _check_fused_writes(tag, engine, launches, counts)
    _check_fused_dense(tag, engine.draft.cfg.num_layers, launches,
                       counts.get("draft_rollout_substeps", 0)
                       + counts.get("draft_catch_ups", 0),
                       "draft forwards (rollout substeps, catch-ups)")


def _tree_bytes(tree) -> int:
    """Bytes of the tensors of a nested dict."""
    return sum(_tree_bytes(v) if isinstance(v, dict)
               else v.numel() * v.element_size() for v in tree.values())


def _mistral_engine(torch, serving, draft=False, repeating=False):
    """Mistral-7B-v0.1 at full width through ``Engine``: seeded random
    weights drawn layer by layer in bf16 and quantized to int8 before the
    engine is built, so that the bf16 tree (14.5 GB) is gone before the
    engine sizes its pool. ``draft``: the same weights serve as the draft
    model (a self-draft). ``repeating``: the untied head holds the
    embedding's rows and the embedding is scaled by REPEAT_EMBED_SCALE, so
    that the current token's embedding dominates what the head reads and
    the greedy stream repeats its token."""
    from aws_k8s_ansible_provisioner_tpu_torch.config import MISTRAL_7B_V01
    from aws_k8s_ansible_provisioner_tpu_torch.models.layers import init_params
    from aws_k8s_ansible_provisioner_tpu_torch.models.quant import \
        quantize_params
    from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import Engine

    cfg = MISTRAL_7B_V01
    t0 = time.monotonic()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = init_params(cfg, gen, torch.bfloat16)
    if repeating:
        emb = params["embed"]["weight"]
        params["lm_head"] = {"kernel": emb.T.contiguous()}
        params["embed"] = {"weight": emb * REPEAT_EMBED_SCALE}
    params = quantize_params(params, cfg)
    torch.cuda.synchronize()
    weights_gb = _tree_bytes(params) / 1e9
    engine = Engine(cfg, params, serving, device="cuda",
                    draft=(cfg, params) if draft else None)
    del params
    torch.cuda.synchronize()
    extra = (f", draft cache {_tree_bytes(engine.draft.cache) / 2**30:.2f} "
             f"GiB" if draft else "")
    log(f"[{cfg.name}] {cfg.num_layers} layers, hidden {cfg.hidden_size}, "
        f"MLP {cfg.intermediate_size}, heads {cfg.num_heads}/"
        f"{cfg.num_kv_heads}, vocab {cfg.vocab_size}, window "
        f"{cfg.sliding_window}; int8 weights {weights_gb:.2f} GB; KV "
        f"{serving.kv_dtype}, {serving.max_decode_slots} slots x "
        f"{serving.max_cache_len}, {_cache_layout(engine)}{extra}; "
        f"allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; set-up "
        f"{time.monotonic() - t0:.1f}s")
    return engine


def _mistral_serving(**kw):
    from aws_k8s_ansible_provisioner_tpu_torch.config import (MISTRAL_7B_V01,
                                                              ServingConfig)

    return ServingConfig(model=MISTRAL_7B_V01.name, max_decode_slots=16,
                         max_cache_len=8192, prefill_chunk=512,
                         derived_seed=0, **kw)


def _delta(after, before):
    return {k: after[k] - before[k] for k in after}


def phase_mistral(torch, np, kv_dtype, paged=True, bblock=0):
    """Mistral-7B-v0.1 at full width (window 4096) on the paged engine with
    the ``kv_dtype`` pool (or, ``paged`` False, the dense engine with its
    16 x 8192-row cache and ``bblock`` slots per decode CTA): 16 slots of
    8192 rows, prefill_chunk 512, int8 weights; 8 greedy requests with
    prompts of 30-7,900 tokens (four past the window) and 96 new tokens
    each, so that every long row's window start crosses a page (tile) edge.
    Once every prompt is in, the next decode step's logits are held against
    the plain versions and against window 0 (:func:`_logits_check`), and
    one decode dispatch is timed and profiled; those launches are taken out
    of the run's counts, which are zeroed just before the run and read just
    after: the pool's attention kernel (its window instance only) and row
    write > 0, the other pool's 0 (dense: the decode instance's window
    form and the row write, no paged kernel). With int8 KV a seeded sampled
    request, alone and beside running requests, gives one stream."""
    from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import Request

    quant = kv_dtype == "int8"
    engine = _mistral_engine(torch, _mistral_serving(
        kv_dtype=kv_dtype, paged=paged, decode_bblock=bblock))
    cfg = engine.cfg
    tag = f"[{cfg.name} {kv_dtype}{'' if paged else ' dense'}]"
    rng = np.random.default_rng(51)
    lens = [30, 300, 1500, 3000, 4500, 6000, 7900, 120]
    new = 96
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    engine.submit(Request(prompt_ids=prompts[0][:8], max_tokens=2,
                          ignore_eos=True))
    engine.run_until_idle()
    engine.counts.clear()
    replays0 = engine.decoder.replays
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.monotonic()
    reqs = [engine.submit(Request(prompt_ids=p, max_tokens=new,
                                  ignore_eos=True)) for p in prompts]
    while engine.pending or engine._chunk is not None:
        engine.step()
    torch.cuda.synchronize()
    t1 = time.monotonic()
    before, counts0 = _launches(), dict(engine.counts)
    _logits_check(torch, engine, MISTRAL_LOGIT_TOL)
    _profile_dispatch(torch, engine, f"[profile {cfg.name} {kv_dtype}"
                                     f"{'' if paged else ' dense'}]")
    checks = _delta(_launches(), before)
    check_counts = {k: v - counts0.get(k, 0)
                    for k, v in engine.counts.items()}
    t2 = time.monotonic()
    engine.run_until_idle()
    torch.cuda.synchronize()
    dt = time.monotonic() - t2 + t1 - t0
    counts = dict(engine.counts)
    n_gen = sum(len(r.generated) for r in reqs)
    if quant:
        _seeded_twice(engine, rng, Request)
    launches = _delta(_launches(), checks)
    # the run's dispatches (the seeded ones included), the checks' out
    run_counts = {k: v - check_counts.get(k, 0)
                  for k, v in engine.counts.items()}
    log(f"{tag} {len(reqs)} requests, prompts {lens}, {new} new tokens "
        f"each: {n_gen} tokens in {dt:.2f}s ({n_gen / dt:.1f} tok/s end to "
        f"end, {_dispatch_mode(engine)}, the checks' time taken out); "
        f"dispatches {counts}; kernel launches {launches}")
    for r in reqs:
        _finish_ok(cfg, r, new)
    _check_replays(tag, engine, replays0)
    if not paged:
        _check_dense_launches(tag, engine, launches, counts=run_counts)
        attn = _dense_kernel_names(engine)[0]
        if launches[attn[:-len(" window")]] != launches[attn]:
            raise AssertionError(f"{tag} the window-0 instance launched: "
                                 f"{launches}")
        return engine, launches
    attn, write = _kernel_names(quant)
    if launches[attn + " window"] <= 0 or launches[write] <= 0:
        raise AssertionError(f"{tag} a kernel of the path never launched: "
                             f"{launches}")
    if launches[attn] != launches[attn + " window"]:
        raise AssertionError(f"{tag} the window-0 instance launched: "
                             f"{launches}")
    if max(launches[k] for k in _kernel_names(not quant)
           + STANDALONE_WRITES) != 0:
        raise AssertionError(f"{tag} the other pool's kernels or a "
                             f"standalone row write launched: {launches}")
    if counts.get("mixed_dispatches", 0) <= 0:
        raise AssertionError(f"{tag} no chunked prefill through mixed_step")
    if launches[attn + " chunk window"] <= 0 or \
            launches[attn + " chunk"] != launches[attn + " chunk window"]:
        raise AssertionError(f"{tag} the chunk rows did not take the chunk "
                             f"body's window instance: {launches}")
    return engine, launches


def phase_mistral_spec(torch, np):
    """Prompt-lookup speculation with Mistral-7B-v0.1 at full width, bf16
    pool: 3 prompts that repeat a random 16-token pattern 270 times (4,320
    tokens, past the window) and one of 8 repeats, 48 new tokens each. The
    weights repeat their current token (``_mistral_engine(repeating=True)``)
    so that the proposer finds n-grams. Launch counts
    zeroed just before the run and read just after: verify dispatches,
    drafts and the verify kernel's window instance > 0. Then the 4 prompts
    again, and one verify dispatch past their prefill profiled."""
    from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import Request

    engine = _mistral_engine(torch, _mistral_serving(spec_decode=True),
                             repeating=True)
    cfg = engine.cfg
    tag = f"[{cfg.name} spec]"
    rng = np.random.default_rng(61)
    prompts = (_pattern_prompts(rng, cfg.vocab_size, 3, reps=270)
               + _pattern_prompts(rng, cfg.vocab_size, 1))
    engine.submit(Request(prompt_ids=prompts[3][:8], max_tokens=2,
                          ignore_eos=True))
    engine.run_until_idle()
    engine.counts.clear()
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.monotonic()
    reqs = [engine.submit(Request(prompt_ids=p, max_tokens=48,
                                  ignore_eos=True)) for p in prompts]
    engine.run_until_idle()
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    launches = _launches()
    counts = dict(engine.counts)
    for r in reqs:
        _finish_ok(cfg, r, 48)
    drafted = counts.get("spec_drafted_tokens", 0)
    accepted = counts.get("spec_accepted_tokens", 0)
    log(f"{tag} 4 greedy requests (prompts {[len(p) for p in prompts]}): "
        f"{48 * len(reqs) / dt:.1f} tok/s end to end with the prefill; "
        f"dispatches {counts}; acceptance {accepted}/{drafted} = "
        f"{accepted / max(drafted, 1):.3f}; kernel launches {launches}")
    if counts.get("spec_dispatches", 0) <= 0 or drafted <= 0:
        raise AssertionError(f"{tag} no verify dispatch or no draft: {counts}")
    spec = "paged_attention_spec"
    if launches[spec + " window"] <= 0 or \
            launches[spec] != launches[spec + " window"]:
        raise AssertionError(f"{tag} the verify's window instance: "
                             f"{launches}")
    # one verify dispatch of the 4 slots past their prefill, profiled
    for p in prompts:
        engine.submit(Request(prompt_ids=p, max_tokens=400, ignore_eos=True))
    while engine.pending or engine._chunk is not None:
        engine.step()
    engine.step()
    _profile_verify(torch, np, engine, tag)
    for s in engine._active_slots():
        engine.cancel(engine.slot_req[s])
    engine.step()
    del engine
    return launches


def phase_mistral_draft(torch, np):
    """A self-draft of Mistral-7B-v0.1 at full width (the target's int8
    weights, its own dense bf16 cache of 16 slots x 8192 rows, 17.2 GB)
    beside the bf16 pool: 6 requests, then 2 prompts of 600 tokens walked
    in chunks so that mixed dispatches put the drafts behind and they catch
    up. Launch counts zeroed just before the run and read just after: the
    window instances of K4 (rollout) and K7 (catch-up), and the fused K8, >
    0, the fused writes once a layer of every target and draft forward;
    accepted drafts > 0."""
    from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import Request

    engine = _mistral_engine(torch, _mistral_serving(
        spec_decode=True, spec_method="draft"), draft=True)
    cfg = engine.cfg
    tag = f"[{cfg.name} draft]"
    rng = np.random.default_rng(71)
    wave1 = [rng.integers(0, cfg.vocab_size, n).tolist()
             for n in (40, 90, 130, 64, 200, 17)]
    wave2 = [rng.integers(0, cfg.vocab_size, 600).tolist() for _ in range(2)]
    engine.submit(Request(prompt_ids=wave1[0][:8], max_tokens=2,
                          ignore_eos=True))
    engine.run_until_idle()
    engine.counts.clear()
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.monotonic()
    first = [engine.submit(Request(prompt_ids=p, max_tokens=48,
                                   ignore_eos=True)) for p in wave1]
    while engine.pending:
        engine.step()
    engine.step()
    second = [engine.submit(Request(prompt_ids=p, max_tokens=24,
                                    ignore_eos=True)) for p in wave2]
    engine.run_until_idle()
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    launches = _launches()
    counts = dict(engine.counts)
    for r in first:
        _finish_ok(cfg, r, 48)
    for r in second:
        _finish_ok(cfg, r, 24)
    drafted = counts.get("spec_drafted_tokens", 0)
    accepted = counts.get("spec_accepted_tokens", 0)
    n_gen = 48 * len(first) + 24 * len(second)
    log(f"{tag} {len(first)} + {len(second)} requests: {n_gen} tokens in "
        f"{dt:.2f}s ({n_gen / dt:.1f} tok/s); dispatches {counts}; "
        f"acceptance {accepted}/{drafted} = {accepted / max(drafted, 1):.3f};"
        f" kernel launches {launches}")
    if min(launches[k] for k in ("decode_attend_dense window",
                                 "spec_attend_dense window",
                                 "prep_write_rows_dense")) <= 0:
        raise AssertionError(f"{tag} a dense kernel's window instance never "
                             f"launched: {launches}")
    _check_draft_writes(tag, engine, launches, counts)
    if accepted <= 0:
        raise AssertionError(f"{tag} no draft token accepted: {counts}")
    del engine
    return launches


# -- sequence-parallel serving (K6 and the log-sum-exp merge) ------------------

# the sp engine runs: Qwen3-0.6B, 4 slots of 32768 rows (8192 rows a shard
# at sp 4), prompts crossing 0 to 3 shard edges at sp 4
SP_SLOTS, SP_WINDOW, SP_CHUNK = 4, 32768, 512
# the sp engine runs' depth (of Qwen3-0.6B's 28 layers; full width): the
# run's time limit holds the mesh phase too
SP_LAYERS = 8
SP_PROMPTS = (40, 6000, 14000, 27000)
SP_NEW = 32
# the seeded sampled request of the int8 sp 4 run: its prompt crosses the
# first shard edge
SP_SEEDED_PROMPT = 9000


def _stats_check(torch, what, got, ref, B):
    """K6 against its plain version on one shard: m and l within 1e-3
    relative (m against max(|m|, 1)) on the slots with rows, and acc / l
    by the ulp rule; a slot
    with no row in the shard must give exactly (0, -1e30, 0)."""
    acc, m, l_sum = got
    racc, rm, rl = ref
    live = rl[:, 0] > 0
    empty = ~live
    if empty.any() and not (bool((m[empty] == -1e30).all())
                            and not l_sum[empty].any()
                            and not acc[empty].any()):
        raise AssertionError(f"{what}: an empty shard is not (0, -1e30, 0)")
    # m relative to max(|m|, 1): a running max near 0 has no relative scale
    rel = max(float(((m[live] - rm[live]).abs()
                     / rm[live].abs().clamp_min(1.0)).max()),
              float(((l_sum[live] - rl[live]).abs() / rl[live]).max())) \
        if live.any() else 0.0
    if not rel <= 1e-3:
        raise AssertionError(f"{what}: m or l off by {rel:.3e} relative")
    n = int(live.sum())
    check = _ulp_rows(torch, what, (acc / l_sum[..., None])[live],
                      (racc / rl[..., None])[live], n,
                      lambda bad: f"live slots {bad.tolist()}")
    return {**check, "m_l_rel_err": rel, "empty_slots": int(empty.sum())}


def _lse_library_ms(torch, q4, kd, vd, bias):
    """Yardstick of K6: one memory-efficient attention call that also
    returns the log-sum-exp (``_scaled_dot_product_efficient_attention``
    with ``compute_log_sumexp``), or SDPA when that op refuses the shapes;
    returns (ms, the call's name)."""
    op = torch.ops.aten._scaled_dot_product_efficient_attention
    try:
        op(q4, kd, vd, bias, True)
    except RuntimeError as e:
        log(f"[kernels sp] efficient attention refused the shapes "
            f"({str(e).splitlines()[0][:200]}); SDPA instead")
        sdpa = torch.nn.functional.scaled_dot_product_attention
        return timed_ms(torch, lambda: sdpa(q4, kd, vd, attn_mask=bias)), \
            "scaled_dot_product_attention"
    return timed_ms(torch, lambda: op(q4, kd, vd, bias, True)), \
        "_scaled_dot_product_efficient_attention(compute_log_sumexp=True)"


def _k6_case(torch, np, shard, local_np, q, layer, label):
    """K6 over one shard at its local lengths, against its plain version
    (:func:`_stats_check`), timed beside the plain version, the library
    yardstick over the shard's live rows (int8 dequantized to bf16
    beforehand) and the bound: the live rows' K/V (and scale) bytes, q and
    the outputs, over the memory rate."""
    from aws_k8s_ansible_provisioner_tpu_torch.ops import dense_attention as da
    from aws_k8s_ansible_provisioner_tpu_torch.serving.kv_cache import \
        dequantize

    quant = "ks" in shard
    scales = (shard["ks"], shard["vs"]) if quant else ()
    dev = q.device
    B, _, hq, D = q.shape
    Hkv = shard["k"].shape[2]
    local = torch.from_numpy(local_np.astype(np.int32)).to(dev)
    what = f"{_dense_name('decode_attend_dense', quant)} stats {label}"

    def kernel():
        return da.decode_attend_dense_stats(q, shard["k"], shard["v"], local,
                                            layer, *scales)

    def plain():
        return da.dense_attention_stats_plain(q, shard["k"], shard["v"],
                                              local, layer, *scales)

    got, ref = kernel(), plain()
    torch.cuda.synchronize()
    check = _stats_check(torch, what, got, ref, B)
    ms = timed_ms(torch, kernel)
    dev_ms = device_ms(torch, kernel)
    plain_ms = timed_ms(torch, plain, iters=5, warmup=1)
    n = max(int(local_np.max()), 1)
    kd, vd = (shard[name][layer][:, :, :n] for name in ("k", "v"))
    if quant:
        kd = dequantize(kd, shard["ks"][layer][:, :, :n], torch.bfloat16)
        vd = dequantize(vd, shard["vs"][layer][:, :, :n], torch.bfloat16)
    q4 = q[:, 0].reshape(B, Hkv, hq // Hkv, D)
    live = torch.arange(n, device=dev)[None, :] < local[:, None]
    bias = torch.where(live, 0.0, -1e30).to(q.dtype)[:, None, None, :] \
        .expand(B, Hkv, hq // Hkv, n).contiguous()
    library_ms, library = _lse_library_ms(torch, q4, kd.contiguous(),
                                          vd.contiguous(), bias)
    del kd, vd
    row = D * shard["k"].element_size() + (4 if quant else 0)
    rows = int(local_np.sum())
    nbytes = (2 * rows * Hkv * row + B * hq * D * 2 + B * hq * (D + 2) * 4
              + B * 4)
    ops = 4 * hq * D * rows
    res = _report(what, check, ms, dev_ms, plain_ms, library_ms, nbytes,
                  ops, B,
                  da.attention_splits(B, Hkv, shard["k"].shape[3], dev),
                  extra=f"; library: {library}; m, l within "
                        f"{check['m_l_rel_err']:.2e} relative; "
                        f"{check['empty_slots']} empty slots")
    res["library"] = library
    return res


def phase_kernels_sp(torch, np):
    """K6 at the sp engine's shapes: a dense cache [28, 4, 8, 32768, 128]
    (bf16, then int8 with its scales) whose 4 slots hold 41, 6034, 14002
    and 27033 rows (SP_PROMPTS and a few decode steps), split into 4
    shards of 8192 rows and into 2 of 16384
    (each copied out contiguous, as the engine allocates its shards). K6
    over every shard at its local lengths against its plain version (the
    empty shards exact), the shards' triples merged as the engine merges
    them held against K4 (int8: K4-int8) over the whole cache by the ulp
    rule row by row; K6 over the first shard of the 4 (the busiest) timed
    beside its plain version, the library yardstick and its bound; the
    decode's fused q/k prologue and row write into the second shard of the
    4 (one slot's row kept, three dropped)."""
    from aws_k8s_ansible_provisioner_tpu_torch.config import QWEN3_0_6B as cfg
    from aws_k8s_ansible_provisioner_tpu_torch.ops import dense_attention as da
    from aws_k8s_ansible_provisioner_tpu_torch.ops.attention import \
        merge_stats

    L, Hkv, D, hq = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, \
        cfg.num_heads
    B, S, layer = SP_SLOTS, SP_WINDOW, cfg.num_layers - 1
    # the rows of the prompts plus a few decode steps
    lengths = np.array(SP_PROMPTS) + np.array([1, 34, 2, 33])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(29)
    out = {}
    for name in ("bf16", "int8"):
        quant = name == "int8"
        full = _dense_cache(torch, gen, (L, B, Hkv, S, D), quant)
        scales = (full["ks"], full["vs"]) if quant else ()
        q = torch.randn((B, 1, hq, D), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        lens = torch.from_numpy(lengths.astype(np.int32)).cuda()
        k4 = da.decode_attend_dense(q, full["k"], full["v"], lens, layer, 0,
                                    *scales)[:, 0]
        res = out[name] = {}
        # K4 over the whole cache: a 27,033-row slot split over many CTAs
        res["k4"] = _dense_attention_case(
            torch, np, full, lengths, layer, 1,
            f"decode, {B} slots of {lengths.tolist()} rows")
        for sp in (4, 2):
            s_local = S // sp
            parts = []
            for i in range(sp):
                shard = {n: t[:, :, :, i * s_local:(i + 1) * s_local]
                         .contiguous() for n, t in full.items()}
                local = np.clip(lengths - i * s_local, 0, s_local)
                label = f"sp {sp} shard {i}, local lengths {local.tolist()}"
                if sp == 4 and i == 0:
                    res["stats"] = _k6_case(torch, np, shard, local, q, layer,
                                            label)
                else:
                    local_t = torch.from_numpy(local.astype(np.int32)).cuda()
                    args = (q, shard["k"], shard["v"], local_t, layer,
                            *((shard["ks"], shard["vs"]) if quant else ()))
                    _stats_check(torch, f"K6 {name} {label}",
                                 da.decode_attend_dense_stats(*args),
                                 da.dense_attention_stats_plain(*args), B)
                parts.append(da.decode_attend_dense_stats(
                    q, shard["k"], shard["v"],
                    torch.from_numpy(local.astype(np.int32)).cuda(), layer,
                    *((shard["ks"], shard["vs"]) if quant else ())))
                if sp == 4 and i == 1:
                    # the decode's fused write into a shard that owns one
                    # slot's new row (the others drop), after K6 read it
                    rows = (lengths - i * s_local)[:, None]
                    res["prep"] = _prep_case(
                        torch, np, shard, rows, None, lengths[:, None],
                        layer,
                        f"sp {sp} shard {i}, rows {rows[:, 0].tolist()}",
                        hq, cfg.rope_theta, cfg.qk_norm)
                del shard
            merged = merge_stats(*zip(*parts), q.device).to(q.dtype)
            torch.cuda.synchronize()
            res[f"merge sp {sp}"] = _ulp_rows(
                torch, f"K6 {name} merged over {sp} shards vs K4", merged,
                k4, B, lambda bad: f"lengths {lengths[bad].tolist()}")
            log(f"[kernels sp] {name}: K6 over {sp} shards of {s_local} rows "
                f"(lengths {lengths.tolist()}), merged, against "
                f"{_dense_name('decode_attend_dense', quant)} over the whole "
                f"cache: worst row max "
                f"{res[f'merge sp {sp}']['worst_row_max_ulps']:.2f} ulp, "
                f"mean {res[f'merge sp {sp}']['worst_row_mean_ulps']:.3f} "
                f"ulp (tol {ATTN_MAX_ULPS}/{ATTN_MEAN_ULPS})")
            del parts
            torch.cuda.empty_cache()
        del full
        torch.cuda.empty_cache()
    return out


def _sp_cfg():
    """Qwen3-0.6B at full width, its depth cut to SP_LAYERS."""
    from aws_k8s_ansible_provisioner_tpu_torch.config import QWEN3_0_6B

    return QWEN3_0_6B.scaled(num_layers=SP_LAYERS)


def _sp_params(torch):
    """The sp engines' seeded random weights (:func:`_sp_cfg`), quantized to
    int8 once for every sp engine run (as the engine would quantize
    them)."""
    from aws_k8s_ansible_provisioner_tpu_torch.models.layers import init_params
    from aws_k8s_ansible_provisioner_tpu_torch.models.quant import \
        quantize_params

    cfg = _sp_cfg()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return quantize_params(init_params(cfg, gen, torch.bfloat16), cfg)


def phase_sp_engine(torch, np, params, kv_dtype, sp, profile=True):
    """The sequence-parallel path: Qwen3-0.6B at full width (SP_LAYERS of
    its layers) through
    ``Engine(..., mesh=make_mesh(MeshConfig(sp=sp), [cuda:0] * sp))`` (sp 1:
    the dense engine without a mesh, the yardstick of the greedy streams),
    4 slots of 32768 rows, prefill_chunk 512; 4 greedy requests with
    prompts of SP_PROMPTS tokens and SP_NEW new tokens each, launch counts
    zeroed just before and read just after: K6 and the fused q/k prologue
    and row write (K8; int8: K9) each ``L x sp`` times per decode substep
    and no other kernel (sp 1: K4 and the fused row write). With int8 KV a
    seeded sampled request rides along and is drawn again alone
    afterwards: the same stream. The sp 1 run records the top-2 logit gap
    of every row it samples, by (seed, context length). ``profile``: one
    decode dispatch of the 4 slots profiled afterwards. Returns (engine, launches, the
    greedy requests, {(seed, context length): gap} or None)."""
    from aws_k8s_ansible_provisioner_tpu_torch.config import (MeshConfig,
                                                              ServingConfig)
    from aws_k8s_ansible_provisioner_tpu_torch.ops import dense_attention as da
    from aws_k8s_ansible_provisioner_tpu_torch.parallel.mesh import make_mesh
    from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import (Engine,
                                                                      Request)

    cfg = _sp_cfg()
    quant = kv_dtype == "int8"
    # the prefix cache off: the seeded request runs twice and must prefill
    # alike both times (phase_prefix holds the cache)
    serving = ServingConfig(max_decode_slots=SP_SLOTS,
                            max_cache_len=SP_WINDOW, prefill_chunk=SP_CHUNK,
                            paged=False, derived_seed=0, kv_dtype=kv_dtype,
                            prefix_cache=False)
    mesh = make_mesh(MeshConfig(sp=sp), [torch.device("cuda", 0)] * sp) \
        if sp > 1 else None
    t0 = time.monotonic()
    engine = Engine(cfg, params, serving, device="cuda", mesh=mesh)
    torch.cuda.synchronize()
    tag = f"[sp {sp} {'int8' if quant else 'bf16'}]"
    shards = engine.cache if sp > 1 else [engine.cache]
    log(f"{tag} {cfg.name}: {cfg.num_layers} layers, hidden "
        f"{cfg.hidden_size}, vocab {cfg.vocab_size}; int8 weights, KV "
        f"{'int8' if quant else 'bf16'}; {_cache_layout(engine)}; bytes per "
        f"shard {[_tree_bytes(sh) for sh in shards]}; set-up "
        f"{time.monotonic() - t0:.1f}s")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in SP_PROMPTS]
    seeded = rng.integers(0, cfg.vocab_size, SP_SEEDED_PROMPT).tolist()
    engine.submit(Request(prompt_ids=prompts[0][:8], max_tokens=2,
                          ignore_eos=True))
    engine.run_until_idle()
    engine.counts.clear()
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.monotonic()
    reqs = [engine.submit(Request(prompt_ids=p, max_tokens=SP_NEW,
                                  ignore_eos=True)) for p in prompts]
    if quant:
        reqs.append(engine.submit(Request(prompt_ids=seeded,
                                          max_tokens=SP_NEW, seed=5,
                                          **SAMPLED)))
    gaps = _recording_gaps(torch, engine.run_until_idle) if sp == 1 \
        else engine.run_until_idle()
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    launches = _launches()
    counts = dict(engine.counts)
    n_gen = sum(len(r.generated) for r in reqs)
    log(f"{tag} {len(reqs)} requests, prompts "
        f"{[len(r.prompt_ids) for r in reqs]}: {n_gen} tokens in {dt:.2f}s "
        f"({n_gen / dt:.1f} tok/s end to end, {_dispatch_mode(engine)}); "
        f"dispatches {counts}; kernel launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    for r in reqs:
        _finish_ok(cfg, r, SP_NEW)
    substeps = counts.get("decode_substeps", 0)
    if substeps <= 0 or counts.get("chunk_dispatches", 0) <= 0:
        raise AssertionError(f"{tag} no decode substep or no chunk: {counts}")
    write = FUSED_DENSE_WRITES[quant]
    attn = _dense_name("decode_attend_dense", quant, stats=sp > 1)
    expected = {attn: cfg.num_layers * sp * substeps,
                write: cfg.num_layers * sp * substeps}
    # each attention launch of more than one split is followed by a combine
    splits = da.attention_splits(SP_SLOTS, cfg.num_kv_heads,
                                 SP_WINDOW // sp, torch.device("cuda"))
    if splits > 1:
        expected["split_merge"] = expected[attn]
    other = {k: v for k, v in launches.items() if v and k not in expected}
    if any(launches[k] != n for k, n in expected.items()) or other:
        raise AssertionError(f"{tag} launches {launches}, expected "
                             f"{expected} ({substeps} decode substeps) and "
                             f"no other kernel")
    log(f"{tag} {attn}: {launches[attn]} launches = {cfg.num_layers} layers "
        f"x sp {sp} x {substeps} decode substeps; {write} the same; "
        f"split_merge {launches['split_merge']} ({splits} splits a launch)")
    if quant:
        again = engine.submit(Request(prompt_ids=seeded, max_tokens=SP_NEW,
                                      seed=5, **SAMPLED))
        engine.run_until_idle()
        if again.generated != reqs[-1].generated:
            raise AssertionError(f"{tag} the seeded sampled stream differs "
                                 f"when drawn again alone")
        log(f"{tag} seeded sampled request (seed 5, prompt "
            f"{SP_SEEDED_PROMPT} tokens) beside the 4 greedy ones and again "
            f"alone: identical {SP_NEW}-token streams, "
            f"{len(set(again.generated))} distinct tokens")
    if profile:
        _profile_sp_decode(torch, engine, tag)
    return engine, launches, reqs[:len(prompts)], gaps


def _recording_gaps(torch, run):
    """``run()`` with every row the engine samples recorded: {(the row's
    seed, its context length): top-1 minus top-2 logit}."""
    from aws_k8s_ansible_provisioner_tpu_torch.serving import programs

    gaps = {}
    sample = programs.sample

    def recording(logits, temperature, top_k, top_p, seeds, ctrs, *rest):
        top2 = torch.topk(logits.float(), 2, dim=-1).values
        for key, gap in zip(zip(seeds.tolist(), ctrs.tolist()),
                            (top2[:, 0] - top2[:, 1]).tolist()):
            gaps[key] = gap
        return sample(logits, temperature, top_k, top_p, seeds, ctrs, *rest)

    programs.sample = recording
    try:
        run()
    finally:
        programs.sample = sample
    return gaps


def _profile_sp_decode(torch, engine, tag):
    """One decode dispatch (horizon decode_horizon) of all 4 slots at the
    lengths the run left them (a finished dense slot keeps its rows), as
    ``programs.decode_steps`` with the engine's mesh: host-clock wall, then
    profiled (device time by kernel, idle share). Its rows land past each
    slot's length, where nothing attends them before they are rewritten."""
    from aws_k8s_ansible_provisioner_tpu_torch.serving.programs import \
        decode_steps

    args = [engine._dev(a) for a in (engine.last_token, engine.lengths,
                                     engine.temps * 0,
                                     engine.top_ks, engine.top_ps,
                                     engine.seeds)]
    tok, lens, temps, top_ks, top_ps, seeds = args

    def step():
        decode_steps(engine.model, engine.serving.decode_horizon,
                     engine.cache, tok, lens, None, temps, top_ks, top_ps,
                     seeds, mesh=engine.mesh)

    log(f"{tag} profiled decode at lengths {engine.lengths.tolist()}")
    return _profile_dispatch(torch, engine, tag, step, engine.num_slots)



def _greedy_vs_sp1(tag, streams, ref_reqs, ref_gaps):
    """The sp engine's greedy streams against the sp 1 dense engine's on the
    same weights and prompts: how many are identical, and for each that
    parts, the token where it parts and the sp 1 engine's top-2 logit gap
    at that draw (recorded in its run)."""
    ref_streams = [r.generated for r in ref_reqs]
    same = sum(a == b for a, b in zip(streams, ref_streams))
    parts = []
    for r, a, b in zip(ref_reqs, streams, ref_streams):
        if a != b:
            step = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
            parts.append((len(r.prompt_ids), step,
                          ref_gaps[(r.eff_seed, len(r.prompt_ids) + step)]))
    log(f"{tag} greedy streams identical to the sp 1 dense engine's: "
        f"{same}/{len(streams)}"
        + "".join(f"; prompt {n} parts at token {step} (sp 1 top-2 logit "
                  f"gap there {gap:.4f})" for n, step, gap in parts))
    return same, parts


def phase_server(engine, lifecycle=False, fields=False):
    """The HTTP server over ``engine`` (:func:`_serve_in_process`). With
    ``lifecycle`` the replica lifecycle runs too (:func:`_lifecycle`), with
    ``fields`` the request fields (:func:`_http_fields`) and the streaming
    API (:func:`_http_stream`)."""
    base, stop_server = _serve_in_process(engine)
    shards = engine.cache if isinstance(engine.cache, list) \
        else [engine.cache]
    quant = "ks" in shards[0]
    layout = "" if engine.paged else "dense " if len(shards) == 1 \
        else f"sp {len(shards)} "
    tag = f"[server {layout}{'int8' if quant else 'bf16'}]"

    def complete(body):
        req = urllib.request.Request(
            base + "/v1/completions", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            out = json.loads(r.read())
            status = r.status
        choice = out["choices"][0]
        if status != 200 or not isinstance(choice["text"], str) \
                or out["usage"]["completion_tokens"] < 1:
            raise AssertionError(f"/v1/completions: {status} {out}")
        return out

    try:
        with urllib.request.urlopen(base + "/v1/models", timeout=60) as r:
            models = json.loads(r.read())
            if r.status != 200 or models["data"][0]["id"] != engine.cfg.name:
                raise AssertionError(f"/v1/models: {r.status} {models}")
        out = complete({"prompt": "Hello from the smoke test",
                        "max_tokens": 16})
        choice = out["choices"][0]
        log(f"{tag} /v1/models 200 ({models['data'][0]['id']}); "
            f"/v1/completions 200: {out['usage']['completion_tokens']} "
            f"tokens, finish {choice['finish_reason']}, token ids "
            f"{choice['text']!r}")
        if quant:
            body = {"prompt": "Seeded", "max_tokens": 24, "seed": 7,
                    "temperature": 0.8, "top_p": 0.9, "top_k": 20,
                    "ignore_eos": True}
            texts = [complete(body)["choices"][0]["text"] for _ in range(2)]
            if texts[0] != texts[1] or len(texts[0].split()) != 24:
                raise AssertionError(f"seeded completions differ: {texts}")
            log(f"{tag} seeded sampled /v1/completions (seed 7) twice: the "
                f"same token ids {texts[0]!r}")
        if lifecycle:
            _lifecycle(engine, base, tag)
        if fields:
            _http_fields(engine, base, tag)
            _http_stream(engine, base, tag)
    finally:
        stop_server()


COMPLETION_KEYS = {"id", "object", "created", "model", "choices", "usage"}
CHOICE_KEYS = {"index", "text", "logprobs", "finish_reason"}


def _completion(base, body, n=1):
    """A 200 completions answer in the JAX server's shape (its keys, ``n``
    choices indexed in order, usage counted), else AssertionError."""
    status, out, _ = _http(base + "/v1/completions", body)
    choices = out.get("choices", [])
    if status != 200 or not COMPLETION_KEYS <= set(out) or \
            out["object"] != "text_completion" or len(choices) != n or \
            any(not CHOICE_KEYS <= set(c) or c["index"] != i
                for i, c in enumerate(choices)) or \
            out["usage"]["total_tokens"] != out["usage"]["prompt_tokens"] \
            + out["usage"]["completion_tokens"]:
        raise AssertionError(f"/v1/completions {body}: {status} {out}")
    return out


def _http_fields(engine, base, tag):
    """The request fields over HTTP: ``n`` 3 with a seed (choice 0 is the
    n=1 answer), ``best_of`` 4 with ``n`` 2 (ranked; no logprobs in the
    answer, none asked), ``echo`` with ``logprobs`` 2 (the payload covers
    the prompt, position 0 null, the generated tokens' offsets after the
    echoed text), and a ``stop`` string that cuts the text with finish
    ``stop``. For the n check the engine is idle before each request and
    prefills one prompt a dispatch, so that choice 0 prefills as the n=1
    request did: a batch of three rounds apart from a batch of one (cuBLAS
    picks the MLP's down projection by the row count, ROADMAP C22), enough
    to flip a near-tie of a later draw (as the seeded checks of the engine
    phases admit their prompts alike)."""
    import dataclasses

    body = {"prompt": "Fields over HTTP", "max_tokens": 24, "seed": 17,
            "temperature": 0.8, "top_p": 0.9, "ignore_eos": True}
    serving = engine.serving
    engine.serving = dataclasses.replace(serving, max_prefill_batch=1)
    # both admitted into an idle engine (no dispatch in flight): each
    # takes a batch prefill of one
    _settled(engine)
    one = _completion(base, body)["choices"][0]
    _settled(engine)
    three = _completion(base, {**body, "n": 3}, n=3)["choices"]
    engine.serving = serving
    if three[0]["text"] != one["text"] or \
            len({c["text"] for c in three}) < 2:
        raise AssertionError(f"{tag} n=3 choice 0 {three[0]['text']!r} "
                             f"vs n=1 {one['text']!r}")
    best = _completion(base, {**body, "n": 2, "best_of": 4}, n=2)["choices"]
    if any(c["logprobs"] is not None for c in best):
        raise AssertionError(f"{tag} best_of answered logprobs: {best}")
    prompt = "Echo me"
    echo = _completion(base, {"prompt": prompt, "max_tokens": 6,
                              "echo": True, "logprobs": 2,
                              "ignore_eos": True})["choices"][0]
    lp = echo["logprobs"]
    if not echo["text"].startswith(prompt) or \
            len(lp["tokens"]) != len(prompt) + 6 or \
            lp["token_logprobs"][0] is not None or \
            any(v is None or v > 0 for v in lp["token_logprobs"][1:]) or \
            lp["text_offset"][0] != 0 or \
            lp["text_offset"][len(prompt)] != len(prompt):
        raise AssertionError(f"{tag} echo with logprobs: {echo}")
    plain = _completion(base, {"prompt": "Cut me", "max_tokens": 12,
                               "ignore_eos": True})["choices"][0]["text"]
    stop = " " + plain.split()[4] + " "
    cut = _completion(base, {"prompt": "Cut me", "max_tokens": 12,
                             "ignore_eos": True, "stop": [stop]})
    c = cut["choices"][0]
    if c["finish_reason"] != "stop" or c["text"] != plain[:plain.find(stop)]:
        raise AssertionError(f"{tag} stop {stop!r}: {c} (plain {plain!r})")
    log(f"{tag} request fields over HTTP, each 200 in the JAX server's "
        f"shape: n=3 (seed 17) choice 0 = the n=1 answer, "
        f"{len({c['text'] for c in three})} distinct choices; best_of 4 n 2 "
        f"ranked, no logprobs; echo + logprobs 2 over {len(lp['tokens'])} "
        f"tokens (prompt {len(prompt)}); stop {stop!r} cut "
        f"{len(plain)} -> {len(c['text'])} characters, finish stop")


def _sse(base, path, body, timeout=300, close_after=None):
    """POST a streamed ``body``; the parsed ``data:`` events (``"[DONE]"``
    kept as the string) and each one's arrival on the host's monotonic
    clock, the send time first. With ``close_after`` the connection is
    closed once that many events with ``token_ids`` have come (a client, or
    a replica's relay, that goes away)."""
    host, port = base.split("//")[1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
    t0 = time.monotonic()
    conn.request("POST", path, body=json.dumps(body),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    if resp.status != 200 or not resp.headers["Content-Type"].startswith(
            "text/event-stream"):
        raise AssertionError(f"{path} {body}: {resp.status} "
                             f"{resp.read()[:500]!r}")
    events, times, tagged = [], [t0], 0
    try:
        while True:
            line = resp.fp.readline()
            if not line:
                break
            if not line.startswith(b"data: "):
                continue
            payload = line[len(b"data: "):].strip()
            ev = "[DONE]" if payload == b"[DONE]" else json.loads(payload)
            events.append(ev)
            times.append(time.monotonic())
            if ev == "[DONE]":
                # read the terminating chunk too: a close with unread bytes
                # resets the connection
                while line and line != b"0\r\n":
                    line = resp.fp.readline()
                resp.fp.readline()
                break
            tagged += any(c.get("token_ids") for c in ev["choices"])
            if close_after is not None and tagged >= close_after:
                break
    finally:
        conn.close()
    return events, times


def _stream_parts(events, index=0):
    """(text, token ids, finish reason) of one choice of a stream."""
    text, ids, finish = "", [], None
    for ev in events:
        if ev == "[DONE]":
            continue
        for c in ev["choices"]:
            if c["index"] == index:
                text += c.get("text") or (c.get("delta") or {}).get(
                    "content") or ""
                ids += c.get("token_ids") or []
                finish = c["finish_reason"] or finish
    return text, ids, finish


def _whole_stream(events, what):
    """Fail unless ``events`` end with ``[DONE]`` and every choice with a
    finish chunk."""
    if not events or events[-1] != "[DONE]" or events.count("[DONE]") != 1:
        raise AssertionError(f"{what}: the stream did not end with one "
                             f"[DONE]: {events[-3:]}")


def _http_stream(engine, base, tag):
    """The streaming API over HTTP (the paged bf16 engine, each request
    admitted into an idle engine): a greedy streamed completion and a
    streamed chat, each equal to its non-streamed answer (text, the
    ``token_ids`` of its chunks, finish reason, usage); a seeded sampled
    stream with ``n`` 2 and ``include_usage`` (``usage: null`` on every
    chunk, then the usage chunk; choice 0 the n=1 answer, each prompt
    prefilled alone as in :func:`_http_fields`); a stream cut by a stop
    string (its slot freed); and a stream with ``logprobs`` 2 whose
    records equal the non-streamed ones (tokens, logprobs, top entries; the
    ids tokenizer's pieces are not concatenative, so text offsets are not
    compared)."""
    import dataclasses

    url = "/v1/completions"
    body = {"prompt": "Stream me", "max_tokens": 32, "ignore_eos": True}
    _settled(engine)
    whole = _completion(base, body)
    _settled(engine)
    events, _ = _sse(base, url, {**body, "stream": True, "stream_options":
                                 {"include_usage": True}})
    _whole_stream(events, "greedy stream")
    text, ids, finish = _stream_parts(events)
    w = whole["choices"][0]
    usage = events[-2]
    if (text, finish) != (w["text"], w["finish_reason"]) or \
            ids != [int(t) for t in w["text"].split()] or \
            usage.get("choices") != [] or usage["usage"] != whole["usage"] \
            or any(ev.get("usage", 0) is not None for ev in events[:-2]):
        raise AssertionError(f"{tag} greedy stream {text!r} {ids} {finish} "
                             f"{usage} vs {w} {whole['usage']}")
    log(f"{tag} greedy /v1/completions stream: {len(events) - 2} chunks + "
        f"usage + [DONE], text, token_ids ({len(ids)}), finish and usage "
        f"equal to the non-streamed answer")

    chat = {"messages": [{"role": "system", "content": "Be brief."},
                         {"role": "user", "content": "Stream a chat"}],
            "max_tokens": 24, "temperature": 0.0, "ignore_eos": True}
    _settled(engine)
    status, cw, _ = _http(base + "/v1/chat/completions", chat)
    _settled(engine)
    events, _ = _sse(base, "/v1/chat/completions", {**chat, "stream": True})
    _whole_stream(events, "chat stream")
    text, ids, finish = _stream_parts(events)
    m = cw["choices"][0]
    if status != 200 or cw["object"] != "chat.completion" or \
            events[0]["choices"][0]["delta"] != {"role": "assistant"} or \
            (text, finish) != (m["message"]["content"], m["finish_reason"]) \
            or ids != [int(t) for t in text.split()]:
        raise AssertionError(f"{tag} chat stream {text!r} {finish} vs "
                             f"{status} {cw}")
    log(f"{tag} chat (opt style) streamed: role chunk, {len(ids)} tokens, "
        f"equal to the chat.completion answer")

    seeded = {"prompt": "Seeded stream", "max_tokens": 24, "seed": 29,
              "temperature": 0.8, "top_p": 0.9, "ignore_eos": True}
    serving = engine.serving
    engine.serving = dataclasses.replace(serving, max_prefill_batch=1)
    try:
        _settled(engine)
        one = _completion(base, seeded)["choices"][0]
        _settled(engine)
        events, _ = _sse(base, url, {**seeded, "n": 2, "stream": True,
                                     "stream_options":
                                     {"include_usage": True}})
    finally:
        engine.serving = serving
    _whole_stream(events, "n=2 stream")
    c0, c1 = _stream_parts(events, 0), _stream_parts(events, 1)
    if c0[0] != one["text"] or c0[0] == c1[0] or \
            [len(c0[1]), len(c1[1])] != [24, 24] or \
            events[-2]["usage"]["completion_tokens"] != 48:
        raise AssertionError(f"{tag} n=2 seeded stream {c0} {c1} "
                             f"{events[-2]} vs n=1 {one}")
    log(f"{tag} seeded (seed 29) n=2 stream with include_usage: 2 x 24 "
        f"tokens, usage 48, choice 0 = the n=1 answer, the choices differ")

    cut_body = {"prompt": "Cut the stream", "max_tokens": 16,
                "ignore_eos": True}
    _settled(engine)
    plain = _completion(base, cut_body)["choices"][0]["text"]
    stop = " " + plain.split()[5] + " "
    _settled(engine)
    events, _ = _sse(base, url, {**cut_body, "stream": True,
                                 "stop": [stop]})
    _whole_stream(events, "stop stream")
    text, ids, finish = _stream_parts(events)
    _settled(engine)
    if finish != "stop" or text != plain[:plain.find(stop)]:
        raise AssertionError(f"{tag} stop {stop!r}: {text!r} {finish} "
                             f"(plain {plain!r})")
    log(f"{tag} stream cut by stop {stop!r}: {len(plain)} -> {len(text)} "
        f"characters, finish stop, slot and pages released")

    lp_body = {"prompt": "Logprobs", "max_tokens": 8, "logprobs": 2,
               "ignore_eos": True}
    _settled(engine)
    lw = _completion(base, lp_body)["choices"][0]["logprobs"]
    _settled(engine)
    events, _ = _sse(base, url, {**lp_body, "stream": True})
    _whole_stream(events, "logprobs stream")
    recs = [c["logprobs"] for ev in events[:-1] for c in ev["choices"]
            if c.get("logprobs")]
    got = {k: [r[k][0] for r in recs] for k in ("tokens", "token_logprobs",
                                                 "top_logprobs")}
    if len(recs) != 8 or any(got[k] != lw[k] for k in got):
        raise AssertionError(f"{tag} logprobs stream {got} vs {lw}")
    log(f"{tag} logprobs 2 stream: 8 per-token chunks, records equal to the "
        f"non-streamed ones (tokens, logprobs, top 2)")


FAILOVER_TOKENS = 48
FAILOVER_CUT = 5


def phase_failover(torch, np, engine):
    """The failover continuation on the card: a second engine with the same
    seeded weights and ``derived_seed`` as ``engine`` (the paged bf16 one),
    both behind in-process servers (prefix caches off, so that a repeated
    prompt prefills alike). For a greedy and a seeded sampled request:
    the undisturbed stream on server A; the same stream read for
    ``FAILOVER_CUT`` chunks and closed (A's slot and pages must come back);
    the rest from server B as the JAX router asks for it (``resume_token_ids``
    = the ids received, ``resume_text_chars`` = the characters received,
    ``max_tokens`` decremented). The spliced stream must equal the
    undisturbed one, text and ids. Where it does not, the first differing
    token is allowed only where the undisturbed stream's top-2 logit margin
    is below ``LOGIT_TOL`` (B rebuilt prompt + relayed tokens through the
    chunk program, where A wrote the relayed tokens' rows one decode row at
    a time): the position and margin are printed, every token before it
    must be equal, and the phase fails otherwise."""
    import dataclasses

    from aws_k8s_ansible_provisioner_tpu_torch.config import QWEN3_0_6B
    from aws_k8s_ansible_provisioner_tpu_torch.models.layers import init_params
    from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import Engine

    serving = engine.serving
    engine.serving = dataclasses.replace(serving, prefix_cache=False)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = init_params(QWEN3_0_6B, gen, torch.bfloat16)
    engine_b = Engine(QWEN3_0_6B, params, engine.serving, device="cuda")
    del params
    servers = [_serve_in_process(e) for e in (engine, engine_b)]
    (a, _), (b, _) = servers
    url = "/v1/completions"
    results = []
    try:
        for label, extra in (("greedy", {}),
                             ("seeded", {"seed": 1000, "temperature": 0.7,
                                         "top_p": 0.95})):
            body = {"prompt": f"Failover {label}", "stream": True,
                    "max_tokens": FAILOVER_TOKENS, "ignore_eos": True,
                    **extra}
            _settled(engine)
            whole, _ = _sse(a, url, body)
            _whole_stream(whole, f"undisturbed {label} stream")
            _settled(engine)
            head, _ = _sse(a, url, body, close_after=FAILOVER_CUT)
            # A notices the closed connection at its next write
            _settled(engine)
            h_text, h_ids, _ = _stream_parts(head)
            cont = {**body, "resume_token_ids": h_ids,
                    "resume_text_chars": len(h_text),
                    "max_tokens": FAILOVER_TOKENS - len(h_ids)}
            _settled(engine_b)
            tail, _ = _sse(b, url, cont)
            _whole_stream(tail, f"continuation {label} stream")
            _settled(engine_b)
            if any("role" in (c.get("delta") or {}) for ev in tail[:-1]
                   for c in ev["choices"]):
                raise AssertionError("a continuation sent a role chunk")
            w_text, w_ids, w_fin = _stream_parts(whole)
            s_text, s_ids, s_fin = _stream_parts(head + tail)
            if (s_text, s_ids, s_fin) == (w_text, w_ids, w_fin):
                results.append(f"{label}: spliced = undisturbed "
                               f"({len(w_ids)} tokens, cut after "
                               f"{len(h_ids)})")
                continue
            p = next((i for i, (x, y) in enumerate(zip(s_ids, w_ids))
                      if x != y), min(len(s_ids), len(w_ids)))
            _settled(engine)
            rec = _completion(a, {**{k: v for k, v in body.items()
                                     if k != "stream"},
                                  "max_tokens": p + 1, "logprobs": 2})
            r_ids = [int(t) for t in rec["choices"][0]["text"].split()]
            if r_ids != w_ids[:p + 1]:
                raise AssertionError(f"{label}: the logprobs run {r_ids} is "
                                     f"not the undisturbed stream "
                                     f"{w_ids[:p + 1]}")
            top = sorted(rec["choices"][0]["logprobs"]["top_logprobs"][p]
                         .values(), reverse=True)
            margin = top[0] - top[1]
            msg = (f"{label}: the spliced stream parts from the undisturbed "
                   f"one at token {p} of {len(w_ids)} (cut after "
                   f"{len(h_ids)}), where the undisturbed top-2 logit margin "
                   f"is {margin:.4f}")
            if p < len(h_ids) or margin >= LOGIT_TOL or \
                    s_ids[:p] != w_ids[:p]:
                raise AssertionError(msg + f" (tolerance {LOGIT_TOL})")
            results.append(msg)
    finally:
        for _, stop in servers:
            stop()
        engine.serving = serving
    del engine_b
    log("[failover] two servers on one card, the same weights and "
        "derived_seed; a stream cut on A and continued on B: "
        + "; ".join(results))


def _serve_in_process(engine):
    """The port's HTTP server over ``engine`` on a free port, the engine
    stepping on its own thread; (base URL, stop function). Its tokenizer
    encodes bytes and decodes token ids as their decimal numbers, so that
    the random-weight model's streams (ids far past the byte range) show
    in the text."""
    from aws_k8s_ansible_provisioner_tpu_torch.serving.server import (
        ServerState, make_server)
    from aws_k8s_ansible_provisioner_tpu_torch.utils.tokenizer import \
        ByteTokenizer

    class IdTokenizer(ByteTokenizer):
        def decode(self, ids, *args, **kwargs):
            return " ".join(str(int(t)) for t in ids)

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    state = ServerState(engine, IdTokenizer(), engine.cfg.name)
    server = make_server(state, "127.0.0.1", port)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    state.start_engine()

    def stop():
        server.shutdown()
        server.server_close()
        state.stop_engine()
        th.join(10)

    return f"http://127.0.0.1:{port}", stop


def phase_prefill_batch(torch, np):
    """C22: one prompt prefilled in a batch of one and in a batch of three
    (three copies of it, as an ``n`` 3 request admits them, and it beside
    two other prompts), Qwen3-0.6B at full width with the engine's int8
    weights over a bf16 paged pool; the prompt has the same bucket (32) and
    the same page in every run. Prints, layer by layer, the largest
    difference of the prompt's rows in q, k, v (projections and q/k
    prologue), the attention output and the K/V rows written, the first
    layer and stage where one appears, and the last position's logits
    (largest difference, greedy tokens, top-2 margin); then the suspects
    alone on identical inputs: each projection's GEMM and the logits head
    over 32 rows and over 96 (each against a float64 product), and the
    attention of the prompt alone and in the batch. Returns the logits'
    largest difference."""
    from aws_k8s_ansible_provisioner_tpu_torch.config import QWEN3_0_6B
    from aws_k8s_ansible_provisioner_tpu_torch.models.layers import (
        DecoderLM, _linear, causal_attend, init_params, rms_norm)
    from aws_k8s_ansible_provisioner_tpu_torch.models.quant import \
        quantize_params
    from aws_k8s_ansible_provisioner_tpu_torch.ops.attention import \
        make_prefill_attend_batch_paged_carry
    from aws_k8s_ansible_provisioner_tpu_torch.serving import paged_kv as pkv

    cfg = QWEN3_0_6B
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    model = DecoderLM(cfg, quantize_params(init_params(cfg, gen,
                                                       torch.bfloat16), cfg))
    rng = np.random.default_rng(22)
    T, ps, n = 32, 64, 16
    prompt = rng.integers(0, cfg.vocab_size, n).tolist()
    others = [rng.integers(0, cfg.vocab_size, m).tolist() for m in (29, 23)]

    def run(prompts):
        N = len(prompts)
        tokens = torch.zeros((N, T), dtype=torch.int32, device="cuda")
        for i, p in enumerate(prompts):
            tokens[i, :len(p)] = torch.tensor(p, dtype=torch.int32)
        lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                            device="cuda")
        tables = torch.arange(1, N + 1, dtype=torch.int32,
                              device="cuda")[:, None]
        pool = pkv.init_pool(cfg, N + 1, ps, torch.bfloat16, "cuda")
        attend = make_prefill_attend_batch_paged_carry(tables, lens)
        rec = []

        def recording(q, k, v, cache_l):
            ctx, out = attend(q, k, v, cache_l)
            rec.append({"q": q[0, :n].clone(), "k": k[0, :n].clone(),
                        "v": v[0, :n].clone(), "ctx": ctx[0, :n].clone()})
            return ctx, out

        positions = torch.arange(T, dtype=torch.int32,
                                 device="cuda")[None].expand(N, T)
        logits, pool = model.forward_carry(tokens, positions, pool,
                                           recording)
        torch.cuda.synchronize()
        last = logits[torch.arange(N, device="cuda"), lens.long() - 1]
        return rec, pool, last.float()

    base, pool1, last1 = run([prompt])
    logits1 = last1[0]
    worst = 0.0
    for label, batch in (("3 copies", [prompt] * 3),
                         ("beside 2 others", [prompt] + others)):
        rec, pool3, last3 = run(batch)
        logits3 = last3[0]
        first = None
        rows = []
        for layer, (a, b) in enumerate(zip(base, rec)):
            d = {s: (a[s].float() - b[s].float()).abs().max().item()
                 for s in ("q", "k", "v", "ctx")}
            for s in ("k", "v"):
                d[s + " rows"] = (pool1[s][layer, 1, :, :n].float()
                                  - pool3[s][layer, 1, :, :n].float()
                                  ).abs().max().item()
            if first is None and any(d.values()):
                first = (layer, [s for s in ("q", "k", "v", "k rows",
                                             "v rows", "ctx") if d[s]][0])
            rows.append(d)
        diff = (logits1 - logits3).abs().max().item()
        worst = max(worst, diff)
        top = torch.topk(logits1, 2).values
        log(f"[C22] {label}: first difference at "
            + (f"layer {first[0]}, {first[1]}" if first else "none")
            + f"; per layer max |diff| of q k v ctx (layers 0, 1, "
            f"{cfg.num_layers - 1}): "
            + "; ".join(f"{i}: " + " ".join(f"{rows[i][s]:.3g}"
                                            for s in ("q", "k", "v", "ctx"))
                        for i in (0, 1, cfg.num_layers - 1))
            + f"; K/V rows written, layer 0 {rows[0]['k rows']:.3g} / "
            f"{rows[0]['v rows']:.3g}, largest over layers "
            f"{max(r['k rows'] for r in rows):.3g} / "
            f"{max(r['v rows'] for r in rows):.3g}; last position's logits "
            f"max |diff| {diff:.4f} (tolerance {LOGIT_TOL}), greedy "
            f"{int(logits1.argmax())} / {int(logits3.argmax())}, top-2 "
            f"margin {float(top[0] - top[1]):.4f}"
            + ("; the 3 copies' logits among themselves "
               + ("identical" if all(torch.equal(last3[0], last3[i])
                                     for i in (1, 2)) else "DIFFERENT")
               if label == "3 copies" else ""))
    # the suspects alone on identical inputs: every projection of layer 1
    # (the int8 weights' bf16 copy, the GEMM, the scale) and the tied
    # logits head, over 32 rows and over 96 whose first 32 are the same,
    # each against a float64 product; then layer 0's attention of the same
    # q, k, v alone and in a batch of 3
    from aws_k8s_ansible_provisioner_tpu_torch.models.layers import \
        _final_logits

    params, layers = model._cached()
    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    parts = []
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                 "head"):
        if name == "head":
            K = cfg.hidden_size
            x = torch.randn((3, T, K), generator=g, device="cuda")
            x = x.to(torch.bfloat16)
            y1 = _final_logits(params, cfg, x[:1])[0].float()
            y3 = _final_logits(params, cfg, x)[0].float()
            emb = params["embed"]
            w = emb["weight"].double().T * emb["scale"].double()
            h = rms_norm(x[0], params["final_norm"]["weight"], cfg.norm_eps)
        else:
            p = layers[1][name]
            K = p["kernel"].shape[0]
            x = torch.randn((3, T, K), generator=g, device="cuda")
            x = x.to(torch.bfloat16)
            y1 = _linear(x[:1], p)[0].float()
            y3 = _linear(x, p)[0].float()
            w = p["kernel"].double() * p["scale"].double()
            h = x[0]
        ref = (h.double() @ w).float()
        # one bf16 ulp of each output row's largest value: a near-zero
        # output's own ulp is far below the float32 sum's rounding
        ulp = _bf16_ulp(torch, ref.abs().amax(-1, keepdim=True))
        parts.append(
            f"{name} [{T}|{3 * T} x {K} x {y1.shape[-1]}] "
            f"{int((y1 != y3).sum())}/{y1.numel()} differ (max "
            f"{(y1 - y3).abs().max().item():.3g}), err/ulp "
            f"{((y1 - ref).abs() / ulp).max().item():.2f} | "
            f"{((y3 - ref).abs() / ulp).max().item():.2f}")
    q = base[0]["q"][None]
    k, v = base[0]["k"][None], base[0]["v"][None]
    pad = [torch.randn_like(q) for _ in range(2)]
    lens1 = torch.tensor([n], dtype=torch.int32, device="cuda")
    lens3 = torch.tensor([n, n, n], dtype=torch.int32, device="cuda")
    a1 = causal_attend(q, k, v, seq_lens=lens1)[0].float()
    a3 = causal_attend(torch.cat([q] + pad), torch.cat([k] * 3),
                       torch.cat([v] * 3), seq_lens=lens3)[0].float()
    log("[C22] alone, the projections over 32 rows vs 96 (outputs that "
        "differ; each against float64, in bf16 ulps of the row's largest "
        "value, 32 | 96 rows): "
        + "; ".join(parts) + f"; layer 0 attention of the same q, k, v "
        f"alone and in a batch of 3: max |diff| "
        f"{(a1 - a3).abs().max().item():.4g}")
    return worst


def _http(url, body=None, headers=None, timeout=300):
    """(status, JSON body, headers) of a GET (``body`` None) or a POST;
    an HTTP error's status is returned, not raised."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        url, data=data,
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _expect(what, out, code, **fields):
    """Fail unless ``out`` (:func:`_http`) has the HTTP status ``code`` and,
    in its JSON body, the ``fields`` given."""
    if out[0] != code or any(out[1].get(k) != v for k, v in fields.items()):
        raise AssertionError(f"{what}: expected {code} {fields}, got "
                             f"{out[0]} {out[1]}")
    return out


def _settled(engine, timeout=60.0):
    """Wait until the engine thread has nothing active, queued, chunking
    or in flight; fail unless every slot is free and no page is live."""
    t0 = time.monotonic()
    while engine._active_slots() or engine.pending or \
            engine._chunk is not None or engine._inflight is not None:
        if time.monotonic() - t0 > timeout:
            raise AssertionError("the engine did not settle")
        time.sleep(0.01)
    live = engine.allocator.stats()["pages_live"] if engine.paged else 0
    if sorted(engine._free) != list(range(engine.num_slots)) or live:
        raise AssertionError(f"slots or pages not released: free "
                             f"{sorted(engine._free)}, live pages {live}")


def _running(engine, timeout=60.0):
    t0 = time.monotonic()
    while not engine._active_slots():
        if time.monotonic() - t0 > timeout:
            raise AssertionError("the completion never reached a slot")
        time.sleep(0.002)


def _metric(base, name):
    """One unlabelled sample of ``/metrics`` (Prometheus text)."""
    with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
        text = r.read().decode()
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[1])
    raise AssertionError(f"/metrics has no {name}")


def _lifecycle(engine, base, tag):
    """The replica lifecycle over the in-process server of ``engine``
    (the paged int8 engine): probes, the deadline's 408, a drain during a
    running completion and its undrain, a drain's straggler reaped; launch
    counts zeroed just before and read just after."""
    counts0 = dict(engine.counts)
    gen0 = _metric(base, "tpu_serve_generated_tokens_total")
    expired0 = engine.metrics.deadline_expired.total()
    _reset_launches()
    t0 = time.monotonic()
    _expect("/readyz", _http(base + "/readyz"), 200, status="ready")
    health = _expect("/healthz", _http(base + "/healthz"), 200, status="ok",
                     paged=True)[1]
    if health["kv_pages_total"] <= 0:
        raise AssertionError(f"/healthz counts no pages: {health}")
    load = _expect("/load", _http(base + "/load"), 200, slots=32,
                   draining=False)[1]
    log(f"{tag} /readyz 200; /healthz 200 (paged, {health['kv_pages_total']} "
        f"pages, kv {health['kv_dtype']}); /load {load}")

    # the deadline: 1500 tokens cannot finish in 300 ms
    t_send = time.monotonic()
    out = _http(base + "/v1/completions",
                {"prompt": "Deadline", "max_tokens": 1500,
                 "ignore_eos": True},
                headers={"X-Request-Deadline-Ms": "300"})
    waited = time.monotonic() - t_send
    if out[0] != 408 or out[1]["error"]["code"] != "deadline_exceeded":
        raise AssertionError(f"deadline: expected 408, got {out[0]} {out[1]}")
    _settled(engine)
    log(f"{tag} X-Request-Deadline-Ms 300, 1500 tokens: 408 "
        f"deadline_exceeded after {waited * 1e3:.1f} ms (overshoot "
        f"{(waited - 0.3) * 1e3:.1f} ms past the deadline, client clock); "
        f"slot and pages released")

    # a drain out of rotation (exit false) while a 512-token request runs
    done = {}
    th = threading.Thread(target=lambda: done.setdefault("out", _http(
        base + "/v1/completions", {"prompt": "Drain", "max_tokens": 512,
                                   "ignore_eos": True})))
    th.start()
    _running(engine)
    drain = _expect("/admin/drain", _http(base + "/admin/drain",
                                          {"exit": False}),
                    200, status="draining")[1]
    ready = _http(base + "/readyz")
    shed = _http(base + "/v1/completions", {"prompt": "Late",
                                            "max_tokens": 4})
    th.join(300)
    if ready[0] != 503 or ready[2].get("X-TPU-Draining") != "1":
        raise AssertionError(f"/readyz while draining: {ready}")
    if shed[0] != 503 or shed[1]["error"]["code"] != "draining" or \
            "Retry-After" not in shed[2]:
        raise AssertionError(f"a completion while draining: {shed}")
    out = done.get("out")
    if out is None or out[0] != 200 or \
            out[1]["usage"]["completion_tokens"] != 512:
        raise AssertionError(f"the request running through the drain: "
                             f"{out}")
    if drain["active_requests"] < 1:
        raise AssertionError(f"the 512-token request was not running when "
                             f"the drain began: {drain}")
    _expect("/admin/undrain", _http(base + "/admin/undrain", {}), 200,
            draining=False)
    _expect("/readyz after the undrain", _http(base + "/readyz"), 200,
            status="ready")
    _settled(engine)
    log(f"{tag} drain (exit false) during a 512-token completion: /readyz "
        f"503 X-TPU-Draining 1, a new completion 503 draining (Retry-After "
        f"{shed[2]['Retry-After']}), the running one 200 with 512 tokens; "
        f"undrain: /readyz 200")

    # a drain of 0.5 s: its straggler is reaped with a 408
    th = threading.Thread(target=lambda: done.__setitem__("out", _http(
        base + "/v1/completions", {"prompt": "Straggler", "max_tokens": 1500,
                                   "ignore_eos": True})))
    th.start()
    _running(engine)
    t_drain = time.monotonic()
    _expect("/admin/drain 0.5 s", _http(base + "/admin/drain",
                                        {"timeout_s": 0.5, "exit": False}),
            200, status="draining")
    th.join(300)
    waited = time.monotonic() - t_drain
    out = done["out"]
    if out[0] != 408:
        raise AssertionError(f"the drain's straggler: expected 408, got "
                             f"{out[0]} {out[1]}")
    _settled(engine)
    _expect("/admin/undrain", _http(base + "/admin/undrain", {}), 200)
    _expect("/readyz after the undrain", _http(base + "/readyz"), 200)
    log(f"{tag} drain timeout_s 0.5 during a 1500-token completion: the "
        f"straggler 408 after {waited * 1e3:.1f} ms (overshoot "
        f"{(waited - 0.5) * 1e3:.1f} ms), its slot and pages released")

    expired = engine.metrics.deadline_expired.total() - expired0
    gen = _metric(base, "tpu_serve_generated_tokens_total") - gen0
    counted = engine.counts["generated_tokens"] - counts0.get(
        "generated_tokens", 0)
    if expired != 2 or gen != counted or counted < 512:
        raise AssertionError(f"deadline_expired +{expired} (expected 2); "
                             f"/metrics generated tokens +{gen}, engine "
                             f"count +{counted}")
    launches = _launches()
    attn, write = _kernel_names(True)
    if launches[attn] <= 0 or launches[write] <= 0:
        raise AssertionError(f"the server's lifecycle runs launched no "
                             f"K1-int8 or fused K3 write: {launches}")
    log(f"{tag} lifecycle: deadline_expired +{expired:.0f}, /metrics "
        f"tpu_serve_generated_tokens_total +{gen:.0f} = engine count "
        f"+{counted}; launches {attn} {launches[attn]}, {write} "
        f"{launches[write]}; {time.monotonic() - t0:.1f}s")


SERVER_PROCESS_TOKENS = 1024
# the streams timed on the server process: how many, and their tokens
TTFT_STREAMS = 5
TTFT_TOKENS = 64
# a bias that makes every token a byte, so that the byte tokenizer of the
# server process gives each token its own text and chunk
BYTE_BIAS = {"65": 100}


def _stream_timing(base):
    """``TTFT_STREAMS`` greedy streams of ``TTFT_TOKENS`` tokens, one at a
    time, on the host's clock: the time from the request's send to its
    first content chunk, and the gaps between its content chunks."""
    ttft, gaps = [], []
    for i in range(TTFT_STREAMS):
        events, times = _sse(base, "/v1/completions", {
            "prompt": f"Time to first token {i}", "stream": True,
            "max_tokens": TTFT_TOKENS, "ignore_eos": True,
            "logit_bias": BYTE_BIAS})
        _whole_stream(events, "a timed stream")
        t = [times[j + 1] for j, ev in enumerate(events) if ev != "[DONE]"
             and any(c.get("token_ids") for c in ev["choices"])]
        if len(_stream_parts(events)[1]) != TTFT_TOKENS:
            raise AssertionError(f"a timed stream: {events[-3:]}")
        ttft.append((t[0] - times[0]) * 1e3)
        gaps += [(y - x) * 1e3 for x, y in zip(t, t[1:])]
    return ttft, gaps


def phase_server_process():
    """The server as a process, as a pod runs it
    (``python -m aws_k8s_ansible_provisioner_tpu_torch.serving.server
    --device cuda``: Qwen3-0.6B, random int8 weights, 32 slots): the
    seconds until ``/readyz`` answers 200; the client's time to the first
    content chunk of a stream and the gaps between its chunks
    (:func:`_stream_timing`); SIGTERM while a completion and a stream of
    ``SERVER_PROCESS_TOKENS`` tokens run: the completion must answer 200
    with every token, the stream end with its finish chunk and ``[DONE]``
    after every token, and the process exit 0 within
    ``--drain-timeout``."""
    import signal

    drain_timeout = 30
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    base = f"http://127.0.0.1:{port}"
    t_start = time.monotonic()
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "aws_k8s_ansible_provisioner_tpu_torch.serving.server",
         "--device", "cuda", "--host", "127.0.0.1", "--port", str(port),
         "--drain-timeout", str(drain_timeout)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines = []
    threading.Thread(target=lambda: lines.extend(proc.stdout),
                     daemon=True).start()
    try:
        while True:
            if proc.poll() is not None:
                raise AssertionError(f"the server exited {proc.returncode} "
                                     f"before it was ready: "
                                     f"{''.join(lines[-20:])}")
            if time.monotonic() - t_start > 300:
                raise AssertionError("the server was not ready in 300 s")
            try:
                if _http(base + "/readyz", timeout=5)[0] == 200:
                    break
            except OSError:
                pass
            time.sleep(0.1)
        t_ready = time.monotonic() - t_start
        log(f"[server process] /readyz 200 {t_ready:.1f}s after the start "
            f"(interpreter, torch, random weights, engine, graph capture, "
            f"warmup)")
        ttft, gaps = _stream_timing(base)
        qs = statistics.quantiles(gaps, n=100)
        log(f"[server process] streamed, client side ({TTFT_STREAMS} greedy "
            f"streams of {TTFT_TOKENS} tokens, one at a time, the host's "
            f"clock): time to the first content chunk "
            + ", ".join(f"{x:.2f}" for x in ttft)
            + f" ms (p50 {statistics.median(ttft):.2f}); gaps between "
            f"chunks p50 {statistics.median(gaps):.3f} ms, p90 "
            f"{qs[89]:.3f}, max {max(gaps):.3f} ({len(gaps)} gaps, "
            f"{sum(g > 5.0 for g in gaps)} above 5 ms)")
        done = {}
        th = threading.Thread(target=lambda: done.setdefault("out", _http(
            base + "/v1/completions",
            {"prompt": "SIGTERM", "max_tokens": SERVER_PROCESS_TOKENS,
             "ignore_eos": True})))
        ths = threading.Thread(target=lambda: done.setdefault(
            "stream", _sse(base, "/v1/completions", {
                "prompt": "SIGTERM stream", "stream": True,
                "max_tokens": SERVER_PROCESS_TOKENS, "ignore_eos": True,
                "logit_bias": BYTE_BIAS})))
        th.start()
        ths.start()
        while _http(base + "/load")[1]["active"] < 2:
            if not th.is_alive() or not ths.is_alive():
                raise AssertionError(f"a request ended before both were "
                                     f"seen running: {done}")
            time.sleep(0.002)
        proc.send_signal(signal.SIGTERM)
        t_term = time.monotonic()
        code = proc.wait(timeout=drain_timeout + 30)
        t_exit = time.monotonic() - t_term
        th.join(60)
        ths.join(60)
        out = done.get("out")
        if out is None or out[0] != 200 or out[1]["usage"][
                "completion_tokens"] != SERVER_PROCESS_TOKENS:
            raise AssertionError(f"the completion in flight at SIGTERM: "
                                 f"{out}")
        events = done.get("stream", ([], []))[0]
        _whole_stream(events, "the stream in flight at SIGTERM")
        text, ids, finish = _stream_parts(events)
        if len(ids) != SERVER_PROCESS_TOKENS or finish != "length" or \
                len(text) != SERVER_PROCESS_TOKENS:
            raise AssertionError(f"the stream in flight at SIGTERM: "
                                 f"{len(ids)} ids, {len(text)} characters, "
                                 f"finish {finish}")
        if code != 0 or t_exit > drain_timeout:
            raise AssertionError(f"the server exited {code} after "
                                 f"{t_exit:.1f}s: {''.join(lines[-20:])}")
        log(f"[server process] SIGTERM during a {SERVER_PROCESS_TOKENS}-"
            f"token completion and a {SERVER_PROCESS_TOKENS}-token stream: "
            f"the completion answered 200 with every token, the stream "
            f"ended with its finish chunk and [DONE] after every token; "
            f"exit 0 {t_exit:.2f}s after SIGTERM (--drain-timeout "
            f"{drain_timeout})")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)


# the checkpoint phase: prompts (token ids) and new tokens of the greedy
# streams held between the loaded engine, the in-memory one and the servers
# (the second prompt chunks: prefill_chunk 256)
CKPT_PROMPT_LENS = (20, 300, 64)
CKPT_TOKENS = 32
# the servers of the checkpoint phase take the engine phase's chunk size
CKPT_SERVER_ARGS = ("--prefill-chunk", "256")


def _qwen3_hf_config(cfg) -> dict:
    """The published config.json fields of Qwen/Qwen3-0.6B (no
    ``_name_or_path``: the loader's qwen3 branch builds the config)."""
    return {
        "architectures": ["Qwen3ForCausalLM"], "model_type": "qwen3",
        "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
        "max_position_embeddings": cfg.max_seq_len,
        "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.norm_eps,
        "tie_word_embeddings": True, "bos_token_id": cfg.bos_token_id,
        "eos_token_id": cfg.eos_token_id, "hidden_act": "silu",
        "attention_bias": False, "attention_dropout": 0.0,
        "torch_dtype": "bfloat16", "use_sliding_window": False,
        "sliding_window": None, "rope_scaling": None,
    }


def _qwen3_hf_shapes(cfg) -> dict:
    """HF name -> [out, in] shape of every weight of a tied Qwen3."""
    H, D, I = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size
    shapes = {"model.embed_tokens.weight": (cfg.vocab_size, H)}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        shapes.update({
            p + "input_layernorm.weight": (H,),
            p + "self_attn.q_proj.weight": (cfg.num_heads * D, H),
            p + "self_attn.k_proj.weight": (cfg.num_kv_heads * D, H),
            p + "self_attn.v_proj.weight": (cfg.num_kv_heads * D, H),
            p + "self_attn.o_proj.weight": (H, cfg.num_heads * D),
            p + "self_attn.q_norm.weight": (D,),
            p + "self_attn.k_norm.weight": (D,),
            p + "post_attention_layernorm.weight": (H,),
            p + "mlp.gate_proj.weight": (I, H),
            p + "mlp.up_proj.weight": (I, H),
            p + "mlp.down_proj.weight": (H, I),
        })
    shapes["model.norm.weight"] = (H,)
    return shapes


def _write_safetensors(torch, path, tensors) -> int:
    """One safetensors file of bf16 tensors ({name: tensor on any
    device}), written here byte by byte (no ``safetensors`` package
    needed): the 8-byte little-endian header length, the
    JSON header padded to 8 bytes, the raw little-endian bytes in header
    order. Returns the file's size."""
    import struct

    header, off = {"__metadata__": {"format": "pt"}}, 0
    for name, t in tensors.items():
        n = t.numel() * 2
        header[name] = {"dtype": "BF16", "shape": list(t.shape),
                        "data_offsets": [off, off + n]}
        off += n
    h = json.dumps(header, separators=(",", ":")).encode()
    h += b" " * (-len(h) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(h)) + h)
        for t in tensors.values():
            f.write(t.detach().contiguous().view(torch.int16).cpu().numpy()
                    .tobytes())
    return 8 + len(h) + off


def _write_hf_checkpoint(torch, cfg, path, shards: int = 2):
    """A Qwen3 HF directory at ``cfg``'s width: config.json, the index and
    ``shards`` safetensors files of seeded random bf16 weights under the
    HF names, [out, in] (norms 1 + noise, so that no leaf is constant).
    Returns {name: tensor on the card}, the weights as written."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    src = {}
    for name, shape in _qwen3_hf_shapes(cfg).items():
        x = torch.randn(shape, generator=gen, device="cuda")
        src[name] = (1.0 + 0.1 * x if "norm" in name else 0.02 * x) \
            .to(torch.bfloat16)
    os.makedirs(path)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(_qwen3_hf_config(cfg), f, indent=2)
    names = list(src)
    per = -(-len(names) // shards)
    index, size = {}, 0
    for s in range(shards):
        fname = f"model-{s + 1:05d}-of-{shards:05d}.safetensors"
        part = names[s * per:(s + 1) * per]
        size += _write_safetensors(torch, os.path.join(path, fname),
                                   {n: src[n] for n in part})
        index.update({n: fname for n in part})
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": size}, "weight_map": index}, f)
    return src


def _tree_from_hf(torch, cfg, src) -> dict:
    """The port's parameter tree of HF weights, built here independently of
    the loader: [in, out] kernels stacked on a leading layer axis."""
    L = cfg.num_layers

    def stack(fmt, t):
        return torch.stack([src[fmt.format(i=i)].t() if t
                            else src[fmt.format(i=i)] for i in range(L)]) \
            .contiguous()

    p = "model.layers.{i}."
    return {
        "embed": {"weight": src["model.embed_tokens.weight"]},
        "final_norm": {"weight": src["model.norm.weight"]},
        "layers": {
            "input_norm": {"weight": stack(p + "input_layernorm.weight", 0)},
            "post_norm": {"weight": stack(
                p + "post_attention_layernorm.weight", 0)},
            "wq": {"kernel": stack(p + "self_attn.q_proj.weight", 1)},
            "wk": {"kernel": stack(p + "self_attn.k_proj.weight", 1)},
            "wv": {"kernel": stack(p + "self_attn.v_proj.weight", 1)},
            "wo": {"kernel": stack(p + "self_attn.o_proj.weight", 1)},
            "q_norm": {"weight": stack(p + "self_attn.q_norm.weight", 0)},
            "k_norm": {"weight": stack(p + "self_attn.k_norm.weight", 0)},
            "w_gate": {"kernel": stack(p + "mlp.gate_proj.weight", 1)},
            "w_up": {"kernel": stack(p + "mlp.up_proj.weight", 1)},
            "w_down": {"kernel": stack(p + "mlp.down_proj.weight", 1)},
        },
    }


def _same_bits(torch, got, want, path=()):
    """Fail unless two trees hold the same keys and every leaf the same
    dtype, shape, device type and bits."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise AssertionError(f"tree {'/'.join(path)}: keys "
                                 f"{sorted(got)} != {sorted(want)}")
        return sum(_same_bits(torch, got[k], want[k], path + (k,))
                   for k in want)
    if (got.dtype, tuple(got.shape), got.device.type) != \
            (want.dtype, tuple(want.shape), want.device.type) or \
            not torch.equal(got.view(torch.int16), want.view(torch.int16)):
        raise AssertionError(f"leaf {'/'.join(path)} differs from the "
                             f"written weights")
    return 1


def _greedy_streams(engine, Request, prompts):
    """Each prompt's greedy stream, served alone (a batch prefill of one or
    the chunk walk, as a server serving one request at a time does)."""
    out = []
    for p in prompts:
        req = engine.submit(Request(prompt_ids=p, max_tokens=CKPT_TOKENS,
                                    ignore_eos=True))
        engine.run_until_idle()
        out.append(req.generated)
    return out


def _first_chunk_ms(base, prompt, tag):
    """A streamed request's time from its send to its first content chunk
    (host clock, client side); every token biased to a byte
    (``BYTE_BIAS``), so that each has text and goes out in its chunk."""
    events, times = _sse(base, "/v1/completions", {
        "prompt": prompt, "stream": True, "max_tokens": 8,
        "ignore_eos": True, "logit_bias": BYTE_BIAS})
    _whole_stream(events, tag)
    first = next(j for j, ev in enumerate(events) if ev != "[DONE]"
                 and any(c.get("token_ids") for c in ev["choices"]))
    return (times[first + 1] - times[0]) * 1e3


def _server_run(ckpt, extra, prompts, streams, tag, checks=None):
    """``python -m ...serving.server --checkpoint-dir ckpt`` with ``extra``
    flags: the seconds to ``/readyz`` 200, the first request's and the
    second's time to their first streamed chunk (the first and the
    chunked prompt), each prompt's greedy stream (which must equal
    ``streams``), ``checks(base URL)`` when given, the compile seconds
    counter and the server's own log of its start; then SIGTERM, exit
    0."""
    import signal

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    base = f"http://127.0.0.1:{port}"
    t_start = time.monotonic()
    wall = time.strftime("%H:%M:%S")
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "aws_k8s_ansible_provisioner_tpu_torch.serving.server",
         "--device", "cuda", "--host", "127.0.0.1", "--port", str(port),
         "--checkpoint-dir", ckpt, *CKPT_SERVER_ARGS, *extra],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines = []
    threading.Thread(target=lambda: lines.extend(proc.stdout),
                     daemon=True).start()
    try:
        while True:
            if proc.poll() is not None:
                raise AssertionError(f"{tag} the server exited "
                                     f"{proc.returncode} before it was "
                                     f"ready: {''.join(lines[-20:])}")
            if time.monotonic() - t_start > 300:
                raise AssertionError(f"{tag} not ready in 300 s")
            try:
                if _http(base + "/readyz", timeout=5)[0] == 200:
                    break
            except OSError:
                pass
            time.sleep(0.05)
        t_ready = time.monotonic() - t_start
        ttft = [_first_chunk_ms(base, p, f"{tag} timed stream {i}")
                for i, p in enumerate(prompts[:2])]
        for i, (p, want) in enumerate(zip(prompts, streams)):
            events, _ = _sse(base, "/v1/completions", {
                "prompt": p, "stream": True, "max_tokens": CKPT_TOKENS,
                "ignore_eos": True})
            _whole_stream(events, f"{tag} stream {i}")
            ids = _stream_parts(events)[1]
            if ids != want:
                raise AssertionError(f"{tag} prompt {i} (length {len(p)}): "
                                     f"the server's greedy stream {ids} "
                                     f"!= the engine's {want}")
        if checks is not None:
            checks(base)
        compile_s = _metric(base, "tpu_serve_compile_seconds_total")
        compiled = _metric(base, "tpu_serve_hbm_compiled_bytes")
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(timeout=60)
        if code != 0:
            raise AssertionError(f"{tag} exit {code}: "
                                 f"{''.join(lines[-20:])}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
    log(f"{tag} /readyz 200 {t_ready:.2f}s after the start ({wall}); first "
        f"streamed chunk (client side, host clock) of the first request "
        f"{ttft[0]:.2f} ms ({len(prompts[0])} tokens), of the second "
        f"{ttft[1]:.2f} ms ({len(prompts[1])} tokens, the chunk walk); "
        f"tpu_serve_compile_seconds_total {compile_s:.3f}, "
        f"tpu_serve_hbm_compiled_bytes {compiled:.0f}; the greedy streams "
        f"of {len(prompts)} prompts = the engine's")
    for ln in lines:
        if " INFO " in ln and "HTTP" not in ln or " WARNING " in ln:
            log(f"{tag}   {ln.rstrip()[:200]}")
    return {"ready_s": t_ready, "ttft_ms": ttft, "compile_s": compile_s}


def _http_lora_guided(base, tag, adapter):
    """Over a server started with ``--lora <adapter>=DIR``: ``/v1/models``
    lists the adapter under the served model; a completion on the adapter
    answers with its id; ``response_format: json_object`` parses, on the
    adapter whole and on the base model streamed."""
    out = _http(base + "/v1/models")
    ids = [m["id"] for m in out[1]["data"]]
    if out[0] != 200 or len(ids) != 2 or ids[1] != adapter or \
            out[1]["data"][1].get("parent") != ids[0]:
        raise AssertionError(f"{tag} /v1/models: {out[:2]}")
    out = _expect(f"{tag} adapter completion", _http(
        base + "/v1/completions", {"model": adapter, "prompt": "hello",
                                   "max_tokens": 8, "ignore_eos": True}),
        200, model=adapter)
    body = {"prompt": "Reply in JSON:", "max_tokens": GUIDED_TOKENS,
            "response_format": {"type": "json_object"},
            "logit_bias": GUIDED_BIAS}
    whole = _expect(f"{tag} json_object on the adapter", _http(
        base + "/v1/completions", {**body, "model": adapter}), 200)
    text = whole[1]["choices"][0]["text"]
    events, _ = _sse(base, "/v1/completions", {**body, "stream": True})
    _whole_stream(events, f"{tag} json_object stream")
    streamed, _, finish = _stream_parts(events)
    for what, t in (("whole, adapter", text), ("streamed, base", streamed)):
        if not isinstance(json.loads(t), dict):
            raise AssertionError(f"{tag} json_object ({what}): {t!r}")
    log(f"{tag} /v1/models {ids} (parent {ids[0]!r}); model {adapter!r} "
        f"answered {out[1]['usage']['completion_tokens']} tokens; "
        f"json_object on {adapter!r}: {text!r}, streamed on the base: "
        f"{streamed!r} ({finish}): both parse")


def phase_checkpoint(torch, np):
    """Loading and warmup at the published width of Qwen3-0.6B (28 layers,
    hidden 1024, vocab 151,936, tied, bf16): an HF directory of seeded
    random weights written here (config.json without ``_name_or_path``, two
    safetensors shards, no tokenizer files); ``config_from_hf_dir`` held
    against the registry's entry; ``load_checkpoint_cached`` onto the card,
    every leaf bit for bit against the written weights, timed on a miss
    (conversion, cache write) and a hit, with the load's peak device
    memory; an engine of the loaded tree and one of the in-memory tree
    giving the same greedy streams, K1 (decode and ragged) and the fused K2
    launching; the AOT manifest of the server's configuration; the server
    process over the directory with the manifest and warmup, and with
    ``--no-warmup`` (its greedy answers the engine's; seconds to /readyz,
    the first and second request's first chunk, the compile seconds); a
    manifest whose ``max_len`` was edited stopping the server before
    warmup with a non-zero exit. The manifest and the warmed run carry
    ``--lora a=DIR`` (a peft adapter written here, r 16, all seven
    targets): the base streams stay the engine's, ``/v1/models`` lists
    ``a``, ``model: "a"`` answers and ``response_format: json_object``
    parses, whole and streamed. The directory is removed at the end."""
    import dataclasses
    import shutil
    import tempfile

    from aws_k8s_ansible_provisioner_tpu_torch import config
    from aws_k8s_ansible_provisioner_tpu_torch.models import checkpoint as ck
    from aws_k8s_ansible_provisioner_tpu_torch.models import hf_loader
    from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import (Engine,
                                                                      Request)

    cfg = config.QWEN3_0_6B
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    ckpt = os.path.join(tmp, "Qwen3-0.6B")
    try:
        t0 = time.monotonic()
        src = _write_hf_checkpoint(torch, cfg, ckpt)
        files = sorted(f for f in os.listdir(ckpt)
                       if f.endswith(".safetensors"))
        size = sum(os.path.getsize(os.path.join(ckpt, f)) for f in files)
        log(f"[checkpoint] wrote {ckpt}: {len(files)} shards, "
            f"{size / 2**30:.3f} GiB of bf16, {len(src)} tensors; "
            f"{time.monotonic() - t0:.1f}s")
        got = hf_loader.config_from_hf_dir(ckpt)
        skip = {"name", "hf_repo", "bos_token_id"}
        diff = {k: (v, getattr(cfg, k)) for k, v in
                dataclasses.asdict(got).items()
                if k not in skip and v != getattr(cfg, k)}
        if diff or got.name != "Qwen3-0.6B":
            raise AssertionError(f"[checkpoint] config_from_hf_dir differs "
                                 f"from QWEN3_0_6B: {diff}, {got.name}")
        log(f"[checkpoint] config_from_hf_dir = QWEN3_0_6B apart from name "
            f"({got.name!r}), hf_repo and bos_token_id ({got.bos_token_id}:"
            f" the qwen3 branch reads none, as the JAX loader's)")
        import importlib.util

        from aws_k8s_ansible_provisioner_tpu_torch.utils.tokenizer import (
            ByteTokenizer, load_tokenizer)

        t = time.monotonic()
        tok = load_tokenizer(ckpt)
        if type(tok) is not ByteTokenizer:
            raise AssertionError(f"[checkpoint] a directory without "
                                 f"tokenizer files gave {tok!r}")
        hf = "installed" if importlib.util.find_spec("transformers") \
            else "absent"
        log(f"[checkpoint] load_tokenizer: the byte tokenizer (no tokenizer "
            f"files; transformers {hf} here), {time.monotonic() - t:.3f}s")
        # the conversion and the cache write timed apart, inside the miss
        times = {}
        real_load, real_save = hf_loader.load_checkpoint, ck.save_params

        def timed(key, fn):
            def run(*a, **kw):
                torch.cuda.synchronize()
                t = time.monotonic()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                times[key] = time.monotonic() - t
                return out
            return run

        hf_loader.load_checkpoint = timed("convert", real_load)
        ck.save_params = timed("write", real_save)
        try:
            loads = []
            for _ in range(2):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                t = time.monotonic()
                tree = ck.load_checkpoint_cached(ckpt, got, torch.bfloat16,
                                                 device="cuda")
                torch.cuda.synchronize()
                loads.append((tree, time.monotonic() - t,
                              torch.cuda.max_memory_allocated() - base,
                              torch.cuda.memory_allocated() - base))
        finally:
            hf_loader.load_checkpoint, ck.save_params = real_load, real_save
        if set(times) != {"convert", "write"}:
            raise AssertionError(f"[checkpoint] the first load did not "
                                 f"convert and write the cache: {times}")
        want = _tree_from_hf(torch, got, src)
        n = [_same_bits(torch, tree, want) for tree, *_ in loads]
        (miss, t_miss, peak_miss, held), (hit, t_hit, peak_hit, _) = loads
        cache = ck.cache_dir(ckpt, torch.bfloat16)
        cache_gib = os.path.getsize(os.path.join(cache, ck.PARAMS_FILE)) \
            / 2**30
        log(f"[checkpoint] load_checkpoint_cached onto the card: miss "
            f"{t_miss:.2f}s (conversion {times['convert']:.2f}s, cache "
            f"write {times['write']:.2f}s, {cache_gib:.3f} GiB), hit "
            f"{t_hit:.2f}s (reads warm in the page cache); peak device "
            f"memory above the start {peak_miss / 2**30:.3f} GiB (miss), "
            f"{peak_hit / 2**30:.3f} GiB (hit), the tree "
            f"{held / 2**30:.3f} GiB; {n[0]} + {n[1]} leaves bit for bit "
            f"the written weights")
        del loads, hit, want
        rng = np.random.default_rng(5)
        prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
                   for n in CKPT_PROMPT_LENS]
        serving = config.ServingConfig(prefill_chunk=256, derived_seed=0)
        streams = []
        for name, tree in (("loaded", miss), ("in-memory",
                                              _tree_from_hf(torch, got,
                                                            src))):
            engine = Engine(got, tree, serving, device="cuda")
            del tree
            torch.cuda.synchronize()
            _reset_launches()
            engine.counts.clear()
            streams.append(_greedy_streams(engine, Request, prompts))
            torch.cuda.synchronize()
            launches = _launches()
            counts = dict(engine.counts)
            del engine
            _free(torch)
            if name == "loaded":
                need = ("paged_attention", "paged_attention chunk",
                        "prep_write_rows_paged")
                if min(launches[k] for k in need) <= 0:
                    raise AssertionError(f"[checkpoint] a kernel of the "
                                         f"path never launched: {launches}")
                log(f"[checkpoint] engine of the loaded tree: "
                    f"{ {k: launches[k] for k in need} }; dispatches "
                    f"{counts}")
        del miss, src
        _free(torch)
        if streams[0] != streams[1] or \
                any(len(s) != CKPT_TOKENS for s in streams[0]):
            raise AssertionError(f"[checkpoint] greedy streams of the loaded "
                                 f"and the in-memory tree differ: {streams}")
        log(f"[checkpoint] greedy streams of {len(prompts)} prompts x "
            f"{CKPT_TOKENS} tokens: the loaded tree's = the in-memory "
            f"tree's")
        adapter = os.path.join(tmp, "adapter_a")
        _write_adapter_dir(torch, cfg, adapter, 16, 33)
        lora_args = ("--lora", f"a={adapter}")
        manifest = os.path.join(tmp, "aot.json")
        t = time.monotonic()
        out = subprocess.run(
            [sys.executable, "-m",
             "aws_k8s_ansible_provisioner_tpu_torch.serving.aot",
             "--device", "cuda", "--checkpoint-dir", ckpt,
             *CKPT_SERVER_ARGS, *lora_args, "--out", manifest],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            raise AssertionError(f"[checkpoint] aot exit {out.returncode}: "
                                 f"{out.stdout[-2000:]} {out.stderr[-3000:]}")
        with open(manifest) as f:
            m = json.load(f)
        led = m["hbm_ledger"]
        log(f"[checkpoint] aot manifest ({time.monotonic() - t:.1f}s): "
            f"{len(m['programs'])} programs, first runs "
            f"{m['total_compile_seconds']:.3f}s, graph capture "
            f"{m['graph_capture_seconds']:.3f}s; ledger (GiB) capacity "
            f"{led['capacity_bytes_per_chip'] / 2**30:.3f}, params "
            f"{led['params_bytes_per_chip'] / 2**30:.3f}, KV "
            f"{led['kv_bytes_per_chip'] / 2**30:.3f}, graphs "
            f"{led['graph_pool_bytes'] / 2**30:.3f}, largest peak "
            f"{led['max_temp_bytes'] / 2**30:.3f} "
            f"({max(m['programs'], key=lambda p: p['temp_bytes'])['name']}),"
            f" total {led['total_bytes'] / 2**30:.3f}, headroom "
            f"{led['headroom_bytes'] / 2**30:.3f}, fit {led['fit']}")
        log("[checkpoint] programs: " + ", ".join(
            f"{p['name']} {p['compile_seconds']:.3f}s "
            f"{p['temp_bytes'] / 2**20:.1f} MiB" for p in m["programs"]))
        runs = {
            "warmup": _server_run(
                ckpt, ("--aot-manifest", manifest) + lora_args, prompts,
                streams[0], "[checkpoint server, manifest + warmup + lora]",
                lambda base: _http_lora_guided(
                    base, "[checkpoint server, lora]", "a")),
            "no-warmup": _server_run(ckpt, ("--no-warmup",), prompts,
                                     streams[0],
                                     "[checkpoint server, --no-warmup]"),
        }
        if not runs["warmup"]["compile_s"] > 0 or \
                runs["no-warmup"]["compile_s"] != 0:
            raise AssertionError(f"[checkpoint] compile seconds: {runs}")
        m["config"]["max_len"] = 2 * m["config"]["max_len"]
        bad = os.path.join(tmp, "aot_edited.json")
        with open(bad, "w") as f:
            json.dump(m, f)
        t = time.monotonic()
        out = subprocess.run(
            [sys.executable, "-m",
             "aws_k8s_ansible_provisioner_tpu_torch.serving.server",
             "--device", "cuda", "--port", "0", "--checkpoint-dir", ckpt,
             *CKPT_SERVER_ARGS, *lora_args, "--aot-manifest", bad],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        text = out.stdout + out.stderr
        if out.returncode == 0 or "max_len" not in text or \
                "warmup:" in text or "serving " in text:
            raise AssertionError(f"[checkpoint] the edited manifest: exit "
                                 f"{out.returncode}: {text[-3000:]}")
        log(f"[checkpoint] a manifest with max_len edited: the server "
            f"exited {out.returncode} before warmup "
            f"({time.monotonic() - t:.1f}s): "
            f"{[ln for ln in text.splitlines() if 'max_len' in ln][-1][:200]}")
        return runs
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if os.path.exists(tmp):
            raise AssertionError(f"[checkpoint] {tmp} was not removed")


# guided decoding over the byte tokenizer (ids 0-255 bytes, 258 eos): the
# whitespace bytes and the backslash banned, the closing bytes and eos
# favoured, so that seeded random weights close their answers within the
# budget (the grammar alone allows whitespace forever)
GUIDED_EOS = 258
GUIDED_BIAS = {**{str(b): -100.0 for b in b" \t\n\r\\"},
               **{str(ord(c)): v for c, v in (('"', 20.0), ("}", 40.0),
                                               ("]", 30.0))},
               str(GUIDED_EOS): 100.0}
GUIDED_SPECS = {
    "json_object": {"response_format": {"type": "json_object"}},
    "json_schema": {"response_format": {"type": "json_schema", "json_schema": {
        "name": "pet", "schema": {
            "type": "object",
            "properties": {"kind": {"enum": ["cat", "dog", "bird"]},
                           "n": {"type": "integer"}},
            "required": ["kind", "n"]}}}},
    "regex": {"guided_regex": r"[A-Z]{3}-\d{2}"},
    "choice": {"guided_choice": ["alpha", "beta", "gamma"]},
}
GUIDED_TOKENS = 64
# the adapters of the guided and LoRA phase: (name, rank, seed), all seven
# targets, A ~ N(0, 0.02^2), B ~ N(0, 0.1^2), alpha = r: a delta of about
# sqrt(r) x 0.1 (0.4 at r 16) of a random projection's output
LORA_ADAPTERS = (("a", 16, 31), ("b", 8, 32))
LORA_TOKENS = 40
# an adapter row's logits must lie this many LOGIT_TOLs from the base
# model's, so that the merged-weight check's tolerance would catch a
# missing delta
LORA_BASE_MIN = 5


def _guided_answer_ok(kind, text):
    """Whether a guided answer parses, or matches its regex or choice."""
    if kind == "json_object":
        return isinstance(json.loads(text), dict)
    if kind == "json_schema":
        obj = json.loads(text)
        spec = GUIDED_SPECS[kind]["response_format"]["json_schema"]["schema"]
        return (set(obj) == {"kind", "n"} and isinstance(obj["n"], int)
                and obj["kind"] in spec["properties"]["kind"]["enum"])
    if kind == "regex":
        return re.fullmatch(GUIDED_SPECS[kind]["guided_regex"], text) \
            is not None
    return text in GUIDED_SPECS[kind]["guided_choice"]


def _write_adapter_dir(torch, cfg, path, r, seed):
    """A peft LoRA adapter directory at ``cfg``'s width: adapter_config.json
    (r, lora_alpha = r, the seven targets) and adapter_model.safetensors of
    seeded bf16 factors under peft's names (lora_A [r, in], lora_B [out, r])
    written by :func:`_write_safetensors`."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    H, Q, KV, I = (cfg.hidden_size, cfg.q_size, cfg.kv_size,
                   cfg.intermediate_size)
    dims = {"self_attn.q_proj": (H, Q), "self_attn.k_proj": (H, KV),
            "self_attn.v_proj": (H, KV), "self_attn.o_proj": (Q, H),
            "mlp.gate_proj": (H, I), "mlp.up_proj": (H, I),
            "mlp.down_proj": (I, H)}
    tensors = {}
    for layer in range(cfg.num_layers):
        for mod, (din, dout) in dims.items():
            base = f"base_model.model.model.layers.{layer}.{mod}"
            tensors[base + ".lora_A.weight"] = (0.02 * torch.randn(
                (r, din), generator=gen)).to(torch.bfloat16)
            tensors[base + ".lora_B.weight"] = (0.1 * torch.randn(
                (dout, r), generator=gen)).to(torch.bfloat16)
    os.makedirs(path)
    with open(os.path.join(path, "adapter_config.json"), "w") as f:
        json.dump({"peft_type": "LORA", "r": r, "lora_alpha": r,
                   "target_modules": [m.split(".")[1] for m in dims]}, f)
    return _write_safetensors(torch, os.path.join(
        path, "adapter_model.safetensors"), tensors)


def _log_mask_time(tag, counts):
    """The host's guided-mask time of a run (engine counts): the words'
    building and upload, the cursors' mask computation within it, per
    guided token; the allow words' cache hits."""
    gtok = max(1, counts.get("guided_tokens", 0))
    host_us = counts.get("allow_host_ns", 0) / 1e3
    mask_us = counts.get("allow_mask_ns", 0) / 1e3
    log(f"{tag}: host mask time {host_us:.0f} us over {gtok} guided tokens "
        f"= {host_us / gtok:.1f} us a guided token, of which mask_words "
        f"{mask_us / gtok:.1f} us; allow-words cache hits "
        f"{counts.get('allow_words_hits', 0)}")


def _check_run_launches(tag, engine, counts):
    """The launches of one run of the guided and LoRA phase, zeroed just
    before it (``counts`` the engine's counts of that run): K1 once a layer
    of every paged forward (decode substeps and mixed dispatches; the
    verifies launch K1-spec), its chunk body in the mixed dispatches, the
    fused q/k prologue and row write once a layer of every forward, the
    int8 pool's kernels never."""
    launches = _launches()
    forwards = counts.get("decode_substeps", 0) + \
        counts.get("mixed_dispatches", 0)
    _check_fused_writes(tag, engine, launches, counts)
    others = _kernel_names(True) + ("paged_attention_spec_quant",)
    if launches["paged_attention"] != engine.cfg.num_layers * forwards or \
            launches["paged_attention chunk"] <= 0 or \
            any(launches[k] for k in others):
        raise AssertionError(f"{tag} launches {launches}, expected K1 "
                             f"{engine.cfg.num_layers} x {forwards}, its "
                             f"chunk body > 0, {others} 0")
    log(f"{tag} K1 {launches['paged_attention']} launches = "
        f"{engine.cfg.num_layers} layers x {forwards} paged forwards, its "
        f"chunk body {launches['paged_attention chunk']}; int8 pool 0")
    return launches


def _run_requests(engine, reqs):
    """Submit the engine requests ``reqs`` and run until idle."""
    for r in reqs:
        engine.submit(r)
    engine.run_until_idle()
    return reqs


def _guided_run(engine, Request, neighbours, prompts, guided):
    """4 greedy unguided neighbours admitted first (one prefill batch), then,
    with their first decode dispatch in flight, 4 requests over
    ``prompts``, guided by ``guided`` (a list of grammars) or, with
    ``guided`` None, unguided with the same lengths, so that both runs
    prefill, chunk and decode the neighbours alike. Returns (neighbour
    requests, the others)."""
    near = [engine.submit(Request(prompt_ids=p, max_tokens=GUIDED_TOKENS,
                                  ignore_eos=True)) for p in neighbours]
    while engine._inflight is None:
        engine.step()
    bias = tuple((int(k), v) for k, v in GUIDED_BIAS.items())
    others = [engine.submit(Request(
        prompt_ids=p, max_tokens=GUIDED_TOKENS,
        guided=None if guided is None else guided[i],
        logit_bias=bias if guided is not None else (),
        ignore_eos=guided is None)) for i, p in enumerate(prompts)]
    engine.run_until_idle()
    return near, others


def _lora_step_logits(torch, engine, slots):
    """The next decode step of ``slots`` through the kernels and their
    adapters (the engine's paged decode callback and its adapter indices),
    on the engine's own pool (the step writes each slot's next row, which
    the engine's next dispatch rewrites): logits [len(slots), V] float32."""
    from aws_k8s_ansible_provisioner_tpu_torch.ops.attention import \
        make_decode_attend_carry_paged

    engine._settle_inflight()
    engine._ensure_pages(1)
    dev = engine.device
    tok = torch.from_numpy(engine.last_token.copy()).to(dev)
    lens = torch.from_numpy(engine.lengths.copy()).to(dev)
    table = torch.from_numpy(engine.table.copy()).to(dev)
    lora = torch.from_numpy(engine.lora_idx.copy()).to(dev)
    logits, _ = engine.model.forward_carry(
        tok[:, None], lens[:, None], engine.cache,
        make_decode_attend_carry_paged(lens, table, 0),
        engine.model.lora_rows(lora))
    return logits[torch.tensor(slots, device=dev), 0].float()


def _merged_models(torch, cfg, params, served, adapter):
    """Two plain models with the adapter merged into the base weights, W +
    A.B computed in float32: (``params``, the bf16 weights before the
    engine quantized them, merged and then quantized to int8 as the engine
    quantizes; the engine's own int8 weights ``served`` dequantized, merged
    and rounded to the activation dtype, bf16: the weights the engine's
    base kernels and adapter together apply, in one matrix)."""
    from aws_k8s_ansible_provisioner_tpu_torch.models.layers import DecoderLM
    from aws_k8s_ansible_provisioner_tpu_torch.models.quant import \
        quantize_params

    requant = dict(params["layers"])
    exact = {k: v for k, v in served["layers"].items()
             if not k.startswith("lora_")}
    for t, (a, b) in adapter["targets"].items():
        dev = requant[t]["kernel"].device
        ab = torch.einsum("lir,lro->lio", torch.from_numpy(a).to(dev),
                          torch.from_numpy(b).to(dev))
        requant[t] = {**requant[t], "kernel": requant[t]["kernel"].float()
                      + ab}
        q = served["layers"][t]
        exact[t] = {"kernel": (q["kernel"].float() * q["scale"][:, None]
                               + ab).to(torch.bfloat16)}
    return (DecoderLM(cfg, quantize_params({**params, "layers": requant},
                                           cfg)),
            DecoderLM(cfg, {**{k: v for k, v in served.items()
                               if k != "lora"}, "layers": exact}))


def phase_guided_lora(torch, np):
    """Guided decoding and multi-LoRA on the main path: Qwen3-0.6B at full
    width (the default ServingConfig: paged, bf16 KV, int8 weights, 32
    slots of 2048 rows; prefill_chunk 256; the prefix cache off where one
    prompt runs twice), the byte tokenizer's grammars (eos 258).

    Guided: 4 greedy unguided requests, then, with their decode dispatch in
    flight, 4 guided ones (json_object, a json_schema with required keys
    and an enum, a regex, a choice) that take the chunk walk (``mixed_step``
    with the decode rows' allow words and the chunk row's own) and decode
    beside them through the decode graphs (their always-on allow operand)
    and the pipeline: every guided answer must finish and parse or match,
    and every neighbour's stream must equal its stream in a run where the
    4 others are unguided requests of the same lengths. The host's time a
    guided token (mask words and their upload) and the words' cache hits
    are logged; one default decode dispatch of 8 slots is profiled (device
    operations and device ms a substep, with the allow operand).

    LoRA: two peft adapters written here (r 16 and r 8, all seven
    targets, seeded) and an engine over them: a mixed batch (base, a, b,
    twice each; two prompts chunked) gives every slot the greedy stream of
    the run where all 6 take that slot's adapter; one decode step of the
    adapter rows through the kernels within LOGIT_TOL of a plain forward
    over the merged weights (the engine's int8 kernels dequantized + A.B in
    float32, rounded to bf16; the error against W + A.B quantized to int8
    anew is logged beside it) and more than LORA_BASE_MIN x LOGIT_TOL from
    the base model's; a prompt on adapter a, then on b (no prefix hit),
    then on a (a hit); prompt lookup over adapter slots (verify dispatches
    through K1-spec); one dispatch profiled, the graphs' capture time and
    memory. The launch counts are zeroed just before the guided run, the
    mixed adapter batch and the prompt-lookup run and checked just after
    each (:func:`_check_run_launches`, :func:`_check_fused_writes`); the
    hand-made step and the profiled dispatches are in no checked count."""
    import dataclasses
    import shutil
    import tempfile

    from aws_k8s_ansible_provisioner_tpu_torch import config
    from aws_k8s_ansible_provisioner_tpu_torch.models import lora as tlora
    from aws_k8s_ansible_provisioner_tpu_torch.models.layers import init_params
    from aws_k8s_ansible_provisioner_tpu_torch.serving import guided as tg
    from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import (Engine,
                                                                      Request)
    from aws_k8s_ansible_provisioner_tpu_torch.utils.tokenizer import \
        ByteTokenizer

    cfg = config.QWEN3_0_6B
    tok = ByteTokenizer()
    serving = config.ServingConfig(prefill_chunk=256, derived_seed=0,
                                   prefix_cache=False)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = init_params(cfg, gen, torch.bfloat16)
    tag = "[guided]"
    t0 = time.monotonic()
    engine = Engine(cfg, params, serving, eos_token_id=GUIDED_EOS,
                    device="cuda")
    torch.cuda.synchronize()
    log(f"{tag} {cfg.name} engine: {_cache_layout(engine)}, "
        f"{_dispatch_mode(engine)}; set-up {time.monotonic() - t0:.1f}s")
    eos = sorted(engine._eos_set)
    grammars = {k: tg.grammar_for_request(tok, body, eos)
                for k, body in GUIDED_SPECS.items()}
    rng = np.random.default_rng(7)
    neighbours = [rng.integers(0, cfg.vocab_size, n).tolist()
                  for n in (40, 90, 150, 60)]
    prompts = [tok.encode(f"Answer as {k}: " + "x" * n)
               for k, n in zip(GUIDED_SPECS, (20, 300, 80, 40))]
    engine.run_until_idle()
    replays0 = engine.decoder.replays
    engine.counts.clear()
    _reset_launches()
    t = time.monotonic()
    near, guided = _guided_run(engine, Request, neighbours, prompts,
                               [grammars[k] for k in GUIDED_SPECS])
    dt = time.monotonic() - t
    counts = dict(engine.counts)
    _check_run_launches(tag, engine, counts)
    _check_replays(tag, engine, replays0)
    for kind, req in zip(GUIDED_SPECS, guided):
        text = tok.decode(req.generated)
        if req.finish_reason != "stop" or not _guided_answer_ok(kind, text):
            raise AssertionError(f"{tag} {kind}: {req.finish_reason} after "
                                 f"{len(req.generated)} tokens: {text!r}")
        log(f"{tag} {kind}: {len(req.generated)} tokens, {text!r}")
    if counts.get("mixed_dispatches", 0) <= 0:
        raise AssertionError(f"{tag} no guided request took mixed_step")
    log(f"{tag} {len(guided)} guided + {len(near)} unguided requests in "
        f"{dt:.2f}s; dispatches {counts}")
    _log_mask_time(f"{tag} first run (every grammar state new)", counts)
    ref_near, _ = _guided_run(engine, Request, neighbours, prompts, None)
    for i, (a, b) in enumerate(zip(near, ref_near)):
        if a.generated != b.generated:
            raise AssertionError(f"{tag} neighbour {i}: its stream beside "
                                 f"the guided requests differs from its "
                                 f"stream beside unguided ones")
    log(f"{tag} the {len(near)} unguided neighbours' streams "
        f"({GUIDED_TOKENS} tokens each) = their streams beside unguided "
        f"requests of the same lengths")
    # the same guided run again: the grammars' masks of these states are
    # cached, so the host's time is the words' building and upload
    engine.counts.clear()
    again = _guided_run(engine, Request, neighbours, prompts,
                        [grammars[k] for k in GUIDED_SPECS])[1]
    if [r.generated for r in again] != [r.generated for r in guided]:
        raise AssertionError(f"{tag} the guided answers differ run to run")
    _log_mask_time(f"{tag} second run (the states' masks cached)",
                   dict(engine.counts))
    default = {}
    for _ in range(8):
        engine.submit(Request(prompt_ids=rng.integers(
            0, cfg.vocab_size, 100).tolist(), max_tokens=200,
            ignore_eos=True))
    while engine.pending or engine._chunk is not None:
        engine.step()
    engine.step()
    _profile_dispatch(torch, engine, "[profile guided engine, default "
                                     "dispatch]", stats=default)
    for s in engine._active_slots():
        engine.cancel(engine.slot_req[s])
    engine.run_until_idle()
    g_capture, g_pool = engine.decoder.capture_s, engine.decoder.pool_bytes
    del engine
    _free(torch)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_lora_")
    tag = "[lora]"
    try:
        dirs = {}
        for name, r, seed in LORA_ADAPTERS:
            dirs[name] = os.path.join(tmp, name)
            size = _write_adapter_dir(torch, cfg, dirs[name], r, seed)
            log(f"{tag} adapter {name}: r {r}, seven targets, "
                f"{size / 2**20:.1f} MiB")
        t0 = time.monotonic()
        serving = dataclasses.replace(serving, spec_decode=True)
        engine = Engine(cfg, params, serving, device="cuda", lora=dirs)
        torch.cuda.synchronize()
        log(f"{tag} engine with adapters {engine.lora_names}: "
            f"{_dispatch_mode(engine)}; set-up {time.monotonic() - t0:.1f}s")
        plain = dataclasses.replace(serving, spec_decode=False)
        engine.serving = plain
        lens = (40, 300, 64, 120, 280, 90)
        prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
        mix = [None, "a", "b", None, "a", "b"]

        def run(names):
            return [r.generated for r in _run_requests(engine, [
                Request(prompt_ids=p, max_tokens=LORA_TOKENS,
                        ignore_eos=True, lora=n)
                for p, n in zip(prompts, names)])]

        replays0 = engine.decoder.replays
        engine.counts.clear()
        _reset_launches()
        mixed = run(mix)
        _check_run_launches(tag, engine, engine.counts)
        _check_replays(tag, engine, replays0)
        alone = {n: run([n] * len(prompts)) for n in (None, "a", "b")}
        for i, n in enumerate(mix):
            if mixed[i] != alone[n][i]:
                raise AssertionError(f"{tag} slot {i} (adapter {n}): its "
                                     f"stream in the mixed batch differs "
                                     f"from the one-adapter run")
        differ = sum(alone["a"][i] != alone[None][i] for i in range(6))
        log(f"{tag} mixed batch (adapters {mix}, prompts {list(lens)}): "
            f"every slot's {LORA_TOKENS}-token stream = its one-adapter "
            f"run's; adapter a's streams differ from the base's in "
            f"{differ} of 6 prompts")
        if differ == 0:
            raise AssertionError(f"{tag} adapter a changes no stream")
        # one decode step of the adapter rows against the merged weights
        reqs = [Request(prompt_ids=p, max_tokens=4 * LORA_TOKENS,
                        ignore_eos=True, lora=n)
                for p, n in zip(prompts[:4], ("a", "b", "a", "b"))]
        for r in reqs:
            engine.submit(r)
        while engine.pending or engine._chunk is not None:
            engine.step()
        for _ in range(2):
            engine.step()
        engine._settle_inflight()
        slots = engine._active_slots()
        if len(slots) != len(reqs):
            raise AssertionError(f"{tag} {len(slots)} active slots of "
                                 f"{len(reqs)}")
        got = _lora_step_logits(torch, engine, slots)
        errs = {"exact": [], "requant": [], "own": [], "base": []}
        served = engine.model.params
        for name, r, _ in LORA_ADAPTERS:
            requant, exact = _merged_models(torch, cfg, params, served,
                                            tlora.load_adapter(dirs[name]))
            for j, s in enumerate(slots):
                req = engine.slot_req[s]
                if req.lora != name:
                    continue
                ids = req.prompt_ids + req.generated
                x = torch.tensor([ids], device="cuda")
                pos = torch.arange(len(ids), device="cuda")[None]
                own = engine.model(x, pos, lora=engine.model.lora_rows(
                    torch.tensor([engine.lora_idx[s]], device="cuda")))
                for key, m in (("exact", exact), ("requant", requant),
                               ("own", None), ("base", engine.model)):
                    want = (own if m is None else m(x, pos))[0, -1].float()
                    errs[key].append(float((got[j] - want).abs().max()))
            del requant, exact
            _free(torch)
        torch.cuda.synchronize()
        log(f"{tag} one decode step of {len(slots)} adapter rows through the "
            f"kernels, max abs logit difference (per row) against a plain "
            f"forward over: the merged weights, the engine's int8 kernels "
            f"dequantized + A.B in float32, rounded to bf16: "
            f"{max(errs['exact']):.3e} "
            f"({[round(e, 4) for e in errs['exact']]}; tol {LOGIT_TOL}); "
            f"the merged weights W + A.B in float32 quantized to int8 anew "
            f"(two int8 roundings of different matrices): "
            f"{max(errs['requant']):.3e} "
            f"({[round(e, 4) for e in errs['requant']]}); the engine's own "
            f"weights and adapters (plain attention): "
            f"{max(errs['own']):.3e}; the base model without the adapter "
            f"(plain attention): at least {min(errs['base']):.3e} "
            f"({[round(e, 4) for e in errs['base']]}; must exceed "
            f"{LORA_BASE_MIN * LOGIT_TOL})")
        if not max(errs["exact"]) <= LOGIT_TOL:
            raise AssertionError(f"{tag} adapter logits differ from the "
                                 f"merged weights': {errs}")
        if not min(errs["base"]) > LORA_BASE_MIN * LOGIT_TOL:
            raise AssertionError(f"{tag} an adapter row's logits lie within "
                                 f"{LORA_BASE_MIN} x {LOGIT_TOL} of the base "
                                 f"model's: {errs}")
        for r in reqs:
            engine.cancel(r)
        engine.run_until_idle()
        # the prefix chain is salted by the adapter
        engine.serving = dataclasses.replace(plain, prefix_cache=True)
        shared = rng.integers(0, cfg.vocab_size, 200).tolist()
        hits = []
        for n in ("a", "b", "a"):
            _run_requests(engine, [Request(prompt_ids=shared, max_tokens=8,
                                           ignore_eos=True, lora=n)])
            hits.append(engine.counts["prefix_cache_hits"])
        if not (hits[1] == hits[0] and hits[2] > hits[1]):
            raise AssertionError(f"{tag} prefix hits after a, b, a: {hits}")
        log(f"{tag} a 200-token prompt on adapter a, then b, then a: prefix "
            f"hits {hits} (b matched none of a's pages, a its own)")
        # prompt lookup over adapter slots
        engine.serving = serving
        engine.counts.clear()
        _reset_launches()
        spec = _run_requests(engine, [Request(
            prompt_ids=p, max_tokens=LORA_TOKENS, ignore_eos=True, lora=n)
            for p, n in zip(_pattern_prompts(rng, cfg.vocab_size, 4),
                            ("a", "b", None, "a"))])
        sl = _launches()
        _check_fused_writes(tag, engine, sl, engine.counts)
        if engine.counts["spec_dispatches"] <= 0 or \
                sl["paged_attention_spec"] <= 0 or \
                any(len(r.generated) != LORA_TOKENS for r in spec):
            raise AssertionError(f"{tag} prompt lookup over adapter slots: "
                                 f"{dict(engine.counts)}, {sl}")
        log(f"{tag} prompt lookup over adapter slots: "
            f"{engine.counts['spec_dispatches']} verify dispatches, "
            f"{engine.counts['spec_accepted_tokens']} of "
            f"{engine.counts['spec_drafted_tokens']} drafts accepted, "
            f"K1-spec {sl['paged_attention_spec']} launches")
        engine.serving = plain
        stats = {}
        for i in range(8):
            engine.submit(Request(prompt_ids=rng.integers(
                0, cfg.vocab_size, 100).tolist(), max_tokens=200,
                ignore_eos=True, lora=(None, "a", "b")[i % 3]))
        while engine.pending or engine._chunk is not None:
            engine.step()
        engine.step()
        _profile_dispatch(torch, engine, "[profile lora engine, 8 slots over "
                                         "base, a, b]", stats=stats)
        for s in engine._active_slots():
            engine.cancel(engine.slot_req[s])
        engine.run_until_idle()
        torch.cuda.synchronize()
        log(f"[guided and lora] default graph (allow operand on): "
            f"{default.get('ops_per_substep', float('nan')):.1f} device "
            f"operations and {default.get('busy_ms', float('nan')) / 8:.3f} "
            f"device ms a substep (8 slots, horizon 8), capture "
            f"{g_capture:.2f}s, {g_pool / 2**20:.1f} MiB; adapter engine: "
            f"{stats.get('ops_per_substep', float('nan')):.1f} operations, "
            f"{stats.get('busy_ms', float('nan')) / 8:.3f} device ms a "
            f"substep, capture {engine.decoder.capture_s:.2f}s, "
            f"{engine.decoder.pool_bytes / 2**20:.1f} MiB")
        del engine
        _free(torch)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"default": default, "lora": stats}


# -- the other dense families: Llama, Gemma, Phi and OPT ---------------------

# the families' registered configs (full width and depth), by short name:
# Llama-3.2-1B (D 64, G 4, llama3 RoPE), gemma-2b (D 256, MQA G 8,
# zero-centred norms, GeGLU, scaled embedding), phi-2 (D 80, RoPE over 32
# columns, MHA, the parallel block, biases), opt-1.3b (D 64, MHA, learned
# positions: no RoPE, ReLU)
FAMILIES = ("llama", "gemma", "phi", "opt")
# the 8 greedy requests' prompt lengths: up to 700 tokens, and up to ~1,900
# for the families whose learned or published window is 2048 rows
FAMILY_PROMPTS = {"llama": (9, 40, 120, 256, 300, 450, 600, 700),
                  "gemma": (9, 40, 120, 256, 300, 450, 600, 700),
                  "phi": (9, 60, 200, 450, 700, 1100, 1500, 1900),
                  "opt": (9, 60, 200, 450, 700, 1100, 1500, 1900)}
FAMILY_NEW = 48
# the families' engine runs at full width, their depth cut to this many
# layers (the run's time limit holds the mesh phase too); the kernels
# phase keeps every family's registered shapes
FAMILY_LAYERS = 8
# one decode step of a family at full width on random int8 weights,
# kernels vs plain versions: each layer's attention held to the ulp rule in
# the step itself; the logits carry those one-rounding differences through
# 16 to 32 layers of random weights, as Mistral's do (MISTRAL_LOGIT_TOL)
FAMILY_LOGIT_TOL = MISTRAL_LOGIT_TOL


def _family_cfg(fam, layers=None):
    """A family's registered config; ``layers``: its depth cut to that."""
    from aws_k8s_ansible_provisioner_tpu_torch.config import (GEMMA_2B,
                                                              LLAMA_3_2_1B,
                                                              OPT_1_3B,
                                                              PHI_2)

    cfg = {"llama": LLAMA_3_2_1B, "gemma": GEMMA_2B, "phi": PHI_2,
           "opt": OPT_1_3B}[fam]
    return cfg if layers is None else cfg.scaled(
        num_layers=min(layers, cfg.num_layers))


def _family_label(cfg):
    return (f"D {cfg.head_dim}, Hq {cfg.num_heads}, Hkv "
            f"{cfg.num_kv_heads}, RoPE over {cfg.rotary_dim}")


def phase_kernels_families(torch, np):
    """Each kernel of the families' paths against its plain version at
    their shapes (Hq, Hkv, D and rotary width of Llama-3.2-1B, gemma-2b,
    phi-2 and opt-1.3b; page 64; 8 rows of up to 2048 columns; 2 layers,
    the cut: a kernel reads one layer), over a bf16 and an int8 pool: the
    fused q/k prologue and row write at the decode rows (RoPE over D, 32 of
    80 columns or none; no q/k norm), K1 over the decode rows, K1's ragged
    entry over them beside a 256-row chunk of one slot (the chunk body: its
    D 256 instance for gemma), K1-spec over 8 x SPEC_R rows; then over a
    dense bf16 and int8 cache [2, 8, Hkv, 2048, D]: the fused dense write,
    K4, K5 (4 slots per CTA) and K7. Each timed beside its plain version,
    a library call and the bound."""
    out = {}
    for i, fam in enumerate(FAMILIES):
        cfg = _family_cfg(fam)
        L, Hq, Hkv, D, rot = 2, cfg.num_heads, cfg.num_kv_heads, \
            cfg.head_dim, cfg.rotary_dim
        ps, B, S = 64, 8, 2048
        max_pages = S // ps
        P = B * max_pages + 1
        layer = L - 1
        gen = torch.Generator(device="cuda")
        gen.manual_seed(90 + i)
        rng = np.random.default_rng(95 + i)
        table = (rng.permutation(B * max_pages) + 1).reshape(B, max_pages)
        lengths = rng.integers(1, S + 1, B)
        lengths[:4] = [1, 64, 65, S]
        pslot, pstart, C = 3, 512, 256
        limits = np.concatenate([lengths, pstart + np.arange(C) + 1])
        limits[pslot] = 0
        tables = np.concatenate([table, np.repeat(table[pslot][None], C, 0)])
        spec_len = np.minimum(lengths, S - SPEC_R)
        spec_len[:2] = [0, 59]
        label = f"{fam} ({_family_label(cfg)})"
        res = out[fam] = {}
        for name in ("bf16", "int8"):
            pools = _make_pools(torch, gen, (L, P, Hkv, ps, D),
                                name == "int8")
            res[name] = {
                "prep": _prep_case(torch, np, pools, lengths - 1, table,
                                   lengths - 1, layer,
                                   f"{label}, decode {B} rows", Hq,
                                   cfg.rope_theta, cfg.qk_norm, rot=rot,
                                   cfg=cfg),
                "attention": _attention_case(torch, np, pools, lengths,
                                             table, layer,
                                             f"{label}, decode {B} rows", Hq),
                "attention_ragged": _attention_case(
                    torch, np, pools, limits, tables, layer,
                    f"{label}, ragged {B}+{C}", Hq, chunk_start=B),
                "spec": _spec_case(torch, np, pools, spec_len, table, layer,
                                   f"{label}, verify {B} x {SPEC_R} rows",
                                   Hq)}
            if D > 128:
                # the route the chunk rows took before the D 256 instance:
                # the per-row body over every row of the same call
                per_row = _attention_case(
                    torch, np, pools, limits, tables, layer,
                    f"{label}, ragged {B}+{C}, every row per-row", Hq)
                chunked = res[name]["attention_ragged"]
                log(f"[kernels] {fam} {name} ragged {B}+{C}: chunk body "
                    f"{chunked['ms']:.4f} ms (device "
                    f"{chunked['device_ms']:.4f}), per-row body "
                    f"{per_row['ms']:.4f} ms (device "
                    f"{per_row['device_ms']:.4f}): "
                    f"{per_row['device_ms'] / chunked['device_ms']:.2f}x")
                res[name]["per_row_ms"] = per_row["ms"]
                res[name]["per_row_device_ms"] = per_row["device_ms"]
            del pools
            torch.cuda.empty_cache()
        dense_len = lengths.copy()
        dense_len[0] = 0
        for name in ("bf16", "int8"):
            cache = _dense_cache(torch, gen, (L, B, Hkv, S, D),
                                 name == "int8")
            res["dense" if name == "bf16" else "dense int8"] = {
                "prep": _prep_case(
                    torch, np, cache, dense_len[:, None] - 1, None,
                    np.maximum(dense_len[:, None] - 1, 0), layer,
                    f"{label}, decode {B} slots", Hq, cfg.rope_theta,
                    cfg.qk_norm, rot=rot, cfg=cfg),
                "attention": _dense_attention_case(
                    torch, np, cache, dense_len, layer, 1,
                    f"{label}, decode {B} slots", Hq),
                "bblock": _dense_attention_case(
                    torch, np, cache, dense_len, layer, 1,
                    f"{label}, decode {B} slots, 4 per CTA", Hq, bb=4),
                "spec": _dense_attention_case(
                    torch, np, cache, spec_len, layer, SPEC_R,
                    f"{label}, verify {B} x {SPEC_R} rows", Hq)}
            del cache
            torch.cuda.empty_cache()
    return out


def _family_params(torch, cfg, repeating=False):
    """Seeded random weights of ``cfg`` at full width in the published
    shapes (biases, learned positions and all), drawn layer by layer in
    bf16 and quantized to int8 (the serving default). ``repeating``: the
    embedding times REPEAT_EMBED_SCALE (an untied head holding its
    unscaled rows, its bias kept), so that the current token's embedding
    dominates what the head reads and the greedy stream repeats its token
    (prompt lookup then finds n-grams)."""
    from aws_k8s_ansible_provisioner_tpu_torch.models.layers import init_params
    from aws_k8s_ansible_provisioner_tpu_torch.models.quant import \
        quantize_params

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = init_params(cfg, gen, torch.bfloat16)
    if repeating:
        emb = params["embed"]["weight"]
        if not cfg.tie_embeddings:
            params["lm_head"] = {**params["lm_head"],
                                 "kernel": emb.T.contiguous()}
        params["embed"] = {"weight": emb * REPEAT_EMBED_SCALE}
    params = quantize_params(params, cfg)
    torch.cuda.synchronize()
    return params


# a family's runs: (paged, KV dtype, decode_bblock, speculation)
FAMILY_RUNS = {"auto": (True, "auto", 0, None),
               "int8": (True, "int8", 0, None),
               "dense int8": (False, "int8", 4, None),
               "lookup": (True, "auto", 0, "prompt_lookup"),
               "draft": (True, "auto", 0, "draft"),
               "dense draft": (False, "auto", 4, "draft")}
# the runs of each family (its default engine first)
FAMILY_PLAN = {"llama": ("auto", "dense int8", "draft"),
               "gemma": ("auto", "int8", "lookup", "dense draft"),
               "phi": ("auto", "int8", "lookup", "dense draft"),
               "opt": ("auto",)}


def phase_family(torch, np, fam, kind, params):
    """One run of a family at full width and depth on ``params`` (seeded
    random int8 weights, :func:`_family_params`): the default
    ``ServingConfig`` (paged, page 64, bf16 KV, int8 weights, the pipeline
    and the decode graphs on, the prefix cache on) with 8 slots and
    prefill_chunk 256, changed as ``kind`` says (FAMILY_RUNS): int8 KV;
    the dense engine with int8 KV and 4 slots per CTA; prompt lookup; a
    self-draft over its dense cache, beside the paged pool or the dense
    bf16 cache with 4 slots per CTA. The launch counts are zeroed just
    before the run and read just after. Plain runs: 8 greedy requests
    (FAMILY_PROMPTS, FAMILY_NEW new tokens each); once every prompt is in,
    the next decode step's logits are held against the plain versions
    (:func:`_logits_check`, every layer's attention by the ulp rule) and
    one horizon-8 decode dispatch is profiled, both taken out of the run's
    counts; the path's kernels launched (the chunk body among them), the
    fused row write once a layer of every forward, the other pool's and
    the standalone writes never, one graph replay per decode dispatch.
    Speculative runs: prompt lookup on repeated-pattern prompts
    (repeating weights), or a self-draft over two waves (the second
    chunked, so that the draft catches up): verifies and drafts > 0, the
    verify kernel and (draft) the dense K4/K7 launched, the fused writes
    once a layer of every target and draft forward, accepted drafts > 0
    with the self-draft. Returns the run's launches."""
    from aws_k8s_ansible_provisioner_tpu_torch.config import ServingConfig
    from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import (Engine,
                                                                      Request)

    cfg = _family_cfg(fam, FAMILY_LAYERS)
    paged, kv_dtype, bblock, spec = FAMILY_RUNS[kind]
    quant = kv_dtype == "int8"
    serving = ServingConfig(model=cfg.name, max_decode_slots=8,
                            prefill_chunk=256, derived_seed=0,
                            kv_dtype=kv_dtype, paged=paged,
                            decode_bblock=bblock,
                            spec_decode=spec is not None,
                            spec_method=spec or "prompt_lookup")
    t0 = time.monotonic()
    engine = Engine(cfg, params, serving, device="cuda",
                    draft=(cfg, params) if spec == "draft" else None)
    torch.cuda.synchronize()
    tag = f"[{cfg.name} {kind}]"
    log(f"{tag} {cfg.num_layers} layers, hidden {cfg.hidden_size}, MLP "
        f"{cfg.intermediate_size} ({cfg.act}), {_family_label(cfg)}, vocab "
        f"{cfg.vocab_size}, norm {cfg.norm}"
        f"{' zero-centred' if cfg.norm_zero_centered else ''}"
        f"{', parallel block' if cfg.parallel_block else ''}, positions "
        f"{cfg.pos_embed}; int8 weights {_tree_bytes(params) / 1e9:.2f} GB; "
        f"KV {kv_dtype}, 8 slots x {engine.max_len}, {_cache_layout(engine)}"
        f"{f', {spec}' if spec else ''}; {_dispatch_mode(engine)}; "
        f"allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB; set-up "
        f"{time.monotonic() - t0:.1f}s")
    rng = np.random.default_rng(80 + FAMILIES.index(fam))
    engine.submit(Request(prompt_ids=[5, 6, 7, 8, 9, 10, 11, 12],
                          max_tokens=2, ignore_eos=True))
    engine.run_until_idle()
    engine.counts.clear()
    replays0 = engine.decoder.replays
    torch.cuda.synchronize()
    if spec is not None:
        return _family_spec_run(torch, np, engine, tag, rng, spec, quant)
    lens = FAMILY_PROMPTS[fam]
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    _reset_launches()
    t0 = time.monotonic()
    reqs = [engine.submit(Request(prompt_ids=p, max_tokens=FAMILY_NEW,
                                  ignore_eos=True)) for p in prompts]
    while engine.pending or engine._chunk is not None:
        engine.step()
    torch.cuda.synchronize()
    t1 = time.monotonic()
    before, counts0 = _launches(), dict(engine.counts)
    _logits_check(torch, engine, FAMILY_LOGIT_TOL)
    _profile_dispatch(torch, engine, f"[profile {cfg.name} {kind}]")
    checks = _delta(_launches(), before)
    check_counts = {k: v - counts0.get(k, 0)
                    for k, v in engine.counts.items()}
    t2 = time.monotonic()
    engine.run_until_idle()
    torch.cuda.synchronize()
    dt = time.monotonic() - t2 + t1 - t0
    launches = _delta(_launches(), checks)
    run_counts = {k: v - check_counts.get(k, 0)
                  for k, v in engine.counts.items()}
    n_gen = sum(len(r.generated) for r in reqs)
    log(f"{tag} {len(reqs)} requests, prompts {list(lens)}, {FAMILY_NEW} "
        f"new tokens each: {n_gen} tokens in {dt:.2f}s ({n_gen / dt:.1f} "
        f"tok/s end to end, the checks' time taken out); dispatches "
        f"{run_counts}; kernel launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    for r in reqs:
        _finish_ok(cfg, r, FAMILY_NEW)
    _check_replays(tag, engine, replays0)
    if not paged:
        _check_dense_launches(tag, engine, launches, counts=run_counts)
    else:
        attn, write = _kernel_names(quant)
        if min(launches[attn], launches[write],
               launches[attn + " chunk"]) <= 0:
            raise AssertionError(f"{tag} a kernel of the path never "
                                 f"launched (K1, its chunk body, the fused "
                                 f"write): {launches}")
        if max(launches[k] for k in _kernel_names(not quant)
               + STANDALONE_WRITES) != 0:
            raise AssertionError(f"{tag} the other pool's kernels or a "
                                 f"standalone row write launched: "
                                 f"{launches}")
        _check_fused_writes(tag, engine, launches, run_counts)
    del engine
    return launches


def _family_spec_run(torch, np, engine, tag, rng, spec, quant):
    """The speculative run of :func:`phase_family`: prompt lookup over 4
    repeated-pattern prompts, or a self-draft over 6 requests and then 2
    prompts of 600 tokens walked in chunks beside them."""
    from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import Request

    cfg = engine.cfg
    _reset_launches()
    t0 = time.monotonic()
    if spec == "prompt_lookup":
        waves = [(_pattern_prompts(rng, cfg.vocab_size, 3, reps=40)
                  + _pattern_prompts(rng, cfg.vocab_size, 1), 48)]
    else:
        waves = [([rng.integers(0, cfg.vocab_size, n).tolist()
                   for n in (40, 90, 130, 64, 200, 17)], 48),
                 ([rng.integers(0, cfg.vocab_size, 600).tolist()
                   for _ in range(2)], 24)]
    reqs = []
    for i, (prompts, new) in enumerate(waves):
        reqs += [(engine.submit(Request(prompt_ids=p, max_tokens=new,
                                        ignore_eos=True)), new)
                 for p in prompts]
        if i + 1 < len(waves):
            while engine.pending:
                engine.step()
            engine.step()
    engine.run_until_idle()
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    launches = _launches()
    counts = dict(engine.counts)
    for r, new in reqs:
        _finish_ok(cfg, r, new)
    n_gen = sum(new for _, new in reqs)
    drafted = counts.get("spec_drafted_tokens", 0)
    accepted = counts.get("spec_accepted_tokens", 0)
    log(f"{tag} {len(reqs)} greedy requests: {n_gen} tokens in {dt:.2f}s "
        f"({n_gen / dt:.1f} tok/s end to end with the prefill); dispatches "
        f"{counts}; acceptance {accepted}/{drafted} = "
        f"{accepted / max(drafted, 1):.3f}; kernel launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    if counts.get("spec_dispatches", 0) <= 0 or drafted <= 0:
        raise AssertionError(f"{tag} no verify dispatch or no draft: {counts}")
    if engine.paged:
        verify = "paged_attention_spec" + ("_quant" if quant else "")
        if launches[verify] <= 0:
            raise AssertionError(f"{tag} the verify kernel never launched: "
                                 f"{launches}")
        if spec == "draft":
            _check_draft_writes(tag, engine, launches, counts)
        else:
            _check_fused_writes(tag, engine, launches, counts)
    else:
        # the dense target (K5 decode, K7 verify) and the draft (K4
        # rollout, K7 catch-up) write every forward's rows through the
        # fused dense write
        L = cfg.num_layers
        forwards = (_dense_forwards(counts)
                    + counts.get("draft_rollout_substeps", 0)
                    + counts.get("draft_catch_ups", 0))
        _check_fused_dense(tag, L, launches, forwards,
                           "target and draft forwards")
        mine = (_dense_name("decode_attend_dense", quant,
                            engine.decode_bblock),
                _dense_name("spec_attend_dense", quant),
                "decode_attend_dense", "spec_attend_dense")
        if min(launches[k] for k in mine) <= 0:
            raise AssertionError(f"{tag} a kernel of the path never launched "
                                 f"({mine}): {launches}")
        if max(launches[k] for k in PAGED_KERNELS) != 0:
            raise AssertionError(f"{tag} the dense engine launched a paged "
                                 f"kernel: {launches}")
    if spec == "draft" and accepted <= 0:
        raise AssertionError(f"{tag} no draft token accepted: {counts}")
    if spec == "draft" and min(launches[k] for k in (
            "decode_attend_dense", "spec_attend_dense",
            "prep_write_rows_dense")) <= 0:
        raise AssertionError(f"{tag} a dense kernel of the draft never "
                             f"launched (K4/K7/K8): {launches}")
    del engine
    return launches


def phase_families(torch, np):
    """Every family's runs (FAMILY_PLAN), each family's weights drawn once
    (and once more, repeating, for its prompt-lookup run). Returns
    {"<family> <run>": launches}."""
    runs = {}
    for fam in FAMILIES:
        cfg = _family_cfg(fam, FAMILY_LAYERS)
        t0 = time.monotonic()
        params = _family_params(torch, cfg)
        log(f"[{cfg.name}] weights drawn and quantized in "
            f"{time.monotonic() - t0:.1f}s")
        for kind in FAMILY_PLAN[fam]:
            t1 = time.monotonic()
            if kind == "lookup":
                del params
                _free(torch)
                params = _family_params(torch, cfg, repeating=True)
            runs[f"{fam} {kind}"] = phase_family(torch, np, fam, kind, params)
            _free(torch)
            log(f"[wall] {fam} {kind}: {time.monotonic() - t1:.1f}s")
            if kind == "lookup":
                del params
                _free(torch)
                params = _family_params(torch, cfg)
        del params
        _free(torch)
    return runs


def _family_kernel_rows(fk):
    """The kernels line's rows of the families' instances: (name, source,
    TPU line, result, run, launch-count key)."""
    rows = []
    for fam in FAMILIES:
        f = fk[fam]
        # the fused write of every family's decode rows: RoPE over all of
        # D 64 (Llama), 32 of 80 columns (Phi), none (OPT), D 256 (Gemma)
        rows.append((f"prep_write_rows_paged {fam}", WRITE_SRC, 1243,
                     f["bf16"]["prep"], f"{fam} auto",
                     "prep_write_rows_paged"))
        rows.append((f"paged_attention {fam}", ATTN_SRC, 1080,
                     f["bf16"]["attention"], f"{fam} auto",
                     "paged_attention"))
        rows.append((f"paged_attention chunk {fam}", CHUNK_SRC, 1120,
                     f["bf16"]["attention_ragged"], f"{fam} auto",
                     "paged_attention chunk"))
        plan = FAMILY_PLAN[fam]
        if "int8" in plan:
            rows += [(f"prep_write_rows_quant_paged {fam}", WRITE_SRC, 1313,
                      f["int8"]["prep"], f"{fam} int8",
                      "prep_write_rows_quant_paged"),
                     (f"paged_attention_quant {fam}", ATTN_SRC, 1014,
                      f["int8"]["attention"], f"{fam} int8",
                      "paged_attention_quant"),
                     (f"paged_attention_quant chunk {fam}", CHUNK_SRC, 1120,
                      f["int8"]["attention_ragged"], f"{fam} int8",
                      "paged_attention_quant chunk")]
        spec_run = next((k for k in ("lookup", "draft") if k in plan), None)
        if spec_run:
            rows.append((f"paged_attention_spec {fam}", ATTN_SRC, 1169,
                         f["bf16"]["spec"], f"{fam} {spec_run}",
                         "paged_attention_spec"))
        if "dense int8" in plan:
            rows += [(f"prep_write_rows_quant_dense {fam}", WRITE_SRC, 823,
                      f["dense int8"]["prep"], f"{fam} dense int8",
                      "prep_write_rows_quant_dense"),
                     (f"decode_attend_dense quant bblock {fam}", DENSE_SRC,
                      499, f["dense int8"]["bblock"], f"{fam} dense int8",
                      "decode_attend_dense quant bblock")]
        draft_run = next((k for k in ("dense draft", "draft") if k in plan),
                         None)
        if draft_run:
            rows += [(f"prep_write_rows_dense {fam}", WRITE_SRC, 744,
                      f["dense"]["prep"], f"{fam} {draft_run}",
                      "prep_write_rows_dense"),
                     (f"decode_attend_dense {fam}", DENSE_SRC, 516,
                      f["dense"]["attention"], f"{fam} {draft_run}",
                      "decode_attend_dense"),
                     (f"spec_attend_dense {fam}", DENSE_SRC, 675,
                      f["dense"]["spec"], f"{fam} {draft_run}",
                      "spec_attend_dense")]
        if draft_run == "dense draft":
            rows.append((f"decode_attend_dense bblock {fam}", DENSE_SRC, 499,
                         f["dense"]["bblock"], f"{fam} dense draft",
                         "decode_attend_dense bblock"))
    return rows


# -- Qwen3-30B-A3B (MoE): the route-and-sort and grouped expert kernels --------

MOE_ROUTE_SRC = "aws_k8s_ansible_provisioner_tpu_torch/csrc/moe_route.cu"
MOE_GROUPED_SRC = "aws_k8s_ansible_provisioner_tpu_torch/csrc/moe_grouped.cu"
# the XLA regions of the JAX package the two kernels replace (MoE has no
# pallas_call): route and the sort of moe_mlp_ragged; _expert_ffn_ragged's
# ragged_dot products
MOE_ROUTE_JAX = ("none (XLA: aws_k8s_ansible_provisioner_tpu/ops/moe.py:35 "
                 "route, :80-84 the sort)")
MOE_GROUPED_JAX = ("none (XLA: aws_k8s_ansible_provisioner_tpu/ops/moe.py:48 "
                   "_expert_ffn_ragged, ragged_dot)")
# (case, tokens): decode horizons of 8 and 32 slots, a verify of 32 x 5, a
# mixed dispatch of 32 + 512 rows, every token on the same 8 experts, only
# even experts live, router ties, a batch prefill of prompts that sum to
# 2048 tokens (16,384 sorted rows, ~128 an expert)
MOE_CASES = (("decode 8", 8), ("decode 32", 32), ("verify 32x5", 160),
             ("mixed 32+512", 544), ("skewed", 64), ("empty experts", 24),
             ("ties", 40), ("prefill 2048", 2048))
MOE_PROMPTS = (9, 40, 120, 256, 300, 450, 600, 700)
MOE_NEW = 48
# one decode step through the kernels vs the plain versions over 48 layers
# of random weights: each layer's attention by the ulp rule, the logits as
# the other families' (a router whose input moved by an ulp may pick
# another expert of a near tie)
MOE_LOGIT_TOL = MISTRAL_LOGIT_TOL
# the seeded int8 tree's peak device memory (bytes) before the engine
MOE_PEAK_LIMIT = 35e9
# the bf16-weight run (the bf16 instances of the grouped kernel): full
# width, depth cut to 4 layers (its bf16 tree at 48 would be 61 GB)
MOE_BF16_LAYERS = 4


def _moe_cfg(layers=None):
    from aws_k8s_ansible_provisioner_tpu_torch.config import QWEN3_30B_A3B

    if layers is None:
        return QWEN3_30B_A3B
    return QWEN3_30B_A3B.scaled(num_layers=layers)


def _moe_logits(torch, np, case, n, seed, E, k):
    """float32 router logits [n, E] of a case, on the card."""
    rng = np.random.default_rng(seed)
    logits = 2.0 * rng.standard_normal((n, E))
    if case == "skewed":
        logits[:, :k] += 50.0
    elif case == "empty experts":
        logits[:, 1::2] = -1e4
    elif case == "ties":
        logits[:, 0] += 12.0
        for e in (1, 5, 9, 64):
            logits[:, e] = logits[:, 0]
    return torch.from_numpy(logits.astype(np.float32)).cuda()


def _moe_plain_ragged(moe):
    """The exact MoE MLP through the plain versions (the route and the
    sort, the per-expert loops): what the logits check holds the kernels'
    forward against."""
    def ragged(cfg, x, p):
        r = moe.route_sort_plain(moe.router_logits(x, p["router"]["kernel"]),
                                 cfg.num_experts_per_tok, cfg.norm_topk_prob,
                                 x.dtype)
        a = moe.grouped_gate_up_plain(x, p["w_gate"], p["w_up"], r.offsets,
                                      r.row_token)
        ys = moe.grouped_matmul_plain(a, p["w_down"], r.offsets)
        return moe.combine(ys, r.weights, r.pos, x.dtype)
    return ragged


def _grouped_library(torch, xs, w, offsets):
    """The yardstick of a grouped product over sorted rows ``xs`` and bf16
    weights ``w`` [E, K, N]: one ``torch._grouped_mm`` call where the
    card's torch has it, else a per-expert ``torch.matmul`` loop (the
    offsets read on the host first). Returns (fn, its name)."""
    ends = offsets[1:].contiguous()
    if hasattr(torch, "_grouped_mm"):
        for layout, wt in (("row-major", w),
                           ("column-major",
                            w.transpose(-2, -1).contiguous().transpose(-2,
                                                                       -1))):
            try:
                torch._grouped_mm(xs, wt, offs=ends)
                torch.cuda.synchronize()
                return (lambda: torch._grouped_mm(xs, wt, offs=ends),
                        f"torch._grouped_mm ({layout} weights)")
            except (RuntimeError, TypeError, ValueError) as e:
                log(f"[kernels, moe] torch._grouped_mm refused {layout} "
                    f"weights: {str(e).splitlines()[0][:120]}")
    off = offsets.tolist()
    out = xs.new_empty((xs.shape[0], w.shape[-1]))

    def loop():
        for e in range(w.shape[0]):
            if off[e + 1] > off[e]:
                torch.matmul(xs[off[e]:off[e + 1]], w[e],
                             out=out[off[e]:off[e + 1]])
        return out
    return loop, "per-expert torch.matmul loop"


def _moe_result(torch, what, check, ms, dev_ms, plain_ms, library_ms,
                nbytes, ops, extra=""):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_BF16_OPS_PER_S
    res = {**check, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": 1e3 * max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes}
    lib = "null" if library_ms is None else f"{library_ms:.4f}"
    log(f"[kernels, moe] {what}: max abs {check['max_abs_err']:.3e}, mean "
        f"abs {check['mean_abs_err']:.3e}{extra}; kernel_ms {ms:.4f} "
        f"device_ms {dev_ms:.4f} plain_ms {plain_ms:.4f} library_ms {lib} "
        f"bound_ms {res['bound_ms']:.4f} ({nbytes / 1e6:.1f} MB, "
        f"{ops / 1e9:.2f} GFLOP, {100 * res['bound_ms'] / dev_ms:.1f}% of "
        f"bound)")
    return res


def phase_kernels_moe(torch, np):
    """Both MoE kernels against their plain versions at Qwen3-30B-A3B's
    widths (H 2048, expert width 768, 128 experts, top 8), over one
    layer's experts in bf16 and int8 (per-(expert, column) scales), at
    MOE_CASES: the route-and-sort (experts, offsets, sorted rows and
    positions exact; weights within one bf16 ulp), the grouped gate + up
    (silu(g) * u) and down products (each row within one bf16 ulp of its
    largest value), each timed (kernel and device ms) beside its plain
    version, its bound (the touched experts' weights read once, the rows
    and outputs once; 2 x rows x K x N operations) and the library
    yardstick on bf16 weights (``_grouped_library``; the route has none).
    Returns {instance: {case: result}}."""
    from aws_k8s_ansible_provisioner_tpu_torch.models.quant import \
        quant_kernel_chunked
    from aws_k8s_ansible_provisioner_tpu_torch.ops import moe

    cfg = _moe_cfg()
    H, I, E, k = (cfg.hidden_size, cfg.moe_intermediate_size,
                  cfg.num_experts, cfg.num_experts_per_tok)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(200)
    layer = {"bf16": {}, "int8": {}}
    for name, shape in (("w_gate", (E, H, I)), ("w_up", (E, H, I)),
                        ("w_down", (E, I, H))):
        w = (0.02 * torch.randn(shape, generator=gen, device="cuda")
             ).bfloat16()
        layer["bf16"][name] = {"kernel": w}
        q, s = quant_kernel_chunked(w, 1)
        layer["int8"][name] = {"kernel": q, "scale": s}
    out = {name: {} for name in ("moe_route_sort", "moe_gate_up",
                                 "moe_gate_up quant", "moe_grouped",
                                 "moe_grouped quant")}
    for i, (case, n) in enumerate(MOE_CASES):
        logits = _moe_logits(torch, np, case, n, 210 + i, E, k)
        r = moe.route_sort(logits, k, True, torch.bfloat16)
        ref = moe.route_sort_plain(logits, k, True, torch.bfloat16)
        torch.cuda.synchronize()
        for name in ("experts", "offsets", "row_token", "row_expert", "pos"):
            if not torch.equal(getattr(r, name), getattr(ref, name)):
                raise AssertionError(f"[kernels, moe] {case}: route-and-sort "
                                     f"{name} differs from the plain sort")
        werr = (r.weights.float() - ref.weights.float()).abs()
        if float(werr.max()) > 2.0 ** -8:
            raise AssertionError(f"[kernels, moe] {case}: weights differ by "
                                 f"{float(werr.max())} (> one bf16 ulp)")
        counts = (r.offsets[1:] - r.offsets[:-1]).cpu()
        touched = int((counts > 0).sum())
        m = n * k
        if case == "ties" and not bool((r.experts[:, :5] == torch.tensor(
                [0, 1, 5, 9, 64], device="cuda")).all()):
            raise AssertionError("[kernels, moe] ties: not in expert order")
        if case == "empty experts" and int(counts[1::2].sum()) != 0:
            raise AssertionError("[kernels, moe] an odd expert got rows")
        route_bytes = n * E * 4 + m * (2 + 4 + 4 + 4 + 4) + (E + 1) * 4
        out["moe_route_sort"][case] = _moe_result(
            torch, f"route-and-sort, {case} ({n} tokens, {touched} of {E} "
            f"experts touched)",
            {"max_abs_err": float(werr.max()),
             "mean_abs_err": float(werr.mean())},
            timed_ms(torch, lambda: moe.route_sort(logits, k, True,
                                                   torch.bfloat16)),
            device_ms(torch, lambda: moe.route_sort(logits, k, True,
                                                    torch.bfloat16)),
            timed_ms(torch, lambda: moe.route_sort_plain(
                logits, k, True, torch.bfloat16), iters=5, warmup=1),
            None, route_bytes, 0)
        x = torch.randn((n, H), generator=gen, device="cuda").bfloat16()
        xs = x.index_select(0, r.row_token)
        for quant in (False, True):
            p = layer["int8" if quant else "bf16"]
            wb = 1 if quant else 2
            sfx = " quant" if quant else ""
            a = moe.grouped_gate_up(x, p["w_gate"], p["w_up"], r.offsets,
                                    r.row_token)
            a_ref = moe.grouped_gate_up_plain(x, p["w_gate"], p["w_up"],
                                              r.offsets, r.row_token)
            y = moe.grouped_matmul(a_ref, p["w_down"], r.offsets)
            y_ref = moe.grouped_matmul_plain(a_ref, p["w_down"], r.offsets)
            torch.cuda.synchronize()
            label = (f"{'int8' if quant else 'bf16'} experts, {case} ({m} "
                     f"rows, {touched} experts)")
            for inst, got, want, width, kin, nw, fn, plain, lib in (
                    ("moe_gate_up", a, a_ref, I, H, 2,
                     lambda: moe.grouped_gate_up(x, p["w_gate"], p["w_up"],
                                                 r.offsets, r.row_token),
                     lambda: moe.grouped_gate_up_plain(
                         x, p["w_gate"], p["w_up"], r.offsets, r.row_token),
                     (xs, torch.cat([layer["bf16"]["w_gate"]["kernel"],
                                     layer["bf16"]["w_up"]["kernel"]], -1))),
                    ("moe_grouped", y, y_ref, H, I, 1,
                     lambda: moe.grouped_matmul(a_ref, p["w_down"],
                                                r.offsets),
                     lambda: moe.grouped_matmul_plain(a_ref, p["w_down"],
                                                      r.offsets),
                     (a_ref, layer["bf16"]["w_down"]["kernel"]))):
                check = _ulp_rows(torch, f"{inst}{sfx} {label}", got, want,
                                  m, lambda bad: f"case {case}",
                                  max_ulps=1.0)
                check["differ"] = int((got != want).sum())
                lib_fn, lib_name = _grouped_library(torch, lib[0], lib[1],
                                                    r.offsets)
                nbytes = (touched * kin * width * wb * nw
                          + (touched * width * 4 * nw if quant else 0)
                          + (n * H * 2 if inst == "moe_gate_up"
                             else m * I * 2)
                          + m * 4 + (E + 1) * 4 + m * width * 2)
                res = _moe_result(
                    torch, f"{inst}{sfx}, {label}", check,
                    timed_ms(torch, fn), device_ms(torch, fn),
                    timed_ms(torch, plain, iters=5, warmup=1),
                    device_ms(torch, lib_fn), nbytes,
                    2.0 * m * kin * width * nw,
                    extra=f", worst row {check['worst_row_max_ulps']:.2f} "
                          f"ulp, {check['differ']} of {got.numel()} outputs "
                          f"differ from plain; library: {lib_name}")
                out[inst + sfx][case] = res
            del a, a_ref, y, y_ref
        torch.cuda.empty_cache()
    del layer
    torch.cuda.empty_cache()
    return out


def _moe_copy_check(torch, engine, tag):
    """One eager decode forward of the engine's slots under torch.profiler
    with the ops' input shapes: no copy or dtype cast takes an expert
    stack [E, H, I] / [E, I, H] (the experts are read in place, int8 as
    int8). Returns the number of copy and cast ops seen."""
    from torch.profiler import ProfilerActivity, profile

    cfg = engine.cfg
    E, H, I = cfg.num_experts, cfg.hidden_size, cfg.moe_intermediate_size
    stacks = ([E, H, I], [E, I, H])
    tok = torch.zeros((engine.num_slots, 1), dtype=torch.int32,
                      device="cuda")
    pos = torch.zeros_like(tok)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        engine.model(tok, pos)
        torch.cuda.synchronize()
    casts = [e for e in prof.key_averages(group_by_input_shape=True)
             if e.key in ("aten::to", "aten::_to_copy", "aten::copy_",
                          "aten::type_as")]
    bad = [(e.key, e.input_shapes) for e in casts
           if any(list(s) in stacks for s in e.input_shapes)]
    n = sum(e.count for e in casts)
    if bad:
        raise AssertionError(f"{tag} a copy or cast of an expert stack: "
                             f"{bad[:4]}")
    log(f"{tag} eager decode forward profiled with shapes: {n} copy/cast "
        f"ops, none of an expert stack {stacks} (the experts are read in "
        f"place by the grouped kernel)")
    return n


def _moe_engine(torch, cfg, params, **kw):
    from aws_k8s_ansible_provisioner_tpu_torch.config import ServingConfig
    from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import Engine

    serving = ServingConfig(model=cfg.name, max_decode_slots=8,
                            prefill_chunk=256, derived_seed=0, **kw)
    t0 = time.monotonic()
    engine = Engine(cfg, params, serving, device="cuda")
    torch.cuda.synchronize()
    log(f"[{cfg.name}] {cfg.num_layers} layers, hidden {cfg.hidden_size}, "
        f"{cfg.num_experts} experts of width {cfg.moe_intermediate_size}, "
        f"top {cfg.num_experts_per_tok}, Hq {cfg.num_heads}, Hkv "
        f"{cfg.num_kv_heads}, D {cfg.head_dim}, vocab {cfg.vocab_size}; "
        f"weights {serving.weights_dtype} {_tree_bytes(params) / 1e9:.2f} "
        f"GB; KV {serving.kv_dtype}, {_cache_layout(engine)}"
        f"{', ' + serving.spec_method if serving.spec_decode else ''}; "
        f"{_dispatch_mode(engine)}; allocated "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB; set-up "
        f"{time.monotonic() - t0:.1f}s")
    return engine


def _check_moe_launches(tag, cfg, launches, forwards, quant):
    """The route-and-sort, the gate + up and the down launched once a
    layer of every forward of the run (``forwards``: at least the decode
    substeps, mixed dispatches and verifies), each in the weights' dtype's
    instance, the other dtype's never."""
    sfx = " quant" if quant else ""
    route = launches["moe_route_sort"]
    mine = (launches["moe_gate_up" + sfx], launches["moe_grouped" + sfx])
    other = " quant" if not quant else ""
    theirs = (launches["moe_gate_up" + other], launches["moe_grouped" + other])
    if not (route > 0 and mine == (route, route) and theirs == (0, 0)
            and route >= cfg.num_layers * forwards > 0):
        raise AssertionError(f"{tag} MoE launches: route {route}, gate + up "
                             f"and down {mine}, the other instances "
                             f"{theirs}; {cfg.num_layers} layers x "
                             f"{forwards} forwards")
    log(f"{tag} MoE kernels: route-and-sort {route}, grouped gate + up{sfx} "
        f"{mine[0]}, down{sfx} {mine[1]} launches (>= {cfg.num_layers} "
        f"layers x {forwards} decode, mixed and verify forwards; the rest "
        f"prefills)")


def phase_moe(torch, np):
    """Qwen3-30B-A3B at full width and depth (48 layers) on seeded random
    weights drawn and quantized to int8 layer by layer
    (``init_params(quantize=True)``; the peak device memory before the
    engine printed and held under MOE_PEAK_LIMIT), served by the default
    ServingConfig (paged, page 64, bf16 KV, the pipeline and the decode
    graphs on, the prefix cache on) with 8 slots and prefill_chunk 256: 8
    greedy requests (MOE_PROMPTS, MOE_NEW new tokens each) with the launch
    counts zeroed just before and read just after; once every prompt is
    in, the next decode step's logits through the kernels held against the
    plain versions (the attention's and the MoE MLP's), one horizon-8
    dispatch profiled (the grouped kernel's share of device time) and one
    eager forward profiled with shapes (no copy of an expert stack), all
    taken out of the run's counts. Then, the first engine's pool freed,
    prompt lookup over the same weights (verify rows through the MoE
    kernels); then the bf16 instances at full width, 4 layers, bf16
    weights. Returns ({run: launches}, profile stats)."""
    from aws_k8s_ansible_provisioner_tpu_torch.models.layers import init_params
    from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import Request

    cfg = _moe_cfg()
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = init_params(cfg, gen, torch.bfloat16, quantize=True)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    log(f"[{cfg.name}] seeded weights drawn and quantized to int8 layer by "
        f"layer in {time.monotonic() - t0:.1f}s: {_tree_bytes(params) / 1e9:.2f} "
        f"GB; peak device memory {peak / 1e9:.2f} GB before the engine "
        f"(limit {MOE_PEAK_LIMIT / 1e9:.0f} GB)")
    if peak >= MOE_PEAK_LIMIT:
        raise AssertionError(f"seeded int8 weights peaked at {peak} bytes")
    runs, stats = {}, {}
    engine = _moe_engine(torch, cfg, params)
    tag = f"[{cfg.name}]"
    rng = np.random.default_rng(77)
    engine.submit(Request(prompt_ids=[5, 6, 7, 8, 9, 10, 11, 12],
                          max_tokens=2, ignore_eos=True))
    engine.run_until_idle()
    engine.counts.clear()
    replays0 = engine.decoder.replays
    torch.cuda.synchronize()
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in MOE_PROMPTS]
    _reset_launches()
    t0 = time.monotonic()
    reqs = [engine.submit(Request(prompt_ids=p, max_tokens=MOE_NEW,
                                  ignore_eos=True)) for p in prompts]
    while engine.pending or engine._chunk is not None:
        engine.step()
    torch.cuda.synchronize()
    t1 = time.monotonic()
    before, counts0 = _launches(), dict(engine.counts)
    _logits_check(torch, engine, MOE_LOGIT_TOL)
    _profile_dispatch(torch, engine, f"[profile {cfg.name}]", stats=stats)
    _moe_copy_check(torch, engine, tag)
    checks = _delta(_launches(), before)
    check_counts = {k: v - counts0.get(k, 0)
                    for k, v in engine.counts.items()}
    t2 = time.monotonic()
    engine.run_until_idle()
    torch.cuda.synchronize()
    dt = time.monotonic() - t2 + t1 - t0
    launches = _delta(_launches(), checks)
    counts = {k: v - check_counts.get(k, 0) for k, v in engine.counts.items()}
    n_gen = sum(len(r.generated) for r in reqs)
    log(f"{tag} {len(reqs)} requests, prompts {list(MOE_PROMPTS)}, "
        f"{MOE_NEW} new tokens each: {n_gen} tokens in {dt:.2f}s "
        f"({n_gen / dt:.1f} tok/s end to end, the checks' time taken out); "
        f"dispatches {counts}; kernel launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    for r in reqs:
        _finish_ok(cfg, r, MOE_NEW)
    _check_replays(tag, engine, replays0)
    attn, write = _kernel_names(False)
    if min(launches[attn], launches[write], launches[attn + " chunk"]) <= 0:
        raise AssertionError(f"{tag} an attention kernel of the path never "
                             f"launched: {launches}")
    _check_fused_writes(tag, engine, launches, counts)
    forwards = sum(counts.get(k, 0) for k in (
        "decode_substeps", "mixed_dispatches", "spec_dispatches"))
    _check_moe_launches(tag, cfg, launches, forwards, quant=True)
    busy = stats.get("by_kernel")
    if busy:
        grouped = sum(t for key, (t, _) in busy.items()
                      if "grouped_kernel" in key)
        route = sum(t for key, (t, _) in busy.items() if "route_" in key)
        total = sum(t for t, _ in busy.values())
        stats.update(grouped_share=grouped / total, route_share=route / total)
        log(f"[profile {cfg.name}] the grouped kernel {100 * grouped / total:.1f}"
            f"% of device time ({grouped / 1e3:.3f} ms), the route-and-sort "
            f"{100 * route / total:.1f}% ({route / 1e3:.3f} ms)")
    runs["moe"] = launches
    del engine
    _free(torch)
    # prompt lookup over the same weights: verify rows through the kernels
    engine = _moe_engine(torch, cfg, params, spec_decode=True,
                         spec_method="prompt_lookup")
    tag = f"[{cfg.name} lookup]"
    prompts = _pattern_prompts(rng, cfg.vocab_size, 4)
    _reset_launches()
    t0 = time.monotonic()
    reqs = [engine.submit(Request(prompt_ids=p, max_tokens=32,
                                  ignore_eos=True)) for p in prompts]
    engine.run_until_idle()
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    launches, counts = _launches(), dict(engine.counts)
    for r in reqs:
        _finish_ok(cfg, r, 32)
    log(f"{tag} {len(reqs)} greedy requests on repeated-pattern prompts: "
        f"{32 * len(reqs)} tokens in {dt:.2f}s; dispatches {counts}; "
        f"acceptance {counts.get('spec_accepted_tokens', 0)}/"
        f"{counts.get('spec_drafted_tokens', 0)}")
    if counts.get("spec_dispatches", 0) <= 0 or \
            launches["paged_attention_spec"] <= 0:
        raise AssertionError(f"{tag} no verify dispatch through K1-spec: "
                             f"{counts} {launches}")
    _check_fused_writes(tag, engine, launches, counts)
    forwards = sum(counts.get(k, 0) for k in (
        "decode_substeps", "mixed_dispatches", "spec_dispatches"))
    _check_moe_launches(tag, cfg, launches, forwards, quant=True)
    runs["moe lookup"] = launches
    del engine, params
    _free(torch)
    # the bf16 instances: bf16 weights at full width, depth cut
    cfg4 = _moe_cfg(MOE_BF16_LAYERS)
    gen.manual_seed(1)
    params = init_params(cfg4, gen, torch.bfloat16)
    engine = _moe_engine(torch, cfg4, params, weights_dtype="bf16")
    tag = f"[{cfg.name} bf16, {MOE_BF16_LAYERS} layers]"
    _reset_launches()
    reqs = [engine.submit(Request(prompt_ids=rng.integers(
        0, cfg.vocab_size, n).tolist(), max_tokens=16, ignore_eos=True))
        for n in (9, 120, 300, 40)]
    engine.run_until_idle()
    torch.cuda.synchronize()
    launches, counts = _launches(), dict(engine.counts)
    for r in reqs:
        _finish_ok(cfg4, r, 16)
    forwards = sum(counts.get(k, 0) for k in (
        "decode_substeps", "mixed_dispatches", "spec_dispatches"))
    _check_moe_launches(tag, cfg4, launches, forwards, quant=False)
    runs["moe bf16"] = launches
    del engine, params
    _free(torch)
    return runs, stats


# -- tensor, data and expert parallel serving (the mesh phase) ---------------

MESH_PROMPTS = (9, 40, 120, 256, 300, 450, 600, 700)
MESH_NEW = 24
# the repeated-pattern prompts that prompt lookup drafts from
MESH_PATTERNS = 4
# first-token logits of a meshed engine against the same engine without a
# mesh, same weights: a tp shard rounds its row-parallel partial (wo,
# w_down, each expert's down) to bf16 before the sum, one extra rounding
# of up to 2^-9 of the partial per product; like the kernels' one-ulp
# differences those are carried through the layers of random weights
# (MISTRAL_LOGIT_TOL covers 16 to 48 such layers). A greedy draw can part
# only where the unmeshed top-2 margin is below the tolerance's reach
MESH_LOGIT_TOL = MISTRAL_LOGIT_TOL
MESH_MOE_LAYERS = 4
MESH_MOE_TOKENS = 128


def _mesh_engine(torch, cfg, params, serving, mesh, tag):
    from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import Engine

    t0 = time.monotonic()
    engine = Engine(cfg, params, serving, device="cuda", mesh=mesh)
    torch.cuda.synchronize()
    where = "no mesh" if mesh is None else (
        f"mesh {dict((k, v) for k, v in mesh.shape.items() if v > 1)} over "
        f"{sorted({str(d) for d in mesh.devices.flat})}")
    log(f"{tag} {cfg.name}: {cfg.num_layers} layers, hidden "
        f"{cfg.hidden_size}, Hq {cfg.num_heads}, Hkv {cfg.num_kv_heads}, "
        f"vocab {cfg.vocab_size}; {where}; {engine.num_slots} slots x "
        f"{engine.max_len}, page {serving.page_size}, pool pages a group "
        f"{engine._group_pages}; {_dispatch_mode(engine)}"
        f"{', ' + serving.spec_method if engine.spec_decode else ''}; "
        f"allocated {torch.cuda.memory_allocated() / 1e9:.2f} GB; set-up "
        f"{time.monotonic() - t0:.1f}s")
    return engine


def _first_logits(torch, engine, prompts):
    """Each prompt's last-position logits [n, V] float32 (the logits of
    its first token), one prompt a forward through the engine's model and
    paged prefill callback with OOB tables (its rows drop)."""
    from aws_k8s_ansible_provisioner_tpu_torch.ops.attention import \
        make_prefill_attend_batch_paged_carry
    from aws_k8s_ansible_provisioner_tpu_torch.serving import paged_kv as pkv

    dev, i32 = engine.device, torch.int32
    out = []
    for p in prompts:
        n = len(p)
        attend = make_prefill_attend_batch_paged_carry(
            torch.full((1, engine.pages_per_slot), int(pkv.OOB_PAGE),
                       dtype=i32, device=dev),
            torch.tensor([n], dtype=i32, device=dev),
            engine.cfg.sliding_window, [0])
        logits, _ = engine.model.forward_carry(
            torch.tensor([p], dtype=i32, device=dev),
            torch.arange(n, dtype=i32, device=dev)[None], engine.cache,
            attend)
        out.append(logits[0, n - 1].float())
    torch.cuda.synchronize()
    return torch.stack(out)


def _substep_ms(torch, engine, horizon=8, reps=3):
    """One decode dispatch of ``horizon`` substeps of every slot, eager
    (``programs.decode_steps``) on the engine's state once every prompt is
    in: host-clock ms a substep, the median of ``reps``. Its rows land at
    each slot's length onward, which the engine's next dispatch rewrites
    (pages for them taken first, as that dispatch would)."""
    from aws_k8s_ansible_provisioner_tpu_torch.serving.programs import \
        decode_steps

    engine._settle_inflight()
    engine._ensure_pages(horizon)
    tok, lens, table, top_ks, top_ps, seeds = (engine._dev(a) for a in (
        engine.last_token, engine.lengths, engine.table, engine.top_ks,
        engine.top_ps, engine.seeds))
    temps = torch.zeros_like(top_ps)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        decode_steps(engine.model, horizon, engine.cache, tok, lens, table,
                     temps, top_ks, top_ps, seeds, any_sampled=False)
        torch.cuda.synchronize()
        times.append((time.monotonic() - t0) * 1e3 / horizon)
    return statistics.median(times)


def _mesh_run(torch, engine, prompts, tag, gaps=False, check=None):
    """Greedy requests (MESH_NEW tokens each) through the engine, the
    launch counts zeroed just before and read just after; once every
    prompt is in, one eager decode dispatch is timed (its launches taken
    out of the run's). ``gaps``: every draw's top-2 margin recorded
    (:func:`_recording_gaps`); ``check(engine)`` after every step.
    Returns (requests, launches, counts, ms a substep, gaps). With
    ``gaps`` the engine's decode graphs are dropped first: a replay calls
    no Python ``sample``, so its draws would go unrecorded (the same
    kernels run eagerly)."""
    from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import Request

    if gaps:
        engine.decoder.graphs.clear()
        _free(torch)
    engine.counts.clear()
    torch.cuda.synchronize()
    _reset_launches()
    reqs = [engine.submit(Request(prompt_ids=p, max_tokens=MESH_NEW,
                                  ignore_eos=True)) for p in prompts]
    extra, ms = {}, None

    def step():
        nonlocal extra, ms
        while not engine.idle():
            engine.step()
            if check is not None:
                check(engine)
            if ms is None and not engine.pending and engine._chunk is None \
                    and engine._active_slots():
                before = _launches()
                ms = _substep_ms(torch, engine)
                extra = _delta(_launches(), before)

    t0 = time.monotonic()
    got = _recording_gaps(torch, step) if gaps else step()
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    launches = _delta(_launches(), extra)
    counts = dict(engine.counts)
    for r in reqs:
        _finish_ok(engine.cfg, r, MESH_NEW)
    log(f"{tag} {len(reqs)} requests, prompts {[len(p) for p in prompts]}: "
        f"{sum(len(r.generated) for r in reqs)} tokens in {dt:.2f}s; "
        f"dispatches {counts}; kernel launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    return reqs, launches, counts, ms, got


def _check_mesh_launches(tag, engine, launches, counts):
    """The paged kernels of the engine's pool (bf16 or int8 KV) launched
    once a layer on every (dp group, tp shard) pool for every forward: the
    attention per decode substep and mixed dispatch (a dispatch's decode
    rows reach every group), the verify per verify dispatch, the fused q/k
    prologue + row write per forward of the three; the other pool's
    kernels and the standalone writes never. A MoE config's gshard MLP
    (what a mesh serves) routes through the route-and-sort kernel, once a
    layer of every forward (the prefills' too), and launches no grouped
    expert kernel. The chunk body's launches (``<attention> chunk``) and
    the split-KV combine ride the attention's."""
    attn, write = _kernel_names(engine.serving.kv_dtype == "int8")
    spec = attn.replace("attention", "attention_spec")
    shards = engine.tp * engine.dp
    per = engine.cfg.num_layers * shards
    sub, mixed, ver = (counts.get(k, 0) for k in (
        "decode_substeps", "mixed_dispatches", "spec_dispatches"))
    want = {attn: per * (sub + mixed), write: per * (sub + mixed + ver),
            spec: per * ver}
    allowed = {"split_merge"}
    routed = engine.cfg.num_layers * (sub + mixed + ver)
    if engine.cfg.num_experts > 0:
        allowed.add("moe_route_sort")
    other = {k: v for k, v in launches.items()
             if v and k not in want and k not in allowed
             and not k.startswith(attn + " ")}
    bad = {k: (launches[k], n) for k, n in want.items() if launches[k] != n}
    if engine.cfg.num_experts > 0 and launches["moe_route_sort"] < routed:
        bad["moe_route_sort"] = (launches["moe_route_sort"], f">= {routed}")
    if bad or other or launches[attn] <= 0 or launches[write] <= 0:
        raise AssertionError(f"{tag} launches (got, want) {bad}, unexpected "
                             f"{other}; {counts}")
    log(f"{tag} launches on each of the {shards} (dp group, tp shard) "
        f"pools: {attn} {launches[attn] // shards}, {write} "
        f"{launches[write] // shards}, {spec} {launches[spec] // shards} = "
        f"{engine.cfg.num_layers} layers x ({sub} decode substeps + {mixed} "
        f"mixed dispatches [+ {ver} verifies]); the chunk body "
        f"{launches[attn + ' chunk']}, split_merge "
        f"{launches['split_merge']}; no other kernel")


def _streams_vs_ref(tag, reqs, ref_reqs, gaps, tol):
    """Each greedy stream equals the unmeshed one up to the first draw
    whose unmeshed top-2 margin is below ``tol``; logs the parts."""
    same, parts = 0, []
    for r, ref in zip(reqs, ref_reqs):
        a, b = r.generated, ref.generated
        if a == b:
            same += 1
            continue
        j = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        margins = [gaps.get((ref.eff_seed, len(ref.prompt_ids) + i))
                   for i in range(j + 1)]
        low = [i for i, m in enumerate(margins) if m is not None and m < tol]
        parts.append((len(ref.prompt_ids), j, margins[j], low[:1]))
        if margins[j] is None:
            raise AssertionError(f"{tag} prompt {len(ref.prompt_ids)}: no "
                                 f"unmeshed margin recorded at token {j}")
        if not low:
            raise AssertionError(
                f"{tag} prompt {len(ref.prompt_ids)}: parts at token {j} "
                f"with every unmeshed margin up to it >= {tol}: {margins}")
    log(f"{tag} greedy streams identical to the unmeshed engine's: "
        f"{same}/{len(reqs)}" + "".join(
            f"; prompt {n} parts at token {j} (unmeshed margin there "
            f"{m:.4f}, first below {tol} at {low})"
            for n, j, m, low in parts))


def _logits_vs_ref(torch, tag, got, ref, tol,
                   what="first-token logits of {n} prompts vs the unmeshed "
                        "engine"):
    err = (got - ref).abs().amax(-1)
    agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    log(f"{tag} {what.format(n=len(err))}: max |logit| "
        f"{float(ref.abs().max()):.3f}, max abs diff "
        f"{float(err.max()):.4e} (per prompt "
        f"{[round(float(x), 4) for x in err]}; tol {tol}), argmax agreement "
        f"{agree:.2f}")
    if not (math.isfinite(float(err.max())) and float(err.max()) <= tol):
        raise AssertionError(f"{tag} first-token logits differ by "
                             f"{float(err.max())} > {tol}")


def _repeating_int8(params):
    """An untied int8 tree made repeating (:func:`_family_params`'s
    ``repeating`` without a bf16 copy): the embedding's row scales times
    REPEAT_EMBED_SCALE, the head the unscaled int8 embedding transposed
    with its row scales (quantizing the transposed rows over their in axis
    gives those very codes and scales). Other leaves shared."""
    emb = params["embed"]
    return {**params,
            "embed": {"weight": emb["weight"],
                      "scale": emb["scale"] * REPEAT_EMBED_SCALE},
            "lm_head": {"kernel": emb["weight"].T.contiguous(),
                        "scale": emb["scale"].clone()}}


def _mesh_tp(torch, np, runs):
    """(a) Qwen3-8B over tp 2 at full width and depth."""
    import dataclasses

    from aws_k8s_ansible_provisioner_tpu_torch.config import (MeshConfig,
                                                              QWEN3_8B,
                                                              ServingConfig)
    from aws_k8s_ansible_provisioner_tpu_torch.models.layers import init_params
    from aws_k8s_ansible_provisioner_tpu_torch.parallel import sharding
    from aws_k8s_ansible_provisioner_tpu_torch.parallel.mesh import make_mesh

    cfg = QWEN3_8B
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = init_params(cfg, gen, torch.bfloat16, quantize=True)
    torch.cuda.synchronize()
    log(f"[mesh tp 2] {cfg.name}: int8 weights drawn layer by layer, "
        f"{_tree_bytes(params) / 1e9:.2f} GB in {time.monotonic() - t0:.1f}s")
    serving = ServingConfig(model=cfg.name, max_decode_slots=8,
                            max_cache_len=2048, prefill_chunk=256,
                            derived_seed=0, prefix_cache=False)
    rng = np.random.default_rng(23)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in MESH_PROMPTS]
    prompts += _pattern_prompts(rng, cfg.vocab_size, MESH_PATTERNS)
    ref = _mesh_engine(torch, cfg, params, serving, None, "[mesh tp 2 ref]")
    first_ref = _first_logits(torch, ref, prompts[:len(MESH_PROMPTS)])
    ref_reqs, _, _, ref_ms, gaps = _mesh_run(torch, ref, prompts,
                                             "[mesh tp 2 ref]", gaps=True)
    del ref
    _free(torch)
    mesh = make_mesh(MeshConfig(tp=2), [torch.device("cuda", 0)] * 2)
    tag = "[mesh tp 2]"
    eng = _mesh_engine(torch, cfg, params, serving, mesh, tag)
    _logits_vs_ref(torch, tag, _first_logits(
        torch, eng, prompts[:len(MESH_PROMPTS)]), first_ref, MESH_LOGIT_TOL)
    reqs, launches, counts, ms, _ = _mesh_run(torch, eng, prompts, tag)
    _check_mesh_launches(tag, eng, launches, counts)
    _streams_vs_ref(tag, reqs, ref_reqs, gaps, MESH_LOGIT_TOL)
    runs["mesh tp 2"] = launches
    # prompt lookup needs streams that repeat: the same int8 tree with the
    # embedding scaled and an untied head of its unscaled rows (the
    # families' repeating weights), the layers' shards shared
    rep = _repeating_int8(params)
    rep_sharded = {**eng.model.params, **sharding.map_tree(
        sharding.make_sharded_put(mesh, cfg),
        {k: rep[k] for k in ("embed", "lm_head")})}
    del eng
    _free(torch)
    tag = "[mesh tp 2 lookup]"
    ref = _mesh_engine(torch, cfg, rep, serving, None, tag + " ref")
    rep_reqs, _, _, _, rep_gaps = _mesh_run(torch, ref, prompts,
                                            tag + " ref", gaps=True)
    del ref, rep
    _free(torch)
    eng = _mesh_engine(torch, cfg, rep_sharded, dataclasses.replace(
        serving, spec_decode=True), mesh, tag)
    reqs, launches, counts, ms_spec, _ = _mesh_run(torch, eng, prompts, tag)
    if counts.get("spec_dispatches", 0) <= 0:
        raise AssertionError(f"{tag} no verify dispatch: {counts}")
    _check_mesh_launches(tag, eng, launches, counts)
    _streams_vs_ref(tag, reqs, rep_reqs, rep_gaps, MESH_LOGIT_TOL)
    runs["mesh tp 2 lookup"] = launches
    del eng, rep_sharded
    _free(torch)
    log(f"[mesh tp 2] ms a decode substep, eager, 8 slots: meshed "
        f"{ms:.2f}, unmeshed {ref_ms:.2f} ({ms / ref_ms:.2f}x); peak device "
        f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; one card "
        f"holds both shards, so this measures the shard loop's cost, not "
        f"scaling")
    if torch.cuda.device_count() >= 2:
        devs = [torch.device("cuda", 0), torch.device("cuda", 1)]
        tag = "[mesh tp 2, two cards]"
        eng = _mesh_engine(torch, cfg, params, serving,
                           make_mesh(MeshConfig(tp=2), devs), tag)
        reqs, launches, counts, ms2, _ = _mesh_run(torch, eng, prompts, tag)
        _check_mesh_launches(tag, eng, launches, counts)
        _streams_vs_ref(tag, reqs, ref_reqs, gaps, MESH_LOGIT_TOL)
        log(f"{tag} shards on {[str(d) for d in devs]}: {ms2:.2f} ms a "
            f"substep")
        del eng
    del params
    _free(torch)


def _mesh_dp_tp(torch, np, runs):
    """(b) Qwen3-0.6B over dp 2 x tp 2 with prompt lookup."""
    import dataclasses

    from aws_k8s_ansible_provisioner_tpu_torch.config import (MeshConfig,
                                                              QWEN3_0_6B,
                                                              ServingConfig)
    from aws_k8s_ansible_provisioner_tpu_torch.models.layers import init_params
    from aws_k8s_ansible_provisioner_tpu_torch.parallel.mesh import make_mesh

    cfg = QWEN3_0_6B
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = init_params(cfg, gen, torch.bfloat16, quantize=True)
    serving = ServingConfig(model=cfg.name, max_decode_slots=8,
                            max_cache_len=2048, prefill_chunk=256,
                            derived_seed=0)
    rng = np.random.default_rng(29)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in MESH_PROMPTS]
    prompts += _pattern_prompts(rng, cfg.vocab_size, MESH_PATTERNS)
    tag = "[mesh dp 2 tp 2 ref]"
    ref = _mesh_engine(torch, cfg, params, serving, None, tag)
    first_ref = _first_logits(torch, ref, prompts[:len(MESH_PROMPTS)])
    ref_reqs, _, _, ref_ms, gaps = _mesh_run(torch, ref, prompts, tag,
                                             gaps=True)
    del ref
    _free(torch)
    tag = "[mesh dp 2 tp 2 lookup]"
    mesh = make_mesh(MeshConfig(dp=2, tp=2), [torch.device("cuda", 0)] * 4)
    eng = _mesh_engine(torch, cfg, params, dataclasses.replace(
        serving, spec_decode=True), mesh, tag)
    del params
    _logits_vs_ref(torch, tag, _first_logits(
        torch, eng, prompts[:len(MESH_PROMPTS)]), first_ref, MESH_LOGIT_TOL)
    seen = {"steps": 0, "pages": 0}

    def own_partition(e):
        # every active slot's pages lie in its own dp group's partition
        for slot, req in enumerate(e.slot_req):
            if req is None:
                continue
            lo, pages = e._gbase(slot), e._slot_pages[slot]
            live = e.table[slot, :len(pages)]
            if not ((live > lo) & (live < lo + e._group_pages)).all():
                raise AssertionError(f"{tag} slot {slot} (group "
                                     f"{e._group(slot)}) holds pages "
                                     f"{live.tolist()} outside "
                                     f"[{lo}, {lo + e._group_pages})")
            seen["pages"] += len(pages)
        seen["steps"] += 1

    reqs, launches, counts, ms, _ = _mesh_run(torch, eng, prompts, tag,
                                              check=own_partition)
    if counts.get("spec_dispatches", 0) <= 0:
        raise AssertionError(f"{tag} no verify dispatch: {counts}")
    _check_mesh_launches(tag, eng, launches, counts)
    _streams_vs_ref(tag, reqs, ref_reqs, gaps, MESH_LOGIT_TOL)
    log(f"{tag} every active slot's pages in its own group's partition "
        f"after each of {seen['steps']} steps ({seen['pages']} slot-pages "
        f"checked; {eng._group_pages} pages a group); ms a decode substep, "
        f"eager: meshed {ms:.2f}, unmeshed {ref_ms:.2f}")
    runs["mesh dp 2 tp 2 lookup"] = launches
    del eng
    _free(torch)


def _mesh_ep(torch, np, runs):
    """(c) Qwen3-30B-A3B over ep 2 x tp 2 at MESH_MOE_LAYERS layers: the
    meshed gshard forward against gshard whole on the lead, then the
    meshed engine serving a few requests."""
    from aws_k8s_ansible_provisioner_tpu_torch.config import (MeshConfig,
                                                              ServingConfig)
    from aws_k8s_ansible_provisioner_tpu_torch.models.layers import (
        DecoderLM, MeshLM, init_params)
    from aws_k8s_ansible_provisioner_tpu_torch.parallel.mesh import make_mesh

    cfg = _moe_cfg(MESH_MOE_LAYERS).scaled(moe_impl="gshard")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = init_params(cfg, gen, torch.bfloat16, quantize=True)
    mesh = make_mesh(MeshConfig(ep=2, tp=2), [torch.device("cuda", 0)] * 4)
    tag = f"[mesh ep 2 tp 2, {cfg.name} {MESH_MOE_LAYERS} layers]"
    rng = np.random.default_rng(31)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, MESH_MOE_TOKENS)).astype(np.int32)).cuda()
    pos = torch.arange(MESH_MOE_TOKENS, dtype=torch.int32,
                       device=tokens.device)[None].expand(2, -1)
    whole = DecoderLM(cfg, params).forward(tokens, pos)[:, -1].float()
    meshed = MeshLM(cfg, params, mesh, 1)
    got = meshed.forward(tokens, pos)[:, -1].float()
    torch.cuda.synchronize()
    _logits_vs_ref(torch, tag, got, whole, MESH_LOGIT_TOL,
                   f"last-position logits of {{n}} rows of {MESH_MOE_TOKENS} "
                   f"tokens vs gshard whole on the card")
    serving = ServingConfig(model=cfg.name, max_decode_slots=8,
                            max_cache_len=2048, prefill_chunk=256,
                            derived_seed=0)
    eng = _mesh_engine(torch, cfg, meshed.params, serving, mesh, tag)
    del meshed, params
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in MESH_PROMPTS[:4]]
    _, launches, counts, ms, _ = _mesh_run(torch, eng, prompts, tag)
    _check_mesh_launches(tag, eng, launches, counts)
    log(f"{tag} the experts over ep 2 x tp 2 through gshard (its einsums, "
        f"as in the JAX engine under a mesh; route-and-sort "
        f"{launches['moe_route_sort']} launches, the grouped kernels none); "
        f"{ms:.2f} ms a decode substep, eager")
    runs["mesh ep 2 tp 2"] = launches
    del eng
    _free(torch)


def _mesh_load(torch, np):
    """(d) The checkpoint phase's Qwen3-0.6B directory (the same writer and
    seed) loaded under tp 2, int8 as the server loads it: every shard leaf
    equal to the whole load's slice bit for bit, split leaves 1/tp of their
    axis and owning their storage."""
    import shutil
    import tempfile

    from aws_k8s_ansible_provisioner_tpu_torch.config import (MeshConfig,
                                                              QWEN3_0_6B)
    from aws_k8s_ansible_provisioner_tpu_torch.models.hf_loader import \
        load_checkpoint
    from aws_k8s_ansible_provisioner_tpu_torch.parallel import sharding
    from aws_k8s_ansible_provisioner_tpu_torch.parallel.mesh import make_mesh

    cfg = QWEN3_0_6B
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        ckpt = os.path.join(tmp, "Qwen3-0.6B")
        _write_hf_checkpoint(torch, cfg, ckpt)
        _free(torch)
        mesh = make_mesh(MeshConfig(tp=2), [torch.device("cuda", 0)] * 2)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.monotonic()
        placed = load_checkpoint(ckpt, cfg, torch.bfloat16, quantize=True,
                                 place=sharding.make_sharded_put(mesh, cfg))
        torch.cuda.synchronize()
        t_sharded = time.monotonic() - t0
        peak_sharded = torch.cuda.max_memory_allocated() - base
        t0 = time.monotonic()
        whole = load_checkpoint(ckpt, cfg, torch.bfloat16, "cuda",
                                quantize=True)
        torch.cuda.synchronize()
        t_whole = time.monotonic() - t0
        n_split = n_leaves = 0

        def check(path, leaf):
            nonlocal n_split, n_leaves
            w = whole
            for k in path:
                w = w[k]
            split = any(a is not None for a in leaf.spec)
            n_leaves += 1
            n_split += split
            for pos, part in leaf.parts.items():
                want = sharding._slice(w, leaf.spec, mesh,
                                       sharding._slice_index(leaf.spec, mesh,
                                                             pos))
                if part.device != mesh.devices[pos]:
                    raise AssertionError(f"[mesh load] {path} at {pos} on "
                                         f"{part.device}, not on its "
                                         f"position's {mesh.devices[pos]}")
                if not torch.equal(part, want.to(part.device)):
                    raise AssertionError(f"[mesh load] {path} at {pos} "
                                         f"differs from the whole load's "
                                         f"slice")
                if split and part.untyped_storage().nbytes() != \
                        part.numel() * part.element_size():
                    raise AssertionError(f"[mesh load] {path} at {pos} "
                                         f"shares a larger storage")

        sharding.map_tree(check, placed)
        log(f"[mesh load] {cfg.name} int8 under tp 2: {n_leaves} leaves "
            f"({n_split} split), every shard leaf equal to the whole load's "
            f"slice bit for bit; sharded load {t_sharded:.1f}s (converted "
            f"on the host, each leaf placed as it was produced; peak device "
            f"memory above the start {peak_sharded / 1e9:.2f} GB), whole "
            f"load on the card {t_whole:.1f}s")
        del placed, whole
        _free(torch)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_mesh(torch, np):
    """Tensor, data and expert parallel serving on the paged engine, every
    mesh position on this card (``make_mesh`` over an explicit device
    list): (a) Qwen3-8B (36 layers, hidden 4096, Hq 32, Hkv 8, vocab
    151,936, untied) over tp 2 at full width and depth, seeded int8
    weights drawn layer by layer, 8 slots x 2048 rows, bf16 KV; 8 greedy
    requests of MESH_PROMPTS and MESH_PATTERNS repeated-pattern ones, once
    plain and once with prompt lookup, against the same weights on the
    same engine without a mesh: every prompt's first-token logits within
    MESH_LOGIT_TOL, and the greedy streams equal up to the first draw
    whose unmeshed top-2 margin is below it; ms a decode substep (eager,
    meshed and unmeshed), K1, K1-spec and the fused K2 launches per shard,
    the peak device memory; with two visible cards, the plain run again
    with its shards on cards 0 and 1. (b) Qwen3-0.6B over dp 2 x tp 2 with
    prompt lookup, the same checks, and every active slot's pages in its
    own group's partition after every step. (c) Qwen3-30B-A3B at
    MESH_MOE_LAYERS layers over ep 2 x tp 2: the meshed gshard forward's
    logits against gshard whole on the card, then a short engine run. (d)
    the sharded load (:func:`_mesh_load`). Every run's launches are zeroed
    just before and read just after; returns {run: launches}."""
    runs = {}
    for name, fn in (("tp 2", _mesh_tp), ("dp 2 tp 2", _mesh_dp_tp),
                     ("ep 2 tp 2", _mesh_ep)):
        t0 = time.monotonic()
        fn(torch, np, runs)
        _free(torch)
        log(f"[wall] mesh {name}: {time.monotonic() - t0:.1f}s")
    _phase("mesh load", _mesh_load, torch, np)
    return runs


def _phase(name, fn, *args):
    """Run one phase and log its wall time."""
    t0 = time.monotonic()
    out = fn(*args)
    log(f"[wall] {name}: {time.monotonic() - t0:.1f}s")
    return out


def _free(torch):
    """Return the device memory of the phase just ended."""
    gc.collect()
    torch.cuda.empty_cache()


def _sp_phases(torch, np, runs):
    """The sp 1 dense engine (the yardstick), then sp 4 and 2 over bf16 KV
    and sp 4 over int8 KV, their launches into ``runs``."""
    t_sp = time.monotonic()
    params = _sp_params(torch)
    ref_engine, _, ref_reqs, ref_gaps = phase_sp_engine(torch, np, params,
                                                        "auto", 1)
    del ref_engine
    _free(torch)
    log(f"[wall] sp 1 auto: {time.monotonic() - t_sp:.1f}s")
    for kv_dtype, sp in (("auto", 4), ("auto", 2), ("int8", 4)):
        t0 = time.monotonic()
        engine, runs[f"sp {sp} {kv_dtype}"], reqs, _ = phase_sp_engine(
            torch, np, params, kv_dtype, sp, profile=sp == 4)
        _logits_check(torch, engine, LOGIT_TOL, slots=range(SP_SLOTS))
        if kv_dtype == "auto":
            _greedy_vs_sp1(f"[sp {sp} bf16]", [r.generated for r in reqs],
                           ref_reqs, ref_gaps)
        else:
            phase_server(engine)
        del engine
        _free(torch)
        log(f"[wall] sp {sp} {kv_dtype}: {time.monotonic() - t0:.1f}s")
    del params
    _free(torch)
    log(f"[wall] sp phases: {time.monotonic() - t_sp:.1f}s")


# the phases of ``--phases``, in the order they run
PHASES = ("kernels", "kernels-window", "kernels-sp", "kernels-families",
          "kernels-moe", "sampling", "engine", "server-process",
          "checkpoint", "guided-lora", "prefix", "spec", "draft", "dense",
          "mistral", "families", "moe", "sp", "mesh")


class _NotRun(dict):
    """The result of a kernels phase left out by ``--phases``: indexing it
    gives itself, so that the kernels table can name its rows, and no row
    of it is listed."""

    def __getitem__(self, key):
        return self


NOT_RUN = _NotRun()


def _selected(argv) -> tuple:
    """The phases named by ``--phases NAME[,NAME...]`` (all by default)."""
    if not argv:
        return PHASES
    names = tuple(n for n in argv[1].split(",") if n) \
        if len(argv) == 2 and argv[0] == "--phases" else ()
    unknown = [n for n in names if n not in PHASES]
    if unknown or not names:
        raise SystemExit(f"usage: chip_smoke.py [--phases NAME[,NAME...]]; "
                         f"unknown {unknown or argv}; phases: "
                         f"{', '.join(PHASES)}")
    return names


def main(argv=()) -> int:
    import numpy as np
    import torch

    want = set(_selected(list(argv)))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import aws_k8s_ansible_provisioner_tpu_torch  # noqa: F401  (needs the repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"nvidia-smi failed ({smi.returncode})"
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}; "
        f"phases {[p for p in PHASES if p in want]}")
    t_start = time.monotonic()
    _phase("build", phase_build)

    def kernels(name, label, fn):
        return _phase(label, fn, torch, np) if name in want else NOT_RUN

    kern = kernels("kernels", "kernels", phase_kernels)
    wkern = kernels("kernels-window", "kernels, window", phase_kernels_window)
    skern = kernels("kernels-sp", "kernels, sp", phase_kernels_sp)
    fkern = kernels("kernels-families", "kernels, families",
                    phase_kernels_families)
    mkern = kernels("kernels-moe", "kernels, moe", phase_kernels_moe)
    if "sampling" in want:
        _phase("sampling", phase_sampling, torch, np)
    runs = {}
    for kv_dtype in ("auto", "int8") if "engine" in want else ():
        t0 = time.monotonic()
        engine, launches = phase_engine(torch, np, kv_dtype)
        phase_profile(torch, np, engine)
        phase_logits(torch, np, engine)
        if kv_dtype == "int8":
            _phase("server lifecycle", phase_server, engine, True)
            _phase("pipeline, paged", phase_pipeline, torch, np, engine)
        else:
            _phase("server, fields and streams", phase_server, engine,
                   False, True)
            _phase("request fields", phase_fields, torch, np, engine)
            _phase("failover", phase_failover, torch, np, engine)
            _phase("prefill batch (C22)", phase_prefill_batch, torch, np)
        runs[kv_dtype] = launches
        del engine
        _free(torch)
        log(f"[wall] engine {kv_dtype}: {time.monotonic() - t0:.1f}s")
    if "server-process" in want:
        _phase("server process", phase_server_process)
    if "checkpoint" in want:
        _phase("checkpoint", phase_checkpoint, torch, np)
        _free(torch)
    if "guided-lora" in want:
        _phase("guided and LoRA", phase_guided_lora, torch, np)
        _free(torch)
    for kv_dtype in ("auto", "int8") if "prefix" in want else ():
        _phase(f"prefix {kv_dtype}", phase_prefix, torch, np, kv_dtype)
        _free(torch)
    for kv_dtype in ("auto", "int8") if "spec" in want else ():
        t0 = time.monotonic()
        engine, launches, _ = phase_spec(torch, np, kv_dtype)
        phase_verify(torch, np, engine)
        runs["spec " + kv_dtype] = launches
        del engine
        _free(torch)
        log(f"[wall] spec {kv_dtype}: {time.monotonic() - t0:.1f}s")
    if "draft" in want:
        runs["draft"] = _phase("draft", phase_draft, torch, np)["self"][
            "launches"]
    if "dense" in want:
        # the dense engine (paged=False): bf16 KV through K5 (4 slots per
        # CTA), int8 KV through K4-int8, int8 prompt lookup through K7-int8
        # and K5-int8
        for kv_dtype, bb in (("auto", 4), ("int8", 0)):
            t0 = time.monotonic()
            engine, runs["dense " + kv_dtype] = phase_engine(
                torch, np, kv_dtype, paged=False, bblock=bb)
            phase_profile(torch, np, engine)
            phase_logits(torch, np, engine)
            if kv_dtype == "int8":
                phase_server(engine)
                _phase("pipeline, dense", phase_pipeline, torch, np, engine)
            del engine
            _free(torch)
            log(f"[wall] dense {kv_dtype}: {time.monotonic() - t0:.1f}s")
        t0 = time.monotonic()
        engine, runs["dense spec int8"], _ = phase_spec(
            torch, np, "int8", paged=False, bblock=4)
        del engine
        _free(torch)
        log(f"[wall] dense spec int8: {time.monotonic() - t0:.1f}s")
    if "mistral" in want:
        for kv_dtype in ("auto", "int8"):
            t0 = time.monotonic()
            engine, runs["mistral " + kv_dtype] = phase_mistral(torch, np,
                                                                kv_dtype)
            phase_server(engine)
            del engine
            _free(torch)
            log(f"[wall] mistral {kv_dtype}: "
                f"{time.monotonic() - t0:.1f}s")
        runs["mistral spec"] = _phase("mistral spec", phase_mistral_spec,
                                      torch, np)
        _free(torch)
        runs["mistral draft"] = _phase("mistral draft", phase_mistral_draft,
                                       torch, np)
        _free(torch)
        t0 = time.monotonic()
        engine, runs["mistral dense int8"] = phase_mistral(
            torch, np, "int8", paged=False, bblock=4)
        del engine
        _free(torch)
        log(f"[wall] mistral dense int8: {time.monotonic() - t0:.1f}s")
    # the Llama, Gemma, Phi and OPT families at full width and depth
    if "families" in want:
        runs.update(_phase("families", phase_families, torch, np))
    # Qwen3-30B-A3B (MoE) at full width and depth, int8 weights; prompt
    # lookup; the bf16 instances at 4 layers
    if "moe" in want:
        moe_runs, _ = _phase("moe", phase_moe, torch, np)
        runs.update(moe_runs)
    # sequence-parallel serving: the sp 1 dense engine's greedy streams are
    # the yardstick of the bf16 sp runs; the int8 sp 4 engine serves HTTP
    if "sp" in want:
        _sp_phases(torch, np, runs)
    # tensor, data and expert parallel serving, every shard on this card
    mesh_runs = _phase("mesh", phase_mesh, torch, np) \
        if "mesh" in want else {}
    runs.update(mesh_runs)
    keys = ("max_abs_err", "mean_abs_err", "ms", "device_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    kernels = []
    for name, src, line, res, run in (
            ("paged_attention", ATTN_SRC, 1080, kern["bf16"]["attention"],
             "auto"),
            ("paged_attention_quant", ATTN_SRC, 1014,
             kern["int8"]["attention"], "int8"),
            # K2 and K3 with the q/k prologue fused in (the standalone
            # writes launch on no engine path): Qwen3's decode, verify and
            # ragged rows (q/k norm and RoPE), Mistral's decode (RoPE)
            ("prep_write_rows_paged", WRITE_SRC, 1243,
             kern["bf16"]["prep decode"], "auto"),
            ("prep_write_rows_quant_paged", WRITE_SRC, 1313,
             kern["int8"]["prep decode"], "int8"),
            ("prep_write_rows_paged verify", WRITE_SRC, 1243,
             kern["bf16"]["prep verify"], "spec auto"),
            ("prep_write_rows_quant_paged verify", WRITE_SRC, 1313,
             kern["int8"]["prep verify"], "spec int8"),
            ("prep_write_rows_paged ragged", WRITE_SRC, 1243,
             kern["bf16"]["prep ragged"], "auto"),
            ("prep_write_rows_quant_paged ragged", WRITE_SRC, 1313,
             kern["int8"]["prep ragged"], "int8"),
            ("prep_write_rows_paged rope", WRITE_SRC, 1243,
             wkern["bf16"]["prep"], "mistral auto"),
            ("prep_write_rows_quant_paged rope", WRITE_SRC, 1313,
             wkern["int8"]["prep"], "mistral int8"),
            ("paged_attention_spec", ATTN_SRC, 1169, kern["bf16"]["spec"],
             "spec auto"),
            ("paged_attention_spec_quant", ATTN_SRC, 1169,
             kern["int8"]["spec"], "spec int8"),
            ("decode_attend_dense", DENSE_SRC, 516,
             kern["dense"]["attention"], "draft"),
            ("spec_attend_dense", DENSE_SRC, 675, kern["dense"]["spec"],
             "draft"),
            # K8 and K9 with the q/k prologue fused in (the standalone
            # writes launch on no engine path; their times ride the decode
            # rows as standalone_ms): Qwen3's dense decode and verify rows
            # (q/k norm and RoPE), Mistral's decode (RoPE), an sp shard
            ("prep_write_rows_dense", WRITE_SRC, 744,
             kern["dense"]["prep decode"], "dense auto"),
            ("prep_write_rows_dense verify", WRITE_SRC, 744,
             kern["dense"]["prep verify"], "draft"),
            ("prep_write_rows_dense rope", WRITE_SRC, 744,
             wkern["dense"]["prep"], "mistral draft"),
            ("prep_write_rows_dense sp", WRITE_SRC, 744,
             skern["bf16"]["prep"], "sp 4 auto"),
            ("prep_write_rows_quant_dense", WRITE_SRC, 823,
             kern["dense int8"]["prep decode"], "dense int8"),
            ("prep_write_rows_quant_dense verify", WRITE_SRC, 823,
             kern["dense int8"]["prep verify"], "dense spec int8"),
            ("prep_write_rows_quant_dense rope", WRITE_SRC, 823,
             wkern["dense int8"]["prep"], "mistral dense int8"),
            ("prep_write_rows_quant_dense sp", WRITE_SRC, 823,
             skern["int8"]["prep"], "sp 4 int8"),
            # K1's ragged entry with the chunk layout: the decode rows
            # through the per-row body, the chunk's through the chunk body
            # (ms: the whole ragged call)
            ("paged_attention chunk", CHUNK_SRC, 1120,
             kern["bf16"]["attention_ragged"], "auto"),
            ("paged_attention_quant chunk", CHUNK_SRC, 1120,
             kern["int8"]["attention_ragged"], "int8"),
            ("paged_attention chunk window", CHUNK_SRC, 1120,
             wkern["bf16"]["attention_ragged"], "mistral auto"),
            ("paged_attention_quant chunk window", CHUNK_SRC, 1120,
             wkern["int8"]["attention_ragged"], "mistral int8"),
            ("paged_attention window", ATTN_SRC, 1080,
             wkern["bf16"]["attention"], "mistral auto"),
            ("paged_attention_quant window", ATTN_SRC, 1014,
             wkern["int8"]["attention"], "mistral int8"),
            ("paged_attention_spec window", ATTN_SRC, 1169,
             wkern["bf16"]["spec"], "mistral spec"),
            ("decode_attend_dense window", DENSE_SRC, 516,
             wkern["dense"]["attention"], "mistral draft"),
            ("spec_attend_dense window", DENSE_SRC, 675,
             wkern["dense"]["spec"], "mistral draft"),
            ("decode_attend_dense quant", DENSE_SRC, 516,
             kern["dense int8"]["attention"], "dense int8"),
            ("spec_attend_dense quant", DENSE_SRC, 675,
             kern["dense int8"]["spec"], "dense spec int8"),
            ("decode_attend_dense bblock", DENSE_SRC, 499,
             kern["dense"]["bblock 4"], "dense auto"),
            ("decode_attend_dense quant bblock", DENSE_SRC, 499,
             kern["dense int8"]["bblock 4"], "dense spec int8"),
            ("decode_attend_dense quant bblock window", DENSE_SRC, 499,
             wkern["dense int8"]["bblock"], "mistral dense int8"),
            ("decode_attend_dense stats", DENSE_SRC, 429,
             skern["bf16"]["stats"], "sp 4 auto"),
            ("decode_attend_dense quant stats", DENSE_SRC, 429,
             skern["int8"]["stats"], "sp 4 int8"),
            # the split-KV combine, part of K1's and the dense kernels'
            # port: it replaces no pallas_call of its own
            ("split_merge", MERGE_SRC, None, kern["merge"], "auto")):
        if res is NOT_RUN or run not in runs:
            continue
        key = name if name in runs[run] else name.split()[0]
        # the mesh phase's launches of this very instance
        mesh = sum(r.get(name, 0) for r in mesh_runs.values())
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": (f"{TPU_KERNELS}:{line}" if line
                                     else "none (part of K1, K4-K7)"),
                        "launches": runs[run][key],
                        **({"mesh_launches": mesh} if mesh else {}),
                        **{k: res[k] for k in keys},
                        **{k: res[k] for k in (
                            "graph_ms", "chain_graph_ms", "standalone_ms",
                            "standalone_device_ms") if k in res}})
    for name, src, line, res, run, key in (
            _family_kernel_rows(fkern) if fkern is not NOT_RUN else ()):
        if run not in runs:
            continue
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": f"{TPU_KERNELS}:{line}",
                        "launches": runs[run][key],
                        **{k: res[k] for k in keys},
                        **{k: res[k] for k in ("graph_ms", "chain_graph_ms")
                           if k in res}})
    # the MoE kernels, at a decode horizon of 32 slots (every case is in
    # the log); they replace XLA regions, no pallas_call
    for name, src, replaces, run in (
            ("moe_route_sort", MOE_ROUTE_SRC, MOE_ROUTE_JAX, "moe"),
            ("moe_gate_up quant", MOE_GROUPED_SRC, MOE_GROUPED_JAX, "moe"),
            ("moe_grouped quant", MOE_GROUPED_SRC, MOE_GROUPED_JAX, "moe"),
            ("moe_gate_up", MOE_GROUPED_SRC, MOE_GROUPED_JAX, "moe bf16"),
            ("moe_grouped", MOE_GROUPED_SRC, MOE_GROUPED_JAX, "moe bf16")):
        res = mkern[name]["decode 32"]
        if res is NOT_RUN or run not in runs:
            continue
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": runs[run][name],
                        **{k: res[k] for k in keys}})
    missing = [k["name"] for k in kernels if k["launches"] <= 0]
    if missing:
        raise AssertionError(f"kernel instances with no launch in their "
                             f"named run: {missing}")
    # the combine's launches beside those of the attention launches that
    # used it (a launch with more than one split is followed by one combine)
    for run, counts in runs.items():
        users = {k: v for k, v in counts.items()
                 if v and ("attention" in k or "attend" in k)}
        log(f"[split] {run}: split_merge {counts['split_merge']} beside "
            f"{users}")
    seconds = time.monotonic() - t_start
    log(f"[done] {seconds:.1f}s")
    print(f"chip_smoke: {len(kernels)} kernel rows, phases "
          f"{[p for p in PHASES if p in want]}, {seconds:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
