#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout and needs one CUDA card, nvcc and the
port's package beside this file; it exits non-zero without printing a
result when either is missing. Phases, in order (any failure raises):

1. build: nvcc compiles every kernel of the serving path from ``csrc/``
   (one process per source, all started together);
2. kernels: at the shapes of the main path (Qwen3-0.6B: Hq 16, Hkv 8, D 128,
   page 64, a 28-layer pool) each kernel is held against its plain PyTorch
   version on the same inputs on the card, and timed beside its plain
   version, a PyTorch library call of the same function and its bound: the
   attention and the row write over a bf16 pool, and their int8 forms (the
   scale-folding attention, the quantizing row write) over an int8 pool;
   the speculative verify's attention (5 rows per slot) over both pools;
   and over the dense cache ([28, 32, 8, 2048, 128], bf16, then int8 with
   its scales) the decode attention (K4; K5 at 4 and 8 slots per CTA), the
   verify attention (K7) and the row write (K8; int8: K9, bit-exact);
3. engine, once per KV pool: the main path, Qwen3-0.6B at full width with
   seeded random weights through ``serving.engine.Engine`` (the default
   ServingConfig: paged, page 64, 32 slots, int8 weights; prefill_chunk 256
   so long prompts ride ``mixed_step``), first with bf16 KV, then with
   ``kv_dtype="int8"``, with the default one-deep decode pipeline and the
   decode horizon replayed as CUDA graphs captured when the engine is
   built: every decode dispatch must be one replay. The kernels' launch
   counts (a replay adds what its graph captured) are zeroed just before
   each run and read just after; each kernel of that pool must be > 0 and
   the other pool's kernels 0. The int8 run adds seeded sampled requests:
   one submitted alone and again beside other running requests must give
   the same stream. Then one decode dispatch of 8 slots is timed and
   profiled (device time by kernel, the row write's time a launch), and
   one decode step's logits through the kernels are held against the same
   step through the plain versions. After the int8 run, the pipeline
   phase: the graphs' capture time and device memory, one replay against
   eager ``decode_steps`` on a clone of the cache (tokens equal, every
   K/V row and scale bit-identical or the largest difference printed,
   launch counts equal), seeded streams equal with ``decode_pipeline`` 1
   and 0, and a dispatch profiled with the pipeline off;
4. server, for each engine: the port's HTTP server in-process on a free
   port answers ``GET /v1/models`` and ``POST /v1/completions`` (with the
   int8 engine, a seeded sampled completion twice, the same text);
5. spec, once per KV pool: prompt-lookup speculative decoding
   (``spec_decode=True``) at full width on repeated-pattern prompts, with
   its launch counts zeroed just before and read just after (verify
   dispatches, drafts and the verify kernel of that pool required); a
   seeded sampled request gives the same stream with spec on and off (the
   engine serves sampled slots from the plain step only). One
   verify dispatch of 8 slots is held against plain decode steps of the
   same prefixes (logits within LOGIT_TOL, the emitted tokens the accept
   rule on the verify's argmax), then timed and profiled;
6. draft: ``spec_method="draft"`` with a self-draft and a divergent draft of
   the same width over the dense cache; a second wave of chunked prompts
   puts the drafts behind so that they catch up. The dense kernels must
   have launched, and the self-draft must have accepted drafts;
7. the window instances (after the kernels phase): K1 (decode, ragged,
   verify; bf16 and int8 pools), K4, K7 and K5 (4 slots per CTA; bf16 and
   int8 dense caches) at Mistral-7B-v0.1's shapes with its window of 4096,
   each held against its plain version and timed, the dense ones also
   with NaN rows (int8: scales) below their first tile, which must change
   nothing; and K1 at window 0 against window 4096 on rows of ~8000
   columns;
8. Mistral-7B-v0.1 at full width (32 layers, window 4096, int8 weights, 16
   slots of 8192 rows, prefill_chunk 512), once per KV pool: the engine
   with launch counts (window instances only), one decode step's logits
   at lengths past the window held against the plain versions and against
   window 0, one decode dispatch profiled, the server; then prompt lookup
   (the verify's window instance) and a self-draft (K4 and K7's);
9. the dense engine (``ServingConfig(paged=False)``, every slot's window
   of rows reserved, prefill_chunk 256 so that long prompts take the dense
   chunk walk): Qwen3-0.6B at full width with bf16 KV and decode_bblock 4
   (K8, K5), then with int8 KV (K9, K4-int8; seeded sampled streams alone
   and beside others; the server; the pipeline phase as in 3), each with
   one decode dispatch profiled and a decode step's logits held against
   the plain versions; prompt lookup
   over int8 KV with decode_bblock 4 (K7-int8, K9, K5-int8); and
   Mistral-7B-v0.1 at full width on a dense int8 cache of 16 x 8192 rows
   with decode_bblock 4 (K5-int8's window instance, K9; logits held as in
   8). In every dense run the paged kernels' counts must be 0;
10. sequence-parallel serving (after the window kernels, the kernels phase
   "kernels, sp"): K6, the stats form of the dense decode, bf16 and int8,
   over every shard of a dense cache [28, 4, 8, 32768, 128] split into 4
   and into 2 sequence shards, against its plain version (the empty
   shards exactly (0, -1e30, 0)), the shards merged as the engine merges
   them against K4 (int8: K4-int8) over the whole cache by the ulp rule,
   timed beside its plain version and a memory-efficient attention call
   that returns the log-sum-exp; then, last, Qwen3-0.6B at full width
   with 4 slots of 32768 rows, prefill_chunk 512 and prompts of about 40,
   6,000, 14,000 and 27,000 tokens (32 new tokens each): the dense engine
   without a mesh (the yardstick), then ``Engine(..., mesh=)`` over
   ``[cuda:0] * sp`` with bf16 KV at sp 4 and sp 2 and int8 KV at sp 4
   (with a seeded sampled request, drawn twice), each with launch counts
   zeroed just before and read just after (K6 and the row write ``L x
   sp`` times per decode substep, no other kernel), one decode step of
   all 4 slots held against the plain versions, the bf16 greedy streams
   compared with the yardstick's, and the HTTP server over the int8 one.

Every phase logs its wall time. The line before the last is
``{"kernels": [...]}``; the last is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gc
import json
import math
import os
import re
import socket
import subprocess
import sys
import threading
import time
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor cores
ATTN_SRC = "aws_k8s_ansible_provisioner_tpu_torch/csrc/paged_attention.cu"
WRITE_SRC = "aws_k8s_ansible_provisioner_tpu_torch/csrc/cache_write.cu"
DENSE_SRC = "aws_k8s_ansible_provisioner_tpu_torch/csrc/dense_attention.cu"
MERGE_SRC = "aws_k8s_ansible_provisioner_tpu_torch/csrc/split_merge.cu"
TPU_KERNELS = "aws_k8s_ansible_provisioner_tpu/ops/pallas_attention.py"
# bf16 kernel vs plain, per query row (its Hq x D outputs): both compute in
# float32 and round once to bf16, so an element differs by at most one ulp
# of itself. With u the bf16 ulp of the row's max |plain output|, each row
# must hold max |diff| <= ATTN_MAX_ULPS * u and mean |diff| <=
# ATTN_MEAN_ULPS * u. A row that loses or gains one live column moves its
# mean by about |v| / limit, tens of ulps for the rows of these cases.
ATTN_MAX_ULPS, ATTN_MEAN_ULPS = 4.0, 0.5
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
                    hq=16, window=0):
    """Hold the attention kernel against its plain version; time both, an
    SDPA over the gathered K/V, and the bound. ``pools`` holds bf16 "k"/"v",
    or int8 "k"/"v" with float32 scales "ks"/"vs" (the int8 instance);
    ``window`` > 0 takes the window instance. Returns a result dict."""
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
                                            limits, layer, table, window)
        return pa.paged_attention(q, pool_k, pool_v, limits, layer, table,
                                  window)

    out = kernel()
    ref = pa.paged_attention_plain(q, pool_k, pool_v, limits, layer, table,
                                   *scales, window=window)
    torch.cuda.synchronize()
    what = f"{name} {label}"
    check = _ulp_rows(torch, what, out, ref, N,
                      lambda bad: f"limits {limits_np[bad].tolist()}")
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
    splits = split_kv.split_count(N, Hkv, table_np.shape[1],
                                  split_kv.sm_count(dev))
    return _report(what, check, ms, dev_ms, plain_ms, library_ms, nbytes,
                   ops, N, splits)


def _ulp_rows(torch, what, out, ref, n_rows, describe):
    """The attention kernels' tolerance, query row by query row (each row's
    Hq x D outputs): max |diff| <= ATTN_MAX_ULPS and mean |diff| <=
    ATTN_MEAN_ULPS bf16 ulps of the row's largest |plain output|.
    ``describe(bad row indices)`` names the failing rows' inputs."""
    diff = (out.float() - ref.float()).abs().reshape(n_rows, -1)
    max_err, mean_err = float(diff.max()), float(diff.mean())
    ulp = _bf16_ulp(torch, ref.float().abs().reshape(n_rows, -1).amax(1))
    row_max = diff.amax(1) / ulp
    row_mean = diff.mean(1) / ulp
    worst_max, worst_mean = float(row_max.max()), float(row_mean.max())
    if not (math.isfinite(max_err) and worst_max <= ATTN_MAX_ULPS
            and worst_mean <= ATTN_MEAN_ULPS):
        bad = torch.nonzero((row_max > ATTN_MAX_ULPS)
                            | (row_mean > ATTN_MEAN_ULPS)).flatten()[:8]
        raise AssertionError(
            f"{what}: rows {bad.tolist()} ({describe(bad.cpu().numpy())}) "
            f"past tolerance: worst row max {worst_max:.2f} ulp (tol "
            f"{ATTN_MAX_ULPS}), worst row mean {worst_mean:.3f} ulp (tol "
            f"{ATTN_MEAN_ULPS})")
    return {"max_abs_err": max_err, "mean_abs_err": mean_err,
            "worst_row_max_ulps": worst_max, "worst_row_mean_ulps": worst_mean}


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
        f"{check['worst_row_mean_ulps']:.3f} ulp (tol {ATTN_MAX_ULPS}/"
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
    with one row and with SPEC_R rows per slot (some dropped)."""
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
    the split kernels' edges."""
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
                          "ragged 32+256")
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
    log(f"[kernels] {label} pool done")
    return {"attention": dec, "attention_ragged": rag, "write": wr_dec,
            "write_ragged": wr_rag, "write_dropped": wr_oob, "spec": spec}


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
            f"window {W}, ragged {B}+{C}", Hq, W)
        res["spec"] = _spec_case(torch, np, pools, spec_len, table, layer,
                                 f"window {W}, verify {B} x {SPEC_R} rows",
                                 Hq, W)
        _paged_poison_check(torch, np, pools, spec_len, table, layer, Hq, W)
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
        del cache, res
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
    """(attention, row write) launch-count names of one pool's kernels."""
    return (("paged_attention_quant", "cache_write_rows_quant_paged") if quant
            else ("paged_attention", "cache_write_rows_paged"))


# the paged engine's kernels (every instance), each 0 in a dense engine run
PAGED_KERNELS = ("paged_attention", "paged_attention_quant",
                 "paged_attention_spec", "paged_attention_spec_quant",
                 "cache_write_rows_paged", "cache_write_rows_quant_paged")


def _dense_kernel_names(engine):
    """(decode attention instance, row write) launch-count names of a
    dense engine's kernels (its KV dtype, decode_bblock and window)."""
    quant = "ks" in engine.cache
    return (_dense_name("decode_attend_dense", quant, engine.decode_bblock,
                        engine.cfg.sliding_window),
            "cache_write_rows_quant_dense" if quant
            else "cache_write_rows_dense")


def _check_dense_launches(tag, engine, launches, extra=()):
    """A dense engine run: its decode attention instance, its row write and
    ``extra`` launched, no paged kernel, and (without a window) no window
    instance."""
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
    return engine, launches


def _seeded_twice(engine, rng, Request):
    """One sampled request with its own seed, alone, then admitted again
    while three greedy requests decode in other slots (its prefill is a
    batch of its own both times, and no chunk is in flight beside it):
    both streams must be identical."""
    cfg = engine.cfg
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
    wall_ms = _profile_dispatch(torch, engine, tag)
    for s in engine._active_slots():
        engine.cancel(engine.slot_req[s])
    engine.step()
    return wall_ms


def _profile_dispatch(torch, engine, tag, step=None, n_slots=None):
    """One engine step (a decode dispatch; or ``step()``, a dispatch of
    ``n_slots`` slots) timed by the host clock, then the next under
    torch.profiler: device time by kernel and the device's idle share."""
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
        log(f"{tag} profiled dispatch: wall {prof_wall_ms:.2f} ms, "
            f"device busy {busy_ms:.2f} ms (idle share "
            f"{1 - busy_ms / prof_wall_ms:.3f}), "
            f"{sum(e.count for e in events)} device operations")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
            log(f"{tag}   {e.self_device_time_total / 1e3:8.3f} ms "
                f"{100 * e.self_device_time_total / 1e3 / busy_ms:5.1f}% "
                f"x{e.count:<5d} {e.key[:90]}")
        # the row writes (K2, K3, K8, K9): device time a launch (a graph
        # node when the engine replays its decode graphs)
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
    serving = engine.serving
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
    engine.serving = serving
    return {"capture_s": dec.capture_s, "pool_bytes": dec.pool_bytes}


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
    step rewrites them. The dense engine's step takes its decode_bblock.
    A sequence-parallel engine's kernels step writes each shard and merges
    K6's triples (its decode callback); its plain step writes each shard
    through the plain writers at the local rows and attends the rows
    gathered from the shards in order."""
    from aws_k8s_ansible_provisioner_tpu_torch.ops import dense_attention as da
    from aws_k8s_ansible_provisioner_tpu_torch.ops import paged_attention as pa
    from aws_k8s_ansible_provisioner_tpu_torch.ops.attention import (
        make_decode_attend_carry, make_decode_attend_carry_paged)

    engine._settle_inflight()            # the host mirrors up to date
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

    def checked_attend(q, k, v, cache_l):
        ctx, cache_l = kernels(q, k, v, cache_l)
        layer = cache_l[1]
        check = _ulp_rows(torch, f"{engine.cfg.name} layer {layer} attention",
                          ctx[rows, 0], plain_ctx(q, layer)[rows, 0],
                          len(active), lambda bad: f"lengths {lengths}")
        for key in worst:
            worst[key] = max(worst[key], check[key])
        return ctx, cache_l

    def step(attend):
        logits, _ = engine.model.forward_carry(tok[:, None], lens[:, None],
                                               pool, attend)
        return logits[rows, 0].float()

    lk = step(checked_attend)
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
    """Every kernel's launch count, the split-KV combine's included."""
    from aws_k8s_ansible_provisioner_tpu_torch.ops import dense_attention as da
    from aws_k8s_ansible_provisioner_tpu_torch.ops import paged_attention as pa
    from aws_k8s_ansible_provisioner_tpu_torch.ops import split_kv

    return {**pa.launch_counts(), **da.launch_counts(),
            **split_kv.launch_counts()}


def _reset_launches():
    from aws_k8s_ansible_provisioner_tpu_torch.ops import dense_attention as da
    from aws_k8s_ansible_provisioner_tpu_torch.ops import paged_attention as pa
    from aws_k8s_ansible_provisioner_tpu_torch.ops import split_kv

    pa.reset_launch_counts()
    da.reset_launch_counts()
    split_kv.reset_launch_counts()


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
    serving = ServingConfig(spec_decode=True, derived_seed=0,
                            kv_dtype=kv_dtype, paged=paged,
                            decode_bblock=bblock,
                            prefill_chunk=0 if paged else 256)
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
    and accepted drafts > 0 with the self-draft."""
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
                 "cache_write_rows_dense")
        if min(launches[k] for k in dense) <= 0:
            raise AssertionError(f"[draft {name}] a dense kernel never "
                                 f"launched (K4/K7/K8): {launches}")
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
    before = _launches()
    _logits_check(torch, engine, MISTRAL_LOGIT_TOL)
    _profile_dispatch(torch, engine, f"[profile {cfg.name} {kv_dtype}"
                                     f"{'' if paged else ' dense'}]")
    checks = _delta(_launches(), before)
    t2 = time.monotonic()
    engine.run_until_idle()
    torch.cuda.synchronize()
    dt = time.monotonic() - t2 + t1 - t0
    counts = dict(engine.counts)
    n_gen = sum(len(r.generated) for r in reqs)
    if quant:
        _seeded_twice(engine, rng, Request)
    launches = _delta(_launches(), checks)
    log(f"{tag} {len(reqs)} requests, prompts {lens}, {new} new tokens "
        f"each: {n_gen} tokens in {dt:.2f}s ({n_gen / dt:.1f} tok/s end to "
        f"end, {_dispatch_mode(engine)}, the checks' time taken out); "
        f"dispatches {counts}; kernel launches {launches}")
    for r in reqs:
        _finish_ok(cfg, r, new)
    _check_replays(tag, engine, replays0)
    if not paged:
        _check_dense_launches(tag, engine, launches)
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
    if max(launches[k] for k in _kernel_names(not quant)) != 0:
        raise AssertionError(f"{tag} the other pool's kernels launched: "
                             f"{launches}")
    if counts.get("mixed_dispatches", 0) <= 0:
        raise AssertionError(f"{tag} no chunked prefill through mixed_step")
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
    window instances of K4 (rollout) and K7 (catch-up), and K8, > 0;
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
                                 "cache_write_rows_dense")) <= 0:
        raise AssertionError(f"{tag} a dense kernel's window instance never "
                             f"launched: {launches}")
    if accepted <= 0:
        raise AssertionError(f"{tag} no draft token accepted: {counts}")
    del engine
    return launches


# -- sequence-parallel serving (K6 and the log-sum-exp merge) ------------------

# the sp engine runs: Qwen3-0.6B, 4 slots of 32768 rows (8192 rows a shard
# at sp 4), prompts crossing 0 to 3 shard edges at sp 4
SP_SLOTS, SP_WINDOW, SP_CHUNK = 4, 32768, 512
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
    beside its plain version, the library yardstick and its bound."""
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


def _sp_params(torch):
    """Qwen3-0.6B's seeded random weights, quantized to int8 once for every
    sp engine run (as the engine would quantize them)."""
    from aws_k8s_ansible_provisioner_tpu_torch.config import QWEN3_0_6B
    from aws_k8s_ansible_provisioner_tpu_torch.models.layers import init_params
    from aws_k8s_ansible_provisioner_tpu_torch.models.quant import \
        quantize_params

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return quantize_params(init_params(QWEN3_0_6B, gen, torch.bfloat16),
                           QWEN3_0_6B)


def phase_sp_engine(torch, np, params, kv_dtype, sp, profile=True):
    """The sequence-parallel path: Qwen3-0.6B at full width through
    ``Engine(..., mesh=make_mesh(MeshConfig(sp=sp), [cuda:0] * sp))`` (sp 1:
    the dense engine without a mesh, the yardstick of the greedy streams),
    4 slots of 32768 rows, prefill_chunk 512; 4 greedy requests with
    prompts of SP_PROMPTS tokens and SP_NEW new tokens each, launch counts
    zeroed just before and read just after: K6 and the row write (K8; int8:
    K9) each ``L x sp`` times per decode substep and no other attention
    kernel (sp 1: K4 and the row write). With int8 KV a seeded sampled
    request rides along and is drawn again alone afterwards: the same
    stream. The sp 1 run records the top-2 logit gap of every row it
    samples, by (seed, context length). ``profile``: one decode dispatch
    of the 4 slots profiled afterwards. Returns (engine, launches, the
    greedy requests, {(seed, context length): gap} or None)."""
    from aws_k8s_ansible_provisioner_tpu_torch.config import (MeshConfig,
                                                              QWEN3_0_6B,
                                                              ServingConfig)
    from aws_k8s_ansible_provisioner_tpu_torch.ops import dense_attention as da
    from aws_k8s_ansible_provisioner_tpu_torch.parallel.mesh import make_mesh
    from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import (Engine,
                                                                      Request)

    cfg = QWEN3_0_6B
    quant = kv_dtype == "int8"
    serving = ServingConfig(max_decode_slots=SP_SLOTS,
                            max_cache_len=SP_WINDOW, prefill_chunk=SP_CHUNK,
                            paged=False, derived_seed=0, kv_dtype=kv_dtype)
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
    write = "cache_write_rows_quant_dense" if quant \
        else "cache_write_rows_dense"
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

    def recording(logits, temperature, top_k, top_p, seeds, ctrs):
        top2 = torch.topk(logits.float(), 2, dim=-1).values
        for key, gap in zip(zip(seeds.tolist(), ctrs.tolist()),
                            (top2[:, 0] - top2[:, 1]).tolist()):
            gaps[key] = gap
        return sample(logits, temperature, top_k, top_p, seeds, ctrs)

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


def phase_server(engine):
    """The HTTP server over ``engine``. Its tokenizer encodes bytes and
    decodes token ids as their decimal numbers, so that the random-weight
    model's streams (ids far past the byte range) show in the text."""
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
    shards = engine.cache if isinstance(engine.cache, list) \
        else [engine.cache]
    quant = "ks" in shards[0]
    layout = "" if engine.paged else "dense " if len(shards) == 1 \
        else f"sp {len(shards)} "
    tag = f"[server {layout}{'int8' if quant else 'bf16'}]"
    base = f"http://127.0.0.1:{port}"

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
    finally:
        server.shutdown()
        server.server_close()
        state.stop_engine()
        th.join(10)


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


def main() -> int:
    import numpy as np
    import torch

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
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t_start = time.monotonic()
    _phase("build", phase_build)
    kern = _phase("kernels", phase_kernels, torch, np)
    wkern = _phase("kernels, window", phase_kernels_window, torch, np)
    skern = _phase("kernels, sp", phase_kernels_sp, torch, np)
    _phase("sampling", phase_sampling, torch, np)
    runs = {}
    for kv_dtype in ("auto", "int8"):
        t0 = time.monotonic()
        engine, launches = phase_engine(torch, np, kv_dtype)
        phase_profile(torch, np, engine)
        phase_logits(torch, np, engine)
        phase_server(engine)
        if kv_dtype == "int8":
            _phase("pipeline, paged", phase_pipeline, torch, np, engine)
        runs[kv_dtype] = launches
        del engine
        _free(torch)
        log(f"[wall] engine {kv_dtype}: {time.monotonic() - t0:.1f}s")
    for kv_dtype in ("auto", "int8"):
        t0 = time.monotonic()
        engine, launches, _ = phase_spec(torch, np, kv_dtype)
        phase_verify(torch, np, engine)
        runs["spec " + kv_dtype] = launches
        del engine
        _free(torch)
        log(f"[wall] spec {kv_dtype}: {time.monotonic() - t0:.1f}s")
    runs["draft"] = _phase("draft", phase_draft, torch, np)["self"][
        "launches"]
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
    engine, runs["dense spec int8"], _ = phase_spec(torch, np, "int8",
                                                    paged=False, bblock=4)
    del engine
    _free(torch)
    log(f"[wall] dense spec int8: {time.monotonic() - t0:.1f}s")
    for kv_dtype in ("auto", "int8"):
        t0 = time.monotonic()
        engine, runs["mistral " + kv_dtype] = phase_mistral(torch, np,
                                                            kv_dtype)
        phase_server(engine)
        del engine
        _free(torch)
        log(f"[wall] mistral {kv_dtype}: {time.monotonic() - t0:.1f}s")
    runs["mistral spec"] = _phase("mistral spec", phase_mistral_spec, torch,
                                  np)
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
    # sequence-parallel serving: the sp 1 dense engine's greedy streams are
    # the yardstick of the bf16 sp runs; the int8 sp 4 engine serves HTTP
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
    keys = ("max_abs_err", "mean_abs_err", "ms", "device_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    kernels = []
    for name, src, line, res, run in (
            ("paged_attention", ATTN_SRC, 1080, kern["bf16"]["attention"],
             "auto"),
            ("paged_attention_quant", ATTN_SRC, 1014,
             kern["int8"]["attention"], "int8"),
            ("cache_write_rows_paged", WRITE_SRC, 1243, kern["bf16"]["write"],
             "auto"),
            ("cache_write_rows_quant_paged", WRITE_SRC, 1313,
             kern["int8"]["write"], "int8"),
            ("paged_attention_spec", ATTN_SRC, 1169, kern["bf16"]["spec"],
             "spec auto"),
            ("paged_attention_spec_quant", ATTN_SRC, 1169,
             kern["int8"]["spec"], "spec int8"),
            ("decode_attend_dense", DENSE_SRC, 516,
             kern["dense"]["attention"], "draft"),
            ("spec_attend_dense", DENSE_SRC, 675, kern["dense"]["spec"],
             "draft"),
            ("cache_write_rows_dense", WRITE_SRC, 744, kern["dense"]["write"],
             "draft"),
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
            ("cache_write_rows_quant_dense", WRITE_SRC, 823,
             kern["dense int8"]["write"], "dense int8"),
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
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": (f"{TPU_KERNELS}:{line}" if line
                                     else "none (part of K1, K4-K7)"),
                        "launches": runs[run][name],
                        **{k: res[k] for k in keys}})
    # the combine's launches beside those of the attention launches that
    # used it (a launch with more than one split is followed by one combine)
    for run, counts in runs.items():
        users = {k: v for k, v in counts.items()
                 if v and ("attention" in k or "attend" in k)}
        log(f"[split] {run}: split_merge {counts['split_merge']} beside "
            f"{users}")
    log(f"[done] {time.monotonic() - t_start:.1f}s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
