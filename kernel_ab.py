#!/usr/bin/env python3
"""The attention kernels' times, and the engine's decode substep, in several
checkouts of the port, in turns, on one card.

    python3 kernel_ab.py [--engine-only [WORD[,WORD...]] | --sp-only
                          | --only WORD[,WORD...] | --bits] PATH ...

Each PATH is the root of a checkout that holds
``aws_k8s_ansible_provisioner_tpu_torch/``. For each PATH in the order
given, a subprocess builds that checkout's kernels from its ``csrc/`` and
times them through the checkout's own wrappers, at ``chip_smoke.py``'s
shapes (q bf16; each over a bf16 and an int8 pool or cache):

- K1, the paged attention (page 64): Qwen3-0.6B's 32 decode rows with
  lengths up to 2048 over a 28-layer pool, those rows plus a 256-row
  prefill chunk (the ragged entry), and the verify's 32 slots of 5 rows;
  a prefix hit's ragged call (8 decode rows and a 64-row chunk over
  tables that share 24 pages, the pool cut to 68 pages); Mistral-7B's
  window of 4096 over 16 rows with lengths up to 8192 (2 layers): decode,
  ragged (16 + 512 chunk rows) and verify (16 x 5); the decode's row
  writes (K2, K3: 32 rows into the Qwen3 pool) with Qwen3's q/k RMSNorm
  and RoPE before them: the fused kernel (``prep_write_rows_paged``) where
  the checkout has it, else the chain it replaces (the prologue's
  elementwise operations, then the standalone write), eagerly (``write``)
  and as one CUDA graph replay (``write graph``). A ragged case passes
  the chunk layout (``chunk_start``) where the checkout's wrapper takes
  it (its chunk rows then take the chunk body), else it runs the per-row
  body over every row;
- the dense attention over [28, 32, 8, 2048, 128]: K4 (decode, 32 slots),
  K5 (the same at 4 and 8 slots per CTA) and K7 (verify, 32 x 5), and the
  dense decode's row writes (K8, K9: 32 rows) with Qwen3's q/k RMSNorm and
  RoPE before them: the fused kernel (``prep_write_rows_dense``) where the
  checkout has it, else the chain it replaces, eagerly (``write``) and as
  one CUDA graph replay (``write graph``); at the window of 4096 over
  [2, 16, 8, 8192, 128]: K4, K5 (4 and 8 per CTA) and K7; and K6 over the
  busiest shard of the sp 4 cache, [28, 4, 8, 8192, 128] at local lengths
  41, 6034, 8192, 8192.

and the engine's decode dispatch (horizon 8, 8 slots decoding after
100-token prompts, seeded random weights quantized to int8) of seven
engines: Qwen3-0.6B paged with bf16 and int8 KV and dense with int8 KV and
with bf16 KV (4 slots per CTA), Mistral-7B-v0.1 paged with bf16 and int8
KV and dense with int8 KV (4 slots per CTA). For each, the host-clock wall of 12 dispatches each
between two synchronizations (median and mean a substep, and the engine
thread's CPU time), of 12 dispatches back to back (``substep_ms_steady``,
where a pipelined engine overlaps its emits with the next dispatch), and
under torch.profiler of 4 more: the device's busy time a substep, its
idle share (1 - busy / wall) and the device operations (kernels, copies)
a substep; with the checkout's decode graphs, their
capture time and device memory. A checkout without graphs or a pipeline
runs the same cases.
``--engine-only`` times the engines alone: the host's clock varies from
run to run by more than a kernel edit moves it, so give many alternating
runs (A B A B A B A B); ``--engine-only moe`` (words before the paths)
times only the engines whose label holds one of the words, among them
Qwen3-30B-A3B (48 layers, 8 slots, bf16 paged KV, seeded random weights
drawn and quantized to int8 layer by layer as ``chip_smoke.phase_moe``
draws them), which only a word selects; its rows add the grouped expert
kernel's device time a substep. ``--sp-only`` times, the same way, only the
sequence-parallel decode of ``chip_smoke.py``'s sp phase: Qwen3-0.6B dense
over 4 sequence shards on one card (4 slots of 32768 rows after prompts of
40-27,000 tokens, bf16 KV), an eager, synchronous dispatch. ``--only spec,K7`` times only the kernel cases
whose name holds one of the words (here the eight verify instances), and
no engine. ``--only moe`` times the MoE kernels of ``ops/moe.py`` at
``chip_smoke.phase_kernels_moe``'s shapes (one layer of Qwen3-30B-A3B's
experts, bf16 and int8) and ``chip_smoke.MOE_CASES`` (this script's
copy of ``chip_smoke.py``): the route-and-sort and the four grouped
instances (gate + up and down, bf16 and int8), each case with its bound
(``bound_ms``: the touched experts' weights, scales, rows and outputs
once over 3.35 TB/s, or its operations over 989 TFLOP/s) and the device
time of ``torch._grouped_mm`` on bf16 weights (``library_ms``); a
checkout whose ``ops/moe.py`` lacks the kernels is reported as lacking
them. ``--bits`` times nothing: it runs the fused q/k prologue and
row write (paged and dense, bf16 and int8 KV) at Qwen3-0.6B's decode rows
(q/k RMSNorm and RoPE) and Mistral-7B's (RoPE only), head dim 128, on the
same seeded inputs in each checkout, and compares every output (q after
the prologue, every cache leaf and scale) bit for bit with the first
checkout's; it exits non-zero when one differs.

Give two versions as A B B A to compare them within one call. Prints the
card's name and power limit, one JSON line per run, and then a table of
each case's mean per version. Each kernel case has three times (50
launches after 5; needs a CUDA card):

- ``ms``: CUDA events around the back-to-back calls, the yardstick of
  ``chip_smoke.py`` and of every A/B before it; where a wrapper's host time
  exceeds its kernel's device time it times the host;
- ``device_ms``: the same calls queued behind a spinning kernel, so that
  the events time the device's work alone;
- ``host_us``: the host's time per call in that run (the wrapper's Python,
  allocations and launches).

In a checkout with split-KV kernels (``ops/split_kv.py``), a case that
launches the combine is timed again with one split forced
(``ms_1split``, ``device_ms_1split``, ``host_us_1split``): the same kernel
without the workspace and the combine. A decode's split count counts its
rows; a verify's counts its slots (one CTA takes a slot's R x G query rows
of a kv head, ``csrc/split_verify.cuh``), so the verify splits where the
decode of the same slots does.
"""

from __future__ import annotations

import gc
import inspect
import json
import os
import statistics
import subprocess
import sys
import time


def _times(torch, fn, iters=50, warmup=5):
    """(ms, device_ms, host_us) of one call of ``fn`` (see the module
    docstring)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    wall = time.perf_counter() - t0
    ms = start.elapsed_time(end) / iters
    # the spinning kernel (~2e9 cycles a s) outlasts the host's queueing
    torch.cuda._sleep(int(min(2 * wall + 1e-3, 0.05) * 2e9))
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    host = time.perf_counter() - t0
    end.synchronize()
    return ms, start.elapsed_time(end) / iters, 1e6 * host / iters


def _case(torch, ctx, key, fn):
    """Time ``fn`` into ``ctx["out"][key]``; where it launches the split-KV
    combine, also with one split forced. A case that ``ctx["only"]`` does
    not name is skipped."""
    if ctx["only"] and not any(w in key for w in ctx["only"]):
        return
    ms, dev, host = _times(torch, fn)
    row = {"ms": ms, "device_ms": dev, "host_us": host}
    sk = ctx["split_kv"]
    if sk is not None:
        before = sk.split_merge.launches
        fn()
        if sk.split_merge.launches > before:
            count = sk.split_count
            sk.split_count = lambda *args: 1
            try:
                ms, dev, host = _times(torch, fn)
            finally:
                sk.split_count = count
            row.update(ms_1split=ms, device_ms_1split=dev,
                       host_us_1split=host)
    ctx["out"][key] = row


def _kv(torch, gen, shape, quant):
    """Random K and V (bf16, or int8) and, int8, their float32 scales."""
    dev = gen.device
    if not quant:
        return [torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.bfloat16) for _ in range(2)]
    return ([torch.randint(-127, 128, shape, generator=gen, device=dev,
                           dtype=torch.int8) for _ in range(2)]
            + [torch.rand(shape[:-1], generator=gen, device=dev) * 0.02
               + 1e-3 for _ in range(2)])


def _attention_call(pa, q, kv, lim, layer, tab, window, chunk_start):
    """K1 over ``kv`` (bf16 K/V, or int8 with scales); ``chunk_start``: the
    rows from there on are one prefill chunk (the ragged entry's chunk
    layout), passed where the checkout's wrapper takes it."""
    fn = pa.paged_attention_quant if len(kv) == 4 else pa.paged_attention
    kw = {}
    if chunk_start is not None and \
            "chunk_start" in inspect.signature(fn).parameters:
        kw["chunk_start"] = chunk_start
    return lambda: fn(q, *kv, lim, layer, tab, window, **kw)


def _prefix_hit(torch, np, pa, ctx):
    """K1's ragged entry at a prefix hit (chip_smoke.phase_prefix's
    shared-table check): Qwen3-0.6B's pool cut to 68 pages, 8 decode rows
    at 1,600 columns whose tables share their first 24 pages (a 1,536-token
    history) and hold one page of their own, then one tail's 64 chunk rows
    at limits 1,537 .. 1,600 on the first row's table."""
    L, hq, Hkv, ps, D, P, width = 28, 16, 8, 64, 128, 68, 32
    B, shared, C = 8, 24, 64
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    table = np.zeros((B, width), np.int32)
    table[:, :shared] = np.arange(1, shared + 1)
    table[:, shared] = shared + 1 + np.arange(B)
    limits = np.concatenate([np.full(B, shared * ps + C),
                             shared * ps + 1 + np.arange(C)]).astype(np.int32)
    tables = np.concatenate([table, np.repeat(table[:1], C, 0)])
    lim = torch.from_numpy(limits).to(dev)
    tab = torch.from_numpy(tables).to(dev)
    q = torch.randn((B + C, hq, D), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    for pool in ("bf16", "int8"):
        kv = _kv(torch, gen, (L, P, Hkv, ps, D), pool == "int8")
        _case(torch, ctx, f"{pool} ragged prefix {B}+{C}",
              _attention_call(pa, q, kv, lim, L - 1, tab, 0, B))
        del kv
        torch.cuda.empty_cache()


def _graph(torch, fn):
    """``fn`` captured as a CUDA graph after warm-up calls on a side
    stream; returns the graph's replay."""
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


def _prep_write_call(torch, pa, gen, kv, hq, rows, layer, table):
    """Qwen3's q/k RMSNorm and RoPE of a layer's raw q and k rows, then the
    row write of k and v (K2, or K3 when ``kv`` has scales): the fused
    kernel where the checkout has it (``prep_write_rows_paged``), else the
    chain it replaces (``models/layers``'s rms_norm and apply_rope, then the
    standalone write)."""
    from aws_k8s_ansible_provisioner_tpu_torch.models import layers

    N, Hkv, D = rows.shape[0], kv[0].shape[2], kv[0].shape[4]
    dev = gen.device
    q = torch.randn((N, hq, D), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    k, v = _kv(torch, gen, (N, Hkv, D), False)
    w = (1 + 0.1 * torch.randn(D, generator=gen, device=dev)).to(
        torch.bfloat16)
    cos, sin = (t.contiguous() for t in layers.rope_cos_sin(
        torch.randint(0, 2048, (N,), generator=gen, device=dev), D, 1e6))
    quant = len(kv) == 4
    if hasattr(pa, "prep_write_rows_paged"):
        fn = pa.prep_write_rows_quant_paged if quant \
            else pa.prep_write_rows_paged
        prep = layers.QKPrep(w, w, 1e-6, cos, sin)
        return lambda: fn(*kv, q, k, v, rows, layer, table, prep)
    write = pa.cache_write_rows_quant_paged if quant \
        else pa.cache_write_rows_paged

    def chain():
        qp = layers.apply_rope(layers.rms_norm(q, w, 1e-6), cos, sin)
        kp = layers.apply_rope(layers.rms_norm(k, w, 1e-6), cos, sin)
        write(*kv, kp, v, rows, layer, table)
        return qp

    return chain


def _dense_prep_write_call(torch, da, gen, kv, hq, rows, layer):
    """The dense cache's counterpart of :func:`_prep_write_call`: Qwen3's
    q/k prologue of one row per slot, then the dense row write (K8, or K9
    when ``kv`` has scales): the fused kernel where the checkout has it
    (``prep_write_rows_dense``), else the prologue's chain and the
    standalone write."""
    from aws_k8s_ansible_provisioner_tpu_torch.models import layers

    B, Hkv, D = kv[0].shape[1], kv[0].shape[2], kv[0].shape[4]
    dev = gen.device
    q = torch.randn((B, 1, hq, D), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    k, v = _kv(torch, gen, (B, 1, Hkv, D), False)
    w = (1 + 0.1 * torch.randn(D, generator=gen, device=dev)).to(
        torch.bfloat16)
    cos, sin = (t.contiguous() for t in layers.rope_cos_sin(
        rows.long(), D, 1e6))
    quant = len(kv) == 4
    if hasattr(da, "prep_write_rows_dense"):
        fn = da.prep_write_rows_quant_dense if quant \
            else da.prep_write_rows_dense
        prep = layers.QKPrep(w, w, 1e-6, cos, sin)
        return lambda: fn(*kv, q, k, v, rows, layer, prep)
    write = da.cache_write_rows_quant_dense if quant \
        else da.cache_write_rows_dense

    def chain():
        qp = layers.apply_rope(layers.rms_norm(q, w, 1e-6), cos, sin)
        kp = layers.apply_rope(layers.rms_norm(k, w, 1e-6), cos, sin)
        write(*kv, kp, v, rows, layer)
        return qp

    return chain


def _paged(torch, np, pa, ctx, tag, L, hq, B, S, window, lengths, table,
           chunk, spec_len):
    """K1 decode, ragged and verify over a bf16 and an int8 pool."""
    Hkv, ps, D = 8, 64, 128
    max_pages = S // ps
    P = B * max_pages + 1
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    pslot, pstart, C = chunk
    limits = np.concatenate([lengths, pstart + np.arange(C) + 1])
    limits[pslot] = 0
    tables = np.concatenate([table, np.repeat(table[pslot][None], C, 0)])
    q = torch.randn((B + C, hq, D), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    q5 = torch.randn((B, 5, hq, D), generator=gen, device=dev,
                     dtype=torch.bfloat16)

    def t32(a):
        return torch.from_numpy(np.ascontiguousarray(a).astype(np.int32)) \
            .to(dev)

    cases = {"decode": (t32(lengths), t32(table), None),
             "ragged": (t32(limits), t32(tables), B)}
    for pool in ("bf16", "int8"):
        kv = _kv(torch, gen, (L, P, Hkv, ps, D), pool == "int8")
        for case, (lim, tab, chunk_start) in cases.items():
            _case(torch, ctx, f"{tag}{pool} {case}",
                  _attention_call(pa, q[:len(lim)].contiguous(), kv, lim,
                                  L - 1, tab, window, chunk_start))
        if not window:
            # the decode's q/k prologue and row write (K2, K3) at the
            # decode rows' lengths, eagerly and as one graph replay
            fn = _prep_write_call(torch, pa, gen, kv, hq, t32(lengths - 1),
                                  L - 1, cases["decode"][1])
            _case(torch, ctx, f"{tag}{pool} write", fn)
            _case(torch, ctx, f"{tag}{pool} write graph", _graph(torch, fn))
        lens, tab = t32(spec_len), t32(table)
        if pool == "bf16":
            def fn():
                return pa.paged_attention_spec(q5, *kv, lens, L - 1, tab,
                                               window)
        else:
            def fn():
                return pa.paged_attention_spec_quant(q5, *kv, lens, L - 1,
                                                     tab, window)
        _case(torch, ctx, f"{tag}{pool} spec", fn)
        del kv
        torch.cuda.empty_cache()


def _dense(torch, np, da, ctx, tag, L, hq, B, S, window, lengths, spec_len,
           bbs):
    """K4, K5 at each of ``bbs`` slots per CTA and K7 over a bf16 and an
    int8 dense cache."""
    Hkv, D = 8, 128
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    q = torch.randn((B, 1, hq, D), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    q5 = torch.randn((B, 5, hq, D), generator=gen, device=dev,
                     dtype=torch.bfloat16)
    lens = torch.from_numpy(lengths.astype(np.int32)).to(dev)
    slen = torch.from_numpy(spec_len.astype(np.int32)).to(dev)
    for cache in ("bf16", "int8"):
        kv = _kv(torch, gen, (L, B, Hkv, S, D), cache == "int8")
        scales = kv[2:]
        for bb in (1,) + bbs:
            name = "K4" if bb == 1 else f"K5 bb{bb}"
            _case(torch, ctx, f"{tag}{cache} {name}",
                  lambda bb=bb: da.decode_attend_dense(
                      q, kv[0], kv[1], lens, L - 1, window, *scales,
                      bblock=bb))
        _case(torch, ctx, f"{tag}{cache} K7",
              lambda: da.spec_attend_dense(q5, kv[0], kv[1], slen, L - 1,
                                           window, *scales))
        if not window:
            # the decode's q/k prologue and row write (K8, K9) at the
            # slots' lengths, eagerly and as one graph replay
            rows = (lens - 1).clamp_min(0)[:, None].contiguous()
            fn = _dense_prep_write_call(torch, da, gen, kv, hq, rows, L - 1)
            _case(torch, ctx, f"{tag}{cache} write", fn)
            _case(torch, ctx, f"{tag}{cache} write graph", _graph(torch, fn))
        del kv
        torch.cuda.empty_cache()


def _k6(torch, np, da, ctx):
    """K6 over the busiest shard of the sp 4 engine's cache."""
    L, B, Hkv, S, D, hq = 28, 4, 8, 8192, 128, 16
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(29)
    q = torch.randn((B, 1, hq, D), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    local = torch.tensor([41, 6034, 8192, 8192], dtype=torch.int32,
                         device=dev)
    for cache in ("bf16", "int8"):
        kv = _kv(torch, gen, (L, B, Hkv, S, D), cache == "int8")
        _case(torch, ctx, f"{cache} K6",
              lambda: da.decode_attend_dense_stats(
                  q, kv[0], kv[1], local, L - 1, *kv[2:]))
        del kv
        torch.cuda.empty_cache()


# the engine dispatches of ``--engine-only``: (label, model, kv_dtype,
# paged, decode_bblock)
ENGINES = (("qwen3 paged bf16", "qwen3", "auto", True, 0),
           ("qwen3 paged int8", "qwen3", "int8", True, 0),
           ("qwen3 dense int8", "qwen3", "int8", False, 0),
           ("qwen3 dense bf16", "qwen3", "auto", False, 4),
           ("mistral paged bf16", "mistral", "auto", True, 0),
           ("mistral paged int8", "mistral", "int8", True, 0),
           ("mistral dense int8", "mistral", "int8", False, 4))


# the Qwen3-30B-A3B engine, timed only when a word of ``--engine-only``
# names it
MOE_ENGINES = (("moe qwen3-30b-a3b paged bf16", "moe", "auto", True, 0),)


def _build_engine(torch, model, kv_dtype, paged, bblock):
    """Qwen3-0.6B (32 slots x 2048, prefill_chunk 256) or Mistral-7B-v0.1
    (16 slots x 8192, prefill_chunk 512), seeded random weights quantized
    to int8, through the checkout's ``Engine`` with its default
    ServingConfig otherwise (a parent without the pipeline takes the same
    arguments)."""
    from aws_k8s_ansible_provisioner_tpu_torch import config
    from aws_k8s_ansible_provisioner_tpu_torch.models.layers import init_params
    from aws_k8s_ansible_provisioner_tpu_torch.models.quant import \
        quantize_params
    from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import Engine

    if model == "moe":
        cfg = config.QWEN3_30B_A3B
        serving = config.ServingConfig(
            model=cfg.name, max_decode_slots=8, prefill_chunk=256,
            derived_seed=0, kv_dtype=kv_dtype, paged=paged,
            decode_bblock=bblock)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        params = init_params(cfg, gen, torch.bfloat16, quantize=True)
        return Engine(cfg, params, serving, device="cuda")
    if model == "qwen3":
        cfg = config.QWEN3_0_6B
        serving = config.ServingConfig(prefill_chunk=256, derived_seed=0,
                                       kv_dtype=kv_dtype, paged=paged,
                                       decode_bblock=bblock)
    else:
        cfg = config.MISTRAL_7B_V01
        serving = config.ServingConfig(
            model=cfg.name, max_decode_slots=16, max_cache_len=8192,
            prefill_chunk=512, derived_seed=0, kv_dtype=kv_dtype,
            paged=paged, decode_bblock=bblock)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = quantize_params(init_params(cfg, gen, torch.bfloat16), cfg)
    return Engine(cfg, params, serving, device="cuda")


def _engine(torch, np, out, label, model, kv_dtype, paged, bblock):
    """One engine's decode dispatch with 8 slots decoding after 100-token
    prompts (:func:`_time_decode`)."""
    t0 = time.perf_counter()
    engine = _build_engine(torch, model, kv_dtype, paged, bblock)
    torch.cuda.synchronize()
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, engine.cfg.vocab_size, 100).tolist()
               for _ in range(8)]
    _time_decode(torch, out, label, engine, time.perf_counter() - t0,
                 prompts, 400)
    del engine
    gc.collect()
    torch.cuda.empty_cache()


# the sequence-parallel engine of ``--sp-only`` (chip_smoke.phase_sp_engine):
# slots, rows a slot, prefill chunk, prompt lengths
SP_SLOTS, SP_WINDOW, SP_CHUNK = 4, 32768, 512
SP_PROMPTS = (40, 6000, 14000, 27000)


def _sp_engine(torch, np, out, kv_dtype, sp):
    """The sequence-parallel decode dispatch: Qwen3-0.6B (seeded random
    weights quantized to int8) through ``Engine(..., mesh=make_mesh(
    MeshConfig(sp=sp), [cuda:0] * sp))``, 4 dense slots of 32768 rows, all
    shards on one card, decoding after prompts of SP_PROMPTS tokens, as
    ``chip_smoke.py``'s sp phase runs it (:func:`_time_decode`)."""
    from aws_k8s_ansible_provisioner_tpu_torch import config
    from aws_k8s_ansible_provisioner_tpu_torch.models.layers import init_params
    from aws_k8s_ansible_provisioner_tpu_torch.models.quant import \
        quantize_params
    from aws_k8s_ansible_provisioner_tpu_torch.parallel.mesh import make_mesh
    from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import Engine

    t0 = time.perf_counter()
    cfg = config.QWEN3_0_6B
    serving = config.ServingConfig(
        max_decode_slots=SP_SLOTS, max_cache_len=SP_WINDOW,
        prefill_chunk=SP_CHUNK, paged=False, derived_seed=0,
        kv_dtype=kv_dtype, prefix_cache=False)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = quantize_params(init_params(cfg, gen, torch.bfloat16), cfg)
    mesh = make_mesh(config.MeshConfig(sp=sp), [torch.device("cuda", 0)] * sp)
    engine = Engine(cfg, params, serving, device="cuda", mesh=mesh)
    torch.cuda.synchronize()
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in SP_PROMPTS]
    # every slot stays active through the prefills and the timed dispatches
    _time_decode(torch, out, f"qwen3 sp {sp} {kv_dtype}", engine,
                 time.perf_counter() - t0, prompts,
                 SP_WINDOW - max(SP_PROMPTS) - 1)


def _time_decode(torch, out, label, engine, setup_s, prompts, max_tokens):
    """Submit ``prompts`` (greedy, ``max_tokens`` each) and step the engine
    until every one is admitted; then the host-clock wall of 12 decode
    dispatches (after 2), each between two synchronizations, per substep
    (median, mean, and the engine thread's CPU time); 12 dispatches back to
    back with one synchronization at the end (``substep_ms_steady``: a
    pipelined engine overlaps one dispatch's emits with the next one's
    device work there); and 4 dispatches back to back under torch.profiler
    (CUDA activity only): the device's busy time a substep, its idle share
    over that window and the device operations (kernels, copies; a graph's
    nodes) a substep. Into ``out["engine " + label]``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import Request

    for p in prompts:
        engine.submit(Request(prompt_ids=p, max_tokens=max_tokens,
                              ignore_eos=True))
    while engine.pending or engine._chunk is not None:
        engine.step()
    horizon = engine.serving.decode_horizon
    walls, cpus = [], []
    for i in range(14):
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), time.thread_time()
        engine.step()
        torch.cuda.synchronize()
        if i >= 2:
            walls.append(1e3 * (time.perf_counter() - t0))
            cpus.append(1e3 * (time.thread_time() - c0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(12):
        engine.step()
    torch.cuda.synchronize()
    steady = 1e3 * (time.perf_counter() - t0) / (12 * horizon)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(4):
            engine.step()
        torch.cuda.synchronize()
        prof_ms = 1e3 * (time.perf_counter() - t0)
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    ops = sum(e.count for e in events if e.self_device_time_total > 0)
    grouped = sum(e.self_device_time_total for e in events
                  if "grouped_kernel" in e.key) / 1e3
    # the row write's device time a launch (a graph node under a replay)
    writes = [e for e in events if "cache_write" in e.key and e.count]
    write_us = (sum(e.self_device_time_total for e in writes)
                / sum(e.count for e in writes)) if writes else float("nan")
    dec = getattr(engine, "decoder", None)
    out[f"engine {label}"] = {
        "substep_ms_median": statistics.median(walls) / horizon,
        "substep_ms_mean": statistics.mean(walls) / horizon,
        "substep_cpu_ms_median": statistics.median(cpus) / horizon,
        "substep_ms_steady": steady,
        "busy_ms_per_substep": busy / (4 * horizon),
        "device_ops_per_substep": ops / (4 * horizon),
        "idle_share": 1 - busy / prof_ms if busy else float("nan"),
        "row_write_us": write_us,
        "grouped_ms_per_substep": grouped / (4 * horizon),
        "setup_s": setup_s,
        "capture_s": dec.capture_s if dec is not None else 0.0,
        "graph_pool_mib": dec.pool_bytes / 2**20 if dec is not None
        else 0.0}


def _bits(torch, pa, da, out_file: str) -> int:
    """The fused writes' outputs on seeded inputs (see ``--bits``), saved to
    ``out_file``; returns their count."""
    from aws_k8s_ansible_provisioner_tpu_torch.models import layers

    res = {}
    for name, hq, hkv, norm, theta in (("qwen3", 16, 8, True, 1e6),
                                       ("mistral", 32, 8, False, 1e4)):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(7)
        D, N, ps, maxp, L, B, R = 128, 40, 64, 32, 2, 8, 5

        def randn(*shape, scale=1.0):
            return (scale * torch.randn(shape, generator=gen,
                                        device="cuda")).bfloat16()

        q, k, v = randn(N, hq, D, scale=3.0), randn(N, hkv, D, scale=3.0), \
            randn(N, hkv, D)
        w = tuple((1 + 0.1 * randn(D).float()).bfloat16()
                  for _ in range(2)) if norm else (None, None)
        pos = torch.randint(0, 2000, (N,), generator=gen, device="cuda")
        cos, sin = layers.rope_cos_sin(pos, D, theta)
        rows = pos.to(torch.int32)
        table = (torch.randperm(N * maxp, generator=gen, device="cuda")
                 .to(torch.int32) + 1).reshape(N, maxp)
        for quant in (False, True):
            def leaves(shape):
                if not quant:
                    return [torch.zeros(shape, dtype=torch.bfloat16,
                                        device="cuda") for _ in range(2)]
                return ([torch.zeros(shape, dtype=torch.int8, device="cuda")
                         for _ in range(2)]
                        + [torch.zeros(shape[:-1], device="cuda")
                           for _ in range(2)])

            kind = "int8" if quant else "bf16"
            pool = leaves((L, N * maxp + 1, hkv, ps, D))
            fn = pa.prep_write_rows_quant_paged if quant \
                else pa.prep_write_rows_paged
            res[f"{name} paged {kind} q"] = fn(
                *pool, q, k, v, rows, 1, table,
                layers.QKPrep(*w, 1e-6, cos.contiguous(), sin.contiguous()))
            cache = leaves((L, B, hkv, 2048, D))
            fn = da.prep_write_rows_quant_dense if quant \
                else da.prep_write_rows_dense
            res[f"{name} dense {kind} q"] = fn(
                *cache, *(x.reshape(B, R, *x.shape[1:]) for x in (q, k, v)),
                rows.reshape(B, R).contiguous(), 1,
                layers.QKPrep(*w, 1e-6, cos.reshape(B, R, D).contiguous(),
                              sin.reshape(B, R, D).contiguous()))
            for i, leaf in enumerate(pool + cache):
                res[f"{name} {kind} leaf {i}"] = leaf
    torch.save({k: v.cpu() for k, v in res.items()}, out_file)
    return len(res)


def _same_bits(torch, a, b) -> bool:
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32}
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.view(ints[a.element_size()]), b.view(ints[b.element_size()]))


def _chip_smoke():
    """This script's ``chip_smoke.py`` (the MoE cases and helpers), whatever
    checkout is first on the path."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "kernel_ab_chip_smoke",
        os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _moe(torch, np, ctx):
    """The MoE kernels of the checkout (see ``--only moe``)."""
    import importlib

    moe = importlib.import_module(
        "aws_k8s_ansible_provisioner_tpu_torch.ops.moe")
    if not all(hasattr(moe, f) for f in ("route_sort", "grouped_gate_up",
                                         "grouped_matmul")):
        ctx["out"]["moe"] = {"lacking": 1.0}
        return
    from aws_k8s_ansible_provisioner_tpu_torch.config import QWEN3_30B_A3B
    from aws_k8s_ansible_provisioner_tpu_torch.models.quant import \
        quant_kernel_chunked

    cs = _chip_smoke()
    cfg = QWEN3_30B_A3B
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
        q, sc = quant_kernel_chunked(w, 1)
        layer["int8"][name] = {"kernel": q, "scale": sc}
    gate_up_bf16 = torch.cat([layer["bf16"]["w_gate"]["kernel"],
                              layer["bf16"]["w_up"]["kernel"]], -1)

    def extra(key, nbytes, ops, lib):
        row = ctx["out"].get(key)
        if row is None:
            return
        t_bytes, t_ops = nbytes / 3.35e12, ops / 989e12
        row["bound_ms"] = 1e3 * max(t_bytes, t_ops)
        row["library_ms"] = _times(torch, lib)[1] if lib else float("nan")

    for i, (case, n) in enumerate(cs.MOE_CASES):
        logits = cs._moe_logits(torch, np, case, n, 210 + i, E, k)
        r = moe.route_sort(logits, k, True, torch.bfloat16)
        counts = (r.offsets[1:] - r.offsets[:-1]).cpu()
        touched = int((counts > 0).sum())
        m = n * k
        key = f"moe route_sort {case}"
        _case(torch, ctx, key, lambda: moe.route_sort(logits, k, True,
                                                      torch.bfloat16))
        extra(key, n * E * 4 + m * 18 + (E + 1) * 4, 0, None)
        x = torch.randn((n, H), generator=gen, device="cuda").bfloat16()
        xs = x.index_select(0, r.row_token)
        a = moe.grouped_gate_up_plain(x, layer["bf16"]["w_gate"],
                                      layer["bf16"]["w_up"], r.offsets,
                                      r.row_token)
        lib_up, _ = cs._grouped_library(torch, xs, gate_up_bf16, r.offsets)
        lib_down, _ = cs._grouped_library(torch, a,
                                          layer["bf16"]["w_down"]["kernel"],
                                          r.offsets)
        for quant in (False, True):
            p = layer["int8" if quant else "bf16"]
            wb, kind = (1, "int8") if quant else (2, "bf16")
            for inst, fn, width, kin, nw, lib in (
                    ("gate_up", lambda: moe.grouped_gate_up(
                        x, p["w_gate"], p["w_up"], r.offsets, r.row_token),
                     I, H, 2, lib_up),
                    ("down", lambda: moe.grouped_matmul(
                        a, p["w_down"], r.offsets), H, I, 1, lib_down)):
                key = f"moe {kind} {inst} {case}"
                _case(torch, ctx, key, fn)
                nbytes = (touched * kin * width * wb * nw
                          + (touched * width * 4 * nw if quant else 0)
                          + (n * H * 2 if inst == "gate_up" else m * I * 2)
                          + m * 4 + (E + 1) * 4 + m * width * 2)
                extra(key, nbytes, 2.0 * m * kin * width * nw, lib)
        del a, xs, x
        torch.cuda.empty_cache()


def one(path: str, engine_only: bool = False, only=(),
        sp_only: bool = False, bits: str = "", engines=()) -> dict:
    """Times of the checkout at ``path`` (run in its own process); with
    ``engine_only`` the engine's substeps alone (``engines``: words, the
    engines whose label holds one of them); with ``only`` (words) the
    kernel cases named by one of them alone; with ``sp_only`` the sp 4
    engine's substeps (bf16 KV) alone."""
    sys.path.insert(0, path)
    import importlib.util

    import numpy as np
    import torch

    from aws_k8s_ansible_provisioner_tpu_torch.ops import cuda_build
    from aws_k8s_ansible_provisioner_tpu_torch.ops import dense_attention as da
    from aws_k8s_ansible_provisioner_tpu_torch.ops import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_build.build_kernels()
    out = {"path": path}
    if bits:
        out["bits"] = {"file": bits, "outputs": _bits(torch, pa, da, bits)}
        return out
    ctx = {"out": out, "split_kv": None, "only": only}
    if importlib.util.find_spec(
            "aws_k8s_ansible_provisioner_tpu_torch.ops.split_kv"):
        from aws_k8s_ansible_provisioner_tpu_torch.ops import split_kv
        ctx["split_kv"] = split_kv
    if sp_only:
        _sp_engine(torch, np, out, "auto", 4)
        return out
    if not engine_only:
        if not only or any(w != "moe" for w in only):
            _kernels(torch, np, da, pa, ctx)
        if any("moe" in w for w in only):
            _moe(torch, np, ctx)
    chosen = [c for c in ENGINES + MOE_ENGINES
              if any(w in c[0] for w in engines)] if engines else ENGINES
    for case in chosen if not only else ():
        _engine(torch, np, out, *case)
    return out


def _kernels(torch, np, da, pa, ctx):
    """Every kernel case, into ``ctx["out"]``."""
    # Qwen3-0.6B (chip_smoke.phase_kernels, _dense_cases)
    rng = np.random.default_rng(5)
    B, S = 32, 2048
    table = (rng.permutation(B * (S // 64)) + 1).reshape(B, S // 64)
    lengths = rng.integers(1, S + 1, B)
    lengths[:6] = [1, 64, 65, S, S - 1, 128]
    spec_len = np.minimum(lengths, S - 5)
    spec_len[:4] = [0, 59, 60, S - 5]
    _paged(torch, np, pa, ctx, "", 28, 16, B, S, 0, lengths, table,
           (3, 512, 256), spec_len)
    _prefix_hit(torch, np, pa, ctx)
    rng = np.random.default_rng(8)
    dense_len = rng.integers(1, S + 1, B)
    dense_len[:6] = [0, 1, 64, 65, S, S - 1]
    spec_len = np.minimum(dense_len, S - 5)
    spec_len[:4] = [0, 59, 60, S - 5]
    _dense(torch, np, da, ctx, "dense ", 28, 16, B, S, 0, dense_len,
           spec_len, (4, 8))
    # Mistral-7B-v0.1, window 4096 (chip_smoke.phase_kernels_window)
    B, S, W = 16, 8192, 4096
    rng = np.random.default_rng(34)
    table = (rng.permutation(B * (S // 64)) + 1).reshape(B, S // 64)
    lengths = rng.integers(W + 1, S + 1, B)
    lengths[:8] = [1, 64, W, W + 1, W + 64, W + 65, S, S - 1]
    spec_len = np.minimum(lengths, S - 5)
    spec_len[:4] = [0, W - 2, W + 61, S - 5]
    _paged(torch, np, pa, ctx, "window ", 2, 32, B, S, W, lengths, table,
           (3, S - 512, 512), spec_len)
    dense_len = lengths.copy()
    dense_len[0] = 0
    _dense(torch, np, da, ctx, "window dense ", 2, 32, B, S, W, dense_len,
           spec_len, (4, 8))
    _k6(torch, np, da, ctx)


def _table(runs: list) -> None:
    """Each case's mean over the runs of each checkout, in the order the
    checkouts were first given."""
    paths = list(dict.fromkeys(r["path"] for r in runs))
    print("case | metric | " + " | ".join(paths))
    keys = dict.fromkeys(k for r in runs for k in r if k != "path")
    for key in keys:
        for metric in dict.fromkeys(m for r in runs for m in r.get(key, {})):
            means = []
            for p in paths:
                vals = [r[key][metric] for r in runs
                        if r["path"] == p and metric in r.get(key, {})]
                means.append(f"{statistics.mean(vals):.4f}" if vals else "-")
            print(f"{key} | {metric} | " + " | ".join(means))


def main() -> int:
    args = sys.argv[1:]
    one_path = None
    if args[:1] == ["--one"]:
        one_path, args = args[1], args[2:]
    engine_only = args[:1] == ["--engine-only"]
    sp_only = args[:1] == ["--sp-only"]
    bits = args[:1] == ["--bits"]
    only, engines = (), ()
    if args[:1] == ["--only"] and len(args) > 1:
        only = tuple(args[1].split(","))
    # words after --engine-only (not a checkout's directory) pick engines
    if engine_only and len(args) > 1 and not os.path.isdir(args[1]):
        engines = tuple(args[1].split(","))
    flags = args[:2] if only or engines else \
        args[:1] if engine_only or sp_only or bits else []
    if one_path is not None:
        bits_file = args[1] if bits else ""
        print(json.dumps(one(one_path, engine_only, only, sp_only,
                             bits_file, engines)))
        return 0
    paths = args[len(flags):]
    if not paths:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() if smi.returncode == 0
          else f"nvidia-smi failed ({smi.returncode})")
    if bits:
        return _compare_bits(paths)
    runs = []
    for path in paths:
        run = subprocess.run([sys.executable, __file__, "--one", path]
                             + flags, capture_output=True, text=True,
                             timeout=900)
        if run.returncode != 0:
            print(run.stderr[-4000:], file=sys.stderr)
            return run.returncode
        line = run.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    _table(runs)
    return 0


def _compare_bits(paths) -> int:
    """``--bits``: each checkout's outputs (in its own process) against the
    first checkout's, bit for bit."""
    import tempfile

    import torch

    files = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, path in enumerate(paths):
            out = f"{tmp}/bits{i}.pt"
            run = subprocess.run([sys.executable, __file__, "--one", path,
                                  "--bits", out], capture_output=True,
                                 text=True, timeout=900)
            if run.returncode != 0:
                print(run.stderr[-4000:], file=sys.stderr)
                return run.returncode
            files.append(torch.load(out))
        bad = 0
        for path, got in zip(paths[1:], files[1:]):
            differ = [k for k in files[0]
                      if k not in got or not _same_bits(torch, files[0][k],
                                                         got[k])]
            bad += len(differ)
            print(f"[bits] {path} against {paths[0]}: {len(files[0])} "
                  f"outputs, {len(differ)} differ {differ}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
