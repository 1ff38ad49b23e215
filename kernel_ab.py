#!/usr/bin/env python3
"""The attention kernels' times, and the engine's decode substep, in several
checkouts of the port, in turns, on one card.

    python3 kernel_ab.py [--engine-only | --only WORD[,WORD...]] PATH ...

Each PATH is the root of a checkout that holds
``aws_k8s_ansible_provisioner_tpu_torch/``. For each PATH in the order
given, a subprocess builds that checkout's kernels from its ``csrc/`` and
times them through the checkout's own wrappers, at ``chip_smoke.py``'s
shapes (q bf16; each over a bf16 and an int8 pool or cache):

- K1, the paged attention (page 64): Qwen3-0.6B's 32 decode rows with
  lengths up to 2048 over a 28-layer pool, those rows plus a 256-row
  prefill chunk (the ragged entry), and the verify's 32 slots of 5 rows;
  Mistral-7B's window of 4096 over 16 rows with lengths up to 8192 (2
  layers): decode, ragged (16 + 512 chunk rows) and verify (16 x 5);
- the dense attention over [28, 32, 8, 2048, 128]: K4 (decode, 32 slots),
  K5 (the same at 4 and 8 slots per CTA) and K7 (verify, 32 x 5); at the
  window of 4096 over [2, 16, 8, 8192, 128]: K4, K5 (4 and 8 per CTA) and
  K7; and K6 over the busiest shard of the sp 4 cache, [28, 4, 8, 8192,
  128] at local lengths 41, 6034, 8192, 8192.

and the engine's decode dispatch (horizon 8, 8 slots decoding after
100-token prompts, seeded random weights quantized to int8) of six
engines: Qwen3-0.6B paged with bf16 and int8 KV and dense with int8 KV,
Mistral-7B-v0.1 paged with bf16 and int8 KV and dense with int8 KV (4
slots per CTA). For each, the host-clock wall of 12 dispatches each
between two synchronizations (median and mean a substep, and the engine
thread's CPU time), of 12 dispatches back to back (``substep_ms_steady``,
where a pipelined engine overlaps its emits with the next dispatch), and
under torch.profiler of 4 more: the device's busy time a substep and its
idle share (1 - busy / wall); with the checkout's decode graphs, their
capture time and device memory. A checkout without graphs or a pipeline
runs the same cases.
``--engine-only`` times the engines alone: the host's clock varies from
run to run by more than a kernel edit moves it, so give many alternating
runs (A B A B A B A B). ``--only spec,K7`` times only the kernel cases
whose name holds one of the words (here the eight verify instances), and
no engine.

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
import json
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

    cases = {"decode": (t32(lengths), t32(table)),
             "ragged": (t32(limits), t32(tables))}
    for pool in ("bf16", "int8"):
        kv = _kv(torch, gen, (L, P, Hkv, ps, D), pool == "int8")
        for case, (lim, tab) in cases.items():
            qn = q[:len(lim)].contiguous()
            if pool == "bf16":
                def fn():
                    return pa.paged_attention(qn, *kv, lim, L - 1, tab,
                                              window)
            else:
                def fn():
                    return pa.paged_attention_quant(qn, *kv, lim, L - 1, tab,
                                                    window)
            _case(torch, ctx, f"{tag}{pool} {case}", fn)
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
           ("mistral paged bf16", "mistral", "auto", True, 0),
           ("mistral paged int8", "mistral", "int8", True, 0),
           ("mistral dense int8", "mistral", "int8", False, 4))


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
    """One engine dispatch: 8 slots decoding after 100-token prompts, then
    the host-clock wall of 12 decode dispatches (after 2), each between two
    synchronizations, per substep (median, mean, and the engine thread's
    CPU time); 12 dispatches back to back with one synchronization at the
    end (``substep_ms_steady``: a pipelined engine overlaps one dispatch's
    emits with the next one's device work there); and 4 dispatches back to
    back under torch.profiler (CUDA activity only): the device's busy time
    a substep and its idle share over that window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import Request

    t0 = time.perf_counter()
    engine = _build_engine(torch, model, kv_dtype, paged, bblock)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(4)
    for _ in range(8):
        engine.submit(Request(prompt_ids=rng.integers(
            0, engine.cfg.vocab_size, 100).tolist(), max_tokens=400,
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
        "idle_share": 1 - busy / prof_ms if busy else float("nan"),
        "row_write_us": write_us,
        "setup_s": setup_s,
        "capture_s": dec.capture_s if dec is not None else 0.0,
        "graph_pool_mib": dec.pool_bytes / 2**20 if dec is not None
        else 0.0}
    del engine
    gc.collect()
    torch.cuda.empty_cache()


def one(path: str, engine_only: bool = False, only=()) -> dict:
    """Times of the checkout at ``path`` (run in its own process); with
    ``engine_only`` the engine's substeps alone; with ``only`` (words) the
    kernel cases named by one of them alone."""
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
    ctx = {"out": out, "split_kv": None, "only": only}
    if importlib.util.find_spec(
            "aws_k8s_ansible_provisioner_tpu_torch.ops.split_kv"):
        from aws_k8s_ansible_provisioner_tpu_torch.ops import split_kv
        ctx["split_kv"] = split_kv
    if not engine_only:
        _kernels(torch, np, da, pa, ctx)
    for case in ENGINES if not only else ():
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
    only = ()
    if args[:1] == ["--only"] and len(args) > 1:
        only = tuple(args[1].split(","))
    flags = args[:1] if engine_only else args[:2] if only else []
    if one_path is not None:
        print(json.dumps(one(one_path, engine_only, only)))
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


if __name__ == "__main__":
    sys.exit(main())
