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
   version, a PyTorch library call of the same function and its bound;
3. engine: the main path, Qwen3-0.6B at full width with seeded random
   weights through ``serving.engine.Engine`` (the default ServingConfig:
   paged, page 64, 32 slots, bf16 KV, int8 weights; prefill_chunk 256 so
   long prompts ride ``mixed_step``). The kernels' launch counts are zeroed
   just before and read just after; each must be > 0. Then one decode
   dispatch of 8 slots is timed and profiled (device time by kernel), and
   one decode step's logits through the kernels are held against the same
   step through the plain versions;
4. server: the port's HTTP server in-process on a free port answers
   ``GET /v1/models`` and ``POST /v1/completions``.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
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
# 0.039 measured on an H100 80GB HBM3, 700 W).
LOGIT_TOL = 0.1


def log(msg: str) -> None:
    print(msg, flush=True)


def timed_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, by CUDA events over ``iters`` calls."""
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


def _attention_case(torch, np, pool_k, pool_v, limits_np, table_np, layer,
                    label):
    """Hold the attention kernel against its plain version; time both, an
    SDPA over the gathered K/V, and the bound. Returns a result dict."""
    from aws_k8s_ansible_provisioner_tpu_torch.ops import paged_attention as pa

    dev = pool_k.device
    _, P, Hkv, ps, D = pool_k.shape
    Hq = 16
    N = len(limits_np)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    q = torch.randn((N, Hq, D), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    limits = torch.from_numpy(limits_np.astype(np.int32)).to(dev)
    table = torch.from_numpy(table_np.astype(np.int32)).to(dev)
    out = pa.paged_attention(q, pool_k, pool_v, limits, layer, table)
    ref = pa.paged_attention_plain(q, pool_k, pool_v, limits, layer, table)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs().reshape(N, -1)
    max_err, mean_err = float(diff.max()), float(diff.mean())
    ulp = _bf16_ulp(torch, ref.float().abs().reshape(N, -1).amax(1))
    row_max = diff.amax(1) / ulp
    row_mean = diff.mean(1) / ulp
    worst_max, worst_mean = float(row_max.max()), float(row_mean.max())
    if not (math.isfinite(max_err) and worst_max <= ATTN_MAX_ULPS
            and worst_mean <= ATTN_MEAN_ULPS):
        bad = torch.nonzero((row_max > ATTN_MAX_ULPS)
                            | (row_mean > ATTN_MEAN_ULPS)).flatten()
        raise AssertionError(
            f"paged_attention {label}: rows {bad[:8].tolist()} (limits "
            f"{limits_np[bad[:8].cpu().numpy()].tolist()}) past tolerance: "
            f"worst row max {worst_max:.2f} ulp (tol {ATTN_MAX_ULPS}), worst "
            f"row mean {worst_mean:.3f} ulp (tol {ATTN_MEAN_ULPS})")
    ms = timed_ms(torch, lambda: pa.paged_attention(q, pool_k, pool_v, limits,
                                                    layer, table))
    plain_ms = timed_ms(torch, lambda: pa.paged_attention_plain(
        q, pool_k, pool_v, limits, layer, table), iters=5, warmup=1)
    # yardstick: one SDPA call over this case's gathered dense K/V (gather
    # and mask built outside the timed call)
    hi = np.clip((limits_np + ps - 1) // ps - 1, 0, table_np.shape[1] - 1)
    n_vis = int(hi.max()) + 1
    pages = table[:, :n_vis].long()
    kd = pool_k[layer][pages].permute(0, 2, 1, 3, 4).reshape(
        N, Hkv, n_vis * ps, D).repeat_interleave(Hq // Hkv, dim=1)
    vd = pool_v[layer][pages].permute(0, 2, 1, 3, 4).reshape(
        N, Hkv, n_vis * ps, D).repeat_interleave(Hq // Hkv, dim=1)
    col = torch.arange(n_vis * ps, device=dev)
    mask = torch.where(col[None, :] < limits[:, None].long(), 0.0, -1e30) \
        .to(torch.bfloat16)[:, None, None, :]
    q4 = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = timed_ms(torch, lambda: sdpa(q4, kd, vd, attn_mask=mask))
    del kd, vd
    # bound: each input byte read once (K/V pages the rows visit, counted
    # once per distinct (page, kv head) tile), each output byte written once;
    # operations: QK^T and PV over the live columns
    visited = {int(table_np[n, c]) for n in range(N) for c in range(hi[n] + 1)}
    tile = Hkv * ps * D * 2
    nbytes = (2 * len(visited) * tile + 2 * N * Hq * D * 2
              + N * 4 + N * table_np.shape[1] * 4)
    ops = 4 * Hq * D * int(np.maximum(limits_np, 0).sum())
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_BF16_OPS_PER_S
    res = {"max_abs_err": max_err, "mean_abs_err": mean_err,
           "worst_row_max_ulps": worst_max, "worst_row_mean_ulps": worst_mean,
           "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": 1e3 * max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes, "rows": N}
    log(f"[kernels] paged_attention {label}: rows {N}, max abs {max_err:.3e}, "
        f"mean abs {mean_err:.3e}; worst row: max {worst_max:.2f} ulp, mean "
        f"{worst_mean:.3f} ulp (tol {ATTN_MAX_ULPS}/{ATTN_MEAN_ULPS}); "
        f"kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
        f"{library_ms:.4f} bound_ms {res['bound_ms']:.4f} "
        f"({nbytes / 1e6:.1f} MB, {100 * res['bound_ms'] / ms:.1f}% of bound)")
    return res


def _write_case(torch, np, pool_k, pool_v, rows_np, table_np, layer, label):
    """Hold the row-write kernel against its plain version, bit for bit on
    the whole pool; time both, an index_put_ pair and the bound."""
    from aws_k8s_ansible_provisioner_tpu_torch.ops import paged_attention as pa

    dev = pool_k.device
    _, P, Hkv, ps, D = pool_k.shape
    N = len(rows_np)
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    k_new = torch.randn((N, Hkv, D), generator=gen, device=dev,
                        dtype=torch.bfloat16)
    v_new = torch.randn((N, Hkv, D), generator=gen, device=dev,
                        dtype=torch.bfloat16)
    rows = torch.from_numpy(rows_np.astype(np.int32)).to(dev)
    table = torch.from_numpy(table_np.astype(np.int32)).to(dev)
    ref_k, ref_v = pool_k.clone(), pool_v.clone()
    pa.cache_write_rows_paged(pool_k, pool_v, k_new, v_new, rows, layer, table)
    pa.cache_write_rows_paged_plain(ref_k, ref_v, k_new, v_new, rows, layer,
                                    table)
    torch.cuda.synchronize()
    if not (torch.equal(pool_k, ref_k) and torch.equal(pool_v, ref_v)):
        raise AssertionError(f"cache_write_rows_paged {label}: pool differs "
                             f"from the plain version")
    del ref_k, ref_v
    ms = timed_ms(torch, lambda: pa.cache_write_rows_paged(
        pool_k, pool_v, k_new, v_new, rows, layer, table))
    plain_ms = timed_ms(torch, lambda: pa.cache_write_rows_paged_plain(
        pool_k, pool_v, k_new, v_new, rows, layer, table), iters=5, warmup=1)
    ok = (rows_np >= 0) & (rows_np < table_np.shape[1] * ps)
    sel = np.nonzero(ok)[0]
    pg = torch.from_numpy(table_np[sel, rows_np[sel] // ps].astype(
        np.int64)).to(dev)
    off = torch.from_numpy((rows_np[sel] % ps).astype(np.int64)).to(dev)
    heads = torch.arange(Hkv, device=dev)
    lay = torch.full_like(pg, layer)
    idx = (lay[:, None], pg[:, None], heads[None, :], off[:, None])
    ks, vs = k_new[torch.from_numpy(sel).to(dev)], \
        v_new[torch.from_numpy(sel).to(dev)]

    def library():
        pool_k.index_put_(idx, ks)
        pool_v.index_put_(idx, vs)

    library_ms = timed_ms(torch, library)
    # bound: new rows read once, pool rows written once, rows read once,
    # one table entry read per kept row
    nbytes = 2 * 2 * len(sel) * Hkv * D * 2 + N * 4 + len(sel) * 4
    res = {"max_abs_err": 0.0, "mean_abs_err": 0.0, "ms": ms,
           "plain_ms": plain_ms,
           "library_ms": library_ms,
           "bound_ms": 1e3 * nbytes / PEAK_BYTES_PER_S, "bound_by": "bytes",
           "bytes": nbytes, "rows": N}
    log(f"[kernels] cache_write_rows_paged {label}: rows {N} ({len(sel)} "
        f"kept), bit-exact; kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
        f"library_ms {library_ms:.4f} (index_put_ K and V) bound_ms "
        f"{res['bound_ms']:.5f} ({nbytes / 1e6:.2f} MB)")
    return res


def phase_kernels(torch, np):
    """Main-path shapes: 32 decode rows with ragged lengths up to 2048, and
    the ragged mixed case of those rows plus a 256-row chunk of one slot."""
    from aws_k8s_ansible_provisioner_tpu_torch.config import QWEN3_0_6B as cfg

    L, Hkv, D, ps, B, max_pages = cfg.num_layers, cfg.num_kv_heads, \
        cfg.head_dim, 64, 32, 2048 // 64
    P = B * max_pages + 1
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    shape = (L, P, Hkv, ps, D)
    pool_k = torch.randn(shape, generator=gen, device=dev,
                         dtype=torch.bfloat16)
    pool_v = torch.randn(shape, generator=gen, device=dev,
                         dtype=torch.bfloat16)
    log(f"[kernels] pool [L {L}, P {P}, Hkv {Hkv}, page {ps}, D {D}] bf16, "
        f"{2 * pool_k.numel() * 2 / 2**30:.2f} GiB")
    rng = np.random.default_rng(5)
    table = (rng.permutation(B * max_pages) + 1).reshape(B, max_pages)
    lengths = rng.integers(1, 2049, B)
    lengths[:6] = [1, 64, 65, 2048, 2047, 128]
    layer = L - 1
    dec = _attention_case(torch, np, pool_k, pool_v, lengths, table, layer,
                          "decode")
    # ragged mixed: slot 3 chunks rows [512, 768); its own decode row is the
    # dead passenger (limit 0)
    pslot, pstart, C = 3, 512, 256
    limits = np.concatenate([lengths, pstart + np.arange(C) + 1])
    limits[pslot] = 0
    tables = np.concatenate([table, np.repeat(table[pslot][None], C, 0)])
    rag = _attention_case(torch, np, pool_k, pool_v, limits, tables, layer,
                          "ragged 32+256")
    rows = np.concatenate([lengths - 1, pstart + np.arange(C)])
    rows[pslot] = -1
    wr_rag = _write_case(torch, np, pool_k, pool_v, rows, tables, layer,
                         "ragged 32+256")
    wr_dec = _write_case(torch, np, pool_k, pool_v, lengths - 1, table, layer,
                         "decode")
    # a dropped row must not read its table: OOB_PAGE rows beyond the window
    oob = np.full((4, max_pages), 2**31 - 1)
    wr_oob = _write_case(torch, np, pool_k, pool_v,
                         np.array([-1, max_pages * ps, -5, 10**6]), oob,
                         layer, "dropped rows, OOB_PAGE tables")
    del pool_k, pool_v
    torch.cuda.empty_cache()
    return {"paged_attention": dec, "paged_attention_ragged": rag,
            "cache_write_rows_paged": wr_dec, "cache_write_ragged": wr_rag,
            "cache_write_dropped": wr_oob}


def phase_engine(torch, np):
    from aws_k8s_ansible_provisioner_tpu_torch.config import (QWEN3_0_6B,
                                                              ServingConfig)
    from aws_k8s_ansible_provisioner_tpu_torch.models.layers import init_params
    from aws_k8s_ansible_provisioner_tpu_torch.ops import paged_attention as pa
    from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import (Engine,
                                                                      Request)

    cfg = QWEN3_0_6B
    serving = ServingConfig(prefill_chunk=256, derived_seed=0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.monotonic()
    params = init_params(cfg, gen, torch.bfloat16)
    engine = Engine(cfg, params, serving, device="cuda")
    del params
    torch.cuda.synchronize()
    log(f"[engine] {cfg.name}: {cfg.num_layers} layers, hidden "
        f"{cfg.hidden_size}, vocab {cfg.vocab_size}; weights "
        f"{serving.weights_dtype}, KV {serving.dtype}, page "
        f"{serving.page_size}, {serving.max_decode_slots} slots, pool "
        f"{engine.allocator.num_pages} pages; set-up "
        f"{time.monotonic() - t0:.1f}s")
    rng = np.random.default_rng(1)
    lens = [17, 45, 130, 300, 64, 700, 9, 200]
    new = [32, 48, 64, 40, 56, 32, 64, 48]
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    # warm the allocator and the cuBLAS handles outside the measured run
    engine.submit(Request(prompt_ids=prompts[0][:8], max_tokens=2,
                          ignore_eos=True))
    engine.run_until_idle()
    engine.counts.clear()
    torch.cuda.synchronize()
    pa.reset_launch_counts()
    t0 = time.monotonic()
    reqs = [engine.submit(Request(prompt_ids=p, max_tokens=m,
                                  ignore_eos=True))
            for p, m in zip(prompts, new)]
    engine.run_until_idle()
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    launches = pa.launch_counts()
    n_gen = sum(len(r.generated) for r in reqs)
    log(f"[engine] {len(reqs)} requests, prompts {lens}: {n_gen} tokens in "
        f"{dt:.2f}s ({n_gen / dt:.1f} tok/s end to end, synchronous "
        f"dispatch); dispatches {dict(engine.counts)}; kernel launches "
        f"{launches}")
    for r, m in zip(reqs, new):
        if len(r.generated) != m or r.finish_reason != "length" or \
                not all(0 <= t < cfg.vocab_size for t in r.generated):
            raise AssertionError(f"request {r.id}: {len(r.generated)} tokens "
                                 f"({r.finish_reason}), expected {m}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    if engine.counts["mixed_dispatches"] <= 0:
        raise AssertionError("no chunked prefill went through mixed_step")
    return engine, launches, n_gen / dt


def phase_profile(torch, np, engine):
    """Where a decode dispatch's time goes: 8 active slots, one horizon-8
    decode dispatch timed by the host clock, and the same dispatch under
    torch.profiler for device time by kernel and the device's idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import Request

    rng = np.random.default_rng(4)
    for _ in range(8):
        engine.submit(Request(prompt_ids=rng.integers(
            0, engine.cfg.vocab_size, 100).tolist(), max_tokens=200,
            ignore_eos=True))
    while engine.pending or engine._chunk is not None:
        engine.step()
    engine.step()                                  # warm the horizon path
    torch.cuda.synchronize()
    t0 = time.monotonic()
    engine.step()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.monotonic() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        engine.step()
        torch.cuda.synchronize()
        prof_wall_ms = 1e3 * (time.monotonic() - t0)
    # device-side events only (kernels, memcpy/memset): their self time on
    # the one stream the engine uses is the device's busy time
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    horizon = engine.serving.decode_horizon
    log(f"[profile] decode dispatch, {len(engine._active_slots())} active "
        f"slots, horizon {horizon}: wall {wall_ms:.2f} ms "
        f"({wall_ms / horizon:.2f} ms per substep)")
    if not events:
        log("[profile] torch.profiler recorded no device time: device "
            "busy share not measured")
    else:
        log(f"[profile] profiled dispatch: wall {prof_wall_ms:.2f} ms, "
            f"device busy {busy_ms:.2f} ms (idle share "
            f"{1 - busy_ms / prof_wall_ms:.3f}), "
            f"{sum(e.count for e in events)} device operations")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
            log(f"[profile]   {e.self_device_time_total / 1e3:8.3f} ms "
                f"{100 * e.self_device_time_total / 1e3 / busy_ms:5.1f}% "
                f"x{e.count:<5d} {e.key[:90]}")
    for s in engine._active_slots():
        engine.cancel(engine.slot_req[s])
    engine.step()
    return wall_ms


def phase_logits(torch, np, engine):
    """One decode step's logits through the kernels vs through the plain
    versions, on the same engine state (pool cloned)."""
    from aws_k8s_ansible_provisioner_tpu_torch.ops import paged_attention as pa
    from aws_k8s_ansible_provisioner_tpu_torch.ops.attention import \
        make_decode_attend_carry_paged
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
    active = engine._active_slots()
    dev = engine.device
    tok = torch.from_numpy(engine.last_token.copy()).to(dev)
    lens = torch.from_numpy(engine.lengths.copy()).to(dev)
    table = torch.from_numpy(engine.table.copy()).to(dev)
    pool_a = {k: v.clone() for k, v in engine.cache.items()}
    pool_b = engine.cache

    def plain_attend(q, k, v, cache_l):
        pool, layer = cache_l
        pa.cache_write_rows_paged_plain(pool["k"], pool["v"], k[:, 0],
                                        v[:, 0], lens, layer, table)
        ctx = pa.paged_attention_plain(q[:, 0].contiguous(), pool["k"],
                                       pool["v"], lens + 1, layer,
                                       table)[:, None]
        return ctx, (pool, layer)

    model = engine.model
    lk, _ = model.forward_carry(tok[:, None], lens[:, None], pool_a,
                                make_decode_attend_carry_paged(lens, table))
    lp, _ = model.forward_carry(tok[:, None], lens[:, None], pool_b,
                                plain_attend)
    torch.cuda.synchronize()
    lk, lp = lk[active, 0].float(), lp[active, 0].float()
    err = float((lk - lp).abs().max())
    scale = float(lp.abs().max())
    agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    log(f"[logits] decode step over {len(active)} active slots: max |logit| "
        f"{scale:.3f}, kernels vs plain max abs {err:.3e} (tol {LOGIT_TOL}), "
        f"argmax agreement {agree:.2f}")
    if not (math.isfinite(err) and err <= LOGIT_TOL):
        raise AssertionError(f"decode logits differ: {err}")
    for s in active:
        engine.cancel(engine.slot_req[s])
    engine.step()
    return err


def phase_server(engine):
    from aws_k8s_ansible_provisioner_tpu_torch.serving.server import (
        ServerState, make_server)
    from aws_k8s_ansible_provisioner_tpu_torch.utils.tokenizer import \
        ByteTokenizer

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    state = ServerState(engine, ByteTokenizer(), engine.cfg.name)
    server = make_server(state, "127.0.0.1", port)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    state.start_engine()
    try:
        base = f"http://127.0.0.1:{port}"
        with urllib.request.urlopen(base + "/v1/models", timeout=60) as r:
            models = json.loads(r.read())
            if r.status != 200 or models["data"][0]["id"] != engine.cfg.name:
                raise AssertionError(f"/v1/models: {r.status} {models}")
        body = json.dumps({"prompt": "Hello from the smoke test",
                           "max_tokens": 16}).encode()
        req = urllib.request.Request(base + "/v1/completions", data=body,
                                     headers={"Content-Type":
                                              "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            out = json.loads(r.read())
            status = r.status
        choice = out["choices"][0]
        if status != 200 or not isinstance(choice["text"], str) \
                or out["usage"]["completion_tokens"] < 1:
            raise AssertionError(f"/v1/completions: {status} {out}")
        log(f"[server] /v1/models 200 ({models['data'][0]['id']}); "
            f"/v1/completions 200: {out['usage']['completion_tokens']} "
            f"tokens, finish {choice['finish_reason']}, text "
            f"{choice['text']!r} (random weights rarely pick a byte id)")
    finally:
        server.shutdown()
        server.server_close()
        state.stop_engine()
        th.join(10)


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
    phase_build()
    kern = phase_kernels(torch, np)
    engine, launches, tok_s = phase_engine(torch, np)
    phase_profile(torch, np, engine)
    phase_logits(torch, np, engine)
    phase_server(engine)
    dec, wr = kern["paged_attention"], kern["cache_write_rows_paged"]
    keys = ("max_abs_err", "mean_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    kernels = [
        {"name": "paged_attention", "route": "cuda", "source": ATTN_SRC,
         "replaces": f"{TPU_KERNELS}:1080",
         "launches": launches["paged_attention"],
         **{k: dec[k] for k in keys}},
        {"name": "cache_write_rows_paged", "route": "cuda",
         "source": WRITE_SRC, "replaces": f"{TPU_KERNELS}:1243",
         "launches": launches["cache_write_rows_paged"],
         **{k: wr[k] for k in keys}},
    ]
    log(f"[done] {time.monotonic() - t_start:.1f}s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
