#!/usr/bin/env python3
"""K1's device times in several checkouts of the port, in turns, on one card.

    python3 kernel_ab.py PATH [PATH ...]

Each PATH is the root of a checkout that holds
``aws_k8s_ansible_provisioner_tpu_torch/``. For each PATH in the order
given, a subprocess builds that checkout's kernels from its ``csrc/`` and
times the paged attention (K1 over a bf16 pool, its int8 instance over an
int8 pool) through the checkout's own wrappers, at ``chip_smoke.py``'s
shapes: 32 decode rows with lengths up to 2048, and those rows plus a
256-row prefill chunk (the ragged entry), over a 28-layer pool of page 64;
and, where the checkout has it, the speculative verify's form over the
same pools (32 slots of 5 rows).
Give two versions as A B B A to compare them within one call. Prints one
JSON line per run (mean device ms by CUDA events over 50 launches, after 5)
and the card's name and power limit; needs a CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys


def _time_ms(torch, fn, iters=50, warmup=5):
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


def one(path: str) -> dict:
    """Times of the checkout at ``path`` (run in its own process)."""
    sys.path.insert(0, path)
    import numpy as np
    import torch

    from aws_k8s_ansible_provisioner_tpu_torch.ops import cuda_build
    from aws_k8s_ansible_provisioner_tpu_torch.ops import paged_attention as pa

    cuda_build.build_kernels(["paged_attention"])
    L, P, Hkv, ps, D, Hq, B, max_pages = 28, 1025, 8, 64, 128, 16, 32, 32
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    rng = np.random.default_rng(5)
    table = (rng.permutation(B * max_pages) + 1).reshape(B, max_pages)
    lengths = rng.integers(1, 2049, B)
    lengths[:6] = [1, 64, 65, 2048, 2047, 128]
    pslot, pstart, C = 3, 512, 256
    limits = np.concatenate([lengths, pstart + np.arange(C) + 1])
    limits[pslot] = 0
    tables = np.concatenate([table, np.repeat(table[pslot][None], C, 0)])
    cases = {"decode": (lengths, table), "ragged": (limits, tables)}
    q = torch.randn((B + C, Hq, D), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    shape = (L, P, Hkv, ps, D)
    out = {"path": path}
    for pool in ("bf16", "int8"):
        if pool == "bf16":
            k, v = (torch.randn(shape, generator=gen, device=dev,
                                dtype=torch.bfloat16) for _ in range(2))
        else:
            k, v = (torch.randint(-127, 128, shape, generator=gen,
                                  device=dev, dtype=torch.int8)
                    for _ in range(2))
            ks, vs = (torch.rand(shape[:-1], generator=gen, device=dev)
                      * 0.02 + 1e-3 for _ in range(2))
        for case, (lim_np, tab_np) in cases.items():
            n = len(lim_np)
            lim = torch.from_numpy(lim_np.astype(np.int32)).to(dev)
            tab = torch.from_numpy(tab_np.astype(np.int32)).to(dev)
            qn = q[:n].contiguous()
            if pool == "bf16":
                def fn():
                    return pa.paged_attention(qn, k, v, lim, L - 1, tab)
            else:
                def fn():
                    return pa.paged_attention_quant(qn, k, v, ks, vs, lim,
                                                    L - 1, tab)
            out[f"{pool} {case}"] = _time_ms(torch, fn)
        if hasattr(pa, "paged_attention_spec"):
            # the verify: 5 rows per slot, pages covering lengths + 5
            lens = torch.from_numpy(np.minimum(lengths, 2043).astype(
                np.int32)).to(dev)
            tab = torch.from_numpy(table.astype(np.int32)).to(dev)
            q5 = q[:B * 5].reshape(B, 5, Hq, D).contiguous()
            if pool == "bf16":
                def fn():
                    return pa.paged_attention_spec(q5, k, v, lens, L - 1, tab)
            else:
                def fn():
                    return pa.paged_attention_spec_quant(q5, k, v, ks, vs,
                                                         lens, L - 1, tab)
            out[f"{pool} spec"] = _time_ms(torch, fn)
        del k, v
        torch.cuda.empty_cache()
    return out


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        print(json.dumps(one(sys.argv[2])))
        return 0
    paths = sys.argv[1:]
    if not paths:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() if smi.returncode == 0
          else f"nvidia-smi failed ({smi.returncode})")
    for path in paths:
        run = subprocess.run([sys.executable, __file__, "--one", path],
                             capture_output=True, text=True, timeout=600)
        if run.returncode != 0:
            print(run.stderr[-4000:], file=sys.stderr)
            return run.returncode
        print(run.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
