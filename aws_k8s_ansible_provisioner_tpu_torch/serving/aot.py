"""Memory-fit manifest of a serving configuration, built from a run on the
card.

The JAX package's ``serving/aot.py`` compiles the serving program set
deviceless and writes each program's compile seconds and
``memory_analysis()`` bytes, summed into an HBM ledger with a fit verdict.
Eager PyTorch has no deviceless compile, so the port's manifest comes from
the configuration's own engine on the card: it is built (weights loaded,
pool allocated, decode graphs captured), :meth:`Engine.warmup` runs every
program once, and each program's first-run seconds and peak device bytes
(``torch.cuda.max_memory_allocated`` above the allocation before it) are
recorded. The ledger adds what the engine holds: the parameters, the KV
pool (and a draft model's cache), the decode graphs' memory pool, and the
largest program peak, against the card's capacity
(``torch.cuda.mem_get_info``).

Program entries carry the JAX ``PROGRAM_FIELDS`` that have a meaning here:
``name``, ``compile_seconds`` (the first run's wall seconds: kernel library
loads and cuBLAS's first calls, not a compile) and ``temp_bytes`` (the
peak). Left out: ``argument_bytes``, ``output_bytes`` and
``generated_code_bytes`` (XLA executable statistics, with no eager
counterpart). On the CPU (a dry run) ``temp_bytes`` is 0 and the capacity
is the host's memory.

Usage (the server's flags shape the configuration)::

    python -m aws_k8s_ansible_provisioner_tpu_torch.serving.aot \\
        --checkpoint-dir /models/Qwen/Qwen3-0.6B --out M.json

The server adopts it with ``--aot-manifest M.json``
(:meth:`Engine.load_aot_manifest`), which refuses a manifest of another
configuration or a no-fit ledger before warmup.
"""

from __future__ import annotations

import json
import logging
import os
import sys
from typing import Optional

import torch

MANIFEST_SCHEMA = "tpu-serve-aot-torch/v1"
PROGRAM_FIELDS = ("name", "compile_seconds", "temp_bytes")
LEDGER_FIELDS = ("capacity_bytes_per_chip", "params_bytes_per_chip",
                 "kv_bytes_per_chip", "graph_pool_bytes", "max_temp_bytes",
                 "total_bytes", "headroom_bytes", "fit")


def engine_fingerprint(engine) -> dict:
    """The configuration facts a manifest is bound to: the JAX
    fingerprint's keys, plus ``sp``, the speculation setup (spec on or
    off, its method, the draft model), since the ledger counts the draft's
    parameters and cache and the program list its verify and draft
    programs, and the adapter names (the ledger counts their factors and
    every program runs their path)."""
    return {
        "model": engine.cfg.name,
        "num_slots": engine.num_slots,
        "max_len": engine.max_len,
        "page_size": engine.serving.page_size if engine.paged else 0,
        "buckets": list(engine.buckets),
        "weights_dtype": engine.serving.weights_dtype,
        "kv_dtype": engine.serving.kv_dtype,
        "paged": engine.paged,
        "dp": engine.dp, "tp": engine.tp, "sp": engine.sp, "ep": engine.ep,
        # pool pages per dp group (its scratch page included), as the JAX
        # ProgramPlan sizes the pool
        "group_pages": engine._group_pages if engine.paged else 0,
        "spec_decode": engine.spec_decode,
        "spec_method": engine.serving.spec_method,
        "draft": engine.draft.cfg.name if engine.draft is not None else None,
        "lora": list(engine.lora_names),
    }


def _bytes(tree, device=None) -> int:
    """Bytes of a tree's tensors; of a mesh's sharded parameters or pool,
    those on ``device`` (a chip's), each storage once."""
    from aws_k8s_ansible_provisioner_tpu_torch.parallel.sharding import (
        ShardedLeaf, ShardedPool)

    if isinstance(tree, ShardedLeaf):
        on = {t.untyped_storage().data_ptr(): t for t in tree.parts.values()
              if str(t.device) == str(device)}
        return sum(_bytes(t) for t in on.values())
    if isinstance(tree, ShardedPool):
        return sum(_bytes(a) for _, a in tree.leaves()
                   if str(a.device) == str(device))
    if isinstance(tree, dict):
        return sum(_bytes(v, device) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_bytes(v, device) for v in tree)
    return tree.numel() * tree.element_size()


def build_ledger(engine, entries: list,
                 capacity_bytes: Optional[int] = None) -> dict:
    """The memory ledger of a built and warmed engine."""
    dev = engine.device
    if capacity_bytes is None:
        if dev.type == "cuda":
            capacity_bytes = torch.cuda.mem_get_info(dev)[1]
        else:
            capacity_bytes = os.sysconf("SC_PAGE_SIZE") \
                * os.sysconf("SC_PHYS_PAGES")
    params = _bytes(engine.model.params, dev)
    kv = _bytes(engine.cache, dev)
    if engine.draft is not None:
        params += _bytes(engine.draft.model.params)
        kv += _bytes(engine.draft.cache)
    graphs = int(engine.decoder.pool_bytes)
    max_temp = max((e["temp_bytes"] for e in entries), default=0)
    total = params + kv + graphs + max_temp
    return {
        "capacity_bytes_per_chip": int(capacity_bytes),
        "params_bytes_per_chip": params,
        "kv_bytes_per_chip": kv,
        "graph_pool_bytes": graphs,
        "max_temp_bytes": max_temp,
        "total_bytes": total,
        "headroom_bytes": int(capacity_bytes) - total,
        "fit": total <= capacity_bytes,
        # the prefix cache's pinned host tier: host memory, informational
        "host_tier_bytes": (_bytes(engine.host_tier._slots)
                            if engine.host_tier is not None else 0),
    }


def verify_manifest(m: dict) -> None:
    """Schema check shared by the tests and the engine's load path; raises
    ValueError on any structural problem."""
    if m.get("schema") != MANIFEST_SCHEMA:
        raise ValueError(f"manifest schema {m.get('schema')!r} != "
                         f"{MANIFEST_SCHEMA!r}")
    for key in ("platform", "config", "programs", "hbm_ledger",
                "total_compile_seconds"):
        if key not in m:
            raise ValueError(f"manifest missing {key!r}")
    if not m["programs"]:
        raise ValueError("manifest has no programs")
    for p in m["programs"]:
        for f in PROGRAM_FIELDS:
            if f not in p:
                raise ValueError(f"program entry missing {f!r}: {p}")
    for f in LEDGER_FIELDS:
        if f not in m["hbm_ledger"]:
            raise ValueError(f"hbm_ledger missing {f!r}")


def build_manifest(engine, capacity_bytes: Optional[int] = None) -> dict:
    """Warm ``engine`` (idle, as built) and return its manifest."""
    record: list = []
    engine.warmup(record)
    entries = [{"name": r["name"], "compile_seconds": round(r["seconds"], 3),
                "temp_bytes": int(r["peak_bytes"] or 0)} for r in record]
    dev = engine.device
    manifest = {
        "schema": MANIFEST_SCHEMA,
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "torch_version": torch.__version__,
        "config": engine_fingerprint(engine),
        "programs": entries,
        "hbm_ledger": build_ledger(engine, entries, capacity_bytes),
        "total_compile_seconds": round(
            sum(e["compile_seconds"] for e in entries), 3),
        "graph_capture_seconds": round(engine.decoder.capture_s, 3),
    }
    verify_manifest(manifest)
    return manifest


def main(argv=None) -> int:
    from aws_k8s_ansible_provisioner_tpu_torch.serving.server import (
        build_parser, build_state, check_args, serving_config)

    p = build_parser(
        prog="python -m aws_k8s_ansible_provisioner_tpu_torch.serving.aot",
        description="Build the engine of a serving configuration, warm "
                    "every program once and write the memory-fit manifest.")
    p.add_argument("--out", default="",
                   help="manifest path (default: stdout)")
    args = p.parse_args(argv)
    check_args(p, args)
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s "
                               "%(message)s")
    state = build_state(serving_config(args), device=args.device,
                        seed=args.seed)
    manifest = build_manifest(state.engine)
    text = json.dumps(manifest, indent=2)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(text + "\n")
    else:
        print(text)
    ledger = manifest["hbm_ledger"]
    print(f"aot: {len(manifest['programs'])} programs, "
          f"{manifest['total_compile_seconds']:.2f}s first runs, "
          f"{ledger['total_bytes'] / 2**30:.2f} GiB of "
          f"{ledger['capacity_bytes_per_chip'] / 2**30:.2f} GiB "
          f"({'fit' if ledger['fit'] else 'NO FIT'})", file=sys.stderr)
    return 0 if ledger["fit"] else 1


if __name__ == "__main__":
    sys.exit(main())
