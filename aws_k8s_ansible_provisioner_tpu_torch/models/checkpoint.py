"""Converted-params cache: the port's parameter tree saved beside the HF
checkpoint, so that a restart skips the safetensors conversion.

The counterpart of the JAX package's ``load_checkpoint_cached``: after the
first load the converted tree (layers stacked, kernels transposed, leaves
cast) is written with ``torch.save`` to
``<checkpoint_dir>/torch_cache/<dtype>/params.pt``, beside a
``source_manifest.json`` holding the JAX cache's fingerprint (the shard
names, sizes and mtimes plus the model config, hashed); a later start whose
fingerprint matches restores the tree with one ``torch.load`` straight onto
the engine's device. An int8 target (``quantize``) converts with the
quantization done layer by layer (``hf_loader.convert_state_dict``) and
caches the int8 tree in a directory of its own (``<dtype>-int8``). The
behaviour on failure is the reference's, each case
logged: a stale or unreadable cache is reconverted from the shards, and a
cache that cannot be written (a read-only volume) leaves serving going on
from the converted tree.

The reference's ``mesh`` argument (a sharded restore) has no counterpart:
the port's engine serves the parameters whole on one device (tp and dp are
refused, ``serving/engine.py``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os

import torch

from aws_k8s_ansible_provisioner_tpu_torch.device import resolve_device

log = logging.getLogger(__name__)

PARAMS_FILE = "params.pt"


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).rsplit(".", 1)[-1]


def cache_dir(checkpoint_dir: str, dtype: torch.dtype,
              quantize: bool = False) -> str:
    """The cache of ``dtype``'s tree (int8-quantized with ``quantize``):
    one directory per dtype and form."""
    return os.path.join(os.path.abspath(checkpoint_dir), "torch_cache",
                        _dtype_name(dtype) + ("-int8" if quantize else ""))


def fingerprint(checkpoint_dir: str, cfg) -> str:
    """Hash of the source safetensors (name, size, mtime) and the model
    config (the JAX cache's ``_fingerprint``): a re-downloaded shard or a
    changed config invalidates the cache."""
    entries = []
    for f in sorted(os.listdir(checkpoint_dir)):
        if f.endswith(".safetensors"):
            st = os.stat(os.path.join(checkpoint_dir, f))
            entries.append((f, st.st_size, int(st.st_mtime)))
    blob = json.dumps([entries, dataclasses.asdict(cfg)], sort_keys=True,
                      default=str)
    return hashlib.sha256(blob.encode()).hexdigest()


def _manifest_path(cache: str) -> str:
    return os.path.join(cache, "source_manifest.json")


def save_params(params: dict, cache: str, fp: str) -> None:
    """Write the tree, then the manifest that makes it valid (each through a
    temporary file and a rename, so a killed writer leaves no cache that a
    later start would take)."""
    os.makedirs(cache, exist_ok=True)
    manifest = _manifest_path(cache)
    if os.path.exists(manifest):
        os.remove(manifest)
    tmp = os.path.join(cache, f".{PARAMS_FILE}.{os.getpid()}.tmp")
    torch.save(params, tmp)
    os.replace(tmp, os.path.join(cache, PARAMS_FILE))
    tmp = manifest + f".{os.getpid()}.tmp"
    with open(tmp, "w") as fh:
        json.dump({"fingerprint": fp}, fh)
    os.replace(tmp, manifest)


def restore_params(cache: str, dtype: torch.dtype, device=None,
                   quantize: bool = False, place=None) -> dict:
    """The tree saved by :func:`save_params`, loaded onto ``device`` (the
    card unless the caller names another); raises when a leaf is not a
    ``dtype`` tensor (with ``quantize`` also an int8 kernel or its float32
    scales). ``place(path, leaf)`` (``parallel/sharding.
    make_sharded_put``): the tree is read onto the host and each leaf
    replaced by what ``place`` makes of it, one leaf at a time."""
    allowed = {dtype, torch.int8, torch.float32} if quantize else {dtype}
    params = torch.load(os.path.join(cache, PARAMS_FILE), weights_only=True,
                        map_location=resolve_device(
                            device if place is None else "cpu"))

    def check(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                check(v, path + (k,))
        elif not isinstance(node, torch.Tensor) or node.dtype not in allowed:
            raise ValueError(f"cached leaf {'/'.join(path)} is not a "
                             f"{dtype} tensor")

    check(params, ())
    return params if place is None else _placed(params, place)


def _placed(tree: dict, place, path: tuple = ()) -> dict:
    """Each leaf of ``tree`` through ``place``, dropped from the tree as
    it goes (the host keeps no leaf it has placed)."""
    out = {}
    for key in list(tree):
        node = tree.pop(key)
        out[key] = _placed(node, place, path + (key,)) \
            if isinstance(node, dict) else place(path + (key,), node)
    return out


def load_checkpoint_cached(checkpoint_dir: str, cfg,
                           dtype: torch.dtype = torch.bfloat16,
                           device=None, quantize: bool = False,
                           place=None) -> dict:
    """The checkpoint's parameter tree on ``device`` (the card unless the
    caller names another), int8-quantized with ``quantize``: restored from
    the converted-params cache when its fingerprint matches, else converted
    from the shards (``models/hf_loader.load_checkpoint``) and cached. A
    cache that does not restore is logged and reconverted; one that cannot
    be written is logged and skipped. With ``place`` (the sharded load)
    the tree is converted or restored on the host, cached from there, and
    each leaf placed (``restore_params``); no device holds the whole
    tree."""
    from aws_k8s_ansible_provisioner_tpu_torch.models.hf_loader import \
        load_checkpoint

    device = resolve_device(device)
    cache = cache_dir(checkpoint_dir, dtype, quantize)
    fp = fingerprint(checkpoint_dir, cfg)
    if os.path.isdir(cache):
        try:
            with open(_manifest_path(cache)) as fh:
                stored = json.load(fh).get("fingerprint")
            if stored != fp:
                raise ValueError("source checkpoint or config changed "
                                 "since the cache was written")
            params = restore_params(cache, dtype, device, quantize, place)
            log.info("restored converted params from cache %s", cache)
            return params
        # a corrupt or partial cache (a pod killed mid-write) must never
        # block serving: the shards are the source of truth
        except Exception as e:  # noqa: BLE001
            log.warning("checkpoint cache %s not usable (%s); reconverting",
                        cache, e)
    stage = device if place is None else torch.device("cpu")
    if quantize:
        params = load_checkpoint(checkpoint_dir, cfg, dtype, stage,
                                 quantize=True)
    else:
        params = load_checkpoint(checkpoint_dir, cfg, dtype, stage)
    try:
        save_params(params, cache, fp)
        log.info("wrote converted-params cache %s", cache)
    # a read-only volume or a full disk: serve without the cache
    except Exception as e:  # noqa: BLE001
        log.warning("could not write checkpoint cache %s: %s", cache, e)
    return params if place is None else _placed(params, place)
