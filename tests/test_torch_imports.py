"""Import boundary of the PyTorch port: importing every module of
``aws_k8s_ansible_provisioner_tpu_torch`` loads neither JAX nor any module of
the JAX package, and its entry points refuse to run on a machine without
CUDA unless they are asked for the CPU."""

import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import aws_k8s_ansible_provisioner_tpu_torch as port
from aws_k8s_ansible_provisioner_tpu_torch.config import (ServingConfig,
                                                          tiny_qwen3)
from aws_k8s_ansible_provisioner_tpu_torch.models.layers import init_params
from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import Engine

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, json, pkgutil, sys
import aws_k8s_ansible_provisioner_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__,
                                                port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
print(json.dumps({"imported": names, "loaded": sorted(sys.modules)}))
"""


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    expected = {m.name for m in pkgutil.walk_packages(port.__path__,
                                                      port.__name__ + ".")}
    assert set(res["imported"]) == expected
    for mod in ("config", "ops.paged_attention", "ops.dense_attention",
                "ops.sampling", "serving.engine", "serving.draft",
                "serving.kv_cache", "serving.paged_kv", "serving.server",
                "serving.metrics", "serving.chat_template",
                "models.layers", "models.convert", "models.hf_loader",
                "models.checkpoint", "serving.aot", "utils.tokenizer",
                "utils.hf_parity", "parallel.mesh", "parallel.sharding",
                "parallel.collectives",
                "serving.guided", "models.lora", "ops.moe",
                "models.quant", "ops.cuda_build"):
        assert f"{port.__name__}.{mod}" in expected
    loaded = res["loaded"]
    assert not [m for m in loaded if m == "jax" or m.startswith("jax.")
                or m.startswith("jaxlib")]
    ref = "aws_k8s_ansible_provisioner_tpu"
    assert not [m for m in loaded if m == ref or m.startswith(ref + ".")]
    assert "torch" in loaded


def test_engine_without_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_qwen3()
    params = init_params(cfg, torch.Generator().manual_seed(0), torch.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg, params, ServingConfig(max_decode_slots=2,
                                          max_cache_len=32, page_size=8,
                                          prefill_buckets=(8, 16),
                                          dtype="float32"))
    engine = Engine(cfg, params, ServingConfig(
        max_decode_slots=2, max_cache_len=32, page_size=8,
        prefill_buckets=(8, 16), dtype="float32"), device="cpu")
    assert engine.device.type == "cpu"
