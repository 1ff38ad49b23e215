"""The port's converted-params cache (``models/checkpoint.py``): the cases of
``tests/test_checkpoint.py`` against ``load_checkpoint_cached``, a real tiny
checkpoint converted once and then restored bit for bit, the JAX cache's
fingerprint, and a cache that cannot be written."""

import json
import logging
import os
import time

import pytest
import torch

from aws_k8s_ansible_provisioner_tpu_torch.config import tiny_qwen3
from aws_k8s_ansible_provisioner_tpu_torch.models import checkpoint as ck
from aws_k8s_ansible_provisioner_tpu_torch.models import hf_loader as thf
from aws_k8s_ansible_provisioner_tpu_torch.models.layers import init_params

LOADER = "aws_k8s_ansible_provisioner_tpu_torch.models.hf_loader." \
    "load_checkpoint"


def _params(seed: int, dtype=torch.float32):
    return init_params(tiny_qwen3(), torch.Generator().manual_seed(seed),
                       dtype)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _tree_equal(a, b):
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, p
        assert torch.equal(x.view(torch.uint8) if x.dim() else x,
                           y.view(torch.uint8) if y.dim() else y), p


def test_save_restore_roundtrip(tmp_path):
    params = _params(0)
    cache = str(tmp_path / "cache")
    ck.save_params(params, cache, "fp")
    _tree_equal(params, ck.restore_params(cache, torch.float32,
                                          device="cpu"))
    with open(os.path.join(cache, "source_manifest.json")) as f:
        assert json.load(f) == {"fingerprint": "fp"}


def test_save_overwrites_existing(tmp_path):
    cache = str(tmp_path / "cache")
    ck.save_params(_params(0), cache, "a")
    p2 = _params(1)
    ck.save_params(p2, cache, "b")
    _tree_equal(p2, ck.restore_params(cache, torch.float32,
                                      device="cpu"))


def test_cached_load_converts_once_then_restores(tmp_path, monkeypatch):
    """The first load converts and writes the cache; the second restores
    without calling the conversion."""
    cfg = tiny_qwen3()
    params = _params(0)
    calls = {"n": 0}

    def fake_load(checkpoint_dir, cfg_, dtype, device="cpu"):
        calls["n"] += 1
        return params

    monkeypatch.setattr(LOADER, fake_load)
    got1 = ck.load_checkpoint_cached(str(tmp_path), cfg, torch.float32,
                                     device="cpu")
    assert calls["n"] == 1
    _tree_equal(params, got1)
    got2 = ck.load_checkpoint_cached(str(tmp_path), cfg, torch.float32,
                                     device="cpu")
    assert calls["n"] == 1, "the second load should restore the cache"
    _tree_equal(params, got2)


@pytest.mark.parametrize("damage", ["no-manifest", "garbage-params",
                                    "wrong-dtype"])
def test_corrupt_cache_falls_back_to_conversion(tmp_path, monkeypatch,
                                                caplog, damage):
    """A cache directory without its manifest, with a garbage tree under a
    valid manifest, or with leaves of another dtype is logged and
    reconverted."""
    cfg = tiny_qwen3()
    params = _params(0)
    monkeypatch.setattr(LOADER, lambda d, c, t, device="cpu": params)
    cache = ck.cache_dir(str(tmp_path), torch.float32)
    os.makedirs(cache)
    fp = {"fingerprint": ck.fingerprint(str(tmp_path), cfg)}
    if damage == "no-manifest":
        with open(os.path.join(cache, "not_a_checkpoint"), "w") as f:
            f.write("garbage")
    else:
        if damage == "garbage-params":
            with open(os.path.join(cache, ck.PARAMS_FILE), "wb") as f:
                f.write(b"garbage")
        else:
            torch.save(_params(1, torch.bfloat16),
                       os.path.join(cache, ck.PARAMS_FILE))
        with open(os.path.join(cache, "source_manifest.json"), "w") as f:
            json.dump(fp, f)
    with caplog.at_level(logging.WARNING):
        got = ck.load_checkpoint_cached(str(tmp_path), cfg, torch.float32,
                                        device="cpu")
    _tree_equal(params, got)
    assert "reconverting" in caplog.text
    # the reconversion rewrote the cache: the next load restores it
    _tree_equal(params, ck.restore_params(cache, torch.float32,
                                          device="cpu"))


def test_dtype_separate_caches(tmp_path, monkeypatch):
    cfg = tiny_qwen3()
    monkeypatch.setattr(
        LOADER, lambda d, c, dtype, device="cpu": init_params(
            cfg, torch.Generator().manual_seed(0), dtype))
    a = ck.load_checkpoint_cached(str(tmp_path), cfg, torch.float32,
                                     device="cpu")
    b = ck.load_checkpoint_cached(str(tmp_path), cfg, torch.bfloat16,
                                     device="cpu")
    assert a["embed"]["weight"].dtype == torch.float32
    assert b["embed"]["weight"].dtype == torch.bfloat16
    assert (tmp_path / "torch_cache" / "float32").is_dir()
    assert (tmp_path / "torch_cache" / "bfloat16").is_dir()


def test_stale_cache_invalidated_by_source_change(tmp_path, monkeypatch):
    """A re-downloaded shard (new contents and mtime) is not served from
    the old cache."""
    cfg = tiny_qwen3()
    p_old, p_new = _params(0), _params(1)
    current = {"params": p_old}
    monkeypatch.setattr(LOADER,
                        lambda d, c, t, device="cpu": current["params"])
    st = tmp_path / "model.safetensors"
    st.write_bytes(b"v1")
    _tree_equal(p_old, ck.load_checkpoint_cached(str(tmp_path), cfg,
                                                 torch.float32,
                                                 device="cpu"))
    time.sleep(0.01)
    st.write_bytes(b"v2-longer")
    current["params"] = p_new
    _tree_equal(p_new, ck.load_checkpoint_cached(str(tmp_path), cfg,
                                                 torch.float32,
                                                 device="cpu"))


def test_unwritable_cache_still_serves(tmp_path, monkeypatch, caplog):
    """A cache that cannot be written (here a file stands where its
    directory would go, as a read-only volume refuses it) is logged, and
    the converted tree is served all the same, every time."""
    cfg = tiny_qwen3()
    params = _params(0)
    calls = {"n": 0}

    def fake_load(checkpoint_dir, cfg_, dtype, device="cpu"):
        calls["n"] += 1
        return params

    monkeypatch.setattr(LOADER, fake_load)
    (tmp_path / "torch_cache").write_text("not a directory")
    with caplog.at_level(logging.WARNING):
        for _ in range(2):
            _tree_equal(params, ck.load_checkpoint_cached(
                str(tmp_path), cfg, torch.float32, device="cpu"))
    assert calls["n"] == 2
    assert "could not write checkpoint cache" in caplog.text


@pytest.fixture(scope="module")
def tiny_checkpoint(tmp_path_factory):
    from test_model_parity import _hf_qwen3
    from aws_k8s_ansible_provisioner_tpu.config import tiny_qwen3 as jtiny

    d = tmp_path_factory.mktemp("ckpt") / "tiny-qwen3-hf"
    _hf_qwen3(jtiny()).save_pretrained(d, safe_serialization=True)
    return str(d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_real_checkpoint_converts_then_restores_bit_for_bit(
        tiny_checkpoint, monkeypatch, dtype):
    """A real tiny HF directory: the miss converts the shards and writes
    the cache, the hit restores a tree equal to the conversion bit for
    bit without converting; the manifest holds the JAX cache's fingerprint
    of the same directory and config."""
    import dataclasses

    from aws_k8s_ansible_provisioner_tpu.config import ModelConfig as JCfg
    from aws_k8s_ansible_provisioner_tpu.models import checkpoint as jck

    cfg = thf.config_from_hf_dir(tiny_checkpoint)
    want = thf.load_checkpoint(tiny_checkpoint, cfg, dtype, device="cpu")
    got1 = ck.load_checkpoint_cached(tiny_checkpoint, cfg, dtype,
                                     device="cpu")
    _tree_equal(want, got1)

    def no_conversion(*a, **kw):
        raise AssertionError("the cache hit converted")

    monkeypatch.setattr(LOADER, no_conversion)
    got2 = ck.load_checkpoint_cached(tiny_checkpoint, cfg, dtype,
                                     device="cpu")
    _tree_equal(want, got2)
    cache = ck.cache_dir(tiny_checkpoint, dtype)
    with open(os.path.join(cache, "source_manifest.json")) as f:
        stored = json.load(f)["fingerprint"]
    jcfg = JCfg(**dataclasses.asdict(cfg))
    assert stored == jck._fingerprint(tiny_checkpoint, jcfg)


@pytest.mark.parametrize("entry", ["convert_state_dict", "load_checkpoint",
                                   "load_checkpoint_cached",
                                   "restore_params"])
def test_loaders_default_to_the_card(tiny_checkpoint, monkeypatch, entry):
    """Without a ``device`` every loader asks for the card, and raises
    where there is none: nothing lands in host memory unless the caller
    names the CPU."""
    cfg = thf.config_from_hf_dir(tiny_checkpoint)
    calls = {
        "convert_state_dict": lambda: thf.convert_state_dict(cfg, {}),
        "load_checkpoint": lambda: thf.load_checkpoint(tiny_checkpoint, cfg),
        "load_checkpoint_cached": lambda: ck.load_checkpoint_cached(
            tiny_checkpoint, cfg),
        "restore_params": lambda: ck.restore_params(
            ck.cache_dir(tiny_checkpoint, torch.bfloat16), torch.bfloat16),
    }
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        calls[entry]()
