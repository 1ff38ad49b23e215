"""The port's HF checkpoint loader (``models/hf_loader.py``) against the
JAX package's and against the ``safetensors`` package.

Checkpoints are tiny HF models of every family the key map covers, built
in process from seeded random weights (``tests/test_model_parity.py``'s
and ``tests/test_moe.py``'s builders) and written with
``save_pretrained``: no download. Trees must agree leaf for leaf and bit
for bit; configs ``dataclasses.asdict``-equal. The loaded tiny model of
every dense family (Qwen3, Mistral, Llama, Gemma, Phi, OPT) runs through
both packages' forward passes (float32 logits within
1e-5: both sum their float32 products in their own order, a few ulps at
these widths) and through the port's engine against HF ``generate``
(``utils/hf_parity.run``, greedy streams equal).
"""

import dataclasses
import json
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import load_file, save_file

from aws_k8s_ansible_provisioner_tpu.config import (tiny_gemma, tiny_llama,
                                                    tiny_mistral, tiny_opt,
                                                    tiny_phi, tiny_qwen3,
                                                    tiny_qwen3_moe)
from aws_k8s_ansible_provisioner_tpu.models import hf_loader as jhf
from aws_k8s_ansible_provisioner_tpu.models import layers as jl
from aws_k8s_ansible_provisioner_tpu_torch import config as tconfig
from aws_k8s_ansible_provisioner_tpu_torch.models import hf_loader as thf
from aws_k8s_ansible_provisioner_tpu_torch.models import layers as tl
from test_model_parity import (_hf_gemma, _hf_llama, _hf_mistral, _hf_opt,
                               _hf_phi, _hf_qwen3)
from test_moe import _hf_qwen3_moe
from test_real_checkpoint import _write_byte_level_tokenizer

torch.set_num_threads(2)

FAMILIES = {
    "qwen3": (tiny_qwen3, _hf_qwen3),
    "mistral": (tiny_mistral, _hf_mistral),
    "llama": (tiny_llama, _hf_llama),
    "gemma": (tiny_gemma, _hf_gemma),
    "phi": (tiny_phi, _hf_phi),
    "opt": (tiny_opt, _hf_opt),
    "qwen3_moe": (tiny_qwen3_moe, _hf_qwen3_moe),
}
DTYPES = [("float32", jnp.float32, torch.float32),
          ("bfloat16", jnp.bfloat16, torch.bfloat16)]


def _bits(x) -> np.ndarray:
    """A leaf's bytes (numpy, JAX or torch; bfloat16 included)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        x = x.numpy()
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


def assert_same_tree(jtree, ttree, path=()):
    """Same keys, shapes and dtypes, every leaf bit for bit."""
    if isinstance(jtree, dict):
        assert isinstance(ttree, dict) and set(jtree) == set(ttree), \
            (path, sorted(jtree), sorted(ttree))
        for k in jtree:
            assert_same_tree(jtree[k], ttree[k], path + (k,))
        return
    j = jtree if isinstance(jtree, torch.Tensor) else np.asarray(jtree)
    assert tuple(j.shape) == tuple(ttree.shape), path
    assert str(j.dtype).rsplit(".", 1)[-1] == \
        str(ttree.dtype).rsplit(".", 1)[-1], (path, j.dtype, ttree.dtype)
    assert np.array_equal(_bits(j), _bits(ttree)), path


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """family -> (the JAX tiny config, the HF model, its float32 and
    bfloat16 checkpoint directories)."""
    out = {}
    for fam, (make_cfg, build) in FAMILIES.items():
        cfg = make_cfg()
        model = build(cfg)
        root = tmp_path_factory.mktemp(f"ckpt-{fam}")
        f32, bf16 = root / f"tiny-{fam}-f32", root / f"tiny-{fam}-bf16"
        model.save_pretrained(f32, safe_serialization=True)
        model.to(torch.bfloat16).save_pretrained(bf16, safe_serialization=True)
        model.float()
        out[fam] = (cfg, model, str(f32), str(bf16))
    return out


# -- the safetensors reader ---------------------------------------------------


def _tensors(seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {
        "bf16": torch.randn(3, 5, generator=g).bfloat16(),
        "f16": torch.randn(7, generator=g).half(),
        "f32": torch.randn(2, 3, 4, generator=g),
        "i8": torch.randint(-128, 127, (4, 3), generator=g,
                            dtype=torch.int8),
        "i32": torch.randint(-2**31, 2**31 - 1, (5,), generator=g,
                             dtype=torch.int32),
        "i64": torch.randint(-2**40, 2**40, (2, 2), generator=g,
                             dtype=torch.int64),
        "bool": torch.rand(6, generator=g) > 0.5,
        "scalar": torch.tensor(3.5),
        "empty": torch.zeros(0, 4),
    }


def _assert_same(got: dict, want: dict):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert np.array_equal(_bits(g), _bits(w)), k


def test_reader_matches_safetensors_over_shards(tmp_path):
    """Every dtype the reader takes, over three shards (with metadata): the
    port's tensors equal ``safetensors.torch.load_file``'s bit for bit."""
    for i in range(3):
        path = str(tmp_path / f"model-{i:05d}-of-00003.safetensors")
        save_file({f"s{i}.{k}": v for k, v in _tensors(i).items()}, path,
                  metadata={"format": "pt"})
        _assert_same(thf.read_safetensors(path), load_file(path))


def _write_raw(path, entries, data: bytes, pad: int = 0):
    """A safetensors file by hand: ``entries`` {name: (dtype, shape,
    [begin, end])}, the header padded with ``pad`` spaces."""
    header = {name: {"dtype": dt, "shape": list(shape),
                     "data_offsets": list(off)}
              for name, (dt, shape, off) in entries.items()}
    header["__metadata__"] = {"format": "pt"}
    h = json.dumps(header).encode()
    h += b" " * ((-len(h)) % 8 + pad)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(h)) + h + data)


def test_reader_copies_a_misaligned_tensor(tmp_path):
    """A float32 and a bfloat16 tensor at odd byte offsets (behind a 1-byte
    and a 3-byte int8 tensor) are copied, not viewed, and read as the
    ``safetensors`` package reads them."""
    a = np.array([7], np.int8).tobytes()
    b = np.arange(6, dtype=np.float32).tobytes()
    c = np.array([1, -2, 3], np.int8).tobytes()
    d = torch.tensor([1.5, -2.25]).bfloat16().view(torch.int16).numpy() \
        .tobytes()
    path = str(tmp_path / "misaligned.safetensors")
    _write_raw(path, {"a": ("I8", [1], [0, 1]),
                      "b": ("F32", [2, 3], [1, 25]),
                      "c": ("I8", [3], [25, 28]),
                      "d": ("BF16", [2], [28, 32])}, a + b + c + d)
    got = thf.read_safetensors(path)
    _assert_same(got, load_file(path))
    assert got["b"].storage_offset() == 0          # a copy of its own


@pytest.mark.parametrize("case", ["truncated-data", "truncated-header",
                                  "no-header-length", "unknown-dtype",
                                  "overlap", "size-mismatch"])
def test_reader_refuses_a_broken_file(tmp_path, case):
    """A truncated file, an unknown dtype, overlapping tensors and a size
    that disagrees with the shape raise, naming the file (and the tensor
    where there is one)."""
    path = str(tmp_path / f"{case}.safetensors")
    data = np.arange(8, dtype=np.float32).tobytes()
    entries = {"w": ("F32", [8], [0, 32])}
    if case == "truncated-data":
        _write_raw(path, entries, data[:20])
    elif case == "truncated-header":
        _write_raw(path, entries, data)
        with open(path, "r+b") as f:
            f.truncate(12)
    elif case == "no-header-length":
        with open(path, "wb") as f:
            f.write(b"\x01\x02")
    elif case == "unknown-dtype":
        _write_raw(path, {"w": ("F8_E4M3", [32], [0, 32])}, data)
    elif case == "overlap":
        _write_raw(path, {"w": ("F32", [4], [0, 16]),
                          "v": ("F32", [4], [8, 24])}, data)
    else:
        _write_raw(path, {"w": ("F32", [3], [0, 16])}, data)
    with pytest.raises(ValueError) as err:
        thf.read_safetensors(path)
    assert path in str(err.value)
    if case not in ("truncated-header", "no-header-length"):
        assert "'w'" in str(err.value) or "'v'" in str(err.value)


# -- the key map --------------------------------------------------------------


@pytest.mark.parametrize("fam", sorted(FAMILIES))
def test_config_from_hf_dir_matches_jax(checkpoints, fam):
    """Each family's config.json gives the JAX package's ModelConfig, field
    for field."""
    _, _, f32, _ = checkpoints[fam]
    want = dataclasses.asdict(jhf.config_from_hf_dir(f32))
    assert dataclasses.asdict(thf.config_from_hf_dir(f32)) == want


@pytest.mark.parametrize("fam", sorted(FAMILIES))
@pytest.mark.parametrize("name,jdt,tdt", DTYPES, ids=[d[0] for d in DTYPES])
def test_convert_state_dict_matches_jax(checkpoints, fam, name, jdt, tdt):
    """The HF model's own state dict through both key maps: the same tree,
    bit for bit, in float32 and in bfloat16."""
    _, model, f32, _ = checkpoints[fam]
    jcfg = jhf.config_from_hf_dir(f32)
    tcfg = thf.config_from_hf_dir(f32)
    sd = model.state_dict()
    assert_same_tree(jhf.convert_state_dict(jcfg, sd, jdt),
                     thf.convert_state_dict(tcfg, sd, tdt, device="cpu"))


@pytest.mark.parametrize("name,jdt,tdt", DTYPES, ids=[d[0] for d in DTYPES])
def test_opt_bare_decoder_keys_load_like_jax(checkpoints, name, jdt, tdt):
    """OPT's hub files carry bare ``decoder.*`` keys: both prefixes give
    the tree of ``model.decoder.*``."""
    _, model, f32, _ = checkpoints["opt"]
    cfg = thf.config_from_hf_dir(f32)
    sd = model.state_dict()
    bare = {k[len("model."):] if k.startswith("model.") else k: v
            for k, v in sd.items()}
    assert "decoder.embed_tokens.weight" in bare
    want = thf.convert_state_dict(cfg, sd, tdt, device="cpu")
    assert_same_tree(want, thf.convert_state_dict(cfg, bare, tdt,
                                                  device="cpu"))
    assert_same_tree(jhf.convert_state_dict(jhf.config_from_hf_dir(f32),
                                            bare, jdt), want)


@pytest.mark.parametrize("fam", sorted(FAMILIES))
@pytest.mark.parametrize("file_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name,jdt,tdt", DTYPES, ids=[d[0] for d in DTYPES])
def test_load_checkpoint_matches_jax(checkpoints, fam, file_dtype, name, jdt,
                                     tdt):
    """``load_checkpoint`` of a float32 and of a bfloat16 directory into
    either dtype: the JAX loader's tree, bit for bit (the JAX loader reads
    bfloat16 safetensors through ``safetensors.numpy`` and ml_dtypes)."""
    _, _, f32, bf16 = checkpoints[fam]
    d = f32 if file_dtype == "f32" else bf16
    jcfg, tcfg = jhf.config_from_hf_dir(d), thf.config_from_hf_dir(d)
    assert_same_tree(jhf.load_checkpoint(d, jcfg, jdt),
                     thf.load_checkpoint(d, tcfg, tdt, device="cpu"))


def test_load_checkpoint_reads_shards_in_sorted_order(checkpoints, tmp_path):
    """The weights split over two shards load as the single file does; a
    directory without a shard raises FileNotFoundError."""
    _, _, f32, _ = checkpoints["qwen3"]
    cfg = thf.config_from_hf_dir(f32)
    tensors = load_file(f"{f32}/model.safetensors")
    keys = sorted(tensors)
    d = tmp_path / "sharded"
    d.mkdir()
    (d / "config.json").write_text(open(f"{f32}/config.json").read())
    save_file({k: tensors[k] for k in keys[::2]},
              str(d / "model-00001-of-00002.safetensors"))
    save_file({k: tensors[k] for k in keys[1::2]},
              str(d / "model-00002-of-00002.safetensors"))
    assert_same_tree(
        thf.load_checkpoint(f32, cfg, torch.float32, device="cpu"),
        thf.load_checkpoint(str(d), cfg, torch.float32, device="cpu"))
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        thf.load_checkpoint(str(empty), cfg, device="cpu")


def test_missing_key_and_wrong_shape_raise(checkpoints):
    _, model, f32, _ = checkpoints["qwen3"]
    cfg = thf.config_from_hf_dir(f32)
    sd = dict(model.state_dict())
    del sd["model.layers.1.mlp.up_proj.weight"]
    with pytest.raises(KeyError, match="model.layers.1.mlp.up_proj.weight"):
        thf.convert_state_dict(cfg, sd, device="cpu")
    sd = dict(model.state_dict())
    sd["model.layers.0.self_attn.k_proj.weight"] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="k_proj"):
        thf.convert_state_dict(cfg, sd, device="cpu")


def test_loaded_leaves_are_fresh_tensors(checkpoints):
    """No leaf views the mapped file: the tree owns its memory (a view
    would pin the file's mapping and write it whole into the cache)."""
    _, _, f32, _ = checkpoints["mistral"]
    cfg = thf.config_from_hf_dir(f32)
    tree = thf.load_checkpoint(f32, cfg, torch.float32, device="cpu")
    leaves = [tree["embed"]["weight"], tree["final_norm"]["weight"],
              tree["lm_head"]["kernel"], tree["layers"]["wq"]["kernel"]]
    for t in leaves:
        assert t.untyped_storage().nbytes() == t.numel() * t.element_size()


# -- refusals and the registry ------------------------------------------------


_REFUSED = {
    "qwen3_moe-mixed-layers": {"model_type": "qwen3_moe",
                               "mlp_only_layers": [1]},
    "qwen3_moe-sparse-step": {"model_type": "qwen3_moe",
                              "decoder_sparse_step": 2},
    "llama-yarn": {"model_type": "llama",
                   "rope_scaling": {"rope_type": "yarn", "factor": 4.0}},
    "opt-350m": {"model_type": "opt", "hidden_size": 64,
                 "word_embed_proj_dim": 32},
    "opt-post-norm": {"model_type": "opt", "hidden_size": 64,
                      "do_layer_norm_before": False},
    "unknown": {"model_type": "falcon"},
}


@pytest.mark.parametrize("case", sorted(_REFUSED))
def test_refusals_match_jax(tmp_path, case):
    d = tmp_path / f"refused-{case}"
    d.mkdir()
    (d / "config.json").write_text(json.dumps(_REFUSED[case]))
    with pytest.raises(ValueError) as want:
        jhf.config_from_hf_dir(str(d))
    with pytest.raises(ValueError) as got:
        thf.config_from_hf_dir(str(d))
    assert str(got.value) == str(want.value)


def test_registry_match_is_exact(tmp_path):
    """``_name_or_path`` naming a registered model gives the registry's
    entry; a near miss is built from the file."""
    d = tmp_path / "reg"
    d.mkdir()
    hf = {"model_type": "qwen3", "vocab_size": 128, "hidden_size": 64,
          "intermediate_size": 128, "num_hidden_layers": 2,
          "num_attention_heads": 4, "num_key_value_heads": 2}
    (d / "config.json").write_text(json.dumps(
        {**hf, "_name_or_path": "Qwen/Qwen3-0.6B"}))
    assert thf.config_from_hf_dir(str(d)) is tconfig.QWEN3_0_6B
    (d / "config.json").write_text(json.dumps(
        {**hf, "_name_or_path": "Qwen/Qwen3-0.6B-Base"}))
    got = thf.config_from_hf_dir(str(d))
    assert got.name == "Qwen/Qwen3-0.6B-Base" and got.num_layers == 2
    assert dataclasses.asdict(got) == \
        dataclasses.asdict(jhf.config_from_hf_dir(str(d)))


# -- the loaded model ---------------------------------------------------------


DENSE = ["qwen3", "mistral", "llama", "gemma", "phi", "opt"]


@pytest.mark.parametrize("fam", DENSE)
def test_loaded_logits_match_jax(checkpoints, fam):
    """Both packages' float32 forward passes over the trees each loads from
    the same directory: logits within 1e-5 (11 tokens: past tiny_mistral's
    window of 8)."""
    _, _, f32, _ = checkpoints[fam]
    jcfg, tcfg = jhf.config_from_hf_dir(f32), thf.config_from_hf_dir(f32)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 11)).astype(np.int32)
    positions = np.stack([np.arange(11), np.arange(3, 14)]).astype(np.int32)
    jparams = jhf.load_checkpoint(f32, jcfg, jnp.float32)
    want, _ = jl.model_forward(jparams, jcfg, jnp.asarray(tokens),
                               jnp.asarray(positions))
    lm = tl.DecoderLM(tcfg, thf.load_checkpoint(f32, tcfg, torch.float32,
                                                 device="cpu"))
    with torch.no_grad():
        got = lm(torch.from_numpy(tokens), torch.from_numpy(positions))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("fam", DENSE)
def test_engine_greedy_equals_hf_generate(tmp_path, fam):
    """A tiny checkpoint with a byte-level BPE tokenizer, served by the
    port's engine on the CPU through ``build_state``: its greedy streams
    equal HF ``generate``'s (``utils/hf_parity.run``; the Mistral prompts
    run past the window of 8)."""
    from aws_k8s_ansible_provisioner_tpu_torch.utils.hf_parity import run

    make_cfg, build = FAMILIES[fam]
    model = build(make_cfg(vocab_size=256))
    ckpt = tmp_path / f"tiny-{fam}-hf"
    model.save_pretrained(ckpt, safe_serialization=True)
    _write_byte_level_tokenizer(ckpt)
    report = run(str(ckpt), prompts=("abc", "hello w", "12345678"),
                 max_tokens=8, device="cpu")
    assert report["ok"], json.dumps(report)[:2000]
