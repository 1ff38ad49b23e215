"""The port's model (``models/layers.py``), quantization and conversion
against the JAX package on the same parameters.

Parameters come from the JAX ``init_params`` (float32), scaled so that the
logits are of order one rather than of order 1e-3, and reach the port through
``from_jax_params``. Logit tolerance: max abs 1e-4. Both sides compute in
float32, but XLA's and PyTorch's CPU matmuls sum their products in different
orders, which moves each logit by a few ulps per layer (about 1e-6 here);
1e-4 leaves room for that while still catching any wrong term (those move
logits by 1e-2 or more). Quantized values and scales, and the conversion,
must be bit-identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from aws_k8s_ansible_provisioner_tpu.config import tiny_qwen3 as jax_tiny
from aws_k8s_ansible_provisioner_tpu.models import layers as jl
from aws_k8s_ansible_provisioner_tpu.models import quant as jq
from aws_k8s_ansible_provisioner_tpu_torch.config import ModelConfig
from aws_k8s_ansible_provisioner_tpu_torch.models import layers as tl
from aws_k8s_ansible_provisioner_tpu_torch.models import quant as tq
from aws_k8s_ansible_provisioner_tpu_torch.models.convert import \
    from_jax_params

torch.set_num_threads(2)

TOL = 1e-4


def _scaled(tree, factor=8.0):
    """Projection kernels and the embedding times ``factor`` (norms stay at
    one), so that activations and logits are far from zero."""
    def go(node):
        return {k: go(v) if isinstance(v, dict) else
                v * factor if k == "kernel" else v for k, v in node.items()}
    out = go(tree)
    out["embed"] = {"weight": tree["embed"]["weight"] * factor}
    return out


@pytest.fixture(scope="module")
def model():
    jcfg = jax_tiny()
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    params = _scaled(jl.init_params(jcfg, jax.random.PRNGKey(0),
                                    dtype=jnp.float32))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 11)).astype(np.int32)
    positions = np.stack([np.arange(11), np.arange(5, 16)]).astype(np.int32)
    return jcfg, tcfg, params, tokens, positions


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_logits(params, cfg, tokens, positions):
    logits, _ = jl.model_forward(params, cfg, jnp.asarray(tokens),
                                 jnp.asarray(positions))
    return np.asarray(logits)


def _port_logits(params, cfg, tokens, positions):
    lm = tl.DecoderLM(cfg, params)
    with torch.no_grad():
        return lm(torch.from_numpy(tokens), torch.from_numpy(positions)) \
            .numpy()


def test_logits_match_jax_float32(model):
    jcfg, tcfg, params, tokens, positions = model
    ref = _jax_logits(params, jcfg, tokens, positions)
    got = _port_logits(from_jax_params(_numpy_tree(params), tcfg), tcfg,
                       tokens, positions)
    assert got.shape == ref.shape == (2, 11, jcfg.vocab_size)
    assert np.abs(ref).max() > 0.5                # logits far from zero
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


def test_logits_match_jax_int8_weights(model):
    """Weights-only int8 (the serving default): the JAX-quantized tree
    converted, against the JAX model on that same tree."""
    jcfg, tcfg, params, tokens, positions = model
    qparams = jq.quantize_params(params, jcfg)
    ref = _jax_logits(qparams, jcfg, tokens, positions)
    got = _port_logits(from_jax_params(_numpy_tree(qparams), tcfg), tcfg,
                       tokens, positions)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


def test_quantize_params_bit_identical(model):
    """The port's quantize_params on the converted float32 tree gives the
    same int8 values and float32 scales as the JAX one."""
    jcfg, tcfg, params, _, _ = model
    ref = _numpy_tree(jq.quantize_params(params, jcfg))
    got = tq.quantize_params(from_jax_params(_numpy_tree(params), tcfg),
                             tcfg)
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref):
        node = got
        for k in path:
            node = node[k.key]
        assert node.dtype == {np.dtype(np.int8): torch.int8,
                              np.dtype(np.float32): torch.float32}[leaf.dtype]
        np.testing.assert_array_equal(node.numpy(), leaf, err_msg=str(path))
    assert tq.weights_quantized(got)


def test_quantize_rounds_half_to_even():
    """Ties of w / s go to the even integer, as jnp.round does."""
    w = torch.tensor([[127.0, 2.5, -2.5, 0.5, 1.5]]).T       # [in=5, out=1]
    q, s = tq.quant_kernel(w, 0)
    assert s.tolist() == [1.0]
    assert q[:, 0].tolist() == [127, 2, -2, 0, 2]


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_from_jax_params_round_trips_bits(model, kind):
    jcfg, tcfg, params, _, _ = model
    if kind == "bfloat16":
        params = jax.tree.map(lambda x: x.astype(jnp.bfloat16), params)
    elif kind == "int8":
        params = jq.quantize_params(params, jcfg)
    tree = _numpy_tree(params)
    got = from_jax_params(tree, tcfg)
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        node = got
        for k in path:
            node = node[k.key]
        if leaf.dtype == ml_dtypes.bfloat16:
            assert node.dtype == torch.bfloat16
            back = node.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        else:
            back = node.numpy()
        assert back.dtype == leaf.dtype and back.shape == leaf.shape
        np.testing.assert_array_equal(back.view(np.uint8),
                                      leaf.view(np.uint8), err_msg=str(path))


def test_from_jax_params_checks_shapes(model):
    jcfg, tcfg, params, _, _ = model
    tree = _numpy_tree(params)
    with pytest.raises(ValueError, match="shape"):
        from_jax_params(tree, tcfg.scaled(hidden_size=32))
    del tree["final_norm"]
    with pytest.raises(KeyError):
        from_jax_params(tree, tcfg)


def test_norm_and_rope_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 5)).astype(np.int32)
    ref = np.asarray(jl.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))
    got = tl.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    jcos, jsin = jl.rope_cos_sin(jnp.asarray(pos), 16, 1e6)
    tcos, tsin = tl.rope_cos_sin(torch.from_numpy(pos), 16, 1e6)
    np.testing.assert_allclose(tcos.numpy(), np.asarray(jcos), atol=1e-5)
    np.testing.assert_allclose(tsin.numpy(), np.asarray(jsin), atol=1e-5)
    ref = np.asarray(jl.apply_rope(jnp.asarray(x), jcos, jsin, 16))
    got = tl.apply_rope(torch.from_numpy(x), tcos, tsin).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_causal_attend_matches_jax_with_padding():
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 7, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 7, 2, 16)).astype(np.float32)
    lens = np.array([7, 4], np.int32)
    ref = np.asarray(jl.causal_attend(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v),
                                      seq_lens=jnp.asarray(lens)))
    got = tl.causal_attend(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v),
                           seq_lens=torch.from_numpy(lens)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_init_params_shapes_follow_the_jax_layout():
    tcfg = ModelConfig(**dataclasses.asdict(jax_tiny()))
    gen = torch.Generator().manual_seed(0)
    p = tl.init_params(tcfg, gen, torch.float32)
    jp = jax.eval_shape(lambda: jl.init_params(
        jax_tiny(), jax.random.PRNGKey(0), dtype=jnp.float32))
    flat = jax.tree_util.tree_leaves_with_path(jp)
    for path, leaf in flat:
        node = p
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape, path
    again = tl.init_params(tcfg, torch.Generator().manual_seed(0),
                           torch.float32)
    assert torch.equal(p["embed"]["weight"], again["embed"]["weight"])
