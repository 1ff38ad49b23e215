"""The port's sampler against the JAX sampler.

Greedy rows match the JAX argmax exactly. The seeded path reproduces the
JAX package's bits: ``random_key``/``fold_in``/``uniform`` equal
``jax.random`` (threefry2x32, partitionable) over many (seed, position,
token) triples, and ``sample`` with per-slot keys picks the same token ids
as ``ops/sampling.sample`` on the same logits. Sampled rows stay inside
their top-k / top-p candidate sets and repeat under one (seed, position).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aws_k8s_ansible_provisioner_tpu.ops import sampling as jsampling
from aws_k8s_ansible_provisioner_tpu_torch.ops import sampling as tsampling
from aws_k8s_ansible_provisioner_tpu_torch.ops.sampling import MAX_TOPK, sample

torch.set_num_threads(2)


def _logits(B=5, V=300, seed=0):
    return np.random.default_rng(seed).standard_normal((B, V)) \
        .astype(np.float32) * 3


def _triples(n, seed):
    rng = np.random.default_rng(seed)
    seeds = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    seeds[:3] = [0, 2**31, 2**32 - 1]
    ctrs = rng.integers(0, 40960, n).astype(np.int32)
    toks = rng.integers(0, 151936, n).astype(np.int32)
    return seeds, ctrs, toks


def _key_words(keys):
    return np.asarray(jax.random.key_data(keys)).astype(np.int64)


def test_greedy_matches_jax():
    x = _logits()
    B = x.shape[0]
    ref = jsampling.sample(jnp.asarray(x), jax.random.PRNGKey(0),
                           jnp.zeros(B), jnp.zeros(B, jnp.int32),
                           jnp.ones(B))
    got = sample(torch.from_numpy(x), torch.zeros(B),
                 torch.zeros(B, dtype=torch.int32), torch.ones(B))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_threefry_key_fold_in_and_uniform_bits_match_jax():
    """1,200 (seed, ctr, token) triples, seeds 0, 2**31 and 2**32 - 1
    among them: the per-slot key, the token key and the float32 uniform are
    bit-identical to jax.random's."""
    seeds, ctrs, toks = _triples(1200, seed=1)
    jkeys = jsampling.per_slot_keys(jnp.asarray(seeds), jnp.asarray(ctrs))
    jtok = jax.vmap(jax.random.fold_in)(jkeys, jnp.asarray(toks))
    ju = jax.vmap(lambda k: jax.random.uniform(k, minval=1e-20))(jtok)
    tkeys = tsampling.per_slot_keys(torch.from_numpy(seeds.astype(np.int64)),
                                    torch.from_numpy(ctrs))
    ttok = tsampling.fold_in(tkeys, torch.from_numpy(toks))
    tu = tsampling.uniform(ttok)
    np.testing.assert_array_equal(tkeys.numpy(), _key_words(jkeys))
    np.testing.assert_array_equal(ttok.numpy(), _key_words(jtok))
    assert tu.dtype == torch.float32
    np.testing.assert_array_equal(tu.numpy().view(np.uint32),
                                  np.asarray(ju).view(np.uint32))
    root = tsampling.random_key(torch.from_numpy(seeds.astype(np.int64)))
    np.testing.assert_array_equal(
        root.numpy(), _key_words(jax.vmap(jax.random.key)(
            jnp.asarray(seeds))))


def test_uniform_floor_is_minval():
    """A key whose bits give 0.0 returns minval, as jax does; the floor
    keeps log(-log(u)) finite."""
    key = torch.tensor([[0, 0]], dtype=torch.int64)
    u = tsampling.uniform(key, minval=0.5)
    ref = jax.random.uniform(jax.random.wrap_key_data(
        jnp.zeros(2, jnp.uint32)), minval=0.5)
    assert float(u[0]) == float(ref) and float(u[0]) >= 0.5


@pytest.mark.parametrize("case", ["mixed", "temperature", "top_k", "top_p"])
def test_seeded_sample_matches_jax_token_ids(case):
    """Per-slot keys: the same token ids as the JAX sampler over greedy,
    temperature, top-k and top-p rows, at several positions."""
    B, V = 8, 500
    x = _logits(B, V, seed=3)
    rng = np.random.default_rng(4)
    seeds = rng.integers(0, 2**32, B, dtype=np.uint64).astype(np.uint32)
    temp = {"mixed": [0, 0.8, 1.0, 0.5, 0, 1.3, 0.8, 2.0],
            "temperature": [0.7] * B, "top_k": [1.0] * B,
            "top_p": [0.9] * B}[case]
    top_k = {"top_k": [1, 3, 20, 64, 100, 5, 2, 0],
             "mixed": [0, 20, 0, 5, 0, 0, 20, 0]}.get(case, [0] * B)
    top_p = {"top_p": [0.9, 0.5, 0.1, 1.0, 0.95, 0.3, 0.7, 0.99],
             "mixed": [1.0, 0.9, 1.0, 1.0, 1.0, 0.5, 0.9, 1.0]}.get(
                 case, [1.0] * B)
    temp = np.asarray(temp, np.float32)
    top_k = np.asarray(top_k, np.int32)
    top_p = np.asarray(top_p, np.float32)
    picked = set()
    for ctr in (1, 17, 300, 4095):
        ctrs = np.full(B, ctr, np.int32) + np.arange(B, dtype=np.int32)
        ref = jsampling.sample(
            jnp.asarray(x), jsampling.per_slot_keys(jnp.asarray(seeds),
                                                    jnp.asarray(ctrs)),
            jnp.asarray(temp), jnp.asarray(top_k), jnp.asarray(top_p))
        got = sample(torch.from_numpy(x), torch.from_numpy(temp),
                     torch.from_numpy(top_k), torch.from_numpy(top_p),
                     torch.from_numpy(seeds.astype(np.int64)),
                     torch.from_numpy(ctrs))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        picked |= set(got.tolist())
    if case != "top_k":
        assert len(picked) > B        # the draws really vary


def test_sampled_rows_stay_in_their_candidate_sets():
    x = torch.from_numpy(_logits(B=4, seed=1))
    temp = torch.tensor([0.0, 1.0, 1.0, 0.7])
    top_k = torch.tensor([0, 1, 5, 0], dtype=torch.int32)
    top_p = torch.tensor([1.0, 1.0, 1.0, 0.3])
    order = torch.argsort(x, dim=-1, descending=True)
    probs = torch.softmax(x[3] / 0.7, dim=-1)[order[3]]
    nucleus = int((torch.cumsum(probs, 0) - probs < 0.3).sum())
    seeds = torch.tensor([5, 6, 7, 8])
    for ctr in range(50):
        t = sample(x, temp, top_k, top_p, seeds, torch.full((4,), ctr))
        assert t[0] == order[0, 0] and t[1] == order[1, 0]
        assert t[2] in order[2, :5]
        assert t[3] in order[3, :min(nucleus, MAX_TOPK)]


def test_seeded_draws_repeat():
    """One (seed, position) gives one draw whatever the rows around it;
    another position or seed moves it."""
    x = torch.from_numpy(_logits(seed=2))
    B = x.shape[0]
    args = (torch.ones(B), torch.zeros(B, dtype=torch.int32), torch.ones(B))
    seeds, ctrs = torch.arange(B) + 7, torch.full((B,), 9)
    a = sample(x, *args, seeds, ctrs)
    b = sample(x, *args, seeds, ctrs)
    assert torch.equal(a, b)
    alone = sample(x[2:3], *(t[:1] for t in args), seeds[2:3], ctrs[2:3])
    assert alone[0] == a[2]
    draws = {int(sample(x[:1], *(t[:1] for t in args), seeds[:1],
                        torch.tensor([c]))[0]) for c in range(40)}
    assert len(draws) > 1


def test_greedy_batch_needs_no_seeds_and_sampled_rows_do():
    x = torch.from_numpy(_logits(B=2))
    k, p = torch.zeros(2, dtype=torch.int32), torch.ones(2)
    sample(x, torch.zeros(2), k, p)
    with pytest.raises(ValueError, match="seeds"):
        sample(x, torch.tensor([0.0, 1.0]), k, p)
