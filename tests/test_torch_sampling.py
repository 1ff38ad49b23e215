"""The port's sampler: greedy rows match the JAX sampler's argmax exactly;
sampled rows stay inside their top-k / top-p candidate set and repeat under
one ``torch.Generator`` seed. (Seeded streams cannot match the JAX package's
threefry draws bit for bit; see ROADMAP.md, queue C.)"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from aws_k8s_ansible_provisioner_tpu.ops import sampling as jsampling
from aws_k8s_ansible_provisioner_tpu_torch.ops.sampling import MAX_TOPK, sample

torch.set_num_threads(2)


def _logits(B=5, V=300, seed=0):
    return np.random.default_rng(seed).standard_normal((B, V)) \
        .astype(np.float32) * 3


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


def test_sampled_rows_stay_in_their_candidate_sets():
    x = torch.from_numpy(_logits(B=4, seed=1))
    temp = torch.tensor([0.0, 1.0, 1.0, 0.7])
    top_k = torch.tensor([0, 1, 5, 0], dtype=torch.int32)
    top_p = torch.tensor([1.0, 1.0, 1.0, 0.3])
    order = torch.argsort(x, dim=-1, descending=True)
    probs = torch.softmax(x[3] / 0.7, dim=-1)[order[3]]
    nucleus = int((torch.cumsum(probs, 0) - probs < 0.3).sum())
    gen = torch.Generator().manual_seed(0)
    for _ in range(50):
        t = sample(x, temp, top_k, top_p, gen)
        assert t[0] == order[0, 0] and t[1] == order[1, 0]
        assert t[2] in order[2, :5]
        assert t[3] in order[3, :min(nucleus, MAX_TOPK)]


def test_seeded_draws_repeat():
    x = torch.from_numpy(_logits(seed=2))
    B = x.shape[0]
    args = (torch.ones(B), torch.zeros(B, dtype=torch.int32), torch.ones(B))
    a = sample(x, *args, torch.Generator().manual_seed(7))
    b = sample(x, *args, torch.Generator().manual_seed(7))
    assert torch.equal(a, b)
