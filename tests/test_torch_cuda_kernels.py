"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and nvcc; without them each skips. The
module imports no JAX, so it also runs on a machine that has none:

    pytest -m cuda tests/test_torch_cuda_kernels.py

Tolerances: the row write copies values and must be bit-identical; the
attention kernel accumulates in float32 like its plain version, in another
order, so float32 pools agree within 1e-5 and bf16 pools within 2e-2 (one
bf16 ulp of outputs below 4 in magnitude is at most 2^-6).
"""

import numpy as np
import pytest
import torch

from aws_k8s_ansible_provisioner_tpu_torch.ops import paged_attention as tpa
from aws_k8s_ansible_provisioner_tpu_torch.serving.paged_kv import OOB_PAGE

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m cuda)")
    return torch.device("cuda")


def _layout(B, L, hkv, ps, d, maxp, seed):
    rng = np.random.default_rng(seed)
    P = B * maxp + 1
    pool_k = rng.standard_normal((L, P, hkv, ps, d)).astype(np.float32)
    pool_v = rng.standard_normal((L, P, hkv, ps, d)).astype(np.float32)
    table = (rng.permutation(B * maxp) + 1).reshape(B, maxp).astype(np.int32)
    return rng, pool_k, pool_v, table


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("hq,hkv,ps,d", [(4, 2, 8, 16), (16, 8, 64, 128)])
def test_paged_attention_matches_plain(dev, dtype, tol, hq, hkv, ps, d):
    """Rows of limit 0, one row, page edges and the full window; garbage
    table entries past each row's live range."""
    maxp = 4
    rng, pk, pv, table = _layout(6, 2, hkv, ps, d, maxp, seed=77)
    lengths = np.array([0, 1, ps, ps + 1, maxp * ps, 2 * ps + 3], np.int32)
    for n, lim in enumerate(lengths):
        live = max(-(-int(lim) // ps), 1)
        table[n, live:] = OOB_PAGE
    q = rng.standard_normal((6, hq, d)).astype(np.float32)
    qd, kd, vd = (torch.from_numpy(a).to(dev, dtype) for a in (q, pk, pv))
    lim = torch.from_numpy(lengths).to(dev)
    tab = torch.from_numpy(table).to(dev)
    before = tpa.paged_attention.launches
    out = tpa.paged_attention(qd, kd, vd, lim, 1, tab)
    assert tpa.paged_attention.launches == before + 1
    ref = tpa.paged_attention_plain(qd, kd, vd, lim, 1, tab)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == qd.shape
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cache_write_bit_identical_to_plain(dev, dtype):
    """Dropped rows (-1, past the window, OOB_PAGE tables), kept rows, and
    chunk rows sharing one table."""
    maxp, ps = 3, 8
    rng, pool_k, pool_v, table = _layout(8, 2, 2, ps, 16, maxp, seed=8)
    table[0, :] = OOB_PAGE
    table[5:] = table[4]
    rows = np.array([-1, 0, 8, 23, maxp * ps, 12, 13, 14], np.int32)
    k_new = rng.standard_normal((8, 2, 16)).astype(np.float32)
    v_new = rng.standard_normal((8, 2, 16)).astype(np.float32)
    pk, pv, kn, vn = (torch.from_numpy(a).to(dev, dtype)
                      for a in (pool_k, pool_v, k_new, v_new))
    r, t = torch.from_numpy(rows).to(dev), torch.from_numpy(table).to(dev)
    rk, rv = pk.clone(), pv.clone()
    before = tpa.cache_write_rows_paged.launches
    tpa.cache_write_rows_paged(pk, pv, kn, vn, r, 1, t)
    assert tpa.cache_write_rows_paged.launches == before + 1
    tpa.cache_write_rows_paged_plain(rk, rv, kn, vn, r, 1, t)
    torch.cuda.synchronize()
    assert torch.equal(pk, rk) and torch.equal(pv, rv)
    assert not torch.equal(pk, torch.from_numpy(pool_k).to(dev, dtype))


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q = torch.zeros((2, 4, 16), device=dev)
    pool = torch.zeros((1, 3, 2, 8, 16), device=dev)
    lim = torch.ones(2, dtype=torch.int32, device=dev)
    tab = torch.ones((2, 2), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        tpa.paged_attention(q.bfloat16(), pool, pool, lim, 0, tab)
    with pytest.raises(ValueError):
        tpa.paged_attention(q, pool, pool, lim.long(), 0, tab)
    with pytest.raises(ValueError):
        tpa.paged_attention(q, pool, pool, lim, 1, tab)
    with pytest.raises(ValueError):
        tpa.paged_attention(q, pool, pool, lim.cpu(), 0, tab)
